"""End-to-end serving driver on the PyTorch port: a mobile fleet on a 5G
trace, trigger-based re-planning, real batched execution of a reduced
model, SLO accounting. The twin of ``examples/serve_cluster.py``; runs
on the card (the smoke config's head_dim 16 raised to 32, the least the
attention kernels take), or with ``--device cpu`` on the CPU.

This is the paper's full loop (Fig. 5): clients partition with Neurosurgeon
as bandwidth changes -> scheduler re-plans (merge/group/re-align) ->
executor deploys stage pools -> requests flow through alignment + shared
stages in real batches.

  PYTHONPATH=src python examples/serve_cluster_torch.py --seconds 12
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import GraftPlanner, plan_gslice, place
from repro_torch.core.costmodel import arch_layer_costs
from repro_torch.core.profiles import ProfileBook
from repro_torch import models as M
from repro_torch.kernels.ops import kernel_head_dim
from repro_torch.serving import (make_fleet, fleet_fragments, simulate,
                                 GraftExecutor, ServeRequest)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--seconds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--replan-every", type=float, default=4.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = M.resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    cfg = kernel_head_dim(cfg, device)
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(cfg, seq_len=16),
                                 name=cfg.name))
    fleet = make_fleet(cfg.name, book, n_nano=args.clients, rate=30.0,
                       seed=3)
    planner = GraftPlanner(book)
    params = M.init_params(cfg, seed=0, device=device)
    rng = np.random.RandomState(0)

    print(f"serving {cfg.name} for {args.seconds}s, "
          f"{args.clients} clients, replan every {args.replan_every}s")
    t, served, plan, ex = 0.0, 0, None, None
    last_frags = None
    while t < args.seconds:
        frags = fleet_fragments(fleet, book, t=t)
        key = tuple(sorted((f.client, f.p) for f in frags))
        if plan is None or key != last_frags:              # trigger-based
            plan = planner.plan(frags)
            gs = plan_gslice(frags, book)
            ex = GraftExecutor(plan, params, cfg, device=device)
            pl = place(plan)
            print(f"[t={t:5.1f}s] REPLAN: {len(frags)} frags -> "
                  f"{ex.n_stage_pools} stage pools, "
                  f"resource {plan.total_resource:.0f}% "
                  f"(gslice {gs.total_resource:.0f}%), "
                  f"{pl.n_chips} chips @ {pl.utilization:.0%} util")
            last_frags = key
        # one batch window of real requests through the executor
        p_of = {f.client: f.p for f in frags}
        reqs = [(ServeRequest(client=c.name,
                              tokens=rng.randint(0, cfg.vocab_size, 16)
                              .astype(np.int32)), p_of[c.name])
                for c in fleet if c.name in p_of]
        done = ex.serve(reqs)
        served += len(done)
        t += args.replan_every

    # latency/SLO picture from the event simulator on the final plan
    res = simulate(plan, fleet, book, duration_s=5.0, t0=t)
    lat = res.all_latencies()
    print(f"\nserved {served} real requests through re-aligned stages")
    if len(lat):
        print(f"simulated e2e latency p50/p95/p99 = "
              f"{np.percentile(lat, 50):.0f}/{np.percentile(lat, 95):.0f}/"
              f"{np.percentile(lat, 99):.0f} ms; "
              f"SLO violations {res.violation_rate():.1%}")


if __name__ == "__main__":
    main()
