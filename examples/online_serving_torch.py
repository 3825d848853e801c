"""Online SLO-aware serving on the PyTorch port: the controller closing
the loop, live. The twin of ``examples/online_serving.py``; the real
transports run on the card, or with ``--device cpu`` on the CPU (the
simulator is numpy only).

Two ways to run it:

  * ``--transport sim`` (default): a mobile fleet rides a volatile 5G
    trace in the discrete-event simulator; the ServingController watches
    the request stream, estimates per-client rate/bandwidth/SLO-risk
    from sliding windows, and replans whenever a trigger fires —
    applying only the plan *diff* so unchanged pools keep their queues
    and warm instances. Compared against replanning from scratch.

  * ``--transport inprocess|socket``: the REAL data path at smoke scale.
    Requests carry actual tensors through length-prefixed msgpack frames
    (loopback or worker subprocesses on localhost TCP), uplinks are
    shaped by per-client bandwidth traces, the controller's bandwidth
    estimator consumes the transport-measured samples, and a mid-run
    partition shift exercises apply_plan() on the live executor — warm
    pools (and their worker pids) survive the replan.

  * ``--loop`` (with a real transport): instead of scripted waves, the
    long-running event-driven GraftServer serves trace-driven client
    threads wall-clock — per-pool driver threads, deadline-aware
    micro-batching, and the controller replanning on a timer while
    traffic is in flight.

  PYTHONPATH=src python examples/online_serving_torch.py --seconds 20
  PYTHONPATH=src python examples/online_serving_torch.py --transport inprocess --waves 3
  PYTHONPATH=src python examples/online_serving_torch.py --transport inprocess --loop --seconds 6
"""
import argparse

import numpy as np

from repro_torch.core import GraftPlanner, default_book
from repro_torch.core.reuse import IncrementalPlanner
from repro_torch.serving import (ServingController, fleet_fragments,
                                 make_fleet, simulate)


def run_mode(mode, book, fleet, frags0, seconds):
    diffs = mode == "controller"
    planner = IncrementalPlanner(book) if diffs else GraftPlanner(book)
    ctl = ServingController(book, planner=planner, apply_diffs=diffs)
    plan0 = ctl.bootstrap(frags0)
    res = simulate(plan0, fleet, book, duration_s=seconds, t0=0.0,
                   controller=ctl, seed=1)
    return ctl, res


def main_sim(args):
    book = default_book()
    fleet = make_fleet(args.model, book, n_nano=args.clients, rate=args.rate,
                       seed=17, trace_kw={"sigma": 0.6, "fade_prob": 0.05})
    frags0 = fleet_fragments(fleet, book, t=0.0)
    print(f"{args.model}: {len(fleet)} clients on volatile traces, "
          f"{args.seconds:.0f}s\n")

    ctl, res = run_mode("controller", book, fleet, frags0, args.seconds)
    print("replan timeline (controller mode):")
    for t_ms, triggers, s in ctl.log:
        print(f"  t={t_ms / 1e3:6.2f}s  {'+'.join(triggers):24s} "
              f"kept={s['keep'] + s['resize'] + s['rebatch']} "
              f"added={s['add']} removed={s['remove']}")

    print("\nmode         attainment  drops   mean replan")
    for mode, (c, r) in (("controller", (ctl, res)),
                         ("scratch", run_mode("scratch", book, fleet,
                                              frags0, args.seconds))):
        print(f"{mode:12s} {r.attainment():9.1%} {r.drop_rate():6.1%}"
              f" {c.mean_replan_ms():9.1f} ms"
              f"   ({c.stats['replans']} replans, "
              f"{c.stats['pools_kept']} pools kept)")

    print("\ncontroller's final view of the fleet (sliding-window estimates):")
    for name, e in sorted(ctl.estimates(args.seconds * 1e3).items()):
        print(f"  {name:8s} p={e.p}  rate={e.rate:5.1f} rps  "
              f"budget={e.budget_ms:6.1f} ms  uplink={e.bw * 8 / 1e6:6.1f} "
              f"Mbit/s  risk={e.risk:.2f}")

    lat = res.all_latencies()
    if len(lat):
        print(f"\ncontroller e2e latency p50/p95/p99 = "
              f"{np.percentile(lat, 50):.0f}/{np.percentile(lat, 95):.0f}/"
              f"{np.percentile(lat, 99):.0f} ms")
    return 0


def main_real(args):
    """Real tensors over the chosen transport, controller in the loop."""
    import dataclasses

    from repro_torch.data.traces import synth_5g_trace
    from repro_torch.models import n_fragment_units
    from repro_torch.serving import (GraftExecutor, InProcessTransport,
                                     LinkShape, RemoteExecutor,
                                     ShapedTransport, SocketTransport)
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           smoke_fragments, smoke_requests,
                                           smoke_setup)

    cfg, book, params = smoke_setup(args.arch, seed=args.seed,
                                    device=args.device)
    L = n_fragment_units(cfg)
    frags = smoke_fragments(cfg, args.clients, seed=args.seed)
    clock = {"s": 0.0}
    shapes = {f.client: LinkShape(
        trace=synth_5g_trace(seed=100 + i, sigma=0.6, fade_prob=0.05),
        rtt_ms=8.0) for i, f in enumerate(frags)}
    inner = SocketTransport() if args.transport == "socket" \
        else InProcessTransport()
    tp = ShapedTransport(inner, shapes, clock=lambda: clock["s"])

    ctl = ServingController(book, planner=GraftPlanner(book),
                            min_replan_interval_ms=0.0)
    plan0 = ctl.bootstrap(frags, now_ms=0.0)
    cls = RemoteExecutor if args.transport == "socket" else GraftExecutor
    print(f"{cfg.name}: {len(frags)} clients over {args.transport} "
          f"transport, {args.waves} waves")
    rng = np.random.RandomState(args.seed)
    with cls(plan0, params, cfg, transport=tp, device=args.device) as ex:
        pids0 = dict(ex.worker_pids())
        print(f"deployed {ex.n_stage_pools} stage pools on pids "
              f"{sorted(set(pids0.values()))}")
        for wave in range(args.waves):
            now_ms = wave * 1000.0
            clock["s"] = wave * 1.0
            if wave == args.waves // 2 and len(frags) > 1:
                # mid-run partition shift: client 0 flips its split point
                frags = [dataclasses.replace(
                    frags[0], p=(frags[0].p + 1) % L)] + frags[1:]
            reqs = smoke_requests(cfg, frags, rng=rng)
            for (req, p), f in zip(reqs, frags):
                ctl.observe_arrival(now_ms, req.client, cfg.name, p,
                                    budget_ms=f.t)
            # replan BEFORE serving the wave: a shifted client must not be
            # routed through a chain built for its old partition point
            new_plan = ctl.control(now_ms)
            if new_plan is not None:
                diff = ex.apply_plan(new_plan)
                s = diff.summary()
                survivors = {k: pid for k, pid in ex.worker_pids().items()
                             if k in pids0}
                warm = all(pids0[k] == pid for k, pid in survivors.items())
                print(f"  replan: kept={diff.n_kept} add={s['add']} "
                      f"remove={s['remove']}; surviving pools "
                      f"{'kept their processes' if warm else 'RESTARTED'}")
                pids0 = dict(ex.worker_pids())
            ex.serve(reqs)
            check_against_monolithic(cfg, params, reqs)
            up = ex.drain_uplink()
            ctl.ingest_uplink(now_ms, up)
            bw = [n / (ms / 1e3) for _, n, ms in up if ms > 0]
            print(f"wave {wave}: served {len(reqs)} reqs, shaped uplink "
                  f"mean {np.mean(bw) * 8 / 1e6:6.2f} Mbit/s" if bw else
                  f"wave {wave}: served {len(reqs)} reqs")
        print("\ncontroller estimates from transport-measured uplinks:")
        for name, e in sorted(ctl.estimates(args.waves * 1000.0).items()):
            print(f"  {name:4s} p={e.p}  uplink={e.bw * 8 / 1e6:6.2f} Mbit/s"
                  f"  budget={e.budget_ms:5.1f} ms")
    print("numerics matched the monolithic forward pass on every wave")
    return 0


def main_loop(args):
    """Wall-clock event-driven runtime (GraftServer) over real tensors."""
    from repro_torch.serving import run_serve_loop
    rep = run_serve_loop(
        arch=args.arch, mode=args.transport, n_clients=args.clients,
        seconds=args.seconds, rate=min(args.rate, 12.0), seed=args.seed,
        shift_frac=0.5, shaped=args.shaped, log=print, device=args.device)
    print(f"\nserved {rep['served']} requests, attainment "
          f"{rep['attainment']:.1%}, p50/p99 = "
          f"{rep['p50_ms']:.1f}/{rep['p99_ms']:.1f} ms, mean batch "
          f"{rep['mean_batch']:.2f}")
    print(f"replans: {rep['replans']} applied live "
          f"({rep['timer_replans']} timer-driven), triggers "
          f"{rep['controller_triggers']}")
    print(f"rerouted {rep['rerouted']} queued requests across replans; "
          f"numerics matched monolithic forward on all "
          f"{rep['numerics_checked']} checked")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--transport", choices=("sim", "inprocess", "socket"),
                    default="sim")
    ap.add_argument("--model", default="inc", help="sim mode: paper model")
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="real mode: smoke architecture")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rate", type=float, default=30.0)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--waves", type=int, default=4,
                    help="real mode: request waves to serve")
    ap.add_argument("--loop", action="store_true",
                    help="real mode: run the event-driven GraftServer "
                         "wall-clock instead of scripted waves")
    ap.add_argument("--shaped", action="store_true",
                    help="loop mode: shape uplinks with 5G traces")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="real mode: torch device (default: the card)")
    args = ap.parse_args()
    if args.transport == "sim":
        if args.loop:
            ap.error("--loop needs a real transport: "
                     "add --transport inprocess|socket")
        return main_sim(args)
    args.clients = min(args.clients, 4)        # smoke scale
    if args.loop:
        return main_loop(args)
    return main_real(args)


if __name__ == "__main__":
    raise SystemExit(main())
