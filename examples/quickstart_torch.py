"""Quickstart: plan + serve misaligned fragments of one model, on the
PyTorch port. The twin of ``examples/quickstart.py``; runs on the card,
or with ``--device cpu`` on the CPU.

  PYTHONPATH=src python examples/quickstart_torch.py
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import Fragment, GraftPlanner, plan_gslice
from repro_torch.core.costmodel import arch_layer_costs
from repro_torch.core.profiles import ProfileBook
from repro_torch import models as M
from repro_torch.serving import GraftExecutor, ServeRequest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = M.resolve_device(args.device)

    # 1. a reduced qwen3 and its (analytic) performance profile
    cfg = get_smoke_config("qwen3-1.7b")
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(cfg, seq_len=16),
                                 name=cfg.name))

    # 2. three mobile clients offloaded misaligned fragments (p, budget, rate)
    frags = [Fragment(cfg.name, 0, 60.0, 30.0, client="phone-a"),
             Fragment(cfg.name, 1, 45.0, 30.0, client="phone-b"),
             Fragment(cfg.name, 1, 70.0, 30.0, client="phone-c")]

    # 3. Graft: merge -> group -> re-align;  baseline: GSLICE (no realign)
    plan = GraftPlanner(book).plan(frags)
    base = plan_gslice(frags, book)
    print(f"Graft resource : {plan.total_resource:.0f} (chip-share %)")
    print(f"GSLICE resource: {base.total_resource:.0f}")
    print(f"saving         : {100 * (1 - plan.total_resource / base.total_resource):.0f}%")
    for p in plan.plans:
        print("  plan:", type(p).__name__,
              getattr(p, "repartition_point", ""),
              [f.client for f in p.fragments])

    # 4. actually serve requests through the re-aligned stages
    params = M.init_params(cfg, seed=0, device=device)
    ex = GraftExecutor(plan, params, cfg, device=device)
    rng = np.random.RandomState(0)
    reqs = [(ServeRequest(client=f.client,
                          tokens=rng.randint(0, cfg.vocab_size, 16)
                          .astype(np.int32)), f.p) for f in frags]
    ex.serve(reqs)
    for req, p in reqs:
        toks = torch.as_tensor(req.tokens, device=device)[None]
        want, _ = M.forward(params, cfg, toks)
        err = (req.result.float()
               - want[0].float().cpu()).abs().max().item()
        print(f"  {req.client}: served logits {tuple(req.result.shape)}, "
              f"|err vs monolithic| = {err:.2e}")


if __name__ == "__main__":
    main()
