"""Anatomy of DNN re-alignment: merge -> group -> Algorithm 1, step by step,
on the paper's Inception workload profile. The twin of
``examples/realign_demo.py`` on the PyTorch port's planner, which is
numpy only: it prints the same lines. ``--device`` is taken for a
command line like the other twins'; the planner runs on the host.

  PYTHONPATH=src python examples/realign_demo_torch.py
"""
import argparse

import numpy as np

from repro_torch.core import (default_book, Fragment, merge,
                              group_fragments, realign, plan_gslice,
                              GraftPlanner, place)
from repro_torch.core.repartition import GroupPlan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="unused: the planner runs on the host")
    ap.parse_args()

    book = default_book()
    prof = book["inc"]
    rng = np.random.RandomState(4)
    frags = []
    for i in range(12):
        p = int(rng.choice([0, 1, 2, 3]))
        t = float(rng.choice([110, 120, 140]))
        frags.append(Fragment("inc", p, t, 30.0, client=f"client{i:02d}"))
    print("fragments (p, budget ms, RPS):")
    for f in frags:
        print(f"  {f.client}: p={f.p} t={f.t:.0f} q={f.q:.0f}")

    merged = merge(frags, book, threshold=0.2)
    print(f"\n§4.1 merging: {len(frags)} -> {len(merged)} fragments")
    for m in merged:
        n = len(m.merged_from) or 1
        print(f"  p={m.p} t={m.t:.0f} q={m.q:.0f}  ({n} clients)")

    groups = group_fragments(merged, group_size=5)
    print(f"\n§4.2 grouping into {len(groups)} group(s)")

    total = 0.0
    for gi, g in enumerate(groups):
        res, plans = realign(g, prof)
        total += res
        print(f"\n§4.3 group {gi}: resource {res:.0f}%")
        for p in plans:
            if isinstance(p, GroupPlan):
                sh = p.shared
                print(f"  re-partition @ layer {p.repartition_point}: "
                      f"shared [{sh.start},{sh.end}) "
                      f"share={sh.alloc.share}% batch={sh.alloc.batch} "
                      f"x{sh.alloc.n_instances} "
                      f"({sh.alloc.throughput:.0f} RPS)")
                for a in p.aligns:
                    if a.alloc.n_instances:
                        print(f"    align [{a.start},{a.end}) for "
                              f"{a.fragment.client or 'merged'}: "
                              f"share={a.alloc.share}% x{a.alloc.n_instances}")
            else:
                print(f"  solo [{p.stage.start},{p.stage.end}) "
                      f"share={p.stage.alloc.share}%")

    gs = plan_gslice(frags, book)
    plan = GraftPlanner(book).plan(frags)
    pl = place(plan)
    print(f"\nGraft total {plan.total_resource:.0f}% vs GSLICE "
          f"{gs.total_resource:.0f}%  "
          f"(saving {100 * (1 - plan.total_resource / gs.total_resource):.0f}%)")
    print(f"placement: {pl.n_chips} chips, {pl.utilization:.0%} mean util")


if __name__ == "__main__":
    main()
