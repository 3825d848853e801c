"""DNN fragments merging (paper §4.1).

Uniform fragments (same model, same partition point, same time budget) are
merged incrementally while the *resource margin* (q_a - q_d)/q_d of the
merged fragment stays above the merging threshold — merging beyond that
point exhausts the discreteness slack that grouping/re-partitioning could
otherwise exploit (paper §5.5).

Strategies:
  * ``none``      — no merging (paper: No-merging)
  * ``uniform``   — merge all uniform fragments (paper: Uniform; what
                    GSLICE+/Static+ get)
  * ``uniform+``  — threshold-bounded merging (paper: Uniform+; the default)
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.core.fragment import Fragment, merge_fragments
from repro_torch.core.profiles import ProfileBook


def _uniform_key(f: Fragment, budget_quantum: float = 1.0):
    return (f.model, f.p, round(f.t / budget_quantum))


def merge(frags: list[Fragment], book: ProfileBook, *,
          threshold: float = 0.2, strategy: str = "uniform+",
          budget_quantum: float = 1.0) -> list[Fragment]:
    if strategy == "none":
        return list(frags)
    groups = defaultdict(list)
    for f in frags:
        groups[_uniform_key(f, budget_quantum)].append(f)
    out: list[Fragment] = []
    for g in groups.values():
        if strategy == "uniform":
            out.append(merge_fragments(g) if len(g) > 1 else g[0])
            continue
        # uniform+: incremental merging bounded by the resource margin
        prof = book[g[0].model]
        L = prof.costs.n_layers
        g = sorted(g, key=lambda f: f.q)                   # merge-sort order
        cur = [g[0]]
        for f in g[1:]:
            cand = merge_fragments(cur + [f])
            margin = prof.resource_margin(cand.p, L, cand.t / 2.0, cand.q)
            if margin > threshold:
                cur.append(f)
            else:
                out.append(merge_fragments(cur) if len(cur) > 1 else cur[0])
                cur = [f]
        out.append(merge_fragments(cur) if len(cur) > 1 else cur[0])
    return out
