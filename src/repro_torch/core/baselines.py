"""Baselines the paper evaluates against (§5.1):

  * Static / Static+  — provisioning from each client's AVERAGE bandwidth
    (partition point and budget frozen at trace averages); Static+ merges
    uniform fragments first. No re-alignment.
  * GSLICE / GSLICE+  — fine-grained spatial GPU sharing with per-fragment
    batching (GSLICE [59]); GSLICE+ merges all uniform fragments first.
    No re-alignment.
  * Optimal           — exhaustive grouping enumeration + re-partitioning
    (exponential; guarded to small fragment counts).
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from repro_torch.core import merging as merging_mod
from repro_torch.core.fragment import Fragment
from repro_torch.core.grouping import optimal_groupings
from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.profiles import ProfileBook
from repro_torch.core.repartition import realign, solo_plan, DEFAULT_GRID


def _solo_all(frags, book, max_instances=0):
    plans, total = [], 0.0
    for f in frags:
        sp = solo_plan(f, book[f.model], max_instances)
        if sp is None:
            total = np.inf
            continue
        plans.append(sp)
        total += sp.resource
    return plans, total


def plan_gslice(frags: list[Fragment], book: ProfileBook, *,
                merge_uniform: bool = False,
                max_instances: int = 0) -> ExecutionPlan:
    """GSLICE (merge_uniform=False) / GSLICE+ (True)."""
    t0 = time.perf_counter()
    fs = merging_mod.merge(frags, book, strategy="uniform") \
        if merge_uniform else list(frags)
    plans, total = _solo_all(fs, book, max_instances)
    return ExecutionPlan(plans=plans, total_resource=total,
                         n_fragments_in=len(frags), n_fragments_merged=len(fs),
                         schedule_time_s=time.perf_counter() - t0,
                         meta={"baseline": "gslice+" if merge_uniform
                               else "gslice"})


def plan_static(frags: list[Fragment], book: ProfileBook, *,
                avg_frags: list[Fragment] = None,
                merge_uniform: bool = False,
                max_instances: int = 0) -> ExecutionPlan:
    """Static / Static+: allocate for the average-bandwidth fragments
    (``avg_frags``), i.e. ignore current network conditions.

    The returned plan carries the average-conditions fragments; the latency
    simulator evaluates it against the *actual* fragments, exposing SLO
    violations when conditions degrade and over-allocation when they
    improve — the paper's Static behaviour.
    """
    t0 = time.perf_counter()
    fs = avg_frags if avg_frags is not None else list(frags)
    if merge_uniform:
        fs = merging_mod.merge(fs, book, strategy="uniform")
    plans, total = _solo_all(fs, book, max_instances)
    return ExecutionPlan(plans=plans, total_resource=total,
                         n_fragments_in=len(frags), n_fragments_merged=len(fs),
                         schedule_time_s=time.perf_counter() - t0,
                         meta={"baseline": "static+" if merge_uniform
                               else "static"})


def plan_optimal(frags: list[Fragment], book: ProfileBook, *,
                 group_size: int = 5, d_grid: tuple = DEFAULT_GRID,
                 max_instances: int = 0,
                 max_fragments: int = 11) -> ExecutionPlan:
    """Exhaustive enumeration of groupings (per model), each re-partitioned
    with Algorithm 1. Exponential — refuses > max_fragments per model."""
    t0 = time.perf_counter()
    by_model = defaultdict(list)
    for f in frags:
        by_model[f.model].append(f)
    plans, total = [], 0.0
    for model, fs in by_model.items():
        if len(fs) > max_fragments:
            raise ValueError(
                f"Optimal baseline limited to {max_fragments} fragments "
                f"per model; got {len(fs)} for {model}")
        profile = book[model]
        memo: dict = {}
        best_res, best_plans = np.inf, None
        for grouping in optimal_groupings(len(fs), group_size):
            res, ps = 0.0, []
            for block in grouping:
                r, p = realign([fs[i] for i in block], profile,
                               d_grid=d_grid, max_instances=max_instances,
                               _memo=memo)
                res += r
                ps += p
                if res >= best_res:
                    break
            if res < best_res:
                best_res, best_plans = res, ps
        plans += best_plans or []
        total += best_res
    return ExecutionPlan(plans=plans, total_resource=total,
                         n_fragments_in=len(frags), n_fragments_merged=len(frags),
                         schedule_time_s=time.perf_counter() - t0,
                         meta={"baseline": "optimal"})
