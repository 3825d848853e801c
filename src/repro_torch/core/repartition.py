"""DNN fragments re-partitioning + resource allocation (paper §4.3, Alg. 1).

Given a group of fragments of one model, pick a re-partition point p and a
time-budget split between the per-fragment *alignment stage* [p_i, p) and
the batched *shared stage* [p, L) minimising total resource, subject to
the queueing-aware constraint d_align + d_shared <= min_t / 2 (worst-case
queueing delay equals execution time, paper §4.3 / Nexus [8]).

Fragments whose partition point exceeds p recurse (Alg. 1 line 13).
The continuous budget-split LP (solved with Gurobi in the paper) is replaced
by a pruned grid search over the shared-stage fraction — the profile's
latency function is piecewise-monotonic in the budget, so a modest grid
finds the same discrete (batch, share) optima the LP would.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.fragment import Fragment
from repro_torch.core.profiles import Allocation, PerfProfile, EMPTY_ALLOC


@dataclass(frozen=True)
class StagePlan:
    fragment: Fragment
    start: int
    end: int
    budget_ms: float
    alloc: Allocation


def pool_key(model: str, sp: StagePlan) -> tuple:
    """Identity of the instance pool a stage plan deploys to — the unit
    plan diffing (``core.plandiff``) matches across replans."""
    return (model, sp.start, sp.end)


@dataclass(frozen=True)
class GroupPlan:
    """One shared-stage instance pool + per-fragment alignment stages."""
    model: str
    repartition_point: int
    shared: StagePlan
    aligns: tuple[StagePlan, ...]

    @property
    def resource(self) -> float:
        return self.shared.alloc.resource + sum(
            a.alloc.resource for a in self.aligns)

    @property
    def fragments(self) -> tuple[Fragment, ...]:
        return tuple(a.fragment for a in self.aligns)

    def pools(self):
        """Deployable (PoolKey, StagePlan) pairs — zero-width alignment
        stages (f.p == repartition point) are not pools. Zero-instance
        stages with a real block range ARE included: routing
        (``simulator._routing``) sends clients through them, so they must
        have a pool identity even when the allocation is empty."""
        yield pool_key(self.model, self.shared), self.shared
        for a in self.aligns:
            if a.end > a.start:
                yield pool_key(self.model, a), a


@dataclass(frozen=True)
class SoloPlan:
    """Fallback: serve one fragment on its own instances (no re-alignment)."""
    model: str
    stage: StagePlan

    @property
    def resource(self) -> float:
        return self.stage.alloc.resource

    @property
    def fragments(self) -> tuple[Fragment, ...]:
        return (self.stage.fragment,)

    def pools(self):
        if self.stage.end > self.stage.start:
            yield pool_key(self.model, self.stage), self.stage


# shared-stage budget fractions; 1.0 = no alignment budget, which is the
# right operating point for groups whose members share one partition point
# (pure merge-like sharing)
DEFAULT_GRID = tuple(np.linspace(0.15, 0.9, 11)) + (0.95, 1.0)


def solo_plan(f: Fragment, profile: PerfProfile,
              max_instances: int = 0) -> Optional[SoloPlan]:
    L = profile.costs.n_layers
    a = profile.alloc(f.p, L, f.t / 2.0, f.q, max_instances=max_instances)
    if a is None:
        return None
    return SoloPlan(model=f.model,
                    stage=StagePlan(f, f.p, L, f.t / 2.0, a))


def realign(frags: list[Fragment], profile: PerfProfile, *,
            d_grid: tuple = DEFAULT_GRID, max_instances: int = 0,
            _memo: Optional[dict] = None) -> tuple[float, list]:
    """Algorithm 1. Returns (total_resource, plans). Infeasible fragments
    fall back to solo plans at infinite-resource penalty avoidance —
    a None allocation anywhere yields resource = inf."""
    if _memo is None:
        _memo = {}
    if not frags:
        return 0.0, []
    key = tuple(sorted(id(f) for f in frags))
    if key in _memo:
        return _memo[key]
    L = profile.costs.n_layers
    min_p = min(f.p for f in frags)
    best_res, best_plans = np.inf, None

    for p in range(min_p, L + 1):
        FA = [f for f in frags if f.p <= p]
        FB = [f for f in frags if f.p > p]
        if not FA or p == L:
            continue
        min_t = min(f.t for f in FA)
        Q = sum(f.q for f in FA)
        half = min_t / 2.0
        best_p_res, best_p_plan = np.inf, None
        for frac in d_grid:
            d_shared = frac * half
            shared = profile.alloc(p, L, d_shared, Q,
                                   max_instances=max_instances)
            if shared is None:
                continue
            d_align = half - d_shared
            total = shared.resource
            aligns = []
            ok = True
            for f in FA:
                if f.p == p:
                    aligns.append(StagePlan(f, p, p, d_align, EMPTY_ALLOC))
                    continue
                a = profile.alloc(f.p, p, d_align, f.q,
                                  max_instances=max_instances)
                if a is None:
                    ok = False
                    break
                aligns.append(StagePlan(f, f.p, p, d_align, a))
                total += a.resource
            if ok and total < best_p_res:
                best_p_res = total
                best_p_plan = GroupPlan(
                    model=frags[0].model, repartition_point=p,
                    shared=StagePlan(FA[0], p, L, d_shared, shared),
                    aligns=tuple(aligns))
        if best_p_plan is None:
            continue
        res_b, plans_b = realign(FB, profile, d_grid=d_grid,
                                 max_instances=max_instances, _memo=_memo)
        if best_p_res + res_b < best_res:
            best_res = best_p_res + res_b
            best_plans = [best_p_plan] + plans_b

    # solo (no re-alignment) always competes — p = p_E degenerates to it
    total, plans = 0.0, []
    for f in frags:
        sp = solo_plan(f, profile, max_instances)
        if sp is None:
            total = np.inf
            break
        total += sp.resource
        plans.append(sp)
    if best_plans is None or total < best_res:
        best_res, best_plans = total, plans

    _memo[key] = (best_res, best_plans)
    return best_res, best_plans
