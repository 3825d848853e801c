"""Realignment reuse / shadow instances — the paper's §6 proposal,
implemented.

    "this strategy sets up shadow instances for the latest arrived DNN
     fragments when the scheduler is busy ... identifies 'similar'
     fragments, which share the same partition points and approximate time
     budgets with the recently arrived ones, and then reuses their
     realignment"

The :class:`IncrementalPlanner` keeps a signature cache of past
allocations: a fragment whose (model, partition point, budget bucket)
matches a cached entry is served by a *shadow instance pool* cloned from
the cached allocation (instance count re-scaled to the new rate — valid
because, per the paper's §6 observation, the discreteness of batch/share
means small budget/rate deltas rarely change the per-instance optimum).
Only unmatched fragments go through the full merge/group/re-align
pipeline, whose results refresh the cache.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Optional

import numpy as np

from repro_torch.core.fragment import Fragment
from repro_torch.core.planner import ExecutionPlan, GraftPlanner
from repro_torch.core.repartition import GroupPlan, SoloPlan, StagePlan


def fragment_signature(f: Fragment, budget_quantum_ms: float):
    """Reuse identity of a fragment: (model, partition point, budget
    bucket). Two fragments with equal signatures hit the same shadow
    cache entry and therefore land in pools with the same
    ``core.plandiff`` identity across replans."""
    return (f.model, f.p, int(f.t // budget_quantum_ms))


_signature = fragment_signature                      # backward-compat alias


@dataclasses.dataclass
class CachedAlloc:
    """A reusable per-fragment serving recipe."""
    start: int
    end: int
    share: int
    batch: int
    latency_ms: float
    per_instance_rps: float
    shared_chain: Optional[tuple] = None   # (start, end, share, batch, lat)


class IncrementalPlanner:
    """Trigger-storm-friendly planner: full Graft planning for novel
    fragments, shadow-instance reuse for familiar ones."""

    def __init__(self, book, *, budget_quantum_ms: float = 5.0,
                 max_cache: int = 4096, **planner_kw):
        self.book = book
        self.budget_quantum_ms = budget_quantum_ms
        self.max_cache = max_cache
        self.full = GraftPlanner(book, **planner_kw)
        self._cache: dict = {}
        self.stats = {"hits": 0, "misses": 0, "full_plans": 0}

    # ------------------------------------------------------------- caching
    def _remember(self, plan: ExecutionPlan) -> None:
        for pl in plan.plans:
            if isinstance(pl, SoloPlan):
                st = pl.stage
                a = st.alloc
                if a.n_instances == 0:
                    continue
                self._cache[_signature(st.fragment, self.budget_quantum_ms)] = \
                    CachedAlloc(st.start, st.end, a.share, a.batch,
                                a.latency_ms,
                                a.throughput / a.n_instances)
            elif isinstance(pl, GroupPlan):
                sh = pl.shared
                for st in pl.aligns:
                    a = st.alloc if st.alloc.n_instances else None
                    self._cache[_signature(st.fragment,
                                           self.budget_quantum_ms)] = \
                        CachedAlloc(
                            st.start, st.end,
                            a.share if a else 0, a.batch if a else 1,
                            a.latency_ms if a else 0.0,
                            (a.throughput / a.n_instances) if a else np.inf,
                            shared_chain=(sh.start, sh.end, sh.alloc.share,
                                          sh.alloc.batch,
                                          sh.alloc.latency_ms,
                                          sh.alloc.throughput
                                          / max(sh.alloc.n_instances, 1)))
        while len(self._cache) > self.max_cache:
            self._cache.pop(next(iter(self._cache)))

    def _shadow_plan(self, f: Fragment, rec: CachedAlloc):
        """Clone the cached recipe at this fragment's rate."""
        from repro_torch.core.profiles import Allocation, EMPTY_ALLOC

        def scaled(start, end, share, batch, lat, per_rps, rate):
            if end <= start:
                return EMPTY_ALLOC
            n = max(1, math.ceil(rate / max(per_rps, 1e-9)))
            return Allocation(share=share, batch=batch, n_instances=n,
                              latency_ms=lat, throughput=per_rps * n,
                              resource=share * n)
        if rec.shared_chain is None:
            a = scaled(rec.start, rec.end, rec.share, rec.batch,
                       rec.latency_ms, rec.per_instance_rps, f.q)
            return SoloPlan(model=f.model,
                            stage=StagePlan(f, rec.start, rec.end,
                                            f.t / 2.0, a))
        s0, s1, ssh, sb, slat, srps = rec.shared_chain
        align = scaled(rec.start, rec.end, rec.share, rec.batch,
                       rec.latency_ms, rec.per_instance_rps, f.q)
        shared = scaled(s0, s1, ssh, sb, slat, srps, f.q)
        return GroupPlan(model=f.model, repartition_point=s0,
                         shared=StagePlan(f, s0, s1, f.t / 2.0, shared),
                         aligns=(StagePlan(f, rec.start, rec.end,
                                           f.t / 2.0, align),))

    # -------------------------------------------------------------- plan
    def plan(self, frags: list[Fragment]) -> ExecutionPlan:
        t0 = time.perf_counter()
        by_sig = defaultdict(list)
        novel = []
        for f in frags:
            sig = _signature(f, self.budget_quantum_ms)
            if sig in self._cache:
                by_sig[sig].append(f)
                self.stats["hits"] += 1
            else:
                novel.append(f)
                self.stats["misses"] += 1
        # one shadow POOL per signature: matching fragments join the same
        # instances (the whole point of re-alignment) rather than cloning
        # per-client pools — and signatures whose cached recipe shares the
        # same SHARED-stage shape join one shared pool across signatures
        # (the realignment topology §6 wants to preserve).
        from repro_torch.core.fragment import merge_fragments
        from repro_torch.core.profiles import Allocation, EMPTY_ALLOC

        shared_groups = defaultdict(list)          # shared recipe -> members
        solo_shadows = []
        for sig, fs in by_sig.items():
            pooled = merge_fragments(fs) if len(fs) > 1 else fs[0]
            rec = self._cache[sig]
            if rec.shared_chain is None:
                solo_shadows.append(self._shadow_plan(pooled, rec))
            else:
                shared_groups[(pooled.model, rec.shared_chain)].append(
                    (pooled, rec))

        def scaled(share, batch, lat, per_rps, rate, start, end):
            if end <= start or rate <= 0:
                return EMPTY_ALLOC
            n = max(1, math.ceil(rate / max(per_rps, 1e-9)))
            return Allocation(share=share, batch=batch, n_instances=n,
                              latency_ms=lat, throughput=per_rps * n,
                              resource=share * n)

        shadows = solo_shadows
        for (model, chain), members in shared_groups.items():
            s0, s1, ssh, sb, slat, srps = chain
            q_total = sum(f.q for f, _ in members)
            shared = scaled(ssh, sb, slat, srps, q_total, s0, s1)
            aligns = []
            for f, rec in members:
                a = scaled(rec.share, rec.batch, rec.latency_ms,
                           rec.per_instance_rps, f.q, rec.start, rec.end)
                aligns.append(StagePlan(f, rec.start,
                                        rec.end if rec.end > rec.start
                                        else rec.start, f.t / 2.0, a))
            shadows.append(GroupPlan(
                model=model, repartition_point=s0,
                shared=StagePlan(members[0][0], s0, s1, members[0][0].t / 2.0,
                                 shared),
                aligns=tuple(aligns)))
        plans = list(shadows)
        total = sum(p.resource for p in shadows)
        if novel:
            self.stats["full_plans"] += 1
            sub = self.full.plan(novel)
            self._remember(sub)
            plans += sub.plans
            total += sub.total_resource
        return ExecutionPlan(
            plans=plans, total_resource=total,
            n_fragments_in=len(frags), n_fragments_merged=len(frags),
            schedule_time_s=time.perf_counter() - t0,
            meta={"shadow_hits": len(shadows), "novel": len(novel)})
