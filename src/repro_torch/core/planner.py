"""Graft's scheduler: merge -> group -> re-partition (paper §3/§4).

Produces an :class:`ExecutionPlan` — the fragment groups, re-partition
point per group, per-instance resource share, batch size, and instance
count — which the executor (``repro_torch.serving.executor``) deploys, and the
placement layer (``core.placement``) maps onto physical chips.
"""
from __future__ import annotations

import time
import dataclasses
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core import merging as merging_mod
from repro_torch.core.fragment import Fragment
from repro_torch.core.grouping import group_fragments
from repro_torch.core.profiles import ProfileBook
from repro_torch.core.repartition import realign, GroupPlan, SoloPlan, DEFAULT_GRID


@dataclass
class ExecutionPlan:
    plans: list                                  # GroupPlan | SoloPlan
    total_resource: float
    n_fragments_in: int
    n_fragments_merged: int
    schedule_time_s: float
    meta: dict = field(default_factory=dict)

    @property
    def instances(self) -> list:
        """Flat list of (model, start, end, Allocation) instance pools."""
        out = []
        for pl in self.plans:
            if isinstance(pl, GroupPlan):
                out.append((pl.model, pl.shared.start, pl.shared.end,
                            pl.shared.alloc))
                out += [(pl.model, a.start, a.end, a.alloc)
                        for a in pl.aligns if a.alloc.n_instances > 0]
            else:
                out.append((pl.model, pl.stage.start, pl.stage.end,
                            pl.stage.alloc))
        return out

    def stage_pools(self):
        """Every deployable (PoolKey, StagePlan) pair — the identity keys
        ``core.plandiff`` matches across replans."""
        for pl in self.plans:
            yield from pl.pools()

    def pool_index(self) -> dict:
        """PoolKey -> aggregated PoolSpec (see ``plandiff.plan_pools``)."""
        from repro_torch.core.plandiff import plan_pools
        return plan_pools(self)

    def with_disagg(self, model: str, n_units: int, *, share: int = 50,
                    batch: int = 4, n_instances: int = 1,
                    prefill_key: Optional[tuple] = None
                    ) -> "ExecutionPlan":
        """A copy of this plan with prefill/decode pool disaggregation
        annotated: the full-range pool over ``[0, n_units)`` (created as
        an extra prefill-role pool if no stage plan spans it) plus a
        decode-role pool of the same range fed over the KV handoff.
        The controller's ``disagg_pressure`` replan produces exactly this
        shape; expressing it as plan *metadata* keeps the transition an
        ordinary pool diff."""
        from repro_torch.core.plandiff import (PoolSpec, decode_pool_key,
                                         plan_pools, pool_range)
        full = (model, 0, int(n_units))
        derived = plan_pools(dataclasses.replace(self, meta={}))
        roles = dict(self.meta.get("pool_roles", {}))
        extra = [sp for sp in self.meta.get("extra_pools", ())
                 if pool_range(sp.key) != pool_range(full)]
        if prefill_key is None:
            prefill_key = full
        if tuple(prefill_key) in derived:
            roles[tuple(prefill_key)] = "prefill"
        else:
            extra.append(PoolSpec(key=tuple(prefill_key), share=share,
                                  batch=batch, n_instances=n_instances,
                                  role="prefill"))
        extra.append(PoolSpec(key=decode_pool_key(model, 0, n_units),
                              share=share, batch=batch,
                              n_instances=n_instances, role="decode"))
        meta = {**self.meta, "pool_roles": roles,
                "extra_pools": tuple(extra)}
        return dataclasses.replace(self, meta=meta)


class GraftPlanner:
    def __init__(self, book: ProfileBook, *,
                 merging_threshold: float = 0.2,
                 merge_strategy: str = "uniform+",
                 group_size: int = 5,
                 group_weights: tuple = (1.0, 1.0, 1.0),
                 d_grid: tuple = DEFAULT_GRID,
                 max_instances: int = 0,
                 consolidate: bool = True,
                 seed: int = 0):
        self.book = book
        self.merging_threshold = merging_threshold
        self.merge_strategy = merge_strategy
        self.group_size = group_size
        self.group_weights = group_weights
        self.d_grid = d_grid
        self.max_instances = max_instances
        self.consolidate = consolidate
        self.seed = seed

    def plan(self, frags: list[Fragment]) -> ExecutionPlan:
        t0 = time.perf_counter()
        merged = merging_mod.merge(frags, self.book,
                                   threshold=self.merging_threshold,
                                   strategy=self.merge_strategy)
        by_model = defaultdict(list)
        for f in merged:
            by_model[f.model].append(f)
        plans, total = [], 0.0
        for model, fs in by_model.items():
            profile = self.book[model]
            groups = group_fragments(fs, group_size=self.group_size,
                                     weights=self.group_weights,
                                     seed=self.seed)
            model_plans = []
            for g in groups:
                r, ps = realign(g, profile, d_grid=self.d_grid,
                                max_instances=self.max_instances)
                model_plans += ps
            if self.consolidate:
                model_plans = self._consolidate(model_plans, profile)
            plans += model_plans
            total += sum(p.resource for p in model_plans)
        return ExecutionPlan(
            plans=plans, total_resource=total,
            n_fragments_in=len(frags), n_fragments_merged=len(merged),
            schedule_time_s=time.perf_counter() - t0)

    def _consolidate(self, plans: list, profile) -> list:
        """BEYOND-PAPER: shared-stage consolidation across groups.

        The paper caps group size at ~5 (Fig. 16a's complexity knee), which
        at large scale fractures identical re-partition points into many
        small shared pools, losing batching that GSLICE+'s global uniform
        merge gets for free (observed in our Fig.18-scale runs). After the
        per-group Algorithm 1 pass, re-run re-alignment once on the UNION
        of fragments of all GroupPlans sharing a re-partition point; accept
        when it lowers resource. Complexity stays bounded: one realign per
        distinct (model, p), and the union's p-loop is pinned near p.
        """
        from repro_torch.core.repartition import GroupPlan
        buckets = defaultdict(list)
        out = []
        for p in plans:
            if isinstance(p, GroupPlan):
                buckets[p.repartition_point].append(p)
            else:
                out.append(p)
        for point, bucket in buckets.items():
            if len(bucket) == 1:
                out.append(bucket[0])
                continue
            union = [f for p in bucket for f in p.fragments]
            r_new, ps_new = realign(union, profile, d_grid=self.d_grid,
                                    max_instances=self.max_instances)
            r_old = sum(p.resource for p in bucket)
            if r_new < r_old:
                out += ps_new
            else:
                out += bucket
        return out
