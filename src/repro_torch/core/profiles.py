"""Performance profiles: latency / throughput as a function of
(fragment range, batch size, resource share) — Graft's profiler component.

The profile answers the scheduler's only two questions:

  * ``latency_ms(start, end, batch, share)``
  * ``alloc(start, end, budget_ms, rate)`` — the cheapest (share, batch,
    n_instances) meeting the budget and rate, i.e. the ``min_resource``
    call in Algorithm 1 line 10.

Resource unit: 1% of one H100 (a CUDA MPS active-thread share, the
paper's own sharing mechanism). ``resource`` of an allocation = n_instances * share.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np

from repro_torch.core.costmodel import (LayerCosts, PEAK_FLOPS, HBM_BW,
                                  COMPUTE_EFF, MEMORY_EFF,
                                  INSTANCE_OVERHEAD_MS)

MAX_BATCH = 64
SHARES = np.arange(1, 101)               # 1% resource units
BATCHES = np.arange(1, MAX_BATCH + 1)


@dataclass(frozen=True)
class Allocation:
    share: int                           # % of a chip per instance
    batch: int
    n_instances: int
    latency_ms: float                    # per-batch execution latency
    throughput: float                    # RPS across all instances
    resource: float                      # n_instances * share

    def scaled(self, n: int) -> "Allocation":
        return dataclasses.replace(self, n_instances=n,
                                   throughput=self.throughput / self.n_instances * n,
                                   resource=self.share * n)


EMPTY_ALLOC = Allocation(share=0, batch=1, n_instances=0, latency_ms=0.0,
                         throughput=float("inf"), resource=0.0)


class PerfProfile:
    """Latency/throughput profile of one model's fragments."""

    def __init__(self, costs: LayerCosts):
        self.costs = costs
        self.cf = PEAK_FLOPS * COMPUTE_EFF
        self.cm = HBM_BW * MEMORY_EFF
        self._cumF = costs.cum_flops
        self._cumW = costs.cum_weight_bytes
        self._alloc_cache: dict = {}

    # ------------------------------------------------------------------ lat
    def latency_ms(self, start: int, end: int, batch, share) -> np.ndarray:
        """Vectorised over batch/share arrays. share in 1..100."""
        batch = np.asarray(batch, np.float64)
        share = np.asarray(share, np.float64) / 100.0
        F = (self._cumF[end] - self._cumF[start]) * batch
        M = (self._cumW[end] - self._cumW[start]) \
            + (self.costs.act_bytes[start] + self.costs.act_bytes[end]) * batch
        t = np.maximum(F / self.cf, M / self.cm) / share * 1e3
        return t + INSTANCE_OVERHEAD_MS

    # ---------------------------------------------------------------- alloc
    def alloc(self, start: int, end: int, budget_ms: float, rate: float,
              max_instances: int = 0) -> Optional[Allocation]:
        """Cheapest allocation executing blocks [start,end) within
        ``budget_ms`` at aggregate ``rate`` RPS. None if infeasible."""
        if end <= start or rate <= 0:
            return EMPTY_ALLOC
        key = (start, end, round(budget_ms, 3), round(rate, 3), max_instances)
        if key in self._alloc_cache:
            return self._alloc_cache[key]
        lat = self.latency_ms(start, end, BATCHES[:, None], SHARES[None, :])
        ok = lat <= budget_ms                              # (B, S)
        thpt = BATCHES[:, None] / lat * 1e3                # RPS per instance
        with np.errstate(divide="ignore"):
            n = np.ceil(rate / thpt)
        n = np.where(ok, n, np.inf)
        if max_instances:
            n = np.where(n <= max_instances, n, np.inf)
        cost = n * SHARES[None, :]
        idx = np.unravel_index(np.argmin(cost), cost.shape)
        if not np.isfinite(cost[idx]):
            self._alloc_cache[key] = None
            return None
        b, s = int(BATCHES[idx[0]]), int(SHARES[idx[1]])
        ni = int(n[idx])
        a = Allocation(share=s, batch=b, n_instances=ni,
                       latency_ms=float(lat[idx]),
                       throughput=float(thpt[idx] * ni),
                       resource=float(cost[idx]))
        self._alloc_cache[key] = a
        return a

    # -------------------------------------------------------------- margins
    def resource_margin(self, start: int, end: int, budget_ms: float,
                        rate: float) -> float:
        """(q_a - q_d) / q_d for the cheapest allocation (paper §4.1)."""
        a = self.alloc(start, end, budget_ms, rate)
        if a is None or a.resource == 0:
            return 0.0
        return (a.throughput - rate) / rate


class ProfileBook:
    """Registry: model name -> PerfProfile (the profiler's output store)."""

    def __init__(self):
        self._profiles: dict[str, PerfProfile] = {}

    def add(self, costs: LayerCosts) -> PerfProfile:
        prof = PerfProfile(costs)
        self._profiles[costs.name] = prof
        return prof

    def __getitem__(self, name: str) -> PerfProfile:
        return self._profiles[name]

    def __contains__(self, name: str) -> bool:
        return name in self._profiles

    def costs(self, name: str) -> LayerCosts:
        return self._profiles[name].costs


def default_book(*, seq_len: int = 512) -> ProfileBook:
    """Profiles for the paper's five workloads + the 10 assigned archs."""
    from repro_torch.core.paper_models import paper_layer_costs, PAPER_MODELS
    from repro_torch.core.costmodel import arch_layer_costs
    from repro_torch.configs import ARCHS
    book = ProfileBook()
    for m in PAPER_MODELS:
        book.add(paper_layer_costs(m))
    for cfg in ARCHS.values():
        book.add(arch_layer_costs(cfg, seq_len=seq_len))
    return book
