"""Neurosurgeon-style DNN partitioning (Kang et al., ASPLOS'17) — the
device-side strategy the paper assumes (§5.1; other strategies plug in).

Picks the partition point p minimising estimated end-to-end latency:

  mobile(0..p) + act_bytes(p) / bandwidth + server(p..L | nominal alloc)

and derives the server-side time budget  t = SLO - mobile(0..p) - transfer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.costmodel import LayerCosts
from repro_torch.core.profiles import PerfProfile


@dataclass(frozen=True)
class PartitionDecision:
    p: int
    mobile_ms: float
    transfer_ms: float
    server_est_ms: float
    budget_ms: float                     # server-side time budget
    feasible: bool

    @property
    def total_ms(self) -> float:
        return self.mobile_ms + self.transfer_ms + self.server_est_ms


def partition(profile: PerfProfile, device: str, bandwidth_bps: float,
              slo_ms: float, *, nominal_share: int = 30,
              nominal_batch: int = 4) -> PartitionDecision:
    costs = profile.costs
    L = costs.n_layers
    best: Optional[PartitionDecision] = None
    for p in range(0, L + 1):
        mob = costs.mobile_latency_ms(device, p)
        xfer = costs.act_bytes[p] / bandwidth_bps * 1e3
        srv = float(profile.latency_ms(p, L, nominal_batch, nominal_share)) \
            if p < L else 0.0
        budget = slo_ms - mob - xfer
        d = PartitionDecision(p=p, mobile_ms=mob, transfer_ms=xfer,
                              server_est_ms=srv, budget_ms=budget,
                              feasible=(mob + xfer + srv) <= slo_ms
                              and budget > 0)
        if best is None or d.total_ms < best.total_ms:
            best = d
    return best
