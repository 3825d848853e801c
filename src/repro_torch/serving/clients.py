"""Mobile client simulation: each client runs hybrid DL over a bandwidth
trace, re-partitioning via Neurosurgeon as conditions change, and offers
its server-side fragment (p, t, q) to the scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.fragment import Fragment
from repro_torch.core.profiles import ProfileBook
from repro_torch.data.traces import BandwidthTrace
from repro_torch.serving.neurosurgeon import partition, PartitionDecision


@dataclass
class MobileClient:
    name: str
    model: str
    device: str                          # "nano" | "tx2"
    trace: BandwidthTrace
    rate: float                          # RPS
    slo_ratio: float = 0.95              # SLO = ratio * mobile full latency

    def slo_ms(self, book: ProfileBook) -> float:
        costs = book.costs(self.model)
        return self.slo_ratio * costs.mobile_latency_ms(
            self.device, costs.n_layers)

    def decision(self, book: ProfileBook, t: float, *,
                 use_average_bw: bool = False) -> PartitionDecision:
        bw = self.trace.mean if use_average_bw else self.trace.at(t)
        return partition(book[self.model], self.device, bw,
                         self.slo_ms(book))

    def fragment(self, book: ProfileBook, t: float, *,
                 use_average_bw: bool = False) -> Optional[Fragment]:
        """The server-side fragment at time t (None if fully on-device)."""
        d = self.decision(book, t, use_average_bw=use_average_bw)
        L = book.costs(self.model).n_layers
        if d.p >= L:
            return None
        return Fragment(model=self.model, p=d.p,
                        t=max(d.budget_ms, 1e-3), q=self.rate,
                        client=self.name, device=self.device)


def make_fleet(model: str, book: ProfileBook, *, n_nano: int = 4,
               n_tx2: int = 0, rate: float = 30.0, seed: int = 0,
               slo_ratio: float = 0.95,
               trace_kw: Optional[dict] = None) -> list[MobileClient]:
    """The paper's testbeds: 4 Nanos (small homo), +2 TX2 (small hetero),
    20 emulated (large), thousands (massive sim)."""
    from repro_torch.data.traces import synth_5g_trace
    trace_kw = trace_kw or {}
    fleet = []
    for i in range(n_nano + n_tx2):
        dev = "nano" if i < n_nano else "tx2"
        tr = synth_5g_trace(seed=seed * 1000 + i, **trace_kw)
        fleet.append(MobileClient(
            name=f"{dev}{i}", model=model, device=dev, trace=tr,
            rate=rate, slo_ratio=slo_ratio))
    return fleet


def fleet_fragments(fleet: list[MobileClient], book: ProfileBook,
                    t: float = 0.0, *, use_average_bw: bool = False
                    ) -> list[Fragment]:
    out = []
    for c in fleet:
        f = c.fragment(book, t, use_average_bw=use_average_bw)
        if f is not None:
            out.append(f)
    return out
