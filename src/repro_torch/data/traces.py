"""Synthetic 5G bandwidth traces.

The paper replays the Raca et al. 5G dataset [55] (driving/static traces,
throughput swinging between ~0 and ~600 Mbit/s on second granularity) with
``tc`` HTB shaping. The dataset is not available offline, so we synthesize
statistically similar traces: a mean-reverting lognormal random walk with
occasional deep fades — the qualitative features (heavy variability, fades,
multi-second coherence) that drive partition-point churn in Fig. 2.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BandwidthTrace:
    """Per-second bandwidth samples in bytes/s."""
    samples: np.ndarray                 # (T,) bytes/s
    period_s: float = 1.0

    def at(self, t: float) -> float:
        i = int(t / self.period_s) % len(self.samples)
        return float(self.samples[i])

    @property
    def mean(self) -> float:
        return float(self.samples.mean())

    def window_mean(self, t: float, horizon_s: float = 30.0) -> float:
        i0 = int(t / self.period_s)
        i1 = i0 + max(1, int(horizon_s / self.period_s))
        idx = np.arange(i0, i1) % len(self.samples)
        return float(self.samples[idx].mean())


def synth_5g_trace(*, seconds: int = 600, seed: int = 0,
                   mean_mbps: float = 180.0, sigma: float = 0.35,
                   revert: float = 0.12, fade_prob: float = 0.02,
                   fade_depth: float = 0.08,
                   min_mbps: float = 4.0, max_mbps: float = 620.0
                   ) -> BandwidthTrace:
    """Mean-reverting lognormal walk with random fades (Mbit/s -> bytes/s)."""
    rng = np.random.RandomState(seed)
    log_mean = np.log(mean_mbps)
    x = log_mean + rng.randn() * sigma
    out = np.empty(seconds)
    fade = 0
    for i in range(seconds):
        x += revert * (log_mean - x) + sigma * rng.randn() * 0.45
        v = float(np.exp(x))
        if fade == 0 and rng.rand() < fade_prob:
            fade = rng.randint(2, 8)                       # fade lasts 2-8s
        if fade > 0:
            v *= fade_depth
            fade -= 1
        out[i] = np.clip(v, min_mbps, max_mbps)
    return BandwidthTrace(samples=out * 1e6 / 8.0)         # Mbit/s -> B/s
