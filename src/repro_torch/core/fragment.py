"""Fragment abstraction: what a mobile client offloads to the server."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.costmodel import LayerCosts


@dataclass(frozen=True)
class Fragment:
    """A server-side DNN fragment: blocks [p, L) of ``model``.

    t  — server-side time budget (ms) for one request (SLO minus device
         compute minus transfer).
    q  — request rate (RPS) feeding this fragment.
    """
    model: str
    p: int
    t: float
    q: float
    client: str = ""
    device: str = "nano"
    merged_from: tuple = ()

    def vec(self) -> np.ndarray:
        return np.array([self.p, self.t, self.q], np.float64)


def merge_fragments(frags: list[Fragment]) -> Fragment:
    """Merge uniform fragments (same model + partition point): rates add,
    the budget is the most restrictive one."""
    assert len({f.model for f in frags}) == 1
    assert len({f.p for f in frags}) == 1
    return Fragment(
        model=frags[0].model,
        p=frags[0].p,
        t=min(f.t for f in frags),
        q=sum(f.q for f in frags),
        client="+".join(f.client for f in frags if f.client),
        device=frags[0].device,
        merged_from=tuple(frags),
    )


def normalization_scales(frags: list[Fragment]) -> np.ndarray:
    """Per-dimension scales for (p, t, q) similarity distances."""
    v = np.stack([f.vec() for f in frags])
    s = v.max(axis=0) - v.min(axis=0)
    s[s == 0] = 1.0
    return s
