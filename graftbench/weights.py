"""Seeded random weights in the port's parameter layout.

The layout (every leaf's name, shape and dtype) is the port's own, read
from ``repro_torch.models.init_params`` on the meta device, which
allocates nothing. The numbers are drawn here, on the device, in a few
large calls: one standard normal draw per dtype into a flat buffer, which
the leaves then view. A leaf is scaled in place by its fan-in (0.02 for
the embedding); norm and qk-norm scales are ones. The same tensors feed
the port and the reference.
"""
from __future__ import annotations

import math

import torch

_ONES = ("scale", "q_norm", "k_norm")


def _leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + ".")
        else:
            yield name, v


def _std(name: str, shape: tuple) -> float:
    if name == "embed":
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def make_weights(cfg, seed: int, device) -> dict:
    """-> params for ``cfg`` on ``device``, drawn from ``seed``."""
    import sys
    import time
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    meta = init_params(cfg, device="meta")
    t1 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    leaves = list(_leaves(meta))
    drawn = [(n, t) for n, t in leaves if n.split(".")[-1] not in _ONES]
    flat: dict = {}
    for dt in sorted({t.dtype for _, t in drawn}, key=str):
        n = sum(t.numel() for _, t in drawn if t.dtype == dt)
        flat[dt] = torch.randn(n, dtype=dt, device=device, generator=gen)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    offset = {dt: 0 for dt in flat}
    out: dict = {}
    for name, t in leaves:
        key = name.split(".")[-1]
        if key in _ONES:
            leaf = torch.ones(t.shape, dtype=t.dtype, device=device)
        else:
            o = offset[t.dtype]
            leaf = flat[t.dtype][o:o + t.numel()].view(t.shape)
            offset[t.dtype] = o + t.numel()
            leaf.mul_(_std(name, tuple(t.shape)))
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    print(f"[graftbench] weights: layout {t1 - t0:.3f} s, draws "
          f"{t2 - t1:.3f} s, views {time.perf_counter() - t2:.3f} s",
          file=sys.stderr)
    return out
