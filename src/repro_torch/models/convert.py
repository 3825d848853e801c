"""Weights from the JAX package's parameter tree to the port's.

The two packages share one parameter layout (nested dicts, block weights
stacked on a leading layer axis), so converting is a leaf-by-leaf copy.
Callers hand over numpy leaves (``jax.device_get`` of the JAX tree), so
this module needs no JAX. bf16 leaves arrive as ``ml_dtypes`` arrays,
which torch cannot read: their raw 16 bits are viewed as int16 and then
as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_jax_params(tree: dict, *, device="cpu") -> dict:
    """Nested dict of numpy arrays (float32 or ml_dtypes bfloat16) -> the
    same nesting of torch tensors on ``device``."""
    return {k: from_jax_params(v, device=device) if isinstance(v, dict)
            else _leaf(v, device) for k, v in tree.items()}
