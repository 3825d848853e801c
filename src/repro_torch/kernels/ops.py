"""The attention entry points the models call.

A tensor on the CPU runs the plain PyTorch version; a CUDA tensor runs
the Hopper kernel (``kernels/flash_attention.py``,
``kernels/decode_attention.py``) or raises. There is no block-size
choice here: the kernels tile the sequence themselves and mask the
ragged edge.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_lse)

Tensor = torch.Tensor


def attention(q: Tensor, k: Tensor, v: Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None,
              seg_ids: Optional[Tensor] = None) -> Tensor:
    """Prefill attention. q (B,Sq,H,hd), k/v (B,Sk,KV,hd).

    seg_ids (B, S) int32: sequence-packing segment mask for ragged
    batches (``models.packed``) — attention stays within segments.
    """
    if seg_ids is not None:
        # the packed serving path: the segment-masked kernel
        return flash_attention(q, k, v, seg_ids, causal=causal,
                               window=window, scale=scale)
    # every unsegmented call: the kernel that also yields the logsumexp,
    # as the JAX package reaches its trainable forward here
    o, _ = flash_attention_lse(q, k, v, causal=causal, window=window,
                               scale=scale)
    return o


def attend_cache(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                 kv_pos: Tensor, *, window: int = 0,
                 scale: Optional[float] = None) -> Tensor:
    """Single-token decode attention against a (possibly ring-buffer)
    cache. q (B,1,H,hd), k/v (B,Sk,KV,hd), q_pos (B,), kv_pos (B,Sk)."""
    return decode_attention(q, k, v, q_pos, kv_pos, window=window,
                            scale=scale)
