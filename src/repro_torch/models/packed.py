"""Sequence-packed (ragged) fragment execution.

Instead of padding every payload in a batch to a common length and
stacking along a batch axis, heterogeneous-length payloads are
concatenated along the TOKEN axis into one ``(1, T)`` buffer with
cu_seqlens-style segment boundaries. Per-token segment ids mask
attention so packed requests never attend across each other, and
per-segment positions restart RoPE at every boundary — making the
packed forward numerically identical to running each request alone.

Only the tail of the buffer is padded (to a quantized token bucket,
``serving.batcher.token_bucket``), so padding waste is bounded by the
bucket rounding regardless of how the batch mixes lengths.

The packed program takes the fragment's ``start`` as a runtime index
into the stacked block params, so every pool of one depth runs the same
code whatever its offset (in the JAX package, one compiled program per
depth; PyTorch runs eagerly and compiles nothing).

Packability: families whose per-token math is invariant to how tokens
are grouped into batches. ``dense`` always qualifies; ``moe`` only with
the dense dispatch; recurrent families (``ssm``/``hybrid``) and the
extras-carrying ``vlm``/``audio`` do not. Non-packable pools fall back
to the pad-to-bucket path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import (n_fragment_units, slice_blocks,
                                            stack_forward, unembed)

Tensor = torch.Tensor


def is_packable(cfg: ModelConfig, extras=None) -> bool:
    """Can this (config, extras) combination run sequence-packed?"""
    if extras:
        return False
    if cfg.family == "dense":
        return True
    if cfg.family == "moe":
        return cfg.moe_impl == "dense"
    return False


def pack_segments(lengths, pad_to: int):
    """Packed layout for ``lengths`` padded to ``pad_to`` total tokens.

    Returns ``(seg_ids, positions, cu_seqlens)`` as numpy arrays:
    ``seg_ids`` (pad_to,) int32 gives each token its request index (pad
    tokens get the out-of-range id ``len(lengths)`` so they form their
    own segment); ``positions`` (pad_to,) int32 restarts at 0 per segment
    (RoPE); ``cu_seqlens`` (len+1,) are the segment boundary offsets —
    request ``i`` owns tokens ``[cu[i], cu[i+1])``.
    """
    lengths = [int(n) for n in lengths]
    total = sum(lengths)
    if pad_to < total:
        raise ValueError(f"pad_to={pad_to} < total tokens {total}")
    cu = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=cu[1:])
    seg = np.empty(pad_to, np.int32)
    pos = np.empty(pad_to, np.int32)
    for i, n in enumerate(lengths):
        seg[cu[i]:cu[i + 1]] = i
        pos[cu[i]:cu[i + 1]] = np.arange(n, dtype=np.int32)
    seg[total:] = len(lengths)
    pos[total:] = np.arange(pad_to - total, dtype=np.int32)
    return seg, pos, cu


def _packed_forward(params: dict, inputs: Tensor, seg_ids: Tensor,
                    positions: Tensor, start: int, *, cfg: ModelConfig,
                    depth: int, embed: bool, head: bool) -> Tensor:
    """Blocks ``[start, start+depth)`` over a packed ``(1, T)`` buffer.

    ``start`` is a runtime index: the blocks are views sliced out of the
    stacked layer params, so the code depends only on (depth, embed,
    head) — not on where in the stack the fragment sits.
    """
    x = inputs
    if embed:
        x = params["embed"][inputs.long()]
    blocks = slice_blocks(params["blocks"], start, start + depth)
    x, _ = stack_forward(blocks, cfg, x, window=cfg.sliding_window,
                         seg_ids=seg_ids, positions=positions)
    if head:
        x = unembed(params, cfg, x)
    return x


def run_fragment_packed(params: dict, cfg: ModelConfig, payloads, start: int,
                        end: int, *, pad_to=None) -> list:
    """Run blocks ``[start, end)`` over per-request ``payloads`` packed
    into one buffer; returns the per-request outputs (pad stripped).

    ``payloads``: tensors of token ids (S_i,) when start == 0, else
    hidden states (S_i, d), all on one device. ``pad_to`` pads the packed
    token axis (e.g. to a token bucket); default is the exact total.
    """
    L = n_fragment_units(cfg)
    lengths = [int(p.shape[0]) for p in payloads]
    total = sum(lengths)
    T = int(pad_to) if pad_to else total
    seg, pos, cu = pack_segments(lengths, T)
    cat = torch.cat(list(payloads), dim=0)
    dev = cat.device
    if T > total:
        cat = torch.cat([cat, cat.new_zeros((T - total, *cat.shape[1:]))])
    y = _packed_forward(params, cat[None],
                        torch.from_numpy(seg).to(dev)[None],
                        torch.from_numpy(pos).to(dev)[None], int(start),
                        cfg=cfg, depth=end - start, embed=start == 0,
                        head=end == L)
    return [y[0, int(cu[i]):int(cu[i + 1])] for i in range(len(lengths))]
