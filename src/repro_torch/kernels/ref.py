"""Plain PyTorch attention: the oracle and the memory-bounded reference.

These are the plain versions of the Hopper attention kernels
(``kernels/flash_attention.py``, ``kernels/decode_attention.py``): the
CPU path runs them, and the kernels are held against them on the card.

Conventions
-----------
q:        (B, Sq, H, hd)
k, v:     (B, Sk, KV, hd)           (GQA: KV divides H)
q_pos:    (B, Sq) int32 global positions of the queries
kv_pos:   (B, Sk) int32 global positions of the keys; -1 marks unwritten slots
window:   0 = full (causal) attention, W>0 = only kv with q_pos-kv_pos < W
causal:   mask kv_pos > q_pos (False for encoder/cross attention)
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def _gqa_scores(q: Tensor, k: Tensor) -> Tensor:
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B, H, Sq, Sk) fp32 with GQA grouping."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    gs = H // KV
    qg = q.reshape(B, Sq, KV, gs, hd)
    s = torch.einsum("bqgsd,bkgd->bgsqk", qg.float(), k.float())
    return s.reshape(B, H, Sq, k.shape[1])


def _mask(q_pos: Tensor, kv_pos: Tensor, *, causal: bool,
          window: int) -> Tensor:
    """(B, Sq, Sk) boolean validity mask."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & ((qp - kp) < window)
    return m


def _positions(n: int, B: int, device) -> Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None].expand(B, n)


def ref_attention(q: Tensor, k: Tensor, v: Tensor, *,
                  q_pos: Optional[Tensor] = None,
                  kv_pos: Optional[Tensor] = None,
                  seg_q: Optional[Tensor] = None,
                  seg_kv: Optional[Tensor] = None,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None,
                  return_lse: bool = False):
    """Naive full-materialisation attention — the oracle.

    seg_q/seg_kv (B, Sq)/(B, Sk) int32: sequence-packing segment ids —
    attention is confined to seg_q == seg_kv. Positions stay GLOBAL
    packed coordinates, so only RoPE (applied by the caller) needs
    per-segment positions. Rows with no valid kv give 0.

    ``return_lse`` also returns the per-row logsumexp (B, H, Sq) fp32 of
    the scaled, masked scores (``NEG_INF`` for rows with no valid kv).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q_pos is None:
        q_pos = _positions(Sq, B, q.device)
    if kv_pos is None:
        kv_pos = _positions(Sk, B, q.device)
    scale = scale if scale is not None else hd ** -0.5
    s = _gqa_scores(q, k) * scale                       # (B,H,Sq,Sk) fp32
    m = _mask(q_pos, kv_pos, causal=causal, window=window)
    if seg_q is not None:
        m = m & (seg_q[:, :, None] == seg_kv[:, None, :])
    m = m[:, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with no valid kv produce uniform junk; zero them for determinism
    valid = m.any(dim=-1, keepdim=True)
    p = torch.where(valid, p, torch.zeros_like(p))
    gs = H // KV
    pv = p.reshape(B, KV, gs, Sq, Sk)
    o = torch.einsum("bgsqk,bkgd->bqgsd", pv, v.float())
    o = o.reshape(B, Sq, H, hd).to(q.dtype)
    if return_lse:
        lse = torch.where(valid[..., 0], torch.logsumexp(s, dim=-1),
                          torch.full_like(s[..., 0], NEG_INF))
        return o, lse
    return o


def attend_cache_plain(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                       kv_pos: Tensor, *, window: int = 0,
                       scale: Optional[float] = None) -> Tensor:
    """One query token per row against a (possibly ring-buffer) cache:
    q (B,1,H,hd), k/v (B,Sk,KV,hd), q_pos (B,), kv_pos (B,Sk) with -1 for
    unwritten slots. The plain version of the decode kernel
    (``kernels/decode_attention.py``); a row with no valid slot gives 0."""
    return ref_attention(q, k, v, q_pos=q_pos[:, None], kv_pos=kv_pos,
                         causal=True, window=window, scale=scale)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *,
                      q_pos: Optional[Tensor] = None,
                      kv_pos: Optional[Tensor] = None,
                      seg_ids: Optional[Tensor] = None,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      q_chunk: int = 1024) -> Tensor:
    """Memory-bounded reference: loop over query chunks, full softmax inside.

    Peak score memory is (B, H, q_chunk, Sk) instead of (B, H, Sq, Sk).
    seg_ids (B, S): self-attention segment mask for packed batches.
    """
    B, Sq, H, hd = q.shape
    if Sq <= q_chunk:
        return ref_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                             seg_q=seg_ids, seg_kv=seg_ids,
                             causal=causal, window=window, scale=scale)
    if q_pos is None:
        q_pos = _positions(Sq, B, q.device)
    if kv_pos is None:
        kv_pos = _positions(k.shape[1], B, q.device)
    seg_kv = seg_ids
    pad = (-Sq) % q_chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=0)
        if seg_ids is not None:
            # pad q rows with a segment id no kv row carries: fully
            # masked rows, zeroed by the oracle's all-masked guard
            seg_ids = torch.nn.functional.pad(seg_ids, (0, pad), value=-2)
    outs = []
    for i in range(0, q.shape[1], q_chunk):
        sl = slice(i, i + q_chunk)
        outs.append(ref_attention(
            q[:, sl], k, v, q_pos=q_pos[:, sl], kv_pos=kv_pos,
            seg_q=None if seg_ids is None else seg_ids[:, sl],
            seg_kv=seg_kv, causal=causal, window=window, scale=scale))
    return torch.cat(outs, dim=1)[:, :Sq]
