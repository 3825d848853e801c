"""The kernel entry points the models call: attention and the two
recurrent scans.

A tensor on the CPU runs the plain PyTorch version; a CUDA tensor runs
the Hopper kernel (``kernels/flash_attention.py``,
``kernels/flash_attention_bwd.py``, ``kernels/decode_attention.py``,
``kernels/ssm_scan.py``, ``kernels/wkv6_scan.py``) or raises.
Unsegmented :func:`attention` is differentiable on both devices (its
backward is the FA-2 backward: kernels on the card, the plain formulas
on the CPU); the segmented, decode and scan kernels have no backward, as
in the JAX package, and raise on the card when autograd records and an
input requires grad. Their plain versions on the CPU stay
differentiable by autograd. There is no block-size choice here:
the attention kernels tile the sequence themselves and the scans walk it
token by token, masking the ragged edge; the scans' plain versions keep
the JAX package's chunk rule. The one-token step functions
(:func:`ssm_step`, :func:`wkv6_step`) are plain tensor ops on either
device, as in the JAX package (no Pallas kernel there).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_trainable
from repro_torch.kernels.ref import LOG_DECAY_MIN, wkv6_log_decay
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.wkv6_scan import wkv6_scan

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
    # every unsegmented call: the trainable attention (forward kernel with
    # the logsumexp, backward kernels for dq and dk/dv), as the JAX
    # package reaches flash_attention_trainable here
    return flash_attention_trainable(q, k, v, causal=causal, window=window,
                                     scale=scale)


def attend_cache(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                 kv_pos: Tensor, *, window: int = 0,
                 scale: Optional[float] = None) -> Tensor:
    """Single-token decode attention against a (possibly ring-buffer)
    cache. q (B,1,H,hd), k/v (B,Sk,KV,hd), q_pos (B,), kv_pos (B,Sk)."""
    return decode_attention(q, k, v, q_pos, kv_pos, window=window,
                            scale=scale)


# ---------------------------------------------------------------------------
# RWKV6 WKV
# ---------------------------------------------------------------------------

def wkv6(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
         state: Tensor) -> tuple[Tensor, Tensor]:
    """Whole-sequence WKV6. r,k,v,w (B,T,H,hd); u (H,hd); state
    (B,H,hd,hd) fp32 -> (o, final state)."""
    return wkv6_scan(r, k, v, w, u, state)


def wkv6_step(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
              state: Tensor) -> tuple[Tensor, Tensor]:
    """One-token WKV6 update (decode path; recurrence is trivial here).

    r,k,v,w: (B,1,H,hd); state (B,H,hd,hd) fp32.
    """
    rt, kt, vt, wt = (x[:, 0].float() for x in (r, k, v, w))
    wt = torch.exp(wkv6_log_decay(wt))
    kv = kt[..., :, None] * vt[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", rt,
                     state + u[None, :, :, None] * kv)
    new = wt[..., :, None] * state + kv
    return o[:, None].to(r.dtype), new


# ---------------------------------------------------------------------------
# Selective SSM scan
# ---------------------------------------------------------------------------

def ssm(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
        state: Tensor) -> tuple[Tensor, Tensor]:
    """Whole-sequence selective scan. x (B,T,H,hd); dt (B,T,H); A (H,);
    Bm/Cm (B,T,N); state (B,H,hd,N) fp32 -> (y, final state)."""
    return ssm_scan(x, dt, A, Bm, Cm, state)


def ssm_step(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
             state: Tensor) -> tuple[Tensor, Tensor]:
    """One-token SSM update. x (B,1,H,hd); dt (B,1,H); Bm/Cm (B,1,N)."""
    xt = x[:, 0].float()
    dtt = dt[:, 0].float()
    bt, ct = Bm[:, 0].float(), Cm[:, 0].float()
    a = torch.exp(torch.clamp(dtt * A[None], LOG_DECAY_MIN, 0.0))
    h = a[..., None, None] * state \
        + (dtt[..., None] * xt)[..., None] * bt[:, None, None, :]
    y = torch.einsum("bhdn,bn->bhd", h, ct)
    return y[:, None].to(x.dtype), h
