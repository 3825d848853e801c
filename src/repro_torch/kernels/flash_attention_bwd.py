"""Flash-attention backward on Hopper: wrappers of csrc/flash_attention_bwd.cu,
and the trainable attention built on them.

The counterpart of the JAX package's ``repro/kernels/flash_attention_bwd.py``:

  * :func:`flash_attention_bwd` — ``_flash_bwd``, the FlashAttention-2
    backward: its dq kernel (:func:`launch_dq`) and its dkv kernel
    (:func:`launch_dkv`), launched in that order (the dq kernel also
    writes ``D = rowsum(dO o)``, which the dkv kernel reads);
  * :class:`FlashAttention` / :func:`flash_attention_trainable` — the
    ``custom_vjp`` of ``flash_attention_trainable``: the forward is
    ``kernels/flash_attention.py::flash_attention_lse``, the backward
    :func:`flash_attention_bwd`.

The dtype picks the kernels' bodies in the source: bfloat16 runs on the
tensor cores (``wgmma``, operands loaded by TMA), float32 on scalar FMA.
A bfloat16 input that TMA cannot read (a base not 16-byte aligned, or a
stride that is not a positive multiple of 16 bytes) raises
``ValueError``; :class:`FlashAttention` hands the kernels a packed copy
of such an incoming gradient.

A tensor on the CPU goes to the plain version,
:func:`flash_attention_bwd_plain` (the FA-2 formulas written out on full
tensors); a CUDA tensor launches the kernels or raises. ``LAUNCHES``
counts kernel launches, so a run can show its path went through them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import (HEAD_DIMS, _DTYPES, _on_cpu,
                                                 count_launch,
                                                 flash_attention_lse,
                                                 tma_unreadable)
from repro_torch.kernels.ref import NEG_INF, _acc_dtype, _mask, _positions

Tensor = torch.Tensor

# kernel launches per kernel; chip_smoke.py resets and reads these
LAUNCHES = {"flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain version (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                              lse: Tensor, do: Tensor, *, causal: bool = True,
                              window: int = 0, scale: Optional[float] = None
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """The FA-2 backward on full (B, heads, Sq, Sk) tensors, in float32
    (float64 for float64 inputs): p = exp(s scale - lse) inside the mask,
    0 outside; ds = p (dO v^T - D) scale with D = rowsum(dO o); dq = ds k,
    dk = ds^T q and dv = p^T dO summed over each kv head's GQA group.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    acc = _acc_dtype(q)
    qg = q.to(acc).reshape(B, Sq, KV, G, hd)
    dog = do.to(acc).reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(acc), v.to(acc)
    mask = _mask(_positions(Sq, B, q.device), _positions(Sk, B, q.device),
                 causal=causal, window=window)[:, None, None]
    s = torch.einsum("bqgsd,bkgd->bgsqk", qg, kf) * scale
    lse_g = lse.to(acc).reshape(B, KV, G, Sq, 1)
    # the mask before the exponential: a row with lse = NEG_INF gives 0
    p = torch.exp(torch.where(mask, s - lse_g, torch.full_like(s, NEG_INF)))
    dvec = (do.to(acc) * o.to(acc)).sum(-1)                     # (B, Sq, H)
    dvec = dvec.reshape(B, Sq, KV, G).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqgsd,bkgd->bgsqk", dog, vf)
    ds = p * (dp - dvec) * scale
    dq = torch.einsum("bgsqk,bkgd->bqgsd", ds, kf).reshape(B, Sq, H, hd)
    dk = torch.einsum("bgsqk,bqgsd->bkgd", ds, qg)
    dv = torch.einsum("bgsqk,bqgsd->bkgd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_ARGTYPES = {
    "flash_attention_bwd_dq": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                               + [ctypes.c_longlong] * 15),
    "flash_attention_bwd_dkv": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                + [ctypes.c_longlong] * 12),
}
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]


def _fn(name: str):
    from repro_torch.kernels.build import library
    fn = getattr(library("flash_attention_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name] + _TAIL
        fn.restype = ctypes.c_int
    return fn


def _check(q: Tensor, k: Tensor, v: Tensor, lse: Tensor, do: Tensor,
           window: int, **more: Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"n_heads {H} not a multiple of kv heads {KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if min(B, Sq, Sk) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    named = dict(q=q, k=k, v=v, do=do, **more)
    for name, t in named.items():
        if t.dtype != q.dtype or q.dtype not in _DTYPES:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}: the kernels "
                            "take float32 or bfloat16, all alike")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous")
        # the bf16 bodies load q, k, v and dO by TMA and read o with
        # 16-byte loads
        why = tma_unreadable(t) if q.dtype == torch.bfloat16 else None
        if why is not None:
            raise ValueError(f"{name}'s {why} (the bf16 kernels load it by "
                             "TMA)")
    for name in ("do", *more):
        if named[name].shape != q.shape:
            raise ValueError(f"{name} {tuple(named[name].shape)} != q "
                             f"{tuple(q.shape)}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({B}, {H}, {Sq}) "
                         f"on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if max(B * H, Sq, Sk) >= 2 ** 31 or B * H > 65535:
        raise ValueError(f"shape {tuple(q.shape)} out of the kernels' range")


def _strides(*ts: Tensor) -> list:
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _tail(q: Tensor, scale: Optional[float], causal: bool,
          window: int) -> list:
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return [float(scale), int(bool(causal)), int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream]


def launch_dq(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
              do: Tensor, *, causal: bool = True, window: int = 0,
              scale: Optional[float] = None) -> tuple[Tensor, Tensor]:
    """The dq kernel (CUDA tensors only): -> (dq in q's dtype, D (B, H, Sq)
    fp32 = rowsum(dO o), which :func:`launch_dkv` takes)."""
    _check(q, k, v, lse, do, window, o=o)
    B, Sq, H, hd = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _fn("flash_attention_bwd_dq")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                 dq.data_ptr(), B, Sq, k.shape[1], H, k.shape[2], hd,
                 *_strides(q, k, v, o, do), *_tail(q, scale, causal, window))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA "
                           f"error {err}")
    count_launch(LAUNCHES, "flash_attention_bwd_dq")
    return dq, dvec


def launch_dkv(q: Tensor, k: Tensor, v: Tensor, lse: Tensor, do: Tensor,
               dvec: Tensor, *, causal: bool = True, window: int = 0,
               scale: Optional[float] = None) -> tuple[Tensor, Tensor]:
    """The dkv kernel (CUDA tensors only), given the ``D`` that
    :func:`launch_dq` returned: -> (dk, dv) in k's and v's dtypes."""
    _check(q, k, v, lse, do, window)
    if dvec.shape != lse.shape or dvec.dtype != torch.float32 or \
            dvec.device != q.device or not dvec.is_contiguous():
        raise ValueError("D must be contiguous float32 shaped like lse")
    B, Sq, H, hd = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    fn = _fn("flash_attention_bwd_dkv")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, Sq, k.shape[1], H, k.shape[2], hd,
                 *_strides(q, k, v, do), *_tail(q, scale, causal, window))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA "
                           f"error {err}")
    count_launch(LAUNCHES, "flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        lse: Tensor, do: Tensor, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """Gradients of the unsegmented attention o = attn(q, k, v) given the
    forward's o and lse (B, H, Sq) fp32 and the incoming dO: -> (dq, dk,
    dv). q, o, dO (B, Sq, H, hd); k, v (B, Sk, KV, hd)."""
    if _on_cpu(q, "flash_attention_bwd"):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, scale=scale)
    kw = dict(causal=causal, window=window, scale=scale)
    dq, dvec = launch_dq(q, k, v, o, lse, do, **kw)
    dk, dv = launch_dkv(q, k, v, lse, do, dvec, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the trainable attention
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v): the forward kernel saves (q, k, v, o, lse);
    the backward runs the two backward kernels (plain versions on the
    CPU). The counterpart of ``flash_attention_trainable``'s custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over an expanded (stride 0) or strided view;
        # the kernels read strided rows but need a contiguous last axis,
        # and the bf16 bodies a view TMA can load: else a packed copy
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and
                                  tma_unreadable(do) is not None):
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q: Tensor, k: Tensor, v: Tensor, *,
                              causal: bool = True, window: int = 0,
                              scale: Optional[float] = None) -> Tensor:
    """Differentiable unsegmented attention: q (B, Sq, H, hd), k/v
    (B, Sk, KV, hd) -> o (B, Sq, H, hd) in q's dtype."""
    return FlashAttention.apply(q, k, v, causal, window, scale)
