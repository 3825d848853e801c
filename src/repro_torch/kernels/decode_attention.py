"""Flash-decoding on Hopper: the wrapper of csrc/decode_attention.cu.

The counterpart of the Pallas TPU kernel ``repro/kernels/
decode_attention.py::decode_attention``: one query token per batch row
against a (possibly ring-buffer) KV cache, every decode step of every
layer. A tensor on the CPU goes to the plain version
(:func:`decode_attention_plain`, ``ref.attend_cache_plain``); a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts wrapper calls
that launched the kernel, so a run can show its decode path went
through it.

The kernel splits the cache into ``SPLIT``-position pieces
(flash-decoding): ``ceil(Sk / SPLIT)`` blocks per (kv head, row), each
writing a partial softmax state to fp32 scratch; the last block of each
(row, kv head) to finish merges them in the same launch, counted by an
int32 ticket. The scratch and the tickets are allocated here once per
device (:func:`scratch`) and grown when a larger batch, kv head count,
split count or head dim comes; no call allocates anything else but its
output (and, with ``return_lse``, the (B, H) log-sum-exp with which the
shards of a sequence-sharded cache merge: ``spmd.merge_softmax``). The
tickets assume one launch in flight at a time, that is, one stream at a
time. The split count depends on ``Sk`` alone, never on the
batch, so a row's result does not depend on its batch
(``csrc/decode_attention.cu`` says why that matters).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (HEAD_DIMS, _DTYPES,
                                                 _no_backward, _on_cpu,
                                                 count_launch, grown_scratch,
                                                 unaligned)
from repro_torch.kernels.ref import attend_cache_plain

Tensor = torch.Tensor

SPLIT = 64           # kv positions per split; csrc/decode_attention.cu::SPLIT
MAX_GROUP = 16       # q heads per kv head the kernel keeps in registers

# kernel launches; chip_smoke.py resets and reads this
LAUNCHES = {"decode_attention": 0}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def decode_attention_plain(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                           kv_pos: Tensor, *, window: int = 0,
                           scale: Optional[float] = None,
                           return_lse: bool = False):
    return attend_cache_plain(q, k, v, q_pos, kv_pos, window=window,
                              scale=scale, return_lse=return_lse)


# device -> (partial sums and (m, l) fp32, tickets int32), grown on demand
_SCRATCH: dict = {}


def scratch(device: torch.device, B: int, KV: int, G: int, hd: int,
            n_split: int) -> tuple[Tensor, Tensor]:
    """The device's fp32 partial states (B KV n_split G (hd + 2) values:
    the splits' sums, then their (m, l) pairs) and its B KV tickets."""
    return grown_scratch(_SCRATCH, device, B * KV * n_split * G * (hd + 2),
                         B * KV)


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _fn():
    from repro_torch.kernels.build import library
    fn = library("decode_attention").decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor,
           window: int) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, head_dim), got "
                         f"{tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if Sk == 0:
        raise ValueError("empty cache (Sk == 0)")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"n_heads {H} must be a multiple of kv heads {KV}, "
                         f"at most {MAX_GROUP} per kv head")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        "kernel takes float32 or bfloat16, all alike")
    if tuple(q_pos.shape) != (B,) or tuple(kv_pos.shape) != (B, Sk) \
            or q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise ValueError(f"q_pos must be int32 ({B},) and kv_pos int32 "
                         f"({B}, {Sk}); got {q_pos.dtype} "
                         f"{tuple(q_pos.shape)}, {kv_pos.dtype} "
                         f"{tuple(kv_pos.shape)}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        why = unaligned(t)
        if why:
            raise ValueError(f"{name}: {why}; the kernel reads it in "
                             "16-byte pieces")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if B > 65535 or KV > 65535 or Sk >= 2 ** 31 or B * H >= 2 ** 31:
        raise ValueError(f"shape {tuple(k.shape)} out of the kernel's range")


def decode_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                     kv_pos: Tensor, *, window: int = 0,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """q (B,1,H,hd); k/v (B,Sk,KV,hd); q_pos (B,) int32; kv_pos (B,Sk)
    int32 (-1 = unwritten slot) -> (B,1,H,hd) in q's dtype; with
    ``return_lse`` also each (row, head)'s log-sum-exp of its scaled,
    masked scores, (B, H) fp32, -inf for a row with no valid slot. An
    empty cache (``Sk == 0``: a rank's share of a sequence-sharded cache
    can be empty) launches nothing and gives o = 0, lse = -inf."""
    if _on_cpu(q):
        return decode_attention_plain(q, k, v, q_pos, kv_pos, window=window,
                                      scale=scale, return_lse=return_lse)
    _no_backward("decode_attention", q, k, v)
    if k.dim() == 4 and k.shape[1] == 0 and q.dim() == 4:
        o = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.full((q.shape[0], q.shape[2]), float("-inf"),
                         device=q.device)
        return (o, lse) if return_lse else o
    _check(q, k, v, q_pos, kv_pos, window)
    B, _, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    n_split = -(-Sk // SPLIT)
    fn = _fn()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    part, ticket = scratch(q.device, B, KV, H // KV, hd, n_split)
    ml_ptr = part.data_ptr() + 4 * B * n_split * H * hd   # after the sums
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 kv_pos.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), part.data_ptr(),
                 ml_ptr, ticket.data_ptr(),
                 B, Sk, H, KV, hd, n_split,
                 q.stride(0), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 kv_pos.stride(0), o.stride(0), o.stride(2),
                 float(scale), int(window), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed: CUDA error "
                           f"{err}")
    count_launch(LAUNCHES, "decode_attention")
    return (o, lse) if return_lse else o
