"""RWKV6 WKV scan on Hopper: the wrapper of csrc/wkv6_scan.cu.

The counterpart of the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py::
wkv6_scan``: rwkv6's time-mix recurrence over a whole sequence (prefill,
fragments), returning the final state that decode carries. A tensor on
the CPU goes to the plain version (:func:`wkv6_scan_plain`: the chunked
matmul form with the JAX package's chunk rule); a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts wrapper calls that launched
the kernel, so a run can show its path went through it.

Types: r, k and v in the model dtype (float32 or bfloat16, alike); the
decay w (``exp(-exp(.))`` of a float32 sum), the bonus u and the state
always float32. o comes back in r's dtype.

The kernel cuts time into ``CHUNK``-step chunks (three launches: chunk
states, their carry, then the outputs; ``csrc/wkv6_scan.cu`` says why;
``ref.subchunk_wkv6`` is its algorithm in plain PyTorch). Its scratch, a
state and hd decays per (row, head, chunk), is allocated here once per
device (:func:`scratch`) and grown when a call needs more; one launch
may use it at a time, that is, one stream at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import (_DTYPES, _no_backward,
                                                 _on_cpu, count_launch,
                                                 grown_scratch, unaligned)
from repro_torch.kernels.ref import chunked_wkv6, pick_block

Tensor = torch.Tensor

HEAD_DIMS = (16, 32, 64)      # csrc/wkv6_scan.cu::launch_hd
CHUNK = 64                    # time steps per chunk; csrc/wkv6_scan.cu::C

# kernel launches; chip_smoke.py resets and reads this
LAUNCHES = {"wkv6_scan": 0}


def reset_launches() -> None:
    LAUNCHES["wkv6_scan"] = 0


def wkv6_scan_plain(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                    state: Tensor) -> tuple[Tensor, Tensor]:
    return chunked_wkv6(r, k, v, w, u, state,
                        chunk=pick_block(r.shape[1], 32))


# device -> (chunk states and decays fp32, no tickets), grown on demand
_SCRATCH: dict = {}


def scratch(device: torch.device, B: int, H: int, hd: int,
            n_chunk: int) -> Tensor:
    """The device's fp32 chunk buffer: B H n_chunk hd hd states, then
    B H n_chunk hd decays."""
    return grown_scratch(_SCRATCH, device, B * H * n_chunk * (hd * hd + hd),
                         0)[0]


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def _fn():
    from repro_torch.kernels.build import library
    fn = library("wkv6_scan").wkv6_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
           state: Tensor) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, hd), got {tuple(r.shape)}")
    B, T, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, hd) or tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)} must be ({H}, {hd}) and state "
                         f"{tuple(state.shape)} ({B}, {H}, {hd}, {hd})")
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"empty scan {tuple(r.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype}: the "
                        "kernel takes float32 or bfloat16, all alike")
    for name, t in (("w", w), ("u", u), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous")
    if not (u.is_contiguous() and state.is_contiguous()):
        raise ValueError("u and state must be contiguous")
    if state.data_ptr() % 16:
        raise ValueError("state must start on a 16-byte boundary (the "
                         "kernel reads it in 16-byte pieces)")
    if B > 65535 or H > 65535 or T >= 2 ** 31 - CHUNK:
        raise ValueError(f"shape {tuple(r.shape)} out of the kernel's range")


def wkv6_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
              state: Tensor) -> tuple[Tensor, Tensor]:
    """r,k,v (B,T,H,hd); w (B,T,H,hd) fp32; u (H,hd) fp32; state
    (B,H,hd,hd) fp32 -> (o (B,T,H,hd) in r's dtype, final state fp32)."""
    if _on_cpu(r, "wkv6_scan"):
        return wkv6_scan_plain(r, k, v, w, u, state)
    _no_backward("wkv6_scan", r, k, v, w, u, state)
    _check(r, k, v, w, u, state)
    B, T, H, hd = r.shape
    n_chunk = -(-T // CHUNK)
    fn = _fn()
    o = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    s_out = torch.empty(state.shape, dtype=torch.float32, device=r.device)
    states = scratch(r.device, B, H, hd, n_chunk)
    decays_ptr = states.data_ptr() + 4 * B * H * n_chunk * hd * hd
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), o.data_ptr(),
                 s_out.data_ptr(), states.data_ptr(), decays_ptr,
                 B, T, H, hd, n_chunk,
                 *(s for t in (r, k, v, w) for s in t.stride()[:3]),
                 int(all(unaligned(t) is None for t in (r, k, v))),
                 int(unaligned(w) is None), _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6_scan_fwd launch failed: CUDA error {err}")
    count_launch(LAUNCHES, "wkv6_scan")
    return o, s_out
