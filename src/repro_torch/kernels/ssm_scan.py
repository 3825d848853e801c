"""Selective SSM scan on Hopper: the wrapper of csrc/ssm_scan.cu.

The counterpart of the Pallas TPU kernel ``repro/kernels/ssm_scan.py::
ssm_scan``: hymba's mamba2-style heads over a whole sequence (prefill,
fragments), returning the final state that decode carries. A tensor on
the CPU goes to the plain version (:func:`ssm_scan_plain`: the chunked
matmul form with the JAX package's chunk rule); a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts wrapper calls that launched
the kernel, so a run can show its path went through it.

Types: x, Bm and Cm in the model dtype (float32 or bfloat16, alike); dt,
A and the state always float32 (``xc @ w_dt + dt_bias`` promotes to
float32 in both frameworks). y comes back in x's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import _DTYPES, _no_backward, _on_cpu
from repro_torch.kernels.ref import chunked_ssm_scan, pick_block

Tensor = torch.Tensor

STATE_DIMS = (4, 8, 16, 32)   # csrc/ssm_scan.cu::launch_n
MAX_THREADS = 1024            # hd * N, one state element per thread

# kernel launches; chip_smoke.py resets and reads this
LAUNCHES = {"ssm_scan": 0}


def reset_launches() -> None:
    LAUNCHES["ssm_scan"] = 0


def ssm_scan_plain(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                   state: Tensor) -> tuple[Tensor, Tensor]:
    return chunked_ssm_scan(x, dt, A, Bm, Cm, state,
                            chunk=pick_block(x.shape[1], 32))


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 13 + [ctypes.c_int, ctypes.c_void_p])


def _fn():
    from repro_torch.kernels.build import library
    fn = library("ssm_scan").ssm_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
           state: Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, T, H, hd), got {tuple(x.shape)}")
    B, T, H, hd = x.shape
    if Bm.dim() != 3 or Bm.shape[:2] != (B, T) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} must "
                         f"be ({B}, {T}, N)")
    N = Bm.shape[2]
    if tuple(dt.shape) != (B, T, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} must be ({B}, {T}, {H}) and "
                         f"A {tuple(A.shape)} ({H},)")
    if tuple(state.shape) != (B, H, hd, N):
        raise ValueError(f"state {tuple(state.shape)} must be "
                         f"({B}, {H}, {hd}, {N})")
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"empty scan {tuple(x.shape)}")
    if N not in STATE_DIMS or hd * N > MAX_THREADS or (hd * N) % 32:
        raise ValueError(f"state {hd} x {N}: N must be in {STATE_DIMS} and "
                         f"hd * N a multiple of 32 up to {MAX_THREADS}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x/Bm/Cm dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}: "
                        "the kernel takes float32 or bfloat16, all alike")
    for name, t in (("dt", dt), ("A", A), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("state", state)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if not (A.is_contiguous() and state.is_contiguous()):
        raise ValueError("A and state must be contiguous")
    if B > 65535 or T >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} out of the kernel's range")


def ssm_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
             state: Tensor) -> tuple[Tensor, Tensor]:
    """x (B,T,H,hd); dt (B,T,H) fp32; A (H,) fp32; Bm/Cm (B,T,N); state
    (B,H,hd,N) fp32 -> (y (B,T,H,hd) in x's dtype, final state fp32)."""
    if _on_cpu(x, "ssm_scan"):
        return ssm_scan_plain(x, dt, A, Bm, Cm, state)
    _no_backward("ssm_scan", x, dt, A, Bm, Cm, state)
    _check(x, dt, A, Bm, Cm, state)
    B, T, H, hd = x.shape
    N = Bm.shape[2]
    fn = _fn()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s_out = torch.empty(state.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), state.data_ptr(), y.data_ptr(),
                 s_out.data_ptr(), B, T, H, hd, N,
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2),
                 Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 y.stride(0), y.stride(1), y.stride(2),
                 _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_fwd launch failed: CUDA error {err}")
    LAUNCHES["ssm_scan"] += 1
    return y, s_out
