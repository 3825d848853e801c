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

The kernel cuts time into ``CHUNK``-step chunks (two launches: chunk
states and their carry, then the outputs; ``csrc/ssm_scan.cu`` says
why). Its scratch, a state per (row, head, chunk) and a ticket per
(row, head), is allocated here once per device (:func:`scratch`) and
grown when a call needs more; the tickets assume one launch in flight
at a time, that is, one stream at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import (_DTYPES, _no_backward,
                                                 _on_cpu, count_launch,
                                                 grown_scratch, unaligned)
from repro_torch.kernels.ref import chunked_ssm_scan, pick_block

Tensor = torch.Tensor

STATE_DIMS = (4, 8, 16, 32)   # csrc/ssm_scan.cu::ssm_scan_fwd
MAX_HEAD_DIM = 128            # hd: a multiple of 8 up to this
CHUNK = 64                    # time steps per chunk; csrc/ssm_scan.cu::C

# kernel launches; chip_smoke.py resets and reads this
LAUNCHES = {"ssm_scan": 0}


def reset_launches() -> None:
    LAUNCHES["ssm_scan"] = 0


def ssm_scan_plain(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                   state: Tensor) -> tuple[Tensor, Tensor]:
    return chunked_ssm_scan(x, dt, A, Bm, Cm, state,
                            chunk=pick_block(x.shape[1], 32))


# device -> (chunk states and decays fp32, tickets int32), grown on demand
_SCRATCH: dict = {}


def scratch(device: torch.device, B: int, H: int, hd: int, N: int,
            n_chunk: int) -> tuple[Tensor, Tensor]:
    """The device's fp32 chunk buffer (B H n_chunk hd N states, then
    B H n_chunk decays) and its B H tickets."""
    return grown_scratch(_SCRATCH, device, B * H * n_chunk * (hd * N + 1),
                         B * H)


_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


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
    if N not in STATE_DIMS or hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"state {hd} x {N}: N must be in {STATE_DIMS} and "
                         f"hd a multiple of 8 up to {MAX_HEAD_DIM}")
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
    if B > 65535 or H > 65535 or T >= 2 ** 31 - CHUNK:
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
    n_chunk = -(-T // CHUNK)
    fn = _fn()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s_out = torch.empty(state.shape, dtype=torch.float32, device=x.device)
    states, ticket = scratch(x.device, B, H, hd, N, n_chunk)
    decays_ptr = states.data_ptr() + 4 * B * H * n_chunk * hd * N
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), state.data_ptr(), y.data_ptr(),
                 s_out.data_ptr(), states.data_ptr(), decays_ptr,
                 ticket.data_ptr(), B, T, H, hd, N, n_chunk,
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2),
                 Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 int(unaligned(x) is None),
                 int(unaligned(Bm) is None and unaligned(Cm) is None),
                 _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_fwd launch failed: CUDA error {err}")
    count_launch(LAUNCHES, "ssm_scan")
    return y, s_out
