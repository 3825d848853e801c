"""Flash-attention forward on Hopper: wrappers of csrc/flash_attention.cu.

Two wrappers over one CUDA source, each the counterpart of one Pallas
TPU kernel of the JAX package:

  * :func:`flash_attention` — ``repro/kernels/flash_attention.py::
    flash_attention`` (causal / window / segment-id masks; the packed
    serving path);
  * :func:`flash_attention_lse` — ``repro/kernels/flash_attention_bwd.py::
    _flash_fwd`` (the unsegmented forward plus the per-row logsumexp).

The dtype picks the kernel in the source: bfloat16 runs on the tensor
cores (``wgmma``, operands loaded by TMA), float32 on scalar FMA. A
bfloat16 tensor that TMA cannot read (a base not 16-byte aligned, or a
stride that is not a positive multiple of 16 bytes) raises
``ValueError``.

A tensor on the CPU (or the meta device: a shape pass, see
``launch/dryrun.py``) goes to the plain version beside each wrapper
(:func:`flash_attention_plain`, :func:`flash_attention_lse_plain`); a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches per wrapper so a run can show its main path went through them.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import ref

Tensor = torch.Tensor

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per wrapper; chip_smoke.py resets and reads these
LAUNCHES = {"flash_attention": 0, "flash_attention_lse": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_count_lock = threading.Lock()

# the tally of the CUDA graph this thread is capturing, if any
_capturing = threading.local()


class CaptureTally:
    """What the kernel wrappers did on one thread while it captured a
    CUDA graph (:func:`captured_launches`): the launches they recorded
    into the graph, by wrapper (``launches``: name -> [its ``LAUNCHES``
    dict, count]), and the scratch they handed the captured kernels
    (``held``). The graph reads that scratch at every replay, so holding
    it here keeps it alive when a larger call replaces it in its
    wrapper's cache."""

    def __init__(self):
        self.launches: dict = {}
        self.held: list = []

    def replayed(self) -> None:
        """Count one replay's launches in the wrappers' ``LAUNCHES``."""
        with _count_lock:
            for name, (counts, n) in self.launches.items():
                counts[name] += n


@contextlib.contextmanager
def captured_launches():
    """``with captured_launches() as tally:`` around a CUDA graph capture
    on this thread: the wrappers' launches go to ``tally`` and not to
    ``LAUNCHES`` (a capture runs nothing; each replay counts them), and
    a scratch that would have to grow raises instead (its zero fill
    would run only inside the graph)."""
    prev = getattr(_capturing, "tally", None)
    _capturing.tally = tally = CaptureTally()
    try:
        yield tally
    finally:
        _capturing.tally = prev


def count_launch(counts: dict, name: str) -> None:
    """Add one launch of ``name`` to a wrapper's ``LAUNCHES``: a server's
    threads launch kernels at once, and ``counts[name] += 1`` alone is
    not atomic. Inside :func:`captured_launches` the launch goes to the
    capture's tally instead."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally.launches.setdefault(name, [counts, 0])[1] += 1
        return
    with _count_lock:
        counts[name] += 1


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------

def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          seg_ids: Optional[Tensor] = None, *,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> Tensor:
    return ref.chunked_attention(q, k, v, seg_ids=seg_ids, causal=causal,
                                 window=window, scale=scale)


def flash_attention_lse_plain(q: Tensor, k: Tensor, v: Tensor, *,
                              causal: bool = True, window: int = 0,
                              scale: Optional[float] = None
                              ) -> tuple[Tensor, Tensor]:
    return ref.ref_attention(q, k, v, causal=causal, window=window,
                             scale=scale, return_lse=True)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 13
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def _fn():
    from repro_torch.kernels.build import library
    fn = library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def tma_unreadable(t: Tensor) -> Optional[str]:
    """Why TMA cannot load the (B, S, heads, hd) view ``t`` as the bf16
    kernels do, or None: they need a 16-byte aligned base and every stride
    of an axis longer than 1 a positive multiple of 16 bytes."""
    if t.data_ptr() % 16:
        return "base address is not 16-byte aligned"
    for ax in range(3):
        nbytes = t.stride(ax) * t.element_size()
        if t.shape[ax] > 1 and (nbytes <= 0 or nbytes % 16):
            return (f"stride along axis {ax} is {nbytes} bytes, not a "
                    "positive multiple of 16")
    return None


def unaligned(t: Tensor) -> Optional[str]:
    """Why a kernel cannot read the rows of ``t`` (its last axis,
    contiguous) in 16-byte pieces (``cp.async``, vector loads), or None:
    that needs a 16-byte aligned base, rows of whole 16-byte units, and
    the other axes' strides in whole 16-byte units (0 allowed: an
    expanded axis re-reads the same rows)."""
    es = t.element_size()
    if t.data_ptr() % 16:
        return "base address is not 16-byte aligned"
    if (t.shape[-1] * es) % 16:
        return f"rows of {t.shape[-1] * es} bytes, not a multiple of 16"
    for ax, st in enumerate(t.stride()[:-1]):
        if (st * es) % 16:
            return (f"stride along axis {ax} is {st} elements, not a whole "
                    "number of 16 bytes")
    return None


def grown_scratch(cache: dict, device: torch.device, n_float: int,
                  n_ticket: int) -> tuple[Tensor, Tensor]:
    """A kernel's scratch on ``device``, kept in its wrapper's ``cache``:
    at least ``n_float`` fp32 values and ``n_ticket`` int32 tickets, zero
    between launches (each launch leaves the tickets it took at zero).
    Allocated on first use and replaced by a larger one when a call needs
    more; a replaced buffer is freed in stream order, so a launch still
    reading it is safe on one stream. A CUDA graph capturing on this
    thread (:func:`captured_launches`) holds what it is handed, and
    must find it large enough."""
    buf, ticket = cache.get(device, (None, None))
    grow_buf = buf is None or buf.numel() < n_float
    grow_ticket = ticket is None or ticket.numel() < n_ticket
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        if grow_buf or grow_ticket:
            raise RuntimeError(
                "a kernel's scratch would grow inside a CUDA graph "
                "capture: run the captured call once eagerly first")
        tally.held.append((buf, ticket))
        return buf, ticket
    if grow_buf:
        buf = torch.empty(n_float, dtype=torch.float32, device=device)
    if grow_ticket:
        ticket = torch.zeros(n_ticket, dtype=torch.int32, device=device)
    cache[device] = (buf, ticket)
    return buf, ticket


def _check(q: Tensor, k: Tensor, v: Tensor, seg_ids: Optional[Tensor],
           window: int) -> None:
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        "kernel takes float32 or bfloat16, all alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous")
        # the bf16 kernel loads q, k and v by TMA (o is allocated
        # contiguous here)
        why = tma_unreadable(t) if q.dtype == torch.bfloat16 else None
        if why is not None:
            raise ValueError(f"{name}'s {why} (the bf16 kernel loads it by "
                             "TMA)")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if max(B * H, Sq, Sk) >= 2 ** 31 or B * H > 65535:
        raise ValueError(f"shape {tuple(q.shape)} out of the kernel's range")
    if seg_ids is not None:
        if Sq != Sk:
            raise ValueError("segment ids require self-attention (Sq == Sk)")
        if tuple(seg_ids.shape) != (B, Sq) or seg_ids.dtype != torch.int32:
            raise ValueError(f"seg_ids must be int32 ({B}, {Sq}), got "
                             f"{seg_ids.dtype} {tuple(seg_ids.shape)}")
        if seg_ids.device != q.device or seg_ids.stride(-1) != 1:
            raise ValueError("seg_ids must lie on q's device, contiguous "
                             "along S")


def _launch(q: Tensor, k: Tensor, v: Tensor, seg_ids: Optional[Tensor],
            *, causal: bool, window: int, scale: Optional[float],
            with_lse: bool) -> tuple[Tensor, Optional[Tensor]]:
    _check(q, k, v, seg_ids, window)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    fn = _fn()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 seg_ids.data_ptr() if seg_ids is not None else None,
                 o.data_ptr(), lse.data_ptr() if lse is not None else None,
                 B, Sq, Sk, H, KV, hd,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 o.stride(0), o.stride(1), o.stride(2),
                 seg_ids.stride(0) if seg_ids is not None else 0,
                 float(scale), int(bool(causal)), int(window),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    return o, lse


def _on_cpu(q: Tensor, what: str = "attention") -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one (the kernel runs); raises for any other device. A meta tensor
    takes the plain version too: it computes no values, so that is the
    shape pass its caller asked for (``launch/dryrun.py``)."""
    if q.device.type in ("cpu", "meta"):
        return True
    if q.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {q.device}")
    return False


def _no_backward(what: str, *inputs: Optional[Tensor]) -> None:
    """Raise where autograd records and an input of a kernel that has no
    backward requires grad: its output would carry no ``grad_fn`` and cut
    the gradient without a word (the JAX package cannot differentiate
    such a ``pallas_call`` either). The CPU plain versions keep autograd."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input "
            "requires grad (run it under torch.no_grad(), or on the CPU)")


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    seg_ids: Optional[Tensor] = None, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype.

    Positions are implicit (q token i is position i). ``seg_ids`` (B, S)
    int32 (self-attention, Sq == Sk) confines attention to equal ids;
    pad tokens carry their own id and attend among themselves.
    """
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, seg_ids, causal=causal,
                                     window=window, scale=scale)
    _no_backward("flash_attention", q, k, v)
    o, _ = _launch(q, k, v, seg_ids, causal=causal, window=window,
                   scale=scale, with_lse=False)
    count_launch(LAUNCHES, "flash_attention")
    return o


def flash_attention_lse(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None
                        ) -> tuple[Tensor, Tensor]:
    """The unsegmented forward: -> (o (B, Sq, H, hd), lse (B, H, Sq) fp32)."""
    if _on_cpu(q):
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         window=window, scale=scale)
    # differentiable through kernels/flash_attention_bwd.py::FlashAttention
    _no_backward("flash_attention_lse", q, k, v)
    o, lse = _launch(q, k, v, None, causal=causal, window=window,
                     scale=scale, with_lse=True)
    count_launch(LAUNCHES, "flash_attention_lse")
    return o, lse
