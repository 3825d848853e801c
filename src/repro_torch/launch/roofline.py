"""Roofline analysis of one entry's counted work, at the H100's rates.

The port of ``repro/launch/roofline.py``. Three terms per (arch x shape
x mesh), in seconds:

  compute    = FLOPs / (chips x PEAK_FLOPS)     (989 TFLOP/s bf16)
  memory     = HBM bytes / (chips x HBM_BW)     (3.35 TB/s)
  collective = collective bytes / (chips x ICI_BW)

The rates are ``core/costmodel.py``'s (one H100 SXM at 700 W, NVIDIA's
data sheet); this module keeps no copy of them.

FLOPs and bytes come from two sources:
  * :class:`OpStats`, filled by :func:`count_ops` over an eager run of
    the entry on the meta device (``launch/dryrun.py``): the matrix
    products' FLOPs as ``torch.utils.flop_counter.FlopCounterMode``
    counts them, and every aten op's bytes read and written (views move
    nothing), with the peak of the storages the run holds at once;
  * the analytic model (``core.costmodel`` conventions), copied from
    the JAX package: 6*N*D for train, 2*N_active per token for inference.

Not copied: ``parse_hlo``, ``HloStats`` and their regexes, which read
XLA's compiled HLO text; the port compiles no HLO. The layer loops are
Python loops in the port, so every layer's ops are dispatched and
counted, and no loop trip correction is needed.
"""
from __future__ import annotations

import contextlib
import importlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.costmodel import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.kernels import ref

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "OpStats", "count_ops",
           "model_flops", "hbm_bytes_estimate", "Roofline"]


# ---------------------------------------------------------------------------
# Counted FLOPs/bytes (an eager run, normally on the meta device)
# ---------------------------------------------------------------------------

@dataclass
class OpStats:
    flops: float = 0.0            # matmul FLOPs (FlopCounterMode)
    bytes: float = 0.0            # bytes read + written over every aten op
    n_ops: int = 0                # aten ops dispatched (views included)
    peak_bytes: float = 0.0       # most bytes of storages made in the run
    per_op: dict = field(default_factory=dict)   # op -> [n, bytes]


def _extent_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: a broadcast
    (stride 0) dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


# in-place writes through an index: they touch as many elements of
# their target as they read from their sources, not the whole target
_INDEXED_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                   "index_add_", "scatter_", "scatter_add_"}
# gathers: they read as many elements of their source as they write
_INDEXED_READS = {"index", "gather", "index_select", "embedding"}
# each kernel wrapper's plain version, by the module whose wrapper calls
# it under that name (a meta tensor takes the plain version)
_PLAIN = {
    "repro_torch.kernels.flash_attention": ("flash_attention_plain",
                                            "flash_attention_lse_plain"),
    "repro_torch.kernels.flash_attention_bwd": ("flash_attention_bwd_plain",),
    "repro_torch.kernels.decode_attention": ("decode_attention_plain",),
    "repro_torch.kernels.ssm_scan": ("ssm_scan_plain",),
    "repro_torch.kernels.wkv6_scan": ("wkv6_scan_plain",),
}
# the scans' plain versions loop over chunks in Python (1,024 of them a
# layer at 32k tokens): folded by ``_fold_chunks`` while counted
_SCANS = {"ssm_scan_plain", "wkv6_scan_plain"}
SCAN_CHUNK = 32               # the chunk the scans' plain versions prefer


def _fold_chunks(plain):
    """``plain`` (a chunked scan's plain version: time-major arguments
    (B, T, ...) of three or more dims, the state (B, ...) last) run with
    its ``n`` chunks folded into the batch: one chunk of (B n) rows from
    the same state. On meta tensors every chunk runs the same ops on the
    same shapes and there is no value to carry, so the shapes and the
    forward's FLOPs counted are the loop's, in one pass where the loop
    takes n. Under autograd the state carried between chunks is not
    differentiated: the backward counts 0.06-0.09% fewer FLOPs than the
    loop's at train_4k (hymba-1.5b, rwkv6-7b)."""
    def folded(*args):
        x, state = args[0], args[-1]
        B, T = x.shape[:2]
        C = ref.pick_block(T, SCAN_CHUNK)
        n = T // C
        rows = [a.reshape(B * n, C, *a.shape[2:])
                if a.dim() >= 3 and tuple(a.shape[:2]) == (B, T) else a
                for a in args[:-1]]
        s0 = state[:, None].expand(B, n, *state.shape[1:]) \
            .reshape(B * n, *state.shape[1:])
        y, s = plain(*rows, s0)
        return (y.reshape(B, T, *y.shape[2:]),
                s.reshape(B, n, *s.shape[1:])[:, -1])
    return folded


class _ByteCounter(TorchDispatchMode):
    """Sums each aten op's tensor inputs (read) and outputs (written);
    an argument the op writes in place counts once, as written. Tracks
    the bytes of the storages created under it that are still alive.

    A kernel wrapper's plain version (``_PLAIN``) on meta tensors counts
    as the kernel: its arguments read once and its outputs written once;
    the ops inside move and hold nothing here, since the kernel keeps
    its scores and chunk states on chip. Their FLOPs still count."""

    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats
        self._per_op = defaultdict(lambda: [0, 0])
        self._live = 0
        self._seen: set = set()
        self._in_kernel = 0

    def _freed(self, key: int, nbytes: int) -> None:
        self._live -= nbytes
        self._seen.discard(key)

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen or key in inputs:
            return
        self._seen.add(key)
        self._live += st.nbytes()
        weakref.finalize(st, self._freed, key, st.nbytes())
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)

    def as_kernel(self, plain, on_meta):
        """``plain`` (a kernel's plain version) counted as the kernel
        where it runs on meta tensors, there as ``on_meta``."""
        def counted(*args, **kwargs):
            if not any(isinstance(a, torch.Tensor) and a.device.type == "meta"
                       for a in args):
                return plain(*args, **kwargs)
            self._in_kernel += 1
            try:
                out = on_meta(*args, **kwargs)
            finally:
                self._in_kernel -= 1
            if not self._in_kernel:
                self._kernel(args, out)
            return out
        return counted

    def _kernel(self, args, out) -> None:
        """One kernel call's traffic."""
        nbytes, inputs = 0, set()
        for a in tree_flatten(args)[0]:
            if isinstance(a, torch.Tensor):
                inputs.add(a.untyped_storage()._cdata)
                nbytes += _extent_bytes(a)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                nbytes += _extent_bytes(o)
                self._track(o, inputs)
        self._add("kernel (plain version on meta)", nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.stats.n_ops += 1
        if func.is_view or self._in_kernel:
            return out
        if func.overloadpacket.__name__ in _INDEXED_WRITES:
            src = sum(_extent_bytes(a) for a in tree_flatten(
                (args[1:], kwargs))[0] if isinstance(a, torch.Tensor))
            self._add(func, 2 * src)            # sources read, then written
            return out
        if func.overloadpacket.__name__ in _INDEXED_READS:
            idx = sum(_extent_bytes(a) for a in tree_flatten(
                (args[1:], kwargs))[0] if isinstance(a, torch.Tensor))
            self._track(out, set())
            self._add(func, idx + 2 * _extent_bytes(out))
            return out
        schema = func._schema.arguments
        written = {id(a) for s, a in zip(schema, args)
                   if isinstance(a, torch.Tensor) and s.alias_info is not None
                   and s.alias_info.is_write}
        nbytes, inputs = 0, set()
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor):
                inputs.add(a.untyped_storage()._cdata)
                if id(a) not in written:
                    nbytes += _extent_bytes(a)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                nbytes += _extent_bytes(o)
                self._track(o, inputs)
        self._add(func, nbytes)
        return out

    def _add(self, name, nbytes: int) -> None:
        self.stats.bytes += nbytes
        rec = self._per_op[str(name)]
        rec[0] += 1
        rec[1] += nbytes


@contextlib.contextmanager
def count_ops():
    """``with count_ops() as stats:`` counts every aten op run inside:
    FLOPs on exit, bytes as they go (see :class:`OpStats`)."""
    stats = OpStats()
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter(stats)
    saved = [(m, n, getattr(m, n)) for m, names in
             ((importlib.import_module(k), v) for k, v in _PLAIN.items())
             for n in names]
    for m, n, plain in saved:
        setattr(m, n, counter.as_kernel(
            plain, _fold_chunks(plain) if n in _SCANS else plain))
    try:
        with flops, counter:
            yield stats
    finally:
        for m, n, plain in saved:
            setattr(m, n, plain)
    stats.flops = float(flops.get_total_flops())
    stats.per_op = {k: list(v) for k, v in counter._per_op.items()}


# ---------------------------------------------------------------------------
# Analytic FLOPs/bytes (model-level; as the JAX package counts them)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N_active*D_tok for inference."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # one token


def hbm_bytes_estimate(cfg, shape) -> float:
    """First-order HBM traffic: params once + KV/state traffic."""
    pbytes = cfg.n_params() * 2.0
    if shape.kind == "train":
        return pbytes * 3 * 2                            # p+g+opt r/w
    if shape.kind == "decode":
        kv = 0.0
        if cfg.family != "ssm":
            sc = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window \
                else shape.seq_len
            kv_bytes = 1 + 4.0 / cfg.head_dim_ \
                if cfg.kv_cache_dtype == "int8" else 2
            kv = (cfg.n_layers * shape.global_batch * sc
                  * cfg.n_kv_heads * cfg.head_dim_ * 2 * kv_bytes)
        if cfg.family == "ssm":
            hd = cfg.rwkv.head_dim
            kv = cfg.n_layers * shape.global_batch \
                * (cfg.d_model // hd) * hd * hd * 4 * 2
        return pbytes + kv
    return pbytes


@dataclass
class Roofline:
    chips: int
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops_: float

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * ICI_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_ / max(self.flops, 1.0)

    def to_dict(self) -> dict:
        return {
            "chips": self.chips, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_,
            "useful_ratio": self.useful_ratio,
        }
