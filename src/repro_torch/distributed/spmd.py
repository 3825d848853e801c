"""The port's stand-in for GSPMD partitioning: an entry run on DTensors.

The JAX dry-run hands every entry to ``jax.jit(fn, in_shardings=...)``
and reads the collectives GSPMD inserted from the partitioned HLO. Here
the same entry runs eagerly on DTensors placed by the port's
``ShardingRules`` (:func:`distribute_tree`); DTensor redistributes op by
op where an operand's placement does not suit the op, and
:class:`CollectiveCounter` adds up the collectives it sends. On the
meta device over a fake process group (:func:`fake_group`) nothing is
allocated or sent, so a 256- or 512-rank mesh is counted in one process;
over a real group of ranks the same code runs the model.

Bytes are counted as ``repro/launch/roofline.py`` counts them in the
partitioned HLO: each collective's shard-local RESULT bytes, an
all-reduce weighted 2x (ring reduce then broadcast), keyed by the HLO
op's name. One rank's bytes are one device's bytes. An eager run
dispatches every layer and microbatch, so there are no loop trips to
correct.

A decode cache whose sequence dim is split over ranks (batch 1 over the
batch axes; under ``kv_seq_shard`` over ``model``) stays where it lies:
each rank runs the decode kernel on its slots with the log-sum-exp, and
:func:`merge_softmax` all-reduces the ranks' (B, H) maxima and weighted
(B, H, hd + 1) sums, where GSPMD reduces the same partial softmaxes.

On a card, gloo takes the four collectives on CUDA tensors through its
c10d calls, but the functional all-gather that DTensor calls
(``_c10d_functional.all_gather_into_tensor``) kills the process (torch
2.11, H100); :func:`gloo_cuda_collectives` routes the functional ops'
CUDA kernels to those c10d calls.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.sharding import placements, to_device_mesh

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_FACTOR = {"all-reduce": 2.0}
SOURCE = ("CollectiveCounter over an eager run on DTensors: each "
          "collective's shard-local result bytes, all-reduce 2x")


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def distribute_tree(tree, spec_tree, device_mesh):
    """Each tensor leaf of nested dicts placed on ``device_mesh`` by its
    fitted spec (``sharding.placements``); None stays None. Every rank
    holds the whole tree (drawn from one seed) and keeps its own shard
    of each leaf: nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], device_mesh)
                for k, v in tree.items()}
    return distribute_tensor(tree, device_mesh,
                             placements(spec_tree, device_mesh),
                             src_data_rank=None)


@contextlib.contextmanager
def fake_group(mesh):
    """A ``"fake"`` process group of ``mesh.size`` ranks in this process
    (rank 0; its collectives move nothing) and, yielded, a cuda-typed
    ``DeviceMesh`` over it with ``mesh``'s axis names: on a mesh typed
    ``"cpu"`` DTensor swaps an all-to-all for an all-gather. The group
    is destroyed on exit, so one process can enter this for 256 ranks,
    then for 512."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), world_size=mesh.size,
                            rank=0)
    try:
        yield to_device_mesh(mesh, "cuda")
    finally:
        dist.destroy_process_group()


_COUNTED = (
    ("_c10d_functional", "all_gather_into_tensor", "all-gather", "out"),
    ("_c10d_functional", "all_gather_into_tensor_coalesced", "all-gather",
     "out"),
    ("_c10d_functional", "all_gather_into_tensor_out", "all-gather", "out"),
    ("_c10d_functional", "reduce_scatter_tensor", "reduce-scatter", "out"),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced", "reduce-scatter",
     "out"),
    ("_c10d_functional", "all_reduce", "all-reduce", "out"),
    ("_c10d_functional", "all_reduce_", "all-reduce", "out"),
    ("_c10d_functional", "all_reduce_coalesced", "all-reduce", "out"),
    ("_c10d_functional", "all_reduce_coalesced_", "all-reduce", "out"),
    ("_c10d_functional", "all_to_all_single", "all-to-all", "out"),
    ("_dtensor", "shard_dim_alltoall", "all-to-all", "out"),
    ("c10d", "allreduce_", "all-reduce", "arg0"),
    ("c10d", "allreduce_coalesced_", "all-reduce", "arg0"),
    ("c10d", "_allgather_base_", "all-gather", "arg0"),
    ("c10d", "allgather_", "all-gather", "arg0"),
    ("c10d", "allgather_into_tensor_coalesced_", "all-gather", "arg0"),
    ("c10d", "_reduce_scatter_base_", "reduce-scatter", "arg0"),
    ("c10d", "reduce_scatter_", "reduce-scatter", "arg0"),
    ("c10d", "reduce_scatter_tensor_coalesced_", "reduce-scatter", "arg0"),
    ("c10d", "alltoall_base_", "all-to-all", "arg0"),
    ("c10d", "alltoall_", "all-to-all", "arg0"),
)
# collectives with no counterpart among the reference's five
_UNCOUNTED = (("c10d", "broadcast_"), ("c10d", "scatter_"),
              ("c10d", "gather_"), ("c10d", "reduce_"),
              ("_c10d_functional", "broadcast"),
              ("_c10d_functional", "broadcast_"))


def _packet(ns: str, name: str):
    """``torch.ops.<ns>.<name>``, or None where this torch lacks it."""
    try:
        return getattr(getattr(torch.ops, ns), name)
    except (AttributeError, RuntimeError):
        return None


def _ops() -> dict:
    """{op packet: (HLO name, which result to size)}: "out" the op's
    output, "arg0" its first argument (the in-place c10d ops)."""
    out = {}
    for ns, name, hlo, which in _COUNTED:
        p = _packet(ns, name)
        if p is not None:
            out[p] = (hlo, which)
    return out


def _other_collectives() -> set:
    return {p for p in (_packet(ns, n) for ns, n in _UNCOUNTED)
            if p is not None}


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as cc:`` counts the collectives run
    inside: ``cc.bytes``, ``cc.per_op`` (HLO name -> bytes), ``cc.count``
    and ``cc.per_op_count``. Built as ``CommDebugMode``: an op with a
    DTensor operand returns ``NotImplemented`` here, so DTensor first
    turns it into its local ops and collectives, which then come back
    through this mode; a plain dispatch mode would see the op before
    DTensor and miss the collectives its redistributions send. A
    collective without a counterpart among the reference's five (a
    broadcast, a scatter) raises."""

    def __init__(self):
        super().__init__()
        self.supports_higher_order_operators = True
        self.bytes = 0.0
        self.count = 0
        self.per_op: dict = defaultdict(float)
        self.per_op_count: dict = defaultdict(int)
        self._ops = _ops()
        self._other = _other_collectives()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        hit = self._ops.get(packet)
        if hit is None:
            if packet in self._other:
                raise ValueError(f"{packet} has no counterpart among the "
                                 f"reference's collectives {COLLECTIVES}")
            return out
        name, which = hit
        sized = out if which == "out" else args[0]
        n = sum(t.numel() * t.element_size() for t in tree_flatten(sized)[0]
                if isinstance(t, torch.Tensor))
        b = n * _FACTOR.get(name, 1.0)
        self.bytes += b
        self.count += 1
        self.per_op[name] += b
        self.per_op_count[name] += 1
        return out

    def record(self) -> dict:
        """The dry-run's ``"collectives"`` entry."""
        return {"bytes": self.bytes, "per_op": dict(self.per_op),
                "count": self.count, "per_op_count": dict(self.per_op_count),
                "source": SOURCE}


def reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending (``Partial``) sums done: each such mesh
    dim made ``Replicate`` (an all-reduce); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a DTensor ``table`` (V, d) whose rows may be
    split over the vocabulary: each rank looks up the rows it holds
    (``F.embedding``), one all-reduce joins them, and the result's
    hidden dim is split where the table's rows were, the layout the
    indexing gives. Indexing itself would move the whole table, and its
    backward (``index_put``) fails DTensor's propagation (torch 2.11);
    the embedding's backward is a local scatter-add."""
    from torch.distributed.tensor import Shard
    out = reduced(torch.nn.functional.embedding(ids, table))
    return out.redistribute(out.device_mesh, [
        Shard(out.ndim - 1) if isinstance(tp, Shard) and tp.dim == 0 else op
        for tp, op in zip(table.placements, out.placements)])


def laid_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (broadcastable to DTensor ``ref``) split as ``ref`` is, and
    whole along the dims where ``x`` has size 1 and ``ref`` not, so that
    an elementwise op of the two moves nothing: an operand left in its
    own layout can make DTensor move ``ref`` (a whole KV cache) to it
    instead."""
    from torch.distributed.tensor import Replicate, Shard
    x = as_dtensor(x, ref.device_mesh)
    lead = ref.ndim - x.ndim
    place = [Shard(p.dim - lead) if isinstance(p, Shard) and p.dim >= lead
             and x.shape[p.dim - lead] == ref.shape[p.dim] else Replicate()
             for p in ref.placements]
    return x.redistribute(ref.device_mesh, place)


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with ``dim`` gathered on every mesh dim that shards it
    (before a reduction along it that DTensor cannot split, an argmax
    over the vocabulary); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements])


class _Reshape(torch.autograd.Function):
    """``x.reshape(shape)`` whose backward first lays the gradient out as
    the forward's output was: DTensor may hand back a gradient sharded
    in a way the inverse view cannot split (tokens flattened over more
    ranks than the batch divides), and the forward's own layout always
    views back."""

    @staticmethod
    def forward(ctx, x, shape):
        out = x.reshape(shape)
        ctx.in_shape, ctx.place = x.shape, tuple(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.place:
            g = g.redistribute(g.device_mesh, ctx.place)
        return g.reshape(ctx.in_shape), None


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``; a DTensor's through :class:`_Reshape`."""
    if is_dtensor(x):
        return _Reshape.apply(x, shape)
    return x.reshape(*shape)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last two dims flattened into one; a DTensor whose
    second-to-last dim is split unevenly (hymba's 50 heads over 16) is
    first gathered along it: DTensor cannot flatten such a shard."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        d = x.ndim - 2
        on = [m for m, p in enumerate(x.placements)
              if isinstance(p, Shard) and p.dim == d]
        if on and x.shape[d] % math.prod(x.device_mesh.size(m) for m in on):
            x = x.redistribute(x.device_mesh, [
                Replicate() if m in on else p
                for m, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:-2], -1)


def split_last(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], *shape)``; a DTensor whose last dim is
    sharded in pieces that do not fall on ``shape[0]``'s boundaries (8
    KV heads over a ``model`` dim of 16) is first gathered along it on
    those mesh dims: DTensor cannot view such a shard."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.ndim - 1
        on = [m for m, p in enumerate(x.placements)
              if isinstance(p, Shard) and p.dim == last]
        if on and shape[0] % math.prod(x.device_mesh.size(m) for m in on):
            x = x.redistribute(x.device_mesh, [
                Replicate() if m in on else p
                for m, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:-1], *shape)


# ---------------------------------------------------------------------------
# gloo on CUDA tensors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def gloo_cuda_collectives(log: Optional[list] = None):
    """The CUDA kernels of the functional collectives DTensor calls,
    routed to the c10d collectives on the same CUDA tensors (gloo copies
    them through host memory either way). With gloo on CUDA tensors the
    functional all-gather kills the process (torch 2.11, H100), while
    ``torch.distributed.all_gather_into_tensor`` on the same tensors
    runs; all four are routed, so one path carries every collective.
    Each call completes before it returns (the wait is a no-op). Only
    for ranks whose group is gloo: NCCL needs none of this. With ``log``
    each call appends (HLO name, result bytes, (start, end) CUDA events,
    host ms)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def op(name: str):
        return getattr(dist.ReduceOp, name.upper())

    def all_gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    def reduce_scatter(inp, reduce_op, group_size, group_name):
        out = inp.new_empty((inp.shape[0] // group_size, *inp.shape[1:]))
        dist.reduce_scatter_tensor(out, inp.contiguous(), op=op(reduce_op),
                                   group=_resolve_process_group(group_name))
        return out

    def all_reduce(inp, reduce_op, group_name):
        out = inp.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op(reduce_op),
                        group=_resolve_process_group(group_name))
        return out

    def all_to_all(inp, out_splits, in_splits, group_name):
        rows = sum(out_splits) if out_splits else inp.shape[0]
        out = inp.new_empty((rows, *inp.shape[1:]))
        dist.all_to_all_single(out, inp.contiguous(), out_splits or None,
                               in_splits or None,
                               group=_resolve_process_group(group_name))
        return out

    def logged(name: str, fn):
        if log is None:
            return fn

        def run(*args):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            t = time.perf_counter()
            out = fn(*args)
            t = time.perf_counter() - t
            ev[1].record()
            log.append((name, out.numel() * out.element_size(), ev, t * 1e3))
            return out
        return run

    lib = torch.library.Library("_c10d_functional", "IMPL")
    try:
        lib.impl("all_gather_into_tensor", logged("all-gather", all_gather),
                 "CUDA")
        lib.impl("reduce_scatter_tensor",
                 logged("reduce-scatter", reduce_scatter), "CUDA")
        lib.impl("all_reduce", logged("all-reduce", all_reduce), "CUDA")
        lib.impl("all_to_all_single", logged("all-to-all", all_to_all),
                 "CUDA")
        lib.impl("wait_tensor", lambda t: t, "CUDA")
        yield
    finally:
        lib._destroy()


# ---------------------------------------------------------------------------
# The kernels on local shards
# ---------------------------------------------------------------------------

def batch_dims(mesh, B: int) -> list:
    """Mesh dims ("pod", "data") the batch dim splits over: the largest
    prefix whose product divides ``B`` (``ShardingRules.batch_dim_axes``)."""
    names = tuple(mesh.mesh_dim_names or ())
    dims, prod = [], 1
    for a in ("pod", "data"):
        if a in names:
            n = mesh.size(names.index(a))
            if B % (prod * n):
                break
            dims.append(names.index(a))
            prod *= n
    return dims


def _model_dim(mesh):
    names = tuple(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


def layout(mesh, bdims, shards: dict) -> tuple:
    """Placements: ``Shard(0)`` on the batch dims, ``Shard(d)`` on mesh
    dim m for each {m: d} of ``shards``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for m in bdims:
        out[m] = Shard(0)
    for m, d in shards.items():
        out[m] = Shard(d)
    return tuple(out)


def as_dtensor(x, mesh):
    """A DTensor ``x`` as it is; a plain tensor (made inside the model)
    as the same value on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if x is None or is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_shard(x, mesh, place, grad_place=None):
    """This rank's shard of DTensor ``x`` laid out as ``place``; its
    gradient read as ``grad_place`` (default ``place``)."""
    return x.redistribute(mesh, place).to_local(grad_placements=grad_place)


def from_shards(local, mesh, place, like):
    """``local`` (each rank's shard, laid out contiguously: DTensor
    views its local shards) as the DTensor of ``like``'s shape."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, place,
                              run_check=False,
                              shape=like.shape,
                              stride=torch.empty(like.shape,
                                                 device="meta").stride())


def head_layout(mesh, H: int, KV: int) -> str:
    """How attention's heads lie over ``mesh``'s ``model`` dim of n:
    "split" — q, k and v heads each split (n divides H and KV); "slice"
    — q heads split, k and v whole on every rank, each rank slicing out
    the KV heads its q heads read (n divides H but not KV, and a rank's
    H / n q heads cover whole groups or lie in one); "whole" — every
    head on every rank (n divides neither, or no ``model`` dim)."""
    m = _model_dim(mesh)
    n = 1 if m is None else mesh.size(m)
    if n == 1 or H % n:
        return "whole"
    if KV % n == 0:
        return "split"
    g, hq = H // KV, H // n
    return "slice" if hq % g == 0 or g % hq == 0 else "whole"


def attention_shards(kernel, q, k, v, *extra):
    """``kernel(q, k, v, *extra)`` on each rank's shards of DTensors q
    (B, Sq, H, hd), k and v (B, Sk, KV, hd) (``extra``: per-row tensors
    of leading dim B, such as decode's positions), returning the
    DTensor of q's shape and layout. The batch splits over the batch
    dims it divides and the heads by :func:`head_layout`; every other
    dim (a prefill's sequence-sharded k and v) is gathered first; a
    decode cache split so takes :func:`merged_cache_shards`. Autograd
    passes through: in "slice", a rank's k and v gradient covers its KV
    heads only, so it is marked ``Partial`` over ``model`` and summed
    there."""
    from torch.distributed.tensor import Partial
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    B, H, KV = q.shape[0], q.shape[2], k.shape[2]
    bd = batch_dims(mesh, B)
    heads = head_layout(mesh, H, KV)
    m = _model_dim(mesh)
    pq = layout(mesh, bd, {m: 2} if heads in ("split", "slice") else {})
    pkv = layout(mesh, bd, {m: 2} if heads == "split" else {})
    ql = local_shard(q, mesh, pq)
    if heads == "slice":
        gp = list(pkv)
        gp[m] = Partial()
        lo, hi = _kv_slice(mesh, H, KV)
        kl = local_shard(k, mesh, pkv, gp)[:, :, lo:hi]
        vl = local_shard(v, mesh, pkv, gp)[:, :, lo:hi]
    else:
        kl, vl = local_shard(k, mesh, pkv), local_shard(v, mesh, pkv)
    rows = layout(mesh, bd, {})
    ex = [local_shard(as_dtensor(e, mesh), mesh, rows) for e in extra]
    return from_shards(kernel(ql, kl, vl, *ex), mesh, pq, q)


def _kv_slice(mesh, H: int, KV: int) -> tuple:
    """The KV heads [lo, hi) that this rank's q heads read in "slice"."""
    m = _model_dim(mesh)
    r, g, hq = mesh.get_local_rank(m), H // KV, H // mesh.size(m)
    return (r * hq) // g, ((r + 1) * hq - 1) // g + 1


def seq_dims(x) -> list:
    """The mesh dims that split ``x``'s dim 1 (a cache's sequence), in
    mesh order: none for a plain tensor."""
    from torch.distributed.tensor import Shard
    return [m for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == 1] if is_dtensor(x) else []


def merge_states(o: torch.Tensor, lse: torch.Tensor, dtype, amax,
                 total) -> torch.Tensor:
    """One decode output from its shards (flash-decoding's merge): o
    (..., B, H, hd), each shard's output normalised over its own slots,
    and lse (..., B, H) fp32, each shard's log-sum-exp, where ``amax``
    and ``total`` reduce a term over the shards -> (B, 1, H, hd) in
    ``dtype``: sum_s e^(lse_s - M) o_s / sum_s e^(lse_s - M), M = max_s
    lse_s, in fp32. A row whose shards are all -inf (no valid slot
    anywhere) gives 0, as the kernel and its plain version do."""
    top = amax(lse)
    top = torch.where(top == float("-inf"), torch.zeros_like(top), top)
    w = torch.exp(lse - top)[..., None]
    state = total(torch.cat([w * o.float(), w], -1))
    num, den = state[..., :-1], state[..., -1:]
    den = torch.where(den == 0, torch.ones_like(den), den)
    return (num / den)[:, None].to(dtype)


def merge_softmax(o: torch.Tensor, lse: torch.Tensor, dtype, mesh, place,
                  dims) -> torch.Tensor:
    """:func:`merge_states` of this rank's shard, o (B, H, hd) and lse
    (B, H), laid out as ``place`` (dims of (B, H)), with the ranks' over
    the mesh dims ``dims``: a (B, H) max, then a (B, H, hd + 1) sum
    all-reduced, in place of a gather of every rank's state."""
    return merge_states(
        o, lse, dtype, lambda t: _all_reduced(t, mesh, place, dims, "max"),
        lambda t: _all_reduced(t, mesh, place, dims, "sum"))


def _all_reduced(t: torch.Tensor, mesh, place, dims, op: str):
    """``t``, this rank's term laid out as ``place``, reduced by ``op``
    over the mesh dims ``dims`` (a DTensor redistribution: counted by
    :class:`CollectiveCounter`, routed by :func:`gloo_cuda_collectives`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    part = DTensor.from_local(t, mesh, [
        Partial(op) if d in dims else p for d, p in enumerate(place)],
        run_check=False)
    return part.redistribute(mesh, [
        Replicate() if d in dims else p for d, p in enumerate(place)]) \
        .to_local()


def merged_cache_shards(kernel, q, k, v, q_pos, kv_pos):
    """``kernel(q, k, v, q_pos, kv_pos)`` -> (o, lse), the decode kernel
    with its log-sum-exp, against DTensors k, v whose sequence dim (1)
    is split over the mesh dims ``S`` (:func:`seq_dims`): the layout the
    sharding rules give a batch-1 cache (over the batch axes) and, under
    ``kv_seq_shard``, one whose KV heads do not divide ``model``. q is
    made whole over ``S``; k, v and kv_pos keep (or are cut to) this
    rank's slots; the kernel returns each rank's output and log-sum-exp
    over its slots, and :func:`merge_softmax` all-reduces their max and
    weighted sums over ``S``, so every rank holds the whole softmax. The batch splits as in
    :func:`attention_shards`; the heads too, unless ``model`` is among
    ``S``, where every rank takes every head of its slots. Raises where
    the cache cannot be merged in place: v split otherwise than k, or a
    mesh dim splitting both the batch and the sequence."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = k.device_mesh
    S = seq_dims(k)
    q, v = as_dtensor(q, mesh), as_dtensor(v, mesh)
    B, H, KV = q.shape[0], q.shape[2], k.shape[2]
    bd = batch_dims(mesh, B)
    if seq_dims(v) != S or set(bd) & set(S):
        raise ValueError(
            f"decode cannot merge the cache's shards in place: k "
            f"{k.placements}, v {v.placements}, batch dims {bd}")
    m = _model_dim(mesh)
    heads = "whole" if m is None or m in S else head_layout(mesh, H, KV)
    hs = {m: 2} if heads in ("split", "slice") else {}
    seq = {d: 1 for d in S}
    pq = layout(mesh, bd, hs)
    pkv = layout(mesh, bd, {**seq, **({m: 2} if heads == "split" else {})})
    ql = local_shard(q, mesh, pq)
    kl, vl = local_shard(k, mesh, pkv), local_shard(v, mesh, pkv)
    if heads == "slice":
        lo, hi = _kv_slice(mesh, H, KV)
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    qp = local_shard(as_dtensor(q_pos, mesh), mesh, layout(mesh, bd, {}))
    kp = local_shard(as_dtensor(kv_pos, mesh), mesh, layout(mesh, bd, seq))
    o, lse = kernel(ql, kl, vl, qp, kp)
    place = [Replicate()] * mesh.ndim           # of (B, H) and (B, H, .)
    for d in bd:
        place[d] = Shard(0)
    for d in hs:
        place[d] = Shard(1)
    out = merge_softmax(o[:, 0], lse, q.dtype, mesh, place, S)
    return from_shards(out, mesh, pq, q)


def scan_shards(kernel, seq, per_head, rows, state, head_dims):
    """``kernel(*seq, *per_head, *rows, state)`` (a scan's operands: the
    time-major tensors ``seq`` (B, T, H, ...), the per-head parameters
    ``per_head`` (H, ...), the head-free rows ``rows`` (B, T, ...) and
    the state (B, H, ...)) on each rank's shards; -> (output DTensor of
    ``seq[0]``'s shape and layout, state DTensor). The batch splits over
    the batch dims it divides, the heads over ``model`` where it divides
    H; ``head_dims`` gives each ``seq`` tensor's head dim."""
    dts = [t for t in (*seq, *per_head, *rows, state) if is_dtensor(t)]
    mesh = dts[0].device_mesh
    B, H = seq[0].shape[0], seq[0].shape[2]
    bd = batch_dims(mesh, B)
    m = _model_dim(mesh)
    split = m is not None and H % mesh.size(m) == 0 and mesh.size(m) > 1
    hs = (lambda d: {m: d}) if split else (lambda d: {})
    seq_l = [local_shard(as_dtensor(t, mesh), mesh, layout(mesh, bd, hs(d)))
             for t, d in zip(seq, head_dims)]
    ph_l = [local_shard(as_dtensor(t, mesh), mesh, layout(mesh, [], hs(0)))
            for t in per_head]
    row_l = [local_shard(as_dtensor(t, mesh), mesh, layout(mesh, bd, {}))
             for t in rows]
    ps = layout(mesh, bd, hs(1))
    st_l = local_shard(as_dtensor(state, mesh), mesh, ps)
    y, s = kernel(*seq_l, *ph_l, *row_l, st_l)
    y_place = layout(mesh, bd, hs(head_dims[0]))
    return (from_shards(y, mesh, y_place, seq[0]),
            from_shards(s, mesh, ps, as_dtensor(state, mesh)))
