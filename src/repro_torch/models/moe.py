"""Mixture-of-Experts MLP (OLMoE 64e/top-8, Llama4-Scout 16e/top-1+shared),
the port of ``repro/models/moe.py``.

Two dispatches, checked against each other and against the JAX package:

  * ``grouped`` (default) — sort-by-expert + fixed-capacity grouped
    products: tokens are scattered into an (E, C, d) buffer (C = the
    capacity), each expert runs its products over its capacity slice
    (``torch.bmm``), results are gathered back and gate-combined.
    Overflowing tokens are dropped (GShard capacity semantics): a
    dropped token keeps only the shared expert and the residual. How
    many drop depends on the number of tokens routed together, so a
    batch of other prompts (or pad rows) can change a token's output.
  * ``dense`` — every expert runs on every token, gate-masked combine.
    O(E/top_k) overcompute, but a token's output depends on that token
    alone, so the dispatch packs (``models/packed.py``).

``expert_parallel`` (:func:`moe_forward_expert_parallel`) shards the
experts over the ``model`` dim of a ``torch.distributed`` ``DeviceMesh``
installed with ``distributed.actspec.moe_mesh``: each rank holds and
runs only its E / n experts (:func:`shard_experts`) on tokens every rank
holds whole, and one ``all_reduce`` per layer sums the ranks' partial
outputs, as the JAX package's shard_map and ``psum`` do. With no mesh
installed, or one whose ``model`` size does not divide E, it takes the
grouped path, as in the JAX package. The dispatches build from
products, a sort, gathers/scatters and that one collective, as the JAX
package's do; there is no kernel of ours in them.

The router aux (load-balance) loss is returned for the training path.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import actspec, spmd
from repro_torch.models.layers import (_trunc_normal, apply_mlp, dense_init,
                                       init_mlp, torch_dtype)

Tensor = torch.Tensor

IMPLS = ("grouped", "dense", "expert_parallel")


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: tuple = ()) -> dict:
    """Router (float32 whatever the model's dtype), the stacked expert
    weights (``(*lead, E, ...)``) and, for llama4, the shared expert."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    E = e.n_experts
    p = {
        "router": dense_init(gen, d, E, torch.float32, lead),
        "w_gate": _trunc_normal((*lead, E, d, f), 1.0 / math.sqrt(d), dt,
                                gen),
        "w_up": _trunc_normal((*lead, E, d, f), 1.0 / math.sqrt(d), dt, gen),
        "w_down": _trunc_normal((*lead, E, f, d), 1.0 / math.sqrt(f), dt,
                                gen),
    }
    if e.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, lead, d_ff=f * e.n_shared_experts)
    return p


def _route(p: dict, cfg: ModelConfig, xf: Tensor):
    """xf (N, d) -> (gates (N, k), eidx (N, k), router probs (N, E)).

    Top-k is a stable descending sort, so equal probabilities (a zero
    hidden row gives a uniform softmax) pick the lower expert index, as
    ``jax.lax.top_k`` does; ``torch.topk`` orders ties otherwise. The
    gates are gathered from ``probs`` so their gradient reaches the
    router."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    eidx = torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :cfg.moe.top_k]
    gates = torch.gather(probs, -1, eidx)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, eidx, probs


def _counts(idx: Tensor, n: int) -> Tensor:
    """``torch.bincount(idx, minlength=n)`` for ``idx`` in [0, n), by a
    scatter-add, which the meta device also runs (bincount has no meta
    kernel, ``launch/dryrun.py``); integer sums, so exactly equal. A
    DTensor ``idx`` takes the out-of-place scatter-add: DTensor refuses
    the in-place one into a fresh replicated tensor."""
    zeros = torch.zeros(n, dtype=torch.int64, device=idx.device)
    ones = torch.ones_like(idx, dtype=torch.int64)
    if spmd.is_dtensor(idx):
        return zeros.scatter_add(0, idx.long(), ones)
    return zeros.scatter_add_(0, idx.long(), ones)


def _aux_loss(probs: Tensor, eidx: Tensor, n_experts: int) -> Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    pe = probs.mean(dim=0)
    fe = _counts(eidx.reshape(-1), n_experts).float() / probs.shape[0]
    return n_experts * torch.sum(fe * pe)


def _expert_ffn(p: dict, xs: Tensor) -> Tensor:
    """xs (E, C, d) -> (E, C, d), each expert on its own slice."""
    g = F.silu(torch.bmm(xs, p["w_gate"]))
    return torch.bmm(g * torch.bmm(xs, p["w_up"]), p["w_down"])


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` routed together: the mean load
    times the capacity factor, rounded up to a multiple of 8 (at least
    8), at most every (token, choice) pair."""
    e = cfg.moe
    cap = int(math.ceil(n_tokens * e.top_k / e.n_experts
                        * e.capacity_factor))
    cap = max(8, -(-cap // 8) * 8)
    return min(cap, n_tokens * e.top_k)


def dropless(cfg: ModelConfig) -> bool:
    """True when no token is ever dropped, whatever the number routed
    together: the dense dispatch, or a capacity of at least N (an
    expert's load is at most N, since a token picks an expert once)."""
    e = cfg.moe
    return cfg.moe_impl == "dense" or \
        e.capacity_factor * e.top_k >= e.n_experts


def dispatch(cfg: ModelConfig, eidx: Tensor):
    """The grouped dispatch's slots for routes ``eidx`` (N, k): ->
    (order, slot, keep, cap). ``order`` sorts the flat (token, choice)
    pairs by expert, stably, so within an expert earlier tokens rank
    first; pair ``order[i]`` goes to buffer row ``slot[i]`` (expert *
    cap + rank), or to the spare row E * cap when its rank reaches the
    capacity (``keep`` False: dropped)."""
    E = cfg.moe.n_experts
    N = eidx.shape[0]
    cap = capacity(cfg, N)
    flat_e = eidx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts              # exclusive
    rank = torch.arange(flat_e.shape[0], device=eidx.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, torch.full_like(se, E * cap))
    return order, slot, keep, cap


def moe_forward(p: dict, cfg: ModelConfig, x: Tensor, *,
                impl: str = "") -> tuple[Tensor, Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss, a float32 scalar)."""
    impl = impl or cfg.moe_impl
    if impl not in IMPLS:
        raise ValueError(f"moe impl {impl!r} not in {IMPLS}")
    if impl == "expert_parallel":
        mesh = actspec.get_moe_mesh()
        n = 0 if mesh is None else _axis_size(mesh)
        if n and cfg.moe.n_experts % n == 0:
            if spmd.is_dtensor(x):
                return _expert_parallel_shards(p, cfg, x, mesh)
            return moe_forward_expert_parallel(p, cfg, x, mesh=mesh)
        impl = "grouped"                 # no mesh installed, or E % n
    e = cfg.moe
    B, S, d = x.shape
    xf = spmd.reshape(x, -1, d)
    N, E = xf.shape[0], e.n_experts
    gates, eidx, probs = _route(p, cfg, xf)
    aux = _aux_loss(probs, eidx, E)

    if impl == "dense":
        h = F.silu(torch.einsum("nd,edf->enf", xf, p["w_gate"])) \
            * torch.einsum("nd,edf->enf", xf, p["w_up"])
        ye = torch.einsum("enf,efd->end", h, p["w_down"])      # (E, N, d)
        combine = torch.zeros((N, E), dtype=xf.dtype, device=xf.device) \
            .scatter(1, eidx, gates.to(xf.dtype))
        y = torch.einsum("ne,end->nd", combine, ye)
    else:
        order, slot, _, cap = dispatch(cfg, eidx)
        y = _grouped_sum(p, xf, gates, order, slot, cap, e.top_k)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], cfg, xf)
    return y.reshape(B, S, d), aux


def _grouped_sum(w: dict, xf: Tensor, gates: Tensor, order: Tensor,
                 slot: Tensor, cap: int, k: int, dtype=None) -> Tensor:
    """The grouped products and combine over the experts in ``w``
    (``w_gate``, ``w_up``, ``w_down`` of E' experts): sorted pair i, of
    token ``order[i] // k``, goes to buffer row ``slot[i]``, or to the
    spare row E' * cap (zeros after the products) when it is dropped or
    routed to an expert not in ``w``. -> (N, d): each token's sum over
    its k choices, in (token, choice) order; no atomic adds, so the
    combine does not depend on their order. The sum is in ``dtype``
    (None: ``xf``'s)."""
    N, d = gates.shape[0], xf.shape[1]
    rows = w["w_gate"].shape[0] * cap
    buf = xf.new_zeros((rows + 1, d)).index_put((slot,), xf[order // k])
    ye = _expert_ffn(w, buf[:-1].view(-1, cap, d)).reshape(-1, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    contrib = ye[slot] * gates.reshape(-1)[order, None].to(xf.dtype)
    return contrib.new_empty(contrib.shape).index_put((order,), contrib) \
        .view(N, k, d).sum(dim=1, dtype=dtype)


# ---------------------------------------------------------------------------
# Expert parallelism over a torch.distributed group
# ---------------------------------------------------------------------------

EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _axis_size(mesh, axis: str = "model") -> int:
    """The size of ``mesh``'s dim ``axis``, 0 where it has no such dim."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return mesh.size(names.index(axis)) if axis in names else 0


class _CopyToExperts(torch.autograd.Function):
    """Forward the identity; backward the ``all_reduce`` of the
    gradient over ``group``. It marks where the replicated tokens and
    gates enter the rank's own experts: each rank's gradient there is
    only its experts' share, and the sum makes it whole again, so what
    lies before (the router, the aux loss, the blocks below) gets the
    gradient of the whole layer on every rank. No communication under
    ``torch.no_grad``."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromExperts(torch.autograd.Function):
    """Forward the ``all_reduce`` (sum) of the ranks' partial outputs
    over ``group``; backward the identity: the output, and so its
    gradient, is the same on every rank, which is each partial's
    gradient. (``torch.distributed.nn.functional.all_reduce`` would sum
    that replicated gradient again: n times the gradient.)"""

    @staticmethod
    def forward(ctx, y: Tensor, group) -> Tensor:
        dist.all_reduce(y, group=group)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


def shard_experts(p: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s of ``n`` MoE params: ``w_gate``, ``w_up`` and
    ``w_down`` cut to its E / n experts (the expert dim is the third
    from last, so a stack of layers cuts too), copied so that the whole
    stack can be freed; the router and the shared expert whole."""
    E = p["w_gate"].shape[-3]
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks")
    lo, m = rank * (E // n), E // n
    return {k: v[..., lo:lo + m, :, :].clone() if k in EXPERT_KEYS else v
            for k, v in p.items()}


def moe_forward_expert_parallel(p: dict, cfg: ModelConfig, x: Tensor, *,
                                mesh, axis: str = "model"
                                ) -> tuple[Tensor, Tensor]:
    """Expert-parallel MoE over ``mesh``'s dim ``axis`` (a
    ``DeviceMesh`` with named dims, ``distributed/sharding.py::
    to_device_mesh``): rank r of n runs only experts [r E/n, (r+1) E/n),
    and one ``all_reduce`` on ``mesh.get_group(axis)`` sums the ranks'
    partial outputs. The port of ``repro/models/moe.py``'s shard_map
    body.

    Tokens are whole on every rank, so the dispatch leg of GShard's
    all-to-all is a local selection: routing, the aux loss and the
    grouped dispatch's sort, ranks and drops (:func:`dispatch`, from the
    global N = B S) run on every rank, bit for bit as ``grouped``; a rank
    keeps the (token, choice) pairs that are routed to its experts and
    ranked below the capacity, and sums them over the k choices into an
    (N, d) partial that is zero elsewhere. For a float32 ``x`` the sum
    stays in float32, as JAX's ``psum``. For bf16 (or fp16) it runs in
    float32 too: each rank's partial is its float32 sum over the k
    choices, the ``all_reduce`` sums float32 partials, and the result is
    cast to ``x.dtype`` once, so a token's sum is rounded once, as
    ``grouped``'s is. A bf16 ``all_reduce`` rounds the partials and each
    of its n - 1 additions: on an H100 with gloo, over olmoe-1b-7b's 16
    layers that moved bf16 logits by a relative L2 of 2.6e-2 from the
    grouped forward's. Llama4's shared expert runs whole on every rank,
    after the sum. ``p`` holds all E experts (sliced here, as views) or
    the rank's own (:func:`shard_experts`).

    Gradients: the combine's backward is the identity and the entry of
    the tokens and gates into the local experts all-reduces the
    gradient (``_ReduceFromExperts``, ``_CopyToExperts``), so the router
    and everything before the layer get the whole gradient on every
    rank and the expert weights their own. Comm per layer: one (N, d)
    float32 all-reduce forward, and two (N, d and N, k) backward.
    """
    e = cfg.moe
    B, S, d = x.shape
    E, k = e.n_experts, e.top_k
    n = _axis_size(mesh, axis)
    if n == 0 or E % n:
        raise ValueError(f"{E} experts do not split over the mesh's "
                         f"{axis!r} dim of {n}")
    m = E // n
    lo = mesh.get_local_rank(axis) * m
    group = mesh.get_group(axis)
    have = p["w_gate"].shape[0]
    if have == E:
        w = {key: p[key][lo:lo + m] for key in EXPERT_KEYS}
    elif have == m:
        w = {key: p[key] for key in EXPERT_KEYS}
    else:
        raise ValueError(f"expert weights for {have} experts: want all "
                         f"{E} or this rank's {m}")
    xf = spmd.reshape(x, -1, d)
    gates, eidx, probs = _route(p, cfg, xf)
    aux = _aux_loss(probs, eidx, E)
    order, slot, keep, cap = dispatch(cfg, eidx)
    local = keep & (slot >= lo * cap) & (slot < (lo + m) * cap)
    slot = torch.where(local, slot - lo * cap, torch.full_like(slot, m * cap))
    y = _grouped_sum(w, _CopyToExperts.apply(xf, group),
                     _CopyToExperts.apply(gates, group), order, slot, cap, k,
                     dtype=torch.promote_types(x.dtype, torch.float32))
    y = _ReduceFromExperts.apply(y, group).to(x.dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], cfg, xf)
    return y.reshape(B, S, d), aux


def _expert_parallel_shards(p: dict, cfg: ModelConfig, x: Tensor, mesh,
                            axis: str = "model") -> tuple[Tensor, Tensor]:
    """:func:`moe_forward_expert_parallel` on DTensors (an entry run under
    the sharding rules, ``distributed/spmd.py``): each rank runs it on
    its local tokens (the batch over the batch axes it divides, whole
    over ``model``) with the router and shared expert whole and its
    E / n experts of each stack (``Shard(0)`` over ``axis``); the
    gathers that place them are counted where they run. Where the JAX
    package's shard_map replicates every token on every rank, here a
    rank's capacity, drops and aux loss are its own tokens'; the aux
    returned is the mean of the ranks' (``Partial("avg")`` over the
    batch axes). Gradients: the experts' are summed over the batch axes
    (each rank's covers its tokens), the router's and shared expert's
    too (the combine makes them whole over ``axis``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m = tuple(mesh.mesh_dim_names).index(axis)
    bd = spmd.batch_dims(mesh, x.shape[0])
    rows = spmd.layout(mesh, bd, {})
    whole = spmd.layout(mesh, [], {})
    summed = tuple(Partial() if i in bd else pl for i, pl in enumerate(whole))
    xl = spmd.local_shard(spmd.as_dtensor(x, mesh), mesh, rows)

    def local(t, place, grad):
        return spmd.local_shard(spmd.as_dtensor(t, mesh), mesh, place, grad)
    experts = tuple(Shard(0) if i == m else pl for i, pl in enumerate(whole))
    expert_grads = tuple(Shard(0) if i == m else pl
                         for i, pl in enumerate(summed))
    pl_ = {k: local(v, experts, expert_grads) if k in EXPERT_KEYS
           else local(v, whole, summed) for k, v in p.items()
           if not isinstance(v, dict)}
    if "shared" in p:
        pl_["shared"] = {k: local(v, whole, summed)
                         for k, v in p["shared"].items()}
    y, aux = moe_forward_expert_parallel(pl_, cfg, xl, mesh=mesh, axis=axis)
    avg = tuple(Partial("avg") if i in bd else pl
                for i, pl in enumerate(whole))
    return (spmd.from_shards(y, mesh, rows, x),
            DTensor.from_local(aux, mesh, avg, run_check=False))
