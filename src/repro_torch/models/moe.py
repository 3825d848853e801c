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

``expert_parallel`` shards the experts over a TPU mesh in the JAX
package; with no mesh installed it takes the grouped path there, and it
always does here. The dispatches build from products, a sort and
gathers/scatters, as the JAX package's do; there is no kernel of ours
in them.

The router aux (load-balance) loss is returned for the training path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
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


def _aux_loss(probs: Tensor, eidx: Tensor, n_experts: int) -> Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    pe = probs.mean(dim=0)
    fe = torch.bincount(eidx.reshape(-1), minlength=n_experts).float() \
        / probs.shape[0]
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
    counts = torch.bincount(flat_e, minlength=E)
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
    e = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(-1, d)
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
    else:                                       # grouped, expert_parallel
        k = e.top_k
        order, slot, _, cap = dispatch(cfg, eidx)
        tok = order // k                        # token of each sorted pair
        buf = xf.new_zeros((E * cap + 1, d)).index_put((slot,), xf[tok])
        ye = _expert_ffn(p, buf[:-1].view(E, cap, d)).reshape(-1, d)
        ye = torch.cat([ye, ye.new_zeros((1, d))])
        contrib = ye[slot] * gates.reshape(-1)[order, None].to(x.dtype)
        # back to (token, choice) order and a sum over the k choices: no
        # atomic adds, so the combine does not depend on their order
        y = contrib.new_empty(contrib.shape).index_put((order,), contrib) \
            .view(N, k, d).sum(dim=1)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], cfg, xf)
    return y.reshape(B, S, d), aux
