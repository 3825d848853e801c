"""Shared layer primitives: norms, RoPE, the MLP, initialisers.

Pure functions over parameter dicts of tensors, as in the JAX package.
Initialisers draw from an explicit ``torch.Generator`` (truncated-normal
fan-in scaling, as the source model families do); they cannot reproduce
``jax.random``'s numbers, so parity tests convert the JAX weights
instead (``models.convert``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

Tensor = torch.Tensor


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std: float, dtype, gen: torch.Generator) -> Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               lead: tuple = ()) -> Tensor:
    """(*lead, in_dim, out_dim); ``lead`` stacks layers, as JAX's vmap."""
    return _trunc_normal((*lead, in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                         dtype, gen)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> Tensor:
    return _trunc_normal((vocab, dim), 0.02, dtype, gen)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    if cfg.nonparametric_ln:
        return {}
    shape = (*lead, cfg.d_model)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if not cfg.rmsnorm:
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def apply_norm(params: dict, cfg: ModelConfig, x: Tensor,
               eps: float = 1e-5) -> Tensor:
    """RMSNorm / LayerNorm / non-parametric LayerNorm (OLMo), fp32 internals."""
    xf = x.float()
    if cfg.rmsnorm:
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    if params:
        xf = xf * params["scale"]
        if "bias" in params:
            xf = xf + params["bias"]
    return xf.to(x.dtype)


def rms_head_norm(scale: Tensor, x: Tensor, eps: float = 1e-6) -> Tensor:
    """Per-head RMSNorm used by qk_norm (qwen3 / olmoe)."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, positions: Tensor) -> tuple[Tensor, Tensor]:
    """cos/sin tables for integer ``positions`` (any leading shape)."""
    hd = cfg.head_dim_
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv                      # (..., hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (..., n_heads, head_dim); cos/sin broadcastable to (..., hd/2).

    Interleaved-pair convention: (x[..., 0::2], x[..., 1::2]) rotate as
    one pair — not the rotate-half layout.
    """
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos = cos[..., None, :]                                       # add head axis
    sin = sin[..., None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sinusoid_pos_emb(length: int, dim: int, *, device=None) -> Tensor:
    """Whisper-style fixed sinusoidal embedding (length, dim), float32."""
    half = dim // 2
    inv = torch.exp(-math.log(10_000.0)
                    * torch.arange(half, dtype=torch.float32, device=device)
                    / max(half - 1, 1))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
             d_ff: int = 0) -> dict:
    """The (gated) MLP's weights; ``d_ff`` 0 means ``cfg.d_ff`` (a moe
    shared expert passes its own width)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    if cfg.gated_mlp:
        p = {"w_gate": dense_init(gen, d, f, dt, lead),
             "w_up": dense_init(gen, d, f, dt, lead),
             "w_down": dense_init(gen, f, d, dt, lead)}
    else:
        p = {"w_up": dense_init(gen, d, f, dt, lead),
             "w_down": dense_init(gen, f, d, dt, lead)}
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros((*lead, f), dtype=dt, device=gen.device)
        p["b_down"] = torch.zeros((*lead, d), dtype=dt, device=gen.device)
    return p


def apply_mlp(params: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    if cfg.gated_mlp:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = x @ params["w_up"]
        if "b_up" in params:
            h = h + params["b_up"]
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    y = h @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y
