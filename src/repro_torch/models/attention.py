"""GQA attention block: projections, qk-norm, RoPE, full-sequence forward.

Supports GQA (any group size), qk_norm (qwen3/olmoe), QKV bias (qwen2),
sliding-window attention and cross-attention. The one-token decode path
comes with the decode slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, rms_head_norm,
                                       rope_freqs, torch_dtype)

Tensor = torch.Tensor


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   lead: tuple = ()) -> dict:
    """Attention params, with ``lead`` stacked layer axes in front."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, H * hd, dt, lead),
        "wk": dense_init(gen, d, KV * hd, dt, lead),
        "wv": dense_init(gen, d, KV * hd, dt, lead),
        "wo": dense_init(gen, H * hd, d, dt, lead),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((*lead, H * hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((*lead, KV * hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((*lead, KV * hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=dev)
    return p


def _project_q(p: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim_)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
    return q


def _project_kv(p: dict, cfg: ModelConfig, x: Tensor) -> tuple[Tensor, Tensor]:
    B, S, _ = x.shape
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim_)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim_)
    if "k_norm" in p:
        k = rms_head_norm(p["k_norm"], k)
    return k, v


def attn_forward(p: dict, cfg: ModelConfig, x: Tensor, *,
                 window: int = 0, causal: bool = True,
                 positions: Optional[Tensor] = None,
                 kv_src: Optional[Tensor] = None,
                 seg_ids: Optional[Tensor] = None,
                 return_kv: bool = False):
    """Full-sequence attention (prefill / fragment execution).

    kv_src: source sequence for cross-attention (no RoPE applied on cross).
    seg_ids: (B, S) int32 segment ids for sequence-packed batches — tokens
    only attend within their segment (pass packed per-segment positions
    too so RoPE restarts at each boundary).
    return_kv: also return the (rope'd) k, v.
    """
    B, S, _ = x.shape
    q = _project_q(p, cfg, x)
    cross = kv_src is not None
    k, v = _project_kv(p, cfg, kv_src if cross else x)
    if not cross and cfg.rope_theta > 0:
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None]
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = ops.attention(q, k, v, causal=causal and not cross,
                      window=0 if cross else window,
                      seg_ids=None if cross else seg_ids)
    out = o.reshape(B, S, -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out
