"""GQA attention block: projections, qk-norm, RoPE, KV-cache management.

Supports GQA (any group size), qk_norm (qwen3/olmoe), QKV bias (qwen2),
sliding-window attention, cross-attention (llama-3.2-vision, whisper)
in the full-sequence forward and in decode, and one-token decode against
plain or ring-buffer KV caches (float or int8-quantized).

Decode writes the cache IN PLACE: where the JAX package returns an
updated copy (``.at[].set``, ``dynamic_update_slice``), :func:`attn_decode`
writes the new token's k/v (and int8 scales) into the cache tensors it
is given and returns those same tensors, so a step never copies a cache.
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


def project_cross_kv(p: dict, cfg: ModelConfig,
                     memory: Tensor) -> tuple[Tensor, Tensor]:
    """Cross-attention k/v of encoder or image memory (B, T, d), computed
    once at prefill so decode never projects the memory again."""
    return _project_kv(p, cfg, memory)


# ---- int8 KV-cache quantization -------------------------------------------

def quantize_kv(x: Tensor) -> tuple[Tensor, Tensor]:
    """(.., S, KV, hd) -> (int8 values, fp32 absmax scale (.., S, KV))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _slot(pos: Tensor, cache_len: int, window: int) -> Tensor:
    """Cache slot of each row's position: the ring index with a window,
    else the position clamped to the last slot — the clamp JAX's
    ``dynamic_update_slice`` applies silently. Idle batch rows keep
    stepping past the capacity, so the clamp keeps their writes in
    range."""
    if window:
        return torch.remainder(pos, cache_len)
    return torch.clamp(pos, max=cache_len - 1)


def _write_slot(cache: Tensor, new: Tensor, slot: Tensor) -> Tensor:
    """cache (B,Sc,...), new (B,1,...), slot (B,): writes row b's new entry
    at slot[b] in place and returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache


def attn_decode(p: dict, cfg: ModelConfig, x: Tensor,
                cache_k: Tensor, cache_v: Tensor,
                pos: Tensor, kv_pos: Tensor, *,
                window: int = 0,
                cross_kv: Optional[tuple[Tensor, Tensor]] = None,
                scales: Optional[tuple[Tensor, Tensor]] = None,
                ) -> tuple[Tensor, Tensor, Tensor, Optional[tuple]]:
    """One-token decode. x (B,1,d); cache_k/v (B,Sc,KV,hd); pos (B,) int32;
    kv_pos (B,Sc) already holding ``pos`` at this step's slot. Returns
    (out (B,1,d), cache_k, cache_v, scales) — the caches (and the int8
    ``scales`` pair) written in place.

    For cross-attention pass ``cross_kv=(k, v)`` precomputed at prefill
    (:func:`project_cross_kv`): the query attends to all of it, and the
    cache arguments are returned untouched.
    """
    B = x.shape[0]
    q = _project_q(p, cfg, x)
    if cross_kv is not None:
        k, v = cross_kv
        o = ops.attention(q, k, v, causal=False)
        return o.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v, scales
    k_new, v_new = _project_kv(p, cfg, x)
    if cfg.rope_theta > 0:
        cos, sin = rope_freqs(cfg, pos[:, None])
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    slot = _slot(pos, cache_k.shape[1], window)
    if cache_k.dtype == torch.int8:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        _write_slot(cache_k, kq, slot)
        _write_slot(cache_v, vq, slot)
        _write_slot(scales[0], ks, slot)
        _write_slot(scales[1], vs, slot)
        k_eff = dequantize_kv(cache_k, scales[0], x.dtype)
        v_eff = dequantize_kv(cache_v, scales[1], x.dtype)
    else:
        _write_slot(cache_k, k_new, slot)
        _write_slot(cache_v, v_new, slot)
        k_eff, v_eff = cache_k, cache_v
    o = ops.attend_cache(q, k_eff, v_eff, pos, kv_pos, window=window)
    return o.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v, scales


def update_kv_pos(kv_pos: Tensor, pos: Tensor, cache_len: int,
                  window: int) -> Tensor:
    """Track global positions stored in each cache slot (-1 = unwritten).
    Returns a new tensor; ``kv_pos`` is left as it was."""
    out = kv_pos.clone()
    rows = torch.arange(out.shape[0], device=out.device)
    out[rows, _slot(pos, cache_len, window).long()] = pos.to(out.dtype)
    return out
