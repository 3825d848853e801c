"""Prefill + single-token decode with stacked (over layers) caches.

:func:`decode_step` advances every row of a batched cache by ONE token;
:func:`prefill` runs a prompt and returns the cache ready to decode from
its end. Windowed archs use a ring-buffer cache of ``min(seq, window)``
slots. ``lax.scan`` over the stacked layer axis becomes a Python loop
over that axis, as in ``models/transformer.py``.

Caches are written IN PLACE: a decode step writes each layer's new k/v
into the stacked cache tensors it was given (``attention.attn_decode``)
and returns a dict holding those same tensors, with fresh ``pos`` and
``kv_pos`` tensors (so a caller's earlier reference to either still
reads the values from before the step).

The ssm family (rwkv6) carries no KV: its cache is the per-layer WKV
state and the two token-shift carries. The hybrid family (hymba) carries
a windowed KV cache plus each layer's SSM conv tail and scan state. Both
recurrent states are written in place too. The moe family's blocks run
their MoE mlp (``models/moe.py``) on the step's rows or the prompt, as
the JAX package does. The vlm and audio branches raise
``NotImplementedError`` naming the slice they belong to.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (PORTED_FAMILIES, _layer,
                                            embed_tokens, unembed)

Tensor = torch.Tensor

# the slice that ports each family's decode path
_LATER_SLICE = {
    "vlm": "the vlm/audio slice (models/stubs.py, cross-attention)",
    "audio": "the vlm/audio slice (models/stubs.py, cross-attention)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} decode belongs to "
            f"{_LATER_SLICE.get(cfg.family, 'a later slice')}, which is not "
            "ported yet")


# hybrid models carry O(1) recurrent state for long-range context, so
# their attention branch only needs a bounded local window
HYBRID_DEFAULT_WINDOW = 1024


def decode_window(cfg: ModelConfig) -> int:
    """Effective attention window for decode caches, sized from FAMILY,
    not just the sliding_window knob: ssm (rwkv) carries no KV at all;
    hybrid defaults to a bounded local window because its scan state
    covers the long range. 0 means unwindowed (full causal KV)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.sliding_window or HYBRID_DEFAULT_WINDOW
    return cfg.sliding_window or 0


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "ssm":
        return 0
    W = decode_window(cfg)
    if W:
        return min(seq_len, W)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device) -> dict:
    """Zeroed cache dict sized for ``seq_len`` context, on ``device``."""
    _check_family(cfg)
    L, d, dt = cfg.n_layers, cfg.d_model, torch_dtype(cfg.dtype)
    c = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        H, rhd = rwkv_mod.rwkv_dims(cfg)
        c["wkv"] = torch.zeros((L, batch, H, rhd, rhd), dtype=torch.float32,
                               device=device)
        c["shift_tm"] = torch.zeros((L, batch, 1, d), dtype=dt,
                                    device=device)
        c["shift_cm"] = torch.zeros((L, batch, 1, d), dtype=dt,
                                    device=device)
        return c
    Sc = cache_len_for(cfg, seq_len)
    c["kv_pos"] = torch.full((batch, Sc), -1, dtype=torch.int32,
                             device=device)
    c.update(attn.init_kv_cache(cfg, batch, Sc, device=device))
    if torch_dtype(cfg.kv_cache_dtype or cfg.dtype) == torch.int8:
        shape = (L, batch, Sc, cfg.n_kv_heads)
        c["k_scale"] = torch.zeros(shape, dtype=torch.float32, device=device)
        c["v_scale"] = torch.zeros(shape, dtype=torch.float32, device=device)
    if cfg.family == "hybrid":
        st = ssm_mod.init_ssm_state(cfg, batch, device=device)
        c["ssm_conv"], c["ssm_scan"] = st["conv"], st["scan"]
    return c


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _block_decode(p: dict, cfg: ModelConfig, x: Tensor, c: dict,
                  pos: Tensor, kv_pos: Tensor) -> tuple[Tensor, dict]:
    """One-token decode through one block. ``c`` holds this layer's
    cache views, written in place; returns (x, c)."""
    if cfg.family == "ssm":
        h = nn.apply_norm(p["ln1"], cfg, x)
        y, shift, wkv = rwkv_mod.time_mix_decode(
            p["time_mix"], cfg, h, c["shift_tm"], c["wkv"])
        c["shift_tm"].copy_(shift)
        c["wkv"].copy_(wkv)
        x = x + y
        h = nn.apply_norm(p["ln2"], cfg, x)
        y, shift = rwkv_mod.channel_mix(p["channel_mix"], cfg, h,
                                        shift_carry=c["shift_cm"])
        c["shift_cm"].copy_(shift)
        return x + y, c
    h = nn.apply_norm(p["ln1"], cfg, x)
    scales = (c["k_scale"], c["v_scale"]) if "k_scale" in c else None
    y, _, _, _ = attn.attn_decode(p["attn"], cfg, h, c["k"], c["v"], pos,
                                  kv_pos, window=decode_window(cfg),
                                  scales=scales)
    if cfg.family == "hybrid":
        ys, tail, scan = ssm_mod.ssm_decode(p["ssm"], cfg, h, c["ssm_conv"],
                                            c["ssm_scan"])
        c["ssm_conv"].copy_(tail)
        c["ssm_scan"].copy_(scan)
        y = 0.5 * (y + ys)
    x = x + y
    h = nn.apply_norm(p["ln2"], cfg, x)
    return x + _mlp(p, cfg, h), c


def _mlp(p: dict, cfg: ModelConfig, h: Tensor) -> Tensor:
    """The block's mlp: the MoE (its aux loss dropped) or the dense one."""
    if cfg.family == "moe":
        return moe_mod.moe_forward(p["moe"], cfg, h)[0]
    return nn.apply_mlp(p["mlp"], cfg, h)


def _layer_cache_keys(cfg: ModelConfig) -> tuple[str, ...]:
    _check_family(cfg)
    if cfg.family == "ssm":
        return ("wkv", "shift_tm", "shift_cm")
    keys = ("k", "v")
    if cfg.kv_cache_dtype == "int8":
        keys += ("k_scale", "v_scale")
    if cfg.family == "hybrid":
        keys += ("ssm_conv", "ssm_scan")
    return keys


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens: Tensor
                ) -> tuple[Tensor, dict]:
    """ONE token step. tokens (B,1) -> (logits (B,1,V), cache): the
    per-layer tensors of ``cache`` (k/v, recurrent states) are written in
    place; ``pos`` and ``kv_pos`` are new tensors in the returned dict."""
    _check_family(cfg)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    kv_pos = cache.get("kv_pos")
    if kv_pos is not None and kv_pos.shape[1] > 0:
        kv_pos = attn.update_kv_pos(kv_pos, pos, kv_pos.shape[1],
                                    decode_window(cfg))
    lkeys = _layer_cache_keys(cfg)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        x, _ = _block_decode(_layer(blocks, i), cfg, x,
                             {k: cache[k][i] for k in lkeys}, pos, kv_pos)
    new_cache = dict(cache)
    if kv_pos is not None:
        new_cache["kv_pos"] = kv_pos
    new_cache["pos"] = pos + 1
    return unembed(params, cfg, x), new_cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _to_ring(full: Tensor, S: int, W: int) -> Tensor:
    """(B,S,…) position-major kv -> (B,W,…) ring layout (slot = pos % W)."""
    last = full[:, S - W:S]
    slots = torch.arange(S - W, S, device=full.device) % W
    out = torch.zeros_like(last)
    out[:, slots] = last
    return out


def prefill(params: dict, cfg: ModelConfig, tokens: Tensor, *,
            extras: Optional[dict] = None, cache_seq: Optional[int] = None
            ) -> tuple[Tensor, dict]:
    """Full-sequence forward that also fills a decode cache.

    Returns (logits (B,S,V), cache ready for decode at pos=S). A cache
    longer than the prompt (``cache_seq > S``) is padded: the attention
    runs at the prompt's own length and the slots past ``S`` stay
    unwritten (``kv_pos`` -1). The ssm family's cache is its final
    recurrent state (the WKV state the scan kernel returns) and the
    token-shift carries, the hybrid family's adds each layer's SSM conv
    tail and scan state to the KV. ``extras`` is the vlm/audio families'
    input; the ported families take none.
    """
    _check_family(cfg)
    B, S = tokens.shape
    cache_seq = cache_seq or S
    dev = tokens.device
    cache = init_cache(cfg, B, cache_seq, device=dev)
    x = embed_tokens(params, cfg, tokens)
    blocks = params["blocks"]

    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            p_l = _layer(blocks, i)
            hn = nn.apply_norm(p_l["ln1"], cfg, x)
            y, sh_tm, wkv = rwkv_mod.time_mix_forward(p_l["time_mix"], cfg,
                                                      hn)
            x = x + y
            hn = nn.apply_norm(p_l["ln2"], cfg, x)
            y, sh_cm = rwkv_mod.channel_mix(p_l["channel_mix"], cfg, hn)
            x = x + y
            cache["wkv"][i].copy_(wkv)
            cache["shift_tm"][i].copy_(sh_tm)
            cache["shift_cm"][i].copy_(sh_cm)
        cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
        return unembed(params, cfg, x), cache

    Sc = cache_len_for(cfg, cache_seq)
    W = decode_window(cfg)
    quant = cache["k"].dtype == torch.int8

    def capture(dst: Tensor, new: Tensor) -> None:
        if W and Sc < S:                                   # ring buffer
            dst.copy_(_to_ring(new, S, Sc))
        else:                                              # pad to capacity
            dst[:, :S] = new

    for i in range(cfg.n_layers):
        p_l = _layer(blocks, i)
        hn = nn.apply_norm(p_l["ln1"], cfg, x)
        y, (k, v) = attn.attn_forward(p_l["attn"], cfg, hn, window=W,
                                      return_kv=True)
        if cfg.family == "hybrid":
            ys, tail, scan = ssm_mod.ssm_forward_with_state(p_l["ssm"], cfg,
                                                            hn)
            cache["ssm_conv"][i].copy_(tail)
            cache["ssm_scan"][i].copy_(scan)
            y = 0.5 * (y + ys)
        x = x + y
        hn = nn.apply_norm(p_l["ln2"], cfg, x)
        x = x + _mlp(p_l, cfg, hn)
        if quant:
            k, ks = attn.quantize_kv(k)
            v, vs = attn.quantize_kv(v)
            capture(cache["k_scale"][i], ks)
            capture(cache["v_scale"][i], vs)
        capture(cache["k"][i], k)
        capture(cache["v"][i], v)

    # kv_pos: which global position occupies each cache slot
    if Sc >= S:                                            # plain cache
        ar = torch.arange(Sc, dtype=torch.int32, device=dev)
        kvp = torch.where(ar < S, ar, torch.full_like(ar, -1))
    else:                                                  # ring buffer
        pos_range = torch.arange(S - Sc, S, dtype=torch.int32, device=dev)
        kvp = torch.zeros((Sc,), dtype=torch.int32, device=dev)
        kvp[pos_range % Sc] = pos_range
    cache["kv_pos"] = kvp[None].expand(B, Sc).contiguous()
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
    return unembed(params, cfg, x), cache
