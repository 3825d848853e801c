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

Only the ``dense`` family is ported; the ssm (rwkv6), hybrid (hymba),
moe, vlm and audio branches raise ``NotImplementedError`` naming the
slice they belong to.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import _layer, embed_tokens, unembed

Tensor = torch.Tensor

# the slice that ports each family's decode path
_LATER_SLICE = {
    "ssm": "the ssm family slice (models/rwkv.py, wkv6_step, kernel 7)",
    "hybrid": "the hybrid family slice (models/ssm.py, ssm_step, kernel 6)",
    "moe": "the moe slice (models/moe.py)",
    "vlm": "the vlm/audio slice (models/stubs.py, cross-attention)",
    "audio": "the vlm/audio slice (models/stubs.py, cross-attention)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
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
    Sc = cache_len_for(cfg, seq_len)
    c = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
         "kv_pos": torch.full((batch, Sc), -1, dtype=torch.int32,
                              device=device)}
    c.update(attn.init_kv_cache(cfg, batch, Sc, device=device))
    if torch_dtype(cfg.kv_cache_dtype or cfg.dtype) == torch.int8:
        shape = (cfg.n_layers, batch, Sc, cfg.n_kv_heads)
        c["k_scale"] = torch.zeros(shape, dtype=torch.float32, device=device)
        c["v_scale"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return c


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _block_decode(p: dict, cfg: ModelConfig, x: Tensor, c: dict,
                  pos: Tensor, kv_pos: Tensor) -> tuple[Tensor, dict]:
    """One-token decode through one dense block. ``c`` holds this layer's
    cache views, written in place; returns (x, c)."""
    h = nn.apply_norm(p["ln1"], cfg, x)
    scales = (c["k_scale"], c["v_scale"]) if "k_scale" in c else None
    y, _, _, _ = attn.attn_decode(p["attn"], cfg, h, c["k"], c["v"], pos,
                                  kv_pos, window=decode_window(cfg),
                                  scales=scales)
    x = x + y
    h = nn.apply_norm(p["ln2"], cfg, x)
    return x + nn.apply_mlp(p["mlp"], cfg, h), c


def _layer_cache_keys(cfg: ModelConfig) -> tuple[str, ...]:
    _check_family(cfg)
    keys = ("k", "v")
    if cfg.kv_cache_dtype == "int8":
        keys += ("k_scale", "v_scale")
    return keys


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens: Tensor
                ) -> tuple[Tensor, dict]:
    """ONE token step. tokens (B,1) -> (logits (B,1,V), cache): the k/v
    tensors of ``cache`` are written in place; ``pos`` and ``kv_pos`` are
    new tensors in the returned dict."""
    _check_family(cfg)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    kv_pos = cache["kv_pos"]
    if kv_pos.shape[1] > 0:
        kv_pos = attn.update_kv_pos(kv_pos, pos, kv_pos.shape[1],
                                    decode_window(cfg))
    lkeys = _layer_cache_keys(cfg)
    blocks = params["blocks"]
    for i in range(cache["k"].shape[0]):
        x, _ = _block_decode(_layer(blocks, i), cfg, x,
                             {k: cache[k][i] for k in lkeys}, pos, kv_pos)
    new_cache = dict(cache)
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
    unwritten (``kv_pos`` -1). ``extras`` is the vlm/audio families'
    input; the dense family takes none.
    """
    _check_family(cfg)
    B, S = tokens.shape
    cache_seq = cache_seq or S
    dev = tokens.device
    cache = init_cache(cfg, B, cache_seq, device=dev)
    Sc = cache_len_for(cfg, cache_seq)
    W = decode_window(cfg)
    quant = cache["k"].dtype == torch.int8
    x = embed_tokens(params, cfg, tokens)
    blocks = params["blocks"]

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
        x = x + y
        hn = nn.apply_norm(p_l["ln2"], cfg, x)
        x = x + nn.apply_mlp(p_l["mlp"], cfg, hn)
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
