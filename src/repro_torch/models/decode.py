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
the JAX package does. The vlm family's self-attention caches carry two
leading axes (superblock G, layer E) beside each superblock's image k/v
(``img_k``/``img_v``); the audio family's carry each decoder layer's
cross-attention k/v of the encoder's memory (``xk``/``xv``). Prefill
projects both once (``attention.project_cross_kv``); decode only reads
them.
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
from repro_torch.models.transformer import (_layer, add_positions,
                                            block_forward, embed_tokens,
                                            encode_audio, unembed)

Tensor = torch.Tensor

# rows of the audio decoder's positional table (positions past the last
# row read it, as the JAX package's clip does)
AUDIO_POSITIONS = 4096
_AUDIO_PE: dict = {}       # (device, d) -> (AUDIO_POSITIONS, d) table


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
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    lead = (L,)
    if cfg.family == "vlm":
        E = cfg.vision.cross_attn_every
        G = L // E
        lead = (G, E)
        img = (G, batch, cfg.vision.n_image_tokens, KV, hd)
        c["img_k"] = torch.zeros(img, dtype=dt, device=device)
        c["img_v"] = torch.zeros(img, dtype=dt, device=device)
    kv_dt = torch_dtype(cfg.kv_cache_dtype or cfg.dtype)
    c["k"] = torch.zeros((*lead, batch, Sc, KV, hd), dtype=kv_dt,
                         device=device)
    c["v"] = torch.zeros_like(c["k"])
    if kv_dt == torch.int8:
        shape = (*lead, batch, Sc, KV)
        c["k_scale"] = torch.zeros(shape, dtype=torch.float32, device=device)
        c["v_scale"] = torch.zeros(shape, dtype=torch.float32, device=device)
    if cfg.family == "audio":
        mem = (L, batch, cfg.audio.n_audio_frames, KV, hd)
        c["xk"] = torch.zeros(mem, dtype=dt, device=device)
        c["xv"] = torch.zeros(mem, dtype=dt, device=device)
    if cfg.family == "hybrid":
        st = ssm_mod.init_ssm_state(cfg, batch, device=device)
        c["ssm_conv"], c["ssm_scan"] = st["conv"], st["scan"]
    return c


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _block_decode(p: dict, cfg: ModelConfig, x: Tensor, c: dict,
                  pos: Tensor, kv_pos: Tensor, *, kind: str = "self",
                  memory_kv: Optional[tuple] = None) -> tuple[Tensor, dict]:
    """One-token decode through one block of ``kind`` (self | cross |
    dec). ``c`` holds this layer's cache views, written in place;
    returns (x, c). Cross and dec blocks attend to ``memory_kv``, the
    (k, v) prefill projected."""
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
    if kind == "cross":
        h = nn.apply_norm(p["ln1"], cfg, x)
        y, _, _, _ = attn.attn_decode(p["xattn"], cfg, h, None, None, pos,
                                      kv_pos, cross_kv=memory_kv)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * y
        h = nn.apply_norm(p["ln2"], cfg, x)
        return x + torch.tanh(p["gate_mlp"]).to(x.dtype) \
            * nn.apply_mlp(p["mlp"], cfg, h), c
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
    if kind == "dec":
        h = nn.apply_norm(p["lnx"], cfg, x)
        y, _, _, _ = attn.attn_decode(p["xattn"], cfg, h, None, None, pos,
                                      kv_pos, cross_kv=memory_kv)
        x = x + y
    h = nn.apply_norm(p["ln2"], cfg, x)
    return x + _mlp(p, cfg, h), c


def _mlp(p: dict, cfg: ModelConfig, h: Tensor) -> Tensor:
    """The block's mlp: the MoE (its aux loss dropped) or the dense one."""
    if cfg.family == "moe":
        return moe_mod.moe_forward(p["moe"], cfg, h)[0]
    return nn.apply_mlp(p["mlp"], cfg, h)


def _layer_cache_keys(cfg: ModelConfig) -> tuple[str, ...]:
    """The cache entries each (self-attention) layer owns a slice of."""
    if cfg.family == "ssm":
        return ("wkv", "shift_tm", "shift_cm")
    keys = ("k", "v")
    if cfg.kv_cache_dtype == "int8":
        keys += ("k_scale", "v_scale")
    if cfg.family == "hybrid":
        keys += ("ssm_conv", "ssm_scan")
    if cfg.family == "audio":
        keys += ("xk", "xv")
    return keys


def _audio_positions(cfg: ModelConfig, pos: Tensor) -> Tensor:
    """(B, 1, d) float32 rows of the decoder's sinusoid at ``pos``, from a
    table built once per device."""
    key = (pos.device, cfg.d_model)
    if key not in _AUDIO_PE:
        _AUDIO_PE[key] = nn.sinusoid_pos_emb(AUDIO_POSITIONS, cfg.d_model,
                                             device=pos.device)
    pe = _AUDIO_PE[key]
    return pe[torch.clamp(pos.long(), 0, AUDIO_POSITIONS - 1)][:, None]


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens: Tensor
                ) -> tuple[Tensor, dict]:
    """ONE token step. tokens (B,1) -> (logits (B,1,V), cache): the
    per-layer tensors of ``cache`` (k/v, recurrent states) are written in
    place; ``pos`` and ``kv_pos`` are new tensors in the returned dict."""
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    if cfg.family == "audio":
        x = x + _audio_positions(cfg, pos).to(x.dtype)
    kv_pos = cache.get("kv_pos")
    if kv_pos is not None and kv_pos.shape[1] > 0:
        kv_pos = attn.update_kv_pos(kv_pos, pos, kv_pos.shape[1],
                                    decode_window(cfg))
    lkeys = _layer_cache_keys(cfg)
    blocks = params["blocks"]
    if cfg.family == "vlm":
        for g in range(cfg.n_layers // cfg.vision.cross_attn_every):
            sb = _layer(blocks, g)
            for e in range(cfg.vision.cross_attn_every):
                x, _ = _block_decode(_layer(sb, e), cfg, x,
                                     {k: cache[k][g, e] for k in lkeys},
                                     pos, kv_pos)
            x, _ = _block_decode(_layer(params["cross_blocks"], g), cfg, x,
                                 {}, pos, kv_pos, kind="cross",
                                 memory_kv=(cache["img_k"][g],
                                            cache["img_v"][g]))
    else:
        kind = "dec" if cfg.family == "audio" else "self"
        for i in range(cfg.n_layers):
            c = {k: cache[k][i] for k in lkeys}
            mem = (c["xk"], c["xv"]) if kind == "dec" else None
            x, _ = _block_decode(_layer(blocks, i), cfg, x, c, pos, kv_pos,
                                 kind=kind, memory_kv=mem)
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
    input (``forward``'s): their cross-attention k/v of the image
    embeddings or of the encoder's memory are projected here, once.
    """
    extras = extras or {}
    B, S = tokens.shape
    cache_seq = cache_seq or S
    dev = tokens.device
    cache = init_cache(cfg, B, cache_seq, device=dev)
    x = add_positions(cfg, embed_tokens(params, cfg, tokens))
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

    def layer(p_l: dict, c: dict, x: Tensor, mem: Optional[Tensor]
              ) -> Tensor:
        """One self-attention layer over the prompt, filling its cache
        views ``c``; with ``mem``, a whisper decoder layer's cross-
        attention too, whose k/v of ``mem`` go to ``c["xk"]``/``"xv"``."""
        hn = nn.apply_norm(p_l["ln1"], cfg, x)
        y, (k, v) = attn.attn_forward(p_l["attn"], cfg, hn, window=W,
                                      return_kv=True)
        if cfg.family == "hybrid":
            ys, tail, scan = ssm_mod.ssm_forward_with_state(p_l["ssm"], cfg,
                                                            hn)
            c["ssm_conv"].copy_(tail)
            c["ssm_scan"].copy_(scan)
            y = 0.5 * (y + ys)
        x = x + y
        if mem is not None:
            hn = nn.apply_norm(p_l["lnx"], cfg, x)
            y, (xk, xv) = attn.attn_forward(p_l["xattn"], cfg, hn,
                                            kv_src=mem, causal=False,
                                            return_kv=True)
            x = x + y
            c["xk"].copy_(xk)
            c["xv"].copy_(xv)
        hn = nn.apply_norm(p_l["ln2"], cfg, x)
        x = x + _mlp(p_l, cfg, hn)
        if quant:
            k, ks = attn.quantize_kv(k)
            v, vs = attn.quantize_kv(v)
            capture(c["k_scale"], ks)
            capture(c["v_scale"], vs)
        capture(c["k"], k)
        capture(c["v"], v)
        return x

    lkeys = _layer_cache_keys(cfg)
    if cfg.family == "vlm":
        img = extras["images"]
        for g in range(cfg.n_layers // cfg.vision.cross_attn_every):
            sb = _layer(blocks, g)
            for e in range(cfg.vision.cross_attn_every):
                x = layer(_layer(sb, e), {k: cache[k][g, e] for k in lkeys},
                          x, None)
            p_x = _layer(params["cross_blocks"], g)
            x, _ = block_forward(p_x, cfg, x, memory=img, kind="cross")
            ik, iv = attn.project_cross_kv(p_x["xattn"], cfg, img)
            cache["img_k"][g].copy_(ik)
            cache["img_v"][g].copy_(iv)
    else:
        mem = encode_audio(params, cfg, extras["frames"]) \
            if cfg.family == "audio" else None
        for i in range(cfg.n_layers):
            x = layer(_layer(blocks, i), {k: cache[k][i] for k in lkeys}, x,
                      mem)

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
