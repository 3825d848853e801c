"""Block-stacked dense transformer and fragment execution.

Parameters keep the JAX package's leading layer axis (``params["blocks"]``
holds one tensor per weight with shape ``(L, ...)``), so a fragment's
blocks ``[start, end)`` are views of the stacked tensors, and
``lax.scan`` over that axis becomes a Python loop. Re-alignment (the
paper's technique) cuts the stack at block granularity:
:func:`fragment_forward` executes blocks ``[start, end)`` on externally
supplied hidden states — the substrate operation Graft's alignment and
shared stages run.

Families:
  dense   — [ln -> GQA attn] + [ln -> (swiglu|gelu) mlp]
  moe     — attn + MoE mlp (``models/moe.py``: grouped or dense dispatch)
  hybrid  — parallel attn + mamba2-style SSM heads (hymba), then mlp
  ssm     — RWKV6 time-mix + channel-mix (attention-free)
  vlm     — dense blocks with a tanh-gated cross-attention block after
            every ``cross_attn_every`` of them (llama-3.2-vision); the
            fragment unit is that superblock. Image embeddings come from
            the stub frontend (``models/stubs.py``)
  audio   — whisper-style encoder-decoder: a bidirectional encoder over
            stub frame embeddings, decoder blocks of self-attention, then
            cross-attention to the encoder's memory, then the mlp

``remat`` (training) recomputes each block's activations in the
backward, as the JAX package's ``jax.checkpoint`` over the layer scan:
False keeps them, True / "full" recomputes everything, "dots" keeps the
outputs of the non-batched matrix products (the port's
``dots_with_no_batch_dims_saveable``) and recomputes the rest. A vlm
model recomputes per superblock (its E self blocks and its cross block).
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import torch_dtype

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raise rather than fall back to the CPU
    when a CUDA device is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def _layer(blocks: dict, i: int) -> dict:
    """The i-th layer's params out of a stacked-blocks dict (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _layers(blocks: dict, n: Optional[int] = None) -> list:
    """Every layer's params out of a stacked-blocks dict, by one
    ``unbind`` per leaf (views). Training takes this over ``_layer`` per
    layer: an unbind's gradient is one stack of the layers' gradients,
    where indexing each layer would add up one zero-padded full-stack
    gradient per layer."""
    n = _depth(blocks) if n is None else n
    per_leaf = {k: _layers(v, n) if isinstance(v, dict) else torch.unbind(v)
                for k, v in blocks.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _depth(blocks: dict) -> int:
    """Length of the leading layer axis of a stacked-blocks dict."""
    for v in blocks.values():
        if isinstance(v, dict):
            if v:
                return _depth(v)
        else:
            return v.shape[0]
    raise ValueError("stacked blocks hold no tensor")


def slice_blocks(blocks: dict, start: int, end: int) -> dict:
    """Blocks ``[start, end)`` of a stacked-blocks dict (views)."""
    return {k: slice_blocks(v, start, end) if isinstance(v, dict)
            else v[start:end] for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_stack(gen: torch.Generator, cfg: ModelConfig, lead: tuple, *,
               kind: str = "self") -> dict:
    """Blocks of ``kind`` stacked on the ``lead`` axes. kind: self |
    cross (the vlm's gated cross block) | enc (whisper's bidirectional
    encoder block, the weights of a self block) | dec (whisper's decoder
    block: self, then cross)."""
    dev = gen.device
    blocks = {"ln1": nn.init_norm(cfg, dev, lead),
              "ln2": nn.init_norm(cfg, dev, lead)}
    if cfg.family == "ssm":
        blocks["time_mix"] = rwkv_mod.init_time_mix(gen, cfg, lead)
        blocks["channel_mix"] = rwkv_mod.init_channel_mix(gen, cfg, lead)
        return blocks
    if kind == "cross":
        blocks["xattn"] = attn.init_attention(gen, cfg, lead)
        blocks["mlp"] = nn.init_mlp(gen, cfg, lead)
        # zero gates: a fresh cross block passes its input through
        blocks["gate_attn"] = torch.zeros(lead, dtype=torch.float32,
                                          device=dev)
        blocks["gate_mlp"] = torch.zeros(lead, dtype=torch.float32,
                                         device=dev)
        return blocks
    blocks["attn"] = attn.init_attention(gen, cfg, lead)
    if kind == "dec":
        blocks["xattn"] = attn.init_attention(gen, cfg, lead)
        blocks["lnx"] = nn.init_norm(cfg, dev, lead)
    if cfg.family == "moe":
        blocks["moe"] = moe_mod.init_moe(gen, cfg, lead)
    else:
        blocks["mlp"] = nn.init_mlp(gen, cfg, lead)
    if cfg.family == "hybrid":
        blocks["ssm"] = ssm_mod.init_ssm(gen, cfg, lead)
    return blocks


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (None = the card), in the JAX package's layout: block weights are
    stacked along a leading layer axis of length ``cfg.n_layers``; a vlm
    model's self blocks along two, (superblock G, layer E), beside its G
    ``cross_blocks``; an audio model adds ``enc_blocks`` and
    ``enc_norm``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = torch_dtype(cfg.dtype)
    p: dict = {
        "embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": nn.init_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    if cfg.family == "vlm":
        E = cfg.vision.cross_attn_every
        G = cfg.n_layers // E
        p["blocks"] = init_stack(gen, cfg, (G, E))
        p["cross_blocks"] = init_stack(gen, cfg, (G,), kind="cross")
    elif cfg.family == "audio":
        p["enc_blocks"] = init_stack(gen, cfg, (cfg.audio.n_encoder_layers,),
                                     kind="enc")
        p["enc_norm"] = nn.init_norm(cfg, dev)
        p["blocks"] = init_stack(gen, cfg, (cfg.n_layers,), kind="dec")
    else:
        p["blocks"] = init_stack(gen, cfg, (cfg.n_layers,))
    return p


# ---------------------------------------------------------------------------
# Full-sequence block application (prefill / fragments)
# ---------------------------------------------------------------------------

def block_forward(p: dict, cfg: ModelConfig, x: Tensor, *,
                  window: int = 0, causal: bool = True,
                  memory: Optional[Tensor] = None, kind: str = "self",
                  seg_ids: Optional[Tensor] = None,
                  positions: Optional[Tensor] = None
                  ) -> tuple[Tensor, Optional[Tensor]]:
    """One block of ``kind`` (see :func:`init_stack`; an enc block runs
    with ``causal=False``), full sequence; cross and dec blocks attend to
    ``memory`` (B, T, d). Returns (x, moe_aux): the router's
    load-balance loss for a moe block, None for every other family.

    seg_ids/positions (B, S) carry the sequence-packed layout
    (``models.packed``): attention is masked to segment boundaries and
    RoPE restarts per segment. None = the ordinary unpacked batch.
    """
    if cfg.family == "ssm":
        y, _, _ = rwkv_mod.time_mix_forward(
            p["time_mix"], cfg, nn.apply_norm(p["ln1"], cfg, x))
        x = x + y
        y, _ = rwkv_mod.channel_mix(
            p["channel_mix"], cfg, nn.apply_norm(p["ln2"], cfg, x))
        return x + y, None
    if kind == "cross":
        h = nn.apply_norm(p["ln1"], cfg, x)
        y = attn.attn_forward(p["xattn"], cfg, h, kv_src=memory,
                              causal=False)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * y
        h = nn.apply_norm(p["ln2"], cfg, x)
        return x + torch.tanh(p["gate_mlp"]).to(x.dtype) \
            * nn.apply_mlp(p["mlp"], cfg, h), None
    h = nn.apply_norm(p["ln1"], cfg, x)
    y = attn.attn_forward(p["attn"], cfg, h, window=window, causal=causal,
                          positions=positions, seg_ids=seg_ids)
    if cfg.family == "hybrid":
        y = 0.5 * (y + ssm_mod.ssm_forward(p["ssm"], cfg, h))
    x = x + y
    if kind == "dec":
        h = nn.apply_norm(p["lnx"], cfg, x)
        x = x + attn.attn_forward(p["xattn"], cfg, h, kv_src=memory,
                                  causal=False)
    h = nn.apply_norm(p["ln2"], cfg, x)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_forward(p["moe"], cfg, h)
        return x + y, aux
    return x + nn.apply_mlp(p["mlp"], cfg, h), None


Remat = Union[bool, str]
REMAT = (False, True, "full", "dots")
# what "dots" keeps: the outputs of products without batch dimensions
# (every weight product; attention's batched products are recomputed)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat_kwargs(remat: Remat) -> Optional[dict]:
    """``torch.utils.checkpoint`` arguments for one block, or None (keep
    every activation)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    if not remat:
        return None
    kw: dict = {"use_reentrant": False}
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    return kw


def stack_forward(blocks: dict, cfg: ModelConfig, x: Tensor, *,
                  window: int = 0, causal: bool = True,
                  memory: Optional[Tensor] = None, kind: str = "self",
                  seg_ids: Optional[Tensor] = None,
                  positions: Optional[Tensor] = None,
                  remat: Remat = False) -> tuple[Tensor, Tensor]:
    """Apply every layer of ``blocks`` (leading layer axis) in order,
    each block under ``remat`` (see the module docstring). Returns (x,
    the moe aux loss summed over the layers: a float32 scalar, 0 for the
    families without a router)."""
    ckpt = _remat_kwargs(remat)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in _layers(blocks):
        def block(h, p_l=p_l):
            return block_forward(p_l, cfg, h, window=window, causal=causal,
                                 memory=memory, kind=kind, seg_ids=seg_ids,
                                 positions=positions)
        x, aux = block(x) if ckpt is None else checkpoint(block, x, **ckpt)
        if aux is not None:
            total = total + aux
    return x, total


def vlm_stack_forward(params: dict, cfg: ModelConfig, x: Tensor,
                      img: Tensor, *, window: int = 0,
                      remat: Remat = False) -> tuple[Tensor, Tensor]:
    """Every superblock in order: its E self layers, then its gated cross
    block over the image embeddings ``img`` (B, T, d), the superblock
    under ``remat``. Returns (x, a float32 zero: no router)."""
    ckpt = _remat_kwargs(remat)
    selfs = _layers(params["blocks"])
    for p_self, p_cross in zip(selfs, _layers(params["cross_blocks"],
                                              len(selfs))):
        def superblock(h, p_self=p_self, p_cross=p_cross):
            h, _ = stack_forward(p_self, cfg, h, window=window)
            return block_forward(p_cross, cfg, h, memory=img,
                                 kind="cross")[0]
        x = superblock(x) if ckpt is None else \
            checkpoint(superblock, x, **ckpt)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Model facade
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return params["embed"][tokens.long()]


def unembed(params: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = nn.apply_norm(params["final_norm"], cfg, x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def add_positions(cfg: ModelConfig, x: Tensor) -> Tensor:
    """An audio model's token embeddings (B, S, d) plus the sinusoid of
    positions 0..S-1; every other family's unchanged."""
    if cfg.family != "audio":
        return x
    pe = nn.sinusoid_pos_emb(x.shape[1], cfg.d_model, device=x.device)
    return x + pe.to(x.dtype)[None]


def encode_audio(params: dict, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """Whisper encoder over stub frame embeddings (B, F, d) -> memory
    (B, F, d): the sinusoid added, the bidirectional blocks, the norm."""
    pe = nn.sinusoid_pos_emb(frames.shape[1], cfg.d_model,
                             device=frames.device)
    h, _ = stack_forward(params["enc_blocks"], cfg, frames
                         + pe.to(frames.dtype)[None], causal=False,
                         kind="enc")
    return nn.apply_norm(params["enc_norm"], cfg, h)


def forward(params: dict, cfg: ModelConfig, tokens: Tensor, *,
            extras: Optional[dict] = None, remat: Remat = False
            ) -> tuple[Tensor, Tensor]:
    """Full forward (training / logits-only prefill): tokens (B, S) ->
    (logits (B, S, vocab), moe_aux), as the JAX ``forward``: moe_aux is
    the router load-balance loss summed over the layers (0 for the
    families without a router). ``extras``: {"images": (B, T, d)} for
    vlm, {"frames": (B, F, d)} for audio."""
    extras = extras or {}
    x = add_positions(cfg, embed_tokens(params, cfg, tokens))
    if cfg.family == "audio":
        mem = encode_audio(params, cfg, extras["frames"])
        x, aux = stack_forward(params["blocks"], cfg, x, memory=mem,
                               kind="dec", remat=remat)
    elif cfg.family == "vlm":
        x, aux = vlm_stack_forward(params, cfg, x, extras["images"],
                                   window=cfg.sliding_window, remat=remat)
    else:
        x, aux = stack_forward(params["blocks"], cfg, x,
                               window=cfg.sliding_window, remat=remat)
    return unembed(params, cfg, x), aux


# ---------------------------------------------------------------------------
# Fragment execution (the substrate operation for DNN re-alignment)
# ---------------------------------------------------------------------------

def n_fragment_units(cfg: ModelConfig) -> int:
    """Number of re-partitionable units ("layers" in Graft's sense)."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.vision.cross_attn_every
    return cfg.n_layers


def fragment_forward(params: dict, cfg: ModelConfig, hidden: Tensor,
                     start: int, end: int, *,
                     extras: Optional[dict] = None) -> Tensor:
    """Run units [start, end) on hidden states — Graft stage execution.
    A vlm unit is a superblock and reads ``extras["images"]``; an audio
    unit reads the encoder's output, ``extras["memory"]``."""
    extras = extras or {}
    blocks = slice_blocks(params["blocks"], start, end)
    if cfg.family == "vlm":
        x, _ = vlm_stack_forward(
            {"blocks": blocks,
             "cross_blocks": slice_blocks(params["cross_blocks"], start,
                                          end)},
            cfg, hidden, extras["images"], window=cfg.sliding_window)
    elif cfg.family == "audio":
        x, _ = stack_forward(blocks, cfg, hidden, memory=extras["memory"],
                             kind="dec")
    else:
        x, _ = stack_forward(blocks, cfg, hidden, window=cfg.sliding_window)
    return x


def run_fragment(params: dict, cfg: ModelConfig, inputs: Tensor,
                 start: int, end: int, *,
                 extras: Optional[dict] = None, offset: int = 0) -> Tensor:
    """Fragment execution including the embed (start==0) and head (end==L)
    boundary work — what a serving instance actually runs.

    ``extras`` carries the vlm/audio families' per-request inputs
    (:func:`fragment_forward`); the other families ignore it, as the JAX
    package does. ``offset`` is the unit ``params["blocks"]`` starts at:
    a pool worker holds only its own unit range (see
    :func:`slice_params`)."""
    L = n_fragment_units(cfg)
    x = inputs
    if start == 0:
        x = add_positions(cfg, embed_tokens(params, cfg, inputs))
    x = fragment_forward(params, cfg, x, start - offset, end - offset,
                         extras=extras)
    if end == L:
        x = unembed(params, cfg, x)
    return x


def slice_params(params: dict, cfg: ModelConfig, start: int,
                 end: int) -> dict:
    """The parameters units ``[start, end)`` read, and nothing else: the
    blocks of that range (views; a vlm model's cross blocks too), the
    embedding when the range starts at 0 or its head is tied to it, the
    final norm and head when it ends at the last unit. Run it with
    ``offset=start``. An audio range reads the encoder's memory from its
    extras, so it holds no encoder."""
    L = n_fragment_units(cfg)
    out = {"blocks": slice_blocks(params["blocks"], start, end)}
    if cfg.family == "vlm":
        out["cross_blocks"] = slice_blocks(params["cross_blocks"], start,
                                           end)
    if start == 0 or (end == L and cfg.tie_embeddings):
        out["embed"] = params["embed"]
    if end == L:
        out["final_norm"] = params["final_norm"]
        if not cfg.tie_embeddings:
            out["lm_head"] = params["lm_head"]
    return out
