"""Block-stacked dense transformer and fragment execution.

Parameters keep the JAX package's leading layer axis (``params["blocks"]``
holds one tensor per weight with shape ``(L, ...)``), so a fragment's
blocks ``[start, end)`` are views of the stacked tensors, and
``lax.scan`` over that axis becomes a Python loop. Re-alignment (the
paper's technique) cuts the stack at block granularity:
:func:`fragment_forward` executes blocks ``[start, end)`` on externally
supplied hidden states — the substrate operation Graft's alignment and
shared stages run.

Families ported so far:
  dense   — [ln -> GQA attn] + [ln -> (swiglu|gelu) mlp]
  hybrid  — parallel attn + mamba2-style SSM heads (hymba), then mlp
  ssm     — RWKV6 time-mix + channel-mix (attention-free)
The moe, vlm and audio families raise ``NotImplementedError``.

``remat`` (training) recomputes each block's activations in the
backward, as the JAX package's ``jax.checkpoint`` over the layer scan:
False keeps them, True / "full" recomputes everything, "dots" keeps the
outputs of the non-batched matrix products (the port's
``dots_with_no_batch_dims_saveable``) and recomputes the rest.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
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


PORTED_FAMILIES = ("dense", "hybrid", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(PORTED_FAMILIES)})")


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

def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (None = the card). Block weights are stacked along a leading layer
    axis of length ``cfg.n_layers``."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = torch_dtype(cfg.dtype)
    L = (cfg.n_layers,)
    p: dict = {
        "embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": nn.init_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    blocks = {"ln1": nn.init_norm(cfg, dev, L),
              "ln2": nn.init_norm(cfg, dev, L)}
    if cfg.family == "ssm":
        blocks["time_mix"] = rwkv_mod.init_time_mix(gen, cfg, L)
        blocks["channel_mix"] = rwkv_mod.init_channel_mix(gen, cfg, L)
    else:
        blocks["attn"] = attn.init_attention(gen, cfg, L)
        blocks["mlp"] = nn.init_mlp(gen, cfg, L)
    if cfg.family == "hybrid":
        blocks["ssm"] = ssm_mod.init_ssm(gen, cfg, L)
    p["blocks"] = blocks
    return p


# ---------------------------------------------------------------------------
# Full-sequence block application (prefill / fragments)
# ---------------------------------------------------------------------------

def block_forward(p: dict, cfg: ModelConfig, x: Tensor, *,
                  window: int = 0, causal: bool = True,
                  seg_ids: Optional[Tensor] = None,
                  positions: Optional[Tensor] = None) -> Tensor:
    """One block, full sequence.

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
        return x + y
    h = nn.apply_norm(p["ln1"], cfg, x)
    y = attn.attn_forward(p["attn"], cfg, h, window=window, causal=causal,
                          positions=positions, seg_ids=seg_ids)
    if cfg.family == "hybrid":
        y = 0.5 * (y + ssm_mod.ssm_forward(p["ssm"], cfg, h))
    x = x + y
    h = nn.apply_norm(p["ln2"], cfg, x)
    return x + nn.apply_mlp(p["mlp"], cfg, h)


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
                  seg_ids: Optional[Tensor] = None,
                  positions: Optional[Tensor] = None,
                  remat: Remat = False) -> Tensor:
    """Apply every layer of ``blocks`` (leading layer axis) in order,
    each block under ``remat`` (see the module docstring)."""
    ckpt = _remat_kwargs(remat)
    for p_l in _layers(blocks):
        def block(h, p_l=p_l):
            return block_forward(p_l, cfg, h, window=window, causal=causal,
                                 seg_ids=seg_ids, positions=positions)
        x = block(x) if ckpt is None else checkpoint(block, x, **ckpt)
    return x


# ---------------------------------------------------------------------------
# Model facade
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return params["embed"][tokens.long()]


def unembed(params: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = nn.apply_norm(params["final_norm"], cfg, x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward(params: dict, cfg: ModelConfig, tokens: Tensor, *,
            remat: Remat = False) -> Tensor:
    """Full forward (training / logits-only prefill): tokens (B, S) ->
    logits (B, S, vocab). The ported families have no MoE auxiliary
    loss, so, unlike the JAX ``forward``, it returns the logits alone."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    x = stack_forward(params["blocks"], cfg, x, window=cfg.sliding_window,
                      remat=remat)
    return unembed(params, cfg, x)


# ---------------------------------------------------------------------------
# Fragment execution (the substrate operation for DNN re-alignment)
# ---------------------------------------------------------------------------

def n_fragment_units(cfg: ModelConfig) -> int:
    """Number of re-partitionable units ("layers" in Graft's sense)."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.vision.cross_attn_every
    return cfg.n_layers


def fragment_forward(params: dict, cfg: ModelConfig, hidden: Tensor,
                     start: int, end: int) -> Tensor:
    """Run blocks [start, end) on hidden states — Graft stage execution."""
    _check_family(cfg)
    return stack_forward(slice_blocks(params["blocks"], start, end), cfg,
                         hidden, window=cfg.sliding_window)


def run_fragment(params: dict, cfg: ModelConfig, inputs: Tensor,
                 start: int, end: int, *,
                 extras: Optional[dict] = None, offset: int = 0) -> Tensor:
    """Fragment execution including the embed (start==0) and head (end==L)
    boundary work — what a serving instance actually runs.

    ``extras`` carries the vlm/audio families' per-request inputs; the
    ported families take none and ignore it, as the JAX package does.
    ``offset`` is the layer ``params["blocks"]`` starts at: a pool worker
    holds only its own block range (see :func:`slice_params`)."""
    L = n_fragment_units(cfg)
    x = inputs
    if start == 0:
        x = embed_tokens(params, cfg, inputs)
    x = fragment_forward(params, cfg, x, start - offset, end - offset)
    if end == L:
        x = unembed(params, cfg, x)
    return x


def slice_params(params: dict, cfg: ModelConfig, start: int,
                 end: int) -> dict:
    """The parameters blocks ``[start, end)`` read, and nothing else: the
    blocks of that range (views), the embedding when the range starts at
    0 or its head is tied to it, the final norm and head when it ends at
    the last block. Run it with ``offset=start``."""
    L = n_fragment_units(cfg)
    out = {"blocks": slice_blocks(params["blocks"], start, end)}
    if start == 0 or (end == L and cfg.tie_embeddings):
        out["embed"] = params["embed"]
    if end == L:
        out["final_norm"] = params["final_norm"]
        if not cfg.tie_embeddings:
            out["lm_head"] = params["lm_head"]
    return out
