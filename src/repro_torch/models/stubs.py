"""Modality-frontend stubs (the one sanctioned carve-out).

As in the JAX package (``repro/models/stubs.py``), the vision encoder
and the audio conv/mel frontend are not implemented: stand-ins deliver
precomputed patch or frame embeddings of the right shape, and these
helpers draw random-but-deterministic ones for smokes and examples. The
port draws from an explicit ``torch.Generator``; it cannot reproduce
``jax.random``'s numbers, so parity tests feed both packages the JAX
stub's arrays.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import resolve_device


def extras_shapes(cfg: ModelConfig, batch: int) -> dict:
    """{name: (shape, dtype)} of the stub-frontend inputs that
    ``forward`` and ``prefill`` read; {} for the text-only families.
    (Served audio fragments read the encoder's ``memory`` of them.)"""
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        return {"images": ((batch, cfg.vision.n_image_tokens, cfg.d_model),
                           dt)}
    if cfg.family == "audio":
        return {"frames": ((batch, cfg.audio.n_audio_frames, cfg.d_model),
                           dt)}
    return {}


def make_extras(cfg: ModelConfig, batch: int,
                generator: Optional[torch.Generator] = None, *,
                device=None) -> dict:
    """Standard-normal embeddings x 0.02 in ``cfg.dtype`` on ``device``
    (None = the card), drawn from ``generator`` (None: a fresh one seeded
    0 on that device)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (shape, dt) in extras_shapes(cfg, batch).items():
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02
        out[name] = x.to(device=dev, dtype=dt)
    return out
