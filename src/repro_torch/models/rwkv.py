"""RWKV6 (Finch) blocks: time-mix with data-dependent decay + channel-mix.

Faithful to arXiv:2404.05892 at block level: token-shift interpolation,
LoRA-parameterised per-channel decay w_t = exp(-exp(w0 + tanh(x Wa) Wb)),
bonus u, per-head output group-norm, squared-ReLU receptance-gated
channel-mix. The WKV recurrence runs through the Hopper kernel
``kernels/wkv6_scan.py`` on the card (its chunked plain version on the
CPU) for a whole sequence, and the plain O(1) ``ops.wkv6_step`` in
decode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_head_norm, torch_dtype

Tensor = torch.Tensor


def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv.head_dim
    assert cfg.d_model % hd == 0
    return cfg.d_model // hd, hd


def init_time_mix(gen: torch.Generator, cfg: ModelConfig,
                  lead: tuple = ()) -> dict:
    """Random time-mix weights; ``lead`` stacks layers, as JAX's vmap."""
    d = cfg.d_model
    H, hd = rwkv_dims(cfg)
    r = cfg.rwkv
    dt = torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=gen.device)
    mix = lambda: torch.full((*lead, d), 0.5, **f32)       # noqa: E731
    return {
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(),
        "mu_w": mix(), "mu_g": mix(),
        "w_r": dense_init(gen, d, d, dt, lead),
        "w_k": dense_init(gen, d, d, dt, lead),
        "w_v": dense_init(gen, d, d, dt, lead),
        "w_g": dense_init(gen, d, d, dt, lead),
        "w_o": dense_init(gen, d, d, dt, lead),
        "w0": torch.full((*lead, d), -1.0, **f32),          # base decay
        "wa": dense_init(gen, d, r.decay_lora, dt, lead),
        "wb": (torch.randn((*lead, r.decay_lora, d), generator=gen, **f32)
               * 0.01).to(dt),
        "u": torch.randn((*lead, H, hd), generator=gen, **f32) * 0.1,
        "ln_x": torch.ones((*lead, hd), **f32),
    }


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                     lead: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "mu_k": torch.full((*lead, d), 0.5, **f32),
        "mu_r": torch.full((*lead, d), 0.5, **f32),
        "w_up": dense_init(gen, d, f, dt, lead),
        "w_down": dense_init(gen, f, d, dt, lead),
        "w_r": dense_init(gen, d, d, dt, lead),
    }


def _shift(x: Tensor, carry: Optional[Tensor]) -> Tensor:
    """Token shift: x_{t-1}; carry (B,1,d) is the last token of the previous
    segment (zeros at sequence start)."""
    if carry is None:
        carry = torch.zeros_like(x[:, :1])
    return torch.cat([carry, x[:, :-1]], dim=1)


def _mix(x: Tensor, xs: Tensor, mu: Tensor) -> Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _time_mix_inputs(p: dict, cfg: ModelConfig, x: Tensor, xs: Tensor):
    H, hd = rwkv_dims(cfg)
    r = _mix(x, xs, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xs, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xs, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, xs, p["mu_g"]) @ p["w_g"])
    xw = _mix(x, xs, p["mu_w"])
    dec = p["w0"] + torch.tanh(xw @ p["wa"]) @ p["wb"]
    w = torch.exp(-torch.exp(dec.float()))                 # (B,S,d) in (0,1)
    return (*(spmd.split_last(t, (H, hd)) for t in (r, k, v, w)), g)


def time_mix_forward(p: dict, cfg: ModelConfig, x: Tensor,
                     shift_carry: Optional[Tensor] = None,
                     wkv_state: Optional[Tensor] = None,
                     ) -> tuple[Tensor, Tensor, Tensor]:
    """Full-seq time-mix. Returns (y, new_shift_carry, new_wkv_state)."""
    B = x.shape[0]
    H, hd = rwkv_dims(cfg)
    xs = _shift(x, shift_carry)
    r, k, v, w, g = _time_mix_inputs(p, cfg, x, xs)
    if wkv_state is None:
        wkv_state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                device=x.device)
    o, wkv_state = ops.wkv6(r, k, v, w, p["u"], wkv_state)
    o = spmd.merge_last(rms_head_norm(p["ln_x"], o))
    y = (o * g) @ p["w_o"]
    return y, x[:, -1:], wkv_state


def time_mix_decode(p: dict, cfg: ModelConfig, x: Tensor,
                    shift_carry: Tensor, wkv_state: Tensor
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """One-token time-mix. x (B,1,d)."""
    r, k, v, w, g = _time_mix_inputs(p, cfg, x, shift_carry)
    o, wkv_state = ops.wkv6_step(r, k, v, w, p["u"], wkv_state)
    o = spmd.merge_last(rms_head_norm(p["ln_x"], o))
    y = (o * g) @ p["w_o"]
    return y, x, wkv_state


def channel_mix(p: dict, cfg: ModelConfig, x: Tensor,
                shift_carry: Optional[Tensor] = None
                ) -> tuple[Tensor, Tensor]:
    """Squared-ReLU channel mix with receptance gate."""
    xs = _shift(x, shift_carry)
    k = _mix(x, xs, p["mu_k"]) @ p["w_up"]
    k = torch.square(F.relu(k))
    r = torch.sigmoid(_mix(x, xs, p["mu_r"]) @ p["w_r"])
    return r * (k @ p["w_down"]), x[:, -1:]
