"""Mamba2-style selective-SSM branch used by hymba's hybrid blocks.

x -> in_proj -> [x_inner | z gate]; causal depthwise conv on x_inner;
per-head scalar-decay selective scan (the Hopper kernel
``kernels/ssm_scan.py`` on the card, its chunked plain version on the
CPU); gated output projection. Decode keeps a (conv tail, scan state)
pair and steps it with the plain ``ops.ssm_step``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, torch_dtype

Tensor = torch.Tensor


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, n_heads, head_dim) for the SSM branch."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    hd = 64 if d_inner % 64 == 0 else max(
        8, d_inner // max(1, d_inner // 64))
    while d_inner % hd:
        hd //= 2
    n_heads = s.n_heads or d_inner // hd
    return d_inner, n_heads, d_inner // n_heads


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             lead: tuple = ()) -> dict:
    """Random SSM-branch weights; ``lead`` stacks layers, as JAX's vmap."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, hd = ssm_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv = torch.randn((*lead, s.conv_width, d_in), generator=gen, **f32) \
        / math.sqrt(s.conv_width)
    A_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "w_in": dense_init(gen, d, 2 * d_in, dt, lead),
        "conv": conv.to(dt),
        "w_dt": dense_init(gen, d_in, H, dt, lead),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "A_log": A_log.expand(*lead, H).contiguous(),
        "w_B": dense_init(gen, d_in, s.state_dim, dt, lead),
        "w_C": dense_init(gen, d_in, s.state_dim, dt, lead),
        "w_out": dense_init(gen, d_in, d, dt, lead),
    }


def _causal_conv(x: Tensor, w: Tensor, tail: Optional[Tensor] = None
                 ) -> Tensor:
    """Depthwise causal conv. x (B,S,C), w (cw,C), tail (B,cw-1,C) or None."""
    cw = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, *, device,
                   n_layers: Optional[int] = None) -> dict:
    L = n_layers if n_layers is not None else cfg.n_layers
    d_in, H, hd = ssm_dims(cfg)
    return {
        "conv": torch.zeros((L, batch, cfg.ssm.conv_width - 1, d_in),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "scan": torch.zeros((L, batch, H, hd, cfg.ssm.state_dim),
                            dtype=torch.float32, device=device),
    }


def _split_project(p: dict, cfg: ModelConfig, x: Tensor):
    d_in, H, hd = ssm_dims(cfg)
    xz = x @ p["w_in"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    return xi, z, (d_in, H, hd)


def _post(p: dict, y: Tensor, z: Tensor, B: int, S: int) -> Tensor:
    y = y.reshape(B, S, -1) * F.silu(z)
    return y @ p["w_out"]


def _scan_inputs(p: dict, xc: Tensor):
    """dt (fp32: the bias promotes the product), A, Bm, Cm."""
    dt = F.softplus(xc @ p["w_dt"] + p["dt_bias"])         # (B,S,H)
    A = -torch.exp(p["A_log"])
    return dt, A, xc @ p["w_B"], xc @ p["w_C"]


def ssm_forward_with_state(p: dict, cfg: ModelConfig, x: Tensor
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """Full-sequence SSM branch returning decode state.

    Returns (y (B,S,d), conv_tail (B,cw-1,d_in), scan_state (B,H,hd,N))."""
    B, S, _ = x.shape
    xi, z, (d_in, H, hd) = _split_project(p, cfg, x)
    xc = F.silu(_causal_conv(xi, p["conv"]))
    dt, A, Bm, Cm = _scan_inputs(p, xc)
    xh = xc.reshape(B, S, H, hd)
    state = torch.zeros((B, H, hd, cfg.ssm.state_dim), dtype=torch.float32,
                        device=x.device)
    y, state = ops.ssm(xh, dt, A, Bm, Cm, state)
    cw = cfg.ssm.conv_width
    tail = xi[:, S - (cw - 1):] if S >= cw - 1 else torch.cat(
        [xi.new_zeros((B, cw - 1 - S, d_in)), xi], dim=1)
    return _post(p, y, z, B, S), tail, state


def ssm_forward(p: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    """Full-sequence SSM branch. x (B,S,d) -> (B,S,d)."""
    return ssm_forward_with_state(p, cfg, x)[0]


def ssm_decode(p: dict, cfg: ModelConfig, x: Tensor,
               conv_tail: Tensor, scan_state: Tensor
               ) -> tuple[Tensor, Tensor, Tensor]:
    """One-token SSM step. x (B,1,d); conv_tail (B,cw-1,d_in);
    scan_state (B,H,hd,N). Returns (y (B,1,d), conv_tail', scan_state')
    as new tensors: the caller writes them into its cache."""
    B = x.shape[0]
    xi, z, (d_in, H, hd) = _split_project(p, cfg, x)
    xc = F.silu(_causal_conv(xi, p["conv"], tail=conv_tail))
    new_tail = torch.cat([conv_tail[:, 1:], xi], dim=1)
    dt, A, Bm, Cm = _scan_inputs(p, xc)
    xh = xc.reshape(B, 1, H, hd)
    y, scan_state = ops.ssm_step(xh, dt, A, Bm, Cm, scan_state)
    return _post(p, y, z, B, 1), new_tail, scan_state
