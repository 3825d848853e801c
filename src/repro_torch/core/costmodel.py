"""Analytic cost model: per-layer FLOPs / bytes / activation sizes.

Replaces Graft's *measured* GPU profiler (the paper's profiler component)
with a roofline-derived profiler for the H100 target — the scheduler only
ever consumes ``LayerCosts``, so a measured profiler (see
``core.profiles.measure_profile``) can be swapped in for reduced models
on CPU.

Two sources of LayerCosts:
  * :func:`arch_layer_costs` — derived from a ModelConfig (the 10 assigned
    archs), at transformer-block granularity (the paper's §6 argues block
    granularity is right for transformer-family models).
  * :mod:`repro_torch.core.paper_models` — synthesized tables for the paper's five
    CNN/ViT workloads (Inc/Res/VGG/Mob/ViT), calibrated against Table 2.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.config import ModelConfig

# ---------------------------------------------------------------------------
# Hardware constants: one NVIDIA H100 SXM at its full 700 W power limit
# (NVIDIA's H100 data sheet, dense rates without sparsity)
# ---------------------------------------------------------------------------

PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (tensor cores)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
ICI_BW = 450e9               # bytes/s per NVLink direction (900 GB/s total)
BYTES_PER_PARAM = 2          # bf16 serving

# Efficiency knobs for the serving cost model (matmul-shaped work doesn't
# hit peak). Not measured on the card: these keep the reference's values
# until a calibration against measured fragment times replaces them.
COMPUTE_EFF = 0.55
MEMORY_EFF = 0.75
INSTANCE_OVERHEAD_MS = 0.15  # dispatch + launch setup per batch

# Mobile devices (paper Table 1), effective throughput
MOBILE_DEVICES = {
    "nano": {"flops": 472e9, "eff": 0.25, "overhead_ms": 1.0},
    "tx2": {"flops": 1.33e12, "eff": 0.25, "overhead_ms": 0.7},
}


@dataclass(frozen=True)
class LayerCosts:
    """Per-unit ("layer" in Graft's sense) costs of one model.

    Arrays have length L+1 where index l in [0, L) is block l and the last
    entry is the head/unembed; index -0 conventions:
      flops_per_item[l]  — FLOPs to run block l for ONE request (seq included)
      weight_bytes[l]    — parameter bytes touched by block l
      act_bytes[l]       — activation bytes CROSSING the boundary l (what a
                           partition at l must transfer), l in [0, L]
      mobile_flops[l]    — FLOPs the mobile device spends on block l
    """
    name: str
    n_layers: int
    flops_per_item: np.ndarray
    weight_bytes: np.ndarray
    act_bytes: np.ndarray
    mobile_flops: np.ndarray
    input_bytes: float = 588e3           # paper: ~588KB request input
    # Optional measured/calibrated per-device mobile latencies (ms per layer,
    # length L). When present they override the mobile_flops-derived model.
    mobile_ms: Optional[dict] = None

    def __post_init__(self):
        assert len(self.flops_per_item) == self.n_layers
        assert len(self.act_bytes) == self.n_layers + 1

    def mobile_latency_ms(self, device: str, end_layer: int) -> float:
        """Latency for the mobile device to run blocks [0, end_layer)."""
        if self.mobile_ms is not None:
            return float(np.sum(self.mobile_ms[device][:end_layer]))
        spec = MOBILE_DEVICES[device]
        fl = float(self.cum_mobile_flops[end_layer])
        return (fl / (spec["flops"] * spec["eff"])) * 1e3 \
            + spec["overhead_ms"] * (end_layer > 0)

    # cumulative helpers -----------------------------------------------------
    @property
    def cum_flops(self) -> np.ndarray:
        return np.concatenate([[0.0], np.cumsum(self.flops_per_item)])

    @property
    def cum_weight_bytes(self) -> np.ndarray:
        return np.concatenate([[0.0], np.cumsum(self.weight_bytes)])

    @property
    def cum_mobile_flops(self) -> np.ndarray:
        return np.concatenate([[0.0], np.cumsum(self.mobile_flops)])


def arch_layer_costs(cfg: ModelConfig, *, seq_len: int = 512) -> LayerCosts:
    """Block-granularity LayerCosts for an assigned architecture.

    A serving request is one prefill of ``seq_len`` tokens (the hybrid-DL
    analogue of the paper's single-image request). The units are the
    model's fragment units (``models.n_fragment_units``): a vlm unit is a
    superblock of ``cross_attn_every`` self blocks and one cross block,
    so a plan's pools end at the unit the executor applies the head
    after. The reference counts vlm units as layers; the per-model sums
    of ``flops_per_item`` and ``weight_bytes`` are the same either way.
    """
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    H, KV = cfg.n_heads, max(cfg.n_kv_heads, 1)
    S = seq_len
    L = cfg.n_layers

    # per-block FLOPs for one request (2*m*n*k convention)
    if cfg.family == "ssm":
        proj = 2 * S * (4 * d * d)                     # r,k,v,g (+o below)
        proj += 2 * S * d * d                          # output proj
        wkv = 2 * S * d * hd * 2                       # state update+readout
        cmix = 2 * S * (2 * d * f + d * d)
        blk_flops = proj + wkv + cmix
        blk_weights = (5 * d * d + 2 * d * f + d * d) * BYTES_PER_PARAM
    else:
        qkvo = 2 * S * d * (H * hd + 2 * KV * hd + H * hd)
        attn_window = min(S, cfg.sliding_window) if cfg.sliding_window else S
        scores = 2 * S * attn_window * H * hd * 2      # qk^T and pv
        if cfg.moe:
            e = cfg.moe
            ff = e.d_ff_expert or f
            mlp = 2 * S * (e.top_k + e.n_shared_experts) * 3 * d * ff
            mlp_w = ((e.n_experts + e.n_shared_experts) * 3 * d * ff
                     + d * e.n_experts) * BYTES_PER_PARAM
        else:
            nmat = 3 if cfg.gated_mlp else 2
            mlp = 2 * S * nmat * d * f
            mlp_w = nmat * d * f * BYTES_PER_PARAM
        blk_flops = qkvo + scores + mlp
        attn_w = (d * H * hd + 2 * d * KV * hd + H * hd * d) * BYTES_PER_PARAM
        blk_weights = attn_w + mlp_w
        if cfg.family == "hybrid":
            s = cfg.ssm
            d_in = s.expand * d
            blk_flops += 2 * S * (2 * d * d_in + d_in * d) \
                + 2 * S * d_in * s.state_dim * 2
            blk_weights += (3 * d * d_in) * BYTES_PER_PARAM
        if cfg.vision is not None:
            # amortize one cross block per cross_attn_every self blocks
            xf = (2 * S * d * 2 * H * hd
                  + 2 * S * cfg.vision.n_image_tokens * H * hd * 2
                  + 2 * S * 3 * d * f)
            blk_flops += xf / cfg.vision.cross_attn_every
            blk_weights += (4 * d * H * hd + 3 * d * f) \
                / cfg.vision.cross_attn_every * BYTES_PER_PARAM

    if cfg.family == "vlm":
        # blk_* amortize one cross block over its E self blocks
        E = cfg.vision.cross_attn_every
        L = cfg.n_layers // E
        blk_flops, blk_weights = blk_flops * E, blk_weights * E
    flops = np.full(L, float(blk_flops))
    weights = np.full(L, float(blk_weights))
    act = np.full(L + 1, float(S * d * BYTES_PER_PARAM))
    act[0] = min(S * 4.0, 588e3)                       # token ids at the input
    # mobile runs the same math (device-side fragment)
    mobile = flops.copy()
    return LayerCosts(name=cfg.name, n_layers=L, flops_per_item=flops,
                      weight_bytes=weights, act_bytes=act,
                      mobile_flops=mobile, input_bytes=float(act[0]))
