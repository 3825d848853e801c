"""Configuration system for repro_torch.

Two config families:
  * ModelConfig  — architecture hyper-parameters (one per assigned arch).
  * ShapeConfig  — workload input shapes (train_4k / prefill_32k / decode_32k /
                   long_500k).

Configs are plain frozen dataclasses; the registry in ``repro_torch.configs`` maps
``--arch`` ids to ModelConfig instances and provides reduced smoke variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    n_shared_experts: int = 0          # llama4 has a shared expert
    capacity_factor: float = 1.25       # dispatch capacity for dense-dispatch impl
    router_aux_weight: float = 0.01     # load-balance loss weight (training)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16                 # per-head recurrent state size
    conv_width: int = 4                 # local conv before the scan
    expand: int = 2                     # d_inner = expand * d_model (mamba-style)
    n_heads: int = 0                    # ssm heads (0 -> derive from d_inner/64)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64                  # rwkv6 head size
    decay_lora: int = 64                # rank of the data-dependent decay LoRA
    gate_lora: int = 32


@dataclass(frozen=True)
class VisionConfig:
    """VLM frontend STUB parameters (per assignment: frontend not implemented)."""
    n_image_tokens: int = 1601          # llama-3.2-vision tile tokens
    cross_attn_every: int = 5           # a cross-attn block every N layers
    image_dim: int = 0                  # embedding dim delivered by the stub (0 -> d_model)


@dataclass(frozen=True)
class AudioConfig:
    """Whisper-style enc-dec; conv frontend is a STUB delivering frame embeddings."""
    n_audio_frames: int = 1500
    n_encoder_layers: int = 6


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    # attention flavour
    qk_norm: bool = False               # qwen3
    attn_bias: bool = False             # qwen2 QKV bias
    rope_theta: float = 10_000.0
    sliding_window: int = 0             # 0 = full attention; >0 = window size
    # norm flavour
    nonparametric_ln: bool = False      # olmo-1b: LN without learnable params
    rmsnorm: bool = True                # rmsnorm (default) vs layernorm
    # mlp flavour
    gated_mlp: bool = True              # swiglu (default) vs plain gelu mlp
    mlp_bias: bool = False
    tie_embeddings: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    # numerics
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""            # "" = dtype; "int8" = quantized cache
                                        # (absmax per (pos, kv-head); beyond-
                                        # paper §Perf optimization)
    moe_impl: str = "grouped"           # grouped | dense | expert_parallel
    # provenance (citation for the assigned config)
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch natively supports O(1)/O(w) decode state growth."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim_
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":                      # rwkv6: time-mix + channel-mix
            per_layer = 4 * d * d + 3 * d * f // 1    # r,k,v,o + channel mix (approx; k->f)
            per_layer = 4 * d * d + 2 * d * f
        else:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            attn = q + kv + o
            if self.moe:
                e = self.moe
                ff_e = e.d_ff_expert or f
                mlp = (e.n_experts + e.n_shared_experts) * (3 if self.gated_mlp else 2) * d * ff_e
                mlp += d * e.n_experts                # router
            else:
                mlp = (3 if self.gated_mlp else 2) * d * f
            per_layer = attn + mlp
            if self.ssm is not None:                  # hybrid: add ssm branch
                s = self.ssm
                d_in = s.expand * d
                per_layer += 2 * d * d_in + d_in * d + d_in * (2 * s.state_dim)
            if self.vision is not None:
                # cross-attn layers every N: amortized per layer
                per_layer += attn // self.vision.cross_attn_every
        blocks = L * per_layer
        if self.audio is not None:
            blocks += self.audio.n_encoder_layers * per_layer
        return emb + blocks

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.n_params()
        e = self.moe
        d, f, L = self.d_model, self.d_ff, self.n_layers
        ff_e = e.d_ff_expert or f
        per_tok_mlp = (e.top_k + e.n_shared_experts) * (3 if self.gated_mlp else 2) * d * ff_e
        all_mlp = (e.n_experts + e.n_shared_experts) * (3 if self.gated_mlp else 2) * d * ff_e
        return self.n_params() - L * (all_mlp - per_tok_mlp)

    def validate(self) -> "ModelConfig":
        assert self.family in FAMILIES, self.family
        if self.family != "ssm":
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
                f"{self.name}: n_heads {self.n_heads} not divisible by kv {self.n_kv_heads}")
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "hybrid":
            assert self.ssm is not None
        if self.family == "vlm":
            assert self.vision is not None
        if self.family == "audio":
            assert self.audio is not None
        return self


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests.

    Keeps the architectural *shape* (GQA ratio, MoE top-k, ssm state, ...) while
    shrinking dims: ≤2 layers, d_model ≤ 512, ≤4 experts.
    """
    d_model = min(d_model, 512)
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = n_kv * min(ratio, 4)
    head_dim = max(16, d_model // max(n_heads, 1) // 2)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_model * 2,
        vocab_size=vocab,
        rope_theta=cfg.rope_theta,
        dtype="float32",
    )
    if cfg.moe:
        # capacity_factor high enough to be dropless at smoke scale so
        # prefill/forward agree exactly (capacity drops are N-dependent)
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
                            d_ff_expert=d_model, capacity_factor=4.0)
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, state_dim=min(cfg.ssm.state_dim, 8), n_heads=0)
    if cfg.rwkv:
        kw["rwkv"] = replace(cfg.rwkv, head_dim=32, decay_lora=16, gate_lora=8)
    if cfg.vision:
        # 4 layers / cross every 2 -> 2 superblocks, so fragment-composition
        # tests can split the stack at superblock granularity
        kw["vision"] = replace(cfg.vision, n_image_tokens=17, cross_attn_every=2)
        kw["n_layers"] = 4
    if cfg.audio:
        kw["audio"] = replace(cfg.audio, n_audio_frames=16, n_encoder_layers=2)
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    return replace(cfg, **kw).validate()


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # "train" | "prefill" | "decode"
    # decode shapes: the KV/state cache length is seq_len; the step feeds 1 token.
    sliding_window_override: int = 0    # force sliding-window attn for full-attn archs


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode", sliding_window_override=4096)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_for(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Apply per-shape config overrides (e.g. sliding window for long_500k)."""
    if shape.sliding_window_override and not cfg.sub_quadratic and cfg.family != "ssm":
        return replace(cfg, sliding_window=shape.sliding_window_override)
    return cfg
