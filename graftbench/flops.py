"""Frozen work counts and the H100's published peaks.

FLOPs follow the 2*m*n*k convention. Work is counted from what the
inputs need: real tokens, valid (causal) pairs and valid cache slots,
never padding or the most a call could do. A kernel's bytes count each
input read once and each output written once. Kept beside the harness so
that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def dims(cfg) -> dict:
    moe = cfg.moe
    return {"d": cfg.d_model, "H": cfg.n_heads, "KV": cfg.n_kv_heads,
            "hd": cfg.head_dim_, "f": cfg.d_ff, "V": cfg.vocab_size,
            "E": moe.n_experts if moe else 0,
            "k": moe.top_k if moe else 0,
            "fe": (moe.d_ff_expert or cfg.d_ff) if moe else 0}


def layer_token_flops(cfg) -> float:
    """One token through one block, without attention's pair products:
    the four projections and the MLP (a moe layer: the router and its
    top-k experts)."""
    m = dims(cfg)
    d, H, KV, hd = m["d"], m["H"], m["KV"], m["hd"]
    proj = 2 * d * (2 * H * hd + 2 * KV * hd)
    if m["E"]:
        mlp = 2 * d * m["E"] + m["k"] * 3 * 2 * d * m["fe"]
    else:
        mlp = 3 * 2 * d * m["f"]
    return float(proj + mlp)


def pair_flops(cfg, pairs: float) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, every head."""
    m = dims(cfg)
    return 4.0 * m["H"] * m["hd"] * pairs


def head_flops(cfg, tokens: float) -> float:
    m = dims(cfg)
    return 2.0 * m["d"] * m["V"] * tokens


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def prefill_flops(cfg, n_tokens: int, layers: int, head: bool) -> float:
    """One causal prompt of ``n_tokens`` through ``layers`` blocks, plus
    the head over every position when ``head``."""
    f = layers * (n_tokens * layer_token_flops(cfg)
                  + pair_flops(cfg, causal_pairs(n_tokens)))
    return f + (head_flops(cfg, n_tokens) if head else 0.0)


def attention_prefill_work(cfg, n_tokens: int, layers: int) -> tuple:
    """(FLOPs, bytes) of the flash-attention kernel for one causal
    prompt over ``layers`` blocks: q, k, v read and o written once."""
    m = dims(cfg)
    flops = layers * pair_flops(cfg, causal_pairs(n_tokens))
    nbytes = layers * n_tokens * (2 * m["H"] + 2 * m["KV"]) * m["hd"] * BF16
    return flops, float(nbytes)


def decode_step_flops(cfg, valid_slots: int) -> float:
    """One decode row: every block at one token attending ``valid_slots``
    cache slots, and the head."""
    return cfg.n_layers * (layer_token_flops(cfg)
                           + pair_flops(cfg, valid_slots)) \
        + head_flops(cfg, 1)


def attention_decode_work(cfg, valid_slots: int) -> tuple:
    """(FLOPs, bytes) of the decode-attention kernel for one row over
    every block: the valid k and v slots read once, q read and o
    written."""
    m = dims(cfg)
    flops = cfg.n_layers * pair_flops(cfg, valid_slots)
    nbytes = cfg.n_layers * (2 * m["KV"] * m["hd"] * valid_slots
                             + 2 * m["H"] * m["hd"]) * BF16
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float) -> tuple:
    """(seconds, bound) of the roofline: the larger of compute and
    memory time at the published peaks."""
    tc, tm = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (tc, "flops") if tc >= tm else (tm, "bytes")
