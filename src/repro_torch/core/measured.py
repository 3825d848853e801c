"""Measured profiler: build LayerCosts by TIMING a real model.

The paper's profiler measures latency/throughput per (batch, share) on
GPUs; here each block's ``fragment_forward`` is timed on the params'
device and the two-parameter latency model the scheduler consumes is
fitted:

    lat_l(b) ~ alpha_l + beta_l * b
    => weight_bytes_l = alpha_l * C_m,   flops_l = beta_l * C_f

so a measured profile plugs into exactly the same PerfProfile machinery
as the analytic one (shares rescale both terms, as MPS does). On the
card a block is timed between two ``torch.cuda.Event`` records after a
warm-up call; on the CPU with ``time.perf_counter``. ``C_f`` and ``C_m``
are the cost model's rates (``core/costmodel.py``): this module only
measures, and changes none of them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.costmodel import (LayerCosts, PEAK_FLOPS, HBM_BW,
                                        COMPUTE_EFF, MEMORY_EFF,
                                        BYTES_PER_PARAM)
from repro_torch.models import embed_tokens, fragment_forward, n_fragment_units


def _time_call(fn, *, reps: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` after one warm-up call."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measure_layer_costs(cfg: ModelConfig, params, *, seq_len: int = 16,
                        batches=(1, 4), reps: int = 3,
                        mobile_slowdown: float = 200.0) -> LayerCosts:
    """Time per-block execution of ``cfg`` on ``params``' device; return
    LayerCosts.

    mobile_slowdown scales server-measured latency into the synthetic
    mobile-device model (a Nano is ~O(100x) slower than a server chip).
    """
    L = n_fragment_units(cfg)
    dev = params["embed"].device
    rng = np.random.RandomState(0)
    lat = np.zeros((len(batches), L))
    with torch.no_grad():
        for bi, b in enumerate(batches):
            toks = rng.randint(0, cfg.vocab_size, (b, seq_len)).astype(
                np.int32)
            h = embed_tokens(params, cfg, torch.from_numpy(toks).to(dev))
            for l in range(L):
                lat[bi, l] = _time_call(
                    lambda: fragment_forward(params, cfg, h, l, l + 1),
                    reps=reps, device=dev)
    b0, b1 = batches[0], batches[-1]
    beta = np.maximum((lat[-1] - lat[0]) / max(b1 - b0, 1), 1e-9)
    alpha = np.maximum(lat[0] - beta * b0, 1e-9)
    flops = beta * PEAK_FLOPS * COMPUTE_EFF
    weights = alpha * HBM_BW * MEMORY_EFF
    act = np.full(L + 1, float(seq_len * cfg.d_model * BYTES_PER_PARAM))
    act[0] = seq_len * 4.0
    mobile = flops * mobile_slowdown
    return LayerCosts(name=cfg.name, n_layers=L, flops_per_item=flops,
                      weight_bytes=weights, act_bytes=act,
                      mobile_flops=mobile, input_bytes=float(act[0]))
