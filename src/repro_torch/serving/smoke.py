"""Shared scaffolding for real-execution serving runs.

The executor tests and ``chip_smoke.py`` need the same setup: a model
config, a profile book built from its analytic layer costs, initialised
parameters, and a fleet of fragments whose partition points are valid
for the layer count. Centralised here so the pieces can't drift apart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.costmodel import arch_layer_costs
from repro_torch.core.fragment import Fragment
from repro_torch.core.profiles import ProfileBook

DEFAULT_ARCH = "qwen3-1.7b"
DEFAULT_SEQ = 16


def smoke_setup(arch: str = DEFAULT_ARCH, *, seq_len: int = DEFAULT_SEQ,
                seed: int = 0, n_layers: Optional[int] = None,
                full_width: bool = False, dtype: Optional[str] = None,
                device=None):
    """-> (cfg, book, params): everything an executor needs.

    By default the reduced smoke config (2 blocks, narrow widths);
    ``n_layers`` sets the depth. ``full_width`` keeps the registry
    config's published widths instead (``n_layers`` may still cut its
    depth). ``dtype`` overrides the config's dtype. ``device`` None
    means the card, and raises when there is none."""
    from repro_torch.configs import get_config, get_smoke_config, reduced
    from repro_torch.models import init_params

    if full_width:
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
    else:
        cfg = get_smoke_config(arch)
        if n_layers is not None and n_layers != cfg.n_layers:
            cfg = reduced(get_config(arch), n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    costs = dataclasses.replace(arch_layer_costs(cfg, seq_len=seq_len),
                                name=cfg.name)
    book = ProfileBook()
    book.add(costs)
    params = init_params(cfg, seed=seed, device=device)
    return cfg, book, params


def smoke_fragments(cfg, n_clients: int = 3, *, rate: float = 30.0,
                    seed: int = 0) -> list[Fragment]:
    """A small fleet with partition points spread over the model."""
    from repro_torch.models import n_fragment_units
    rng = np.random.RandomState(seed)
    L = n_fragment_units(cfg)
    return [Fragment(cfg.name, p=int(rng.randint(0, L)),
                     t=float(40.0 + 40.0 * rng.rand()), q=rate,
                     client=f"c{i}")
            for i in range(n_clients)]


def smoke_requests(cfg, frags, *, seq_len: int = DEFAULT_SEQ,
                   seed: Optional[int] = None, rng=None) -> list:
    """[(ServeRequest, p), ...] with random token payloads per fragment."""
    from repro_torch.serving.executor import ServeRequest
    if rng is None:
        rng = np.random.RandomState(seed or 0)
    return [(ServeRequest(
        client=f.client,
        tokens=rng.randint(0, cfg.vocab_size, seq_len).astype(np.int32)),
        f.p) for f in frags]


def mixed_depth_plan(cfg, book, frags, *, s: int = 1, batch: int = 4):
    """Hand-built ExecutionPlan with REAL depth-2 chains: clients with
    p < s run an alignment stage [p, s) then the shared pool [s, L);
    clients at p == s hit the shared pool directly.

    The analytic cost book is so cheap that ``GraftPlanner`` may prefer
    solo batch-1 pools, but the runtime must be exercised on the paper's
    aligned topology regardless, so this builds the grouped plan
    explicitly.
    """
    from repro_torch.core.planner import ExecutionPlan
    from repro_torch.core.profiles import Allocation, EMPTY_ALLOC
    from repro_torch.core.repartition import GroupPlan, StagePlan
    from repro_torch.models import n_fragment_units

    prof = book[cfg.name]
    L = n_fragment_units(cfg)
    if any(f.p > s for f in frags):
        raise ValueError("clients must start at p <= s")

    def alloc(start, end, b):
        lat = float(prof.latency_ms(start, end, b, 50))
        return Allocation(share=50, batch=b, n_instances=1,
                          latency_ms=lat, throughput=b / lat * 1e3,
                          resource=50.0)

    lead = min(frags, key=lambda f: f.t)
    shared = StagePlan(lead, s, L, lead.t / 2.0, alloc(s, L, batch))
    aligns = tuple(
        StagePlan(f, f.p, s, f.t / 2.0,
                  alloc(f.p, s, batch) if f.p < s else EMPTY_ALLOC)
        for f in frags)
    gp = GroupPlan(model=cfg.name, repartition_point=s, shared=shared,
                   aligns=aligns)
    return ExecutionPlan(plans=[gp], total_resource=gp.resource,
                         n_fragments_in=len(frags),
                         n_fragments_merged=len(frags),
                         schedule_time_s=0.0)


def check_against_monolithic(cfg, params, reqs, *, atol=5e-5, rtol=1e-3):
    """Assert each served result equals the un-fragmented forward pass
    (``|got - want| <= atol + rtol * |want|`` elementwise)."""
    from repro_torch.models import forward
    dev = params["embed"].device
    for req, _p in reqs:
        toks = torch.as_tensor(np.asarray(req.tokens, np.int32),
                               device=dev)[None]
        want = forward(params, cfg, toks)[0]
        np.testing.assert_allclose(req.result.float().numpy(),
                                   want.float().cpu().numpy(),
                                   atol=atol, rtol=rtol)
