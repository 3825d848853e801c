"""Stand-ins for every entry point on the meta device: nothing is allocated.

The port of ``repro/launch/specs.py``. ``input_specs(arch, shape)``
returns the inputs of the entry the dry-run runs, as meta tensors of the
JAX package's shapes and dtypes (``jax.ShapeDtypeStruct`` there),
covering all three entries:

  train_4k            -> train_step(params, opt_state, batch[, extras])
  prefill_32k         -> prefill(params, tokens[, extras])
  decode_* / long_*   -> decode_step(params, cache, tokens)

``entry_fn`` returns the function itself, which runs on whatever device
its inputs lie on: on meta it computes shapes only (``launch/dryrun.py``
counts its ops there), on the card it is the workload
(``chip_smoke.py``'s launch phase).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.config import ModelConfig, ShapeConfig, shape_for
from repro_torch.configs import SHAPES, get_config
from repro_torch.models import init_params
from repro_torch.models.decode import decode_step, init_cache, prefill
from repro_torch.models.stubs import extras_shapes
from repro_torch.training import init_opt_state, make_train_step

META = torch.device("meta")


def params_specs(cfg: ModelConfig, *, device=META) -> dict:
    """The parameter tree of ``cfg``; on meta, shapes and dtypes only."""
    return init_params(cfg, device=device)


def input_specs(arch: str, shape_name, *, kv_cache_dtype: str = "",
                batch: int = 0, device=META) -> dict:
    """Every entry input for (arch, workload shape): {"cfg", "params",
    "extras", and "opt_state" + "batch" (train), "tokens" (prefill) or
    "tokens" + "cache" (decode)}. ``shape_name`` is a name from
    ``SHAPES`` or a ``ShapeConfig``; ``batch`` > 0 cuts the shape's
    global batch; ``device`` meta allocates nothing (elsewhere the
    tensors are zeros, the parameters a seeded draw)."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    if batch:
        shape = dataclasses.replace(shape, global_batch=batch)
    cfg = shape_for(get_config(arch), shape)
    if kv_cache_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    B, S = shape.global_batch, shape.seq_len
    params = params_specs(cfg, device=device)
    ex = {name: torch.zeros(sh, dtype=dt, device=device)
          for name, (sh, dt) in extras_shapes(cfg, B).items()} or None
    out = {"cfg": cfg, "params": params, "extras": ex}

    def tokens(n: int) -> torch.Tensor:
        return torch.zeros((B, n), dtype=torch.int32, device=device)

    if shape.kind == "train":
        out["opt_state"] = init_opt_state(params)
        out["batch"] = {"tokens": tokens(S), "labels": tokens(S)}
    elif shape.kind == "prefill":
        out["tokens"] = tokens(S)
    else:                                    # decode: ONE token + cache(S)
        out["tokens"] = tokens(1)
        out["cache"] = init_cache(cfg, B, S, device=device)
    return out


def entry_fn(cfg: ModelConfig, shape: ShapeConfig, *, train_remat=True,
             ce_impl: str = "onehot", microbatches: int = 1):
    """The function the dry-run runs for this workload kind."""
    if shape.kind == "train":
        step = make_train_step(cfg, remat=train_remat, ce_impl=ce_impl,
                               microbatches=microbatches)

        def train_entry(params, opt_state, batch, extras=None):
            return step(params, opt_state, batch, extras=extras)
        return train_entry

    if shape.kind == "prefill":
        def prefill_entry(params, tokens, extras=None):
            return prefill(params, cfg, tokens, extras=extras)
        return prefill_entry

    def serve_entry(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)
    return serve_entry
