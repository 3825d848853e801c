"""AdamW on nested dicts of tensors (the port of ``repro/training/optimizer.py``).

Moments are kept in fp32 whatever the parameter dtype (the mixed-precision
convention), the global gradient norm is clipped, and the update is cast
back to the parameter dtype. Not ``torch.optim.AdamW``: that keeps bf16
moments for bf16 parameters and does no clipping.

Functional, as in the JAX package: :func:`adamw_update` returns new
parameter and moment trees and leaves its arguments untouched. Every
step stays on the device (the step count is a device scalar), so an
update never waits on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree: dict) -> list:
    """Leaves in insertion order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def init_opt_state(params: dict) -> dict:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,   # noqa: E731
                                device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(params: dict, grads: dict, state: dict,
                 cfg: AdamWConfig = AdamWConfig()
                 ) -> tuple[dict, dict, dict]:
    """-> (new params, new state, {"grad_norm"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                           "step": step}, {"grad_norm": gnorm}


def _pick(tree: dict, i: int) -> dict:
    """The i-th member of each tuple leaf of ``tree``."""
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
