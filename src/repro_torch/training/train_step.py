"""Training step: causal-LM loss + AdamW, remat per block (the port of
``repro/training/train_step.py``).

Supports the paper's §6 "split training" direction: the same fragment
boundaries used for inference re-alignment are valid recomputation
boundaries here (remat is applied per block). Gradients come from
``torch.autograd.grad`` over the parameter leaves; on the card the
attention's backward is the two FA-2 backward kernels
(``kernels/flash_attention_bwd.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.models.transformer import Remat, forward
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, tree_leaves,
                                            tree_map)

Tensor = torch.Tensor

CE_IMPLS = ("onehot", "gather")


def lm_loss(params: dict, cfg: ModelConfig, tokens: Tensor, labels: Tensor,
            *, extras: Optional[dict] = None, remat: Remat = True,
            ce_impl: str = "onehot") -> tuple[Tensor, dict]:
    """Mean next-token cross entropy -> (loss, {"ce", "moe_aux"}).

    Both ``ce_impl`` values compute the same cross entropy with one
    gather of the label logits. In the JAX package "onehot" is a layout
    device for vocab-sharded logits under GSPMD (it avoids gathering the
    (B, S, V) logits across devices); one card has nothing to gather, and
    a materialised one-hot would cost a (B, S, V) tensor. ``moe_aux`` is
    the forward's router load-balance loss (0 without a router), added
    at ``router_aux_weight``; ``extras`` is the vlm/audio families'
    input to the forward (stub image or frame embeddings)."""
    if ce_impl not in CE_IMPLS:
        raise ValueError(f"ce_impl {ce_impl!r} not in {CE_IMPLS}")
    logits, moe_aux = forward(params, cfg, tokens, extras=extras,
                              remat=remat)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # a vocab-sharded DTensor's gather is a masked partial sum, which
    # DTensor cannot index before the sum is done (spmd.reduced)
    tgt = spmd.reduced(torch.gather(logits, -1, labels.long()[..., None]))
    tgt = tgt[..., 0]
    ce = (logz - tgt).mean()
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + aux_w * moe_aux, {"ce": ce, "moe_aux": moe_aux}


def loss_and_grads(params: dict, cfg: ModelConfig, tokens: Tensor,
                   labels: Tensor, *, extras: Optional[dict] = None,
                   remat: Remat = True, ce_impl: str = "onehot"
                   ) -> tuple[Tensor, dict, dict]:
    """-> (loss, {"ce", "moe_aux"}, grads): :func:`lm_loss` and its
    gradients (``torch.autograd.grad``) with respect to every leaf of
    ``params``, in the params' nesting. The caller's tensors are not
    touched: the loss is taken over detached leaves that share their
    storage."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, parts = lm_loss(live, cfg, tokens, labels, extras=extras,
                          remat=remat, ce_impl=ce_impl)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True))

    def grad(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
        tree_map(grad, live)


def _device_batch(batch: Optional[dict], device) -> Optional[dict]:
    """``batch``'s arrays or tensors as tensors on ``device`` (None
    stays None)."""
    if batch is None:
        return None
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, Tensor)
                               else v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    *, remat: Remat = True, ce_impl: str = "onehot",
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch[, extras]) ->
    (params, opt_state, metrics), metrics {"loss", "ce", "moe_aux",
    "grad_norm"} as device scalars. ``batch`` holds "tokens" and "labels"
    (B, S) as numpy arrays or tensors; ``extras`` the vlm/audio inputs
    (B, ...), moved to the params' device like the batch.

    microbatches > 1 = gradient accumulation: the batch and its extras
    are processed in ``microbatches`` sequential slices along the batch,
    each slice's fp32 gradients divided by k and summed; total FLOPs
    unchanged.
    """

    def grads_of(params, tokens, labels, extras):
        return loss_and_grads(params, cfg, tokens, labels, extras=extras,
                              remat=remat, ce_impl=ce_impl)

    def train_step(params, opt_state, batch, extras=None):
        dev = tree_leaves(params)[0].device
        b = _device_batch(batch, dev)
        extras = _device_batch(extras, dev)
        if microbatches <= 1:
            loss, parts, grads = grads_of(params, b["tokens"], b["labels"],
                                          extras)
        else:
            k = microbatches
            B = b["tokens"].shape[0]
            if B % k:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"microbatches {k}")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            moe_aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(k):
                sl = slice(i * B // k, (i + 1) * B // k)
                ex = {n: x[sl] for n, x in extras.items()} if extras \
                    else None
                lo, pa, g = grads_of(params, b["tokens"][sl],
                                     b["labels"][sl], ex)
                grads = tree_map(lambda a, gi: a + gi.float() / k, grads, g)
                loss = loss + lo / k
                moe_aux = moe_aux + pa["moe_aux"] / k
            parts = {"ce": loss, "moe_aux": moe_aux}
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **parts, **opt_metrics}

    return train_step


__all__ = ["lm_loss", "loss_and_grads", "make_train_step",
           "init_opt_state", "AdamWConfig"]
