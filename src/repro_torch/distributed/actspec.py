"""Residual-stream sharding constraints (hooks a model may call).

The port of ``repro/distributed/actspec.py``. The JAX models anchor the
residual stream's batch dim after every block, because GSPMD's
propagation can drop batch sharding inside deep layer scans. The hooks
are thread-local and do nothing unless a spec is installed; with one
installed, :func:`constrain` and :func:`constrain_batch` return a plain
tensor as it is and ``redistribute`` a DTensor onto the spec.

A spec is a tuple with an entry per tensor dim (``distributed/sharding.py``):
None is whole, an axis name or a tuple of names splits the dim over
them, and :data:`UNCONSTRAINED` leaves the dim as the tensor has it
(``P.UNCONSTRAINED`` in JAX). The port's models call them where the JAX
models do: :func:`constrain_batch` on q, k and v in
``models/attention.py::attn_forward``, :func:`constrain` on the residual
after every block of ``transformer.py``'s ``stack_forward`` and
``vlm_stack_forward`` and after every layer of ``decode.py::prefill``
(its non-vlm stacks, as JAX's). Their tensors are plain on one card and
under expert parallelism (tokens whole on every rank), so there every
hook returns the object it was given.

The MoE mesh hook (:func:`moe_mesh`) takes a ``DeviceMesh`` with a
``model`` dim, over which ``models/moe.py``'s ``expert_parallel``
dispatch shards the experts.
"""
from __future__ import annotations

import contextlib
import threading

import torch

UNCONSTRAINED = "unconstrained"

_state = threading.local()


def set_residual_spec(spec) -> None:
    """spec: a tuple as above, or None to disable."""
    _state.spec = spec


def get_residual_spec():
    return getattr(_state, "spec", None)


@contextlib.contextmanager
def residual_spec(spec):
    prev = get_residual_spec()
    set_residual_spec(spec)
    try:
        yield
    finally:
        set_residual_spec(prev)


def _redistribute(x, spec: tuple):
    """A DTensor ``x`` redistributed onto ``spec``; the mesh dims that
    only UNCONSTRAINED dims use keep their placement."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(x.device_mesh.mesh_dim_names or ())
    fixed = {d for d, e in enumerate(spec) if e != UNCONSTRAINED}
    out = [Replicate() if isinstance(p, Shard) and p.dim in fixed else p
           for p in x.placements]
    for d in fixed:
        entry = spec[d]
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return x.redistribute(x.device_mesh, tuple(out))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor) -> torch.Tensor:
    """Apply the installed constraint to a (B, S, d) residual tensor."""
    spec = get_residual_spec()
    if spec is None or x.ndim != 3 or not _is_dtensor(x):
        return x
    return _redistribute(x, tuple(spec))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Anchor ONLY the leading batch dim of an arbitrary-rank tensor (the
    head-split q/k/v inside attention)."""
    spec = get_residual_spec()
    if spec is None or x.ndim < 2 or not _is_dtensor(x):
        return x
    return _redistribute(x, (tuple(spec)[0],)
                         + (UNCONSTRAINED,) * (x.ndim - 1))


def captured():
    """This thread's hooks (the residual spec and the MoE mesh), as a
    context-manager factory: entering what it returns installs them on
    whichever thread enters it. The hooks are thread-local, and autograd
    runs a CUDA graph's backward, and so a checkpointed block's
    recompute (``models/transformer.py``'s remat), on a device thread of
    its own, where they are unset; the stacks enter this around every
    block, so the recompute sees what the forward saw."""
    spec, mesh = get_residual_spec(), get_moe_mesh()

    @contextlib.contextmanager
    def install():
        with residual_spec(spec), moe_mesh(mesh):
            yield
    return install


# ---------------------------------------------------------------------------
# Mesh hook for expert-parallel layers (models/moe.py)
# ---------------------------------------------------------------------------

def set_moe_mesh(mesh) -> None:
    _state.moe_mesh = mesh


def get_moe_mesh():
    return getattr(_state, "moe_mesh", None)


@contextlib.contextmanager
def moe_mesh(mesh):
    prev = get_moe_mesh()
    set_moe_mesh(mesh)
    try:
        yield
    finally:
        set_moe_mesh(prev)
