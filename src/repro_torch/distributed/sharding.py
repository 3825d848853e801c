"""Sharding rules for every (architecture x workload shape).

The port of ``repro/distributed/sharding.py``: the same rules, the same
policy knobs, the same divisibility fit, over a :class:`MeshShape`
(``launch/mesh.py``). A spec is a tuple with one entry per tensor
dimension: None (whole), one mesh axis name, or a tuple of several
(that dimension split over their product). Baseline scheme:

  * tensor parallelism over the ``model`` axis: column-parallel up
    projections (last dim), row-parallel down projections (first
    non-layer dim), vocab-parallel embedding/lm-head;
  * FSDP-style weight sharding over the ``data`` axis on the non-TP dim
    of each matrix;
  * batch over ('pod', 'data') when divisible; long-context decode
    (batch 1) shards the KV-cache sequence over the batch axes instead;
  * MoE expert weights sharded over ``model`` on the ffn dim (tensor
    parallelism inside every expert). The expert-parallel alternative,
    ``models/moe.py::moe_forward_expert_parallel`` (``moe_impl=
    "expert_parallel"`` with a ``DeviceMesh`` installed by
    ``distributed/actspec.py::moe_mesh``), instead gives each rank of
    ``model`` E / n whole experts (``models/moe.py::shard_experts``) and
    sums the ranks' outputs with one all-reduce a layer; these rules
    describe the baseline layout only.

The dry-run reads per-device bytes from these specs. To place tensors,
:func:`to_device_mesh` and :func:`placements` turn a mesh and a spec into
``torch.distributed``'s ``DeviceMesh`` and DTensor placements; both need
a process group of the mesh's size.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.launch.mesh import MeshShape

PyTree = Any
Spec = tuple

# leaf-name -> role
COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_r", "w_k",
                "w_v", "w_g", "wa", "w_dt", "w_B", "w_C"}
ROW_PARALLEL = {"wo", "w_down", "w_out", "wb"}
MODEL_BIAS = {"bq", "bk", "bv", "b_up"}
REPLICATED = {"router", "w0", "dt_bias", "A_log", "u", "ln_x", "scale",
              "bias", "b_down", "gate_attn", "gate_mlp", "conv",
              "mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "q_norm", "k_norm",
              "step"}


class ShardingRules:
    """Baseline rules plus the JAX package's policy knobs:

    kv_seq_shard — when the KV-head dim does not divide the model axis,
        shard the cache SEQUENCE dim over 'model' instead of replicating
        the cache (flash-decode/context-parallel layout).
    tp — False replicates params (no tensor parallelism) and leans on
        batch/sequence sharding only.
    seq_shard_activations — shard the seq dim of (B, S) inputs over
        'model' (sequence parallelism for the non-TP policy).
    """

    def __init__(self, mesh: MeshShape, *, fsdp: bool = True,
                 tp: bool = True, kv_seq_shard: bool = False,
                 seq_shard_activations: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        self.tp = tp
        self.kv_seq_shard = kv_seq_shard
        self.seq_shard_activations = seq_shard_activations
        self.axes = tuple(mesh.axis_names)
        self.batch_axes = tuple(a for a in ("pod", "data") if a in self.axes)

    def _fsdp_axis(self):
        return "data" if (self.fsdp and "data" in self.axes) else None

    # ------------------------------------------------------------- params
    def param_spec(self, path, leaf) -> Spec:
        name = _leaf_name(path)
        nd = leaf.ndim
        if name in REPLICATED or nd == 0:
            return ()
        if not self.tp:
            # FSDP-only: shard the largest dim over 'data'
            if nd >= 2:
                return _lead((self._fsdp_axis(),), nd - 2)
            return ()
        if name == "embed":                      # (V, d) vocab-parallel
            return ("model", None)
        if name == "lm_head":                    # (d, V)
            return (self._fsdp_axis(), "model")
        if name in MODEL_BIAS:
            return _lead(("model",), nd - 1)
        if name in COL_PARALLEL and nd >= 2:
            return _lead((self._fsdp_axis(), "model"), nd - 2)
        if name in ROW_PARALLEL and nd >= 2:
            return _lead(("model", self._fsdp_axis()), nd - 2)
        return ()

    def params_specs(self, params: PyTree) -> PyTree:
        return tree_map_with_path(
            lambda p, l: fit_spec(self.param_spec(p, l), l.shape, self.mesh),
            params)

    # ------------------------------------------------------------- batch
    def batch_dim_axes(self, batch_size: int) -> tuple:
        """Mesh axes to shard the batch dim over (largest divisible prefix)."""
        axes = []
        prod = 1
        for a in self.batch_axes:
            n = self.mesh.shape[a]
            if batch_size % (prod * n) == 0:
                axes.append(a)
                prod *= n
        return tuple(axes)

    def data_spec(self, batch_size: int, ndim: int,
                  seq_axis: Optional[int] = None) -> Spec:
        """Spec for (B, ...) arrays; if B unshardable and seq_axis given,
        shard that axis instead (context parallelism)."""
        ax = self.batch_dim_axes(batch_size)
        if ax:
            return _lead((ax,), 0, total=ndim)
        if seq_axis is not None:
            parts = [None] * ndim
            parts[seq_axis] = self.batch_axes
            return tuple(parts)
        return (None,) * ndim

    def batch_spec(self, path, leaf) -> Spec:
        s = self.data_spec(leaf.shape[0], leaf.ndim)
        if self.seq_shard_activations and leaf.ndim >= 2 \
                and leaf.shape[1] > 1:
            parts = list(s) + [None] * (leaf.ndim - len(s))
            parts[1] = "model"
            s = tuple(parts)
        return s

    def batch_specs(self, batch: PyTree) -> PyTree:
        return tree_map_with_path(
            lambda p, l: fit_spec(self.batch_spec(p, l), l.shape, self.mesh),
            batch)

    # ------------------------------------------------------------- caches
    def cache_spec(self, path, leaf) -> Spec:
        name = _leaf_name(path)
        nd = leaf.ndim
        n_model = self.mesh.shape.get("model", 1)
        if name == "pos":                         # (B,)
            return self.data_spec(leaf.shape[0], 1)
        if name == "kv_pos":                      # (B, Sc)
            return self.data_spec(leaf.shape[0], 2, seq_axis=1)
        if name in ("k_scale", "v_scale"):        # (L, B, Sc, KV)
            B, KV = leaf.shape[1], leaf.shape[3]
            bax = self.batch_dim_axes(B)
            if self.kv_seq_shard and KV % n_model != 0:
                if bax:
                    return (None, bax, "model", None)
                return (None, None, (*self.batch_axes, "model"), None)
            return (None, bax if bax else None, None, "model")
        if name in ("k", "v", "xk", "xv"):        # (L, B, Sc, KV, hd)
            B, KV = leaf.shape[1], leaf.shape[3]
            bax = self.batch_dim_axes(B)
            if self.kv_seq_shard and KV % n_model != 0:
                # KV heads can't split the model axis: shard the cache
                # sequence instead of replicating it (flash-decode layout)
                if bax:
                    return (None, bax, "model", None, None)
                return (None, None, (*self.batch_axes, "model"), None, None)
            if bax:
                return (None, bax, None, "model", None)
            return (None, None, self.batch_axes, "model", None)
        if name in ("img_k", "img_v"):            # (G, B, Timg, KV, hd)
            bax = self.batch_dim_axes(leaf.shape[1])
            return (None, bax if bax else None, None, "model", None)
        if name in ("wkv", "ssm_scan"):           # (L, B, H, hd, hd | N)
            bax = self.batch_dim_axes(leaf.shape[1])
            if bax:
                return (None, bax, "model", None, None)
            return (None, None, self.batch_axes, "model", None)
        if name in ("shift_tm", "shift_cm",       # (L, B, 1, d)
                    "ssm_conv"):                  # (L, B, cw-1, d_in)
            bax = self.batch_dim_axes(leaf.shape[1])
            return (None, bax if bax else None, None, "model")
        return (None,) * nd

    def cache_specs(self, cache: PyTree) -> PyTree:
        return tree_map_with_path(
            lambda p, l: fit_spec(self.cache_spec(p, l), l.shape, self.mesh),
            cache)

    # ------------------------------------------------------------- opt
    def opt_specs(self, params: PyTree) -> dict:
        pspec = self.params_specs(params)
        return {"m": pspec, "v": pspec, "step": ()}


def fit_spec(spec: Spec, shape: tuple, mesh: MeshShape) -> Spec:
    """Drop mesh axes whose size does not divide the dim (the JAX
    package's ``_fit_spec``): dropped axes mean replication. One entry
    per dimension of ``shape``."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, parts):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for a in axes:
            n = mesh.shape[a]
            if dim % (prod * n) == 0:
                kept.append(a)
                prod *= n
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def shard_factor(spec: Spec, mesh: MeshShape) -> int:
    """How many pieces a fitted spec cuts its tensor into: the product
    of the sizes of the mesh axes it names."""
    n = 1
    for entry in spec:
        if entry is not None:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n *= mesh.shape[a]
    return n


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _lead(spec: Spec, n_lead: int, total: Optional[int] = None) -> Spec:
    parts = [None] * n_lead + list(spec)
    if total is not None:
        parts += [None] * (total - len(parts))
    return tuple(parts)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of nested dicts (None stays
    None); ``path`` is the tuple of keys down to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


# ---------------------------------------------------------------------------
# torch.distributed: a DeviceMesh and DTensor placements
# ---------------------------------------------------------------------------

def to_device_mesh(mesh: MeshShape, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``mesh`` over the ranks of the default
    process group, which must be initialised with world size
    ``mesh.size``; raises otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: init_process_group first "
                           f"(world size {mesh.size})")
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"mesh {mesh.sizes} needs {mesh.size} ranks, "
                           f"the process group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(mesh.sizes),
                            mesh_dim_names=tuple(mesh.axis_names))


def placements(spec: Spec, device_mesh) -> tuple:
    """DTensor placements of a fitted ``spec`` on ``device_mesh`` (a
    ``DeviceMesh`` with dim names, :func:`to_device_mesh`): one per mesh
    dim, ``Shard(d)`` where the spec splits tensor dim d over that axis,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a not in names:
                raise ValueError(f"axis {a!r} not in the mesh's {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)

