"""Checkpointing: nested dicts of tensors <-> a directory of .npy leaves and
a JSON manifest (the port of ``repro/training/checkpoint.py``).

The on-disk format is the JAX package's: one ``.npy`` per leaf, named by
its ``/``-joined key path with ``__`` for ``/``; ``manifest.json`` with
the step and each leaf's file, shape and dtype; written into a temporary
directory beside the target and renamed into place. float32 trees cross
both ways between the packages. A bfloat16 leaf is stored as its raw 16
bits, as the JAX package stores an ``ml_dtypes`` bfloat16 array (numpy
writes it as void ``V2``), so it round-trips bit for bit within the port
and the port reads the JAX package's bf16 leaves; the JAX package's
restore cannot cast ``V2`` and raises, it never misreads.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

Tensor = torch.Tensor


def _flatten_with_names(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        out.extend(_flatten_with_names(v, f"{prefix}{k}/")
                   if isinstance(v, dict) else [(f"{prefix}{k}", v)])
    return out


def _rebuild(tree: dict, leaves: dict, prefix: str = "") -> dict:
    return {k: _rebuild(v, leaves, f"{prefix}{k}/") if isinstance(v, dict)
            else leaves[f"{prefix}{k}"] for k, v in tree.items()}


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_numpy(arr: np.ndarray, meta: dict) -> Tensor:
    if meta["dtype"] == "bfloat16":
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vi":
            raise TypeError(f"{meta['file']}: a bfloat16 leaf stored as "
                            f"{arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise TypeError(f"{meta['file']}: raw {arr.dtype} data for a "
                        f"{meta['dtype']} leaf")
    return torch.from_numpy(np.array(arr, copy=True))


def save_checkpoint(path: str, tree: dict, *, step: int = 0) -> None:
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    manifest = {"step": step, "leaves": {}}
    try:
        for name, leaf in _flatten_with_names(tree):
            arr = _to_numpy(leaf)
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape),
                "dtype": _dtype_name(leaf, arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_checkpoint(path: str, like: dict) -> tuple[dict, int]:
    """Restore into the structure of ``like``: each leaf's shape is
    checked, and it takes ``like``'s dtype and device."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = dict(_flatten_with_names(like))
    leaves = {}
    for name, meta in manifest["leaves"].items():
        if name not in names:
            raise KeyError(f"checkpoint leaf {name} not in target structure")
        arr = np.load(os.path.join(path, meta["file"]))
        want = names[name]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        leaves[name] = _from_numpy(arr, meta).to(dtype=want.dtype,
                                                 device=want.device)
    missing = set(names) - set(leaves)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    return _rebuild(like, leaves), manifest["step"]
