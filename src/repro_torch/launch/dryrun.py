"""Dry-run of every (arch x shape) on one H100 or a mesh: the work each
entry does, counted on the meta device, and what it holds per device.

The port of ``repro/launch/dryrun.py``. The JAX package lowers and
AOT-compiles each entry for a 256- or 512-chip v5e mesh and reads XLA's
cost and memory analyses. Here the entry (``launch/specs.py``) runs
eagerly on the meta device, where nothing is allocated or computed,
under ``launch/roofline.py``'s counter:

  * FLOPs: the matrix products ``FlopCounterMode`` counts. Attention
    there is the plain version, which scores every (q, k) pair, masked
    ones included (``"flops_source"``); ``useful_ratio`` stays
    ``model_flops / flops`` as in JAX;
  * bytes: every aten op's reads and writes (the eager program's
    traffic), or the analytic estimate where that is larger;
  * memory: per-device ``argument_bytes``, each input leaf's bytes over
    the product of the mesh axes its fitted spec names
    (``distributed/sharding.py``; on ``1xH100`` every leaf is whole);
    ``temp_bytes``, the most bytes the run held at once in storages it
    made, spread evenly over the chips; ``fits_80gb`` whether the two
    fit one card's 80 GB.

That pass runs on plain meta tensors in one process. On a mesh of more
than one device a second pass runs the same entry as the JAX package
compiles it, with ``in_shardings``: every input a DTensor placed by the
policy's ``ShardingRules`` (``distributed/spmd.py``) on a fake process
group of the mesh's size in this process, under
``implicit_replication`` (a tensor made inside the model is the same on
every rank), the residual constraint ``(batch axes, UNC, UNC)`` unless
the policy is ``legacy`` (``distributed/actspec.py``) and the MoE mesh
hook. ``spmd.CollectiveCounter`` fills ``"collectives"``: ``"bytes"``
and ``"per_op"`` (by the HLO names of ``repro/launch/roofline.py``),
``"count"``, ``"per_op_count"`` and ``"source"``. Those bytes are one
device's, and the roofline's collective term divides them by chips x
the link rate, as the JAX package's ``Roofline.collective_s`` does, so
that the records compare. The reference's ``n_while`` and
``loop_trips`` are not kept: an eager run dispatches every layer and
microbatch, so there is no loop to correct for. On ``1xH100`` the
record keeps ``"collectives": null`` (``launch/report.py`` prints
``-``). The ``opt`` policy sets the moe models' non-decode entries to
``expert_parallel``, as the JAX package does; the plain pass installs
no mesh, so there they take ``grouped`` (``models/moe.py``), whose FLOPs
are the expert-parallel path's summed over its ranks, and the sharded
pass runs ``expert_parallel`` on each rank's tokens.

``mesh`` is a name from ``launch/mesh.py``'s ``MESHES`` or any
``MeshShape`` (a host's ``(data 2, model 2)`` of four ranks, counted to
hold a real run's collectives against); ``shape`` a name from
``SHAPES`` or a ``ShapeConfig``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh 16x16 \\
      --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh 1xH100
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.config import shape_for
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import actspec, spmd
from repro_torch.distributed.sharding import (ShardingRules, fit_spec,
                                              shard_factor)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import MESHES, MeshShape
from repro_torch.launch.specs import entry_fn, input_specs

HBM_BYTES = 80e9              # one H100 SXM's device memory (data sheet)
FLOPS_SOURCE = ("FlopCounterMode over the meta run; attention by the "
                "plain version, every (q, k) pair counted, masked ones "
                "included")


def _leaves(tree, specs):
    """(leaf, its spec) pairs of a tree and its spec tree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k])
        return
    yield tree, specs


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def argument_bytes(args: list, mesh) -> int:
    """One device's bytes of (tree, spec tree) pairs."""
    total = 0
    for tree, specs in args:
        for leaf, spec in _leaves(tree, specs):
            total += leaf.numel() * leaf.element_size() \
                // shard_factor(spec, mesh)
    return total


def apply_policy(cfg, shape, policy: str, mesh, *, fsdp: bool = True):
    """The JAX dry-run's policy (``repro/launch/dryrun.py``): -> (cfg,
    kv_cache_dtype, rules, microbatches, remat)."""
    kv_dt = ""
    if policy == "opt" and shape.kind == "decode" and cfg.family != "ssm":
        kv_dt = "int8"                     # beyond-paper: quantized KV cache
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dt)
    if policy == "opt" and cfg.moe and shape.kind != "decode":
        cfg = dataclasses.replace(cfg, moe_impl="expert_parallel")
    if policy == "opt":
        # context-parallel KV caches when KV heads don't divide the model
        # axis; tensor parallelism off for tiny models in favour of
        # sequence sharding
        small = cfg.d_model < 1024
        rules = ShardingRules(mesh, fsdp=fsdp, tp=not small,
                              kv_seq_shard=True,
                              seq_shard_activations=small)
    else:
        rules = ShardingRules(mesh, fsdp=fsdp)
    mb, remat = 1, True
    if policy == "opt" and shape.kind == "train":
        n = cfg.n_params()
        mb = 16 if n > 50e9 else (8 if n > 20e9 else 1)
        # the per-microbatch batch must stay shardable over the data axes
        data_chips = mesh.size // mesh.shape["model"]
        while mb > 1 and (shape.global_batch // mb) % data_chips:
            mb //= 2
        remat = True if n > 20e9 else "dots"
    return cfg, kv_dt, rules, mb, remat


def mesh_name(ms: MeshShape) -> str:
    """``ms``'s name in ``MESHES``, else its axes and sizes."""
    for name, make in MESHES.items():
        if make() == ms:
            return name
    return "x".join(f"{a}{n}" for a, n in zip(ms.axis_names, ms.sizes))


def count_collectives(fn, sized: list, ms: MeshShape, rules, shape,
                      policy: str) -> dict:
    """The sharded pass: ``fn`` on its inputs, ``sized``'s (tree, spec
    tree) pairs in ``fn``'s argument order, each placed by its specs on a
    fake group of ``ms.size`` ranks; -> its ``"collectives"``."""
    from torch.distributed.tensor.experimental import implicit_replication
    bax = rules.batch_dim_axes(shape.global_batch)
    act = (bax, actspec.UNCONSTRAINED, actspec.UNCONSTRAINED) \
        if bax and policy != "legacy" else None
    with spmd.fake_group(ms) as dm:
        dargs = tuple(spmd.distribute_tree(tree, spec, dm)
                      for tree, spec in sized)
        with spmd.CollectiveCounter() as cc, implicit_replication(), \
                actspec.residual_spec(act), actspec.moe_mesh(dm):
            out = fn(*dargs)
        del out, dargs
    return cc.record()


def dryrun_one(arch: str, shape_name, *, mesh="1xH100",
               fsdp: bool = True, policy: str = "baseline",
               batch: int = 0, verbose: bool = True,
               save_ops: str = "") -> dict:
    """Count one (arch, shape) entry on meta and size it on ``mesh`` (a
    name from ``MESHES`` or a ``MeshShape``); on a mesh of more than one
    device, count its collectives on DTensors (the module's docstring).
    ``shape_name`` is a name from ``SHAPES`` or a ``ShapeConfig``;
    ``batch`` > 0 cuts its global batch."""
    t0 = time.perf_counter()
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    if batch:
        shape = dataclasses.replace(shape, global_batch=batch)
    ms = MESHES[mesh]() if isinstance(mesh, str) else mesh
    mesh = mesh_name(ms)
    cfg, kv_dt, rules, mb, remat = apply_policy(
        shape_for(get_config(arch), shape), shape, policy, ms, fsdp=fsdp)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "chips": ms.size, "fsdp": fsdp, "policy": policy,
           "global_batch": shape.global_batch}
    try:
        specs = input_specs(arch, shape, kv_cache_dtype=kv_dt)
        # the policy's moe impl; every other field is input_specs' cfg
        specs["cfg"] = dataclasses.replace(specs["cfg"],
                                           moe_impl=cfg.moe_impl)
        fn = entry_fn(specs["cfg"], shape, train_remat=remat,
                      ce_impl="gather" if policy == "legacy" else "onehot",
                      microbatches=mb)
        p = specs["params"]
        sized = [(p, rules.params_specs(p))]
        if shape.kind == "train":
            args = (p, specs["opt_state"], specs["batch"])
            sized += [(specs["opt_state"], rules.opt_specs(p)),
                      (specs["batch"], rules.batch_specs(specs["batch"]))]
        elif shape.kind == "prefill":
            args = (p, specs["tokens"])
            sized.append((specs["tokens"],
                          rules.batch_specs(specs["tokens"])))
        else:
            args = (p, specs["cache"], specs["tokens"])
            sized += [(specs["cache"], rules.cache_specs(specs["cache"])),
                      (specs["tokens"], rules.batch_specs(specs["tokens"]))]
        if specs["extras"] is not None and shape.kind != "decode":
            args += (specs["extras"],)
            sized.append((specs["extras"],
                          rules.batch_specs(specs["extras"])))
        with rl.count_ops() as stats:
            out = fn(*args)
        out_bytes = sum(t.numel() * t.element_size()
                        for t in _tensor_leaves(out))
        del out
        if save_ops:
            with open(save_ops, "a") as f:
                f.write(json.dumps({"arch": arch, "shape": shape_name,
                                    "per_op": stats.per_op}) + "\n")
        coll = None if ms.size == 1 else count_collectives(
            fn, sized, ms, rules, shape, policy)
        mf = rl.model_flops(specs["cfg"], shape)
        flops = stats.flops if stats.flops > 0.1 * mf else mf
        hbm = max(stats.bytes, rl.hbm_bytes_estimate(specs["cfg"], shape))
        roof = rl.Roofline(chips=ms.size, flops=flops, hbm_bytes=hbm,
                           collective_bytes=coll["bytes"] if coll else 0.0,
                           model_flops_=mf)
        arg_b = argument_bytes(sized, ms)
        temp_b = int(stats.peak_bytes) // ms.size
        rec.update({
            "ok": True,
            "compile_s": round(time.perf_counter() - t0, 1),
            "memory": {"argument_bytes": arg_b,
                       "output_bytes": out_bytes // ms.size,
                       "temp_bytes": temp_b,
                       "peak_bytes": arg_b + temp_b},
            "fits_80gb": arg_b + temp_b <= HBM_BYTES,
            "counted": {"flops": stats.flops, "bytes": stats.bytes,
                        "n_ops": stats.n_ops},
            "flops_source": FLOPS_SOURCE,
            "microbatches": mb, "remat": remat,
            "collectives": coll,
            "roofline": roof.to_dict(),
        })
        if verbose:
            m = rec["memory"]
            print(f"[ok] {arch:24s} {shape_name:12s} {mesh:8s} "
                  f"analysed={rec['compile_s']:6.1f}s "
                  f"args/dev={m['argument_bytes'] / 2**30:7.2f}GiB "
                  f"temp/dev={m['temp_bytes'] / 2**30:7.2f}GiB "
                  f"fits_80gb={rec['fits_80gb']} "
                  + ("" if coll is None else
                     f"coll={coll['bytes'] / 2**30:8.2f}GiB ")
                  + f"dom={roof.dominant}")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "compile_s": round(time.perf_counter() - t0, 1)})
        if verbose:
            print(f"[FAIL] {arch} {shape_name} {mesh}: {rec['error']}")
            traceback.print_exc()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", default="single",
                    choices=("single", "multi", "both"),
                    help="the JAX package's meshes: 16x16, 2x16x16 or both "
                         "(unless --mesh is given)")
    ap.add_argument("--mesh", default="",
                    help="comma-separated mesh names from "
                         f"{sorted(MESHES)}; overrides --multi-pod")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--policy", default="baseline",
                    choices=("legacy", "baseline", "opt"))
    ap.add_argument("--out", default="")
    ap.add_argument("--save-hlo", default="",
                    help="the port compiles no HLO: appends each combo's "
                         "counted aten ops (count, bytes) to this file")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.mesh:
        meshes = args.mesh.split(",")
        unknown = set(meshes) - set(MESHES)
        if unknown:
            ap.error(f"unknown meshes {sorted(unknown)}")
    else:
        meshes = {"single": ["16x16"], "multi": ["2x16x16"],
                  "both": ["16x16", "2x16x16"]}[args.multi_pod]

    recs, n_fail = [], 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                rec = dryrun_one(arch, shape, mesh=mesh,
                                 fsdp=not args.no_fsdp, policy=args.policy,
                                 save_ops=args.save_hlo)
                recs.append(rec)
                n_fail += 0 if rec["ok"] else 1
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    print(f"\n{len(recs) - n_fail}/{len(recs)} combos analysed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
