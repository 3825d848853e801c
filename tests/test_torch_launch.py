"""The port's launch analysis tools and sharding rules against the JAX
package, on the CPU.

``launch/roofline.py``'s analytic counts must equal the reference's for
every arch and workload shape; its terms divide by the H100's rates.
``launch/specs.py`` builds every entry's inputs on the meta device with
the reference's shapes and dtypes. ``distributed/sharding.py`` must give
every parameter, cache and batch leaf the reference's fitted spec, on
the reference's meshes (duck-typed: the JAX rules read only
``axis_names`` and ``shape``, and the tests stand in for
``NamedSharding`` so they return the fitted ``PartitionSpec``).
``launch/report.py`` renders the reference's tables. ``launch/dryrun.py``
runs an entry on meta and sizes its arguments by those rules.
``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS``
for 512 devices at import.
"""
import dataclasses
import functools
import json
import math
import socket

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.config import SHAPES as J_SHAPES, shape_for as j_shape_for
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jsh
from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro.launch import specs as jspecs
from repro_torch.config import SHAPES, shape_for
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import costmodel
from repro_torch.distributed import actspec
from repro_torch.distributed.sharding import (fit_spec, placements,
                                              to_device_mesh)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssm_scan as tss
from repro_torch.kernels import wkv6_scan as twk
from repro_torch.launch import dryrun, report, specs
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (MESHES, MeshShape, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import init_params
from repro_torch.models.moe import _counts

MESH_NAMES = ("16x16", "2x16x16")
SPEC_ARCHS = ("qwen3-1.7b", "rwkv6-7b", "llama-3.2-vision-90b")


# --------------------------------------------------------------- helpers

def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts (a None subtree has no leaves)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): leaf for path, leaf in leaves}


class _Fitted:
    """A fitted JAX spec where the JAX rules build a NamedSharding (a
    pytree leaf, not a tuple)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


class _JaxMesh:
    """What the JAX rules read of a mesh."""

    def __init__(self, m: MeshShape):
        self.axis_names = tuple(m.axis_names)
        self.shape = dict(m.shape)


@pytest.fixture
def jax_rules(monkeypatch):
    """The JAX ShardingRules over a duck-typed mesh, their
    ``*_shardings`` returning fitted specs as tuples."""
    monkeypatch.setattr(jsh, "NamedSharding", _Fitted)

    def make(mesh: MeshShape, cfg, policy: str):
        jm = _JaxMesh(mesh)
        if policy == "opt":
            small = cfg.d_model < 1024
            return jsh.ShardingRules(jm, tp=not small, kv_seq_shard=True,
                                     seq_shard_activations=small)
        return jsh.ShardingRules(jm)
    return make


@functools.lru_cache(maxsize=None)
def _jax_inputs(arch: str, shape: str, kv: str = "") -> dict:
    return jspecs.input_specs(arch, shape, kv_cache_dtype=kv)


@functools.lru_cache(maxsize=None)
def _port_inputs(arch: str, shape: str, kv: str = "") -> dict:
    return specs.input_specs(arch, shape, kv_cache_dtype=kv)


def _specs_equal(got: dict, want: dict) -> None:
    got, want = _flat(got), _jflat(want)
    assert set(got) == set(want)
    for path in want:
        assert tuple(got[path]) == want[path].spec, path


# --------------------------------------------------------------- roofline

@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_hbm_estimate_equal_jax(arch, shape_name):
    cfg = shape_for(get_config(arch), SHAPES[shape_name])
    jcfg = j_shape_for(j_get_config(arch), J_SHAPES[shape_name])
    assert rl.model_flops(cfg, SHAPES[shape_name]) == \
        jrl.model_flops(jcfg, J_SHAPES[shape_name])
    assert rl.hbm_bytes_estimate(cfg, SHAPES[shape_name]) == \
        jrl.hbm_bytes_estimate(jcfg, J_SHAPES[shape_name])
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    j8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    assert rl.hbm_bytes_estimate(int8, SHAPES[shape_name]) == \
        jrl.hbm_bytes_estimate(j8, J_SHAPES[shape_name])


def test_roofline_terms_at_the_h100_rates():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW) == \
        (costmodel.PEAK_FLOPS, costmodel.HBM_BW, costmodel.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    r = rl.Roofline(chips=4, flops=989e12 * 4, hbm_bytes=3.35e12 * 8,
                    collective_bytes=450e9 * 2, model_flops_=989e12)
    assert abs(r.compute_s - 1.0) < 1e-12
    assert abs(r.memory_s - 2.0) < 1e-12
    assert abs(r.collective_s - 0.5) < 1e-12
    assert r.dominant == "memory"
    assert abs(r.useful_ratio - 0.25) < 1e-12
    d = r.to_dict()
    j = jrl.Roofline(chips=4, flops=989e12 * 4, hbm_bytes=3.35e12 * 8,
                     collective_bytes=450e9 * 2, model_flops_=989e12)
    assert set(d) == set(j.to_dict())
    assert d["dominant"] == "memory" and d["useful_ratio"] == r.useful_ratio


def test_count_ops_counts_matmuls_and_bytes():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    with rl.count_ops() as st:
        c = a @ b
        d = c.t()                                   # a view: no bytes
        e = d + 1.0
    assert st.flops == 2 * 64 * 32 * 16
    assert st.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16) + 4 * 2 * 64 * 16
    assert st.peak_bytes == 4 * 2 * 64 * 16         # c and e alive
    del c, d, e


def test_a_kernels_plain_version_counts_as_the_kernel():
    """On meta, a wrapper's plain version moves and holds only the
    kernel's inputs and outputs (its (B, H, Sq, Sk) scores are left
    out), while its FLOPs are the plain version's, every pair."""
    B, S, H, KV, hd = 2, 256, 4, 2, 64
    q = torch.empty((B, S, H, hd), device="meta")
    k = torch.empty((B, S, KV, hd), device="meta")
    before = dict(tfa.LAUNCHES)
    with rl.count_ops() as st:
        o, lse = tfa.flash_attention_lse(q, k, k)
    assert tfa.LAUNCHES == before
    assert o.shape == q.shape and o.device.type == "meta"
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    io = 4 * (B * S * H * hd * 2 + B * S * KV * hd * 2 + B * H * S)
    assert st.bytes == io
    assert st.peak_bytes == 4 * (B * S * H * hd + B * H * S)
    assert st.flops == 2 * (2 * B * H * S * S * hd)
    assert st.per_op["kernel (plain version on meta)"] == [1, io]


@pytest.mark.parametrize("which", ["wkv6", "ssm"])
def test_chunked_scans_on_meta_count_the_loops_ops(which):
    """Counted on meta, a scan wrapper's chunk loop runs once with its
    chunks folded into the batch: the same FLOPs as the loop on real
    tensors, the same shapes, one kernel's inputs and outputs moved; the
    plain version is itself again after the count."""
    rng = np.random.RandomState(0)
    B, T, H, hd, N = 2, 96, 2, 16, 8
    if which == "wkv6":
        arrays = [rng.randn(B, T, H, hd).astype(np.float32)
                  for _ in range(4)] + [rng.randn(H, hd).astype(np.float32),
                                        np.zeros((B, H, hd, hd), np.float32)]
        arrays[3] = np.exp(-np.exp(arrays[3]))
        mod, fn, plain = twk, twk.wkv6_scan, twk.wkv6_scan_plain
    else:
        arrays = [rng.randn(B, T, H, hd), rng.rand(B, T, H),
                  -np.exp(rng.randn(H)), rng.randn(B, T, N),
                  rng.randn(B, T, N), np.zeros((B, H, hd, N))]
        arrays = [a.astype(np.float32) for a in arrays]
        mod, fn, plain = tss, tss.ssm_scan, tss.ssm_scan_plain
    cpu = [torch.as_tensor(a) for a in arrays]
    meta = [t.to("meta") for t in cpu]
    fc = FlopCounterMode(display=False)
    with fc:
        want = fn(*cpu)
    before = dict(mod.LAUNCHES)
    with rl.count_ops() as st:
        got = fn(*meta)
    assert mod.LAUNCHES == before
    assert getattr(mod, f"{which}_scan_plain") is plain
    assert st.flops == fc.get_total_flops() > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.device.type == "meta"
    io = sum(t.numel() * 4 for t in (*cpu, *want))
    assert st.per_op["kernel (plain version on meta)"] == [1, io]


def test_moe_counts_equal_bincount():
    idx = torch.as_tensor(np.random.RandomState(1).randint(0, 7, 300))
    assert torch.equal(_counts(idx, 9), torch.bincount(idx, minlength=9))
    assert _counts(idx.to("meta"), 9).shape == (9,)


# --------------------------------------------------------------- specs

def test_meta_params_have_the_cpu_draws_shapes():
    cfg = get_smoke_config("hymba-1.5b")
    meta = _flat(init_params(cfg, device="meta"))
    cpu = _flat(init_params(cfg, device="cpu"))
    again = _flat(init_params(cfg, device="cpu"))
    assert set(meta) == set(cpu)
    for path, t in cpu.items():
        assert meta[path].device.type == "meta"
        assert (meta[path].shape, meta[path].dtype) == (t.shape, t.dtype)
        assert torch.equal(t, again[path])


_SPEC_CASES = sorted({(a, s) for a in ARCH_IDS
                      for s in ("decode_32k", "train_4k")}
                     | {(a, s) for a in SPEC_ARCHS for s in SHAPES})


@pytest.mark.parametrize("arch,shape_name", _SPEC_CASES)
def test_input_specs_on_meta_equal_jax(arch, shape_name):
    want = _jax_inputs(arch, shape_name)
    got = _port_inputs(arch, shape_name)
    assert got["cfg"].sliding_window == want["cfg"].sliding_window
    keys = {"params", "extras", "opt_state", "batch", "tokens", "cache"}
    assert set(got) & keys == set(want) & keys
    for k in sorted(set(want) & keys):
        g, w = _flat(got[k]), _jflat(want[k])
        assert set(g) == set(w), k
        for path, leaf in w.items():
            t = g[path]
            assert t.device.type == "meta", (k, path)
            assert tuple(t.shape) == tuple(leaf.shape), (k, path)
            assert _dtype(t) == str(leaf.dtype), (k, path)


# --------------------------------------------------------------- sharding

def test_meshes_mirror_the_jax_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).axis_names == \
        ("pod", "data", "model")
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_host_mesh().size == 1 and MESHES["1xH100"]().size == 1
    with pytest.raises(ValueError):
        MeshShape(("data",), (1, 2))


@pytest.mark.parametrize("policy", ["baseline", "opt"])
@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_specs_equal_jax(arch, mesh_name, policy, jax_rules):
    """Every parameter and optimizer leaf (train_4k), batch leaf, cache
    leaf (decode_32k at batch 128, long_500k at batch 1; int8 under
    ``opt``) and prompt (prefill_32k) gets the reference's fitted spec."""
    mesh = MESHES[mesh_name]()
    for shape_name in ("train_4k", "prefill_32k", "decode_32k",
                       "long_500k"):
        shape = SHAPES[shape_name]
        cfg, kv, rules, _, _ = dryrun.apply_policy(
            shape_for(get_config(arch), shape), shape, policy, mesh)
        jr = jax_rules(mesh, cfg, policy)
        want = _jax_inputs(arch, shape_name, kv)
        got = _port_inputs(arch, shape_name, kv)
        if shape_name == "train_4k":
            _specs_equal(rules.params_specs(got["params"]),
                         jr.params_shardings(want["params"]))
            _specs_equal(rules.opt_specs(got["params"]),
                         jr.opt_shardings(want["opt_state"],
                                          want["params"]))
            _specs_equal(rules.batch_specs(got["batch"]),
                         jr.batch_shardings(want["batch"]))
        if got["extras"] is not None:
            _specs_equal(rules.batch_specs(got["extras"]),
                         jr.batch_shardings(want["extras"]))
        if shape.kind == "decode":
            _specs_equal(rules.cache_specs(got["cache"]),
                         jr.cache_shardings(want["cache"]))
        if "tokens" in want:
            assert fit_spec(rules.batch_spec((), got["tokens"]),
                            got["tokens"].shape, mesh) == \
                jr.batch_shardings(want["tokens"]).spec


def test_fit_spec_drops_axes_that_do_not_divide():
    mesh = MeshShape(("pod", "data", "model"), (2, 4, 2))
    jm = _JaxMesh(mesh)
    for spec, shape in [((("pod", "data"), "model"), (8, 6)),
                        ((("pod", "data"), None), (6, 3)),
                        (("model",), (3, 5, 7)),
                        ((None, ("data", "model")), (2, 12))]:
        want = jsh._fit_spec(jax.sharding.PartitionSpec(*spec), shape, jm)
        assert fit_spec(spec, shape, mesh) == tuple(want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_placements_round_trip_through_a_gloo_device_mesh():
    """A one-process gloo group and a 1 x 1 DeviceMesh: the placements
    of a spec distribute a tensor and give it back whole; the actspec
    hooks leave plain tensors alone and redistribute DTensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    mesh = make_host_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        to_device_mesh(mesh, "cpu")
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
            rank=0, world_size=1)
    except (RuntimeError, ValueError) as e:
        pytest.skip(f"gloo cannot initialise here: {e}")
    try:
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            to_device_mesh(make_production_mesh(), "cpu")
        dm = to_device_mesh(mesh, "cpu")
        pl = placements(("data", None, "model"), dm)
        assert pl == (Shard(0), Shard(2))          # per mesh dim
        assert placements((None, None), dm) == (Replicate(), Replicate())
        x = torch.arange(24.0).reshape(2, 3, 4)
        dx = distribute_tensor(x, dm, pl)
        assert isinstance(dx, DTensor) and tuple(dx.placements) == pl
        assert torch.equal(dx.full_tensor(), x)
        with actspec.residual_spec(("data", actspec.UNCONSTRAINED, None)):
            assert actspec.constrain(x) is x
            c = actspec.constrain(dx)
            assert tuple(c.placements) == (Shard(0), Replicate())
            assert torch.equal(c.full_tensor(), x)
            b = actspec.constrain_batch(dx)
            assert tuple(b.placements) == (Shard(0), Shard(2))
        assert actspec.get_residual_spec() is None
        assert actspec.constrain(dx) is dx
        with actspec.moe_mesh(dm):
            assert actspec.get_moe_mesh() is dm
        assert actspec.get_moe_mesh() is None
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------- report

def _records():
    recs = []
    for i, (arch, shape) in enumerate([("qwen3-1.7b", "train_4k"),
                                       ("qwen3-1.7b", "decode_32k"),
                                       ("rwkv6-7b", "long_500k")]):
        ro = jrl.Roofline(chips=256, flops=1e15 * (i + 1),
                          hbm_bytes=3e12 / (i + 1), collective_bytes=2e10,
                          model_flops_=5e14).to_dict()
        recs.append({"arch": arch, "shape": shape, "mesh": "16x16",
                     "ok": True, "compile_s": 12.5 + i,
                     "memory": {"argument_bytes": 3 << 30,
                                "temp_bytes": (i + 1) << 29},
                     "collectives": {"bytes": 7 << 30, "count": 40 + i},
                     "roofline": ro})
    recs.append({"arch": "olmo-1b", "shape": "prefill_32k", "mesh": "16x16",
                 "ok": False, "compile_s": 1.0, "error": "ValueError: x"})
    return recs


def test_report_renders_the_reference_tables(tmp_path):
    path = tmp_path / "recs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    got, want = report.load([str(path)]), jreport.load([str(path)])
    assert got == want
    assert report.roofline_table(got) == jreport.roofline_table(want)
    assert report.compile_table(got) == jreport.compile_table(want)


def test_report_prints_a_dash_without_collectives():
    rec = dict(_records()[0], mesh="1xH100", collectives=None)
    table = report.roofline_table([rec], mesh="1xH100").splitlines()[-1]
    assert table.split("|")[5].strip() == "-"
    row = report.compile_table([rec]).splitlines()[-1]
    assert row.endswith("| - | - |")


# --------------------------------------------------------------- dryrun

def test_dryrun_whisper_decode_equals_the_jax_counts(jax_rules):
    """The JAX slow test's combo: ok; its model FLOPs are the
    reference's; its 16x16 argument bytes are the sum over the
    reference's specs sharded by the reference's rules."""
    rec = dryrun.dryrun_one("whisper-base", "decode_32k", mesh="16x16",
                            verbose=False)
    assert rec["ok"], rec.get("error")
    jcfg = j_shape_for(j_get_config("whisper-base"), J_SHAPES["decode_32k"])
    assert rec["roofline"]["model_flops"] == \
        jrl.model_flops(jcfg, J_SHAPES["decode_32k"])
    coll = rec["collectives"]
    assert coll["bytes"] > 0 and coll["count"] > 0 and rec["chips"] == 256
    assert set(coll["per_op"]) <= set(jrl.COLLECTIVES)
    assert coll["bytes"] == sum(coll["per_op"].values())
    assert rec["roofline"]["collective_bytes"] == coll["bytes"]
    mesh = MESHES["16x16"]()
    jr = jax_rules(mesh, jcfg, "baseline")
    want = _jax_inputs("whisper-base", "decode_32k")
    total = 0
    for tree, shard in ((want["params"], jr.params_shardings),
                        (want["cache"], jr.cache_shardings),
                        (want["tokens"], jr.batch_shardings)):
        specs_ = _jflat(shard(tree)) if isinstance(tree, dict) \
            else {(): shard(tree)}
        leaves = _jflat(tree) if isinstance(tree, dict) else {(): tree}
        for path, leaf in leaves.items():
            n = math.prod(mesh.shape[a] for e in specs_[path].spec
                          if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
            total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    assert rec["memory"]["argument_bytes"] == total
    assert rec["fits_80gb"] is True
    assert rec["counted"]["flops"] > 0 and rec["counted"]["bytes"] > 0


@pytest.mark.parametrize("arch,shape,policy", [
    ("qwen3-1.7b", "train_4k", "baseline"),
    ("qwen3-1.7b", "prefill_32k", "baseline"),
    ("qwen3-1.7b", "decode_32k", "baseline"),
    ("qwen3-1.7b", "long_500k", "baseline"),
    ("olmoe-1b-7b", "train_4k", "opt")])
def test_dryrun_counts_collectives_at_16x16(arch, shape, policy,
                                             monkeypatch):
    """Each entry runs on DTensors over a fake group of 256 ranks and
    counts its collectives under the reference's op names; the opt
    policy's moe train entry takes the expert-parallel dispatch there,
    whose combine all-reduces once a layer."""
    from repro_torch.models import moe as tmoe
    calls = []
    inner = tmoe.moe_forward_expert_parallel

    def spy(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(tmoe, "moe_forward_expert_parallel", spy)
    rec = dryrun.dryrun_one(arch, shape, mesh="16x16", policy=policy,
                            verbose=False)
    assert rec["ok"], rec.get("error")
    coll = rec["collectives"]
    assert coll["bytes"] > 0 and set(coll["per_op"]) <= set(jrl.COLLECTIVES)
    assert coll["count"] == sum(coll["per_op_count"].values())
    ro = rec["roofline"]
    assert ro["collective_s"] == pytest.approx(
        coll["bytes"] / (256 * rl.ICI_BW))
    if policy == "opt":
        L = dryrun.get_config(arch).n_layers
        assert len(calls) >= L                   # forward and recompute
        assert coll["per_op_count"]["all-reduce"] >= L
    else:
        assert not calls


def test_dryrun_on_one_card_keeps_every_leaf_whole():
    rec = dryrun.dryrun_one("qwen3-1.7b", "long_500k", verbose=False)
    assert rec["ok"] and rec["mesh"] == "1xH100" and rec["chips"] == 1
    got = _port_inputs("qwen3-1.7b", "long_500k")
    whole = sum(t.numel() * t.element_size() for part in
                (got["params"], got["cache"], got["tokens"])
                for t in _flat(part).values())
    assert rec["memory"]["argument_bytes"] == whole
    assert rec["roofline"]["useful_ratio"] == \
        rec["roofline"]["model_flops"] / rec["roofline"]["flops"]


def test_dryrun_cli_flags_and_summary(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    ops = tmp_path / "ops.jsonl"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--multi-pod", "both", "--policy", "opt",
                        "--out", str(out), "--save-hlo", str(ops)]) == 0
    text = capsys.readouterr().out
    assert "2/2 combos analysed" in text
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["policy"] == "opt" and r["ok"] for r in recs)
    assert len(ops.read_text().splitlines()) == 2
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--mesh", "1xH100", "--no-fsdp"]) == 0
    assert "1/1 combos analysed" in capsys.readouterr().out
