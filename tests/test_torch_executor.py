"""The port's one-shot serving slice against the JAX package.

``GraftExecutor(device="cpu")`` serves planner plans and re-aligned
depth-2 chains, across ``apply_plan``, on weights converted from the JAX
init; every result is held against the JAX monolithic forward at the
reference's tolerance (``atol=5e-5, rtol=1e-3``). Also: the port's
planner against the JAX planner, its transport codec, and the import
boundary (the port loads neither JAX nor ``repro``).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import Fragment as JFragment
from repro.core import GraftPlanner as JPlanner
from repro.core import ProfileBook as JBook
from repro.core import arch_layer_costs as j_arch_costs
from repro.core import plan_pools as j_plan_pools
from repro.serving import batcher as jbatcher
from repro_torch.core import (Fragment, GraftPlanner, ProfileBook,
                              arch_layer_costs, plan_pools)
from repro_torch.core import costmodel
from repro_torch.models import from_jax_params
from repro_torch.serving import (FrameError, GraftExecutor,
                                 InProcessTransport, PoolDrainingError,
                                 ServeRequest, SocketTransport,
                                 TruncatedFrameError)
from repro_torch.serving import batcher
from repro_torch.serving.executor import FragmentInstance
from repro_torch.serving.smoke import (check_against_monolithic,
                                       mixed_depth_plan, smoke_setup)
from repro_torch.serving.transport import decode_frame, encode_frame

ATOL, RTOL = 5e-5, 1e-3
ARCH = "qwen3-1.7b"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def deep():
    """3-block smoke model: (port cfg, book, port params, JAX cfg, JAX
    params) with the port's params converted from the JAX init."""
    cfg, book, _ = smoke_setup(ARCH, n_layers=3, device="cpu")
    jcfg = j_reduced(j_get_config(ARCH), n_layers=3)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, book, from_jax_params(jax.device_get(jp)), jcfg, jp


def _frags(ps):
    return [Fragment(f"{ARCH}-smoke", p, t, 30.0, client=f"c{i}")
            for i, (p, t) in enumerate(zip(ps, (60.0, 45.0, 70.0, 55.0)))]


def _wave(cfg, frags, lens, rng):
    return [(ServeRequest(client=f.client,
                          tokens=rng.randint(0, cfg.vocab_size, n)
                          .astype(np.int32)), f.p)
            for f, n in zip(frags, lens)]


def _check_vs_jax(jcfg, jp, reqs):
    for req, _ in reqs:
        want, _ = JM.forward(jp, jcfg, np.asarray(req.tokens)[None])
        np.testing.assert_allclose(req.result.float().numpy(),
                                   np.asarray(want[0]), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------- executor

@pytest.mark.parametrize("packed", [True, False])
def test_planner_plan_serves_like_jax_forward(deep, packed):
    """The planner's plan, packed pools and the padded fallback alike."""
    cfg, book, params, jcfg, jp = deep
    frags = _frags((0, 1, 2))
    rng = np.random.RandomState(0)
    with GraftExecutor(GraftPlanner(book).plan(frags), params, cfg,
                       packed=packed, device="cpu") as ex:
        reqs = _wave(cfg, frags, (5, 9, 16), rng)
        ex.serve(reqs)
        _check_vs_jax(jcfg, jp, reqs)
        st = ex.pool_stats()
        assert all(s["packed"] == packed for s in st.values())
        assert sum(s["real_tokens"] for s in st.values()) > 0


def test_realigned_chains_across_apply_plan(deep):
    """Depth-2 re-aligned chains sharing one packed pool, then a live
    apply_plan that moves the shared boundary: every wave equals the JAX
    monolithic forward on the same weights."""
    cfg, book, params, jcfg, jp = deep
    frags = _frags((0, 1, 1))
    rng = np.random.RandomState(1)
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params, cfg,
                       device="cpu") as ex:
        routes = ex.route_table()
        assert [k[1:] for k in routes["c0"]] == [(0, 1), (1, 3)]
        assert [k[1:] for k in routes["c1"]] == [(1, 3)]
        reqs = _wave(cfg, frags, (5, 9, 16), rng)
        ex.serve(reqs)
        _check_vs_jax(jcfg, jp, reqs)
        shared = ex.pool_stats()[(cfg.name, 1, 3)]
        assert shared["n_batches"] == 1 and shared["real_tokens"] == 30
        frags2 = [dataclasses.replace(f, p=min(f.p, 2)) for f in frags]
        diff = ex.apply_plan(mixed_depth_plan(cfg, book, frags2, s=2))
        assert diff.by_kind("remove") and ex.stats["plan_applies"] == 1
        assert all(len(c) == 2 for c in ex.route_table().values())
        reqs = _wave(cfg, frags2, (12, 3, 8), rng)
        ex.serve(reqs)
        _check_vs_jax(jcfg, jp, reqs)
        check_against_monolithic(cfg, params, reqs)


def test_compile_count_is_distinct_shapes(deep):
    cfg, book, params, _, _ = deep
    frags = _frags((1, 1))
    rng = np.random.RandomState(2)
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params, cfg,
                       device="cpu") as ex:
        ex.serve(_wave(cfg, frags, (5, 6), rng))   # 11 tokens -> bucket 16
        ex.serve(_wave(cfg, frags, (7, 8), rng))   # 15 tokens -> bucket 16
        assert ex.pool_stats()[(cfg.name, 1, 3)]["n_compiles"] == 1
        ex.serve(_wave(cfg, frags, (9, 9), rng))   # 18 tokens -> bucket 32
        st = ex.pool_stats()[(cfg.name, 1, 3)]
        assert st["n_compiles"] == 2 and st["n_batches"] == 3


def test_pools_record_into_a_shared_telemetry_registry(deep):
    """Pools record per-batch exec time and tokens into the executor's
    registry, and its snapshot crosses the wire on the stats op."""
    from repro_torch.serving.telemetry import Telemetry
    cfg, book, params, _, _ = deep
    tel = Telemetry(process="t")
    frags = _frags((0, 1))
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params, cfg,
                       telemetry=tel, device="cpu") as ex:
        ex.serve(_wave(cfg, frags, (5, 7), np.random.RandomState(6)))
        stats = ex.pool_stats()
    tokens = tel.histogram("pool/batch_tokens").state()
    assert tokens["count"] == sum(s["n_batches"] for s in stats.values())
    assert tokens["sum"] == 5 + 5 + 7        # c0 crosses two pools
    assert tel.histogram("pool/exec_ms").state()["count"] == tokens["count"]
    assert all(s["telemetry"] is not None for s in stats.values())


def test_draining_pool_refuses_over_the_wire(deep):
    cfg, book, params, _, _ = deep
    frags = _frags((1,))
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params, cfg,
                       device="cpu") as ex:
        key = (cfg.name, 1, 3)
        h = ex._handles[key]
        h.retarget(dataclasses.replace(ex._pools[key], batch=0))
        with pytest.raises(PoolDrainingError):
            h.submit(0, "c0", torch.zeros(4, cfg.d_model))


def test_execute_op_batches_in_one_round_trip(deep):
    """``execute`` submits a batch and flushes it in one frame; its
    results equal the blocks run directly."""
    cfg, book, params, _, _ = deep
    from repro_torch.models import run_fragment
    rng = np.random.RandomState(5)
    xs = [torch.from_numpy(rng.randn(n, cfg.d_model).astype(np.float32))
          for n in (3, 8)]
    with GraftExecutor(mixed_depth_plan(cfg, book, _frags((1,)), s=1),
                       params, cfg, device="cpu") as ex:
        out = dict(ex._handles[(cfg.name, 1, 3)].execute(
            [(i, "c0", x, None) for i, x in enumerate(xs)]))
    for i, x in enumerate(xs):
        want = run_fragment(params, cfg, x[None], 1, 3)[0]
        np.testing.assert_allclose(out[i].numpy(), want.numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_apply_plan_refuses_to_drop_queued_work(deep):
    cfg, book, params, _, _ = deep
    frags = _frags((0, 1))
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params, cfg,
                       device="cpu") as ex:
        ex._handles[(cfg.name, 0, 1)].submit(
            99, "c0", torch.zeros(4, dtype=torch.int32))
        frags2 = [dataclasses.replace(f, p=2) for f in frags]
        with pytest.raises(RuntimeError, match="queued"):
            ex.apply_plan(mixed_depth_plan(cfg, book, frags2, s=2))
        assert ex.drain() == 0          # rid 99 was never tracked by serve
        ex.apply_plan(mixed_depth_plan(cfg, book, frags2, s=2))


def test_executor_without_device_needs_a_card(deep):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg, book, params, _, _ = deep
    plan = mixed_depth_plan(cfg, book, _frags((1,)), s=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraftExecutor(plan, params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke_setup(ARCH)


def test_fragment_instance_moves_payloads_to_its_device(deep):
    cfg, book, params, _, _ = deep
    spec = plan_pools(mixed_depth_plan(cfg, book, _frags((1,)), s=1))
    inst = FragmentInstance(params, cfg, spec[(cfg.name, 1, 3)])
    inst.submit(ServeRequest("c0", None), torch.zeros(3, cfg.d_model))
    assert inst.queue[0][1].device == inst.device == torch.device("cpu")


def test_smoke_helpers_match_jax(deep):
    """The port's smoke fleet and requests are the JAX package's: same
    partition points, budgets and token payloads from the same seed."""
    from repro.serving import smoke as jsmoke
    from repro_torch.serving import smoke as tsmoke
    cfg, _, _, jcfg, _ = deep
    frags = tsmoke.smoke_fragments(cfg, 5, seed=4)
    jfrags = jsmoke.smoke_fragments(jcfg, 5, seed=4)
    assert [(f.client, f.p, f.t, f.q) for f in frags] == \
        [(f.client, f.p, f.t, f.q) for f in jfrags]
    reqs = tsmoke.smoke_requests(cfg, frags, seed=4)
    jreqs = jsmoke.smoke_requests(jcfg, jfrags, seed=4)
    for (r, p), (jr, jp_) in zip(reqs, jreqs):
        assert p == jp_ and r.client == jr.client
        np.testing.assert_array_equal(r.tokens, jr.tokens)


# -------------------------------------------------------------- planner

def test_planner_pools_match_jax():
    """Same fragments, same profile rates: the port's planner gives the
    JAX planner's pools. The rates are set equal because the port's
    cost model states H100 figures and the reference TPU ones."""
    jcfg = j_get_config(ARCH)
    jbook, book = JBook(), ProfileBook()
    jprof = jbook.add(j_arch_costs(jcfg, seq_len=512))
    prof = book.add(arch_layer_costs(jcfg, seq_len=512))
    prof.cf, prof.cm = jprof.cf, jprof.cm
    rng = np.random.RandomState(3)
    spec = [(int(rng.randint(0, 28)), float(rng.uniform(30, 120)),
             float(rng.uniform(5, 60))) for _ in range(10)]
    jplan = JPlanner(jbook).plan(
        [JFragment(ARCH, p, t, q, client=f"c{i}")
         for i, (p, t, q) in enumerate(spec)])
    plan = GraftPlanner(book).plan(
        [Fragment(ARCH, p, t, q, client=f"c{i}")
         for i, (p, t, q) in enumerate(spec)])
    def norm(pools):
        return {k: (s.share, s.batch, s.n_instances, s.role)
                for k, s in pools.items()}
    assert norm(plan_pools(plan)) == norm(j_plan_pools(jplan))
    assert plan.total_resource == pytest.approx(jplan.total_resource)


def test_cost_model_states_h100_rates():
    assert costmodel.PEAK_FLOPS == 989e12
    assert costmodel.HBM_BW == 3.35e12
    assert costmodel.ICI_BW == 450e9
    costs = arch_layer_costs(j_get_config(ARCH), seq_len=256)
    jcosts = j_arch_costs(j_get_config(ARCH), seq_len=256)
    for f in ("flops_per_item", "weight_bytes", "act_bytes"):
        np.testing.assert_array_equal(getattr(costs, f), getattr(jcosts, f))


@pytest.mark.parametrize("fn,args", [
    ("bucket_size", (n, b)) for n in (1, 3, 5, 8) for b in (1, 4, 6)] + [
    ("seq_bucket", (n,)) for n in (1, 8, 9, 100)] + [
    ("token_bucket", (n,)) for n in (1, 8, 9, 33)])
def test_bucket_policies_match_jax(fn, args):
    assert getattr(batcher, fn)(*args) == getattr(jbatcher, fn)(*args)


# ------------------------------------------------------------ transport

def test_transport_round_trip_keeps_tensors_exact():
    msg = {"bf16": torch.randn(3, 5).to(torch.bfloat16),
           "f32": torch.randn(2, 0, 4),
           "i32": torch.arange(7, dtype=torch.int32),
           "nested": [{"t": torch.ones(2, dtype=torch.int64)}, 1.5, "x"],
           "np": np.arange(6, dtype=np.float32).reshape(2, 3)}
    back = decode_frame(encode_frame(msg))
    for k in ("bf16", "f32", "i32"):
        assert back[k].dtype == msg[k].dtype
        assert back[k].shape == msg[k].shape
        assert torch.equal(back[k], msg[k])
    assert torch.equal(back["nested"][0]["t"], msg["nested"][0]["t"])
    assert back["nested"][1:] == [1.5, "x"]
    np.testing.assert_array_equal(back["np"], msg["np"])
    # the received bf16 tensor owns writable memory
    back["bf16"].add_(1)


def test_transport_frame_rules():
    t = torch.zeros(1024)
    with pytest.raises(FrameError):
        encode_frame({"t": t}, max_frame_bytes=1000)
    wire = encode_frame({"t": t})
    with pytest.raises(FrameError):
        decode_frame(wire, max_frame_bytes=1000)
    with pytest.raises(TruncatedFrameError):
        decode_frame(wire[:-7])


def test_inprocess_and_socket_transports_carry_tensors():
    echo = lambda m: {"ok": True, "y": m["x"] * 2}            # noqa: E731
    x = torch.randn(4, 3).to(torch.bfloat16)
    inproc = InProcessTransport()
    inproc.serve("e", echo)
    ch = inproc.connect("e")
    assert torch.equal(ch.request({"x": x})["y"], x * 2)
    assert ch.stats.n_transfers == 1
    with SocketTransport() as sock:
        sock.serve("e", echo)
        sch = sock.connect("e")
        try:
            assert torch.equal(sch.request({"x": x})["y"], x * 2)
        finally:
            sch.close()


# -------------------------------------------------------- import boundary

EXAMPLES = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "examples"))


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port and every example twin (run as a module
    that is not ``__main__``: its imports only)."""
    code = (
        "import glob, pkgutil, runpy, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"twins = sorted(glob.glob({EXAMPLES!r} + '/*_torch.py'))\n"
        "assert len(twins) == 6, twins\n"
        "for p in twins:\n"
        "    runpy.run_path(p, run_name='twin')\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro']\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "print(bad)\n"
        "print(all(m in sys.modules for m in ('repro_torch.serving.server', "
        "'repro_torch.serving.controller', 'repro_torch.serving.remote', "
        "'repro_torch.serving.fleet', 'repro_torch.launch.serve', "
        "'repro_torch.core.baselines', 'repro_torch.core.measured', "
        "'repro_torch.models.moe', 'repro_torch.launch.dryrun', "
        "'repro_torch.launch.specs', 'repro_torch.launch.roofline', "
        "'repro_torch.launch.report', 'repro_torch.launch.mesh', "
        "'repro_torch.distributed.sharding', "
        "'repro_torch.distributed.actspec', "
        "'repro_torch.distributed.spmd')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    n, bad, runtime = out.stdout.strip().splitlines()
    assert int(n) >= 65, out.stdout
    assert bad == "[]", bad
    assert runtime == "True", "the server runtime, fleet, remote " \
        "workers, serving launcher, baselines, moe, launch tools or " \
        "sharding rules were not imported"
