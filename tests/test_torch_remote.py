"""The port's RemoteExecutor against the JAX package, on the CPU: the
full cross-process data path with every stage pool in a worker process
(``--device cpu``) behind a socket.

Mirrors ``tests/test_remote.py`` (equivalence across a replan that keeps
the surviving workers' pids, the dial-back launcher and extra channels,
a worker exiting when its pool is removed) and the worker tests of
``tests/test_faults.py`` (the launchers' argv, a killed worker respawned
and the next batch served, the respawn budget failing typed). Results
are held against the JAX executor and the JAX monolithic forward on the
same converted weights (``atol=5e-5, rtol=1e-3``). Also: a worker built
from its pool's parameter slice alone serves what the in-process pool
serves, and the worker entry point loads neither ``jax`` nor ``repro``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import wait_until
from repro import models as JM
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import Fragment as JFragment
from repro.core import GraftPlanner as JPlanner
from repro.serving import GraftExecutor as JExecutor
from repro.serving import ServeRequest as JRequest
from repro_torch.core import Fragment, GraftPlanner
from repro_torch.models import from_jax_params
from repro_torch.serving import (GraftExecutor, GraftServer, ServeRequest,
                                 SocketTransport)
from repro_torch.serving.remote import (RemoteExecutor, SRC_ROOT,
                                        SSHLauncher, SubprocessLauncher,
                                        WorkerDiedError, bind_host_for,
                                        param_pieces)
from repro_torch.serving.smoke import smoke_setup

pytestmark = pytest.mark.slow          # worker spawn + torch import

ARCH = "qwen3-1.7b"
ATOL, RTOL = 5e-5, 1e-3


@pytest.fixture(scope="module")
def setup():
    """3-block smoke model: (port cfg, book, port params, JAX cfg, JAX
    params), the port's params converted from the JAX init."""
    cfg, book, _ = smoke_setup(ARCH, n_layers=3, device="cpu")
    jcfg = j_reduced(j_get_config(ARCH), n_layers=3)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, book, from_jax_params(jax.device_get(jp)), jcfg, jp


def _remote(plan, params, cfg, **kw):
    return RemoteExecutor(plan, params, cfg, transport=SocketTransport(),
                          device="cpu", **kw)


def _requests(cfg, frags, seed, n=1):
    rng = np.random.RandomState(seed)
    return [(ServeRequest(client=f.client, tokens=rng.randint(
        0, cfg.vocab_size, 16).astype(np.int32)), f.p)
        for _ in range(n) for f in frags]


def check_against_jax(jcfg, jp, reqs):
    for req, _p in reqs:
        assert isinstance(req.result, torch.Tensor)
        want, _ = JM.forward(jp, jcfg, np.asarray(req.tokens)[None])
        np.testing.assert_allclose(req.result.float().numpy(),
                                   np.asarray(want[0]), atol=ATOL, rtol=RTOL)


def check_against_jax_executor(jcfg, jp, jbook_frags, reqs):
    """The same requests through the JAX executor on the JAX planner's
    plan of the same fragments give the same results."""
    jfrags, jbook = jbook_frags
    jreqs = [(JRequest(client=r.client, tokens=r.tokens), p)
             for r, p in reqs]
    with JExecutor(JPlanner(jbook).plan(jfrags), jp, jcfg) as jex:
        jex.serve(jreqs)
    for (r, _), (jr, _) in zip(reqs, jreqs):
        np.testing.assert_allclose(r.result.float().numpy(),
                                   np.asarray(jr.result), atol=ATOL,
                                   rtol=RTOL)


def _jax_side(jcfg, frags):
    from repro.core import ProfileBook as JBook
    from repro.core import arch_layer_costs as j_arch_costs
    import dataclasses
    jbook = JBook()
    jbook.add(dataclasses.replace(j_arch_costs(jcfg, seq_len=16),
                                  name=frags[0].model))
    return [JFragment(f.model, f.p, f.t, f.q, client=f.client)
            for f in frags], jbook


def test_remote_executor_equals_jax_across_replan(setup):
    cfg, book, params, jcfg, jp = setup
    planner = GraftPlanner(book)
    frags1 = [Fragment(cfg.name, 0, 60.0, 30.0, client="c0"),
              Fragment(cfg.name, 0, 55.0, 30.0, client="c1"),
              Fragment(cfg.name, 1, 70.0, 30.0, client="c2")]
    with _remote(planner.plan(frags1), params, cfg) as ex:
        # every pool runs in its own worker process, none in the parent
        pids1 = ex.worker_pids()
        assert len(pids1) == ex.n_stage_pools
        assert os.getpid() not in pids1.values()
        assert all(s["device"] == "cpu" for s in ex.pool_stats().values())
        reqs = _requests(cfg, frags1, seed=11)
        ex.serve(reqs)
        check_against_jax(jcfg, jp, reqs)
        compiles1 = {k: s["n_compiles"] for k, s in ex.pool_stats().items()}
        created1 = ex.stats["pools_created"]
        # every worker knows its placement (chip binding crossed the wire)
        chips1 = {k: s["chips"] for k, s in ex.pool_stats().items()}
        for key, chips in chips1.items():
            assert chips == ex.chips_of(key) and len(chips) >= 1

        # conditions shift: c3 arrives on the deeper split point
        frags2 = frags1 + [Fragment(cfg.name, 1, 50.0, 30.0, client="c3")]
        diff = ex.apply_plan(planner.plan(frags2))
        assert diff.n_kept >= 1, "no pool survived a mild replan"
        assert ex.stats["pools_created"] - created1 == \
            len(diff.by_kind("add"))
        # surviving workers were NOT restarted: same pid as before
        pids2 = ex.worker_pids()
        survivors = set(pids1) & set(pids2)
        assert survivors
        for key in survivors:
            assert pids2[key] == pids1[key], f"worker for {key} restarted"
        chips2 = {k: s["chips"] for k, s in ex.pool_stats().items()}
        for a in diff.by_kind("keep"):
            if a.key in survivors:
                assert chips2[a.key] == chips1[a.key]
        # the same request shapes after the replan add no shape to
        # strictly-kept pools (their batch spec is unchanged)
        reqs2 = _requests(cfg, frags1, seed=11)
        ex.serve(reqs2)
        check_against_jax(jcfg, jp, reqs2)
        compiles2 = {k: s["n_compiles"] for k, s in ex.pool_stats().items()}
        kept = {a.key for a in diff.by_kind("keep")} & set(compiles1)
        assert kept, "replan produced no strictly-kept pool"
        for key in kept:
            assert compiles2[key] == compiles1[key]
        # the full new fleet equals the JAX executor's results
        reqs3 = _requests(cfg, frags2, seed=13)
        ex.serve(reqs3)
        check_against_jax_executor(jcfg, jp, _jax_side(jcfg, frags2), reqs3)
        # identity transition: nothing spawned, nothing killed
        before = dict(ex.stats)
        assert ex.apply_plan(planner.plan(frags2)).is_identity
        assert ex.stats["pools_created"] == before["pools_created"]
        assert ex.worker_pids() == pids2
        # every worker logged its spawn and its parameter load
        assert len(ex.spawn_log) == ex.stats["pools_created"]
        assert all(s > 0 and i > 0 and b > 0 for _, s, i, b in ex.spawn_log)


def test_remote_multihost_dialback_launcher_and_channels(setup):
    """Workers started through an ssh-shaped launcher (a local shim in
    place of ssh), dialing back to an EXPLICIT advertise host;
    per-front-end channels reach the same worker; pids stay across a
    replan."""
    cfg, book, params, jcfg, jp = setup
    planner = GraftPlanner(book)
    shim = (sys.executable, "-c",
            "import subprocess, sys; sys.exit(subprocess.call(sys.argv[2:]))")
    launcher = SSHLauncher("worker-host-0", python=sys.executable,
                           pythonpath=SRC_ROOT, ssh=shim)
    frags1 = [Fragment(cfg.name, 0, 60.0, 30.0, client="m0"),
              Fragment(cfg.name, 1, 70.0, 30.0, client="m1")]
    with _remote(planner.plan(frags1), params, cfg,
                 advertise_host="127.0.0.1", launcher=launcher) as ex:
        for key, w in ex._workers.items():
            assert w.connect_str.startswith("127.0.0.1:")
            assert w.launcher is launcher
            argv = w.launcher.argv(w.connect_str, 64, "cpu")
            assert argv[len(shim)] == "worker-host-0"
            assert "repro_torch.serving.remote" in argv
            assert argv[argv.index("--device") + 1] == "cpu"
        pids1 = ex.worker_pids()
        assert os.getpid() not in pids1.values()
        reqs = _requests(cfg, frags1, seed=21)
        ex.serve(reqs)
        check_against_jax(jcfg, jp, reqs)
        # a per-front-end channel is a SEPARATE lane to the SAME worker
        key = ex.chain_keys("m0")[0]
        lane = ex.open_handle(key)
        assert lane is not ex.handle(key)
        assert lane.channel is not ex.handle(key).channel
        assert int(lane.stats()["pid"]) == pids1[key]
        lane.close()
        frags2 = frags1 + [Fragment(cfg.name, 1, 50.0, 30.0, client="m2")]
        ex.apply_plan(planner.plan(frags2))
        pids2 = ex.worker_pids()
        survivors = set(pids1) & set(pids2)
        assert survivors
        for k in survivors:
            assert pids2[k] == pids1[k]
        reqs2 = _requests(cfg, frags2, seed=22)
        ex.serve(reqs2)
        check_against_jax(jcfg, jp, reqs2)
        assert ex.respawn_log == []          # no worker ever died here


def test_remote_worker_shutdown_on_pool_removal(setup):
    cfg, book, params, jcfg, jp = setup
    planner = GraftPlanner(book)
    frags = [Fragment(cfg.name, 0, 60.0, 30.0, client="c0"),
             Fragment(cfg.name, 1, 45.0, 30.0, client="c1")]
    ex = _remote(planner.plan(frags), params, cfg)
    procs = {k: w.proc for k, w in ex._workers.items()}
    assert len(procs) == ex.n_stage_pools
    # shrink to one client: the departed pool's worker must exit
    diff = ex.apply_plan(planner.plan(frags[:1]))
    removed = {a.key for a in diff.by_kind("remove")}
    assert removed
    for key in removed:
        assert procs[key].wait(timeout=15) == 0
    reqs = _requests(cfg, frags[:1], seed=5)
    ex.serve(reqs)
    check_against_jax(jcfg, jp, reqs)
    ex.close()
    for proc in procs.values():
        assert proc.poll() is not None       # every worker is gone


def test_sliced_workers_serve_what_in_process_pools_serve(setup):
    """Each worker holds only its pool's parameter slice (no embedding
    for a pool that neither starts at 0 nor ends at the tied head, no
    head for one that ends early) and still serves exactly what the
    in-process pool over the whole params serves; a respawn re-sends the
    same slice; the workers' launch counters come back (zero here: the
    kernels run on the card only)."""
    from repro_torch.serving.smoke import mixed_depth_plan
    cfg, book, params, jcfg, jp = setup
    frags = [Fragment(cfg.name, 0, 60.0, 30.0, client="a0"),
             Fragment(cfg.name, 1, 50.0, 30.0, client="a1")]
    plan = mixed_depth_plan(cfg, book, frags, s=1, batch=4)
    full = sum(t.numel() * t.element_size()
               for frame in param_pieces(params) for t in
               [p["tensor"] for p in frame])
    reqs_a = _requests(cfg, frags, seed=31, n=2)
    reqs_b = _requests(cfg, frags, seed=31, n=2)
    with GraftExecutor(plan, params, cfg, device="cpu") as ex:
        ex.serve(reqs_a)
    with _remote(plan, params, cfg) as rex:
        sizes = {k: b for k, _, _, b in rex.spawn_log}
        align = next(k for k in sizes if k[1:3] == (0, 1))
        shared = next(k for k in sizes if k[1:3] == (1, 3))
        # the alignment pool [0, 1) holds block 0 and the embedding, the
        # shared pool [1, 3) two blocks and the (tied) head
        assert sizes[align] < full and sizes[shared] < full
        rex.serve(reqs_b)
        for (a, _), (b, _) in zip(reqs_a, reqs_b):
            np.testing.assert_allclose(b.result.numpy(), a.result.numpy(),
                                       atol=ATOL, rtol=RTOL)
        check_against_jax(jcfg, jp, reqs_b)
        w = rex.worker(shared)
        w.proc.kill()
        w.proc.wait(timeout=30)
        with pytest.raises(WorkerDiedError):
            rex.handle(shared).stats()
        assert w.respawns == 1 and w.init_bytes == sizes[shared]
        reqs_c = _requests(cfg, frags, seed=31, n=2)
        rex.serve(reqs_c)
        for (a, _), (c, _) in zip(reqs_a, reqs_c):
            np.testing.assert_allclose(c.result.numpy(), a.result.numpy(),
                                       atol=ATOL, rtol=RTOL)
        counts = rex.kernel_launches(reset=True)
        assert "flash_attention" in counts and "decode_attention" in counts
        assert set(rex.pool_stats()[shared]["launches"]) == set(counts)


# ------------------------------------------------------------ launchers

def test_launcher_argv_and_environment(monkeypatch):
    sub = SubprocessLauncher().argv("127.0.0.1:4242", 99, "cuda:0")
    assert sub[0] == sys.executable and "--connect" in sub
    assert any("repro_torch.serving.remote" in a for a in sub)
    assert sub[sub.index("--connect") + 1] == "127.0.0.1:4242"
    assert sub[sub.index("--max-frame") + 1] == "99"
    assert sub[sub.index("--device") + 1] == "cuda:0"
    assert "--device" not in SubprocessLauncher().argv("h:1", 2)
    # the environment gains PYTHONPATH and nothing else
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    env = SubprocessLauncher().popen_kwargs()["env"]
    assert "JAX_PLATFORMS" not in env
    assert env["PYTHONPATH"].split(os.pathsep)[0] == SRC_ROOT
    assert {k: v for k, v in env.items() if k != "PYTHONPATH"} == \
        {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    ssh = SSHLauncher("gpu-host-3", python="python3.12",
                      pythonpath="/srv/graft/src")
    argv = ssh.argv("198.51.100.7:5123", 1024, "cuda")
    assert argv[:2] == ["ssh", "gpu-host-3"]
    assert argv[2] == "env" and argv[3] == "PYTHONPATH=/srv/graft/src"
    assert not any(a.startswith("JAX_PLATFORMS") for a in argv)
    assert argv[argv.index("-m") + 1] == "repro_torch.serving.remote"
    assert argv[argv.index("--connect") + 1] == "198.51.100.7:5123"
    assert argv[argv.index("--device") + 1] == "cuda"
    shim = SSHLauncher("h", ssh=("/usr/bin/autossh", "-M", "0"))
    assert shim.argv("a:1", 2)[:4] == ["/usr/bin/autossh", "-M", "0", "h"]
    assert bind_host_for("127.0.0.1") == "127.0.0.1"
    assert bind_host_for("localhost") == "localhost"
    assert bind_host_for("10.0.0.7") == ""


def test_worker_entry_point_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC_ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "repro_torch.serving.remote", "--help"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--device" in out.stdout and "--connect" in out.stdout
    mods = [line.rsplit("|", 1)[-1].strip()
            for line in out.stderr.splitlines()
            if line.startswith("import time:")]
    assert "repro_torch.serving.remote" in mods
    assert "torch" in mods
    bad = [m for m in mods if m in ("jax", "repro")
           or m.startswith(("jax.", "jaxlib", "repro."))]
    assert bad == []


def test_worker_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.serving.remote import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--connect", "127.0.0.1:9", "--device", "cuda"])


# ------------------------------------------------------------ worker kill

def test_worker_kill_mid_batch_respawns_and_completes(setup):
    """SIGKILL a pool worker with a batch pinned against it: the batch
    finishes (in-process for the request in flight at the kill), the
    executor respawns the worker, and the NEXT batch rides the new
    process."""
    cfg, book, params, jcfg, jp = setup
    frags = [Fragment(cfg.name, 0, 5000.0, 30.0, client="k0")]
    ex = _remote(GraftPlanner(book).plan(frags), params, cfg,
                 respawn_backoff_s=0.01)
    server = GraftServer(ex, book=book).start()
    try:
        key = ex.chain_keys("k0")[0]
        warm = _requests(cfg, frags, seed=3)
        for req, p in warm:
            server.submit(req, p, 5000.0)
        assert server.join(timeout=600.0)
        check_against_jax(jcfg, jp, warm)
        pid0 = ex.worker(key).pid
        drv = server.driver(key)
        drv.batcher.pause()                      # pin the doomed batch
        doomed = _requests(cfg, frags, seed=4, n=2)
        for req, p in doomed:
            server.submit(req, p, 5000.0)
        wait_until(lambda: len(drv.batcher) == len(doomed),
                   desc="requests to queue on the doomed pool")
        ex.worker(key).proc.kill()
        ex.worker(key).proc.wait(timeout=30)
        drv.batcher.resume()
        assert server.join(timeout=600.0), \
            "worker death stranded in-flight requests"
        rep = server.report()
        assert rep["served"] == len(warm) + len(doomed)
        assert 1 <= rep["local_finishes"] <= len(doomed)
        check_against_jax(jcfg, jp, doomed)
        w = ex.worker(key)
        assert w.respawns == 1 and w.pid != pid0
        assert (key, 1) in ex.respawn_log
        after = _requests(cfg, frags, seed=5)
        for req, p in after:
            server.submit(req, p, 5000.0)
        assert server.join(timeout=600.0)
        check_against_jax(jcfg, jp, after)
        rep2 = server.report()
        assert rep2["local_finishes"] == rep["local_finishes"]
        assert rep2["served"] == rep["served"] + len(after)
        stats = ex.handle(key).stats()
        assert stats["pid"] == w.pid and stats["n_batches"] >= 1
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_worker_respawn_budget_exhausts_typed(setup):
    """Past max_respawns the pool fails TYPED (WorkerDiedError). The
    first death is observed by a NEVER-BOUND per-front-end lane, and the
    worker still respawns."""
    cfg, book, params, _, _ = setup
    frags = [Fragment(cfg.name, 0, 60.0, 30.0, client="x0")]
    ex = _remote(GraftPlanner(book).plan(frags), params, cfg,
                 max_respawns=1, respawn_backoff_s=0.01)
    try:
        key = ex.chain_keys("x0")[0]
        lane = ex.open_handle(key)
        for round_ in range(2):
            ex.worker(key).proc.kill()
            ex.worker(key).proc.wait(timeout=30)
            if round_ == 0:
                with pytest.raises(WorkerDiedError):
                    lane.stats()
                assert ex.worker(key).respawns == 1
                assert int(lane.stats()["pid"]) == ex.worker(key).pid
                assert int(ex.handle(key).stats()["pid"]) \
                    == ex.worker(key).pid
            else:
                with pytest.raises(WorkerDiedError):
                    ex.handle(key).stats()
                with pytest.raises(WorkerDiedError):
                    ex.handle(key).stats()
        lane.close()
    finally:
        ex.close()
