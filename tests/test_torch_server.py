"""The port's event-driven server runtime against the JAX package, on
the CPU.

The JAX smoke model's weights (converted by ``from_jax_params``) serve
through the port's ``GraftServer``: its pool drivers, micro-batchers,
reroutes, grace expiry, timer-driven replans, continuous-batching decode
and disaggregated decode. Every one-shot result is held against the JAX
monolithic forward within the reference's fragment tolerance
(``atol=5e-5, rtol=1e-3``); every decode stream must equal the JAX
``reference_decode`` token for token.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from conftest import FakeClock, wait_until
from repro import models as JM
from repro.configs import get_smoke_config as j_smoke_config
from repro.configs import reduced as j_reduced
from repro.configs import get_config as j_get_config
from repro.serving import smoke as jsmoke
from repro_torch.core import Fragment, GraftPlanner
from repro_torch.core.plandiff import plan_pools
from repro_torch.models import from_jax_params
from repro_torch.serving import (GraftExecutor, GraftServer,
                                 InProcessTransport, ServeRequest,
                                 ShedPolicy, run_serve_loop)
from repro_torch.serving import smoke as tsmoke
from repro_torch.serving.controller import ServingController
from repro_torch.serving.telemetry import Telemetry

ARCH = "qwen3-1.7b"
ATOL, RTOL = 5e-5, 1e-3


def _twin(jcfg, n_layers=None):
    """(port cfg, port book, port params, JAX cfg, JAX params): the JAX
    init, converted."""
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg, book, _ = tsmoke.smoke_setup(ARCH, n_layers=n_layers, seed=0,
                                      device="cpu")
    assert cfg.n_layers == jcfg.n_layers
    return cfg, book, from_jax_params(jax.device_get(jp)), jcfg, jp


@pytest.fixture(scope="module")
def smoke():
    return _twin(j_smoke_config(ARCH))


def check_against_jax(jcfg, jp, reqs):
    """Each served result equals the JAX monolithic forward."""
    assert reqs
    for req, _p in reqs:
        assert isinstance(req.result, torch.Tensor)
        want, _ = JM.forward(jp, jcfg, np.asarray(req.tokens)[None])
        np.testing.assert_allclose(req.result.float().numpy(),
                                   np.asarray(want[0]), atol=ATOL, rtol=RTOL)


def check_decode_against_jax(jcfg, jp, served):
    assert served
    for req, max_new in served:
        want = jsmoke.reference_decode(jcfg, jp, req.tokens, max_new)
        assert list(req.out_tokens or []) == want, req.client


def _server(smoke, frags, **kw):
    cfg, book, params, _, _ = smoke
    ex = GraftExecutor(GraftPlanner(book).plan(frags), params, cfg,
                       device="cpu")
    return ex, GraftServer(ex, book=book, **kw).start()


def _submit_all(server, cfg, frags, rng, n_per_client=2):
    out = []
    for _ in range(n_per_client):
        for f in frags:
            req = ServeRequest(client=f.client, tokens=rng.randint(
                0, cfg.vocab_size, 16).astype(np.int32))
            server.submit(req, f.p, f.t)
            out.append((req, f.p))
    return out


# ------------------------------------------------------- one-shot serving

def test_server_pipelined_numerics_match_jax(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="c0"),
             Fragment(cfg.name, 1, 60.0, 30.0, client="c1"),
             Fragment(cfg.name, 1, 90.0, 30.0, client="c2")]
    ex, server = _server(smoke, frags)
    try:
        reqs = _submit_all(server, cfg, frags, np.random.RandomState(0),
                           n_per_client=3)
        assert server.join(timeout=300.0), "requests never drained"
        check_against_jax(jcfg, jp, reqs)
        rep = server.report()
        assert rep["served"] == len(reqs)
        assert rep["local_finishes"] == 0 and rep["rerouted"] == 0
        assert rep["n_stage_pools"] == ex.n_stage_pools
        assert server.stats["batches"] >= 1
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_server_parallel_ingest_threads(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = [Fragment(cfg.name, i % 2, 80.0, 30.0, client=f"i{i}")
             for i in range(6)]
    ex, server = _server(smoke, frags)
    try:
        assert server.n_ingest_threads == 4        # min(4, 6 clients)
        reqs = _submit_all(server, cfg, frags, np.random.RandomState(6),
                           n_per_client=3)
        assert server.join(timeout=300.0)
        check_against_jax(jcfg, jp, reqs)
        assert server.report()["served"] == len(reqs)
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()
    ex2, server2 = _server(smoke, frags[:2], ingest_threads=3)
    try:
        assert server2.n_ingest_threads == 3
    finally:
        server2.stop(drain=False, timeout=5.0)
        ex2.close()


def test_server_mixed_depth_chains_numerics():
    """Depth-2 chains (align [0,1) -> shared [1,L) for p=0 clients,
    direct shared for p=1): results cross TWO pool drivers through the
    batched execute hop and stay within the tolerance of JAX."""
    deep = _twin(j_reduced(j_get_config(ARCH), n_layers=3), n_layers=3)
    cfg, book, params, jcfg, jp = deep
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="a0"),
             Fragment(cfg.name, 1, 60.0, 30.0, client="b1"),
             Fragment(cfg.name, 0, 90.0, 30.0, client="b2")]
    ex = GraftExecutor(tsmoke.mixed_depth_plan(cfg, book, frags, s=1,
                                               batch=4),
                       params, cfg, device="cpu")
    server = GraftServer(ex, book=book).start()
    try:
        assert len(ex.chain_keys("a0")) == 2     # align -> shared
        assert len(ex.chain_keys("b1")) == 1
        assert [h.key for h in ex.client_chain("a0")] == \
            ex.chain_keys("a0")
        reqs = _submit_all(server, cfg, frags, np.random.RandomState(4),
                           n_per_client=3)
        assert server.join(timeout=300.0)
        check_against_jax(jcfg, jp, reqs)
        assert server.report()["served"] == len(reqs)
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_server_reroutes_requests_queued_on_removed_pool(smoke):
    """Requests queued on a pool that a concurrent ``apply`` removes are
    rerouted (the client left the plan, so they finish through the
    in-process fallback) and stay within the tolerance of JAX; on a fake
    clock, so no flush deadline fires behind the pause."""
    cfg, book, _, jcfg, jp = smoke
    frags1 = [Fragment(cfg.name, 0, 80.0, 30.0, client="c0"),
              Fragment(cfg.name, 1, 60.0, 30.0, client="c1")]
    ex, server = _server(smoke, frags1, clock=FakeClock())
    try:
        victim_key = ex.chain_keys("c1")[0]
        server.driver(victim_key).batcher.pause()   # pin c1's requests
        reqs = _submit_all(server, cfg, [frags1[1]],
                           np.random.RandomState(1), n_per_client=3)
        wait_until(lambda: len(server.driver(victim_key).batcher)
                   >= len(reqs), desc="requests to queue on the victim")
        diff = server.apply(GraftPlanner(book).plan([frags1[0]]))
        assert any(a.key == victim_key for a in diff.by_kind("remove"))
        assert server.join(timeout=300.0), "rerouted requests lost"
        rep = server.report()
        assert rep["served"] == len(reqs)
        assert rep["rerouted"] == len(reqs)
        assert rep["local_finishes"] == len(reqs)
        check_against_jax(jcfg, jp, reqs)
        assert all(r.result.device.type == "cpu" for r, _ in reqs)
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_server_apply_plan_keeps_warm_pools_and_requeues(smoke):
    cfg, book, _, jcfg, jp = smoke
    planner = GraftPlanner(book)
    frags1 = [Fragment(cfg.name, 0, 80.0, 30.0, client="c0"),
              Fragment(cfg.name, 1, 60.0, 30.0, client="c1")]
    ex, server = _server(smoke, frags1)
    try:
        reqs = _submit_all(server, cfg, frags1, np.random.RandomState(2))
        assert server.join(timeout=300.0)
        created = ex.stats["pools_created"]
        frags2 = [frags1[0], dataclasses.replace(frags1[1], q=60.0)]
        diff = server.apply(planner.plan(frags2))
        assert diff.n_kept >= 1
        reqs += _submit_all(server, cfg, frags2, np.random.RandomState(3))
        assert server.join(timeout=300.0)
        assert ex.stats["pools_created"] - created == \
            len(diff.by_kind("add"))
        check_against_jax(jcfg, jp, reqs)
        assert server.report()["served"] == len(reqs)
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


@pytest.mark.parametrize("hold", ["resident_stream", "queued_request"])
def test_refused_apply_reverts_the_controller_and_is_retried(smoke, hold):
    """Client c1 leaves the controller's window while the server still
    holds its work: a decode stream resident on the pool only c1 uses
    (the pool's stats say so, and ``apply_plan`` refuses), or a request
    of c1's queued server-side (the tick refuses to strand it). The
    replan changes nothing, the tick counts the refusal instead of
    raising, and the controller believes the deployed plan again. Once
    the work is done, the next tick's replan (the departure fires again)
    is applied and the two agree."""
    cfg, book, params, jcfg, jp = smoke
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="c0"),
             Fragment(cfg.name, 1, 60.0, 30.0, client="c1")]
    clock = FakeClock()
    ctl = ServingController(book, planner=GraftPlanner(book),
                            window_ms=1000.0, control_period_ms=1e6,
                            min_replan_interval_ms=500.0)
    plan0 = ctl.bootstrap(frags, now_ms=0.0)
    ex = GraftExecutor(plan0, params, cfg, device="cpu")
    server = GraftServer(ex, controller=ctl, book=book, clock=clock).start()
    try:
        (key1,) = ex.chain_keys("c1")
        reqs = []
        if hold == "resident_stream":
            for h in ex._handles.values():
                h.stats = lambda: {"queue_len": 0, "decode_active": 1}
            want = "resident decode streams"
        else:
            server.driver(key1).batcher.pause()
            reqs = _submit_all(server, cfg, [frags[1]],
                               np.random.RandomState(9), n_per_client=1)
            wait_until(lambda: len(server.driver(key1).batcher) == 1,
                       desc="c1's request to queue")
            want = "['c1'] still have requests in flight"
        clock.advance(3000.0)                    # c1 leaves the window
        for t in (2200.0, 2500.0, 2800.0):
            ctl.observe_arrival(t, "c0", cfg.name, 0, 80.0)
        assert server.tick() is None
        assert server.stats["applies_refused"] == 1
        assert server.stats["tick_errors"] == server.stats["timer_replans"] \
            == 0
        assert ctl.stats["refused"] == 1 and ctl.current_plan is plan0
        assert want in ctl.audit[-1]["refused"]
        assert ctl.audit[-1]["diff"]["remove"] >= 1
        assert ex.pool_specs() == plan_pools(plan0)
        if hold == "resident_stream":            # ... and then it drains
            for h in ex._handles.values():
                del h.stats
        else:
            server.driver(key1).batcher.resume()
            assert server.join(timeout=120.0)
            check_against_jax(jcfg, jp, reqs)
        clock.advance(600.0)
        for t in (3300.0, 3500.0):
            ctl.observe_arrival(t, "c0", cfg.name, 0, 80.0)
        assert server.tick() is not None
        assert server.stats["timer_replans"] == 1
        assert ctl.stats["triggers"]["fragment_departure"] == 2
        assert plan_pools(ctl.current_plan) == ex.pool_specs() \
            != plan_pools(plan0)
        rep = server.report()
        assert rep["applies_refused"] == 1
        assert rep["local_finishes"] == rep["rerouted"] == 0
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_server_unroutable_request_grace_expires_without_controller(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="c0")]
    ex, server = _server(smoke, frags, waiting_grace_ms=150.0)
    try:
        req = ServeRequest(client="c0", tokens=np.random.RandomState(5)
                           .randint(0, cfg.vocab_size, 16).astype(np.int32))
        server.submit(req, 1, 80.0)            # p=1: plan only covers p=0
        assert server.join(timeout=120.0), "parked request stranded"
        rep = server.report()
        assert rep["served"] == 1 and rep["waited"] == 1
        assert rep["local_finishes"] == 1
        check_against_jax(jcfg, jp, [(req, 1)])
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_server_sheds_hopeless_requests_only(smoke):
    """With a shed policy and a budget no pool can meet, requests are
    shed at the door (recorded, never served); with a generous budget
    none is."""
    cfg, _, _, jcfg, jp = smoke
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="c0")]
    ex, server = _server(smoke, frags, shed_policy=ShedPolicy(
        budget_frac=1.0))
    try:
        rng = np.random.RandomState(8)
        hopeless = ServeRequest(client="c0", tokens=rng.randint(
            0, cfg.vocab_size, 16).astype(np.int32))
        server.submit(hopeless, 0, 1e-6)
        ok = ServeRequest(client="c0", tokens=rng.randint(
            0, cfg.vocab_size, 16).astype(np.int32))
        server.submit(ok, 0, 60_000.0)
        assert server.join(timeout=120.0)
        rep = server.report()
        assert rep["shed"] == 1 and rep["shed_ingest"] == 1
        assert rep["served"] == 1 and hopeless.result is None
        check_against_jax(jcfg, jp, [(ok, 0)])
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


# ------------------------------------------------------ the serve loop

@pytest.mark.parametrize("shaped", [False, True])
def test_serve_loop_timer_replan_mid_traffic(smoke, shaped):
    """The wall-clock loop replans on its timer mid-traffic (the
    partition shift), over the plain loopback and over the 5G-shaped
    uplink whose delays are paid in real time; every served result is
    within the tolerance of JAX."""
    cfg, book, params, jcfg, jp = smoke
    rep = run_serve_loop(seconds=1.5, n_clients=2, rate=8.0, seed=0,
                         shift_frac=0.5, control_period_ms=200.0,
                         shaped=shaped, setup=(cfg, book, params))
    assert rep["served"] > 0 and rep["drained"]
    assert rep["plan_in_sync"] and rep["tick_errors"] == 0
    assert rep["numerics_ok"] and rep["numerics_checked"] > 0
    assert rep["timer_replans"] >= 1, f"no timer-driven replan fired: {rep}"
    assert rep["controller_replans"] >= 1
    assert rep["controller_triggers"].get("partition_shift", 0) >= 1
    done = [(r, p) for r, p in rep["requests"] if r.result is not None]
    check_against_jax(jcfg, jp, done[:16])


def test_serve_loop_decode_client_and_numerics(smoke):
    """The last client sends decode streams (every other one repeating a
    prompt) through decode-capable pools while the others serve one-shot
    requests; the streams equal the JAX reference."""
    cfg, book, params, jcfg, jp = smoke
    frags = [Fragment(cfg.name, 1, 4000.0, 8.0, client="c0"),
             Fragment(cfg.name, 0, 4000.0, 6.0, client="c1")]
    rep = run_serve_loop(seconds=1.2, seed=1, shift_frac=None,
                         control_period_ms=200.0, frags=frags,
                         setup=(cfg, book, params), prompt_lens=(6, 20),
                         decode_max_new=4)
    assert rep["drained"] and rep["numerics_ok"]
    assert rep["decode_numerics_ok"] and rep["decode_checked"] > 0
    assert rep["decode_min_margin"] > 0.0
    assert rep["decode_local"] == 0 and rep["local_finishes"] == 0
    assert rep["decode"]["n"] == rep["decode_served"] > 0
    streams = rep["decoded"]
    assert any(np.array_equal(a.tokens, b.tokens)
               for a, _ in streams for b, _ in streams if a is not b)
    check_decode_against_jax(jcfg, jp, streams[:4])


def test_serve_loop_unported_modes_and_no_card_raise():
    with pytest.raises(NotImplementedError, match="item 5"):
        run_serve_loop(mode="socket", seconds=0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        run_serve_loop(frontends=2, seconds=0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        run_serve_loop(shed_budget_frac=0.1, seconds=0.1, device="cpu")
    if torch.cuda.is_available():
        return
    for fn in (run_serve_loop, tsmoke.run_decode_smoke,
               tsmoke.run_disagg_smoke):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(seconds=0.1) if fn is run_serve_loop else fn()


def test_spans_and_audit_across_mid_traffic_replan(smoke, tmp_path):
    cfg, book, params, _, _ = smoke
    tel = Telemetry(process="serve", trace=True)
    trace_p = tmp_path / "trace.json"
    metrics_p = tmp_path / "metrics.json"
    rep = run_serve_loop(seconds=1.5, n_clients=2, rate=8.0, seed=0,
                         shift_frac=0.5, control_period_ms=200.0,
                         setup=(cfg, book, params), telemetry=tel,
                         trace_out=str(trace_p),
                         metrics_dump=str(metrics_p))
    assert rep["served"] > 0 and rep["numerics_ok"]
    assert rep["timer_replans"] >= 1, f"no timer replan fired: {rep}"
    audit = rep["audit"]
    assert audit, "replan fired but the audit log is empty"
    for e in audit:
        assert e["triggers"], "audit entry without a trigger name"
        assert {"add", "keep", "remove"} <= set(e["diff"])
        assert e["replan_ms"] >= 0.0 and "window" in e
    stamped = [e for e in audit if e["apply_ms"] is not None]
    assert len(stamped) >= rep["timer_replans"]
    kinds = {s["name"] for s in tel.spans}
    assert {"ingest", "queue", "uplink", "exec", "request"} <= kinds
    n_request = sum(1 for s in tel.spans if s["name"] == "request")
    assert n_request >= rep["served"]
    trace = json.loads(trace_p.read_text())
    assert any(e["ph"] == "X" and e["name"] == "request"
               for e in trace["traceEvents"])
    dump = json.loads(metrics_p.read_text())
    assert dump["histograms"]["server/latency_ms"]["count"] >= rep["served"]
    assert dump["histograms"]["replan/apply_ms"]["count"] >= len(stamped)
    assert len(dump["audit"]) == len(audit)


# ----------------------------------------------------------------- decode

def _serve_decode(server, cfg, frags, prompts, max_new=5):
    served = []
    for i, toks in enumerate(prompts):
        f = frags[i % len(frags)]
        req = ServeRequest(client=f.client, tokens=toks,
                           max_new_tokens=max_new, tpot_budget_ms=2000.0)
        server.submit(req, 0, 4000.0)
        served.append((req, max_new))
    assert server.join(timeout=600.0), "decode run never drained"
    return served


def _decode_prompts(cfg, seed):
    rng = np.random.RandomState(seed)
    uniq = [rng.randint(0, cfg.vocab_size, 12).astype(np.int32)
            for _ in range(3)]
    return uniq + [uniq[0].copy()]           # one repeat -> reuse


def test_decode_and_disagg_serving_token_exact_against_jax(smoke):
    """Single-pool continuous batching and the disaggregated two-phase
    admit (prefill pool -> KV frame -> decode pool) through the server:
    both equal the JAX reference token for token, at least one KV
    handoff crosses the transport, and the repeated prompt finds its
    blocks resident on the decode arena."""
    cfg, book, params, jcfg, jp = smoke
    frags = tsmoke.smoke_fragments(cfg, 2, rate=30.0, seed=0)
    prompts = _decode_prompts(cfg, 7)
    outs = {}
    for disagg in (False, True):
        plan = (tsmoke.disagg_plan if disagg else tsmoke.decode_plan)(
            cfg, book, frags, batch=4)
        ex = GraftExecutor(plan, params, cfg, InProcessTransport(),
                           decode_ctx=64, kv_block_tokens=4,
                           decode_disagg=disagg, device="cpu")
        server = GraftServer(ex, book=book).start()
        try:
            served = _serve_decode(server, cfg, frags, prompts)
            outs[disagg] = [list(r.out_tokens) for r, _ in served]
            rep = server.report()
            stats = {s["role"]: s for s in ex.pool_stats().values()}
            check_decode_against_jax(jcfg, jp, served)
        finally:
            server.stop(drain=False, timeout=10.0)
            ex.close()
        assert rep["decode_local"] == 0 and rep["decode_served"] == 4
        assert all(r["ttft_ms"] > 0 for r in server.records()
                   if r.get("decode"))
    assert outs[False] == outs[True]
    assert rep["kv_handoffs"] >= 1 and rep["kv_handoff_ms"] > 0.0
    assert stats["prefill"]["prefill_exports"] >= len(prompts)
    assert stats["prefill"]["decode_active"] == 0
    dkv = stats["decode"]["kv"]
    assert stats["decode"]["kv_handoffs_in"] >= 1
    assert dkv["handoff_reused"] + dkv["prefix_hits"] >= 1
    assert dkv["active_seqs"] == 0


def test_forced_decode_local_equals_jax(smoke):
    """A pool that cannot decode (no ``decode_ctx``) refuses the
    admission; the server's counted escape hatch decodes in-process on
    the executor's device with the port's own modules, and its tokens
    equal the JAX reference."""
    cfg, book, params, jcfg, jp = smoke
    frags = tsmoke.smoke_fragments(cfg, 1, rate=30.0, seed=0)
    ex = GraftExecutor(tsmoke.decode_plan(cfg, book, frags), params, cfg,
                       InProcessTransport(), device="cpu")
    server = GraftServer(ex, book=book).start()
    try:
        served = _serve_decode(server, cfg, frags, _decode_prompts(cfg, 3)[:2],
                               max_new=4)
        rep = server.report()
    finally:
        server.stop(drain=False, timeout=10.0)
        ex.close()
    assert rep["decode_local"] == 2 and rep["decode_served"] == 2
    assert all(r["local"] for r in server.records())
    check_decode_against_jax(jcfg, jp, served)


def test_server_feeds_disagg_pressure_deltas(smoke):
    """The server reports the per-tick LOCAL fraction of decode
    completions, not a lifetime average."""
    class Probe:
        def __init__(self):
            self.fracs = []

        def observe_disagg_pressure(self, now_ms, frac):
            self.fracs.append(frac)

    cfg, book, params, _, _ = smoke
    ex = GraftExecutor(tsmoke.decode_plan(cfg, book,
                                          tsmoke.smoke_fragments(cfg, 2)),
                       params, cfg, InProcessTransport(), decode_ctx=32,
                       kv_block_tokens=4, device="cpu")
    server = GraftServer(ex, book=book)          # never started
    probe = Probe()
    try:
        server.controller = probe
        server.stats["decode_local"] = 3
        server.stats["decode_served"] = 4
        server._feed_disagg_pressure()
        assert probe.fracs == [0.75]
        server._feed_disagg_pressure()          # no new completions
        assert probe.fracs == [0.75]
        server.stats["decode_served"] = 8       # 4 new, all pool-served
        server._feed_disagg_pressure()
        assert probe.fracs == [0.75, 0.0]
    finally:
        ex.close()


def test_executor_server_plumbing(smoke):
    """Roles, prefill candidates, chips, new channels and the uplink
    sample queue that the server drives."""
    cfg, book, params, _, _ = smoke
    frags = tsmoke.smoke_fragments(cfg, 2, rate=30.0, seed=0)
    ex = GraftExecutor(tsmoke.disagg_plan(cfg, book, frags, batch=2),
                       params, cfg, InProcessTransport(), decode_ctx=32,
                       kv_block_tokens=4, decode_disagg=True, device="cpu")
    try:
        (dkey,) = ex.decode_pool_keys()
        assert ex.pool_role(dkey) == "decode"
        assert ex.pool_role(("nope", 0, 1)) == "both"
        assert ex.prefill_pool_keys() == ex.prefill_pool_keys(dkey[:3])
        assert all(ex.pool_role(k) in ("prefill", "both")
                   for k in ex.prefill_pool_keys())
        assert ex.chips_of(dkey) == list(ex.placement.chips_of(dkey))
        h = ex.open_handle(dkey)
        assert h is not ex.handle(dkey) and h.queue_len() == 0
        h.close()
        with pytest.raises(KeyError):
            ex.open_handle(("nope", 0, 1))
        for i in range(5):
            ex.record_uplink(f"c{i % 2}", 100.0 * i, 0.5)
        assert ex.drain_uplink() == [(f"c{i % 2}", 100.0 * i, 0.5)
                                     for i in range(5)]
        assert ex.drain_uplink() == []
        assert ex._wire_extras(ServeRequest("c0", None)) is None
        assert ex.merge_telemetry() == 0         # telemetry off
    finally:
        ex.close()


# ------------------------------------------------------- ci_torch smokes

@pytest.mark.parametrize("disagg", [False, True])
def test_ci_decode_smokes_on_cpu(disagg):
    fn = tsmoke.run_disagg_smoke if disagg else tsmoke.run_decode_smoke
    rep = fn(n_requests=6, n_clients=2, max_new=4, seq_len=8, seed=1,
             device="cpu")
    assert rep["numerics_ok"], rep.get("numerics_error")
    assert rep["decode_served"] == 6 and rep["decode_local"] == 0
    assert rep["decode"]["tokens"] == 24
    assert rep["decode"]["ttft_p50_ms"] > 0
    assert (rep["kv_handoffs"] >= 1) if disagg else \
        (rep["kv"].get("prefix_hits", 0) >= 1)
