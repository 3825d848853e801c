"""The port's numpy-only serving modules against their JAX-package
originals, on the CPU, exactly.

Bandwidth traces, the Neurosurgeon partitioner, mobile clients, the
incremental planner, the micro-batcher and shed policy, the
discrete-event simulator, the serving controller and the router are
copies of the originals with their imports renamed; the controller
adds ``revert``, which its own test covers. The same seeded
inputs go through both and must give equal results: equal arrays, equal
decisions, equal plans, equal latencies. The profile books are built
from the same layer costs at the same rates (the port's cost model
states H100 figures, the reference's TPU ones, so the rates are set
equal here).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import Fragment as JFragment
from repro.core import GraftPlanner as JPlanner
from repro.core import default_book as j_default_book
from repro.core.plandiff import plan_pools as j_plan_pools
from repro.core.reuse import IncrementalPlanner as JIncremental
from repro.core.reuse import fragment_signature as j_signature
from repro.data.traces import synth_5g_trace as j_synth
from repro.serving import batcher as jb
from repro.serving import router as jr
from repro.serving.clients import fleet_fragments as j_fleet_fragments
from repro.serving.clients import make_fleet as j_make_fleet
from repro.serving.controller import ServingController as JController
from repro.serving.neurosurgeon import partition as j_partition
from repro.serving.simulator import simulate as j_simulate
from repro_torch.core import Fragment, GraftPlanner
from repro_torch.core.costmodel import LayerCosts
from repro_torch.core.plandiff import plan_pools
from repro_torch.core.profiles import ProfileBook
from repro_torch.core.reuse import IncrementalPlanner, fragment_signature
from repro_torch.data import BandwidthTrace, synth_5g_trace
from repro_torch.serving import batcher as tb
from repro_torch.serving import router as tr
from repro_torch.serving import (ServingController, fleet_fragments,
                                 make_fleet, partition, simulate)


@pytest.fixture(scope="module")
def books():
    """(JAX book, port book): the reference's default book and a port
    book over the same layer costs at the same rates."""
    jbook = j_default_book()
    book = ProfileBook()
    for name, jprof in jbook._profiles.items():
        c = jprof.costs
        prof = book.add(LayerCosts(**{f.name: getattr(c, f.name)
                                      for f in dataclasses.fields(c)}))
        prof.cf, prof.cm = jprof.cf, jprof.cm
    return jbook, book


def _frag_tuple(f):
    return None if f is None else (f.model, f.p, f.t, f.q, f.client,
                                   f.device)


def _pools(pools):
    return {k: (s.share, s.batch, s.n_instances, s.role)
            for k, s in pools.items()}


# ------------------------------------------------------- traces, clients

@pytest.mark.parametrize("kw", [{}, {"seed": 7, "sigma": 0.6,
                                     "fade_prob": 0.05},
                                {"seed": 3, "seconds": 90,
                                 "mean_mbps": 40.0, "fade_depth": 0.2}])
def test_synth_5g_trace_equals_jax(kw):
    got, want = synth_5g_trace(**kw), j_synth(**kw)
    assert isinstance(got, BandwidthTrace)
    np.testing.assert_array_equal(got.samples, want.samples)
    for t in (0.0, 3.7, 59.0, 1234.5):
        assert got.at(t) == want.at(t)
        assert got.window_mean(t) == want.window_mean(t)
    assert got.mean == want.mean


def test_make_fleet_and_fragments_equal_jax(books):
    jbook, book = books
    kw = dict(n_nano=4, n_tx2=2, rate=30.0, seed=17,
              trace_kw={"sigma": 0.6, "fade_prob": 0.05})
    fleet, jfleet = make_fleet("inc", book, **kw), \
        j_make_fleet("inc", jbook, **kw)
    assert [(c.name, c.device, c.rate, c.slo_ratio) for c in fleet] == \
        [(c.name, c.device, c.rate, c.slo_ratio) for c in jfleet]
    for c, jc in zip(fleet, jfleet):
        np.testing.assert_array_equal(c.trace.samples, jc.trace.samples)
        assert c.slo_ms(book) == jc.slo_ms(jbook)
    for t in (0.0, 5.0, 33.0):
        for avg in (False, True):
            assert [_frag_tuple(f) for f in fleet_fragments(
                fleet, book, t, use_average_bw=avg)] == \
                [_frag_tuple(f) for f in j_fleet_fragments(
                    jfleet, jbook, t, use_average_bw=avg)]


@pytest.mark.parametrize("model", ["inc", "mob", "vgg", "res", "qwen3-1.7b"])
def test_partition_decisions_equal_jax(books, model):
    jbook, book = books
    for device in ("nano", "tx2"):
        for bw in (1e5, 2.5e6, 4e7, 7.5e7):
            for slo in (20.0, 80.0, 400.0):
                got = partition(book[model], device, bw, slo)
                want = j_partition(jbook[model], device, bw, slo)
                assert dataclasses.astuple(got) == \
                    dataclasses.astuple(want)


# --------------------------------------------------------------- planner

def test_fragment_signature_equals_jax():
    for p, t, q in [(0, 80.0, 30.0), (3, 4.99, 1.0), (5, 5.0, 0.0),
                    (2, 123.4, 7.0)]:
        for quantum in (1.0, 5.0, 12.5):
            assert fragment_signature(Fragment("m", p, t, q, client="a"),
                                      quantum) == \
                j_signature(JFragment("m", p, t, q, client="a"), quantum)


def test_incremental_planner_plans_equal_jax(books):
    """A sequence of replans with arrivals, departures, partition shifts
    and rate changes: the same pools (keys and allocations), the same
    total resource, the same shadow hits and misses."""
    jbook, book = books
    inc, jinc = IncrementalPlanner(book), JIncremental(jbook)
    rng = np.random.RandomState(11)
    L = book["inc"].costs.n_layers
    spec = [(int(rng.randint(0, L - 1)), float(rng.uniform(60, 120)),
             float(rng.uniform(5, 40))) for _ in range(6)]
    for step in range(6):
        if step:
            i = int(rng.randint(len(spec)))
            p, t, q = spec[i]
            spec[i] = (int(rng.randint(0, L - 1)) if step % 2 else p, t,
                       q * float(rng.uniform(0.5, 2.0)))
            if step == 3:
                spec.append((1, 90.0, 20.0))
            if step == 4:
                spec.pop(0)
        frags = [Fragment("inc", p, t, q, client=f"c{i}")
                 for i, (p, t, q) in enumerate(spec)]
        jfrags = [JFragment("inc", p, t, q, client=f"c{i}")
                  for i, (p, t, q) in enumerate(spec)]
        plan, jplan = inc.plan(frags), jinc.plan(jfrags)
        assert _pools(plan_pools(plan)) == _pools(j_plan_pools(jplan))
        assert plan.total_resource == jplan.total_resource
        assert plan.meta == jplan.meta
        assert inc.stats == jinc.stats


# ------------------------------------------------- micro-batcher and shed

def _items(mod, spec):
    return [mod.BatchItem(rid=rid, client=f"c{rid % 3}", payload=rid,
                          flush_ms=flush, deadline_ms=flush + 40.0,
                          hop_charge_ms=hop, n_tokens=ntok)
            for rid, flush, hop, ntok in spec]


@pytest.mark.parametrize("max_batch,max_tokens", [(1, 0), (3, 0), (8, 48),
                                                  (4, 20)])
def test_microbatcher_close_order_equals_jax(max_batch, max_tokens):
    """One scripted sequence of puts, closes, takes, steals and a drain:
    the same batches in the same order, the same pending charges and the
    same close statistics."""
    rng = np.random.RandomState(max_batch * 31 + max_tokens)
    b = tb.MicroBatcher(max_batch, max_tokens=max_tokens)
    jbat = jb.MicroBatcher(max_batch, max_tokens=max_tokens)
    rid, now = 0, 0.0
    for step in range(40):
        spec = []
        for _ in range(int(rng.randint(0, 4))):
            spec.append((rid, now + float(rng.uniform(0, 30)),
                         float(rng.uniform(0, 3)), int(rng.randint(1, 24))))
            rid += 1
        if step % 5 == 0:
            b.put_many(_items(tb, spec))
            jbat.put_many(_items(jb, spec))
        else:
            for it, jit in zip(_items(tb, spec), _items(jb, spec)):
                b.put(it)
                jbat.put(jit)
        now += float(rng.uniform(0, 12))
        if step % 7 == 3:
            got, want = b.take(2), jbat.take(2)
        elif step % 11 == 5:
            got, want = b.steal(2), jbat.steal(2)
        else:
            got, want = b.pop_ready(now), jbat.pop_ready(now)
        assert [it.rid for it in got] == [it.rid for it in want]
        assert b.pending_hop_ms == jbat.pending_hop_ms
        assert b.n_due(now) == jbat.n_due(now)
        assert b.next_flush_ms() == jbat.next_flush_ms()
        assert len(b) == len(jbat)
    assert [it.rid for it in b.drain()] == [it.rid for it in jbat.drain()]
    assert dataclasses.astuple(b.stats) == dataclasses.astuple(jbat.stats)


def test_flush_deadline_and_hopeless_equal_jax():
    rng = np.random.RandomState(5)
    assert tb.INTER_HOP_MS == jb.INTER_HOP_MS
    for _ in range(200):
        costs = list(rng.uniform(0.5, 30, size=int(rng.randint(1, 4))))
        idx = int(rng.randint(0, len(costs)))
        hop = float(rng.uniform(0, 40))
        now = float(rng.uniform(0, 100))
        dl = float(rng.uniform(0, 200))
        assert tb.remaining_cost_ms(costs, idx, hop_ms=hop) == \
            jb.remaining_cost_ms(costs, idx, hop_ms=hop)
        assert tb.flush_deadline_ms(dl, costs, idx, now, hop_ms=hop) == \
            jb.flush_deadline_ms(dl, costs, idx, now, hop_ms=hop)
        est = float(rng.uniform(0, 150))
        assert tb.hopeless(now, dl, est) == jb.hopeless(now, dl, est)
        assert tb.ShedPolicy.hopeless(now, dl, est) == \
            jb.ShedPolicy.hopeless(now, dl, est)
        ttft_dl, tpot, left = now + float(rng.uniform(0, 60)), \
            float(rng.uniform(1, 20)), int(rng.randint(0, 40))
        assert tb.ShedPolicy.hopeless_decode(now, ttft_dl, est, dl, tpot,
                                             left) == \
            jb.ShedPolicy.hopeless_decode(now, ttft_dl, est, dl, tpot, left)


@pytest.mark.parametrize("budget", [0.0, 0.1, 0.25, 1.0])
def test_shed_policy_verdicts_equal_jax(budget):
    rng = np.random.RandomState(int(budget * 100) + 1)
    pol = tb.ShedPolicy(budget_frac=budget, window=16)
    jpol = jb.ShedPolicy(budget_frac=budget, window=16)
    for _ in range(300):
        client = f"c{int(rng.randint(3))}"
        weight = int(rng.randint(1, 20))
        if rng.rand() < 0.5:
            pol.note_admitted(client, weight=weight)
            jpol.note_admitted(client, weight=weight)
        else:
            assert pol.should_shed(client, charge=weight) == \
                jpol.should_shed(client, charge=weight)
        assert pol.shed_frac(client) == jpol.shed_frac(client)
    assert pol.stats == jpol.stats


# ------------------------------------------------------------ controller

def _strip(entry):
    """An audit entry without its wall-clock timings."""
    return {k: v for k, v in entry.items()
            if k not in ("replan_ms", "apply_ms", "t_wall")}


def test_controller_triggers_and_audit_equal_jax(books):
    """One scripted sequence of observations (arrivals with uplink
    samples, a fading link, completions near the budget, sheds, decode
    samples, disagg pressure, a partition shift, a new client): both
    controllers fire the same triggers at the same ticks, plan the same
    pools, and write the same audit (less its wall-clock timings)."""
    jbook, book = books
    kw = dict(control_period_ms=250.0, min_replan_interval_ms=500.0,
              window_ms=3000.0)
    ctl = ServingController(book, planner=GraftPlanner(book), **kw)
    jctl = JController(jbook, planner=JPlanner(jbook), **kw)
    spec = [("a", 2, 80.0, 30.0), ("b", 4, 90.0, 20.0), ("c", 1, 70.0, 10.0)]
    ctl.bootstrap([Fragment("inc", p, t, q, client=c)
                   for c, p, t, q in spec], now_ms=0.0)
    jctl.bootstrap([JFragment("inc", p, t, q, client=c)
                    for c, p, t, q in spec], now_ms=0.0)
    rng = np.random.RandomState(9)
    t, fired = 0.0, []
    while t < 12000.0:
        for c, p, budget, q in spec:
            if rng.rand() > q / 60.0:
                continue
            if c == "b" and t > 6000.0:
                p = 5                                   # partition shift
            if c == "c" and t > 9000.0:
                continue                                # departs
            bw = 2.5e6 * (1.0 - (0.7 * t / 12000.0 if c == "a" else 0.0))
            for x in (ctl, jctl):
                x.observe_arrival(t, c, "inc", p, budget,
                                  xfer_bytes=bw * 0.01, xfer_ms=10.0)
                x.observe_done(t + 5.0, c, budget * (0.5 + 0.5 * t / 12000),
                               budget_ms=budget)
                x.observe_decode(t + 5.0, c, 0.4 * budget, 8.0, budget, 20.0)
            if rng.rand() < 0.05:
                for x in (ctl, jctl):
                    x.observe_shed(t, c)
        if 7000.0 < t < 7400.0:
            for x in (ctl, jctl):
                x.observe_arrival(t, "d", "inc", 3, 60.0)       # arrival
                x.observe_disagg_pressure(t, 0.6)
                x.ingest_uplink(t, [("d", 1e5, 4.0)])
        if int(t) % 250 == 0:
            plan, jplan = ctl.control(t), jctl.control(t)
            assert (plan is None) == (jplan is None), t
            if plan is not None:
                fired.append(t)
                assert _pools(plan_pools(plan)) == \
                    _pools(j_plan_pools(jplan))
                ctl.note_apply(1.0)
                jctl.note_apply(1.0)
            e, je = ctl.estimates(t), jctl.estimates(t)
            assert {k: dataclasses.astuple(v) for k, v in e.items()} == \
                {k: dataclasses.astuple(v) for k, v in je.items()}
        t += 10.0
    assert len(fired) >= 3
    assert ctl.stats["triggers"] == jctl.stats["triggers"]
    assert ctl.log == jctl.log
    assert [_strip(e) for e in ctl.audit] == [_strip(e) for e in jctl.audit]
    for name in ("partition_shift", "fragment_arrival"):
        assert ctl.stats["triggers"].get(name, 0) >= 1, ctl.stats


def test_controller_revert_restores_the_deployed_plan(books):
    """``revert`` (the port's addition, called by its server when a
    replan cannot be applied) puts back the plan, planned rates, points
    and bandwidth anchors the last ``control`` replaced, marks the audit
    entry, and lets the same trigger fire again; a second call does
    nothing."""
    _, book = books
    ctl = ServingController(book, planner=GraftPlanner(book),
                            min_replan_interval_ms=500.0, window_ms=1000.0)
    frags = [Fragment("inc", 2, 80.0, 30.0, client="a"),
             Fragment("inc", 4, 90.0, 20.0, client="b")]
    plan0 = ctl.bootstrap(frags, now_ms=0.0)
    before = (dict(ctl._planned_q), dict(ctl._planned_p),
              dict(ctl._planned_bw))
    for t in (2200.0, 2500.0, 2800.0):
        ctl.observe_arrival(t, "a", "inc", 2, 80.0)
    plan = ctl.control(3000.0)                  # b departed
    assert plan is not None and ctl.current_plan is plan
    assert "b" not in ctl._planned_q
    ctl.revert("refused")
    assert ctl.current_plan is plan0 and ctl.stats["refused"] == 1
    assert (ctl._planned_q, ctl._planned_p, ctl._planned_bw) == before
    assert ctl.audit[-1]["refused"] == "refused"
    ctl.revert("again")                         # nothing left to undo
    assert ctl.stats["refused"] == 1 and ctl.current_plan is plan0
    assert ctl.control(3200.0) is None          # inside the interval
    again = ctl.control(3600.0)
    assert again is not None and "refused" not in ctl.audit[-1]
    assert ctl.stats["triggers"]["fragment_departure"] == 2
    assert _pools(plan_pools(again)) == _pools(plan_pools(plan))


def test_online_simulation_equals_jax(books):
    """``simulate`` driven by the controller (seed 3): the same
    per-client latencies and drops, the same replans."""
    jbook, book = books
    kw = dict(n_nano=6, rate=30.0, seed=17,
              trace_kw={"sigma": 0.6, "fade_prob": 0.05})
    fleet, jfleet = make_fleet("inc", book, **kw), \
        j_make_fleet("inc", jbook, **kw)
    ctl = ServingController(book, planner=IncrementalPlanner(book))
    jctl = JController(jbook, planner=JIncremental(jbook))
    plan0 = ctl.bootstrap(fleet_fragments(fleet, book, t=0.0))
    jplan0 = jctl.bootstrap(j_fleet_fragments(jfleet, jbook, t=0.0))
    res = simulate(plan0, fleet, book, duration_s=8.0, t0=0.0,
                   controller=ctl, seed=3)
    jres = j_simulate(jplan0, jfleet, jbook, duration_s=8.0, t0=0.0,
                      controller=jctl, seed=3)
    assert res.latencies_ms.keys() == jres.latencies_ms.keys()
    for c in res.latencies_ms:
        np.testing.assert_array_equal(res.latencies_ms[c],
                                      jres.latencies_ms[c])
    assert res.drops == jres.drops
    assert res.slo_ms == jres.slo_ms
    assert res.meta["n_requests"] == jres.meta["n_requests"]
    assert res.meta["controller"]["replans"] == \
        jres.meta["controller"]["replans"] >= 1
    assert ctl.stats["triggers"] == jctl.stats["triggers"]
    done = sum(len(v) for v in res.latencies_ms.values())
    assert done + sum(res.drops.values()) == res.meta["n_requests"]


# ---------------------------------------------------------------- router

def test_router_picks_equal_jax():
    rng = np.random.RandomState(2)
    fes = ["fe0", "fe1", "fe2", "fe3"]
    for i in range(50):
        client = f"client{i}"
        for k in (1, 2, 4):
            assert tr.rendezvous_route(client, fes[:k]) == \
                jr.rendezvous_route(client, fes[:k])
    assert tr.rendezvous_table([f"x{i}" for i in range(20)], fes) == \
        jr.rendezvous_table([f"x{i}" for i in range(20)], fes)
    for _ in range(50):
        dig = tuple(int(x) for x in rng.randint(0, 30, size=4))
        res = frozenset(int(x) for x in rng.randint(0, 30, size=8))
        assert tr.affinity_overlap(dig, res) == jr.affinity_overlap(dig, res)
    assert tr.affinity_overlap((), res) == jr.affinity_overlap((), res) == 0

    r, jrt = tr.WeightedRouter(), jr.WeightedRouter()
    now = 0.0
    for step in range(200):
        if step % 10 == 0:
            for fe in fes[:3 if step < 100 else 4]:
                kw = dict(now_ms=now,
                          queue_depth_ms=float(rng.uniform(0, 80)),
                          shed_frac=float(rng.uniform(0, 0.3)),
                          unhealthy=bool(rng.rand() < 0.1),
                          affinity=[int(x) for x in
                                    rng.randint(0, 30, size=5)])
                r.update(fe, **kw)
                jrt.update(fe, **kw)
        if step == 150:
            r.forget("fe1")
            jrt.forget("fe1")
        live = [fe for fe in fes[:3 if step < 100 else 4]
                if step < 150 or fe != "fe1"]
        digest = tuple(int(x) for x in rng.randint(0, 30, size=3)) \
            if rng.rand() < 0.5 else None
        client = f"c{int(rng.randint(8))}"
        assert r.route(client, live, now_ms=now, digest=digest) == \
            jrt.route(client, live, now_ms=now, digest=digest)
        now += float(rng.uniform(0, 120))
    assert r.stats == jrt.stats
    assert r.queue_depths() == jrt.queue_depths()
