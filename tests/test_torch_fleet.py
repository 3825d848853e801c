"""The port's GraftFleet against the JAX package, on the CPU.

Mirrors ``tests/test_fleet.py`` (consistent routing, the weighted router,
cross-front-end result hand-off, drain-on-remove, work stealing, the
admission-control/shed policy, pad-to-bucket shape hygiene and
migration-aware placement) and the fleet tests of ``tests/test_faults.py``
(a partitioned front-end, a wedged front-end healed by stealing), on the
JAX smoke model's weights converted by ``from_jax_params``, with
``FakeClock`` where the originals use it. Every served one-shot result is
held against the JAX monolithic forward (``atol=5e-5, rtol=1e-3``), every
decode stream against the JAX ``reference_decode`` token for token.

``test_fleet_refused_apply_reverts_the_controller_and_is_retried``
drives a replan that would strand a client's work through JAX's
``GraftFleet.tick`` (the controller keeps the refused plan while the
pools keep the old one, or the queued work finishes locally) and through
the port's (refused before anything changes, the controller reverted,
the replan applied on a later tick).
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import FakeClock, wait_until
from repro import models as JM
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke_config
from repro.configs import reduced as j_reduced
from repro.serving import fleet as jfleet
from repro.serving import smoke as jsmoke
from repro_torch.core import Fragment, GraftPlanner
from repro_torch.core.placement import MigrationAction, migrate, place_pools
from repro_torch.core.plandiff import PoolSpec, diff_plans, plan_pools
from repro_torch.models import from_jax_params, n_fragment_units
from repro_torch.serving import (GraftExecutor, GraftFleet, GraftServer,
                                 ServeRequest, WeightedRouter)
from repro_torch.serving.batcher import (ShedPolicy, bucket_size, hopeless,
                                         remaining_cost_ms)
from repro_torch.serving.controller import ServingController
from repro_torch.serving.executor import FragmentInstance
from repro_torch.serving.fleet import rendezvous_route, rendezvous_table
from repro_torch.serving.smoke import mixed_depth_plan, smoke_setup
from repro_torch.serving.transport import (Channel, InProcessTransport,
                                           Transport)

ARCH = "qwen3-1.7b"
ATOL, RTOL = 5e-5, 1e-3


# --------------------------------------------------------------- harness

class FlakyChannel(Channel):
    """Wraps a channel with an injectable partition switch."""

    def __init__(self, inner: Channel):
        super().__init__(inner.name)
        self._inner = inner
        self.stats = inner.stats
        self.broken = False

    def request(self, msg: dict) -> dict:
        if self.broken:
            raise ConnectionResetError(
                f"injected partition on channel {self.name}")
        return self._inner.request(msg)

    def close(self) -> None:
        self._inner.close()


class FlakyTransport(Transport):
    """Every connected channel is a FlakyChannel the test can partition."""

    def __init__(self, inner: Transport):
        self.inner = inner
        self.channels: list = []

    def serve(self, name, handler):
        return self.inner.serve(name, handler)

    def connect(self, name) -> FlakyChannel:
        ch = FlakyChannel(self.inner.connect(name))
        self.channels.append(ch)
        return ch

    def stop(self, name) -> None:
        self.inner.stop(name)

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, item):
        return getattr(self.inner, item)


def _twin(jcfg, n_layers=None):
    """(port cfg, port book, port params, JAX cfg, JAX params)."""
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg, book, _ = smoke_setup(ARCH, n_layers=n_layers, seed=0,
                               device="cpu")
    assert cfg.n_layers == jcfg.n_layers
    return cfg, book, from_jax_params(jax.device_get(jp)), jcfg, jp


@pytest.fixture(scope="module")
def smoke():
    return _twin(j_smoke_config(ARCH))


@pytest.fixture(scope="module")
def deep():
    return _twin(j_reduced(j_get_config(ARCH), n_layers=3), n_layers=3)


def check_against_jax(jcfg, jp, reqs):
    assert reqs
    for req, _p in reqs:
        assert isinstance(req.result, torch.Tensor), req.client
        want, _ = JM.forward(jp, jcfg, np.asarray(req.tokens)[None])
        np.testing.assert_allclose(req.result.float().numpy(),
                                   np.asarray(want[0]), atol=ATOL, rtol=RTOL)


def check_decode_against_jax(jcfg, jp, served):
    assert served
    for req, max_new in served:
        want = jsmoke.reference_decode(jcfg, jp, req.tokens, max_new)
        assert list(req.out_tokens or []) == want, req.client


def _requests(cfg, frags, rng, n_per_client=2):
    out = []
    for _ in range(n_per_client):
        for f in frags:
            out.append((ServeRequest(client=f.client, tokens=rng.randint(
                0, cfg.vocab_size, 16).astype(np.int32)), f.p))
    return out


def _spread_frags(cfg, fleet_names, n_per_fe=2, budget=80.0):
    """Fragments whose client names rendezvous-route across ALL the given
    front-ends."""
    got = {fe: 0 for fe in fleet_names}
    frags, i = [], 0
    while min(got.values()) < n_per_fe and i < 10_000:
        name = f"cl{i}"
        fe = rendezvous_route(name, fleet_names)
        if got[fe] < n_per_fe:
            got[fe] += 1
            frags.append(Fragment(cfg.name, p=len(frags) % 2, t=budget,
                                  q=30.0, client=name))
        i += 1
    return frags


def _shared_pool_frags(cfg, fes, *, p=1):
    """One client per front-end, all entering the SAME shared pool."""
    got, frags, i = {fe: 0 for fe in fes}, [], 0
    while min(got.values()) < 1 and i < 10_000:
        name = f"fp{i}"
        fe = rendezvous_route(name, fes)
        if got[fe] < 1:
            got[fe] += 1
            frags.append(Fragment(cfg.name, p=p, t=5000.0, q=30.0,
                                  client=name))
        i += 1
    return frags


def _fleet(smoke, frags, n=2, plan=None, **kw):
    cfg, book, params, _, _ = smoke
    ex = GraftExecutor(plan or GraftPlanner(book).plan(frags), params, cfg,
                       device="cpu")
    return ex, GraftFleet(ex, n_frontends=n, book=book, **kw).start()


# --------------------------------------------------------- routing (pure)

def test_rendezvous_routing_is_deterministic_and_minimal_movement():
    clients = [f"client-{i}" for i in range(64)]
    fes = ["fe0", "fe1", "fe2"]
    t1 = rendezvous_table(clients, fes)
    assert t1 == rendezvous_table(clients, list(reversed(fes)))
    assert t1 == jfleet.rendezvous_table(clients, fes)   # the reference's
    assert set(t1.values()) == set(fes)
    t2 = rendezvous_table(clients, fes + ["fe3"])
    for c in clients:
        assert t2[c] == t1[c] or t2[c] == "fe3"
    assert any(t2[c] == "fe3" for c in clients)
    t3 = rendezvous_table(clients, ["fe0", "fe1"])
    for c in clients:
        if t1[c] != "fe2":
            assert t3[c] == t1[c]
        else:
            assert t3[c] in ("fe0", "fe1")
    with pytest.raises(ValueError):
        rendezvous_route("c", [])


# -------------------------------------------------- weighted router (pure)

def test_weighted_router_scores_load_health_and_falls_back():
    r = WeightedRouter(hysteresis_ms=10.0)
    fes = ["fe0", "fe1"]
    hrw = rendezvous_route("c", fes)
    other = "fe1" if hrw == "fe0" else "fe0"
    assert r.route("c", fes, now_ms=0.0) == hrw
    assert r.stats["fallback_hrw"] == 1
    r.update("fe0", now_ms=0.0)
    r.update("fe1", now_ms=0.0)
    assert r.route("c", fes, now_ms=0.0) == hrw
    r.update(hrw, now_ms=0.0, queue_depth_ms=100.0)
    assert r.route("c", fes, now_ms=0.0) == other
    assert r.stats["moves"] == 1
    r.update(hrw, now_ms=0.0, queue_depth_ms=0.0)
    r.update(other, now_ms=0.0, queue_depth_ms=5.0)
    assert r.route("c", fes, now_ms=0.0) == other
    r.update(other, now_ms=0.0, queue_depth_ms=50.0)
    assert r.route("c", fes, now_ms=0.0) == hrw
    r.update(hrw, now_ms=0.0, unhealthy=True)
    assert r.route("c", fes, now_ms=0.0) == other
    assert r.route("c", fes, now_ms=5000.0) == hrw
    assert r.stats["fallback_hrw"] == 2
    r2 = WeightedRouter(hysteresis_ms=0.0)
    r2.update(hrw, now_ms=0.0, shed_frac=0.5)
    r2.update(other, now_ms=0.0)
    assert r2.route("c", fes, now_ms=0.0) == other
    assert r.route("c", ["fe0"], now_ms=0.0) == "fe0"


def test_weighted_router_pending_load_spreads_a_burst():
    r = WeightedRouter(hysteresis_ms=25.0, pending_cost_ms=25.0)
    fes = ["fe0", "fe1"]
    r.update("fe0", now_ms=0.0)
    r.update("fe1", now_ms=0.0)
    got = [r.route("hot", fes, now_ms=0.0) for _ in range(8)]
    assert got.count("fe0") == got.count("fe1") == 4
    r.update("fe0", now_ms=1.0)
    r.update("fe1", now_ms=1.0)
    assert r.route("hot", fes, now_ms=1.0) == rendezvous_route("hot", fes)


def test_weighted_router_affinity_attracts_repeat_prompts():
    r = WeightedRouter(hysteresis_ms=0.0, affinity_bonus_ms=10.0)
    fes = ["fe0", "fe1"]
    hrw = rendezvous_route("c", fes)
    other = "fe1" if hrw == "fe0" else "fe0"
    r.update(hrw, now_ms=0.0)
    r.update(other, now_ms=0.0, affinity=(11, 22, 33))
    assert r.route("c", fes, now_ms=0.0, digest=(11, 22)) == other
    assert r.stats["affinity_hits"] == 1
    r.update(hrw, now_ms=0.0)
    r.update(other, now_ms=0.0, affinity=(11, 22, 33))
    assert r.route("c2", fes, now_ms=0.0, digest=(44,)) \
        == rendezvous_route("c2", fes)
    r.forget(other)
    assert r.signal(other) is None
    assert r.route("c", fes, now_ms=0.0) == hrw


# ------------------------------------------------------ shed policy (pure)

def test_hopeless_boundary_is_strict():
    assert not hopeless(now_ms=10.0, deadline_ms=15.0, est_remaining_ms=5.0)
    assert hopeless(now_ms=10.0, deadline_ms=15.0, est_remaining_ms=5.0001)
    assert not hopeless(now_ms=0.0, deadline_ms=0.0, est_remaining_ms=0.0)


def test_shed_policy_window_counts_requests_and_respects_budget():
    pol = ShedPolicy(budget_frac=0.5, window=8)
    pol.note_admitted("c")
    assert pol.should_shed("c") is True
    assert pol.should_shed("c") is False
    assert pol.stats["budget_admits"] == 1
    assert pol.should_shed("c") is True
    assert pol.shed_frac("c") <= 0.5
    assert pol.should_shed("other") is False
    total = ShedPolicy(budget_frac=1.0, window=4)
    assert all(total.should_shed("x") for _ in range(6))


def test_shed_policy_budget_exhausted_must_admit():
    pol = ShedPolicy(budget_frac=0.25, window=8)
    seq = [pol.should_shed("c") for _ in range(16)]
    assert seq.count(False) >= 11
    assert seq.count(True) >= 1
    assert pol.shed_frac("c") <= 0.25 + 1 / 8
    assert pol.stats["shed"] + pol.stats["admitted"] == 16


# -------------------------------------------------------- buckets (pure)

def test_bucket_size_pads_to_powers_of_two_capped():
    assert bucket_size(1, 8) == 1
    assert bucket_size(3, 8) == 4
    assert bucket_size(5, 8) == 8
    assert bucket_size(8, 8) == 8
    assert bucket_size(5, 6) == 6
    assert bucket_size(2, 1) == 2
    assert bucket_size(0, 4) == 1
    assert len({bucket_size(n, 16) for n in range(1, 17)}) == 5


# ------------------------------------------------- placement migration

def _pools(*specs):
    return {s.key: s for s in specs}


def test_migrate_keeps_unchanged_instances_on_their_chips():
    old = _pools(PoolSpec(("m", 0, 2), 50, 4, 2),
                 PoolSpec(("m", 2, 4), 50, 2, 1))
    pl = place_pools(old)
    before = dict(pl.assignments)
    new = _pools(PoolSpec(("m", 0, 2), 50, 4, 4),
                 PoolSpec(("m", 2, 4), 50, 2, 1),
                 PoolSpec(("n", 0, 4), 60, 1, 1))
    pl2, actions = migrate(pl, diff_plans(old, new))
    for inst, chip in before.items():
        assert pl2.assignments[inst] == chip, f"{inst} moved"
    kinds = [a.kind for a in actions]
    assert kinds.count("spawn") == 3 and "retire" not in kinds \
        and "move" not in kinds
    assert set(pl2.assignments.values()) >= set(before.values())
    for chip in pl2.chips:
        assert chip.used <= 100


def test_migrate_retires_and_moves_only_what_changed():
    old = _pools(PoolSpec(("m", 0, 2), 60, 4, 2),
                 PoolSpec(("m", 2, 4), 40, 2, 2))
    pl = place_pools(old)
    new = _pools(PoolSpec(("m", 0, 2), 60, 4, 1),
                 PoolSpec(("m", 2, 4), 70, 2, 2))
    pl2, actions = migrate(pl, diff_plans(old, new))
    kinds = {}
    for a in actions:
        kinds.setdefault(a.kind, []).append(a)
    assert [a.instance for a in kinds["retire"]] == [1]
    assert all(isinstance(a, MigrationAction) for a in actions)
    assert pl2.assignments[(("m", 0, 2), 0)] == \
        pl.assignments[(("m", 0, 2), 0)]
    for a in kinds.get("move", []):
        assert a.from_chip is not None and a.from_chip != a.chip
    for chip in pl2.chips:
        assert chip.used <= 100
    pl3, acts3 = migrate(pl2, diff_plans(new, {}))
    assert pl3.assignments == {} and \
        all(a.kind == "retire" for a in acts3)


# ------------------------------------------------------------ the fleet

def test_fleet_serves_across_frontends_exactly(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = _spread_frags(cfg, ["fe0", "fe1"], n_per_fe=2)
    ex, fleet = _fleet(smoke, frags)
    try:
        table = fleet.routing_table([f.client for f in frags])
        assert set(table.values()) == {"fe0", "fe1"}
        reqs = _requests(cfg, frags, np.random.RandomState(0),
                         n_per_client=3)
        for req, p in reqs:
            fleet.submit(req, p, 80.0)
        assert fleet.join(timeout=300.0), "fleet never drained"
        check_against_jax(jcfg, jp, reqs)
        rep = fleet.report()
        assert rep["served"] == len(reqs) and rep["shed"] == 0
        assert sum(fe["served"] for fe in rep["frontends"].values()) \
            == len(reqs)
        assert all(fe["ingest_threads"] >= 1
                   for fe in rep["frontends"].values())
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


def test_fleet_cross_frontend_result_handoff(smoke):
    cfg, book, params, jcfg, jp = smoke
    L = n_fragment_units(cfg)
    frags = _spread_frags(cfg, ["fe0", "fe1"], n_per_fe=1)
    ex, fleet = _fleet(smoke, frags, clock=FakeClock())
    try:
        f = frags[0]
        owner = fleet.route(f.client)
        key = ex.chain_keys(f.client)[0]
        owner.driver(key).batcher.pause()
        rng = np.random.RandomState(3)
        req = ServeRequest(client=f.client, tokens=rng.randint(
            0, cfg.vocab_size, 16).astype(np.int32))
        rid = fleet.submit(req, f.p, 80.0)
        wait_until(lambda: len(owner.driver(key).batcher) >= 1,
                   desc="request to queue on the paused batcher")
        assert fleet.registry[rid] is owner
        [item] = owner.driver(key).batcher.drain()
        y = ex.fragment_fn(key[1], L)(
            params, inputs=torch.as_tensor(item.payload)[None],
            extras=None)[0]
        fleet._dispatch([(rid, y.cpu())])
        assert fleet.join(timeout=60.0)
        assert req.result is not None
        assert rid not in fleet.registry
        check_against_jax(jcfg, jp, [(req, f.p)])
        assert fleet.stats["cross_dispatched"] == 1
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


def test_fleet_remove_frontend_drains_then_reroutes(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = _spread_frags(cfg, ["fe0", "fe1", "fe2"], n_per_fe=1)
    ex, fleet = _fleet(smoke, frags, n=3)
    try:
        table = fleet.routing_table([f.client for f in frags])
        victim_fe = table[frags[0].client]
        reqs = _requests(cfg, frags, np.random.RandomState(7))
        for req, p in reqs:
            fleet.submit(req, p, 80.0)
        assert fleet.remove_frontend(victim_fe, drain=True, timeout=300.0)
        assert victim_fe not in fleet.frontends
        assert fleet.join(timeout=300.0)
        for req, _p in reqs:
            assert req.result is not None, "in-flight lost on scale-in"
        check_against_jax(jcfg, jp, reqs)
        moved = fleet.route(frags[0].client).name
        assert moved in fleet.frontends and moved != victim_fe
        for f in frags:
            if table[f.client] != victim_fe:
                assert fleet.route(f.client).name == table[f.client]
        reqs2 = _requests(cfg, [frags[0]], np.random.RandomState(8))
        for req, p in reqs2:
            fleet.submit(req, p, 80.0)
        assert fleet.join(timeout=300.0)
        check_against_jax(jcfg, jp, reqs2)
        with pytest.raises(ValueError):
            for name in list(fleet.frontends):
                fleet.remove_frontend(name)
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


# ------------------------------------------------------- work stealing

def test_steal_hop_not_double_billed_by_shed_policy(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = _spread_frags(cfg, ["fe0", "fe1"], n_per_fe=1)
    pol = ShedPolicy(budget_frac=1.0, window=16)
    ex, fleet = _fleet(smoke, frags, shed_policy=pol)
    try:
        f = frags[0]
        victim = fleet.route(f.client)
        thief = fleet.frontend(
            next(n for n in fleet.frontends if n != victim.name))
        key = ex.chain_keys(f.client)[0]
        victim.driver(key).batcher.pause()
        reqs = _requests(cfg, [f], np.random.RandomState(11),
                         n_per_client=1)
        for req, p in reqs:
            victim.submit(req, p, 5000.0)
        wait_until(lambda: victim.n_queued == 1,
                   desc="request to queue on the victim")
        admitted = pol.stats["admitted"]
        hist = len(pol._hist[f.client])
        assert admitted >= 1
        stolen = victim.steal_queued()
        assert len(stolen) == 1
        rid = stolen[0][0].rid
        assert thief.accept_stolen(stolen) == 1
        assert stolen[0][1].steal_hops == 1
        assert pol.stats["admitted"] == admitted
        assert len(pol._hist[f.client]) == hist
        assert fleet.registry[rid] is thief
        assert victim.n_inflight == 0 and thief.n_inflight == 1
        assert fleet.join(timeout=300.0)
        check_against_jax(jcfg, jp, reqs)
        rep = fleet.report()
        assert rep["served"] == 1 and rep["shed"] == 0
        assert rep["steals_out"] == 1 and rep["steals_in"] == 1
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


def test_remove_frontend_drains_through_steal_path(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = _spread_frags(cfg, ["fe0", "fe1"], n_per_fe=1)
    ex, fleet = _fleet(smoke, frags)
    try:
        table = fleet.routing_table([f.client for f in frags])
        f = frags[0]
        victim_fe = table[f.client]
        victim = fleet.frontend(victim_fe)
        for drv in victim._drivers.values():
            drv.batcher.pause()
        reqs = _requests(cfg, [f], np.random.RandomState(12),
                         n_per_client=2)
        for req, p in reqs:
            victim.submit(req, p, 5000.0)
        wait_until(lambda: victim.n_queued == len(reqs),
                   desc="requests to queue on the departing front-end")
        assert fleet.remove_frontend(victim_fe, drain=True, timeout=300.0)
        assert victim_fe not in fleet.frontends
        assert fleet.stats["steals"] == len(reqs)
        assert victim.stats["steals_out"] == len(reqs)
        assert fleet.join(timeout=300.0)
        check_against_jax(jcfg, jp, reqs)
        rep = fleet.report()
        assert rep["served"] == len(reqs)
        assert rep["frontends"][victim_fe]["retired"]
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


# ------------------------------------------------------------- shedding

def _server(smoke, frags, **kw):
    cfg, book, params, _, _ = smoke
    ex = GraftExecutor(GraftPlanner(book).plan(frags), params, cfg,
                       device="cpu")
    return ex, GraftServer(ex, book=book, **kw).start()


def test_server_sheds_hopeless_requests_at_ingest(smoke):
    cfg = smoke[0]
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="s0")]
    pol = ShedPolicy(budget_frac=1.0, window=16)
    ex, server = _server(smoke, frags, shed_policy=pol)
    try:
        reqs = _requests(cfg, frags, np.random.RandomState(0),
                         n_per_client=4)
        for req, p in reqs:
            server.submit(req, p, 1e-3)
        assert server.join(timeout=120.0), "sheds must count as done"
        rep = server.report()
        assert rep["shed"] == len(reqs) and rep["served"] == 0
        assert rep["shed_ingest"] == len(reqs) and rep["shed_flush"] == 0
        assert rep["offered"] == len(reqs)
        assert all(r.result is None for r, _ in reqs)
        assert server.stats["batches"] == 0
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_server_shed_budget_exhaustion_admits_and_serves(smoke):
    cfg, _, _, jcfg, jp = smoke
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="s1")]
    pol = ShedPolicy(budget_frac=0.5, window=8)
    ex, server = _server(smoke, frags, shed_policy=pol)
    try:
        feasible = _requests(cfg, frags, np.random.RandomState(1),
                             n_per_client=4)
        for req, p in feasible:
            server.submit(req, p, 5000.0)
        assert server.join(timeout=300.0)
        assert server.report()["shed"] == 0
        hopeless_reqs = _requests(cfg, frags, np.random.RandomState(2),
                                  n_per_client=8)
        for req, p in hopeless_reqs:
            server.submit(req, p, 1e-3)
        assert server.join(timeout=300.0)
        rep = server.report()
        n = len(feasible) + len(hopeless_reqs)
        assert rep["shed"] >= 1, "budget never used"
        assert rep["served"] >= n // 2, "must-admit starved"
        assert rep["served"] + rep["shed"] == n
        assert pol.stats["budget_admits"] >= 1
        assert pol.shed_frac("s1") <= 0.5 + 1 / 8
        served = [(r, p) for r, p in feasible + hopeless_reqs
                  if r.result is not None]
        assert len(served) == rep["served"]
        check_against_jax(jcfg, jp, served)
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_shed_accounting_survives_mid_traffic_replan(smoke):
    cfg, book, _, _, _ = smoke
    planner = GraftPlanner(book)
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="s2"),
             Fragment(cfg.name, 1, 60.0, 30.0, client="s3")]
    pol = ShedPolicy(budget_frac=1.0, window=32)
    ex, server = _server(smoke, frags, shed_policy=pol)
    try:
        for req, p in _requests(cfg, [frags[0]], np.random.RandomState(2)):
            server.submit(req, p, 1e-3)
        assert server.join(timeout=120.0)
        shed_before = server.stats["shed_ingest"]
        frac_before = pol.shed_frac("s2")
        assert shed_before == 2 and frac_before > 0
        server.apply(planner.plan([dataclasses.replace(f, q=60.0)
                                   for f in frags]))
        for req, p in _requests(cfg, [frags[0]], np.random.RandomState(3)):
            server.submit(req, p, 1e-3)
        assert server.join(timeout=120.0)
        assert server.stats["shed_ingest"] == shed_before + 2
        assert pol.shed_frac("s2") >= frac_before
        assert pol.stats["shed"] == 4
        assert server.report()["shed"] == 4
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_fleet_shed_policy_is_fleet_global(smoke):
    cfg = smoke[0]
    frags = _spread_frags(cfg, ["fe0", "fe1"], n_per_fe=1)
    pol = ShedPolicy(budget_frac=1.0, window=16)
    ex, fleet = _fleet(smoke, frags, shed_policy=pol)
    try:
        reqs = _requests(cfg, frags, np.random.RandomState(4))
        for req, p in reqs:
            fleet.submit(req, p, 1e-3)
        assert fleet.join(timeout=120.0)
        rep = fleet.report()
        assert rep["shed"] == len(reqs) and rep["served"] == 0
        assert sum(fe["shed"] for fe in rep["frontends"].values()) \
            == len(reqs)
        for f in frags:
            assert pol.shed_frac(f.client) > 0
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


def test_uplink_queue_backlog_sheds_at_ingest_not_flush(smoke):
    cfg, _, _, jcfg, jp = smoke
    clock = FakeClock()
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="q0")]
    pol = ShedPolicy(budget_frac=1.0, window=16)
    ex, server = _server(smoke, frags, shed_policy=pol, clock=clock)
    try:
        rng = np.random.RandomState(0)
        toks = lambda: rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
        warm = ServeRequest(client="q0", tokens=toks())
        server.submit(warm, 0, 1e6)
        assert server.join(timeout=300.0)
        key = ex.chain_keys("q0")[0]
        drv = server.driver(key)
        assert drv.est_cost_ms() == 0.0          # fake perf clock: EWMA 0
        server._uplink_ewma["q0"] = 300.0        # synthetic slow uplink
        drv.batcher.pause()
        r1 = ServeRequest(client="q0", tokens=toks())
        server.submit(r1, 0, 1e6)
        wait_until(lambda: len(drv.batcher) == 1,
                   desc="backlog request to queue")
        assert drv.batcher.pending_hop_ms == 300.0
        est = remaining_cost_ms([drv.est_cost_ms()], 0, hop_ms=300.0) \
            + drv.batcher.pending_hop_ms
        r2 = ServeRequest(client="q0", tokens=toks())
        server.submit(r2, 0, est - 1.0)
        wait_until(lambda: server.stats["shed_ingest"] == 1,
                   desc="uplink-bound request to shed at ingest")
        assert server.stats["shed_flush"] == 0 and server.stats["batches"] == 1
        r3 = ServeRequest(client="q0", tokens=toks())
        server.submit(r3, 0, est)
        wait_until(lambda: len(drv.batcher) == 2,
                   desc="boundary request to be admitted")
        assert server.stats["shed_ingest"] == 1
        drv.batcher.resume()
        assert server.join(timeout=300.0)
        rep = server.report()
        assert rep["served"] == 3 and rep["shed"] == 1
        assert r2.result is None
        check_against_jax(jcfg, jp, [(warm, 0), (r1, 0), (r3, 0)])
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


def test_inflight_uplink_batch_charged_at_ingest(smoke):
    cfg = smoke[0]
    clock = FakeClock()
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="b0")]
    pol = ShedPolicy(budget_frac=1.0, window=16)
    ex, server = _server(smoke, frags, shed_policy=pol, clock=clock)
    try:
        rng = np.random.RandomState(1)
        toks = lambda: rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
        warm = ServeRequest(client="b0", tokens=toks())
        server.submit(warm, 0, 1e6)
        assert server.join(timeout=300.0)
        key = ex.chain_keys("b0")[0]
        drv = server.driver(key)
        server._uplink_ewma["b0"] = 0.0
        drv.batcher.pause()
        drv.busy_until_ms = 400.0
        hopeless_req = ServeRequest(client="b0", tokens=toks())
        server.submit(hopeless_req, 0, 399.0)
        wait_until(lambda: server.stats["shed_ingest"] == 1,
                   desc="busy-pool request to shed at ingest")
        assert server.stats["shed_flush"] == 0
        boundary = ServeRequest(client="b0", tokens=toks())
        server.submit(boundary, 0, 400.0)
        wait_until(lambda: len(drv.batcher) == 1,
                   desc="boundary request to be admitted")
        drv.busy_until_ms = 0.0
        drv.batcher.resume()
        assert server.join(timeout=300.0)
        rep = server.report()
        assert rep["served"] == 2 and rep["shed"] == 1
        assert hopeless_req.result is None and boundary.result is not None
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()


@pytest.mark.parametrize("mode", ["token_budget", "waved_decode"])
def test_server_batching_hooks_serve_exactly(deep, mode):
    """The front-end knobs the fleet passes through: ``token_budget``
    closes a pool's batch once its queued tokens reach the budget (two
    16-token requests of a batch-4 pool), and ``decode_continuous=False``
    admits a new decode wave only once the batch has drained. Results
    equal the JAX forward, streams the JAX reference."""
    from repro_torch.serving.smoke import decode_plan
    cfg, book, params, jcfg, jp = deep
    if mode == "token_budget":
        frags = [Fragment(cfg.name, 1, 4000.0, 30.0, client=f"t{i}")
                 for i in range(2)]
        ex = GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1, batch=4),
                           params, cfg, device="cpu")
        server = GraftServer(ex, book=book, token_budget=32).start()
    else:
        frags = [Fragment(cfg.name, 0, 4000.0, 30.0, client="w0")]
        ex = GraftExecutor(decode_plan(cfg, book, frags, batch=2), params,
                           cfg, decode_ctx=64, kv_block_tokens=4,
                           device="cpu")
        server = GraftServer(ex, book=book, decode_continuous=False).start()
    rng = np.random.RandomState(23)
    try:
        key = ex.chain_keys(frags[0].client)[-1]
        server.driver(key).batcher.pause()
        if mode == "token_budget":
            reqs = _requests(cfg, frags, rng, n_per_client=3)
        else:
            reqs = [(ServeRequest(client="w0", tokens=rng.randint(
                0, cfg.vocab_size, 10).astype(np.int32), max_new_tokens=4,
                tpot_budget_ms=2000.0), 4) for _ in range(4)]
        for req, p in reqs:
            server.submit(req, p if mode == "token_budget" else 0, 4000.0)
        wait_until(lambda: len(server.driver(key).batcher) == len(reqs),
                   desc="requests to queue")
        server.driver(key).batcher.resume()
        assert server.join(timeout=120.0)
        rep = server.report()
        sizes = list(server.driver(key).batcher.stats.batch_sizes)
    finally:
        server.stop(drain=False, timeout=5.0)
        ex.close()
    if mode == "token_budget":
        assert sizes and max(sizes) == 2          # 2 x 16 tokens = budget
        check_against_jax(jcfg, jp, reqs)
    else:
        assert rep["decode_served"] == 4 and rep["decode_local"] == 0
        check_decode_against_jax(jcfg, jp, reqs)


# ----------------------------------------------- pad-to-bucket shapes

def _feed(inst, sizes):
    tok = torch.zeros(16, dtype=torch.int32)
    for n in sizes:
        for _ in range(n):
            inst.submit(ServeRequest(client="c", tokens=None), tok)
        inst.flush()


def test_pad_to_bucket_bounds_compile_count(smoke):
    """Varying partial-batch sizes hit padded power-of-two shapes, so a
    pool sees O(log batch) shapes, fewer than the distinct sizes fed."""
    cfg, _, params, _, _ = smoke
    spec = PoolSpec(key=(cfg.name, 0, 2), share=50, batch=4, n_instances=1)
    padded = FragmentInstance(params, cfg, spec, packed=False)
    sizes = [3, 4, 2, 3, 1]
    _feed(padded, sizes)
    assert padded.n_compiles == 3 < len(set(sizes))       # {4, 2, 1}


def test_pad_to_bucket_survives_replan_retarget(smoke):
    cfg, _, params, _, _ = smoke
    spec = PoolSpec(key=(cfg.name, 0, 2), share=50, batch=4, n_instances=1)
    inst = FragmentInstance(params, cfg, spec, packed=False)
    _feed(inst, [3, 2])                                    # shapes {4, 2}
    assert inst.n_compiles == 2
    inst.retarget(dataclasses.replace(spec, batch=2))
    _feed(inst, [2, 1, 2])                                 # {2} seen, {1}
    assert inst.n_compiles == 3


# --------------------------------------------- executor chip stability

def test_executor_replan_keeps_unchanged_instances_on_chips(smoke):
    cfg, book, params, jcfg, jp = smoke
    planner = GraftPlanner(book)
    frags1 = [Fragment(cfg.name, 0, 60.0, 30.0, client="c0"),
              Fragment(cfg.name, 1, 70.0, 30.0, client="c1")]
    with GraftExecutor(planner.plan(frags1), params, cfg,
                       device="cpu") as ex:
        chips1 = {k: ex.chips_of(k) for k in ex.pool_specs()}
        assert all(chips1.values())
        stats1 = {k: s["chips"] for k, s in ex.pool_stats().items()}
        assert stats1 == chips1
        frags2 = frags1 + [Fragment(cfg.name, 1, 50.0, 30.0, client="c2")]
        diff = ex.apply_plan(planner.plan(frags2))
        assert diff.n_kept >= 1
        chips2 = {k: ex.chips_of(k) for k in ex.pool_specs()}
        for a in diff.by_kind("keep"):
            assert chips2[a.key] == chips1[a.key]
        for a in diff.by_kind("resize") + diff.by_kind("rebatch"):
            n = min(len(chips1[a.key]), len(chips2[a.key]))
            assert chips2[a.key][:n] == chips1[a.key][:n]
        if diff.by_kind("add") or any(
                a.n_delta > 0 for a in diff.by_kind("resize")):
            assert any(m.kind == "spawn" for m in ex.last_migrations)
        assert ex.stats["instances_spawned"] == sum(
            1 for m in ex.last_migrations if m.kind == "spawn")
        reqs = _requests(cfg, frags2, np.random.RandomState(9),
                         n_per_client=1)
        ex.serve(reqs)
        check_against_jax(jcfg, jp, reqs)


def test_fleet_decode_streams_split_across_frontends_equal_jax(deep):
    """Both front-ends admit streams to ONE shared decode pool: a step
    either driver takes advances every resident stream, so each stream's
    events reach its owner through the fleet, which completes it; slots
    another front-end holds are waited for, never decoded locally. Every
    stream equals the JAX reference token for token."""
    from repro_torch.serving.smoke import decode_plan
    cfg, book, params, jcfg, jp = deep
    frags = [Fragment(cfg.name, 0, 4000.0, 30.0, client=f"d{i}")
             for i in range(2)]
    ex = GraftExecutor(decode_plan(cfg, book, frags, batch=2), params, cfg,
                       decode_ctx=64, kv_block_tokens=4, device="cpu")
    fleet = GraftFleet(ex, n_frontends=2, book=book).start()
    rng = np.random.RandomState(17)
    streams = []
    try:
        for i in range(4):
            req = ServeRequest(client=f"d{i % 2}", tokens=rng.randint(
                0, cfg.vocab_size, int(rng.randint(6, 20))).astype(np.int32),
                max_new_tokens=5, tpot_budget_ms=2000.0)
            fleet.frontend(f"fe{i % 2}").submit(req, 0, 4000.0)
            streams.append((req, 5))
        assert fleet.join(timeout=120.0), "a split decode stream stranded"
        rep = fleet.report()
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()
    assert rep["decode_served"] == len(streams)
    assert rep["decode_local"] == 0 and rep["shed"] == 0
    assert all(fe["served"] == 2 for fe in rep["frontends"].values())
    check_decode_against_jax(jcfg, jp, streams)


class _StepGate:
    """A front-end's handle to the shared decode pool whose decode steps
    wait for the test's go-ahead, until ``open`` is set."""

    def __init__(self, inner):
        self.inner = inner
        self.arrived = threading.Semaphore(0)
        self.go = threading.Semaphore(0)
        self.open = False

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def decode_step(self):
        if not self.open:
            self.arrived.release()
            self.go.acquire()
        return self.inner.decode_step()

    def reached(self):
        """Wait until the driver is at this gate, ready to step."""
        assert self.arrived.acquire(timeout=60.0), "driver never stepped"


def test_fleet_foreign_done_event_after_owners_step_strands_nothing(deep):
    """The order that stranded a split stream, forced step by step: fe1's
    step finishes fe0's stream S0, and fe1 holds that done event back
    while fe0 steps twice (admitting S2 in between) and finishes fe1's
    stream S1. Only then does S0's event reach fe0. Each driver's count
    must stay the pool's occupancy as a pool reply last gave it, so fe0
    still steps S2 to its end; a count lowered by the late event leaves
    both drivers idle with S2 resident."""
    from repro_torch.serving.smoke import decode_plan
    cfg, book, params, jcfg, jp = deep
    frags = [Fragment(cfg.name, 0, 4000.0, 30.0, client=f"d{i}")
             for i in range(2)]
    ex = GraftExecutor(decode_plan(cfg, book, frags, batch=2), params, cfg,
                       decode_ctx=64, kv_block_tokens=4, device="cpu")
    (key,) = ex.pool_specs()
    fleet = GraftFleet(ex, n_frontends=2, book=book, clock=FakeClock(),
                       steal_threshold_ms=float("inf"))
    fe0, fe1 = fleet.frontend("fe0"), fleet.frontend("fe1")
    gates = {}
    for srv in (fe0, fe1):
        gates[srv.name] = srv._local_handles[key] = \
            _StepGate(ex.open_handle(key))
    held = threading.Event()           # fe1 holds S0's done event
    let_go = threading.Event()         # fe0 finished S1: release it
    passed = threading.Event()         # S0's done event reached fe0
    rng = np.random.RandomState(23)
    reqs = {}

    def submit(name, srv, max_new):
        req = ServeRequest(client="d0" if srv is fe0 else "d1",
                           tokens=rng.randint(0, cfg.vocab_size, int(
                               rng.randint(6, 20))).astype(np.int32),
                           max_new_tokens=max_new, tpot_budget_ms=2000.0)
        reqs[name] = (req, max_new, srv.submit(req, 0, 4000.0))

    def done_rids(results):
        return {rid for rid, ev in results
                if isinstance(ev, dict) and ev.get("done")}

    def hold_fe1(results, route=fleet._dispatch):
        if reqs["S0"][2] in done_rids(results):
            held.set()
            assert let_go.wait(60.0)
            route(results)
            passed.set()
        else:
            route(results)

    def finish_fe0(results, route=fleet._dispatch):
        route(results)
        if reqs["S1"][2] in done_rids(results):
            let_go.set()
            assert passed.wait(60.0)

    def open_gates():
        for g in gates.values():
            g.open = True
            g.go.release()

    fe1.foreign_router, fe0.foreign_router = hold_fe1, finish_fe0
    fleet.start()
    try:
        submit("S0", fe0, 2)            # done on the first pool step
        submit("S1", fe1, 4)            # done on the third
        gates["fe0"].reached()          # S0 admitted
        gates["fe1"].reached()          # S1 admitted
        gates["fe1"].go.release()       # step 1, on fe1: S0 done
        assert held.wait(60.0)
        submit("S2", fe0, 5)
        wait_until(lambda: fe0.n_queued == 1, desc="S2 queued on fe0")
        gates["fe0"].go.release()       # step 2, on fe0: S1 at 3 tokens
        gates["fe0"].reached()          # S2 admitted
        gates["fe0"].go.release()       # step 3, on fe0: S1 done
        assert passed.wait(60.0)
        open_gates()
        drivers = [srv.driver(key) for srv in (fe0, fe1)]

        def counts():
            return [d.decode_active for d in drivers]

        def occupancy():
            return ex.handle(key).stats()["decode_active"]
        assert fleet.join(timeout=60.0), \
            f"S2 stranded: driver counts {counts()}, pool {occupancy()}"
        rep = fleet.report()
        wait_until(lambda: counts() == [occupancy()] * 2 == [0, 0],
                   desc="driver counts at the pool's occupancy")
        assert not any(d.decode_resident for d in drivers)
    finally:
        let_go.set()                    # a failed step frees the drivers,
        passed.set()                    # or stop() waits on their locks
        open_gates()
        fleet.stop(drain=False, timeout=5.0)
        ex.close()
    assert rep["decode_served"] == 3
    assert rep["decode_local"] == 0 and rep["shed"] == 0
    assert fleet.stats["cross_dispatched"] >= 2
    check_decode_against_jax(jcfg, jp, [r[:2] for r in reqs.values()])


def test_fleet_balancer_leaves_queued_decode_streams_with_their_owner(
        deep):
    """Decode requests queued on a loaded front-end wait for a slot of the
    decode pool both front-ends share, so the balancer's imbalance path
    leaves them where they are: a thief would wait for the same slots,
    and the stream would finish on a front-end it was not sent to (a
    loaded host so broke the split test's count of two served on each
    front-end). The load is forced: fe0's admits are paused and its
    admit cost reads one second."""
    from repro_torch.serving.smoke import decode_plan
    cfg, book, params, jcfg, jp = deep
    frags = [Fragment(cfg.name, 0, 4000.0, 30.0, client=f"d{i}")
             for i in range(2)]
    ex = GraftExecutor(decode_plan(cfg, book, frags, batch=2), params, cfg,
                       decode_ctx=64, kv_block_tokens=4, device="cpu")
    (key,) = ex.pool_specs()
    fleet = GraftFleet(ex, n_frontends=2, book=book,
                       clock=FakeClock()).start()
    fe0 = fleet.frontend("fe0")
    drv = fe0.driver(key)
    rng = np.random.RandomState(29)
    streams = []
    try:
        drv.batcher.pause()
        for _ in range(2):
            req = ServeRequest(client="d0", tokens=rng.randint(
                0, cfg.vocab_size, int(rng.randint(6, 20))).astype(np.int32),
                max_new_tokens=5)
            fe0.submit(req, 0, 4000.0)
            streams.append((req, 5))
        wait_until(lambda: fe0.n_queued == 2, desc="streams queued on fe0")
        drv.exec_ewma_ms = 1000.0
        for _ in range(2):              # the imbalance persists two ticks
            fleet._balance(fleet.now_ms())
        assert fleet.stats["steals"] == 0 and fe0.n_queued == 2
        drv.batcher.resume()
        assert fleet.join(timeout=120.0)
        rep = fleet.report()
    finally:
        drv.batcher.resume()
        fleet.stop(drain=False, timeout=5.0)
        ex.close()
    assert {n: fe["served"] for n, fe in rep["frontends"].items()} \
        == {"fe0": 2, "fe1": 0}
    assert rep["decode_local"] == 0 and rep["shed"] == 0
    check_decode_against_jax(jcfg, jp, streams)


def test_fleet_join_waits_for_a_request_stolen_while_it_runs(smoke):
    """A steal moves a request onto a front-end that ``join`` may already
    have found done. Forced: fe1's queued request is stolen to fe0 just
    after ``join`` has passed fe0, both front-ends paused. ``join`` must
    not return before that request completes (fe0 resumes, and the clock
    passes its flush deadline, on the next look ``join`` takes at it)."""
    cfg, book, _, jcfg, jp = smoke
    frags = _shared_pool_frags(cfg, ["fe0", "fe1"], p=1)
    plan = mixed_depth_plan(cfg, book, frags, s=1, batch=4)
    clock = FakeClock()
    ex, fleet = _fleet(smoke, frags, plan=plan, clock=clock,
                       steal_threshold_ms=float("inf"))
    fe0, fe1 = fleet.frontend("fe0"), fleet.frontend("fe1")
    drivers = [d for srv in (fe0, fe1) for d in srv._drivers.values()]
    looks = {"fe0": 0, "fe1": 0}
    joins = {"fe0": fe0.join, "fe1": fe1.join}

    def join_fe0(timeout=None):
        looks["fe0"] += 1
        if looks["fe0"] == 2:
            clock.advance(5000.0)
            for d in fe0._drivers.values():
                d.batcher.resume()
        return joins["fe0"](timeout=timeout)

    def join_fe1(timeout=None):
        looks["fe1"] += 1
        if looks["fe1"] == 1:
            assert fleet._steal(fe1, fe0) == 1
        return joins["fe1"](timeout=timeout)
    try:
        for d in drivers:
            d.batcher.pause()
        reqs = _requests(cfg, frags[:1], np.random.RandomState(31),
                         n_per_client=1)
        (req, p), = reqs
        fe1.submit(req, p, 5000.0)
        wait_until(lambda: fe1.n_queued == 1, desc="request queued on fe1")
        fe0.join, fe1.join = join_fe0, join_fe1
        assert fleet.join(timeout=120.0)
        assert req.result is not None, \
            "join returned before the stolen request completed"
        assert looks == {"fe0": 2, "fe1": 2}
    finally:
        for d in drivers:
            d.batcher.resume()
        fleet.stop(drain=False, timeout=5.0)
        ex.close()
    check_against_jax(jcfg, jp, reqs)


# ------------------------------------------------------------ fleet faults

def test_fleet_partitioned_frontend_does_not_stall_others(deep):
    cfg, book, params, jcfg, jp = deep
    frags = _shared_pool_frags(cfg, ["fe0", "fe1"], p=1)
    plan = mixed_depth_plan(cfg, book, frags, s=1, batch=4)
    tp = FlakyTransport(InProcessTransport())
    ex = GraftExecutor(plan, params, cfg, transport=tp, device="cpu")
    fleet = GraftFleet(ex, n_frontends=2, book=book).start()
    try:
        keys = {tuple(ex.chain_keys(f.client)) for f in frags}
        assert len(keys) == 1
        key = next(iter(keys))[0]
        warm = _requests(cfg, frags, np.random.RandomState(0),
                         n_per_client=1)
        for req, p in warm:
            fleet.submit(req, p, 5000.0)
        assert fleet.join(timeout=300.0)
        check_against_jax(jcfg, jp, warm)
        table = fleet.routing_table([f.client for f in frags])
        dark_fe = table[frags[0].client]
        lit_fe = next(fe for fe in fleet.frontends if fe != dark_fe)
        dark, lit = fleet.frontend(dark_fe), fleet.frontend(lit_fe)
        assert dark._local_handles[key] is not lit._local_handles[key]
        dark._local_handles[key].channel.broken = True
        lit_batches = lit.stats["batches"]
        reqs = _requests(cfg, frags, np.random.RandomState(1),
                         n_per_client=3)
        for req, p in reqs:
            fleet.submit(req, p, 5000.0)
        assert fleet.join(timeout=300.0), \
            "a partitioned front-end stalled the fleet"
        check_against_jax(jcfg, jp, reqs)
        assert lit.stats["batches"] > lit_batches
        assert lit.stats["local_finishes"] == 0
        n_dark = sum(1 for f in frags if table[f.client] == dark_fe) * 3
        assert dark.stats["local_finishes"] == n_dark
        assert fleet.report()["served"] == len(warm) + len(reqs)
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


def test_fleet_wedged_frontend_work_is_stolen_and_heals(deep):
    cfg, book, params, jcfg, jp = deep
    frags = _shared_pool_frags(cfg, ["fe0", "fe1"], p=0)
    plan = mixed_depth_plan(cfg, book, frags, s=0, batch=4)
    tp = FlakyTransport(InProcessTransport())
    ex = GraftExecutor(plan, params, cfg, transport=tp, decode_ctx=64,
                       kv_block_tokens=4, device="cpu")
    fleet = GraftFleet(ex, n_frontends=2, book=book).start()
    try:
        key = ex.chain_keys(frags[0].client)[0]
        warm = _requests(cfg, frags, np.random.RandomState(0),
                         n_per_client=1)
        for req, p in warm:
            fleet.submit(req, p, 5000.0)
        assert fleet.join(timeout=300.0)
        check_against_jax(jcfg, jp, warm)
        table = fleet.routing_table([f.client for f in frags])
        dark_fe = table[frags[0].client]
        lit_fe = next(fe for fe in fleet.frontends if fe != dark_fe)
        dark, lit = fleet.frontend(dark_fe), fleet.frontend(lit_fe)
        for drv in dark._drivers.values():
            drv.batcher.pause()
        dark._local_handles[key].channel.broken = True
        doomed = _requests(cfg, [frags[0]], np.random.RandomState(1),
                           n_per_client=2)
        for req, p in doomed:
            dark.submit(req, p, 5000.0)
        drng = np.random.RandomState(42)
        dburst = [(ServeRequest(
            client=frags[0].client,
            tokens=drng.randint(0, cfg.vocab_size, 12).astype(np.int32),
            max_new_tokens=4, tpot_budget_ms=2000.0), 4)
            for _ in range(2)]
        for req, _m in dburst:
            dark.submit(req, 0, 5000.0)
        n_doomed = len(doomed) + len(dburst)
        wait_until(lambda: dark.n_queued == n_doomed,
                   desc="requests to queue on the wedged front-end")
        fleet.set_health(dark_fe, False)
        wait_until(lambda: fleet.stats["steals"] >= n_doomed,
                   timeout_s=10.0, desc="the survivor to steal queued work")
        assert dark.stats["steals_out"] == n_doomed
        assert lit.stats["steals_in"] == n_doomed
        assert dark.n_inflight == 0
        assert fleet.join(timeout=300.0), "stolen work never completed"
        check_against_jax(jcfg, jp, doomed)
        check_decode_against_jax(jcfg, jp, dburst)
        assert lit.stats["decode_served"] == len(dburst)
        assert dark.stats["decode_served"] == 0
        rep = fleet.report()
        assert rep["served"] == len(warm) + n_doomed
        assert rep["shed"] == 0 and rep["steals"] == n_doomed
        dark._local_handles[key].channel.broken = False
        for drv in dark._drivers.values():
            drv.batcher.resume()
        fleet.set_health(dark_fe, True)
        dark_batches = dark.stats["batches"]
        back = _requests(cfg, [frags[0]], np.random.RandomState(2),
                         n_per_client=2)
        for req, p in back:
            dark.submit(req, p, 5000.0)
        assert fleet.join(timeout=300.0)
        check_against_jax(jcfg, jp, back)
        assert dark.stats["batches"] > dark_batches
        assert fleet.stats["steals"] == n_doomed
        assert fleet.report()["served"] == len(warm) + n_doomed + len(back)
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()


# ------------------------------------------- a replan the pools refuse

def _hold(fleet, ex, cfg, hold, request_cls):
    """Keep client c1's work in the system: a decode stream resident on
    its pool (the executor's stats say so) or a request queued
    server-side on a front-end. Returns (its driver, [(req, p)])."""
    (key1,) = ex.chain_keys("c1")
    if hold == "resident_stream":
        for h in ex._handles.values():
            h.stats = lambda: {"queue_len": 0, "decode_active": 1}
        return None, []
    drv = fleet.frontend("fe0").driver(key1)
    drv.batcher.pause()
    req = request_cls(client="c1", tokens=np.random.RandomState(9).randint(
        0, cfg.vocab_size, 16).astype(np.int32))
    fleet.frontend("fe0").submit(req, 1, 60.0)
    wait_until(lambda: len(drv.batcher) == 1, desc="c1's request to queue")
    return drv, [(req, 1)]


def _depart(ctl, clock, cfg, advance_ms, t_arrivals):
    """Advance the clock; only c0 keeps arriving."""
    clock.advance(advance_ms)
    for t in t_arrivals:
        ctl.observe_arrival(t, "c0", cfg.name, 0, 80.0)


@pytest.mark.parametrize("hold", ["resident_stream", "queued_request"])
def test_fleet_refused_apply_reverts_the_controller_and_is_retried(
        smoke, hold):
    """Client c1 leaves the controller's window while the fleet still
    holds its work. The reference's fleet applies what it should refuse:
    with a resident stream ``apply_plan`` raises out of ``tick`` and the
    controller keeps the refused plan while the pools keep the old one;
    with a request queued server-side the replan lands and the request
    finishes locally. The port's fleet refuses before anything changes,
    reverts the controller to the deployed plan, counts the refusal, and
    applies the replan on a later tick once the work is done."""
    from repro.core import Fragment as JFragment
    from repro.core import GraftPlanner as JPlanner
    from repro.core.plandiff import plan_pools as j_plan_pools
    from repro.serving import GraftExecutor as JExecutor
    from repro.serving import GraftFleet as JFleet
    from repro.serving import ServeRequest as JRequest
    from repro.serving.controller import ServingController as JController
    cfg, book, params, jcfg, jp = smoke
    frags = [Fragment(cfg.name, 0, 80.0, 30.0, client="c0"),
             Fragment(cfg.name, 1, 60.0, 30.0, client="c1")]
    kw = dict(window_ms=1000.0, control_period_ms=1e6,
              min_replan_interval_ms=500.0)

    # --- the reference: the fault
    _, jbook, _ = jsmoke.smoke_setup(ARCH, seed=0)
    jfrags = [JFragment(f.model, f.p, f.t, f.q, client=f.client)
              for f in frags]
    jclock = FakeClock()
    jctl = JController(jbook, planner=JPlanner(jbook), **kw)
    jplan0 = jctl.bootstrap(jfrags, now_ms=0.0)
    jex = JExecutor(jplan0, jp, jcfg)
    jf = JFleet(jex, n_frontends=2, controller=jctl, book=jbook,
                clock=jclock).start()
    try:
        jdrv, jreqs = _hold(jf, jex, cfg, hold, JRequest)
        _depart(jctl, jclock, cfg, 3000.0, (2200.0, 2500.0, 2800.0))
        if hold == "resident_stream":
            with pytest.raises(RuntimeError, match="drain before"):
                jf.tick()
            # the controller believes a plan that never deployed
            assert jctl.current_plan is not jplan0
            assert j_plan_pools(jctl.current_plan) != jex.pool_specs() \
                == j_plan_pools(jplan0)
        else:
            assert jf.tick() is not None
            assert jf.join(timeout=120.0)
            # c1's queued request lost its pool: finished locally
            assert jf.report()["local_finishes"] == 1
            assert jreqs[0][0].result is not None
    finally:
        jf.stop(drain=False, timeout=5.0)
        jex.close()

    # --- the port: refused, reverted, retried
    clock = FakeClock()
    ctl = ServingController(book, planner=GraftPlanner(book), **kw)
    plan0 = ctl.bootstrap(frags, now_ms=0.0)
    ex = GraftExecutor(plan0, params, cfg, device="cpu")
    fleet = GraftFleet(ex, n_frontends=2, controller=ctl, book=book,
                       clock=clock).start()
    try:
        drv, reqs = _hold(fleet, ex, cfg, hold, ServeRequest)
        want = "resident decode streams" if hold == "resident_stream" \
            else "['c1'] still have requests in flight"
        _depart(ctl, clock, cfg, 3000.0, (2200.0, 2500.0, 2800.0))
        assert fleet.tick() is None
        assert fleet.stats["applies_refused"] == 1
        assert fleet.stats["tick_errors"] == fleet.stats["timer_replans"] \
            == 0
        assert ctl.stats["refused"] == 1 and ctl.current_plan is plan0
        assert want in ctl.audit[-1]["refused"]
        assert ctl.audit[-1]["diff"]["remove"] >= 1
        assert ex.pool_specs() == plan_pools(plan0)
        if hold == "resident_stream":            # ... and then it drains
            for h in ex._handles.values():
                del h.stats
        else:
            drv.batcher.resume()
            assert fleet.join(timeout=120.0)
            check_against_jax(jcfg, jp, reqs)
        _depart(ctl, clock, cfg, 600.0, (3300.0, 3500.0))
        assert fleet.tick() is not None
        assert fleet.stats["timer_replans"] == 1
        assert ctl.stats["triggers"]["fragment_departure"] == 2
        assert plan_pools(ctl.current_plan) == ex.pool_specs() \
            != plan_pools(plan0)
        rep = fleet.report()
        assert rep["applies_refused"] == 1 and rep["tick_errors"] == 0
        assert rep["local_finishes"] == rep["rerouted"] == 0
    finally:
        fleet.stop(drain=False, timeout=5.0)
        ex.close()
