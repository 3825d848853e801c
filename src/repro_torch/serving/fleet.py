"""GraftFleet — multi-front-end scale-out over ONE shared pool fleet.

The paper's evaluation serves fleet-scale traffic (five DNN types, real
network traces): many clients share one pool fleet under an SLO. A
single :class:`~repro_torch.serving.server.GraftServer` front-end tops out
on ingest (mobile-part execution) and on serializing every client's uplink
through one channel per pool. ``GraftFleet`` runs **several front-ends
over one executor** — one set of stage pools, one placement, one
controller — and adds the two cluster-level behaviors a lone server
cannot provide:

  * **Load- and cache-aware routing.** By default a
    :class:`~repro_torch.serving.router.WeightedRouter` scores front-ends
    per request from live signals (queue depth, shed rate, health, KV
    prefix affinity) with the rendezvous (highest-random-weight) ring
    as deterministic anchor and staleness fallback; ``router="hrw"``
    keeps the static ring alone. When imbalance persists across a
    control tick (or a front-end is force-marked unhealthy), idle
    front-ends *steal* queued-not-in-flight work from the loaded one,
    with the extra hop charged against each stolen request's
    shed-policy slack. In-flight requests keep draining on the old
    front-end (:meth:`remove_frontend` hands queued work to survivors
    through the same steal path before teardown), so a rebalance never
    drops or reorders work that already entered the system.

  * **Fleet-wide control.** The fleet owns the controller tick: it
    ingests transport-measured uplinks, replans, and applies the diff
    ONCE to the shared executor under every front-end's writer lock —
    front-ends observe (arrivals, completions, sheds, all on one shared
    clock and controller lock) but never replan on their own
    (``external_control``). Replans ride ``core.plandiff`` into
    ``core.placement.migrate``: unchanged instances stay on their chips;
    only the delta spawns/retires/moves.

Shared pools mean one front-end's flush can surface requests *owned by
another front-end* (the pool batches across front-ends). Every submit
registers its request in a fleet-wide ``rid -> server`` registry; pool
drivers hand foreign results to :meth:`_dispatch`, which forwards them
to the owner OUTSIDE the flushing server's lock — the owner takes its
own read lock, so a fleet-wide writer (replan) can never deadlock
against the hand-off.

Admission control (:class:`~repro_torch.serving.batcher.ShedPolicy`) is
one shared object: per-client shed budgets are fleet-global and survive
both replans and front-end rebalances.

A replan the pools cannot take never leaves the controller believing it:
:meth:`GraftFleet.apply` refuses, before anything changes, a plan that
routes no chain for a client with requests still in flight on any
front-end, and the executor's ``apply_plan`` one that removes a pool
still holding queued requests or resident decode streams. The tick then
reverts the controller to the deployed plan (``ServingController
.revert``) and counts the refusal; a later tick replans once that work
is done.
"""
from __future__ import annotations

import math
import threading
import time
import traceback
from contextlib import ExitStack
from typing import Optional

import numpy as np

from repro_torch.serving.batcher import ShedPolicy
from repro_torch.serving.executor import PlanRefused
from repro_torch.serving.router import (WeightedRouter, rendezvous_route,
                                  rendezvous_table)
from repro_torch.serving.server import GraftServer, summarize_records
from repro_torch.serving.telemetry import NULL as NULL_TELEMETRY

__all__ = ["GraftFleet", "WeightedRouter", "rendezvous_route",
           "rendezvous_table"]


class GraftFleet:
    """Coordinator for several GraftServer front-ends on one executor.

    ``executor`` is owned by the caller (same contract as GraftServer);
    the fleet owns its front-ends and the control thread.
    """

    def __init__(self, executor, *, n_frontends: int = 2, controller=None,
                 book=None, shed_policy: Optional[ShedPolicy] = None,
                 ingest_threads: Optional[int] = None,
                 hop_default_ms: float = 1.0,
                 waiting_grace_ms: Optional[float] = None,
                 flush_safety_frac: float = 0.15,
                 router="weighted",
                 steal_threshold_ms: float = 50.0,
                 clock=None):
        self.executor = executor
        self.controller = controller
        self.book = book
        # front-ends inherit the executor's registry (GraftServer default)
        # so fleet-wide metrics merge for free inside the one process
        self.telemetry = getattr(executor, "telemetry", None) \
            or NULL_TELEMETRY
        self.shed_policy = shed_policy
        self._ingest_threads = ingest_threads
        self._hop_default_ms = hop_default_ms
        self._waiting_grace_ms = waiting_grace_ms
        self._flush_safety_frac = flush_safety_frac
        self._period_ms = getattr(controller, "control_period_ms", 250.0)
        # router: "weighted" (default), "hrw"/None (static ring only), or
        # a ready WeightedRouter instance (tests tune hysteresis etc.)
        if router == "weighted":
            router = WeightedRouter(telemetry=self.telemetry)
        elif router in ("hrw", None):
            router = None
        self.router: Optional[WeightedRouter] = router
        self.steal_threshold_ms = steal_threshold_ms
        self._forced_unhealthy: set = set()   # set_health(False) marks
        self._imbalance_ticks = 0             # persistence before stealing
        self._steal_cond = threading.Condition()
        self._steals_running = 0              # steals between their calls
        self._steals_ended = 0

        self._t0 = time.monotonic()
        self._clock = clock                   # injectable (test determinism)
        self._ctl_lock = threading.Lock()     # shared by every front-end
        self._fe_lock = threading.RLock()     # membership
        self.registry: dict = {}              # rid -> owning GraftServer
        self._servers: dict[str, GraftServer] = {}
        self._retired: dict[str, GraftServer] = {}   # removed, kept for
        self._n_created = 0                          # report continuity
        self._threads: list = []
        self._stop_evt = threading.Event()
        self._started = False
        self.stats = {"replans_applied": 0, "timer_replans": 0,
                      "frontends_added": 0, "frontends_removed": 0,
                      "cross_dispatched": 0, "steals": 0,
                      "applies_refused": 0, "tick_errors": 0}
        self._m_steals = self.telemetry.counter("route/steals")
        for _ in range(max(int(n_frontends), 1)):
            self._make_frontend()

    # -------------------------------------------------------------- clock
    def now_ms(self) -> float:
        """The ONE clock every front-end and the controller share —
        per-server clocks would skew the controller's sliding windows.
        Injectable (``clock=``) so fleet tests run on a fake clock."""
        if self._clock is not None:
            return self._clock()
        return (time.monotonic() - self._t0) * 1e3

    # --------------------------------------------------------- membership
    def _make_frontend(self, name: Optional[str] = None) -> str:
        with self._fe_lock:
            if name is None:
                name = f"fe{self._n_created}"
            if name in self._servers:
                raise ValueError(f"front-end {name!r} already exists")
            self._n_created += 1
            srv = GraftServer(
                self.executor, controller=self.controller, book=self.book,
                hop_default_ms=self._hop_default_ms,
                waiting_grace_ms=self._waiting_grace_ms,
                ingest_threads=self._ingest_threads,
                flush_safety_frac=self._flush_safety_frac,
                shed_policy=self.shed_policy, name=name,
                clock=self.now_ms, ctl_lock=self._ctl_lock,
                external_control=True, registry=self.registry,
                foreign_router=self._dispatch)
            self._servers[name] = srv
            if self._started:
                srv.start()
            return name

    @property
    def frontends(self) -> list:
        with self._fe_lock:
            return list(self._servers)

    def frontend(self, name: str) -> GraftServer:
        with self._fe_lock:
            return self._servers[name]

    def add_frontend(self, name: Optional[str] = None) -> str:
        """Scale out: new clients (and only the clients whose rendezvous
        winner the newcomer is) route here from the next submit on."""
        name = self._make_frontend(name)
        self.stats["frontends_added"] += 1
        return name

    def remove_frontend(self, name: str, *, drain: bool = True,
                        timeout: float = 60.0) -> bool:
        """Scale in: take ``name`` out of the routing ring FIRST (new
        submits for its clients route to the survivors), then hand its
        queued-not-in-flight work to the least-loaded survivor through
        the SAME steal path live rebalancing uses — one code path, one
        set of SLO-accounting rules — and let what is already executing
        drain on the old ingest before teardown. Returns True when
        fully drained."""
        with self._fe_lock:
            if len(self._servers) <= 1:
                raise ValueError("cannot remove the last front-end")
            srv = self._servers.pop(name)
            survivors = dict(self._servers)
            self._forced_unhealthy.discard(name)
        if self.router is not None:
            self.router.forget(name)
        self.stats["frontends_removed"] += 1
        if drain and survivors:
            now = self.now_ms()
            thief_name = min(sorted(survivors),
                             key=lambda n: (survivors[n].queue_depth_ms(now),
                                            n))
            self._steal(srv, survivors[thief_name], None)
        ok = srv.stop(drain=drain, timeout=timeout)
        with self._fe_lock:
            # keep the stopped server: its completion log and stats stay
            # part of every fleet report — scale-in must not erase the
            # traffic the departed front-end served
            self._retired[name] = srv
        return ok

    # ------------------------------------------------------------ routing
    def route(self, client: str, *, digest=None) -> GraftServer:
        """Pick the front-end for ``client``: weighted scoring over the
        live signals when a router is configured (falling back to the
        HRW ring on stale/missing signals), the plain ring otherwise."""
        with self._fe_lock:
            names = list(self._servers)
            if self.router is None or len(names) < 2:
                return self._servers[rendezvous_route(client, names)]
            choice = self.router.route(client, names,
                                       now_ms=self.now_ms(), digest=digest)
            return self._servers[choice]

    def routing_table(self, clients) -> dict:
        with self._fe_lock:
            return rendezvous_table(clients, list(self._servers))

    def submit(self, req, p: int, budget_ms: float) -> int:
        """Accept one request on the client's routed front-end. Decode
        requests carry their prompt-prefix digest so the router can
        score KV-cache affinity (repeated prompts land where their
        blocks already live)."""
        digest = None
        if self.router is not None and \
                getattr(req, "max_new_tokens", 0) > 0:
            with self._fe_lock:
                srv = next(iter(self._servers.values()), None)
            if srv is not None:
                try:
                    digest = srv.request_digest(req, budget_ms)
                except Exception:
                    digest = None
        return self.route(req.client, digest=digest).submit(
            req, p, budget_ms)

    def set_health(self, name: str, healthy: bool) -> None:
        """Force-mark a front-end (un)healthy for routing and stealing.
        An unhealthy front-end is scored off the ring and its queued
        work becomes a priority steal target on the next tick; marking
        it healthy again re-admits it with no further ceremony."""
        with self._fe_lock:
            if healthy:
                self._forced_unhealthy.discard(name)
            else:
                self._forced_unhealthy.add(name)

    def _dispatch(self, results: list) -> None:
        """Hand results a shared pool flushed on one front-end, and the
        step events of streams another front-end admitted to a shared
        decode pool, to their owning front-ends (called with NO locks
        held)."""
        by_owner: dict[int, tuple] = {}
        for rid, y in results:
            owner = self.registry.get(rid)
            if owner is None:
                continue                       # completed/shed meanwhile
            by_owner.setdefault(id(owner), (owner, []))[1].append((rid, y))
        for owner, rs in by_owner.values():
            self.stats["cross_dispatched"] += len(rs)
            try:
                owner.accept_results(rs)
            except Exception:
                traceback.print_exc()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "GraftFleet":
        assert not self._started, "fleet already started"
        self._started = True
        with self._fe_lock:
            for srv in self._servers.values():
                srv.start()
        t = threading.Thread(target=self._control_loop, daemon=True,
                             name="fleet-control")
        t.start()
        self._threads.append(t)
        return self

    def stop(self, *, drain: bool = True, timeout: float = 60.0) -> bool:
        self._stop_evt.set()
        ok = True
        with self._fe_lock:
            servers = list(self._servers.values())
        for srv in servers:
            ok = srv.stop(drain=drain, timeout=timeout) and ok
        return ok

    def __enter__(self):
        return self.start() if not self._started else self

    def __exit__(self, *exc):
        self.stop(drain=False, timeout=5.0)

    # ------------------------------------------------------------ control
    def _control_loop(self):
        period_s = self._period_ms / 1e3
        while not self._stop_evt.wait(timeout=period_s):
            try:
                self.tick()
            except Exception:
                # counted: a run that must not fail reads tick_errors
                self.stats["tick_errors"] += 1
                traceback.print_exc()

    def _refresh_signals(self, now: float) -> None:
        """Push every front-end's live signals into the router: queue
        depth in ms of estimated work, recent shed fraction, forced
        health marks, and the KV prefix-affinity digest."""
        if self.router is None:
            return
        with self._fe_lock:
            servers = list(self._servers.items())
            unhealthy = set(self._forced_unhealthy)
        for name, srv in servers:
            try:
                self.router.update(
                    name, now_ms=now,
                    queue_depth_ms=srv.queue_depth_ms(now),
                    shed_frac=srv.recent_shed_frac(),
                    unhealthy=name in unhealthy,
                    affinity=srv.affinity_digest())
            except Exception:
                traceback.print_exc()

    def _steal(self, victim: GraftServer, thief: GraftServer,
               k: Optional[int] = None, *, decode: bool = True) -> int:
        """Move up to ``k`` queued-not-in-flight items (all when None;
        decode requests only when ``decode``) from ``victim``'s ingest to
        ``thief``. The extra hop is charged to each stolen request's
        shed-policy slack by ``accept_stolen`` — stealing never silently
        blows an SLO. Between the two calls a request is in neither
        front-end's count: :meth:`join` waits while a steal runs."""
        with self._steal_cond:
            self._steals_running += 1
        try:
            stolen = victim.steal_queued(k, decode=decode)
            n = thief.accept_stolen(stolen)
        finally:
            with self._steal_cond:
                self._steals_running -= 1
                self._steals_ended += 1
                self._steal_cond.notify_all()
        if n:
            self.stats["steals"] += n
            self._m_steals.inc(n)
        return n

    def _balance(self, now: float) -> None:
        """Cross-front-end work stealing. Wedged (force-unhealthy)
        front-ends are drained immediately; plain load imbalance must
        persist across two consecutive ticks above ``steal_threshold_ms``
        before half the victim's queue moves — one hot flush is not a
        reason to churn the placement the router just converged."""
        with self._fe_lock:
            servers = dict(self._servers)
            unhealthy = set(self._forced_unhealthy)
        healthy = {n: s for n, s in servers.items() if n not in unhealthy}
        if not healthy or len(servers) < 2:
            self._imbalance_ticks = 0
            return
        # deterministic thief choice: least-loaded healthy front-end,
        # name-ordered tie-break
        depths = {n: s.queue_depth_ms(now) for n, s in servers.items()}
        thief_name = min(sorted(healthy),
                         key=lambda n: (depths[n], n))
        thief = healthy[thief_name]
        # wedged front-ends first: their queue is going nowhere
        for name in sorted(unhealthy):
            srv = servers.get(name)
            if srv is not None and srv is not thief and srv.n_queued > 0:
                self._steal(srv, thief, None)
        # load imbalance is judged on PRESSURE (late work: overdue flush
        # deadlines + busy batches), not raw queue depth — a deep queue
        # of far-future flush deadlines is deliberate batching slack and
        # stealing it would just churn the placement
        pressure = {n: s.steal_pressure_ms(now) for n, s in servers.items()}
        victim_name = max(sorted(servers),
                          key=lambda n: (pressure[n], n))
        if victim_name == thief_name or victim_name in unhealthy:
            self._imbalance_ticks = 0
            return
        imb = pressure[victim_name] - pressure[thief_name]
        if imb <= self.steal_threshold_ms:
            self._imbalance_ticks = 0
            return
        self._imbalance_ticks += 1
        if self._imbalance_ticks < 2:
            return                             # must persist across a tick
        self._imbalance_ticks = 0
        victim = servers[victim_name]
        k = max(victim.n_queued // 2, 1)
        # a queued decode request waits for a slot of the decode pool
        # both front-ends share: moving it cannot start it sooner
        self._steal(victim, thief, k, decode=False)
        if self.controller is not None and \
                hasattr(self.controller, "observe_imbalance"):
            total = sum(pressure.values())
            with self._ctl_lock:
                self.controller.observe_imbalance(
                    now, imb / total if total > 0 else 0.0)

    def tick(self, *, force: bool = False):
        """One fleet control tick: routing signals refresh, persistent
        imbalance (or a wedged front-end) triggers work stealing, then
        the controller sees the fleet-wide event stream and a replan is
        applied ONCE across every front-end. A replan :meth:`apply`
        refuses (or fails to apply) is reverted in the controller, so the
        controller and the pools stay on one plan; the tick then returns
        None and a later tick replans."""
        now = self.now_ms()
        self._refresh_signals(now)
        try:
            self._balance(now)
        except Exception:
            traceback.print_exc()
        plan = None
        if self.controller is not None:
            now = self.now_ms()
            samples = self.executor.drain_uplink()
            with self._ctl_lock:
                self.controller.ingest_uplink(now, samples)
                plan = self.controller.control(now, force=force)
            if plan is not None:
                t0 = time.perf_counter()
                try:
                    self.apply(plan)
                except PlanRefused as e:
                    with self._ctl_lock:
                        self.controller.revert(str(e))
                    self.stats["applies_refused"] += 1
                    plan = None
                except Exception as e:
                    with self._ctl_lock:
                        self.controller.revert(
                            f"{type(e).__name__}: {e}")
                    raise
            if plan is not None:
                apply_ms = (time.perf_counter() - t0) * 1e3
                self.stats["timer_replans"] += 1
                self.telemetry.histogram("replan/apply_ms").record(apply_ms)
                if hasattr(self.controller, "note_apply"):
                    with self._ctl_lock:
                        self.controller.note_apply(apply_ms)
            with self._fe_lock:
                servers = list(self._servers.values())
            for srv in servers:     # requests parked before now were seen
                srv._controlled_ms = now
        # parked-request routing/expiry is NOT repeated here: each
        # front-end's own control thread still ticks those even under
        # external_control
        return plan

    def apply(self, new_plan):
        """Transition the SHARED executor under every front-end's writer
        lock, then re-sync each front-end's drivers/routes to the result.
        One executor transition, one placement migration — not one per
        front-end. Pools the plan adds are started first, outside the
        locks, where the executor can (``prepare_plan``: worker processes
        start while traffic flows). Raises :class:`PlanRefused`, before
        anything changes, when ``new_plan`` routes no chain for a client
        that still has requests in flight on a front-end (or
        ``apply_plan`` refuses)."""
        with self._fe_lock:
            servers = list(self._servers.values())
        for srv in servers:           # parked requests wait for the plan
            srv._hold_parked_until = math.inf
        try:
            self._refuse_stranding(servers, new_plan)   # before any spawn
            self.executor.prepare_plan(new_plan)
            with ExitStack() as stack:
                for srv in servers:            # fixed order: no lock cycles
                    stack.enter_context(srv._rw.write())
                self._refuse_stranding(servers, new_plan)
                diff = self.executor.apply_plan(new_plan)
                leftovers = [srv._sync_to_executor(diff) for srv in servers]
        finally:
            for srv in servers:
                srv.hold_parked()
        for srv, lo in zip(servers, leftovers):
            srv._finish_apply(lo)
        self.stats["replans_applied"] += 1
        return diff

    @staticmethod
    def _refuse_stranding(servers, plan) -> None:
        stranded = sorted({c for srv in servers
                           for c in srv.stranded_clients(plan)})
        if stranded:
            raise PlanRefused(f"clients {stranded} still have requests "
                              "in flight")

    # ------------------------------------------------------------- report
    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every front-end has completed what it was given.
        A steal moves a request to a front-end this pass may already
        have found done, so a pass counts only if no steal ran while it
        did; otherwise it is repeated."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def left() -> Optional[float]:
            return None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
        while True:
            with self._steal_cond:
                while self._steals_running:
                    if left() == 0.0:
                        return False
                    self._steal_cond.wait(timeout=left())
                ended = self._steals_ended
            with self._fe_lock:
                servers = list(self._servers.values())
            for srv in servers:
                if not srv.join(timeout=left()):
                    return False
            with self._steal_cond:
                if not self._steals_running \
                        and self._steals_ended == ended:
                    return True

    def mark(self) -> dict:
        """Per-front-end completion-log snapshot (warmup exclusion);
        covers retired front-ends too so a later ``report(since=...)``
        slices their frozen logs consistently."""
        with self._fe_lock:
            return {name: srv.mark()
                    for name, srv in [*self._servers.items(),
                                      *self._retired.items()]}

    def report(self, since: Optional[dict] = None) -> dict:
        """Fleet-wide SLO report: merged completion records (including
        retired front-ends' — scale-in does not erase served traffic),
        per-front-end breakdown, shared-pool/placement state."""
        with self._fe_lock:
            items = list(self._servers.items()) + list(self._retired.items())
            live = set(self._servers)
        recs, per_fe = [], {}
        sums = {k: 0 for k in ("rerouted", "local_finishes", "waited",
                               "shed_ingest", "shed_flush", "shed_decode",
                               "steals_in", "steals_out",
                               "kv_handoffs", "decode_local",
                               "decode_served", "decode_tokens",
                               "tick_errors")}
        batch_sizes = []
        for name, srv in items:
            rs = srv.records((since or {}).get(name, 0))
            recs.extend(rs)
            per_fe[name] = {
                "served": sum(1 for r in rs if not r.get("shed")),
                "shed": sum(1 for r in rs if r.get("shed")),
                "retired": name not in live,
                "ingest_threads": getattr(srv, "n_ingest_threads", 0)}
            for k in sums:
                sums[k] += srv.stats[k]
            batch_sizes += [s for d in list(srv._drivers.values())
                            for s in list(d.batcher.stats.batch_sizes)]
        out = summarize_records(recs)
        placement = getattr(self.executor, "placement", None)
        out.update({
            "frontends": per_fe,
            "n_frontends": len(live),
            "replans": self.stats["replans_applied"],
            "timer_replans": self.stats["timer_replans"],
            "cross_dispatched": self.stats["cross_dispatched"],
            "steals": self.stats["steals"],
            "applies_refused": self.stats["applies_refused"],
            "router": "weighted" if self.router is not None else "hrw",
            "mean_batch": float(np.mean(batch_sizes)) if batch_sizes
            else 0.0,
            "n_stage_pools": self.executor.n_stage_pools,
            "n_chips": placement.n_chips if placement is not None else 0,
            **sums,
        })
        # the fleet's own control loop counts beside the front-ends'
        out["tick_errors"] += self.stats["tick_errors"]
        return out

    @property
    def n_inflight(self) -> int:
        with self._fe_lock:
            return sum(s.n_inflight for s in self._servers.values())
