"""GraftServer — a long-running, event-driven serving runtime.

Closes the gap between the scripted request waves of
``examples/online_serving.py`` and the paper's deployment story: a
server that *runs*, wall-clock, with traffic in flight while the control
loop adapts the deployment under it.

Data path::

    client threads ──submit()──> ingest queue (non-blocking)
        ingest thread: mobile fragment [0,p) -> payload, route lookup
            └─> per-pool MicroBatcher (deadline-aware, EDF)
                  pool driver thread (one per stage pool):
                      batch closes on max_batch OR flush-deadline
                      -> uplink submit (per client, measured/shaped)
                      -> batched execute over the transport channel
                      -> results feed the NEXT stage's batcher
                         or complete the request
    timer thread: every control_period_ms
        drain_uplink() -> controller.ingest_uplink -> controller.control()
        -> apply_plan diff on the LIVE executor (write-locked instant)

Because every stage pool has its own driver, a depth-1 hop for one
client overlaps depth-0 batching for another — nothing lock-steps per
depth the way :meth:`GraftExecutor.serve` does. Requests are held
*server-side* (payload in the batcher) until their batch closes, so pool
queues on the wire side are empty between batches; a replan that removes
a one-shot pool can proceed at once, and anything still waiting in the
removed pool's batcher is **rerouted**: re-enqueued at the same block
boundary in the client's new chain when one exists, or finished locally
by running the remaining blocks ``[boundary, L)`` in-process — never
dropped, always numerically exact. The control tick refuses a replan
that drops a client with requests still in flight, and ``apply_plan``
one that removes a pool still holding resident decode streams (or
wire-side queued requests); the controller then reverts to the deployed
plan and a later tick replans once that work is done.

Locking: a readers/writer lock around the deployment. Drivers and the
ingest thread are readers (fully concurrent — this is the pipelining);
``apply`` is the writer, so a plan transition waits for in-flight
batches, mutates pools/routes atomically, and releases. The controller
has its own leaf lock (its sliding windows are not thread-safe).

On one card every driver and ingest thread launches its kernels on the
thread's current stream, which is the device's default stream unless a
thread sets one; none here does. The decode and scan kernels keep one
scratch buffer (and its atomic tickets) per device and assume one launch
in flight at a time, so the threads must share that one stream until the
scratch is kept per stream. Results stay torch tensors: a one-shot
result is the host tensor its last pool hop framed, a decode result the
generated token ids.
"""
from __future__ import annotations

import math
import threading
import time
import traceback
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serving.batcher import (BatchItem, MicroBatcher, ShedPolicy,
                                   flush_deadline_ms, hopeless,
                                   remaining_cost_ms)
from repro_torch.serving.executor import (GraftExecutor, PlanRefused,
                                          PoolDrainingError, ServeRequest)
from repro_torch.serving.simulator import _routing
from repro_torch.serving.telemetry import (Histogram, NULL as NULL_TELEMETRY,
                                     Telemetry)

__all__ = ["GraftServer", "PoolDriver", "check_serve_report",
           "run_serve_loop", "summarize_records"]

MAX_RECORDS = 65_536      # completion-log cap; oldest roll off the front


class _RWLock:
    """Readers/writer lock, writer-priority (pending writers block new
    readers so a replan can't be starved by a busy pipeline)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


def _one_shot(item: BatchItem) -> bool:
    return not item.decode


@dataclass
class _InFlight:
    """Server-side state of one accepted request."""
    req: ServeRequest
    p: int
    budget_ms: float
    t_submit_ms: float               # when the client handed it over
    t_arrive_ms: float               # mobile part done, payload ready
    deadline_ms: float               # t_arrive + budget
    chain: list = field(default_factory=list)   # [PoolKey, ...]
    stage: int = 0
    rerouted: int = 0
    steal_hops: int = 0              # cross-front-end work-steal moves
    local: bool = False              # finished by the in-process fallback
    shed_exempt: bool = False        # budget-forced admit: never shed later
    trace: bool = False              # won the telemetry span-sampling draw
    # -- decode (autoregressive) requests only --
    decode: bool = False
    max_new: int = 0                 # decode length budget
    tpot_ms: float = 0.0             # per-token budget after the first
    ttft_deadline_ms: float = 0.0    # first token must land by here;
                                     # deadline_ms then bounds the last
    t_first_ms: float = 0.0          # when the first token was emitted
    n_gen: int = 0                   # tokens emitted so far
    decode_retries: int = 0          # soft admission refusals seen


class PoolDriver(threading.Thread):
    """One stage pool's independent flush loop."""

    def __init__(self, server: "GraftServer", key: tuple, spec):
        super().__init__(daemon=True,
                         name=f"pool-driver-{key[0]}-{key[1]}-{key[2]}")
        self.server = server
        self.key = key
        self.batcher = MicroBatcher(max_batch=max(spec.batch, 1),
                                    max_tokens=server.token_budget)
        self.model_est_ms = server._model_stage_cost(spec)
        self.exec_ewma_ms: Optional[float] = None   # measured batch wall
        self.busy_until_ms = 0.0     # estimated end of the batch in flight
        self.stop_flag = False
        self.n_batches = 0
        # continuous-batching decode session: the pool's slot occupancy
        # as the replies to THIS driver's own steps, admits and aborts
        # gave it. A fleet's shared pool also holds other front-ends'
        # streams: whichever driver the pool last served a step or admit
        # holds a count of at least the pool's occupancy, so a resident
        # stream is always stepped
        self.decode_free = max(spec.batch, 1)
        self.decode_active = 0
        # the streams this front-end admitted and must complete: ownership
        # only, never a count (events may reach it on another's thread)
        self.decode_resident: dict[int, str] = {}    # rid -> client
        self.decode_step_ewma: Optional[float] = None
        # fleet mode: another front-end's streams hold the shared decode
        # pool's slots; no admission is tried before this (monotonic s)
        self.slot_wait_until = 0.0

    def est_cost_ms(self) -> float:
        """Per-batch cost estimate: measured EWMA once the pool has run,
        the cost-model prediction before that."""
        return self.exec_ewma_ms if self.exec_ewma_ms is not None \
            else self.model_est_ms

    def note_exec(self, wall_ms: float) -> None:
        e = self.exec_ewma_ms
        self.exec_ewma_ms = wall_ms if e is None else 0.8 * e + 0.2 * wall_ms
        self.n_batches += 1

    def tpot_est_ms(self) -> float:
        """Measured per-decode-step wall EWMA; before any step has run,
        fall back to the stage cost model (a decode step is at most one
        full forward of the pool's range)."""
        return self.decode_step_ewma if self.decode_step_ewma is not None \
            else max(self.model_est_ms, 1.0)

    def note_decode_step(self, wall_ms: float) -> None:
        e = self.decode_step_ewma
        self.decode_step_ewma = wall_ms if e is None \
            else 0.8 * e + 0.2 * wall_ms

    def run(self):
        srv = self.server
        while True:
            if self.stop_flag or self.batcher.stopped:
                return
            batch, foreign, stepped = None, None, False
            waiting = self.slot_wait_until - time.monotonic()
            with srv._rw.read():
                if self.stop_flag:
                    return
                if self.decode_active:
                    # a decode batch is resident: advance it one token.
                    # One step per lock acquisition — a replan (writer)
                    # interleaves between steps, never waits out a full
                    # decode stream
                    stepped = True
                    try:
                        foreign = srv._decode_tick(self)
                    except Exception:
                        traceback.print_exc()
                elif waiting <= 0:
                    batch = self.batcher.pop_ready(srv.now_ms())
                    if batch:
                        try:
                            foreign = srv._run_batch(self, batch)
                        except Exception:
                            # the driver thread must NEVER die with work
                            # outstanding: salvage the popped batch so
                            # join() can't strand, then keep serving
                            traceback.print_exc()
                            srv._salvage(batch)
            # fleet mode: a shared pool's flush can return requests OWNED
            # BY ANOTHER FRONT-END — hand them over OUTSIDE our read
            # section (the receiving server takes its own lock; nesting
            # the two would deadlock against a fleet-wide writer)
            if foreign:
                try:
                    srv.foreign_router(foreign)
                except Exception:
                    traceback.print_exc()
            if waiting > 0 and not stepped:
                time.sleep(min(waiting, 0.02))
            elif not batch and not stepped:
                self.batcher.wait_for_work(srv.now_ms())


class GraftServer:
    """Event-driven serving runtime over a (local or remote) executor.

    ``executor`` is owned by the caller; the server adds driver/ingest/
    control threads on top and tears only those down on :meth:`stop`.
    """

    def __init__(self, executor: GraftExecutor, *, controller=None,
                 book=None, hop_default_ms: float = 1.0,
                 waiting_grace_ms: Optional[float] = None,
                 ingest_threads: Optional[int] = None,
                 shed_policy: Optional[ShedPolicy] = None,
                 flush_safety_frac: float = 0.15,
                 token_budget: int = 0,
                 name: str = "graft",
                 clock: Optional[Callable[[], float]] = None,
                 ctl_lock: Optional[threading.Lock] = None,
                 external_control: bool = False,
                 registry: Optional[dict] = None,
                 foreign_router: Optional[Callable] = None,
                 decode_continuous: bool = True,
                 tpot_default_ms: float = 50.0,
                 telemetry=None):
        self.executor = executor
        # default to the executor's registry so in-process pools and the
        # server share one (merge-free); NULL when neither is enabled.
        # Instruments are pre-bound ONCE — the disabled hot path is a
        # single no-op method call per site.
        self.telemetry = telemetry if telemetry is not None \
            else getattr(executor, "telemetry", NULL_TELEMETRY)
        tel = self.telemetry
        self._m_ingested = tel.counter("server/ingested")
        self._m_completed = tel.counter("server/completed")
        self._m_shed = tel.counter("server/shed")
        self._m_latency_ms = tel.histogram("server/latency_ms")
        self._m_queue_ms = tel.histogram("server/queue_ms")
        self._m_uplink_ms = tel.histogram("server/uplink_ms")
        self._m_uplink_bytes = tel.histogram("server/uplink_bytes")
        self._m_exec_ms = tel.histogram("server/exec_ms")
        self._m_ttft_ms = tel.histogram("server/ttft_ms")
        self._m_tpot_ms = tel.histogram("server/tpot_ms")
        self._m_handoff_ms = tel.histogram("server/kv_handoff_ms")
        self._m_apply_ms = tel.histogram("replan/apply_ms")
        self._m_inflight = tel.gauge("server/inflight")
        self.controller = controller
        self.book = book
        self.cfg = executor.cfg
        self.name = name
        self.hop_default_ms = hop_default_ms
        # token-budget-aware batching: > 0 closes a pool's batch when its
        # pending payload TOKENS reach the budget, so packed buffers stay
        # inside one token bucket instead of growing with queue depth
        self.token_budget = max(int(token_budget), 0)
        # decode serving: continuous admits new requests into a RUNNING
        # decode batch at step boundaries; False degrades to the "waved"
        # baseline (a new wave only starts once the batch fully drains)
        self.decode_continuous = decode_continuous
        self.tpot_default_ms = float(tpot_default_ms)
        self._period_ms = getattr(controller, "control_period_ms", 250.0)
        self.waiting_grace_ms = waiting_grace_ms \
            if waiting_grace_ms is not None else 4.0 * self._period_ms
        # fleet plumbing: a GraftFleet shares ONE clock, controller lock,
        # rid->server registry, and shed policy across its front-ends and
        # owns the control loop itself (external_control). Standalone
        # servers get private defaults and keep controlling themselves.
        self.shed_policy = shed_policy
        # batches used to close at the LAST instant that could still meet
        # the SLO — which lands every deadline-closed request exactly ON
        # the boundary, where scheduler jitter decides the attainment
        # coin-flip (and the flush-time shed check sees everything as
        # marginal). Reserve a slice of the budget as headroom instead.
        self.flush_safety_frac = flush_safety_frac
        self.ingest_threads = ingest_threads      # None -> min(4, n_clients)
        self.external_control = external_control
        self.registry = registry
        self.foreign_router = foreign_router
        self._clock = clock
        # exec-duration measurement rides the SAME injectable clock as
        # now_ms(): under a fake clock every EWMA (exec, uplink window)
        # becomes deterministic instead of soaking up host jitter
        self._perf = clock if clock is not None \
            else (lambda: time.perf_counter() * 1e3)

        self._rw = _RWLock()
        self._ctl_lock = ctl_lock if ctl_lock is not None \
            else threading.Lock()
        self._drivers: dict[tuple, PoolDriver] = {}
        self._local_handles: dict[tuple, object] = {}   # per-server channels
        self._routes: dict[str, list] = {}
        self._inflight: dict[int, _InFlight] = {}

        self._ingest_q: deque = deque()
        self._ingest_cond = threading.Condition()
        self._stop_ingest = False

        self._wait_lock = threading.Lock()
        self._waiting: list = []                 # (rid, payload, t_ms)

        self._done_cond = threading.Condition()
        self._records: list = []
        self._records_base = 0           # completions trimmed off the front
        self._n_submitted = 0
        self._n_done = 0

        self._uplink_ewma: dict[str, float] = {}

        # prefill/decode disaggregation state: measured cross-pool KV
        # handoff times (the report's kv_handoff_ms and the shed model's
        # handoff charge), per-pool residency-digest cache (pool-level
        # KV-affinity: refreshed lazily with a short TTL so prefill-pool
        # choice doesn't pay a stats round trip per admission), and the
        # decode-local completion counts the controller's disagg_pressure
        # trigger watches between ticks
        self._handoff_samples: deque = deque(maxlen=4096)
        self._handoff_ewma_ms: Optional[float] = None
        self._residency_cache: dict[tuple, tuple] = {}   # key -> (t, set)
        self.residency_ttl_ms = 250.0
        self._disagg_mark = (0, 0)            # (decode_local, decode_served)

        # router signal state: recent admit/shed outcomes (shed-rate
        # scoring) and digests of prompt prefixes whose KV blocks were
        # admitted through THIS front-end (cache-affinity scoring)
        self._outcomes: deque = deque(maxlen=256)    # True = shed
        self._affinity_lock = threading.Lock()
        self._affinity: deque = deque()
        self._affinity_set: set = set()
        self.affinity_cap = 1024

        self._stop_evt = threading.Event()
        self._kick = threading.Event()
        # parked requests do not expire before this (now_ms clock): a
        # replan being deployed (a worker spawn can outlast the grace) or
        # refused and to be retried may cover them
        self._hold_parked_until = 0.0
        # when the controller last finished a look at the traffic (the
        # fleet's tick sets it under external control): a request parked
        # after that has not been seen by a replan yet
        self._controlled_ms = -math.inf
        self._threads: list[threading.Thread] = []
        self._started = False
        self._closed = False

        self.stats = {"replans_applied": 0, "timer_replans": 0,
                      "rerouted": 0, "local_finishes": 0,
                      "waited": 0, "batches": 0,
                      "shed_ingest": 0, "shed_flush": 0,
                      "shed_decode": 0, "decode_served": 0,
                      "decode_tokens": 0, "decode_local": 0,
                      "kv_handoffs": 0, "applies_refused": 0,
                      "tick_errors": 0, "steals_in": 0, "steals_out": 0}
        self._t0 = time.monotonic()

    # -------------------------------------------------------------- clock
    def now_ms(self) -> float:
        if self._clock is not None:        # fleet mode: one shared clock
            return self._clock()
        return (time.monotonic() - self._t0) * 1e3

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "GraftServer":
        assert not self._started, "server already started"
        self._started = True
        with self._rw.write():
            for key, spec in self.executor.pool_specs().items():
                drv = PoolDriver(self, key, spec)
                self._drivers[key] = drv
                drv.start()
            self._routes = self.executor.route_table()
        # mobile parts used to serialize on ONE ingest thread; default one
        # thread per routed client up to 4 so concurrent clients' device
        # fragments overlap (the shared deque + condition is already
        # multi-consumer safe)
        self.n_ingest_threads = self.ingest_threads if self.ingest_threads \
            else min(4, max(len(self._routes), 1))
        for i in range(self.n_ingest_threads):
            t = threading.Thread(target=self._ingest_loop, daemon=True,
                                 name=f"{self.name}-ingest-{i}")
            t.start()
            self._threads.append(t)
        # the timer thread always runs: with no controller it still
        # routes/grace-expires parked requests so join() can't strand
        t = threading.Thread(target=self._control_loop, daemon=True,
                             name=f"{self.name}-control")
        t.start()
        self._threads.append(t)
        return self

    def stop(self, *, drain: bool = True, timeout: float = 60.0) -> bool:
        """Stop ingest, optionally wait for in-flight work, then halt the
        control loop and drivers. Returns True when fully drained."""
        with self._ingest_cond:
            self._stop_ingest = True
            self._ingest_cond.notify_all()
        ok = self.join(timeout=timeout) if drain else True
        self._stop_evt.set()
        self._kick.set()
        with self._rw.write():
            for drv in self._drivers.values():
                drv.stop_flag = True
                drv.batcher.stop()
            self._drop_local_handles()
        self._closed = True
        return ok

    def __enter__(self):
        return self.start() if not self._started else self

    def __exit__(self, *exc):
        self.stop(drain=False, timeout=5.0)

    # -------------------------------------------------------------- ingest
    def submit(self, req: ServeRequest, p: int, budget_ms: float) -> int:
        """Accept one request (non-blocking; returns its rid). The ingest
        thread runs the mobile fragment and routes the payload."""
        if self._closed or self._stop_ingest:
            raise RuntimeError("server is stopped")
        rid = self.executor.next_rid()
        with self._ingest_cond:
            if self.registry is not None:      # fleet: results may surface on
                self.registry[rid] = self      # ANOTHER front-end's flush
            self._ingest_q.append((rid, req, p, budget_ms, self.now_ms()))
            self._n_submitted += 1
            self._ingest_cond.notify_all()
        return rid

    def _ingest_loop(self):
        while True:
            with self._ingest_cond:
                while not self._ingest_q and not self._stop_ingest:
                    self._ingest_cond.wait(timeout=0.1)
                if self._ingest_q:
                    job = self._ingest_q.popleft()
                elif self._stop_ingest:
                    return
                else:
                    continue
            try:
                self._ingest_one(*job)
            except Exception:
                traceback.print_exc()
                self._inflight.pop(job[0], None)
                if self.registry is not None:    # don't leak the rid slot
                    self.registry.pop(job[0], None)
                with self._done_cond:        # never strand join()
                    self._n_done += 1
                    self._done_cond.notify_all()

    def _ingest_one(self, rid, req, p, budget_ms, t_submit):
        if getattr(req, "max_new_tokens", 0) > 0:
            self._ingest_decode(rid, req, budget_ms, t_submit)
            return
        t_mob0 = self.now_ms()
        payload = self.executor.mobile_part(req, p)
        now = self.now_ms()
        # the server-side clock starts when the payload LEAVES the
        # device: submit time plus the device compute itself — NOT `now`,
        # which would silently exclude time spent queued behind other
        # clients' mobile parts in the single ingest thread. Queue wait
        # counts against the budget; simulated device compute does not.
        t_arrive = t_submit + (now - t_mob0)
        if self.controller is not None:
            with self._ctl_lock:
                self.controller.observe_arrival(now, req.client,
                                                self.cfg.name, p, budget_ms)
        st = _InFlight(req=req, p=p, budget_ms=budget_ms,
                       t_submit_ms=t_submit, t_arrive_ms=t_arrive,
                       deadline_ms=t_arrive + budget_ms,
                       trace=self.telemetry.want_trace(rid))
        self._inflight[rid] = st
        self._m_ingested.inc()
        self._m_inflight.set(len(self._inflight))
        if st.trace:
            self.telemetry.span("ingest", "server", now - t_submit,
                                rid=rid, tid=self.name,
                                args={"client": req.client, "p": p})
        with self._rw.read():
            chain = self._routes.get(req.client)
            if chain and chain[0][1] == p:
                st.chain = list(chain)
                t_sc = self._perf()
                shed = self._shed_at_ingest(rid, st, now)
                if st.trace:
                    self.telemetry.span("shed-check", "server",
                                        self._perf() - t_sc, rid=rid,
                                        tid=self.name, args={"shed": shed})
                if shed:
                    return
                self._enqueue_stage(rid, st, payload)
                return
        # no chain for this (client, p) yet — a shifted/unknown client
        # arrived before the plan covers it. Park it and kick the control
        # loop so the replan happens NOW, not at the next timer edge.
        with self._wait_lock:
            self._waiting.append((rid, payload, now))
        self.stats["waited"] += 1
        self._kick.set()

    # ----------------------------------------------------- decode ingest
    def _ingest_decode(self, rid, req, budget_ms, t_submit):
        """Autoregressive ingest: no mobile part (the device ships raw
        token ids; the full-range pool owns the KV cache), and a two-part
        deadline contract — the first token must land within ``budget_ms``
        (TTFT), then every further token earns one TPOT budget, so
        ``deadline_ms`` bounds the LAST token."""
        now = self.now_ms()
        max_new = max(int(req.max_new_tokens), 1)
        tpot = float(req.tpot_budget_ms) if req.tpot_budget_ms > 0 \
            else self.tpot_default_ms
        st = _InFlight(req=req, p=0, budget_ms=budget_ms,
                       t_submit_ms=t_submit, t_arrive_ms=t_submit,
                       deadline_ms=t_submit + budget_ms
                       + tpot * (max_new - 1),
                       decode=True, max_new=max_new, tpot_ms=tpot,
                       ttft_deadline_ms=t_submit + budget_ms,
                       trace=self.telemetry.want_trace(rid))
        if self.controller is not None:
            with self._ctl_lock:
                self.controller.observe_arrival(now, req.client,
                                                self.cfg.name, 0, budget_ms)
        self._inflight[rid] = st
        self._m_ingested.inc()
        self._m_inflight.set(len(self._inflight))
        if st.trace:
            self.telemetry.span("ingest", "server", now - t_submit,
                                rid=rid, tid=self.name,
                                args={"client": req.client, "decode": True})
        with self._rw.read():
            chain = self._decode_chain(req.client)
            if chain is not None:
                st.chain = chain
                if self._shed_decode_at_ingest(rid, st, now):
                    return
                self._enqueue_decode(rid, st)
                return
        # no decode-capable pool routed for this client: decode in-process
        # (numerically identical) so generative traffic never strands
        self._decode_local(rid, st, np.asarray(req.tokens))

    def _decode_chain(self, client: str) -> Optional[list]:
        """Decode needs ONE pool spanning the whole model — the paged
        cache lives pool-side, so the chain must resolve to a single
        full-range pool that *owns* resident streams. A "both"-role
        single-pool route serves decode directly (the continuous path).
        Otherwise — multi-stage chain, or the full-range pool is
        prefill-role under disaggregation — decode is served by a
        decode-role pool when the executor deployed one, which is what
        unlocks decode on plans whose one-shot route is multi-stage."""
        from repro_torch.models import n_fragment_units
        full = (0, n_fragment_units(self.cfg))
        chain = self._routes.get(client)
        if chain and len(chain) == 1:
            key = chain[0]
            if (key[1], key[2]) == full and \
                    self._pool_role(key) == "both":
                return list(chain)
        dpools = getattr(self.executor, "decode_pool_keys", None)
        if dpools is not None:
            for key in dpools():
                if (key[1], key[2]) == full:
                    return [key]
        return None

    def _pool_role(self, key: tuple) -> str:
        role_of = getattr(self.executor, "pool_role", None)
        return role_of(key) if role_of is not None else "both"

    def _reuse_sig(self, client: str, budget_ms: float) -> tuple:
        """Prefix-sharing key: the planner's reuse signature of the
        fragment this request came from, so requests the plan treats as
        the same workload share prompt KV blocks."""
        from repro_torch.core.fragment import Fragment
        from repro_torch.core.reuse import fragment_signature
        quantum = getattr(getattr(self.controller, "planner", None),
                          "budget_quantum_ms", 5.0)
        frag = Fragment(model=self.cfg.name, p=0, t=budget_ms, q=0.0,
                        client=client)
        return fragment_signature(frag, quantum)

    def request_digest(self, req: ServeRequest, budget_ms: float) -> tuple:
        """Prompt-prefix digest of one request (reuse signature + chunked
        prompt hashes) — what the fleet router matches against each
        front-end's :meth:`affinity_digest` so repeated prompts land
        where their KV blocks already live."""
        from repro_torch.serving.kvcache import prefix_digest
        return prefix_digest(self._reuse_sig(req.client, budget_ms),
                             np.asarray(req.tokens).reshape(-1),
                             self._kv_block_tokens())

    def _note_affinity(self, digests) -> None:
        """Record prompt-prefix digests admitted through this front-end
        (bounded LRU — the router's cache-affinity signal)."""
        with self._affinity_lock:
            for d in digests:
                if d in self._affinity_set:
                    continue
                while len(self._affinity) >= self.affinity_cap:
                    self._affinity_set.discard(self._affinity.popleft())
                self._affinity.append(d)
                self._affinity_set.add(d)

    def affinity_digest(self) -> frozenset:
        """Digests of prompt prefixes whose KV was admitted here."""
        with self._affinity_lock:
            return frozenset(self._affinity_set)

    def _decode_sig(self, st: _InFlight) -> tuple:
        return self._reuse_sig(st.req.client, st.budget_ms)

    def _kv_block_tokens(self) -> int:
        return int(getattr(self.executor, "kv_block_tokens", 0) or 16)

    def _shed_decode_at_ingest(self, rid: int, st: _InFlight,
                               now: float) -> bool:
        """Admission control for decode requests: provably blown when
        either the FIRST token cannot meet the TTFT deadline or the
        stream cannot finish by the absolute deadline at the pool's
        measured step rate. The shed budget is charged the REMAINING
        decode length — dropping a 64-token stream costs 64 admission
        slots, not 1. Returns True when shed."""
        if self.shed_policy is None:
            return False
        drv = self._drivers.get(st.chain[0])
        est_first = self._est_remaining_ms(st, at_stage=0,
                                           include_backlog=True, now=now)
        tpot_est = drv.tpot_est_ms() if drv is not None \
            else self.hop_default_ms
        blown = ShedPolicy.hopeless_decode(now, st.ttft_deadline_ms,
                                           est_first, st.deadline_ms,
                                           tpot_est, st.max_new)
        if not blown:
            self.shed_policy.note_admitted(st.req.client, weight=st.max_new)
            return False
        if not self.shed_policy.should_shed(st.req.client,
                                            charge=st.max_new):
            st.shed_exempt = True                  # budget-forced admit
            return False
        self._shed(rid, st, "decode")
        return True

    def _enqueue_decode(self, rid: int, st: _InFlight) -> None:
        """Queue a decode request on its pool's batcher (caller holds the
        read lock). ``flush_ms`` is NOW: admission is iteration-level —
        the driver pulls decode items at step boundaries via ``take()``,
        so there is nothing to gain by holding the batch open."""
        key = st.chain[0]
        drv = self._drivers.get(key)
        toks = np.asarray(st.req.tokens, np.int32).reshape(-1)
        if drv is None or drv.stop_flag:
            self._decode_local(rid, st, toks)
            return
        now = self.now_ms()
        drv.batcher.put(BatchItem(
            rid=rid, client=st.req.client, payload=toks,
            flush_ms=now, deadline_ms=st.deadline_ms,
            boundary=0, enqueued_ms=now, n_tokens=int(toks.shape[0]),
            trace=st.trace, decode=True, max_new=st.max_new,
            ttft_deadline_ms=st.ttft_deadline_ms,
            tpot_budget_ms=st.tpot_ms))

    # ------------------------------------------------------------ routing
    def _wire_extras(self, req: ServeRequest) -> Optional[dict]:
        return self.executor._wire_extras(req)

    def _chain_costs(self, chain: list) -> list:
        specs = self.executor.pool_specs()
        out = []
        for key in chain:
            drv = self._drivers.get(key)
            if drv is not None:
                out.append(drv.est_cost_ms())
            elif key in specs:
                out.append(self._model_stage_cost(specs[key]))
            else:
                out.append(self.hop_default_ms)
        return out

    def _downstream_backlog_ms(self, chain: list, after_stage: int) -> float:
        """Serialized uplink work already queued at stages STRICTLY after
        ``after_stage`` — head-of-line time a request will lose waiting
        for those drivers to push other clients' transfers. The stage
        cost model alone cannot see this network-bound backlog."""
        now = self.now_ms()
        total = 0.0
        for key in chain[after_stage + 1:]:
            drv = self._drivers.get(key)
            if drv is not None:
                # queued uplink charges + the batch the driver is ALREADY
                # sleeping through (popped, so absent from the queue)
                total += drv.batcher.pending_hop_ms \
                    + max(drv.busy_until_ms - now, 0.0)
        return total

    def _model_stage_cost(self, spec) -> float:
        if self.book is None or spec.model not in self.book:
            return 5.0
        return float(self.book[spec.model].latency_ms(
            spec.start, spec.end, max(spec.batch, 1), max(spec.share, 1)))

    def _hop_ms(self, client: str) -> float:
        return self._uplink_ewma.get(client, self.hop_default_ms)

    def _note_uplink(self, client: str, ms: float) -> None:
        e = self._uplink_ewma.get(client)
        self._uplink_ewma[client] = ms if e is None else 0.7 * e + 0.3 * ms

    # ---------------------------------------------------- admission / shed
    def _est_remaining_ms(self, st: _InFlight, *, at_stage: int,
                          include_backlog: bool = False,
                          now: Optional[float] = None) -> float:
        """Uplink EWMA + remaining-stage cost from ``at_stage`` on —
        the provably-blown test's left-hand side. ``include_backlog``
        additionally charges the queue a NEW request would join at the
        entry stage: the uplink time its pool channel must serialize for
        already-queued stage-0 items (the network-bound backlog the
        stage cost model can't see), execution of the full batches
        ahead, and the batch the entry driver is ALREADY pushing
        (``busy_until_ms`` — popped items are absent from the queue, so
        without this charge an uplink-bound pool looks idle at ingest
        exactly while it is sleeping through transfers, and the shed
        lands late at batch close instead). Flush-time items are already
        at the head, so no backlog."""
        costs = self._chain_costs(st.chain)
        hop = self._hop_ms(st.req.client) if at_stage == 0 \
            else self.hop_default_ms
        est = remaining_cost_ms(costs, at_stage, hop_ms=hop) \
            + self._downstream_backlog_ms(st.chain, at_stage)
        if include_backlog:
            drv = self._drivers.get(st.chain[at_stage]) \
                if at_stage < len(st.chain) else None
            if drv is not None:
                t = self.now_ms() if now is None else now
                full_batches = len(drv.batcher) // max(drv.batcher.max_batch,
                                                       1)
                est += drv.batcher.pending_hop_ms \
                    + full_batches * drv.est_cost_ms() \
                    + max(drv.busy_until_ms - t, 0.0)
        return est

    def _shed_at_ingest(self, rid: int, st: _InFlight, now: float) -> bool:
        """Admission control at the door (caller holds the read lock):
        a request whose deadline is provably blown before it is even
        queued is shed — unless the client's shed budget says otherwise
        (then it is admitted AND exempt from every later checkpoint).
        Returns True when the request was shed."""
        if self.shed_policy is None:
            return False
        blown = hopeless(now, st.deadline_ms,
                         self._est_remaining_ms(st, at_stage=0,
                                                include_backlog=True,
                                                now=now))
        if not blown:
            self.shed_policy.note_admitted(st.req.client)
            return False
        if not self.shed_policy.should_shed(st.req.client):
            st.shed_exempt = True                  # budget-forced admit
            return False
        self._shed(rid, st, "ingest")
        return True

    def _shed_at_flush(self, item: BatchItem, st: _InFlight,
                       now: float, extra_ms: float = 0.0) -> bool:
        """Drop decision when a batch closes: requests that became
        hopeless while queued (bandwidth faded, batch ahead overran) are
        dropped instead of burning pool time on a guaranteed SLO miss.
        ``extra_ms`` charges work between this item and its result that
        the chain estimate can't see (its batch companions' uplinks —
        the flush only fires after every submit in the batch). The
        flush-safety margin is demanded as headroom here too: this is
        the LAST checkpoint before real link/pool time is spent, so a
        request that could only finish exactly on the boundary (where
        execution variance decides) is dropped rather than gambled on."""
        if st.shed_exempt:
            return False
        margin = self.flush_safety_frac * max(st.budget_ms, 0.0)
        blown = hopeless(now, item.deadline_ms - margin, extra_ms +
                         self._est_remaining_ms(st, at_stage=st.stage))
        if not blown or not self.shed_policy.should_shed(item.client):
            if blown:
                st.shed_exempt = True              # budget-forced admit
            return False
        self._shed(item.rid, st, "flush")
        return True

    def _shed(self, rid: int, st: _InFlight, where: str) -> None:
        """Retire a request WITHOUT serving it (the simulator's drop,
        now on the live path). Sheds count toward join() and land in the
        completion log flagged, so reports can split p99-of-admitted
        from offered load."""
        self._inflight.pop(rid, None)
        if self.registry is not None:
            self.registry.pop(rid, None)
        self._outcomes.append(True)
        self.stats["shed_" + where] += 1
        self._m_shed.inc()
        self._m_inflight.set(len(self._inflight))
        t = self.now_ms()
        if st.trace:
            self.telemetry.span("shed", "server", 0.0, rid=rid,
                                tid=self.name,
                                args={"client": st.req.client,
                                      "where": where})
        self._push_record({
            "rid": rid, "client": st.req.client, "p": st.p,
            "latency_ms": t - st.t_arrive_ms, "budget_ms": st.budget_ms,
            "ok": False, "shed": True, "rerouted": st.rerouted,
            "local": st.local, "decode": st.decode, "t_done_ms": t})
        if self.controller is not None:
            with self._ctl_lock:
                self.controller.observe_shed(t, st.req.client)

    def _enqueue_stage(self, rid: int, st: _InFlight, payload) -> None:
        """Queue ``payload`` for stage ``st.stage`` of the request's
        chain; caller holds the read (or write) lock."""
        key = st.chain[st.stage]
        drv = self._drivers.get(key)
        if drv is None or drv.stop_flag:
            # the chain this request was routed on is stale (a replan
            # landed since): re-home it like a drained leftover — same
            # boundary in the NEW chain first, local finish as last
            # resort. Bounded so a route/driver mismatch can't ping-pong.
            now = self.now_ms()
            if st.rerouted >= 3:
                self._finish_local(rid, st, payload, boundary=key[1])
            else:
                self._reroute_item(BatchItem(
                    rid=rid, client=st.req.client, payload=payload,
                    flush_ms=now, deadline_ms=st.deadline_ms,
                    extras=self._wire_extras(st.req), boundary=key[1],
                    enqueued_ms=now, trace=st.trace,
                    n_tokens=int(payload.shape[0])))
            return
        now = self.now_ms()
        # only stage 0 still faces the client uplink; deeper stages ride
        # server-internal execute frames. The safety margin keeps the
        # batch-close off the exact SLO boundary.
        hop = self._hop_ms(st.req.client) if st.stage == 0 \
            else self.hop_default_ms
        margin = self.flush_safety_frac * max(st.budget_ms, 0.0) \
            + self._downstream_backlog_ms(st.chain, st.stage)
        flush = flush_deadline_ms(st.deadline_ms - margin,
                                  self._chain_costs(st.chain), st.stage,
                                  now, hop_ms=hop)
        drv.batcher.put(BatchItem(
            rid=rid, client=st.req.client, payload=payload,
            flush_ms=flush, deadline_ms=st.deadline_ms,
            extras=self._wire_extras(st.req), boundary=key[1],
            enqueued_ms=now, trace=st.trace,
            hop_charge_ms=hop if st.stage == 0 else 0.0,
            n_tokens=int(payload.shape[0])))

    # ------------------------------------------------------------ execute
    def _run_batch(self, driver: PoolDriver, batch: list):
        """Execute one closed batch on the driver's pool (read lock held):
        stage-0 items pay the per-client uplink submit (measured/shaped
        individually), deeper items ride one batched execute frame.
        Returns results owned by another front-end (fleet mode) for the
        caller to dispatch outside the lock, or None."""
        handle = self._pool_handle(driver.key)
        # decode items reach pop_ready only while the pool has NO running
        # decode batch (the driver switches to _decode_tick otherwise):
        # admit them here, then run any remaining one-shot items normally
        decode_items = [it for it in batch if it.decode]
        if decode_items:
            for it in decode_items:
                self._decode_admit(driver, handle, it)
            batch = [it for it in batch if not it.decode]
            if not batch:
                return None
        now = self.now_ms()
        pool_tid = "pool/{}/{}-{}".format(*driver.key)
        stage0, later = [], []
        for it in batch:
            st = self._inflight.get(it.rid)
            if st is None:
                continue
            # stage-0 items are checked per item in the submit loop below
            # (their batch position costs them uplink slack)
            if st.stage != 0 and self.shed_policy is not None \
                    and self._shed_at_flush(it, st, now):
                continue
            if it.trace:
                q_ms = now - it.enqueued_ms
                self._m_queue_ms.record(q_ms)
                self.telemetry.span("queue", "server", q_ms,
                                    rid=it.rid, tid=pool_tid,
                                    args={"stage": st.stage})
            (stage0 if st.stage == 0 else later).append(it)
        if not stage0 and not later:
            return None
        driver.busy_until_ms = self.now_ms() \
            + sum(it.hop_charge_ms for it in stage0) + driver.est_cost_ms()
        # exec_ms accumulates ONLY pool execution: the uplink submits are
        # charged separately (hop EWMA) by every deadline/admission
        # estimate — folding their (possibly realtime-shaped) wall time
        # into exec_ewma double-counts the hop and, under load, inflates
        # remaining-cost estimates until every request looks hopeless
        exec_ms = 0.0
        results = []
        try:
            if later:
                # deeper-stage items first: they are closest to their
                # deadlines and must not wait behind this same batch's
                # stage-0 uplink transfers
                t0 = self._perf()
                results += handle.execute(
                    [(it.rid, it.client, it.payload, it.extras, it.trace)
                     for it in later])
                exec_ms += self._perf() - t0
            companions = sum(it.hop_charge_ms for it in stage0)
            for it in stage0:
                companions -= it.hop_charge_ms     # hops still after THIS
                st = self._inflight.get(it.rid)
                # re-check per item at CURRENT time: earlier items' uplink
                # transfers in this same batch consume later items' slack,
                # and a blown request must not burn 25 ms of link time
                if st is None or (self.shed_policy is not None
                                  and self._shed_at_flush(
                                      it, st, self.now_ms(),
                                      extra_ms=companions)):
                    continue
                sample = handle.submit(it.rid, it.client, it.payload,
                                       extras=it.extras, trace=it.trace)
                if sample is not None:
                    # no channel sample => nothing to record: a phantom
                    # (0, 0.0) would seed the controller's bandwidth
                    # estimate with an infinite-bandwidth observation
                    nbytes, ms = sample
                    self.executor.record_uplink(it.client, nbytes, ms)
                    self._note_uplink(it.client, ms)
                    self._m_uplink_ms.record(ms)
                    self._m_uplink_bytes.record(nbytes)
                    if it.trace:
                        self.telemetry.span(
                            "uplink", "server", ms, rid=it.rid,
                            tid=pool_tid,
                            args={"client": it.client, "nbytes": nbytes})
            if stage0:
                # the reply is framed on the host, which waits for the
                # device: this wall time covers the pool's device work
                t0 = self._perf()
                results += handle.flush()
                exec_ms += self._perf() - t0
        except PoolDrainingError:
            # intake refused atomically: nothing queued pool-side
            for it in stage0 + later:
                self._reroute_item(it)
            return None
        except Exception:
            traceback.print_exc()
            recovered = {}
            try:                       # pull back whatever did get queued
                recovered = dict(handle.flush())
            except Exception:
                pass
            foreign = None
            for rid, y in recovered.items():
                if rid in self._inflight:
                    self._advance(rid, y)
                elif self.foreign_router is not None:
                    # a shared pool's recovery flush can surface ANOTHER
                    # front-end's results too — dropping them here would
                    # strand those requests forever
                    if foreign is None:
                        foreign = []
                    foreign.append((rid, y))
            for it in stage0 + later:
                if it.rid not in recovered and it.rid in self._inflight:
                    self._finish_local(it.rid, self._inflight[it.rid],
                                       it.payload, boundary=it.boundary)
            return foreign
        finally:
            # the batch is over on every path: a stale busy_until would
            # keep charging phantom backlog to ingest admission
            driver.busy_until_ms = self.now_ms()
        driver.note_exec(exec_ms)
        self._m_exec_ms.record(exec_ms)
        self.stats["batches"] += 1
        foreign = None
        for rid, y in results:
            if rid in self._inflight:
                self._advance(rid, y)
            elif self.foreign_router is not None:
                if foreign is None:
                    foreign = []
                foreign.append((rid, y))
        return foreign

    # ----------------------------------------------------- decode execute
    def _decode_tick(self, driver: PoolDriver):
        """One iteration of a pool's continuous decode batch (read lock
        held): pull queued admissions at the step boundary, advance every
        resident sequence one token, retire finished streams, and abort
        streams whose remaining tokens provably cannot meet the absolute
        deadline (shed charge = remaining decode length). With
        ``decode_continuous`` off this degrades to the waved baseline:
        new admissions wait until the whole batch drains. Returns results
        owned by another front-end, as :meth:`_run_batch` does."""
        handle = self._pool_handle(driver.key)
        foreign = None
        if driver.decode_free > 0 and (self.decode_continuous
                                       or driver.decode_active == 0):
            items = driver.batcher.take(driver.decode_free)
            oneshot = [it for it in items if not it.decode]
            for it in items:
                if it.decode:
                    self._decode_admit(driver, handle, it)
            if oneshot:
                # a mixed pool: taken one-shot items run as a normal
                # batch between decode steps
                foreign = self._run_batch(driver, oneshot)
        if driver.decode_active == 0:
            return foreign
        t0 = self._perf()
        rep = handle.decode_step()
        driver.note_decode_step(self._perf() - t0)
        now = self.now_ms()
        for ev in rep.get("events", []):
            st = self._inflight.get(ev["rid"])
            if st is None:
                if self.foreign_router is not None:
                    # fleet mode: one step advances every stream resident
                    # on the shared pool, another front-end's too; its
                    # owner must see the event (above all the last one)
                    foreign = (foreign or []) + [(ev["rid"], ev)]
                continue
            st.n_gen = int(ev.get("n_gen", st.n_gen))
            if not ev.get("done"):
                continue
            driver.decode_resident.pop(ev["rid"], None)
            if ev.get("oom"):
                # the arena ran out mid-stream and the pool force-closed
                # the sequence — account it as a shed, not a completion
                self._shed(ev["rid"], st, "decode")
            else:
                self._complete_decode(ev["rid"], st, ev["tokens"])
        driver.decode_active = int(rep.get("active", 0))
        driver.decode_free = int(rep.get("free_slots", driver.decode_free))
        self._shed_mid_decode(driver, handle, now)
        return foreign

    def _decode_admit(self, driver: PoolDriver, handle, item: BatchItem):
        """Admit one queued decode request into the pool's running batch
        (read lock held). The admit reply carries the FIRST generated
        token, so TTFT stamps here."""
        st = self._inflight.get(item.rid)
        if st is None:
            return
        now = self.now_ms()
        disagg = self._pool_role(driver.key) == "decode"
        est_first = driver.est_cost_ms()
        if disagg and self._handoff_ewma_ms is not None:
            # the cross-pool KV handoff is real work on the TTFT path —
            # charge it to the shed-slack model like a steal hop
            est_first += self._handoff_ewma_ms
        if self.shed_policy is not None and not st.shed_exempt:
            blown = ShedPolicy.hopeless_decode(
                now, st.ttft_deadline_ms, est_first,
                st.deadline_ms, driver.tpot_est_ms(), st.max_new)
            if blown:
                if self.shed_policy.should_shed(item.client,
                                                charge=st.max_new):
                    self._shed(item.rid, st, "decode")
                    return
                st.shed_exempt = True
        if item.trace:
            q_ms = now - item.enqueued_ms
            self._m_queue_ms.record(q_ms)
            self.telemetry.span("queue", "server", q_ms, rid=item.rid,
                                tid="pool/{}/{}-{}".format(*driver.key),
                                args={"decode": True})
        sig = self._decode_sig(st)
        handoff = None
        if disagg:
            # two-phase admit: prompt prefill on a prefill-capable pool,
            # KV frame rides the admit hop below. Any failure here just
            # drops the handoff — the decode pool prefills for itself,
            # token-exact either way, only slower.
            handoff = self._prefill_handoff(driver, item, st, sig)
        try:
            t0 = self._perf()
            r = handle.decode_admit(item.rid, item.client, item.payload,
                                    st.max_new, sig=sig, handoff=handoff,
                                    trace=item.trace)
            admit_ms = self._perf() - t0
        except PoolDrainingError:
            self._reroute_item(item)
            return
        except Exception:
            traceback.print_exc()
            # the admit may have SUCCEEDED pool-side with only the reply
            # lost: without an abort the pool keeps a zombie resident
            # stream and its KV blocks leak while we regenerate locally
            try:
                handle.decode_abort(item.rid)
            except Exception:
                pass
            self._decode_local(item.rid, st, item.payload)
            return
        if not r.get("admitted"):
            # soft refusal: slots/blocks are full right now (retry at a
            # later step boundary, bounded) — or the pool cannot decode
            # at all, which no retry fixes. In fleet mode a shared pool's
            # slots may be held by another front-end's streams, which
            # finish on their own: wait a decode step and ask again (no
            # retry is spent on it)
            reason = r.get("reason")
            shared_wait = reason == "no_slot" and self.registry is not None
            if reason in ("not_decode_capable", "role_prefill") \
                    or (st.decode_retries >= 2 and not shared_wait):
                self._decode_local(item.rid, st, item.payload)
            elif shared_wait:
                driver.decode_free = 0
                driver.slot_wait_until = time.monotonic() + max(
                    driver.tpot_est_ms(), 10.0) / 1e3
                driver.batcher.put(item)
            else:
                st.decode_retries += 1
                driver.batcher.put(item)
            return
        driver.note_exec(admit_ms)       # prefill cost feeds est_cost_ms
        if handoff is not None:
            # the block transfer is the admit hop's extra freight: admit
            # wall time IS the measured handoff cost
            self.stats["kv_handoffs"] += 1
            self._handoff_samples.append(admit_ms)
            self._m_handoff_ms.record(admit_ms)
            e = self._handoff_ewma_ms
            self._handoff_ewma_ms = admit_ms if e is None \
                else 0.8 * e + 0.2 * admit_ms
        from repro_torch.serving.kvcache import prefix_digest
        self._note_affinity(prefix_digest(sig, item.payload,
                                          self._kv_block_tokens()))
        if st.t_first_ms <= 0.0:
            # disagg stamped TTFT at the prefill reply already — the
            # first token existed before the decode pool heard of us
            st.t_first_ms = self.now_ms()
        st.n_gen = 1
        driver.decode_active = int(r["active"])
        driver.decode_free = int(r["free_slots"])
        if r.get("done"):
            self._complete_decode(item.rid, st, r["tokens"])
            return
        driver.decode_resident[item.rid] = item.client

    def _prefill_handoff(self, driver: PoolDriver, item: BatchItem,
                         st: _InFlight, sig: tuple):
        """Phase one of the disaggregated admit: run the prompt through a
        prefill-capable pool of the decode pool's range and return the
        encoded KV-block envelope to ride the admit hop (None on any
        failure — the decode pool then prefills for itself, numerically
        identical). TTFT stamps HERE: the prefill reply carries the first
        generated token."""
        from repro_torch.serving.kvcache import prefix_digest
        digest = prefix_digest(sig, item.payload, self._kv_block_tokens())
        key = self._choose_prefill_pool(digest, tuple(driver.key[:3]))
        if key is None:
            return None
        try:
            handle = self._pool_handle(key)
            pr = handle.prefill_export(item.rid, item.client, item.payload,
                                       sig=sig, trace=item.trace)
        except Exception:
            traceback.print_exc()
            return None
        if not pr.get("exported"):
            return None
        if st.t_first_ms <= 0.0:
            st.t_first_ms = self.now_ms()
        return pr.get("kv")

    def _choose_prefill_pool(self, digest, rng: tuple) -> Optional[tuple]:
        """Which prefill-capable pool runs this prompt: the router's KV-affinity
        routing extended down to pool choice — score each candidate by
        how much of the prompt's chunk digest is already resident in its
        arena (``residency_digest`` over the framed stats op, TTL-cached)
        so repeat prompts re-export warm blocks instead of re-prefilling.
        Ties keep the executor's order (prefill-role pools first)."""
        pk = getattr(self.executor, "prefill_pool_keys", None)
        keys = pk(rng) if pk is not None else []
        if not keys:
            return None
        if len(keys) == 1:
            return keys[0]
        from repro_torch.serving.router import affinity_overlap
        best, best_ov = keys[0], -1
        for key in keys:
            ov = affinity_overlap(digest, self._pool_residency(key))
            if ov > best_ov:
                best, best_ov = key, ov
        return best

    def _pool_residency(self, key: tuple) -> frozenset:
        """One pool's KV residency digest, refreshed at most once per
        ``residency_ttl_ms`` (an admission must not pay a stats round
        trip; slightly stale residency only costs a colder pick)."""
        now = self.now_ms()
        hit = self._residency_cache.get(key)
        if hit is not None and now - hit[0] <= self.residency_ttl_ms:
            return hit[1]
        try:
            res = frozenset(self._pool_handle(key).stats()
                            .get("kv_residency", ()))
        except Exception:
            res = frozenset()
        self._residency_cache[key] = (now, res)
        return res

    def _shed_mid_decode(self, driver: PoolDriver, handle,
                         now: float) -> None:
        """Post-step sweep: a resident stream whose remaining tokens
        provably miss the absolute deadline at the measured step rate is
        aborted — its slot and KV blocks go to streams that can still
        win. Charge = tokens NOT delivered."""
        if self.shed_policy is None or not driver.decode_resident:
            return
        tpot = driver.tpot_est_ms()
        for rid in list(driver.decode_resident):
            st = self._inflight.get(rid)
            if st is None or st.shed_exempt:
                continue
            left = st.max_new - st.n_gen
            if left <= 0:
                continue
            # rolling per-token deadline: the NEXT token must land within
            # one TPOT budget, the LAST within the absolute deadline
            if not ShedPolicy.hopeless_decode(
                    now, now + st.tpot_ms, tpot, st.deadline_ms,
                    tpot, left):
                continue
            if not self.shed_policy.should_shed(st.req.client,
                                                charge=left):
                st.shed_exempt = True
                continue
            try:
                aborted = handle.decode_abort(rid)
            except Exception:
                traceback.print_exc()
                aborted = False
            if aborted:
                # the pool confirmed it dropped one counted stream; after
                # a failed abort the next step's reply says what it holds
                driver.decode_active = max(driver.decode_active - 1, 0)
                driver.decode_free += 1
            driver.decode_resident.pop(rid, None)
            self._shed(rid, st, "decode")

    def _complete_decode(self, rid: int, st: _InFlight, tokens) -> None:
        toks = [int(t) for t in tokens]
        st.req.out_tokens = toks
        st.req.result = np.asarray(toks, np.int32)
        self._inflight.pop(rid, None)
        if self.registry is not None:
            self.registry.pop(rid, None)
        t_done = self.now_ms()
        ttft = st.t_first_ms - st.t_arrive_ms
        n = max(len(toks), 1)
        tpot = (t_done - st.t_first_ms) / (n - 1) if n > 1 else 0.0
        ok = st.t_first_ms <= st.ttft_deadline_ms \
            and t_done <= st.deadline_ms
        self.stats["decode_served"] += 1
        self.stats["decode_tokens"] += n
        self._outcomes.append(False)
        self._m_completed.inc()
        self._m_inflight.set(len(self._inflight))
        self._m_latency_ms.record(t_done - st.t_arrive_ms)
        self._m_ttft_ms.record(ttft)
        if n > 1:
            self._m_tpot_ms.record(tpot)
        if st.trace:
            self.telemetry.span("request", "server",
                                t_done - st.t_arrive_ms, rid=rid,
                                tid=self.name,
                                args={"client": st.req.client, "ok": ok,
                                      "decode": True, "n_tokens": n,
                                      "ttft_ms": round(ttft, 3)})
        self._push_record({
            "rid": rid, "client": st.req.client, "p": st.p,
            "latency_ms": t_done - st.t_arrive_ms,
            "budget_ms": st.budget_ms, "ok": ok, "shed": False,
            "rerouted": st.rerouted, "local": st.local,
            "decode": True, "n_tokens": n, "ttft_ms": ttft,
            "tpot_ms": tpot, "t_done_ms": t_done})
        if self.controller is not None:
            with self._ctl_lock:
                # TTFT is the decode analogue of one-shot latency: it is
                # what the request's ``budget_ms`` bounds
                self.controller.observe_done(t_done, st.req.client, ttft,
                                             budget_ms=st.budget_ms)
                if hasattr(self.controller, "observe_decode"):
                    self.controller.observe_decode(
                        t_done, st.req.client, ttft, tpot,
                        st.budget_ms, st.tpot_ms)

    def _decode_local(self, rid: int, st: _InFlight, tokens) -> None:
        """Escape hatch mirroring :meth:`_finish_local`: greedy-decode
        the whole request in-process with the server's own parameters,
        on the executor's device — same numbers as the pool path, no
        cache manager."""
        from repro_torch.models.decode import decode_step, prefill
        st.local = True
        self.stats["decode_local"] += 1
        dev = self.executor.device
        try:
            toks = np.asarray(tokens, np.int32).reshape(-1)
            ctx = int(toks.shape[0]) + st.max_new
            logits, cache = prefill(self.executor.params, self.cfg,
                                    torch.from_numpy(toks).to(dev)[None],
                                    extras=st.req.extras, cache_seq=ctx)
            out = [int(torch.argmax(logits[0, -1]))]
            if st.t_first_ms == 0.0:
                st.t_first_ms = self.now_ms()
            st.n_gen = 1
            while len(out) < st.max_new:
                t0 = self._perf()
                logits, cache = decode_step(
                    self.executor.params, self.cfg, cache,
                    torch.tensor([[out[-1]]], dtype=torch.int32,
                                 device=dev))
                out.append(int(torch.argmax(logits[0, -1])))
                st.n_gen = len(out)
                if st.trace:
                    self.telemetry.span("decode/step", "server",
                                        self._perf() - t0, rid=rid,
                                        tid=self.name,
                                        args={"n_gen": len(out),
                                              "local": True})
            self._complete_decode(rid, st, out)
        except Exception:
            # even the fallback failed: retire as a shed so join() never
            # strands on a decode request
            traceback.print_exc()
            self._shed(rid, st, "decode")

    def _pool_handle(self, key: tuple):
        """This server's own channel to pool ``key`` (opened lazily).
        Per-front-end channels let two front-ends' uplink submits to the
        same pool overlap; executors without multi-channel support fall
        back to the shared deploy handle."""
        h = self._local_handles.get(key)
        if h is None:
            try:
                h = self.executor.open_handle(key)
            except (AttributeError, KeyError):
                h = self.executor.handle(key)
            self._local_handles[key] = h
        return h

    def _drop_local_handles(self, keys=None) -> None:
        for key in list(self._local_handles) if keys is None else keys:
            h = self._local_handles.pop(key, None)
            if h is None:
                continue
            try:                    # never close the executor's own handle
                shared = self.executor._handles.get(key)
            except AttributeError:
                shared = None
            if h is not shared:
                try:
                    h.close()
                except Exception:
                    pass

    def accept_results(self, results: list) -> None:
        """Advance requests whose stage output surfaced on ANOTHER
        front-end's flush of a shared pool (fleet dispatch target), or
        whose decode event (a dict) came back on another front-end's
        step of a shared decode pool."""
        with self._rw.read():
            for rid, y in results:
                if isinstance(y, dict):
                    self._accept_decode_event(rid, y)
                else:
                    self._advance(rid, y)

    def _accept_decode_event(self, rid: int, ev: dict) -> None:
        """A step event of a stream this front-end admitted: the last
        one completes it and ends this front-end's ownership (read lock
        held). The driver's occupancy count is left alone: the step that
        produced the event already left the stream out of its reply, and
        this driver's own next step, admit or abort resets the count."""
        st = self._inflight.get(rid)
        if st is None:
            return
        st.n_gen = int(ev.get("n_gen", st.n_gen))
        if not ev.get("done"):
            return
        for drv in list(self._drivers.values()):
            if drv.decode_resident.pop(rid, None) is not None:
                break
        if ev.get("oom"):
            self._shed(rid, st, "decode")
        else:
            self._complete_decode(rid, st, ev["tokens"])

    # ------------------------------------------------------ work stealing
    def steal_queued(self, k: Optional[int] = None, *,
                     decode: bool = True) -> list:
        """Hand up to ``k`` queued-NOT-in-flight items (every eligible
        item when None) to a peer front-end. Taken under the writer lock
        so no driver can pop a batch containing them mid-steal. Decode
        items in the batcher are queued-not-yet-ADMITTED: they hold no
        resident KV anywhere, so they steal exactly like one-shot items
        (admitted streams live in ``decode_resident`` and never re-enter
        a batcher, so residency can't leave with a steal); ``decode``
        False leaves them queued.
        Returns ``[(BatchItem, _InFlight)]`` pairs; the request leaves
        this front-end's in-flight table and join() accounting entirely
        (the thief's :meth:`accept_stolen` picks both up), so a steal
        can never strand or double-count a rid."""
        stolen: list = []
        with self._rw.write():
            for drv in list(self._drivers.values()):
                room = None if k is None else k - len(stolen)
                if room is not None and room <= 0:
                    break
                stolen.extend(drv.batcher.steal(
                    room, want=None if decode else _one_shot))
        out = []
        for item in stolen:
            st = self._inflight.pop(item.rid, None)
            if st is None:                    # shed/completed mid-steal
                continue
            out.append((item, st))
        if out:
            self.stats["steals_out"] += len(out)
            self._m_inflight.set(len(self._inflight))
            with self._done_cond:
                self._n_submitted -= len(out)
                self._done_cond.notify_all()
        return out

    def accept_stolen(self, stolen: list) -> int:
        """Adopt ``(BatchItem, _InFlight)`` pairs stolen off a peer
        front-end. The extra hop is charged to the request's shed-policy
        slack: the normal flush checkpoint decides (honoring
        ``shed_exempt`` and the per-client budget), but the request is
        NEVER re-billed as a fresh admission — no ``note_admitted``, so
        one request holds exactly one window entry however many times it
        is stolen. Returns the number of requests adopted (sheds on
        arrival included — they are accounted here, not dropped)."""
        if not stolen:
            return 0
        with self._done_cond:
            self._n_submitted += len(stolen)
        with self._rw.read():
            for item, st in stolen:
                st.steal_hops += 1
                self._inflight[item.rid] = st
                if self.registry is not None:
                    self.registry[item.rid] = self
                self.stats["steals_in"] += 1
                now = self.now_ms()
                hop = self._hop_ms(item.client)
                if self.shed_policy is not None and \
                        self._shed_at_flush(item, st, now, extra_ms=hop):
                    continue
                self._reroute_item(item, count=False)
        self._m_inflight.set(len(self._inflight))
        return len(stolen)

    # ------------------------------------------------------ router signals
    @property
    def n_queued(self) -> int:
        """Queued-not-in-flight items across every pool batcher."""
        return sum(len(d.batcher) for d in list(self._drivers.values()))

    def queue_depth_ms(self, now: Optional[float] = None) -> float:
        """Estimated milliseconds of work backed up on this front-end:
        queued uplink charges, the batch each driver is already pushing
        (``busy_until_ms``), execution of the queued batches, and the
        ingest queue still awaiting mobile parts. This is the router's
        load signal — the marginal wait a new request would inherit."""
        t = self.now_ms() if now is None else now
        total = 0.0
        for drv in list(self._drivers.values()):
            q = len(drv.batcher)
            total += drv.batcher.pending_hop_ms \
                + max(drv.busy_until_ms - t, 0.0)
            if q:
                total += (q / max(drv.batcher.max_batch, 1)) \
                    * drv.est_cost_ms()
        with self._ingest_cond:
            n_ingest = len(self._ingest_q)
        return total + n_ingest * self.hop_default_ms

    def steal_pressure_ms(self, now: Optional[float] = None) -> float:
        """Milliseconds of work that is LATE on this front-end: batches
        already pushing (``busy_until_ms``) plus execution of queued
        one-shot items whose flush deadline has passed. Items waiting out
        a future flush deadline are deliberate batching slack, not
        pressure — stealing them churns placement without helping
        latency, so the fleet balancer keys its imbalance test on this
        instead of :meth:`queue_depth_ms`. Queued decode requests are
        not pressure either: they wait for a slot of a decode pool every
        front-end shares, which a thief would wait for too."""
        t = self.now_ms() if now is None else now
        total = 0.0
        for drv in list(self._drivers.values()):
            total += max(drv.busy_until_ms - t, 0.0)
            due = drv.batcher.n_due(t, want=_one_shot)
            if due:
                total += (due / max(drv.batcher.max_batch, 1)) \
                    * drv.est_cost_ms()
        return total

    def recent_shed_frac(self) -> float:
        """Shed fraction over the last ~256 outcomes on this front-end
        (the router's shed-rate penalty input)."""
        o = list(self._outcomes)
        return sum(o) / len(o) if o else 0.0

    def _advance(self, rid: int, y) -> None:
        st = self._inflight.get(rid)
        if st is None:
            return
        st.stage += 1
        if st.stage < len(st.chain):
            self._enqueue_stage(rid, st, y)
        else:
            self._complete(rid, st, y)

    def _push_record(self, rec: dict) -> None:
        with self._done_cond:
            self._records.append(rec)
            if len(self._records) > MAX_RECORDS:   # long-running: bounded
                drop = len(self._records) - MAX_RECORDS
                del self._records[:drop]
                self._records_base += drop
            self._n_done += 1
            self._done_cond.notify_all()

    def _complete(self, rid: int, st: _InFlight, y) -> None:
        st.req.result = y
        self._inflight.pop(rid, None)
        if self.registry is not None:
            self.registry.pop(rid, None)
        t_done = self.now_ms()
        latency = t_done - st.t_arrive_ms
        self._outcomes.append(False)
        self._m_completed.inc()
        self._m_inflight.set(len(self._inflight))
        self._m_latency_ms.record(latency)
        if st.trace:
            self.telemetry.span("request", "server", latency, rid=rid,
                                tid=self.name,
                                args={"client": st.req.client,
                                      "ok": latency <= st.budget_ms})
        self._push_record({
            "rid": rid, "client": st.req.client, "p": st.p,
            "latency_ms": latency, "budget_ms": st.budget_ms,
            "ok": latency <= st.budget_ms, "shed": False,
            "rerouted": st.rerouted, "local": st.local,
            "t_done_ms": t_done})
        if self.controller is not None:
            with self._ctl_lock:
                self.controller.observe_done(t_done, st.req.client, latency,
                                             budget_ms=st.budget_ms)

    # ------------------------------------------------- reroute / fallback
    def _reroute_item(self, item: BatchItem, *, count: bool = True) -> None:
        """Re-home a request whose pool vanished: same block boundary in
        the client's new chain if one exists, else finish locally.
        ``count=False`` skips the reroute accounting — a stolen item
        re-enqueued on its new front-end went exactly where it was
        routed, it did not bounce off a stale chain."""
        st = self._inflight.get(item.rid)
        if st is None:
            return
        if item.decode:
            # decode re-homing: only another full-range pool will do;
            # otherwise the local fallback keeps the stream exact
            if count:
                st.rerouted += 1
                self.stats["rerouted"] += 1
            chain = self._decode_chain(item.client)
            if chain is not None:
                st.chain = chain
                st.stage = 0
                self._enqueue_decode(item.rid, st)
            else:
                self._decode_local(item.rid, st, item.payload)
            return
        chain = self._routes.get(item.client)
        if chain:
            for idx, key in enumerate(chain):
                if key[1] == item.boundary:
                    if count:
                        st.rerouted += 1
                        self.stats["rerouted"] += 1
                    st.chain = list(chain)
                    st.stage = idx
                    self._enqueue_stage(item.rid, st, item.payload)
                    return
        if count:
            st.rerouted += 1
            self.stats["rerouted"] += 1
        self._finish_local(item.rid, st, item.payload,
                           boundary=item.boundary)

    def _salvage(self, batch: list) -> None:
        """Last-ditch accounting after an unexpected _run_batch error:
        finish each still-in-flight item locally; if even that fails,
        retire the request as done-with-error so join() never strands."""
        for it in batch:
            st = self._inflight.get(it.rid)
            if st is None:
                continue
            try:
                self._finish_local(it.rid, st, it.payload,
                                   boundary=it.boundary)
            except Exception:
                traceback.print_exc()
                self._inflight.pop(it.rid, None)
                if self.registry is not None:
                    self.registry.pop(it.rid, None)
                with self._done_cond:
                    self._n_done += 1
                    self._done_cond.notify_all()

    def _finish_local(self, rid: int, st: _InFlight, payload,
                      *, boundary: int) -> None:
        """Escape hatch: run the remaining blocks ``[boundary, L)`` with
        the server's own parameters on the executor's device — same
        numbers, no pool. The result lands on the host, where a pool
        hop's result would."""
        from repro_torch.models import n_fragment_units
        L = n_fragment_units(self.cfg)
        st.local = True
        self.stats["local_finishes"] += 1
        x = torch.as_tensor(payload).to(self.executor.device)
        if boundary >= L:
            y = x
        else:
            fn = self.executor.fragment_fn(boundary, L)
            y = fn(self.executor.params, inputs=x[None],
                   extras=st.req.extras)[0]
        y = y.cpu()
        st.stage = len(st.chain)                   # chain is done
        self._complete(rid, st, y)

    # ------------------------------------------------------------ control
    def _control_loop(self):
        period_s = self._period_ms / 1e3
        while not self._stop_evt.is_set():
            self._kick.wait(timeout=period_s)
            self._kick.clear()
            if self._stop_evt.is_set():
                return
            try:
                self.tick()
            except Exception:
                # counted: a run that must not fail reads tick_errors
                self.stats["tick_errors"] += 1
                traceback.print_exc()

    def _feed_disagg_pressure(self) -> None:
        """Per-tick delta of decode completions that fell back to the
        in-process path over all decode completions — a persistently high
        fraction means the deployed pools can't hold the decode load
        (wrong roles, wrong capacity) and feeds the controller's
        ``disagg_pressure`` trigger so the planner can split (or regrow)
        prefill/decode pools instead of the server serving generative
        traffic on its own CPU thread forever."""
        if self.controller is None or \
                not hasattr(self.controller, "observe_disagg_pressure"):
            return
        local = self.stats["decode_local"]
        served = self.stats["decode_served"]
        d_local = local - self._disagg_mark[0]
        d_served = served - self._disagg_mark[1]
        if d_served <= 0:
            return                      # no decode completions this tick
        self._disagg_mark = (local, served)
        with self._ctl_lock:
            self.controller.observe_disagg_pressure(
                self.now_ms(), d_local / d_served)

    def tick(self, *, force: bool = False):
        """One control tick: feed live uplink samples to the controller,
        maybe replan, apply the diff, revisit parked requests. Returns
        the new plan when one was applied.

        A replan is refused, before anything changes, when it drops a
        client that still has requests here (the controller's window saw
        no recent arrival from it, but its work is still queued,
        executing or decoding), or when ``apply_plan`` finds a pool it
        would remove still holding queued requests or resident decode
        streams. The controller then believes the deployed plan again
        (``revert``), so its triggers fire against what runs and a later
        tick replans, once that work is done.

        With ``external_control`` the fleet owns the controller; this
        tick only re-routes and expires parked requests."""
        plan = None
        self._feed_disagg_pressure()
        if self.controller is not None and not self.external_control:
            now = self.now_ms()
            samples = self.executor.drain_uplink()
            with self._ctl_lock:
                self.controller.ingest_uplink(now, samples)
                plan = self.controller.control(now, force=force)
            if plan is not None:
                t0 = self._perf()
                try:
                    self._refuse_stranding(plan)
                    self.apply(plan)
                except PlanRefused as e:
                    with self._ctl_lock:
                        self.controller.revert(str(e))
                    self.stats["applies_refused"] += 1
                    self.hold_parked()
                    plan = None
            if plan is not None:
                apply_ms = self._perf() - t0
                self.stats["timer_replans"] += 1
                self._m_apply_ms.record(apply_ms)
                if hasattr(self.controller, "note_apply"):
                    with self._ctl_lock:
                        self.controller.note_apply(apply_ms)
        if self.controller is None or not self.external_control:
            self._controlled_ms = self.now_ms()
        self._route_waiting()
        self._expire_waiting(self.now_ms())
        return plan

    def _refuse_stranding(self, plan) -> None:
        """Raise :class:`PlanRefused` when ``plan`` routes no chain for a
        client with requests still in flight here."""
        stranded = self.stranded_clients(plan)
        if stranded:
            raise PlanRefused(f"clients {stranded} still have requests in "
                              "flight")

    def stranded_clients(self, plan) -> list:
        """Clients with requests in flight here that ``plan`` routes no
        chain for (a fleet checks every front-end before it applies)."""
        routed = _routing(plan)
        busy = {st.req.client for st in list(self._inflight.values())}
        return sorted(c for c in busy if c not in routed)

    def apply(self, new_plan):
        """Transition the live deployment to ``new_plan`` while traffic
        is in flight. Blocks until in-flight batches finish (writer
        lock), applies the executor diff (removed pools retire, kept
        pools keep compiled programs/processes), then reroutes anything
        queued on a removed pool. Pools the plan adds are started first,
        outside the writer lock, where the executor can
        (``prepare_plan``: a worker process starts while traffic flows)."""
        self._hold_parked_until = math.inf
        try:
            self.executor.prepare_plan(new_plan)
            with self._rw.write():
                diff = self.executor.apply_plan(new_plan)
                leftovers = self._sync_to_executor(diff)
        finally:
            self.hold_parked()
        self._finish_apply(leftovers)
        return diff

    def hold_parked(self) -> None:
        """Keep parked requests for one more grace period: a replan was
        just deployed or refused, and the next may cover them."""
        self._hold_parked_until = self.now_ms() + self.waiting_grace_ms

    def _sync_to_executor(self, diff) -> list:
        """Re-align drivers/routes with the executor's (already
        transitioned) deployment; caller holds the write lock. Returns
        the batch items drained off removed pools. Split from
        :meth:`apply` so a GraftFleet can apply ONE executor transition
        under every front-end's writer lock."""
        leftovers = []
        for a in diff.by_kind("remove"):
            drv = self._drivers.pop(a.key, None)
            if drv is None:
                continue
            drv.stop_flag = True
            leftovers.extend(drv.batcher.drain())
            drv.batcher.stop()
        self._drop_local_handles([a.key for a in diff.by_kind("remove")])
        for key, spec in self.executor.pool_specs().items():
            drv = self._drivers.get(key)
            if drv is None:
                drv = PoolDriver(self, key, spec)
                self._drivers[key] = drv
                drv.start()
            else:
                drv.batcher.set_max_batch(max(spec.batch, 1))
                drv.model_est_ms = self._model_stage_cost(spec)
        self._routes = self.executor.route_table()
        self.stats["replans_applied"] += 1
        return leftovers

    def _finish_apply(self, leftovers: list) -> None:
        # re-home leftovers OUTSIDE the writer section: a local finish
        # can mean a full forward pass, which must stall
        # only this thread, not every pool driver
        if leftovers:
            with self._rw.read():
                for item in leftovers:
                    self._reroute_item(item)
        self._route_waiting()

    def _route_waiting(self) -> None:
        with self._wait_lock:
            parked = self._waiting
            self._waiting = []
        if not parked:
            return
        still = []
        with self._rw.read():
            for rid, payload, t_ms in parked:
                st = self._inflight.get(rid)
                if st is None:
                    continue
                chain = self._routes.get(st.req.client)
                if chain and chain[0][1] == st.p:
                    st.chain = list(chain)
                    st.stage = 0
                    self._enqueue_stage(rid, st, payload)
                else:
                    still.append((rid, payload, t_ms))
        if still:
            with self._wait_lock:
                self._waiting.extend(still)

    def _expire_waiting(self, now: float) -> None:
        """Parked requests the replans never covered get finished locally
        after a grace period — a server must answer, not starve. None
        expires before the controller has looked at the traffic since it
        was parked, while a replan is being deployed, nor within a grace
        period of one deployed or refused (see :meth:`hold_parked`)."""
        if now < self._hold_parked_until:
            return
        with self._wait_lock:
            keep, expired = [], []
            for rid, payload, t_ms in self._waiting:
                (expired if now - t_ms > self.waiting_grace_ms
                 and t_ms < self._controlled_ms
                 else keep).append((rid, payload, t_ms))
            self._waiting = keep
        for rid, payload, _ in expired:
            st = self._inflight.get(rid)
            if st is not None:
                self._finish_local(rid, st, payload, boundary=st.p)

    # ------------------------------------------------------------- report
    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted request has completed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done_cond:
            while self._n_done < self._n_submitted:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._done_cond.wait(timeout=left if left is not None
                                     else 1.0)
        return True

    def mark(self) -> int:
        """Snapshot index into the completion log (warmup exclusion)."""
        with self._done_cond:
            return self._records_base + len(self._records)

    def records(self, since: int = 0) -> list:
        """Raw completion-log slice (fleet reports merge these)."""
        with self._done_cond:
            start = max(since - self._records_base, 0)
            return list(self._records[start:])

    def report(self, since: int = 0) -> dict:
        recs = self.records(since)
        out = summarize_records(recs)
        # snapshot: a timer replan may mutate the driver table mid-report
        drivers = list(self._drivers.values())
        batch_sizes = [s for d in drivers
                       for s in list(d.batcher.stats.batch_sizes)]
        out.update({
            "replans": self.stats["replans_applied"],
            "timer_replans": self.stats["timer_replans"],
            "rerouted": self.stats["rerouted"],
            "local_finishes": self.stats["local_finishes"],
            "waited": self.stats["waited"],
            "shed_ingest": self.stats["shed_ingest"],
            "shed_flush": self.stats["shed_flush"],
            "shed_decode": self.stats["shed_decode"],
            "decode_served": self.stats["decode_served"],
            "decode_tokens": self.stats["decode_tokens"],
            "decode_local": self.stats["decode_local"],
            "kv_handoffs": self.stats["kv_handoffs"],
            "kv_handoff_ms": float(np.mean(self._handoff_samples))
            if self._handoff_samples else 0.0,
            "applies_refused": self.stats["applies_refused"],
            "tick_errors": self.stats["tick_errors"],
            "steals_in": self.stats["steals_in"],
            "steals_out": self.stats["steals_out"],
            "mean_batch": float(np.mean(batch_sizes)) if batch_sizes
            else 0.0,
            "n_stage_pools": len(drivers),
        })
        return out

    # test/bench introspection -------------------------------------------
    def driver(self, key: tuple) -> PoolDriver:
        return self._drivers[key]

    @property
    def n_inflight(self) -> int:
        return len(self._inflight)


def _record_percentiles(vals: list) -> tuple:
    """(p50, p99) via the telemetry bucket layout, so a report built
    from raw records and one built from merged :class:`Histogram` states
    (fleet/worker dumps) quote identical numbers. Resolution is the
    bucket width (~±4.4% at the midpoint)."""
    h = Histogram("records")
    for v in vals:
        h.record(float(v))
    st = h.state()
    return (Histogram.quantile_of(st, 0.50), Histogram.quantile_of(st, 0.99))


def summarize_records(recs: list) -> dict:
    """Completion-log records -> the SLO report. Latency percentiles and
    attainment are computed over ADMITTED (non-shed) requests — the shed
    policy's whole point is that the requests it serves stay inside the
    SLO; ``offered``/``shed`` keep the dropped load visible."""
    admitted = [r for r in recs if not r.get("shed")]
    by_client: dict[str, list] = {}
    for r in recs:
        by_client.setdefault(r["client"], []).append(r)
    clients = {}
    for c, rs in sorted(by_client.items()):
        adm = [r for r in rs if not r.get("shed")]
        p50, p99 = _record_percentiles([r["latency_ms"] for r in adm])
        clients[c] = {
            "n": len(adm),
            "shed": len(rs) - len(adm),
            "attainment": float(np.mean([r["ok"] for r in adm]))
            if adm else 0.0,
            "p50_ms": p50,
            "p99_ms": p99,
            "budget_ms": float(np.median([r["budget_ms"] for r in rs])),
        }
    p50, p99 = _record_percentiles([r["latency_ms"] for r in admitted])
    out = {
        "served": len(admitted),
        "offered": len(recs),
        "shed": len(recs) - len(admitted),
        "attainment": float(np.mean([r["ok"] for r in admitted]))
        if admitted else 0.0,
        "p50_ms": p50,
        "p99_ms": p99,
        "clients": clients,
    }
    dec = [r for r in admitted if r.get("decode")]
    if dec:
        ttft50, ttft99 = _record_percentiles([r["ttft_ms"] for r in dec])
        tpot50, tpot99 = _record_percentiles(
            [r["tpot_ms"] for r in dec if r.get("n_tokens", 1) > 1])
        out["decode"] = {
            "n": len(dec),
            "tokens": int(sum(r.get("n_tokens", 1) for r in dec)),
            "attainment": float(np.mean([r["ok"] for r in dec])),
            "ttft_p50_ms": ttft50,
            "ttft_p99_ms": ttft99,
            "tpot_p50_ms": tpot50,
            "tpot_p99_ms": tpot99,
        }
    return out


# ---------------------------------------------------------------------------
# wall-clock serve loop (launch/serve.py --serve-loop, tests,
# chip_smoke.py's server and remote phases)
# ---------------------------------------------------------------------------

def run_serve_loop(*, arch: str = "qwen3-1.7b", mode: str = "inprocess",
                   n_clients: int = 3, seconds: float = 4.0,
                   rate: float = 6.0, seed: int = 0,
                   shift_frac: Optional[float] = 0.5,
                   shaped: bool = False, control_period_ms: float = 250.0,
                   warmup: bool = True, check_numerics: bool = True,
                   max_check: int = 64, seq_len: int = 16,
                   frontends: int = 1,
                   shed_budget_frac: Optional[float] = None,
                   router: str = "weighted",
                   advertise_host: str = "127.0.0.1", launcher=None,
                   telemetry=None, trace_out: Optional[str] = None,
                   metrics_dump: Optional[str] = None,
                   decode_max_new: int = 0,
                   log=None, device=None, setup=None, frags=None,
                   prompt_lens: Optional[tuple] = None) -> dict:
    """Run the full event-driven runtime wall-clock for ``seconds``.

    Trace-driven client threads emit requests at their declared rates;
    at ``shift_frac`` of the run, client 0 flips its partition point so
    the timer-driven control loop must replan mid-traffic. Returns the
    server report plus ``plan_in_sync`` (the
    controller's plan is the deployed one) and ``controller_refused``
    (the replans ``apply_plan`` refused, each reverted and retried).

    ``frontends > 1`` (or a ``shed_budget_frac``) runs the fleet
    topology instead: several front-ends over the one executor, clients
    routed by the load/cache-aware weighted router (``router="hrw"``
    keeps the static rendezvous ring), the fleet owning the control
    tick and cross-front-end work stealing.

    ``mode="socket"`` runs every stage pool in a worker process behind a
    socket (:class:`repro_torch.serving.remote.RemoteExecutor`, on the
    executor's device); ``advertise_host``/``launcher`` say where the
    workers dial back to and how they start (a local subprocess when
    None). Each worker's spawn and init time is logged, and the report
    carries ``worker_launches``: the kernels' launches inside the
    workers, those of workers a replan retired included.

    ``trace_out``/``metrics_dump`` turn telemetry on (or pass an
    explicit ``telemetry`` registry) and write the trace / metrics dump
    on exit; ``decode_max_new > 0`` flips the last client to
    autoregressive requests (the first, third, ... on one prompt) so
    traces cover decode steps too. Its streams decode on a full-range
    pool when its route is one (its paged arena holds eight streams of
    the longest prompt plus ``decode_max_new`` tokens), else through the
    server's in-process fallback. ``check_numerics`` ends the loop with
    :func:`check_serve_report` (``max_check`` results and streams).

    ``device`` None runs on the card and raises without one. ``setup``
    reuses a ``smoke_setup`` triple (cfg, book, params) instead of
    building the smoke config; ``frags`` replaces the smoke fleet;
    ``prompt_lens`` (lo, hi) draws each prompt's length uniformly from
    lo..hi instead of ``seq_len``. The report carries the one-shot
    requests as ``report["requests"]`` ([(req, p)]) and the decode
    streams as ``report["decoded"]`` ([(req, max_new)]).
    """
    from repro_torch.core import GraftPlanner
    from repro_torch.core.plandiff import plan_pools
    from repro_torch.models import n_fragment_units
    from repro_torch.serving.controller import ServingController
    from repro_torch.serving.remote import RemoteExecutor
    from repro_torch.serving.smoke import smoke_fragments, smoke_setup
    from repro_torch.serving.transport import (InProcessTransport, LinkShape,
                                               ShapedTransport,
                                               SocketTransport)

    if mode not in ("inprocess", "socket"):
        raise ValueError(f"run_serve_loop: unknown mode {mode!r}")
    say = log if log is not None else (lambda *_: None)
    if telemetry is not None:
        tel = telemetry
    elif trace_out or metrics_dump:
        tel = Telemetry(process="serve", trace=bool(trace_out))
    else:
        tel = NULL_TELEMETRY
    cfg, book, params = setup if setup is not None \
        else smoke_setup(arch, seq_len=seq_len, seed=seed, device=device)
    L = n_fragment_units(cfg)
    if frags is None:
        frags = smoke_fragments(cfg, n_clients, rate=rate, seed=seed)
    ctl = ServingController(
        book, planner=GraftPlanner(book),
        control_period_ms=control_period_ms,
        min_replan_interval_ms=control_period_ms,
        window_ms=max(2000.0, seconds * 500.0))
    if tel.enabled:                  # controller audit lands in the dump
        tel.audit = ctl.audit
    plan0 = ctl.bootstrap(frags, now_ms=0.0)

    tp = SocketTransport() if mode == "socket" else InProcessTransport()
    if shaped:
        from repro_torch.data.traces import synth_5g_trace
        shapes = {f.client: LinkShape(
            trace=synth_5g_trace(seed=100 + i, sigma=0.6, fade_prob=0.05),
            rtt_ms=8.0) for i, f in enumerate(frags)}
        # realtime: the delays must actually be PAID, not just recorded —
        # the wall-clock latencies reported below would otherwise exclude
        # the very fades the uplink EWMA is charging deadlines for
        tp = ShapedTransport(tp, shapes, realtime=True)
    # room for the longest prompt and its new tokens, in whole KV blocks
    block = 16
    hi = seq_len if prompt_lens is None else prompt_lens[1]
    ctx = -(-(hi + decode_max_new) // block) * block if decode_max_new else 0
    pools = dict(decode_ctx=ctx, kv_blocks=8 * ctx // block,
                 kv_block_tokens=block, device=params["embed"].device)
    if mode == "socket":
        ex = RemoteExecutor(plan0, params, cfg, transport=tp,
                            advertise_host=advertise_host,
                            launcher=launcher, telemetry=tel,
                            beacon_interval_s=1.0 if tel.enabled else 0.0,
                            log=say, **pools)
    else:
        ex = GraftExecutor(plan0, params, cfg, transport=tp, telemetry=tel,
                           **pools)

    def prompt(rng) -> np.ndarray:
        n = seq_len if prompt_lens is None \
            else int(rng.randint(prompt_lens[0], prompt_lens[1] + 1))
        return rng.randint(0, cfg.vocab_size, n).astype(np.int32)

    submitted: list = []                         # [(req, p)] for numerics
    decoded: list = []                           # [(req, max_new)]
    if frontends > 1 or shed_budget_frac is not None:
        from repro_torch.serving.fleet import GraftFleet
        policy = ShedPolicy(budget_frac=shed_budget_frac) \
            if shed_budget_frac is not None else None
        server = GraftFleet(ex, n_frontends=max(frontends, 1),
                            controller=ctl, book=book, shed_policy=policy,
                            router=router)
    else:
        server = GraftServer(ex, controller=ctl, book=book)
    server.start()
    say(f"[serve-loop] {cfg.name}: {len(frags)} clients over {mode} "
        f"transport, {seconds:.1f}s wall-clock, "
        f"{ex.n_stage_pools} stage pools, "
        f"{max(frontends, 1)} front-end(s)")
    try:
        if warmup:                               # first calls of each shape
            rng = np.random.RandomState(seed)
            for f in frags:
                req = ServeRequest(client=f.client, tokens=prompt(rng))
                server.submit(req, f.p, f.t)
            if not server.join(timeout=600.0):
                raise RuntimeError("warmup requests never completed")
            m = server.mark()
            n_warm = sum(m.values()) if isinstance(m, dict) else m
            say(f"[serve-loop] warmup done ({n_warm} requests)")
        mark = server.mark()
        t_start = time.monotonic()
        stop_at = t_start + seconds
        shift_at = None if shift_frac is None \
            else t_start + seconds * shift_frac

        def client_loop(idx: int, frag):
            crng = np.random.RandomState(seed * 1000 + idx)
            period = 1.0 / max(frag.q, 0.5)
            p = frag.p
            # the LAST client optionally goes autoregressive so traces /
            # metrics cover the decode path too (excluded from the
            # one-shot numerics check — its result is generated tokens)
            decode = decode_max_new > 0 and idx == len(frags) - 1
            shared = prompt(crng) if decode else None
            n = 0
            while time.monotonic() < stop_at:
                if (idx == 0 and shift_at is not None and L > 1
                        and time.monotonic() >= shift_at):
                    p = (frag.p + 1) % L
                toks = shared.copy() if decode and n % 2 == 0 \
                    else prompt(crng)
                req = ServeRequest(
                    client=frag.client, tokens=toks,
                    max_new_tokens=decode_max_new if decode else 0)
                server.submit(req, p, frag.t)
                (decoded.append((req, decode_max_new)) if decode
                 else submitted.append((req, p)))
                n += 1
                time.sleep(period)

        threads = [threading.Thread(target=client_loop, args=(i, f),
                                    daemon=True, name=f"client-{f.client}")
                   for i, f in enumerate(frags)]
        t_traffic0 = ctl.stats["replans"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        drained = server.join(timeout=600.0)
        report = server.report(since=mark)
        report["drained"] = drained
        report.setdefault("steals", 0)
        report["controller_replans"] = ctl.stats["replans"] - t_traffic0
        report["controller_triggers"] = dict(ctl.stats["triggers"])
        report["controller_refused"] = ctl.stats["refused"]
        report["plan_in_sync"] = \
            plan_pools(ctl.current_plan) == ex.pool_specs()
        if mode == "socket":
            # the workers' kernel launches, read while they are up
            report["worker_launches"] = ex.kernel_launches()
        report["wall_s"] = time.monotonic() - t_start
        if tel.enabled:
            ex.merge_telemetry(tel)
            report["audit"] = [dict(e) for e in ctl.audit]
            if trace_out:
                n_spans = tel.write_trace(trace_out)
                report["trace_spans"] = n_spans
                say(f"[serve-loop] wrote {n_spans} spans -> {trace_out}")
            if metrics_dump:
                tel.write_metrics(metrics_dump)
                say(f"[serve-loop] wrote metrics dump -> {metrics_dump}")
    finally:
        server.stop(drain=False, timeout=10.0)
        ex.close()

    report["requests"] = submitted
    report["decoded"] = decoded
    if check_numerics:
        check_serve_report(cfg, params, report, max_check=max_check)
    return report


def check_serve_report(cfg, params, report: dict, *,
                       max_check: int = 64) -> dict:
    """Hold a :func:`run_serve_loop` report's served requests to the
    references and add the verdicts to it: ``numerics_ok`` (up to
    ``max_check`` one-shot results within ``atol=5e-5, rtol=1e-3`` of
    the monolithic forward, the largest difference in
    ``numerics_max_abs``) and ``decode_numerics_ok`` (up to ``max_check``
    streams token for token against ``reference_decode``, the smallest
    top-1 minus top-2 logit margin of the reference in
    ``decode_min_margin``). A caller that counts kernel launches on the
    served path reads its counters before calling this."""
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           reference_decode)
    done = [(req, p) for req, p in report["requests"]
            if req.result is not None]
    check = done[:max_check]
    try:
        report["numerics_max_abs"] = check_against_monolithic(
            cfg, params, check)
        report["numerics_ok"] = True
    except AssertionError as e:      # report the verdict, let the
        report["numerics_ok"] = False     # caller choose the exit
        report["numerics_error"] = str(e)[:500]
    report["numerics_checked"] = len(check)
    streams = [(req, m) for req, m in report["decoded"]
               if req.out_tokens is not None][:max_check]
    if streams:
        margins: list = []
        bad = [req.client for req, m in streams
               if reference_decode(cfg, params, req.tokens, m,
                                   margins=margins)
               != list(req.out_tokens)]
        report["decode_numerics_ok"] = not bad
        report["decode_checked"] = len(streams)
        report["decode_min_margin"] = min(margins)
    return report
