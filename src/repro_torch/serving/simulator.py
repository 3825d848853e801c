"""Discrete-event serving simulator — end-to-end latency under a plan.

Models the full request path of hybrid DL serving (paper Figs 8-10):

  client emit -> mobile compute -> uplink transfer (bandwidth trace)
    -> [alignment-stage queue -> alignment instances]      (Graft only)
    -> shared/solo-stage queue -> instances (batched)
    -> done; SLO checked end-to-end.

Instances process batches of up to ``alloc.batch`` requests; execution time
comes from the same PerfProfile the scheduler used (actual batch size).
The load balancer drops requests that have already blown their SLO before
execution (paper §3: "requests that fail to meet SLOs are dropped").

Two operating modes:

  * **offline** (``controller=None``): the plan is fixed for the whole
    run; each client's partition point is decided once at t0 — the
    original scheduler-study setup.
  * **online** (``controller=ServingController``): clients re-partition
    continuously over their bandwidth trace, the controller observes the
    event stream, and replans are applied *mid-run* as pool mutations
    (``core.plandiff``): kept pools retain queues and busy instances,
    added pools/instances pay ``instance_startup_ms`` before serving,
    removed pools drain their queues and vanish. Requests arriving for a
    client the current plan doesn't cover wait (bounded by their
    deadline) until a replan routes them.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.plandiff import plan_pools, PoolSpec
from repro_torch.core.profiles import ProfileBook
from repro_torch.core.repartition import GroupPlan, SoloPlan, StagePlan, pool_key


@dataclass
class StageRuntime:
    """One instance pool serving one queue."""
    model: str
    start: int
    end: int
    share: int
    batch: int
    n_instances: int
    queue: list = field(default_factory=list)       # (arrival, req) FIFO
    free_at: list = field(default_factory=list)     # per-instance busy-until

    def __post_init__(self):
        if not self.free_at:
            self.free_at = [0.0] * max(self.n_instances, 1)


@dataclass
class Req:
    client: str
    emit_ms: float
    deadline_ms: float
    server_arrival_ms: float
    stages: list = None                             # [StageRuntime, ...]
    stage_idx: int = 0
    done_ms: Optional[float] = None
    dropped: bool = False
    # online-mode observables (what the server actually sees per request)
    p: int = 0
    xfer_bytes: float = 0.0
    xfer_ms: float = 0.0
    model: str = ""


@dataclass
class SimResult:
    latencies_ms: dict                               # client -> np.ndarray e2e
    drops: dict                                      # client -> count
    slo_ms: dict                                     # client -> SLO
    meta: dict = field(default_factory=dict)

    def violation_rate(self) -> float:
        tot, bad = 0, 0
        for c in set(self.latencies_ms) | set(self.drops):
            lat = self.latencies_ms.get(c, np.array([]))
            tot += len(lat) + self.drops.get(c, 0)
            bad += int((lat > self.slo_ms[c]).sum()) + self.drops.get(c, 0)
        return bad / max(tot, 1)

    def attainment(self) -> float:
        return 1.0 - self.violation_rate()

    def drop_rate(self) -> float:
        n = self.meta.get("n_requests", 0)
        return sum(self.drops.values()) / max(n, 1)

    def all_latencies(self) -> np.ndarray:
        if not self.latencies_ms:
            return np.array([])
        return np.concatenate(list(self.latencies_ms.values()))


def _routing(plan: ExecutionPlan) -> dict:
    """client name -> list of (StagePlan, shared StagePlan) stage chains."""
    routes: dict[str, list[StagePlan]] = {}

    def clients_of(frag):
        if frag.merged_from:
            out = []
            for sub in frag.merged_from:
                out += clients_of(sub)
            return out
        return [frag.client]

    for pl in plan.plans:
        if isinstance(pl, GroupPlan):
            for a in pl.aligns:
                for c in clients_of(a.fragment):
                    routes[c] = [a, pl.shared] if a.end > a.start \
                        else [pl.shared]
        else:
            for c in clients_of(pl.stage.fragment):
                routes[c] = [pl.stage]
    return routes


def _routing_keys(plan: ExecutionPlan) -> dict:
    """client name -> list of PoolKeys (online mode routes by identity)."""
    return {c: [pool_key(sp.fragment.model, sp) for sp in chain]
            for c, chain in _routing(plan).items()}


def simulate(plan: ExecutionPlan, fleet, book: ProfileBook, *,
             duration_s: float = 20.0, t0: float = 0.0,
             use_average_partition: bool = False,
             drop_late: bool = True, seed: int = 0,
             controller=None,
             instance_startup_ms: float = 200.0) -> SimResult:
    """fleet: list[MobileClient]. Requests are periodic at each client rate.

    With ``controller`` set, ``plan`` is the initial deployment (may come
    from ``controller.bootstrap``) and the controller mutates it mid-run.
    """
    rng = np.random.RandomState(seed)
    online = controller is not None

    # -------- stage-pool runtimes -----------------------------------------
    stage_rt: dict[int, StageRuntime] = {}          # offline: per-StagePlan
    pool_table: dict[tuple, StageRuntime] = {}      # online: per PoolKey
    routes = _routing(plan)
    route_keys = _routing_keys(plan) if online else {}

    def runtime_for(sp: StagePlan) -> StageRuntime:
        k = id(sp)
        if k not in stage_rt:
            a = sp.alloc
            stage_rt[k] = StageRuntime(
                model=sp.fragment.model, start=sp.start, end=sp.end,
                share=a.share, batch=a.batch, n_instances=a.n_instances)
        return stage_rt[k]

    def make_pool(spec: PoolSpec, ready_ms: float) -> StageRuntime:
        return StageRuntime(
            model=spec.model, start=spec.start, end=spec.end,
            share=spec.share, batch=spec.batch,
            n_instances=spec.n_instances,
            free_at=[ready_ms] * max(spec.n_instances, 1))

    if online:
        for key, spec in plan_pools(plan).items():
            pool_table[key] = make_pool(spec, 0.0)

    # -------- generate requests with their mobile+transfer prefix ----------
    reqs: list[Req] = []
    slo_ms = {}
    for c in fleet:
        if not online and c.name not in routes:
            continue
        slo = c.slo_ms(book)
        slo_ms[c.name] = slo
        costs = book.costs(c.model)
        L = costs.n_layers
        d = c.decision(book, t0, use_average_bw=use_average_partition)
        period = 1000.0 / c.rate
        t = rng.rand() * period
        while t < duration_s * 1e3:
            if online:                   # partition churns with the trace
                d = c.decision(book, t0 + t / 1e3,
                               use_average_bw=use_average_partition)
                if d.p >= L:
                    t += period          # fully on-device, never reaches us
                    continue
            bw = c.trace.at(t0 + t / 1e3)
            mob = costs.mobile_latency_ms(c.device, d.p)
            nbytes = float(costs.act_bytes[d.p])
            xfer = nbytes / bw * 1e3
            chain = None if online else [runtime_for(sp)
                                         for sp in routes[c.name]]
            reqs.append(Req(client=c.name, emit_ms=t, deadline_ms=t + slo,
                            server_arrival_ms=t + mob + xfer, stages=chain,
                            p=d.p, xfer_bytes=nbytes, xfer_ms=xfer,
                            model=c.model))
            t += period

    # -------- event loop ----------------------------------------------------
    cnt = itertools.count()
    events = [(r.server_arrival_ms, next(cnt), "arrive", r) for r in reqs]
    if online:
        period = getattr(controller, "control_period_ms", 500.0)
        tick = period
        while tick < duration_s * 1e3:
            events.append((tick, next(cnt), "control", None))
            tick += period
    heapq.heapify(events)
    profile_cache = {}
    waiting: list[Req] = []                 # online: no route yet
    n_waited = 0

    def exec_ms(rt: StageRuntime, b: int) -> float:
        key = (rt.model, rt.start, rt.end, b, rt.share)
        if key not in profile_cache:
            profile_cache[key] = float(
                book[rt.model].latency_ms(rt.start, rt.end, b, rt.share))
        return profile_cache[key]

    def try_dispatch(rt: StageRuntime, now: float):
        while rt.queue:
            i = int(np.argmin(rt.free_at))
            if rt.free_at[i] > now:
                heapq.heappush(events, (rt.free_at[i], next(cnt), "poll", rt))
                return
            take = rt.queue[:rt.batch]
            del rt.queue[:rt.batch]
            kept = []
            for _, r in take:
                if drop_late and now > r.deadline_ms:
                    r.dropped = True
                else:
                    kept.append(r)
            if not kept:
                continue
            dt = exec_ms(rt, len(kept))
            rt.free_at[i] = now + dt
            for r in kept:
                heapq.heappush(events,
                               (now + dt, next(cnt), "stage_done", r))

    def resolve(r: Req) -> bool:
        keys = route_keys.get(r.client)
        if keys is None or any(k not in pool_table for k in keys):
            return False
        r.stages = [pool_table[k] for k in keys]
        return True

    def apply_plan(now: float, new_plan: ExecutionPlan) -> None:
        """Mutate the live pool set to the new plan via the controller's
        diff. Scratch mode (apply_diffs=False) tears everything down:
        every old pool drains unreferenced, every new pool pays startup."""
        nonlocal route_keys
        # diff against the simulator's OWN live pool state, not the
        # controller's internal previous plan — they can disagree (e.g. a
        # controller that was never adopt()-ed), and the live table is
        # what actually gets mutated
        from repro_torch.core.plandiff import diff_plans
        diff = diff_plans(
            {k: PoolSpec(k, rt.share, rt.batch, rt.n_instances)
             for k, rt in pool_table.items()}
            if controller.apply_diffs else {},
            plan_pools(new_plan))
        if not controller.apply_diffs:
            pool_table.clear()              # old pools drain, then die
        for a in diff.actions:
            if a.kind == "add":
                pool_table[a.key] = make_pool(
                    a.new, now + instance_startup_ms)
            elif a.kind == "remove":
                pool_table.pop(a.key, None)
            elif a.kind in ("resize", "rebatch"):
                rt = pool_table.get(a.key)
                if rt is None:
                    pool_table[a.key] = make_pool(
                        a.new, now + instance_startup_ms)
                    continue
                # grow/shrink by actual serving slots (a zero-instance
                # pool carries one dead placeholder slot — don't let it
                # become a free warm instance)
                slots = rt.free_at if rt.n_instances > 0 else []
                if a.new.n_instances > len(slots):
                    slots = slots + [now + instance_startup_ms] * \
                        (a.new.n_instances - len(slots))
                elif a.new.n_instances < len(slots):
                    slots = sorted(slots)[:a.new.n_instances]
                rt.free_at = slots or [now + instance_startup_ms]
                rt.n_instances = a.new.n_instances
                rt.share, rt.batch = a.new.share, a.new.batch
        route_keys = _routing_keys(new_plan)
        # replan may have routed clients that were waiting
        still = []
        for r in waiting:
            if now > r.deadline_ms:
                r.dropped = True
            elif resolve(r):
                rt = r.stages[0]
                rt.queue.append((now, r))
                try_dispatch(rt, now)
            else:
                still.append(r)
        waiting[:] = still

    def observe_arrival(now: float, r: Req) -> None:
        controller.observe_arrival(
            now, r.client, r.model, r.p,
            budget_ms=r.deadline_ms - r.server_arrival_ms,
            xfer_bytes=r.xfer_bytes, xfer_ms=r.xfer_ms)

    while events:
        now, _, kind, obj = heapq.heappop(events)
        if kind == "arrive":
            if online:
                observe_arrival(now, obj)
                if not resolve(obj):
                    waiting.append(obj)
                    n_waited += 1
                    new_plan = controller.control(now)   # fragment arrival
                    if new_plan is not None:
                        apply_plan(now, new_plan)
                    continue
            rt = obj.stages[obj.stage_idx]
            rt.queue.append((now, obj))
            try_dispatch(rt, now)
        elif kind == "stage_done":
            obj.stage_idx += 1
            if obj.stage_idx >= len(obj.stages):
                obj.done_ms = now
                if online:
                    controller.observe_done(
                        now, obj.client, now - obj.server_arrival_ms,
                        budget_ms=obj.deadline_ms - obj.server_arrival_ms)
            else:
                rt = obj.stages[obj.stage_idx]
                rt.queue.append((now, obj))
                try_dispatch(rt, now)
        elif kind == "control":
            new_plan = controller.control(now)
            if new_plan is not None:
                apply_plan(now, new_plan)
        else:                                           # poll
            try_dispatch(obj, now)

    for r in waiting:                                   # never routed
        r.dropped = True

    lat, drops = {}, {}
    for r in reqs:
        if r.dropped or r.done_ms is None:
            drops[r.client] = drops.get(r.client, 0) + 1
        else:
            lat.setdefault(r.client, []).append(r.done_ms - r.emit_ms)
    meta = {"n_requests": len(reqs)}
    if online:
        meta["controller"] = {
            "replans": controller.stats["replans"],
            "mean_replan_ms": controller.mean_replan_ms(),
            "pools_kept": controller.stats["pools_kept"],
            "pools_added": controller.stats["pools_added"],
            "pools_removed": controller.stats["pools_removed"],
            "triggers": dict(controller.stats["triggers"]),
            "n_waited": n_waited,
        }
    return SimResult(
        latencies_ms={c: np.asarray(v) for c, v in lat.items()},
        drops=drops, slo_ms=slo_ms,
        meta=meta)
