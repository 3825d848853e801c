"""Online SLO-aware serving controller — closes the monitor -> plan ->
apply loop the paper's deployment story needs (§6 discussion; DynO and
Autodidactic Neurosurgeon show the runtime-adaptation wins).

The controller never reads ground truth: everything it knows comes from
the server-visible event stream — request arrivals (which carry the
client's partition point, the activation bytes that crossed the uplink,
and the residual time budget) and completions. From sliding windows over
those events it estimates per-client arrival rate, uplink bandwidth, and
SLO risk, and decides *when* to replan:

  * fragment arrival / departure — a client appears, vanishes from the
    window, or shifts its partition point (Neurosurgeon churn);
  * rate drift beyond a hysteresis band — small blips don't thrash the
    scheduler;
  * SLO-violation risk — the server-side latency percentile drifting
    toward the budget (queueing building up before violations happen).

A replan calls the configured planner (``IncrementalPlanner`` for shadow
reuse; any ``.plan(frags)`` works) and the *difference* to the running
deployment is applied via ``core.plandiff`` — unchanged pools keep their
queues, warm instances, and compiled programs. ``apply_diffs=False``
degrades to the replan-from-scratch baseline (every pool torn down and
restarted) that ``benchmarks/bench_controller.py`` compares against.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.fragment import Fragment
from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.plandiff import diff_plans, plan_pools, PlanDiff
from repro_torch.serving.telemetry import audit_entry


@dataclass
class ClientWindow:
    """Sliding-window observations for one client, all in sim-ms."""
    model: str
    arrivals: deque = field(default_factory=deque)    # t_ms
    bw: deque = field(default_factory=deque)          # (t_ms, bytes/s)
    budgets: deque = field(default_factory=deque)     # (t_ms, budget_ms)
    lat: deque = field(default_factory=deque)         # (t_ms, lat/budget)
    sheds: deque = field(default_factory=deque)       # t_ms (dropped reqs)
    tpot: deque = field(default_factory=deque)        # (t_ms, tpot/budget)
    p: int = 0                                        # latest partition point

    def prune(self, horizon_ms: float) -> None:
        for dq in (self.arrivals, self.sheds):
            while dq and dq[0] < horizon_ms:
                dq.popleft()
        for dq in (self.bw, self.budgets, self.lat, self.tpot):
            while dq and dq[0][0] < horizon_ms:
                dq.popleft()


@dataclass
class Estimate:
    """What the controller believes about one client right now."""
    model: str
    p: int
    rate: float                                       # RPS
    budget_ms: float
    bw: float                                         # bytes/s uplink
    risk: float                                       # lat/budget percentile
    bw_slope: float = 0.0                             # bytes/s per ms (trend)
    shed_frac: float = 0.0                            # dropped / offered
    tpot_risk: float = 0.0                            # tpot/budget percentile
    from_prior: bool = False                          # cold-start seeded


@dataclass(frozen=True)
class _Prior:
    """Declared-rate prior for one client (controller cold start): what
    the fleet *said* it would do, trusted until the sliding window has
    enough real samples to speak for itself."""
    model: str
    p: int
    q: float
    t: float
    until_ms: float


class ServingController:
    """Event-driven control loop between monitoring and planning."""

    def __init__(self, book, planner=None, *,
                 window_ms: float = 4000.0,
                 control_period_ms: float = 500.0,
                 rate_hysteresis: float = 0.3,
                 risk_pct: float = 95.0,
                 risk_threshold: float = 0.85,
                 risk_boost: float = 1.25,
                 min_replan_interval_ms: float = 1000.0,
                 apply_diffs: bool = True,
                 cold_start_samples: int = 8,
                 bw_trend_lookahead_ms: float = 1500.0,
                 bw_trend_threshold: float = 0.25,
                 bw_trend_min_samples: int = 4,
                 shed_trigger_frac: float = 0.1,
                 route_imbalance_frac: float = 0.25,
                 disagg_pressure_frac: float = 0.25):
        from repro_torch.core.reuse import IncrementalPlanner
        self.book = book
        self.planner = planner or IncrementalPlanner(book)
        self.window_ms = window_ms
        self.control_period_ms = control_period_ms
        self.rate_hysteresis = rate_hysteresis
        self.risk_pct = risk_pct
        self.risk_threshold = risk_threshold
        self.risk_boost = risk_boost
        self.min_replan_interval_ms = min_replan_interval_ms
        self.apply_diffs = apply_diffs
        self.cold_start_samples = cold_start_samples
        self.bw_trend_lookahead_ms = bw_trend_lookahead_ms
        self.bw_trend_threshold = bw_trend_threshold
        self.bw_trend_min_samples = bw_trend_min_samples
        self.shed_trigger_frac = shed_trigger_frac
        self.route_imbalance_frac = route_imbalance_frac
        self.disagg_pressure_frac = disagg_pressure_frac

        # (now_ms, frac) from the fleet's work-stealing balancer: a
        # persistent queue-depth skew the router couldn't smooth means
        # the PLACEMENT is lopsided, not just the routing
        self._route_imbalance: Optional[tuple] = None
        # (now_ms, frac) from each front-end's tick: the fraction of
        # decode completions that fell back to the in-process path — the
        # deployed pools can't hold the generative load, so the planner
        # should revisit pool roles/capacity (prefill/decode split)
        self._disagg_pressure: Optional[tuple] = None
        self._clients: dict[str, ClientWindow] = {}
        self._planned_q: dict[str, float] = {}           # client -> planned RPS
        self._planned_p: dict[str, int] = {}
        self._planned_bw: dict[str, float] = {}          # bw at last replan
        self._priors: dict[str, _Prior] = {}             # cold-start seeds
        self._plan: Optional[ExecutionPlan] = None
        self._undo: Optional[tuple] = None
        self._last_replan_ms = -np.inf
        self.stats = {"replans": 0, "refused": 0, "replan_ms": [],
                      "triggers": {}, "pools_kept": 0, "pools_added": 0,
                      "pools_removed": 0}
        self.last_diff: Optional[PlanDiff] = None        # diff of last replan
        self.log: list = []                              # (t_ms, triggers, diff summary)
        # structured audit: one telemetry.audit_entry per replan, with
        # the window estimates that fired it; the server stamps apply
        # latency via note_apply once the transition lands
        self.audit: list = []

    # ------------------------------------------------------------ observe
    def observe_arrival(self, now_ms: float, client: str, model: str,
                        p: int, budget_ms: float, xfer_bytes: float = 0.0,
                        xfer_ms: float = 0.0) -> None:
        w = self._clients.get(client)
        if w is None:
            w = self._clients[client] = ClientWindow(model=model, p=p)
        w.arrivals.append(now_ms)
        w.budgets.append((now_ms, budget_ms))
        if xfer_ms > 0 and xfer_bytes > 0:
            w.bw.append((now_ms, xfer_bytes / (xfer_ms / 1e3)))
        w.p = p

    def observe_uplink(self, now_ms: float, client: str, nbytes: float,
                       xfer_ms: float) -> None:
        """Feed one transport-measured uplink transfer into the bandwidth
        window — the real-socket counterpart of the ``xfer_bytes`` /
        ``xfer_ms`` pair ``observe_arrival`` takes from the simulator.
        Unknown clients are ignored (a transfer is not an arrival; the
        arrival event itself introduces the client)."""
        w = self._clients.get(client)
        if w is not None and nbytes > 0 and xfer_ms > 0:
            w.bw.append((now_ms, nbytes / (xfer_ms / 1e3)))

    def ingest_uplink(self, now_ms: float, samples) -> None:
        """Bulk-feed ``(client, nbytes, ms)`` samples — the shape
        ``GraftExecutor.drain_uplink()`` produces."""
        for client, nbytes, ms in samples:
            self.observe_uplink(now_ms, client, nbytes, ms)

    def observe_shed(self, now_ms: float, client: str) -> None:
        """One request dropped by the runtime's shed policy. Sheds are
        capacity-starvation signals: their fraction of offered load feeds
        the ``overload_shed`` trigger so the planner gets a chance to buy
        the missing capacity instead of shedding forever."""
        w = self._clients.get(client)
        if w is not None:
            w.sheds.append(now_ms)

    def observe_imbalance(self, now_ms: float, frac: float) -> None:
        """The fleet balancer reports a cross-front-end queue-depth skew
        (victim minus thief depth over total depth) that persisted long
        enough to trigger a steal. Stealing moved the work once; a
        recurring skew above ``route_imbalance_frac`` fires the
        ``route_imbalance`` trigger so the planner can rebalance the
        capacity the skew is really about."""
        self._route_imbalance = (now_ms, float(frac))

    def observe_disagg_pressure(self, now_ms: float, frac: float) -> None:
        """A front-end reports the per-tick fraction of decode
        completions served by its in-process fallback instead of a pool.
        A fraction above ``disagg_pressure_frac`` fires the
        ``disagg_pressure`` trigger: the deployment is missing (or has
        starved) decode capacity and the planner should revisit pool
        roles — e.g. split a full-range pool into prefill + decode via
        ``ExecutionPlan.with_disagg``."""
        self._disagg_pressure = (now_ms, float(frac))

    def observe_done(self, now_ms: float, client: str,
                     server_latency_ms: float,
                     budget_ms: Optional[float] = None) -> None:
        """``budget_ms`` is the completed request's own server-side budget
        (callers that track requests pass it; pairing a completion with
        the latest arrival's budget would skew risk on volatile traces)."""
        w = self._clients.get(client)
        if w is None:
            return
        if budget_ms is None:
            if not w.budgets:
                return
            budget_ms = w.budgets[-1][1]
        if budget_ms > 0:
            w.lat.append((now_ms, server_latency_ms / budget_ms))

    def observe_decode(self, now_ms: float, client: str, ttft_ms: float,
                       tpot_ms: float, ttft_budget_ms: float,
                       tpot_budget_ms: float) -> None:
        """One finished decode stream. TTFT rides the normal ``lat``
        window via :meth:`observe_done` (the caller reports it there);
        this adds the per-token side — normalized TPOT feeds the
        ``decode_slo`` trigger so a pool whose step time creeps toward
        the per-token budget forces a replan before streams start
        missing their ABSOLUTE deadlines."""
        w = self._clients.get(client)
        if w is None or tpot_budget_ms <= 0:
            return
        w.tpot.append((now_ms, tpot_ms / tpot_budget_ms))

    # ---------------------------------------------------------- estimates
    def _bw_slope(self, w: ClientWindow) -> float:
        """Linear bandwidth trend over the window (bytes/s per ms); 0
        when there aren't enough samples to fit a line."""
        if len(w.bw) < self.bw_trend_min_samples:
            return 0.0
        ts = np.array([t for t, _ in w.bw], np.float64)
        vs = np.array([v for _, v in w.bw], np.float64)
        span = ts[-1] - ts[0]
        if span <= 1e-6:
            return 0.0
        return float(np.polyfit(ts - ts[0], vs, 1)[0])

    def estimates(self, now_ms: float) -> dict[str, Estimate]:
        out = {}
        horizon = now_ms - self.window_ms
        for name, w in list(self._clients.items()):
            w.prune(horizon)
            if not w.arrivals:
                if not (w.bw or w.budgets or w.lat or w.sheds):
                    del self._clients[name]     # departed: evict, don't leak
                continue
            if len(w.arrivals) >= 2:        # inter-arrival estimate: robust
                span_s = (w.arrivals[-1] - w.arrivals[0]) / 1e3
                rate = (len(w.arrivals) - 1) / max(span_s, 1e-9)
            else:
                rate = 1e3 / self.window_ms  # one sample: ~1 per window
            budget = min(b for _, b in w.budgets) if w.budgets else 0.0
            bw = float(np.mean([v for _, v in w.bw])) if w.bw else 0.0
            risk = float(np.percentile([r for _, r in w.lat],
                                       self.risk_pct)) if w.lat else 0.0
            tpot_risk = float(np.percentile([r for _, r in w.tpot],
                                            self.risk_pct)) if w.tpot \
                else 0.0
            out[name] = Estimate(model=w.model, p=w.p, rate=rate,
                                 budget_ms=budget, bw=bw, risk=risk,
                                 bw_slope=self._bw_slope(w),
                                 shed_frac=min(
                                     len(w.sheds) / max(len(w.arrivals), 1),
                                     1.0),
                                 tpot_risk=tpot_risk)
        # cold-start overlay: while a client's window is near-empty, the
        # fleet's DECLARED rate/budget speak for it (bounding the first
        # ticks' estimation error) — the window takes over once it holds
        # >= cold_start_samples real arrivals, or the prior expires.
        graduated = []
        for name, pr in self._priors.items():
            w = self._clients.get(name)
            n = len(w.arrivals) if w is not None else 0
            if n >= self.cold_start_samples or now_ms >= pr.until_ms:
                graduated.append(name)
                continue
            e = out.get(name)
            if e is None:
                out[name] = Estimate(model=pr.model, p=pr.p, rate=pr.q,
                                     budget_ms=pr.t, bw=0.0, risk=0.0,
                                     from_prior=True)
            else:
                budget = min(e.budget_ms, pr.t) if e.budget_ms > 0 else pr.t
                out[name] = dataclasses.replace(e, rate=pr.q,
                                                budget_ms=budget,
                                                from_prior=True)
        for name in graduated:
            del self._priors[name]
        return out

    # ------------------------------------------------------------ triggers
    def _bw_anchor(self, e: Estimate) -> float:
        """The bandwidth a replan effectively plans for: the projected
        value when the trend is down, the current mean otherwise.
        Floored at a sliver of the current mean so a to-zero projection
        can't park the anchor at 0 and disarm the trigger."""
        proj = e.bw + min(e.bw_slope, 0.0) * self.bw_trend_lookahead_ms
        return max(min(e.bw, proj), 0.05 * e.bw)

    def _triggers(self, est: dict[str, Estimate],
                  now_ms: Optional[float] = None) -> list[str]:
        trig = []
        if self._route_imbalance is not None:
            t, frac = self._route_imbalance
            fresh = now_ms is None or now_ms - t <= self.window_ms
            if fresh and frac > self.route_imbalance_frac:
                trig.append("route_imbalance")
            elif not fresh:
                self._route_imbalance = None   # stale skew: disarm
        if self._disagg_pressure is not None:
            t, frac = self._disagg_pressure
            fresh = now_ms is None or now_ms - t <= self.window_ms
            if fresh and frac > self.disagg_pressure_frac:
                trig.append("disagg_pressure")
            elif not fresh:
                self._disagg_pressure = None   # stale pressure: disarm
        for name, e in est.items():
            if name not in self._planned_q:
                trig.append("fragment_arrival")
            elif e.p != self._planned_p.get(name):
                trig.append("partition_shift")
            else:
                planned = self._planned_q[name]
                if planned > 0 and \
                        abs(e.rate - planned) / planned > self.rate_hysteresis:
                    trig.append("rate_drift")
            if e.risk > self.risk_threshold:
                trig.append("slo_risk")
            # per-token latency creeping toward the TPOT budget: the
            # decode batch is too deep (or the pool too slow) for the
            # streams it carries
            if e.tpot_risk > self.risk_threshold:
                trig.append("decode_slo")
            # the runtime is dropping this client's requests: the current
            # allocation provably lacks capacity for the offered load —
            # replan (arrival windows already count shed requests, so the
            # planner sees the full offered rate)
            if e.shed_frac > self.shed_trigger_frac:
                trig.append("overload_shed")
            # predictive: a steadily DEGRADING uplink means this client is
            # about to shift its partition point (Neurosurgeon picks a
            # deeper split on a slow link) — replan on the projected drop
            # instead of waiting for mis-routed requests to arrive.
            if e.bw > 0 and e.bw_slope < 0:
                proj = e.bw + e.bw_slope * self.bw_trend_lookahead_ms
                base = self._planned_bw.get(name, e.bw)
                if base > 0 and (base - proj) / base > self.bw_trend_threshold:
                    trig.append("bw_trend")
        for name in self._planned_q:
            if name not in est:
                trig.append("fragment_departure")
        return trig

    # -------------------------------------------------------------- plan
    def adopt(self, plan: ExecutionPlan, frags: list[Fragment],
              now_ms: float = 0.0) -> ExecutionPlan:
        """Seed the controller with an externally-built initial plan.
        The fragments' declared (rate, budget) become cold-start priors:
        until a client's window holds real data, estimates speak with the
        fleet's declared numbers instead of overshooting on noise."""
        self._plan = plan
        self._planned_q = {f.client: f.q for f in frags}
        self._planned_p = {f.client: f.p for f in frags}
        self._priors = {f.client: _Prior(model=f.model, p=f.p, q=f.q,
                                         t=f.t,
                                         until_ms=now_ms + self.window_ms)
                        for f in frags}
        self._last_replan_ms = now_ms
        return plan

    def bootstrap(self, frags: list[Fragment],
                  now_ms: float = 0.0) -> ExecutionPlan:
        """Plan from scratch for an initial fragment set and adopt it."""
        return self.adopt(self.planner.plan(frags), frags, now_ms)

    def _fragments(self, est: dict[str, Estimate]) -> list[Fragment]:
        frags = []
        for name, e in est.items():
            q = e.rate * (self.risk_boost if e.risk > self.risk_threshold
                          else 1.0)
            frags.append(Fragment(model=e.model, p=e.p,
                                  t=max(e.budget_ms, 1e-3), q=q,
                                  client=name))
        return frags

    def control(self, now_ms: float, *, force: bool = False
                ) -> Optional[ExecutionPlan]:
        """One control tick: check triggers, maybe replan. Returns the new
        plan (caller applies it — e.g. the simulator mutates its pools via
        the diff) or None when no action is needed."""
        if not force and \
                now_ms - self._last_replan_ms < self.min_replan_interval_ms:
            return None
        est = self.estimates(now_ms)
        if not est:
            return None
        trig = self._triggers(est, now_ms)
        if not trig and not force:
            return None
        frags = self._fragments(est)
        t0 = time.perf_counter()
        plan = self.planner.plan(frags)
        replan_ms = (time.perf_counter() - t0) * 1e3
        diff = self.last_diff = self.plan_diff(plan)
        self.stats["replans"] += 1
        self.stats["replan_ms"].append(replan_ms)
        for t in set(trig) or {"forced"}:
            self.stats["triggers"][t] = self.stats["triggers"].get(t, 0) + 1
        s = diff.summary()
        self.stats["pools_kept"] += diff.n_kept
        self.stats["pools_added"] += s["add"]
        self.stats["pools_removed"] += s["remove"]
        trig_names = sorted(set(trig)) or ["forced"]
        self.log.append((now_ms, trig_names, s))
        window = {name: {"rate": round(e.rate, 3),
                         "budget_ms": round(e.budget_ms, 3),
                         "bw": round(e.bw, 1),
                         "risk": round(e.risk, 4),
                         "tpot_risk": round(e.tpot_risk, 4),
                         "shed_frac": round(e.shed_frac, 4),
                         "from_prior": e.from_prior}
                  for name, e in sorted(est.items())}
        entry = audit_entry(now_ms, trig_names, window, s)
        entry["replan_ms"] = round(replan_ms, 3)
        self.audit.append(entry)
        # what revert() restores if the caller cannot deploy this plan
        self._undo = (self._plan, self._planned_q, self._planned_p,
                      self._planned_bw)
        self._plan = plan
        self._planned_q = {f.client: f.q for f in frags}
        self._planned_p = {f.client: f.p for f in frags}
        # anchor the trend trigger at the bw this replan ALREADY planned
        # for (the projected value, when the trend is down): bw_trend
        # re-fires only on a further projected drop below this. Clients
        # with no bw signal yet (cold start) get NO anchor — a 0.0 entry
        # would permanently pass the base>0 guard and kill the trigger
        self._planned_bw = {name: self._bw_anchor(e)
                            for name, e in est.items() if e.bw > 0}
        # a replan resets the risk/shed windows: the new allocation gets a
        # fresh look instead of being re-triggered by stale samples
        for w in self._clients.values():
            w.lat.clear()
            w.sheds.clear()
        self._route_imbalance = None
        self._disagg_pressure = None
        self._last_replan_ms = now_ms
        return plan

    def revert(self, reason: str) -> None:
        """The caller could not deploy the plan the last :meth:`control`
        returned (``apply_plan`` refused it): believe the deployed plan
        again, so the triggers that fired it fire against what is running
        and a later tick replans. The refused attempt stays in the audit,
        marked with ``reason``."""
        if self._undo is None:
            return
        (self._plan, self._planned_q, self._planned_p,
         self._planned_bw) = self._undo
        self._undo = None
        self.stats["refused"] += 1
        if self.audit:
            self.audit[-1]["refused"] = reason

    def note_apply(self, apply_ms: float) -> None:
        """Stamp the live-transition latency onto the most recent audit
        entry (the server calls this right after ``apply`` returns)."""
        if self.audit and self.audit[-1]["apply_ms"] is None:
            self.audit[-1]["apply_ms"] = round(apply_ms, 3)

    def plan_diff(self, new_plan: ExecutionPlan) -> PlanDiff:
        """Diff the running plan against ``new_plan``. With
        ``apply_diffs=False`` every pool is reported add/remove (scratch
        redeploy) — warm state is deliberately not carried over."""
        old = plan_pools(self._plan) if (self._plan is not None
                                         and self.apply_diffs) else {}
        return diff_plans(old, plan_pools(new_plan))

    @property
    def current_plan(self) -> Optional[ExecutionPlan]:
        return self._plan

    def mean_replan_ms(self) -> float:
        r = self.stats["replan_ms"]
        return float(np.mean(r)) if r else 0.0
