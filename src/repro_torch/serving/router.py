"""Global request routing for :class:`~repro_torch.serving.fleet.GraftFleet`.

Rendezvous hashing balances *client count*, not *load*: one hot client
pins its front-end while the rest idle, wasting exactly the sharing
that re-alignment creates. This module keeps the HRW ring (it is the
deterministic anchor and the fallback) and layers a
:class:`WeightedRouter` on top that scores front-ends per request from
live signals the fleet refreshes out of its front-ends each control
tick:

  * **queue depth** — ``MicroBatcher`` backlog plus how far into the
    future every pool driver's ``busy_until_ms`` reaches, in
    milliseconds of estimated work;
  * **recent shed rate** — the fraction of this front-end's recent
    outcomes that were sheds (a front-end that is dropping work is a
    bad place to add more);
  * **worker health** — wedged/partitioned front-ends (no completion
    progress, or a ``beacon/*`` watchdog gauge tripped) are scored off
    the ring entirely;
  * **KV prefix-cache affinity** — a compact residency digest exported
    by :class:`~repro_torch.serving.kvcache.PagedKVCache` (hashes of its
    prefix-index keys) matched against the request's own prompt-prefix
    digest, so repeated prompts land where their blocks already live.

Scores are milliseconds (lower is better): depth plus penalty terms
minus an affinity bonus. Signals only refresh on the fleet tick, so the
router also charges itself **pending load** for every request it routes
between refreshes (cleared by the next :meth:`update` for that
front-end) — without it, a burst arriving inside one tick all sees the
same snapshot and lands on one front-end. Routing decisions are
**sticky**: a client
moves off its current front-end only when the best candidate beats it
by more than ``hysteresis_ms`` — without that band, two near-equal
front-ends would flap a client between them every tick, defeating both
the uplink EWMA and the KV affinity it is trying to exploit. Ties break
deterministically (HRW winner first, then lexicographic name) so tests
reproduce. When signals are missing or older than ``stale_after_ms``
the router falls back to the plain HRW ring — a router must never be
*less* available than the static hash it replaces.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.serving.telemetry import NULL as NULL_TELEMETRY

__all__ = ["WeightedRouter", "affinity_overlap", "rendezvous_route",
           "rendezvous_table"]


def affinity_overlap(digest, residency) -> int:
    """How many of a request's prompt-prefix chunk digests are already
    resident in a cache's digest set — the ONE KV-affinity measure, used
    both for front-end scoring here and for prefill-pool choice in
    ``GraftServer`` (the router's affinity extended down to pools).
    Chain-keyed digests mean a hit at chunk ``i`` implies hits at every
    chunk before it, so the count approximates reusable prefix LENGTH,
    not just membership."""
    if not digest or not residency:
        return 0
    return sum(1 for d in digest if d in residency)


def _score(frontend: str, client: str) -> int:
    """Deterministic HRW weight (never the salted builtin ``hash``)."""
    h = hashlib.blake2b(f"{frontend}\x00{client}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big")


def rendezvous_route(client: str, frontends: list) -> str:
    """The front-end ``client`` consistently routes to: the one with the
    highest rendezvous hash. Stable under membership change everywhere
    except the added/removed front-end's own winners."""
    if not frontends:
        raise ValueError("no front-ends to route to")
    return max(sorted(frontends), key=lambda fe: _score(fe, client))


def rendezvous_table(clients, frontends: list) -> dict:
    """client -> front-end for a whole fleet (test/report helper)."""
    return {c: rendezvous_route(c, frontends) for c in clients}


@dataclass
class _Signal:
    """One front-end's live routing inputs, as of ``stamp_ms``."""
    stamp_ms: float = -1e18
    queue_depth_ms: float = 0.0
    shed_frac: float = 0.0
    unhealthy: bool = False
    affinity: frozenset = field(default_factory=frozenset)


class WeightedRouter:
    """Score-based client -> front-end routing over live fleet signals.

    The router holds no references to servers — it maps *names* to
    names from signal snapshots the fleet pushes via :meth:`update`.
    All weights are in milliseconds so the score reads as "estimated
    extra latency of routing one more request here".
    """

    def __init__(self, *, telemetry=None,
                 hysteresis_ms: float = 25.0,
                 shed_penalty_ms: float = 50.0,
                 health_penalty_ms: float = 1e6,
                 affinity_bonus_ms: float = 10.0,
                 stale_after_ms: float = 1000.0,
                 pending_cost_ms: float = 25.0):
        self.hysteresis_ms = hysteresis_ms
        self.shed_penalty_ms = shed_penalty_ms
        self.health_penalty_ms = health_penalty_ms
        self.affinity_bonus_ms = affinity_bonus_ms
        self.stale_after_ms = stale_after_ms
        self.pending_cost_ms = pending_cost_ms
        tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self._tel = tel
        self._m_affinity = tel.counter("route/affinity_hits")
        self._m_fallback = tel.counter("route/fallback_hrw")
        self._m_weighted = tel.counter("route/weighted")
        self._lock = threading.Lock()
        self._signals: dict[str, _Signal] = {}
        self._last: dict[str, str] = {}        # client -> sticky choice
        self._pending: dict[str, float] = {}   # fe -> ms routed since update
        self.stats = {"weighted": 0, "fallback_hrw": 0, "affinity_hits": 0,
                      "moves": 0}

    # ------------------------------------------------------------ signals
    def update(self, name: str, *, now_ms: float,
               queue_depth_ms: float = 0.0, shed_frac: float = 0.0,
               unhealthy: bool = False, affinity=()) -> None:
        """Refresh one front-end's signal snapshot (fleet control tick)."""
        with self._lock:
            self._signals[name] = _Signal(
                stamp_ms=now_ms,
                queue_depth_ms=float(queue_depth_ms),
                shed_frac=float(shed_frac),
                unhealthy=bool(unhealthy),
                affinity=frozenset(affinity))
            # the fresh depth already contains whatever we routed here
            self._pending[name] = 0.0
        self._tel.gauge(f"route/{name}/queue_depth").set(
            float(queue_depth_ms))

    def forget(self, name: str) -> None:
        """Drop a removed front-end's signals and sticky choices."""
        with self._lock:
            self._signals.pop(name, None)
            self._pending.pop(name, None)
            for client, fe in list(self._last.items()):
                if fe == name:
                    del self._last[client]

    def signal(self, name: str) -> Optional[_Signal]:
        with self._lock:
            return self._signals.get(name)

    def queue_depths(self) -> dict[str, float]:
        with self._lock:
            return {n: s.queue_depth_ms for n, s in self._signals.items()}

    # ------------------------------------------------------------ scoring
    def _score_one(self, sig: _Signal, digest) -> tuple[float, bool]:
        score = sig.queue_depth_ms + self.shed_penalty_ms * sig.shed_frac
        if sig.unhealthy:
            score += self.health_penalty_ms
        hit = False
        overlap = affinity_overlap(digest, sig.affinity)
        if overlap:
            hit = True
            score -= self.affinity_bonus_ms * overlap
        return score, hit

    def route(self, client: str, frontends: list, *, now_ms: float,
              digest=None) -> str:
        """Pick the front-end for one request. ``digest`` is the
        request's prompt-prefix digest (iterable of ints) when the
        caller has one; None routes on load/health alone."""
        hrw = rendezvous_route(client, frontends)
        if len(frontends) < 2:
            return hrw
        with self._lock:
            sigs = {fe: self._signals.get(fe) for fe in frontends}
            anchor = self._last.get(client)
            pending = {fe: self._pending.get(fe, 0.0) for fe in frontends}
        fresh = {fe: s for fe, s in sigs.items()
                 if s is not None and now_ms - s.stamp_ms
                 <= self.stale_after_ms}
        if len(fresh) < len(frontends):
            # missing/stale signals: the static ring is the only safe
            # answer (scoring a subset would route around blind spots)
            self.stats["fallback_hrw"] += 1
            self._m_fallback.inc()
            with self._lock:
                self._last[client] = hrw
                self._pending[hrw] = \
                    self._pending.get(hrw, 0.0) + self.pending_cost_ms
            return hrw
        scores, hits = {}, {}
        for fe, sig in fresh.items():
            scores[fe], hits[fe] = self._score_one(sig, digest)
            scores[fe] += pending[fe]
        # deterministic: score, then HRW-winner-first, then name
        best = min(frontends, key=lambda fe: (scores[fe], fe != hrw, fe))
        if anchor not in frontends or fresh[anchor].unhealthy:
            anchor = None
        if anchor is not None and \
                scores[best] + self.hysteresis_ms >= scores[anchor]:
            best = anchor                      # sticky: not enough better
        self.stats["weighted"] += 1
        self._m_weighted.inc()
        if hits.get(best):
            self.stats["affinity_hits"] += 1
            self._m_affinity.inc()
        with self._lock:
            if self._last.get(client) not in (None, best):
                self.stats["moves"] += 1
            self._last[client] = best
            self._pending[best] = \
                self._pending.get(best, 0.0) + self.pending_cost_ms
        return best
