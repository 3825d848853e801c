"""Deadline-aware micro-batching for the serving runtime.

Each stage pool in a :class:`repro_torch.serving.server.GraftServer` owns one
:class:`MicroBatcher`. Requests wait here — server-side, payload in hand
— until their batch *closes*, which happens on whichever comes first:

  * the pool's planned batch size is reached (``max_batch``), or
  * the earliest **flush deadline** in the queue expires.

A request's flush deadline is its absolute SLO deadline minus the
estimated cost of everything still ahead of it (remaining stage
execution from the cost model / measured EWMAs, plus a measured uplink
hop allowance) — the latest instant a batch containing it can close and
still meet the SLO. Batches therefore fill up when there is slack and
fire immediately when there is none, instead of flushing on wave or
depth boundaries like the lock-step ``GraftExecutor.serve`` loop.

The batcher is intentionally executor-agnostic: it holds opaque
:class:`BatchItem` payloads and deals only in deadlines, so it is unit
testable without a model and reusable for any staged pipeline. It also
holds NO clock of its own — every deadline-sensitive entry point takes
``now_ms`` from the caller (the server's injectable clock), so under a
test's fake clock the whole batching policy is deterministic.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

MAX_BATCH_SIZE_SAMPLES = 4096     # long-running servers must not grow
                                  # a float per batch forever


@dataclass
class BatchItem:
    """One queued request at one stage of its chain."""
    rid: int
    client: str
    payload: object                  # activation at this stage's boundary
    flush_ms: float                  # latest batch-close time (server clock)
    deadline_ms: float               # absolute server-side SLO deadline
    extras: Optional[dict] = None
    boundary: int = 0                # block boundary the payload sits at
    enqueued_ms: float = 0.0
    enqueued_ns: int = 0             # the same on the epoch clock (traced)
    hop_charge_ms: float = 0.0       # uplink time this item will serialize
                                     # on the pool's channel (stage 0 only)
    n_tokens: int = 0                # sequence length of the payload (what
                                     # a token-budget batch close counts)
    trace: bool = False              # span context: this request won the
                                     # telemetry trace-sampling draw, so
                                     # every hop (queue, uplink, exec —
                                     # including the worker side, via the
                                     # wire dict) records a span for it
    # -- decode (autoregressive) requests only --
    decode: bool = False             # route to the pool's decode batch
    max_new: int = 0                 # decode length budget (tokens to emit)
    ttft_deadline_ms: float = 0.0    # absolute first-token deadline;
                                     # deadline_ms then bounds the LAST token
    tpot_budget_ms: float = 0.0      # per-token budget after the first


@dataclass
class BatcherStats:
    n_batches: int = 0
    n_items: int = 0
    closed_full: int = 0             # batches closed by max_batch
    closed_deadline: int = 0         # batches closed by flush-deadline expiry
    closed_tokens: int = 0           # batches closed by the token budget
    taken: int = 0                   # items pulled by take() into a running
                                     # decode batch (continuous admission)
    batch_sizes: deque = field(     # recent sizes only; totals above
        default_factory=lambda: deque(maxlen=MAX_BATCH_SIZE_SAMPLES))

    def mean_batch(self) -> float:
        return self.n_items / self.n_batches if self.n_batches else 0.0


class MicroBatcher:
    """Thread-safe earliest-deadline-first batching queue.

    Producers :meth:`put` items; ONE consumer (the pool's driver thread)
    alternates :meth:`pop_ready` / :meth:`wait_for_work`. ``stop()``
    wakes the consumer permanently; ``drain()`` removes and returns
    everything queued (the reroute path when a pool is removed while
    requests are waiting on it).
    """

    def __init__(self, max_batch: int = 1, *, max_tokens: int = 0):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: list = []                    # (flush_ms, seq, item)
        self._seq = itertools.count()
        self._max_batch = max(int(max_batch), 1)
        # token budget: 0 disables. When set, a batch also closes once the
        # queued items' summed ``n_tokens`` reaches the budget — the close
        # policy for packed (ragged) pools, where the cost of a batch is
        # its token count, not its request count.
        self._max_tokens = max(int(max_tokens), 0)
        self._stopped = False
        self._paused = False                     # test hook: hold batches
        self._pending_hop_ms = 0.0               # sum of queued hop charges
        self._pending_tokens = 0                 # sum of queued n_tokens
        self.stats = BatcherStats()

    # ------------------------------------------------------------ intake
    def put(self, item: BatchItem) -> None:
        with self._cond:
            heapq.heappush(self._heap, (item.flush_ms, next(self._seq), item))
            self._pending_hop_ms += item.hop_charge_ms
            self._pending_tokens += item.n_tokens
            self._cond.notify_all()

    def put_many(self, items) -> None:
        with self._cond:
            for item in items:
                heapq.heappush(self._heap,
                               (item.flush_ms, next(self._seq), item))
                self._pending_hop_ms += item.hop_charge_ms
                self._pending_tokens += item.n_tokens
            self._cond.notify_all()

    @property
    def pending_hop_ms(self) -> float:
        """Serialized uplink time already queued here — what admission
        control charges a NEW request for the queue it would join (the
        stage cost model alone misses the network-bound backlog)."""
        with self._lock:
            return self._pending_hop_ms

    # ---------------------------------------------------------- consumer
    def _ready_locked(self, now_ms: float) -> bool:
        if self._paused or not self._heap:
            return False
        return (len(self._heap) >= self._max_batch
                or (self._max_tokens
                    and self._pending_tokens >= self._max_tokens)
                or self._heap[0][0] <= now_ms)

    def pop_ready(self, now_ms: float) -> list:
        """Close and return one batch if the policy says so, else [].

        A batch closes when ``max_batch`` items are queued, the token
        budget is reached (``max_tokens`` > 0), OR the earliest flush
        deadline has passed; items leave in EDF order. A token-budget
        close also bounds the batch it pops: items are taken until the
        budget would be exceeded (always at least one), so a burst of
        long sequences cannot close into one oversized program call.
        """
        with self._cond:
            if not self._ready_locked(now_ms):
                return []
            by_full = len(self._heap) >= self._max_batch
            by_tokens = bool(self._max_tokens
                             and self._pending_tokens >= self._max_tokens)
            batch, tokens = [], 0
            while self._heap and len(batch) < self._max_batch:
                nxt = self._heap[0][2]
                if (self._max_tokens and batch
                        and tokens + nxt.n_tokens > self._max_tokens):
                    break
                batch.append(heapq.heappop(self._heap)[2])
                tokens += nxt.n_tokens
            self._pending_hop_ms -= sum(it.hop_charge_ms for it in batch)
            self._pending_tokens -= tokens
            if not self._heap:
                self._pending_hop_ms = 0.0       # no queue, no drift
                self._pending_tokens = 0
            self.stats.n_batches += 1
            self.stats.n_items += len(batch)
            self.stats.batch_sizes.append(len(batch))
            if by_full:
                self.stats.closed_full += 1
            elif by_tokens:
                self.stats.closed_tokens += 1
            else:
                self.stats.closed_deadline += 1
            return batch

    def take(self, k: int) -> list:
        """Pull up to ``k`` queued items RIGHT NOW, in EDF order,
        bypassing the batch-close policy. This is iteration-level
        (continuous) admission: a running decode batch calls it at every
        step boundary to backfill slots vacated by finished sequences,
        instead of waiting for the queue to close a whole new batch.
        Respects ``pause()`` (the test hook holds decode admission too).
        """
        with self._cond:
            if self._paused or k <= 0:
                return []
            out = []
            while self._heap and len(out) < k:
                out.append(heapq.heappop(self._heap)[2])
            self._pending_hop_ms -= sum(it.hop_charge_ms for it in out)
            self._pending_tokens -= sum(it.n_tokens for it in out)
            if not self._heap:
                self._pending_hop_ms = 0.0
                self._pending_tokens = 0
            self.stats.taken += len(out)
            return out

    def wait_for_work(self, now_ms: float, *,
                      max_wait_ms: float = 100.0) -> None:
        """Block until a batch could be ready (or stop/timeout).

        Sleeps until the earliest flush deadline, a new item arrival, or
        ``max_wait_ms`` — whichever is first. The caller re-checks with
        :meth:`pop_ready`, so spurious wakeups are harmless.
        """
        with self._cond:
            if self._stopped or self._ready_locked(now_ms):
                return
            wait_ms = max_wait_ms
            if self._heap and not self._paused:
                wait_ms = min(wait_ms, max(self._heap[0][0] - now_ms, 0.0))
            self._cond.wait(timeout=wait_ms / 1e3)

    # ------------------------------------------------------------ control
    def set_max_batch(self, n: int) -> None:
        with self._cond:
            self._max_batch = max(int(n), 1)
            self._cond.notify_all()

    @property
    def max_batch(self) -> int:
        return self._max_batch

    def pause(self) -> None:
        """Test hook: hold every queued item until :meth:`resume` (lets a
        test pin requests on a pool while a replan removes it)."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    @property
    def stopped(self) -> bool:
        return self._stopped

    def drain(self) -> list:
        """Remove and return every queued item (EDF order)."""
        with self._cond:
            out = [heapq.heappop(self._heap)[2] for _ in range(len(self._heap))]
            self._pending_hop_ms = 0.0
            self._pending_tokens = 0
            return out

    def steal(self, k: Optional[int] = None, *, want=None) -> list:
        """Remove and return up to ``k`` queued-not-in-flight items for a
        work-stealing peer (every eligible item when ``k`` is None).
        Unlike :meth:`take` this ignores ``pause()`` — stealing exists
        precisely to pull work off a wedged front-end whose drivers have
        stopped consuming. ``want`` filters eligibility (e.g. excluding
        decode items whose KV state is resident here). Among eligible
        items the ones with the MOST slack (latest flush deadline) go
        first: they can best afford the extra hop, while an imminent
        flush stays where its batch is about to close."""
        with self._cond:
            items = [heapq.heappop(self._heap)[2]
                     for _ in range(len(self._heap))]
            eligible = [it for it in items if want is None or want(it)]
            n = len(eligible) if k is None \
                else min(max(int(k), 0), len(eligible))
            stolen = eligible[len(eligible) - n:] if n else []
            stolen_ids = {id(it) for it in stolen}
            self._pending_hop_ms = 0.0
            self._pending_tokens = 0
            for it in items:
                if id(it) in stolen_ids:
                    continue
                heapq.heappush(self._heap,
                               (it.flush_ms, next(self._seq), it))
                self._pending_hop_ms += it.hop_charge_ms
                self._pending_tokens += it.n_tokens
            return stolen

    def n_due(self, now_ms: float, *, want=None) -> int:
        """Queued items whose flush deadline has already passed — work
        that is LATE, as opposed to waiting out its batching window.
        The fleet balancer steals on this, not on raw queue length: a
        deep queue of far-future flush deadlines is deliberate slack.
        ``want`` filters which items count, as in :meth:`steal`."""
        with self._cond:
            return sum(1 for flush_ms, _, it in self._heap
                       if flush_ms <= now_ms and (want is None or want(it)))

    def next_flush_ms(self) -> Optional[float]:
        with self._cond:
            return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)


def bucket_size(n: int, max_batch: int) -> int:
    """Pad-to-bucket target for a batch of ``n``: the smallest power of
    two >= n, capped at ``max_batch`` (the cap itself is always a bucket
    even when not a power of two). Padding partial batches to these
    buckets bounds the distinct batch shapes a pool's jitted program ever
    sees at ~log2(max_batch)+1 instead of one trace per queue-length the
    traffic happens to produce — replans that rebatch pools stop churning
    the compile cache."""
    n = max(int(n), 1)
    cap = max(int(max_batch), 1)
    if n >= cap:
        return n                      # never pad past the planned batch
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def seq_bucket(n_tokens: int, *, floor: int = 8) -> int:
    """Sequence-length bucket: the smallest power of two >= ``n_tokens``
    (>= ``floor``). The pad-to-bucket fallback path pads each payload's
    token axis to this bucket before stacking, so a pool serving mixed
    lengths sees O(log(max_len)) distinct sequence shapes instead of one
    re-trace per length the traffic happens to produce."""
    n = max(int(n_tokens), 1)
    b = max(int(floor), 1)
    while b < n:
        b <<= 1
    return b


def token_bucket(n_tokens: int, *, floor: int = 8, step: int = 16) -> int:
    """Packed-buffer bucket: total token target for a sequence-packed
    batch. Totals at or under ``floor`` get the floor bucket (a lone
    short request must not double its cost); everything else rounds UP
    to the next multiple of ``step``. The packed path concatenates
    heterogeneous-length payloads along the token axis and pads ONLY
    the tail up to this bucket, so waste is bounded by ``step - 1``
    tokens *per flush* no matter how the batch mixes — strictly tighter
    than per-request pad-to-bucket, whose waste scales with the batch.
    Multiples (not powers of two like :func:`seq_bucket`) keep that
    bound flat as totals grow, and the distinct-shape count stays at
    ``~max_total/step + 1`` — below the padded path's seq-buckets x
    batch-buckets product — because totals are capped by the pool's
    batch times the max request length. There is no batch cap: the
    budget is tokens, not rows."""
    n = max(int(n_tokens), 1)
    f = max(int(floor), 1)
    if n <= f:
        return f
    s = max(int(step), 1)
    return ((n + s - 1) // s) * s


def hopeless(now_ms: float, deadline_ms: float,
             est_remaining_ms: float) -> bool:
    """A request is *provably* blown iff its projected completion exceeds
    the deadline STRICTLY — landing exactly on the boundary still counts
    as feasible, so the shed policy must admit it."""
    return now_ms + est_remaining_ms > deadline_ms


class ShedPolicy:
    """Admission-control / drop-shed policy with per-client shed budgets.

    The simulator has always dropped SLO-blown requests (paper §3); the
    live runtime used to record lateness instead. This policy closes the
    gap: callers ask :meth:`decide` whether a *hopeless* request (see
    :func:`hopeless` — uplink EWMA + remaining-stage cost past the
    deadline) should be shed. Two guarantees:

      * never shed a feasible request — ``decide(c, hopeless=False)`` is
        always admit (it only records the decision in the window);
      * per-client shed *budget* — at most ``budget_frac`` of a client's
        last ``window`` admission decisions may be sheds. At the budget
        the request is admitted regardless (must-admit), so a client on a
        degraded link still gets service instead of starving.

    The window counts admission outcomes as they happen: a shed enters
    as True at shed time, an admit as False at admit time
    (:meth:`note_admitted` for feasible requests at ingest; a
    budget-forced admit records inside :meth:`should_shed`). Timeliness
    matters: billing admits at *completion* would starve the budget
    under exactly the queueing overload shedding exists for. A request
    the budget forces through is marked exempt by the caller so later
    checkpoints (deeper stages, batch close) cannot shed it — otherwise
    one request could be billed against the budget at every stage of its
    chain and the per-client shed *rate* would silently exceed the
    budget.

    Thread-safe; shared by every ingest thread, pool driver, and fleet
    front-end so the budget is global per client, and — because it lives
    outside the drivers — its accounting survives replans that tear
    drivers down.
    """

    def __init__(self, *, budget_frac: float = 0.25, window: int = 64):
        self.budget_frac = float(budget_frac)
        self.window = max(int(window), 1)
        self._lock = threading.Lock()
        self._hist: dict[str, deque] = {}      # client -> deque[bool: shed?]
        self.stats = {"shed": 0, "admitted": 0, "budget_admits": 0}

    def shed_frac(self, client: str) -> float:
        """Fraction of the client's recent requests that were shed."""
        with self._lock:
            h = self._hist.get(client)
            return (sum(h) / len(h)) if h else 0.0

    # feasibility predicates live ON the policy so callers have one
    # surface for "is it blown / may I shed it"; the module-level
    # ``hopeless`` stays as an alias for the one-shot form.
    @staticmethod
    def hopeless(now_ms: float, deadline_ms: float,
                 est_remaining_ms: float) -> bool:
        """One-shot requests: see module-level :func:`hopeless`."""
        return hopeless(now_ms, deadline_ms, est_remaining_ms)

    @staticmethod
    def hopeless_decode(now_ms: float, ttft_deadline_ms: float,
                        est_ttft_ms: float, deadline_ms: float,
                        est_tpot_ms: float, tokens_left: int) -> bool:
        """Decode requests are provably blown on EITHER deadline: the
        projected first/next token misses ``ttft_deadline_ms``, or the
        projected last token — first-token time plus ``est_tpot_ms`` per
        remaining token — misses the absolute ``deadline_ms``. Mid-decode
        callers pass ``est_ttft_ms`` as the time to the *next* token and
        ``ttft_deadline_ms = now + tpot budget`` (the per-token deadline
        the stream must keep). Strict comparisons, like :func:`hopeless`:
        landing exactly on a boundary is feasible."""
        if now_ms + est_ttft_ms > ttft_deadline_ms:
            return True
        total = est_ttft_ms + est_tpot_ms * max(int(tokens_left) - 1, 0)
        return now_ms + total > deadline_ms

    def should_shed(self, client: str, charge: int = 1) -> bool:
        """Called ONLY for a provably-blown request. True => shed it
        (recorded). False => the budget is spent, the request must be
        admitted (recorded; the caller marks it exempt from any later
        checkpoint).

        A shed is allowed only if the window INCLUDING this shed stays
        within budget: ``(sheds + charge) / (n + charge) <= budget_frac``.
        The projected form makes the boundary cases exact — 1.0 may shed
        every hopeless request, 0.0 sheds none — with no empty-window
        special case (a client with no admitted history cannot be shed
        unless the budget is total).

        ``charge`` weights the decision by the work being dropped —
        decode requests pass their REMAINING decode length, so shedding
        a 40-tokens-to-go stream spends 40x the budget of a one-shot
        and a client's shed budget bounds dropped *tokens*, not dropped
        request count."""
        charge = max(int(charge), 1)
        with self._lock:
            h = self._hist.get(client)
            if h is None:
                h = self._hist[client] = deque(maxlen=self.window)
            c = min(charge, self.window)
            if (sum(h) + c) / (len(h) + c) > self.budget_frac:
                h.append(False)                    # budget spent: must admit
                self.stats["budget_admits"] += 1
                self.stats["admitted"] += 1
                return False
            h.extend([True] * c)
            self.stats["shed"] += 1
            return True

    def note_admitted(self, client: str, weight: int = 1) -> None:
        """One feasible request admitted at ingest — its window entry
        (what pays the budget down while the system keeps up). Decode
        admissions pass their decode length as ``weight`` so budget
        paydown matches the token-weighted charge on the shed side."""
        with self._lock:
            h = self._hist.get(client)
            if h is None:
                h = self._hist[client] = deque(maxlen=self.window)
            h.extend([False] * min(max(int(weight), 1), self.window))
            self.stats["admitted"] += 1


INTER_HOP_MS = 0.5       # server-internal execute-frame hop allowance


def remaining_cost_ms(stage_costs: list, stage_idx: int, *,
                      hop_ms: float = 0.0) -> float:
    """Estimated time still ahead of a request sitting at ``stage_idx``:
    execution of stages [stage_idx, end), plus THIS stage's own submit
    hop (``hop_ms`` — the measured uplink for stage 0; deeper stages are
    reached by cheap server-internal execute frames, so the caller
    passes a small allowance, not the uplink), plus one internal hop per
    later stage. Charging the uplink once matters: on a slow link a
    per-stage charge would pull every flush deadline to 'now' and
    collapse batching exactly in the network-bound regime."""
    n_later = max(len(stage_costs) - stage_idx - 1, 0)
    return float(sum(stage_costs[stage_idx:])) + hop_ms \
        + INTER_HOP_MS * n_later


def flush_deadline_ms(deadline_ms: float, stage_costs: list,
                      stage_idx: int, now_ms: float, *,
                      hop_ms: float = 0.0) -> float:
    """The latest batch-close time that still meets ``deadline_ms`` given
    the estimated remaining work; never earlier than ``now_ms`` (a late
    request fires immediately rather than scheduling in the past)."""
    t = deadline_ms - remaining_cost_ms(stage_costs, stage_idx,
                                        hop_ms=hop_ms)
    return max(t, now_ms)
