"""Telemetry — mergeable metrics, request tracing, and the replan audit.

Graft's SLO story rests on live measurement, so the observability layer
has to satisfy three constraints at once:

  * **Exact merge.** The same metric is incremented on front-end ingest
    threads, pool-driver threads, and worker *subprocesses*. Counters
    and histograms therefore carry no approximate state: a histogram is
    a map of fixed geometric-bucket index -> count, and merging two
    histograms is integer addition per bucket — ``merge(a, b)`` yields
    bit-identical quantile estimates to recording the concatenated
    sample stream into one histogram. Worker-side registries ride back
    on the existing pool ``stats`` op as :meth:`Telemetry.snapshot`
    dicts and fold in via :meth:`Telemetry.merge_snapshot`.

  * **Cheap enough to leave on.** Counters and histograms write to
    per-thread cells — no lock is taken on the increment path, only on
    first touch by a new thread. Disabled telemetry is the shared
    :data:`NULL` registry whose instruments are no-op singletons, so an
    un-instrumented run pays one dead method call per site. Spans are
    *sampled* per request id (deterministic hash, so every hop of one
    request agrees on the decision without coordination).

  * **Cross-process timelines.** A span's start ``t0_ms`` is epoch
    milliseconds stamped from ``time.time_ns`` when the span starts:
    the clock subprocesses share, and the one ``torch.profiler`` stamps
    its CPU and CUDA events with, so program spans and a device trace
    line up. Durations are measured on ``time.perf_counter`` (or the
    server's own clock). Each span has an id (``sid``) unique in its
    registry and the ``parent`` id of the span that encloses it, so
    self time is a span's duration minus its children's. Export is
    Chrome trace-event JSON (``ph: "X"`` complete events + ``M`` name
    metadata) or JSONL.

The replan audit rides here too: :class:`ServingController` appends one
:func:`audit_entry` per replan (trigger names, the window stats that
fired them, the ``PlanDiff`` summary) and the server stamps apply
latency onto it after the writer-lock transition completes.
"""
from __future__ import annotations

import itertools
import json
import math
import threading
import time
from collections import deque
from typing import Optional
from zlib import crc32

__all__ = [
    "Counter", "Gauge", "Histogram", "Telemetry", "NULL",
    "GROWTH", "ZERO_IDX", "bucket_index", "bucket_value", "Mark",
]

# Geometric bucket layout shared by every histogram in the system —
# merging requires identical edges, so the growth factor is a module
# constant, not a knob. 2**(1/8) per bucket => a bucket's midpoint is
# within ~4.4% of any sample it holds; p50/p99 read from merged buckets
# are exact to that resolution.
GROWTH = 2.0 ** 0.125
_LOG_GROWTH = math.log(GROWTH)
ZERO_IDX = -(1 << 30)          # bucket for samples <= 0 (reported as 0.0)


def bucket_index(v: float) -> int:
    if v <= 0.0:
        return ZERO_IDX
    return math.floor(math.log(v) / _LOG_GROWTH)


def bucket_value(idx: int) -> float:
    """Representative value for a bucket: its geometric midpoint."""
    if idx == ZERO_IDX:
        return 0.0
    return GROWTH ** (idx + 0.5)


class Counter:
    """Monotonic counter with per-thread cells.

    ``inc`` touches only this thread's cell (a one-element list), so
    concurrent increments never contend and never lose counts; the lock
    guards only cell *creation*. Cells are kept in a list (not keyed by
    thread id — ids are reused after a thread dies, which would silently
    drop a dead thread's tally).
    """

    __slots__ = ("name", "_cells", "_local", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._cells: list = []
        self._local = threading.local()
        self._lock = threading.Lock()

    def _cell(self) -> list:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0.0]
            with self._lock:
                self._cells.append(cell)
            self._local.cell = cell
        return cell

    def inc(self, n: float = 1.0) -> None:
        self._cell()[0] += n

    def value(self) -> float:
        return sum(c[0] for c in list(self._cells))


class Gauge:
    """Last-write-wins scalar (block utilisation, beacon age, ...)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def value(self) -> float:
        return self._v


class Histogram:
    """Streaming histogram over the fixed geometric buckets.

    Per-thread cells like :class:`Counter`; each cell holds a bucket
    map plus exact count/sum/min/max. ``merge_state`` is plain per-index
    addition, so fleet-wide quantiles from merged buckets equal the
    quantiles of one histogram fed every sample.
    """

    __slots__ = ("name", "_cells", "_local", "_lock", "_sources")

    def __init__(self, name: str):
        self.name = name
        self._cells: list = []
        self._local = threading.local()
        self._lock = threading.Lock()
        # source-key -> full bucket state, replaced wholesale on every
        # poll of that source: re-polling a worker stays idempotent no
        # matter which thread (beacon, final dump) does the polling.
        self._sources: dict = {}

    def _cell(self) -> dict:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = {"b": {}, "n": 0, "s": 0.0,
                    "mn": math.inf, "mx": -math.inf}
            with self._lock:
                self._cells.append(cell)
            self._local.cell = cell
        return cell

    def set_source_state(self, source: str, state: dict) -> None:
        """Adopt a remote source's running state (last write wins per
        source — the remote keeps the running total)."""
        with self._lock:
            self._sources[source] = {
                "buckets": {int(k): v for k, v in state["buckets"].items()},
                "count": state["count"], "sum": state["sum"],
                "min": state["min"], "max": state["max"]}

    def record(self, v: float) -> None:
        cell = self._cell()
        idx = bucket_index(v)
        b = cell["b"]
        b[idx] = b.get(idx, 0) + 1
        cell["n"] += 1
        cell["s"] += v
        if v < cell["mn"]:
            cell["mn"] = v
        if v > cell["mx"]:
            cell["mx"] = v

    # ------------------------------------------------------- state / merge
    def state(self) -> dict:
        """Merged view over the thread cells: the wire/merge format."""
        out = {"buckets": {}, "count": 0, "sum": 0.0,
               "min": math.inf, "max": -math.inf}
        for cell in list(self._cells):
            Histogram.merge_state(out, {
                "buckets": dict(cell["b"]), "count": cell["n"],
                "sum": cell["s"], "min": cell["mn"], "max": cell["mx"]})
        with self._lock:
            sources = [dict(s, buckets=dict(s["buckets"]))
                       for s in self._sources.values()]
        for st in sources:
            Histogram.merge_state(out, st)
        return out

    @staticmethod
    def merge_state(into: dict, other: dict) -> dict:
        b = into["buckets"]
        for idx, n in other["buckets"].items():
            idx = int(idx)          # JSON round-trips keys as strings
            b[idx] = b.get(idx, 0) + n
        into["count"] += other["count"]
        into["sum"] += other["sum"]
        into["min"] = min(into["min"], other["min"])
        into["max"] = max(into["max"], other["max"])
        return into

    @staticmethod
    def quantile_of(state: dict, q: float) -> float:
        """Nearest-rank quantile from a bucket state. Exact values are
        substituted at the extremes (q=0 -> min, q=1 -> max)."""
        n = state["count"]
        if n == 0:
            return 0.0
        if q <= 0.0:
            return state["min"]
        if q >= 1.0:
            return state["max"]
        target = q * (n - 1)
        cum = 0
        for idx in sorted(state["buckets"]):
            cum += state["buckets"][idx]
            if cum > target:
                return bucket_value(idx)
        return state["max"]

    def quantile(self, q: float) -> float:
        return Histogram.quantile_of(self.state(), q)

    def count(self) -> int:
        return self.state()["count"]

    @staticmethod
    def summary_of(state: dict) -> dict:
        n = state["count"]
        return {
            "count": n,
            "sum": state["sum"],
            "min": state["min"] if n else 0.0,
            "max": state["max"] if n else 0.0,
            "mean": (state["sum"] / n) if n else 0.0,
            "p50": Histogram.quantile_of(state, 0.50),
            "p90": Histogram.quantile_of(state, 0.90),
            "p99": Histogram.quantile_of(state, 0.99),
        }


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for disabled telemetry."""

    __slots__ = ()
    name = "null"

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def value(self) -> float:
        return 0.0

    def quantile(self, q: float) -> float:
        return 0.0

    def count(self) -> int:
        return 0

    def state(self) -> dict:
        return {"buckets": {}, "count": 0, "sum": 0.0,
                "min": math.inf, "max": -math.inf}


_NULL_INSTRUMENT = _NullInstrument()


class Mark:
    """An open span (:meth:`Telemetry.begin`): its id, its start on the
    epoch clock (ns) and on ``perf_counter`` (s), and the thread's CPU
    time at the start (ns; None when not asked for)."""

    __slots__ = ("sid", "t0_ns", "p0", "cpu0")

    def __init__(self, sid: int, t0_ns: int, p0: float, cpu0):
        self.sid, self.t0_ns, self.p0, self.cpu0 = sid, t0_ns, p0, cpu0


class Telemetry:
    """Named registry of instruments + the span/audit stores.

    One Telemetry is shared by everything in a process that should merge
    for free (all fleet front-ends share one); subprocess registries
    merge explicitly via :meth:`snapshot` / :meth:`merge_snapshot`.

    ``tracing`` is the pre-bound verdict instrumented code checks before
    it stamps a clock for a span: False on :data:`NULL` and on a
    registry built without ``trace``, so an untraced hot path pays one
    attribute test and no clock read.
    """

    enabled = True

    def __init__(self, *, process: str = "main", trace: bool = False,
                 trace_sample: float = 1.0, max_spans: int = 65_536):
        self.process = process
        self.tracing = bool(trace)
        self._sample = float(trace_sample)
        self._sids = itertools.count(1)
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        self.spans: deque = deque(maxlen=max_spans)
        self.audit: list = []

    # -------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name))
        return h

    # -------------------------------------------------------------- spans
    def want_trace(self, rid) -> bool:
        """Deterministic per-request sampling decision: every hop (any
        thread, any process) hashes the rid to the same verdict, so a
        sampled request is traced end to end without coordination."""
        if not self.tracing:
            return False
        if self._sample >= 1.0:
            return True
        return (crc32(str(rid).encode()) & 0xFFFF) / 65536.0 < self._sample

    def new_sid(self) -> int:
        """A span id unique in this registry: taken before a span's
        children close, so they can name it as their ``parent``."""
        return next(self._sids)

    def span(self, name: str, cat: str, dur_ms: float, *, t0_ms: float,
             rid=None, tid: str = "main", args: Optional[dict] = None,
             sid: Optional[int] = None,
             parent: Optional[int] = None) -> None:
        """Record one *completed* span. ``t0_ms`` is
        its start in epoch ms, stamped from ``time.time_ns`` when the
        span started (:meth:`begin` does both ends for a span that opens
        and closes on one thread). Ids are unique per registry; spans
        merged from a worker keep their own, so across processes a span
        is ``(pid, sid)``. Callers gate on :meth:`want_trace` — span()
        itself never drops."""
        if sid is None:
            sid = next(self._sids)
        self.spans.append({
            "name": name, "cat": cat, "t0_ms": t0_ms,
            "dur_ms": max(dur_ms, 0.0), "rid": rid,
            "pid": self.process, "tid": tid, "args": args or {},
            "sid": sid, "parent": parent})

    def begin(self, *, cpu: bool = False) -> Mark:
        """Open a span here: take its id and stamp its start (and the
        thread's CPU time when ``cpu``). Close it with :meth:`end`."""
        return Mark(next(self._sids), time.time_ns(), time.perf_counter(),
                    time.thread_time_ns() if cpu else None)

    def end(self, mark: Mark, name: str, cat: str, *, rid=None,
            tid: str = "main", args: Optional[dict] = None,
            parent: Optional[int] = None) -> None:
        """Close the span ``mark`` opened: its duration on
        ``perf_counter``, and ``args["cpu_ms"]``, the thread's CPU time
        across it, when the mark stamped one."""
        # the CPU interval is read inside the wall one, so cpu <= wall
        if mark.cpu0 is not None:
            args = dict(args or {},
                        cpu_ms=(time.thread_time_ns() - mark.cpu0) / 1e6)
        dur = (time.perf_counter() - mark.p0) * 1e3
        self.span(name, cat, dur, t0_ms=mark.t0_ns / 1e6, rid=rid, tid=tid,
                  args=args, sid=mark.sid, parent=parent)

    # ------------------------------------------------------ merge / export
    def snapshot(self, *, drain_spans: bool = False) -> dict:
        """Wire-format state for cross-process merge (rides the pool
        ``stats`` op). Span drain hands ownership to the parent so a
        beacon-polled worker never re-sends the same span."""
        snap = {
            "process": self.process,
            "counters": {n: c.value() for n, c in list(self._counters.items())},
            "gauges": {n: g.value() for n, g in list(self._gauges.items())},
            "histograms": {n: h.state() for n, h in list(self._hists.items())},
        }
        if drain_spans:
            out = []
            while True:
                try:
                    out.append(self.spans.popleft())
                except IndexError:
                    break
            snap["spans"] = out
        return snap

    def merge_snapshot(self, snap: dict, *, source: str = "",
                       prefix: str = "") -> None:
        """Fold a subprocess snapshot into this registry, idempotently:
        the remote keeps running totals, so counters become per-source
        gauges (``prefix`` namespaces them) and histograms adopt the
        source's state wholesale (keyed by ``source``) — re-polling the
        same worker never double counts, from any thread."""
        source = source or snap.get("process", "remote")
        for n, v in snap.get("counters", {}).items():
            self.gauge(prefix + n).set(v)
        for n, v in snap.get("gauges", {}).items():
            self.gauge(prefix + n).set(v)
        for n, st in snap.get("histograms", {}).items():
            self.histogram(n).set_source_state(source, st)
        for sp in snap.get("spans", []) or []:
            self.spans.append(sp)

    def metrics_dump(self) -> dict:
        """JSON-serialisable dump of every instrument + the audit log."""
        hists = {}
        for n, h in list(self._hists.items()):
            st = h.state()
            s = Histogram.summary_of(st)
            s["buckets"] = {str(k): v for k, v in st["buckets"].items()}
            if not math.isfinite(s["min"]):
                s["min"] = 0.0
            if not math.isfinite(s["max"]):
                s["max"] = 0.0
            hists[n] = s
        return {
            "process": self.process,
            "counters": {n: c.value() for n, c in list(self._counters.items())},
            "gauges": {n: g.value() for n, g in list(self._gauges.items())},
            "histograms": hists,
            "audit": list(self.audit),
        }

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (object format) — loads in Perfetto
        / chrome://tracing. Process/thread labels become numeric ids
        plus ``M`` metadata naming events."""
        pids: dict = {}
        tids: dict = {}
        events = []
        for sp in list(self.spans):
            pid = pids.setdefault(sp["pid"], len(pids) + 1)
            tid = tids.setdefault((sp["pid"], sp["tid"]), len(tids) + 1)
            args = dict(sp.get("args") or {})
            if sp.get("rid") is not None:
                args["rid"] = sp["rid"]
            args["sid"] = sp.get("sid")
            args["parent"] = sp.get("parent")
            events.append({
                "name": sp["name"], "cat": sp["cat"], "ph": "X",
                "ts": sp["t0_ms"] * 1e3, "dur": sp["dur_ms"] * 1e3,
                "pid": pid, "tid": tid, "args": args})
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": label}} for label, pid in pids.items()]
        meta += [{"name": "thread_name", "ph": "M", "pid": pids[p],
                  "tid": tid, "args": {"name": t}}
                 for (p, t), tid in tids.items()]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def write_trace(self, path: str) -> int:
        """Write the trace; ``.jsonl`` suffix selects JSONL (one span
        per line), anything else Chrome trace-event JSON. Returns the
        number of spans written."""
        spans = list(self.spans)
        if str(path).endswith(".jsonl"):
            with open(path, "w") as f:
                for sp in spans:
                    f.write(json.dumps(sp) + "\n")
        else:
            with open(path, "w") as f:
                json.dump(self.chrome_trace(), f)
        return len(spans)

    def write_metrics(self, path: str) -> dict:
        dump = self.metrics_dump()
        with open(path, "w") as f:
            json.dump(dump, f, indent=1)
        return dump


class _NullTelemetry(Telemetry):
    """Shared disabled registry: every instrument is the no-op
    singleton, every record path returns immediately. This is the
    default everywhere — instrumented code pre-binds instruments once,
    so the disabled hot path is a single trivial method call."""

    enabled = False

    def __init__(self):
        super().__init__(process="null", trace=False)

    def counter(self, name: str):
        return _NULL_INSTRUMENT

    def gauge(self, name: str):
        return _NULL_INSTRUMENT

    def histogram(self, name: str):
        return _NULL_INSTRUMENT

    def want_trace(self, rid) -> bool:
        return False

    def span(self, *a, **k) -> None:
        pass

    def merge_snapshot(self, snap: dict, *, source: str = "",
                       prefix: str = "") -> None:
        pass


NULL = _NullTelemetry()


def audit_entry(now_ms: float, triggers: list, window_stats: dict,
                diff_summary: str) -> dict:
    """One replan audit record. ``window_stats`` carries the per-client
    estimator state that fired the triggers; ``apply_ms`` is stamped by
    the server once the writer-lock transition lands."""
    return {
        "t_ms": now_ms,
        "triggers": list(triggers),
        "window": window_stats,
        "diff": diff_summary,
        "apply_ms": None,
    }
