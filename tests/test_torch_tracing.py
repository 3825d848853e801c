"""The port's phase spans, on the CPU: a traced one-shot request and a
traced decode stream through ``GraftServer`` over the loopback
transport record every phase span with its request id, span id and
parent; children lie inside their parents; the ingest phases add up;
the spans share ``torch.profiler``'s clock; and with ``NULL`` telemetry
no span site reads a clock.
"""
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from repro_torch.core import Fragment, GraftPlanner
from repro_torch.serving import (GraftExecutor, GraftServer,
                                 InProcessTransport, ServeRequest)
from repro_torch.serving import smoke as tsmoke
from repro_torch.serving.telemetry import NULL, Telemetry
from repro_torch.serving.transport import SocketTransport

ARCH = "qwen3-1.7b"
TOL_MS = 1.0

# phase span -> the span it is a child of (None: a top-level span)
PHASES = {
    "ingest": None, "ingest/wait": "ingest", "ingest/mobile": "ingest",
    "exec": None, "frame/encode": None, "frame/decode": None,
    "decode/admit": None, "decode/admit/prefill": "decode/admit",
    "decode/admit/kv_out": "decode/admit",
    "decode/step": None, "decode/step/prep": "decode/step",
    "decode/step/forward": "decode/step",
    "decode/step/tokens": "decode/step",
    "decode/step/kv_out": "decode/step",
    "decode/step/arena": "decode/step",
}


def _oneshot_executor(cfg, book, params, tel):
    frags = [Fragment(cfg.name, p=1, t=4000.0, q=10.0, client="c0"),
             Fragment(cfg.name, p=0, t=4000.0, q=10.0, client="c1")]
    ex = GraftExecutor(GraftPlanner(book).plan(frags), params, cfg,
                       InProcessTransport(), telemetry=tel, device="cpu")
    return ex, frags


def _decode_executor(cfg, book, params, tel):
    frags = tsmoke.smoke_fragments(cfg, 2, rate=30.0, seed=0)
    ex = GraftExecutor(tsmoke.decode_plan(cfg, book, frags, batch=2),
                       params, cfg, InProcessTransport(), decode_ctx=32,
                       kv_block_tokens=4, telemetry=tel, device="cpu")
    return ex, frags


def _serve(ex, book, reqs):
    """Submit [(request, p)], wait for all; -> the stopped server."""
    server = GraftServer(ex, book=book).start()
    try:
        for req, p in reqs:
            server.submit(req, p, 4000.0)
        assert server.join(timeout=120.0), "the run never drained"
    finally:
        server.stop(drain=False, timeout=10.0)
        ex.close()
    return server


def _requests(cfg, frags, *, decode: bool, seed: int = 0) -> list:
    rng = np.random.RandomState(seed)
    if decode:
        return [(ServeRequest(client=f.client,
                              tokens=rng.randint(0, cfg.vocab_size, 9)
                              .astype(np.int32),
                              max_new_tokens=4, tpot_budget_ms=4000.0), 0)
                for f in frags]
    return [(ServeRequest(client=f.client,
                          tokens=rng.randint(0, cfg.vocab_size, 12)
                          .astype(np.int32)), f.p) for f in frags]


@pytest.fixture(scope="module")
def traced():
    """(cfg, book, params, spans): one traced run of two one-shot
    requests (one with a mobile part) and one of two decode streams."""
    cfg, book, params = tsmoke.smoke_setup(ARCH, seed=0, device="cpu")
    tel = Telemetry(process="test", trace=True)
    ex, frags = _oneshot_executor(cfg, book, params, tel)
    _serve(ex, book, _requests(cfg, frags, decode=False))
    ex, frags = _decode_executor(cfg, book, params, tel)
    _serve(ex, book, _requests(cfg, frags, decode=True, seed=1))
    return cfg, book, params, list(tel.spans)


def _end(s):
    return s["t0_ms"] + s["dur_ms"]


def test_traced_requests_record_every_phase_span(traced):
    *_, spans = traced
    by_sid = {s["sid"]: s for s in spans}
    assert len(by_sid) == len(spans), "span ids repeat"
    seen = defaultdict(int)
    for s in spans:
        seen[s["name"]] += 1
        assert s["rid"] is not None and isinstance(s["sid"], int)
        want = PHASES.get(s["name"])
        if s["name"] in PHASES:
            if want is None:
                assert s["parent"] is None, s
            else:
                parent = by_sid[s["parent"]]
                assert parent["name"] == want and \
                    parent["rid"] == s["rid"], (s, parent)
    assert set(PHASES) <= set(seen), set(PHASES) - set(seen)
    # the step's five phases once a step, the admission's two once each
    for ph in ("prep", "forward", "tokens", "kv_out", "arena"):
        assert seen[f"decode/step/{ph}"] == seen["decode/step"]
    for ph in ("prefill", "kv_out"):
        assert seen[f"decode/admit/{ph}"] == seen["decode/admit"] == 2
    assert seen["ingest/wait"] == seen["ingest"] == 4
    assert seen["ingest/mobile"] == 2


def test_children_lie_inside_their_parents(traced):
    *_, spans = traced
    by_sid = {s["sid"]: s for s in spans}
    kids = [s for s in spans if s["parent"] is not None]
    assert kids
    for s in kids:
        p = by_sid[s["parent"]]
        assert s["t0_ms"] >= p["t0_ms"] - TOL_MS, (s, p)
        assert _end(s) <= _end(p) + TOL_MS, (s, p)


def test_ingest_phases_add_up_to_ingest(traced):
    *_, spans = traced
    parts = defaultdict(float)
    for s in spans:
        if s["name"] in ("ingest/wait", "ingest/mobile"):
            parts[s["parent"]] += s["dur_ms"]
    ingest = [s for s in spans if s["name"] == "ingest"]
    assert len(ingest) == 4
    for s in ingest:
        assert abs(parts[s["sid"]] - s["dur_ms"]) <= TOL_MS, s


def test_phase_args_carry_their_counts(traced):
    *_, spans = traced
    for s in spans:
        a = s["args"]
        if s["name"] in ("exec", "ingest/mobile", "decode/step/forward",
                         "frame/encode", "frame/decode"):
            assert 0.0 <= a["cpu_ms"] <= s["dur_ms"] + TOL_MS, s
        if s["name"] == "exec":
            assert a["real_tokens"] == 12 and a["pad_tokens"] >= 0
        if s["name"] == "ingest/mobile":
            assert a["n_tokens"] == 12
        if s["name"] == "ingest/wait":
            assert a["depth"] >= 0
        if s["name"] == "decode/admit/kv_out":
            assert a["n_tokens"] == 9 and a["d2h_bytes"] > 0
        if s["name"] in ("decode/step/kv_out", "decode/step/arena"):
            assert 1 <= a["rows"] <= 2
        if s["name"].startswith("frame/"):
            assert a["dir"] in ("request", "reply") and a["nbytes"] > 0
            assert a["d2h_bytes"] == 0          # nothing on a device here
    assert sorted(s["args"]["p"] for s in spans
                  if s["name"] == "ingest/mobile") == [0, 1]
    replies = [s for s in spans if s["name"] == "frame/encode"
               and s["args"]["dir"] == "reply"
               and s["args"]["op"] == "flush"]
    assert len(replies) == 2


def test_chrome_export_carries_ids():
    tel = Telemetry(process="t", trace=True)
    outer = tel.begin()
    inner = tel.begin(cpu=True)
    tel.end(inner, "inner", "test", rid=3, parent=outer.sid)
    tel.end(outer, "outer", "test", rid=3)
    ev = {e["name"]: e for e in tel.chrome_trace()["traceEvents"]
          if e["ph"] == "X"}
    assert ev["inner"]["args"]["parent"] == ev["outer"]["args"]["sid"]
    assert ev["outer"]["args"]["parent"] is None
    assert "cpu_ms" in ev["inner"]["args"] and ev["inner"]["args"]["rid"] == 3


def test_spans_share_the_profiler_clock():
    """A span opened and closed inside a ``record_function`` range starts
    inside that range's kineto interval: both stand on the epoch clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tel = Telemetry(process="t", trace=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("graft-probe"):
                m = tel.begin()
                torch.ones(64).sum().item()
                tel.end(m, "probe", "test")
    ranges = sorted((e.start_ns() / 1e6, (e.start_ns() + e.duration_ns())
                     / 1e6) for e in prof.profiler.kineto_results.events()
                    if e.name() == "graft-probe")
    spans = sorted(s["t0_ms"] for s in tel.spans)
    assert len(ranges) == len(spans) == 3
    for (lo, hi), t0 in zip(ranges, spans):
        assert lo - TOL_MS <= t0 <= hi + TOL_MS, (lo, t0, hi)


def test_null_telemetry_reads_no_clock_at_span_sites(traced, monkeypatch):
    """With ``NULL`` telemetry a one-shot flush and a decode step, through
    the server and the loopback frames, never read the span clocks."""
    cfg, book, params, _ = traced
    calls = []

    def boom(name):
        def f():
            calls.append(name)
            raise AssertionError(f"time.{name} read while untraced")
        return f
    monkeypatch.setattr(time, "time_ns", boom("time_ns"))
    monkeypatch.setattr(time, "thread_time_ns", boom("thread_time_ns"))
    ex, frags = _oneshot_executor(cfg, book, params, NULL)
    reqs = _requests(cfg, frags, decode=False)
    _serve(ex, book, reqs)
    ex, frags = _decode_executor(cfg, book, params, NULL)
    dreqs = _requests(cfg, frags, decode=True)
    server = _serve(ex, book, dreqs)
    assert calls == []
    assert all(r.result is not None for r, _ in reqs)
    assert all(len(r.out_tokens) == 4 for r, _ in dreqs)
    assert server.report()["decode_served"] == 2


def test_transfer_stats_keep_request_frames_apart_from_replies(traced):
    """``samples`` and ``total_bytes`` count request frames only (what
    ``wire_mb_per_req.frag`` reads); reply frames are tallied apart."""
    cfg, book, params, _ = traced
    tr = InProcessTransport()
    tr.serve("echo", lambda msg: {"ok": True, "big": np.zeros(1000)})
    ch = tr.connect("echo")
    ch.request({"op": "x", "payload": np.zeros(10)})
    ch.request({"op": "x"})
    assert ch.stats.n_transfers == 2
    req_bytes = ch.stats.total_bytes
    assert req_bytes == sum(n for _, n, _ in ch.stats.samples)
    assert req_bytes < 200 < 8000 < ch.stats.reply_bytes
    # on the serving path too: the one-shot's logits reply is not a sample
    ex, frags = _oneshot_executor(cfg, book, params, None)
    (key,) = [k for k in ex.pool_specs() if k[1] == 1]
    h = ex.handle(key)
    payload = torch.zeros(12, cfg.d_model)
    h.submit(0, "c0", payload)
    before = h.channel.stats.total_bytes
    ((_, y),) = h.flush()
    ex.close()
    st = h.channel.stats
    assert st.total_bytes - before < 100       # the flush request frame
    assert st.reply_bytes > y.numel() * y.element_size()


def test_socket_frames_traced_on_both_ends():
    tel = Telemetry(process="t", trace=True)
    tr = SocketTransport()
    tr.attach(tel)
    try:
        tr.serve("echo", lambda msg: {"ok": True, "n": len(msg["items"])})
        ch = tr.connect("echo")
        ch.attach(tel)
        assert ch.request({"op": "execute", "items": [
            {"req_id": 5}, {"req_id": 7, "trace": True}]})["n"] == 2
        ch.request({"op": "execute", "items": [{"req_id": 9}]})
        st = ch.stats
        assert st.n_transfers == 2 and st.reply_bytes > 0
        ch.close()
    finally:
        tr.close()
    got = sorted((s["name"], s["args"]["dir"]) for s in tel.spans)
    assert got == [("frame/decode", "reply"), ("frame/decode", "request"),
                   ("frame/encode", "reply"), ("frame/encode", "request")]
    assert {s["rid"] for s in tel.spans} == {7}
    assert {s["args"]["op"] for s in tel.spans} == {"execute"}


def test_public_wait_and_token_count(traced):
    cfg, book, params, _ = traced
    ex, frags = _decode_executor(cfg, book, params, None)
    server = GraftServer(ex, book=book).start()
    try:
        mark = server.mark()
        assert not server.wait_done(mark, 0.05)
        (req, _), = _requests(cfg, frags[:1], decode=True)
        rid = server.submit(req, 0, 4000.0)
        seen = 0
        deadline = time.monotonic() + 120.0
        while not server.wait_done(mark, 0.01):
            seen = max(seen, server.emitted(rid))
            assert time.monotonic() < deadline
        assert server.wait_done(mark, 0.0)
        assert server.emitted(rid) == 0     # off the books once complete
        assert 0 <= seen <= 4 and len(req.out_tokens) == 4
    finally:
        server.stop(drain=False, timeout=10.0)
        ex.close()


def test_queue_histogram_counts_untraced_items(traced):
    cfg, book, params, _ = traced
    tel = Telemetry(process="t", trace=False)
    ex, frags = _oneshot_executor(cfg, book, params, tel)
    _serve(ex, book, _requests(cfg, frags, decode=False))
    assert tel.histogram("server/queue_ms").count() == 2
    assert not tel.spans
