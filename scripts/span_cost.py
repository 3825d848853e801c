"""What the phase spans cost on the host, per span and per gated site.

Times, on this process's CPU and with ``time.perf_counter``, the median
of several rounds of:

  * a traced span opened and closed on one thread
    (``Telemetry.begin`` / ``end``), with and without the thread's CPU
    time;
  * a traced span recorded whole (``Telemetry.span``);
  * a gated site left untraced: the check of a pre-bound boolean that
    every span site makes before it reads a clock, against an empty
    loop;
  * a small frame's round trip through a loopback channel, untraced and
    traced (four frame spans).

  python scripts/span_cost.py [--n 200000]
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def per_call_ns(fn, n: int, rounds: int = 5) -> float:
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        fn(n)
        out.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    a = ap.parse_args(argv)
    import numpy as np

    from repro_torch.serving.telemetry import NULL, Telemetry
    from repro_torch.serving.transport import InProcessTransport
    n = a.n
    tel = Telemetry(process="cost", trace=True, max_spans=1024)

    def begin_end(k, cpu):
        for _ in range(k):
            m = tel.begin(cpu=cpu)
            tel.end(m, "decode/step/tokens", "pool", rid=1, tid="pool",
                    parent=7)

    def whole(k):
        for _ in range(k):
            tel.span("ingest/wait", "server", 1.0, t0_ms=0.0, rid=1,
                     tid="srv", args={"depth": 0}, parent=7)

    tracing = NULL.tracing
    span = None

    def gated(k):
        for _ in range(k):
            if tracing:
                pass
            if span is not None:
                pass

    def empty(k):
        for _ in range(k):
            pass

    rows = {
        "traced span, begin/end": per_call_ns(
            lambda k: begin_end(k, False), n),
        "traced span, begin/end with cpu_ms": per_call_ns(
            lambda k: begin_end(k, True), n),
        "traced span, span()": per_call_ns(whole, n),
        "two gated sites, NULL (minus empty loop)":
            per_call_ns(gated, 10 * n) - per_call_ns(empty, 10 * n),
    }
    tr = InProcessTransport()
    tr.serve("echo", lambda msg: {"ok": True, "x": msg["x"]})
    plain = tr.connect("echo")
    traced = tr.connect("echo")
    traced.attach(tel)
    msg = {"op": "flush", "x": np.zeros(16, np.float32)}
    tmsg = dict(msg, trace=True, req_id=1)
    rows["loopback round trip, untraced"] = per_call_ns(
        lambda k: [plain.request(msg) for _ in range(k)], n // 10)
    rows["loopback round trip, traced (4 frame spans)"] = per_call_ns(
        lambda k: [traced.request(tmsg) for _ in range(k)], n // 10)
    for k, v in rows.items():
        print(f"{k:48s} {v:10.1f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
