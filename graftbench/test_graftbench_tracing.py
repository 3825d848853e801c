"""CPU tests of the readers of the program's phase spans: each reads a
known answer from a synthetic span list and nothing from a run whose
program records no such span (the parent of the phase spans)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from graftbench import cpu_run, harness  # noqa: E402


def _span(name, dur, **args):
    return {"name": name, "dur_ms": dur, "args": args, "rid": 0,
            "sid": 0, "parent": None, "t0_ms": 0.0}


# the spans a parent commit records: none of the phase spans, and
# ``exec`` spans without ``cpu_ms``
OLD = [_span("ingest", 5.0), _span("exec", 2.0, rids=[0], n_batch=1),
       _span("decode/step", 3.0), _span("decode/admit", 4.0)]

CASES = {
    "ingest_wait_ms.frag": (
        [_span("ingest/wait", d) for d in (1.0, 9.0, 4.0)], 4.0),
    "mobile_ms.frag": (
        [_span("ingest/mobile", d) for d in (2.0, 6.0)], 4.0),
    "pool_offcpu_ms.frag": (
        [_span("exec", 10.0, cpu_ms=2.0), _span("exec", 30.0, cpu_ms=8.0)],
        15.0),
    "reply_frame_ms.frag": (
        [_span("frame/encode", 6.0, dir="reply", op="flush"),
         _span("frame/encode", 2.0, dir="reply", op="execute"),
         _span("frame/decode", 1.0, dir="reply", op="flush"),
         _span("frame/encode", 99.0, dir="request", op="flush"),
         _span("frame/decode", 99.0, dir="reply", op="submit")], 5.0),
    "step_wait_ms.decode": (
        [_span("decode/step/tokens", d) for d in (10.0, 20.0)], 15.0),
    "step_arena_ms.decode": (
        [_span("decode/step/kv_out", 2.0), _span("decode/step/kv_out", 4.0),
         _span("decode/step/arena", 1.0), _span("decode/step/arena", 1.0),
         _span("decode/step/tokens", 50.0)], 4.0),
    "admit_kv_ms.decode": (
        [_span("decode/admit/kv_out", d) for d in (30.0, 50.0)], 40.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_its_spans(name):
    spans, want = CASES[name]
    read = harness._metric_reader(name)
    assert read({"spans": OLD + spans}) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_finds_nothing_without_its_spans(name):
    read = harness._metric_reader(name)
    assert read({"spans": OLD}) is None
    assert read({}) is None


def test_every_reader_is_declared_for_its_cell():
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in CASES:
        m = declared[name]
        assert m["source"] == "program_span"
        cell = "qwen3-frag-poisson" if name.endswith(".frag") \
            else "olmoe-chat-closed"
        assert m["workloads"] == [cell]


@pytest.mark.parametrize("workload", ["qwen3-frag-poisson",
                                      "olmoe-chat-closed"])
def test_traced_tiny_run_reads_every_phase_metric(workload):
    out = cpu_run.run(workload, trace=True)
    assert out["correct"]
    suffix = ".frag" if workload.endswith("poisson") else ".decode"
    for name in CASES:
        if name.endswith(suffix):
            assert name in out["metrics"], (name, out["metrics"])
            assert out["metrics"][name]["value"] >= 0.0
