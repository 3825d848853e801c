"""Where an olmoe-1b-7b decode step's host time goes, on one card,
with the step eager and replayed from its CUDA graph.

Builds ``olmoe-chat-closed``'s decode pool as the benchmark does, admits
16 streams of 384-token prompts, and calls ``decode_step_batch`` 20
times on this thread under ``torch.profiler`` with its phase spans on,
first with the pool's model step eager, then replayed from the graph it
captures on its next step. Each phase span is joined to the profiler's
device and runtime events on the clock they share (epoch ns), and the
medians over each mode's steps are printed and written as JSON
(``{"eager": ..., "graph": ...}``, by span name): wall and CPU time,
device busy time, kernels, runtime launches (``cudaGraphLaunch``
counts as one) and operator calls, runtime copies and stream syncs,
and the gaps between kernels; ``wrapper_launches`` is the kernel
wrappers' ``LAUNCHES`` a step. Without a card it runs a 2-layer,
128-wide cut of the model on the CPU (both modes eager), which checks
the script and measures nothing.

    python3 scripts/decode_dispatch_probe.py <out.json>
"""
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from graftbench import harness, traffic  # noqa: E402
from graftbench.weights import make_weights  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.serving.telemetry import Telemetry  # noqa: E402

SEED = 2718281829
cell = harness.load_cell("olmoe-chat-closed")
cfg = harness.port_config(cell["config_file"])
DEV = "cuda" if torch.cuda.is_available() else "cpu"
if DEV == "cpu":
    from repro_torch.config import reduced
    cfg = reduced(cfg, n_layers=2, d_model=128)
params = make_weights(cfg, SEED, DEV)
sched = traffic.build(cell["mix"], SEED, 50, cfg.vocab_size, None)
tel = Telemetry(process="probe", trace=True, max_spans=10 ** 6)
server, ex, tap = harness.build_system(cfg, params, sched, cell["mix"],
                                       DEV, tel)
(handler,) = tap._handlers.values()
inst = handler.__self__.inst
rng = np.random.default_rng(SEED)
for rid in range(16):
    toks = rng.integers(0, cfg.vocab_size, 384, dtype=np.int32)
    r = inst.decode_admit(rid, f"s{rid}", toks, 400, ())
    assert r["admitted"], r


def busy(dev, lo, hi):
    """Union of device intervals clipped to [lo, hi], ms; gaps list."""
    tot, cur_s, cur_e, gaps, last = 0.0, None, None, [], lo
    for s, e, _ in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            gaps.append(s - last)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = cur_e
    if cur_e is not None:
        tot += cur_e - cur_s
        gaps.append(hi - cur_e)
    return tot, gaps


def profile_steps(n: int) -> dict:
    """Five warm steps, then ``n`` under the profiler: -> medians over
    the steps by phase span, and the wrappers' launches a step."""
    for _ in range(5):
        inst.decode_step_batch()
    if DEV == "cuda":
        torch.cuda.synchronize()
    tel.spans.clear()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            m = tel.begin()
            inst.decode_step_batch(span=(0, m.sid))
            tel.end(m, "decode/step", "pool", rid=0)
        if DEV == "cuda":
            torch.cuda.synchronize()
    after = launch_counts()
    cuda = torch.autograd.DeviceType.CUDA
    dev, rt = [], []
    for ev in prof.profiler.kineto_results.events():
        d = ev.duration_ns()
        if d <= 0:
            continue
        row = (ev.start_ns() / 1e6, (ev.start_ns() + d) / 1e6, ev.name())
        (dev if ev.device_type() == cuda else rt).append(row)
    dev.sort()
    by: dict = {}
    for s in tel.spans:
        by.setdefault(s["name"], []).append(s)
    out = {}
    for name, ss in sorted(by.items()):
        rows = []
        for s in ss:
            lo, hi = s["t0_ms"], s["t0_ms"] + s["dur_ms"]
            b, gaps = busy(dev, lo, hi)
            calls = [r for r in rt if lo <= r[0] < hi]
            launch = [r for r in calls if "Launch" in r[2]]
            syncs = [r for r in calls if "Synchronize" in r[2]
                     or r[2].startswith("cudaMemcpy")]
            rows.append({
                "wall": s["dur_ms"], "cpu": s["args"].get("cpu_ms"),
                "device_busy": b,
                "kernels": sum(1 for d in dev if lo <= d[0] < hi),
                "launches": len(launch),
                "aten_ops": sum(1 for r in calls
                                if r[2].startswith("aten::")),
                "launch_ms": sum(r[1] - r[0] for r in launch),
                "sync_calls": len(syncs),
                "sync_ms": sum(r[1] - r[0] for r in syncs),
                "sync_names": sorted({r[2] for r in syncs}),
                "gaps": len(gaps), "gap_max": max(gaps, default=0.0),
                "gap_sum": sum(gaps)})
        agg = {k: statistics.median(r[k] for r in rows)
               for k in rows[0] if k not in ("cpu", "sync_names")}
        agg["cpu"] = statistics.median(r["cpu"] for r in rows) \
            if rows[0]["cpu"] is not None else None
        agg["sync_names"] = sorted({n for r in rows
                                    for n in r["sync_names"]})
        agg["n"] = len(rows)
        out[name] = agg
    out["wrapper_launches"] = {k: (after[k] - before[k]) / n for k in after}
    return out


N = 20
step = inst._step
engages = step.engages
step.engages = False                  # eager first, on the same pool
result = {"eager": profile_steps(N)}
step.engages = engages                # captured on its next step
result["graph"] = profile_steps(N)
result["graph_steps"] = inst.decode_graph_steps
result["graph_fallbacks"] = inst.decode_graph_fallbacks
result["device"] = torch.cuda.get_device_name(0) if DEV == "cuda" else "cpu"
print(json.dumps(result, indent=1))
Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
