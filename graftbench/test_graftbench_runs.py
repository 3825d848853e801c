"""CPU tests that drive whole runs of the harness at a tiny size: a sound
run is correct and imports no JAX; a run whose timed path is broken
underneath comes out not correct, once for each fault a serving cell
can have (an answer or token altered where it is produced, a decode step
that returns its state unchanged). The look for a chip is skipped; the
rest of the run is the benchmark's own."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from graftbench import cpu_run  # noqa: E402


@pytest.mark.parametrize("workload", ["qwen3-frag-poisson",
                                      "olmoe-chat-closed"])
def test_sound_run_is_correct_and_imports_no_jax(workload):
    proc = subprocess.run(
        [sys.executable, "-m", "graftbench.cpu_run", workload, "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["forbidden"] == []
    # no device number from a CPU run
    assert not any("idle" in k or "roofline" in k or "mfu" in k
                   for k in out["metrics"])


def test_altered_answer_is_not_correct(monkeypatch):
    from repro_torch.serving import executor
    real = executor._packed_forward

    def altered(*a, **k):
        y = real(*a, **k)
        if k.get("head"):
            y = y.clone()
            y[..., 0] += 100.0
        return y
    monkeypatch.setattr(executor, "_packed_forward", altered)
    out = cpu_run.run("qwen3-frag-poisson")
    assert not out["correct"]
    assert out["checks"]["gap_max"]["value"] > \
        out["checks"]["gap_max"]["limit"]


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serving import executor
    real = executor.decode_step

    def altered(params, cfg, cache, tokens):
        logits, cache = real(params, cfg, cache, tokens)
        return torch.roll(logits, 1, dims=-1), cache
    monkeypatch.setattr(executor, "decode_step", altered)
    out = cpu_run.run("olmoe-chat-closed")
    assert not out["correct"]


def test_step_that_keeps_its_state_is_not_correct(monkeypatch):
    from repro_torch.serving import executor
    real = executor.decode_step

    def frozen(params, cfg, cache, tokens):
        scratch = {k: v.clone() for k, v in cache.items()}
        logits, _ = real(params, cfg, scratch, tokens)
        return logits, cache
    monkeypatch.setattr(executor, "decode_step", frozen)
    out = cpu_run.run("olmoe-chat-closed")
    assert not out["correct"]
