"""The control at a size a test run can hold: the reference computed in
fp8, put in the program's place, comes out not correct under each
cell's limits, while the program's own run at the same size is
correct. (At the cells' own size the control runs on the card:
``control.py``.)

The limits are in logit units. The tiny model's embedding is drawn at
0.04, twice the full models' 0.02, so that its tied head's logits
spread as a 2048-wide model's do (0.02 x sqrt(2048) = 0.04 x
sqrt(512))."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from graftbench import check, cpu_run, weights  # noqa: E402


@pytest.mark.parametrize("workload", ["qwen3-frag-poisson",
                                      "olmoe-chat-closed"])
def test_control_fails_the_limits_the_program_meets(workload,
                                                    monkeypatch):
    full_width = weights._std
    monkeypatch.setattr(weights, "_std", lambda name, shape: 0.04
                        if name == "embed" else full_width(name, shape))
    out = cpu_run.run(workload, control=True)
    limits = cpu_run.tiny_cell(workload)["limits"]
    assert out["correct"], out["checks"]
    ok, shown = check.judge(out["control"], limits, 0)
    assert not ok, shown
