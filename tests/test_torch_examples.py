"""The example twins (``examples/*_torch.py``) against the JAX examples,
on the CPU.

Each pair runs in this process through ``runpy`` with a patched
``sys.argv``, the twin with ``--device cpu``, and their printed lines
are compared. The planner's profiles divide by the rates of the card
each package targets (the H100's in the port, a TPU v5e's in the
reference), so the tests that compare planning or simulated lines run
the twin on the reference's rates (``reference_rates``), as
``test_torch_baselines.py`` shares one book. What is compared:

  * realign_demo: every line;
  * quickstart: the resource, saving and plan lines; each served
    request's largest error against the monolithic forward within the
    serving tolerance's atol (5e-5), in both packages;
  * serve_cluster: every line (REPLAN lines, served count, simulated
    latency);
  * online_serving (simulator): every line but the replan wall time;
    the real transports (``inprocess`` waves, ``--loop``) print their
    numerics line;
  * longcontext: each arch's decode-state bytes, every line.
"""
import os
import re
import runpy
import sys

import numpy as np
import pytest

from repro.core import costmodel as jcost
from repro_torch.core import costmodel, paper_models, profiles

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SERVE_ATOL = 5e-5          # serving/smoke.py::check_against_monolithic


@pytest.fixture
def run(capsys, monkeypatch):
    """run(script, *argv) -> its stdout lines."""
    def go(script, *argv):
        monkeypatch.setattr(sys, "argv", [script, *argv])
        try:
            runpy.run_path(os.path.join(EXAMPLES, script),
                           run_name="__main__")
        except SystemExit as e:
            assert e.code in (0, None), f"{script} exited {e.code}"
        return capsys.readouterr().out.splitlines()
    return go


@pytest.fixture
def reference_rates(monkeypatch):
    """The port's planner profiles at the JAX package's rates."""
    monkeypatch.setattr(profiles, "PEAK_FLOPS", jcost.PEAK_FLOPS)
    monkeypatch.setattr(profiles, "HBM_BW", jcost.HBM_BW)
    monkeypatch.setattr(paper_models, "CF",
                        jcost.PEAK_FLOPS * costmodel.COMPUTE_EFF)
    monkeypatch.setattr(paper_models, "CM",
                        jcost.HBM_BW * costmodel.MEMORY_EFF)


def test_realign_demo_twin_prints_every_reference_line(run,
                                                       reference_rates):
    want = run("realign_demo.py")
    got = run("realign_demo_torch.py", "--device", "cpu")
    assert got == want
    assert any(line.startswith("Graft total") for line in got)


_ERR = re.compile(r"  (\S+): served logits \(?(\d+), (\d+)\)?, "
                  r"\|err vs monolithic\| = (\S+)")


def test_quickstart_twin_plans_and_serves_as_the_reference(
        run, reference_rates):
    want = run("quickstart.py")
    got = run("quickstart_torch.py", "--device", "cpu")
    head = [line for line in want if not _ERR.match(line)]
    assert [line for line in got if not _ERR.match(line)] == head
    assert head[2].startswith("saving")
    errs = {}
    for lines in (want, got):
        for line in lines:
            m = _ERR.match(line)
            if m:
                errs.setdefault(m.group(1), []).append(
                    (int(m.group(2)), int(m.group(3)), float(m.group(4))))
    assert len(errs) == 3
    for client, ((s0, v0, e0), (s1, v1, e1)) in errs.items():
        assert (s0, v0) == (s1, v1) == (16, 512), client
        for e in (e0, e1):
            assert e <= SERVE_ATOL, (client, e)


def test_serve_cluster_twin_replans_as_the_reference(run, reference_rates):
    argv = ("--seconds", "8", "--clients", "4")
    want = run("serve_cluster.py", *argv)
    got = run("serve_cluster_torch.py", *argv, "--device", "cpu")
    assert got == want
    assert sum("REPLAN" in line for line in got) >= 1
    assert any(line.startswith("served ") for line in got)


_REPLAN_MS = re.compile(r"\s+[\d.]+ ms   \(")


def test_online_serving_twin_simulates_as_the_reference(run,
                                                        reference_rates):
    argv = ("--seconds", "6")
    want = run("online_serving.py", *argv)
    got = run("online_serving_torch.py", *argv)
    strip = lambda lines: [_REPLAN_MS.sub(" (", line)  # noqa: E731
                           for line in lines]
    assert strip(got) == strip(want)
    modes = [line.split()[0] for line in got if " replans, " in line]
    assert modes == ["controller", "scratch"]


def test_online_serving_twin_real_transports_check_numerics(run):
    got = run("online_serving_torch.py", "--transport", "inprocess",
              "--waves", "2", "--clients", "2", "--device", "cpu")
    assert got[-1] == \
        "numerics matched the monolithic forward pass on every wave"
    assert sum(line.startswith("wave ") for line in got) == 2
    got = run("online_serving_torch.py", "--transport", "inprocess",
              "--loop", "--seconds", "2", "--clients", "2",
              "--rate", "4", "--device", "cpu")
    m = [re.search(r"numerics matched monolithic forward on all (\d+) "
                   r"checked", line) for line in got]
    assert any(x and int(x.group(1)) > 0 for x in m), got[-3:]


def test_longcontext_twin_prints_the_reference_state_bytes(run):
    want = run("longcontext.py", "--steps", "8")
    got = run("longcontext_torch.py", "--steps", "8", "--device", "cpu")
    assert got == want
    sizes = [float(re.search(r"ctx:\s+([\d.]+) KiB", line).group(1))
             for line in got if "decode state" in line]
    assert len(sizes) == 3 and np.all(np.asarray(sizes) > 0)
