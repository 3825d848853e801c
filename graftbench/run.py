"""Run one cell of BENCHMARK.json once and print its result.

    python3 graftbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; ``checks`` comes last and holds
every number compared beside its limit, which also end standard error.
The run needs as many CUDA cards as the cell asks for and refuses to
print a result without them, or when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` has been imported by the time the window has
closed.

``--rate`` (open-loop cells) overrides the mix's total rate: the knee
sweep. It is not part of a benchmark run.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)

    import torch
    from graftbench import harness
    harness.log(f"[graftbench] set-up: torch imported at "
                f"{time.perf_counter() - T_START:.3f} s")
    cell = harness.load_cell(args.workload, ROOT)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"[graftbench] {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.init()
    harness.log(f"[graftbench] set-up: CUDA context at "
                f"{time.perf_counter() - T_START:.3f} s")
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start=T_START,
                           rate_rps=args.rate)
    bad = forbidden_modules()
    if bad:
        print(f"[graftbench] refused: the process imported {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
