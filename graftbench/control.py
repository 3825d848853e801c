"""Readings for the limits of ``correct``: the program's compared numbers
and the fp8 control's, at a cell's own size and load, on several seeds
in one process (set-up is paid per seed, the import and kernel load
once). Not a benchmark run; used when a cell's limits are set.

    python3 graftbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 20 [--out chiprun_out/control.jsonl]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from graftbench import harness
    if not torch.cuda.is_available():
        print("control readings need the card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False,
                               torch.device("cuda", 0),
                               t_start=time.perf_counter(), control=True)
        row = {"workload": args.workload, "seed": seed,
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": out["control"], "correct": out["correct"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        harness.free(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
