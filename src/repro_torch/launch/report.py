"""Render dry-run JSONL records into the EXPERIMENTS.md roofline tables.

The port of ``repro/launch/report.py``, for the records of
``repro_torch.launch.dryrun``: the collective columns read the bytes and
count the dry-run's sharded pass recorded (``distributed/spmd.py``); a
record without them (``"collectives": null``: one card) shows ``-``.

  python -m repro_torch.launch.report results/dryrun.jsonl --mesh 1xH100
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1.0:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def load(paths):
    recs = []
    for p in paths:
        with open(p) as f:
            for line in f:
                if line.strip():
                    recs.append(json.loads(line))
    # last record wins per (arch, shape, mesh)
    dedup = {}
    for r in recs:
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return list(dedup.values())


def roofline_table(recs, mesh="16x16") -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "MODEL/HLO flops | temp/dev GiB |",
            "|---|---|---|---|---|---|---|---|"]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted((r for r in recs if r["mesh"] == mesh and r.get("ok")),
                    key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        ro = r["roofline"]
        coll = "-" if r.get("collectives") is None \
            else _fmt_s(ro["collective_s"])
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(ro['compute_s'])} | "
            f"{_fmt_s(ro['memory_s'])} | {coll} | "
            f"**{ro['dominant']}** | {ro['useful_ratio']:.2f} | "
            f"{r['memory']['temp_bytes'] / 2**30:.1f} |")
    return "\n".join(rows)


def compile_table(recs) -> str:
    rows = ["| arch | shape | mesh | ok | compile_s | args/dev GiB | "
            "coll GiB | #collectives |",
            "|---|---|---|---|---|---|---|---|"]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted(recs, key=lambda r: (r["arch"], order.get(r["shape"], 9),
                                         r["mesh"])):
        if r.get("ok"):
            c = r.get("collectives")
            coll = ("- | -" if c is None else
                    f"{c['bytes'] / 2**30:.1f} | {c['count']}")
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | yes | "
                f"{r['compile_s']} | "
                f"{r['memory']['argument_bytes'] / 2**30:.2f} | "
                f"{coll} |")
        else:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"**NO** | {r['compile_s']} | - | - | {r['error']} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--kind", choices=("roofline", "compile"),
                    default="roofline")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    recs = load(args.inputs)
    if args.kind == "roofline":
        print(roofline_table(recs, mesh=args.mesh))
    else:
        print(compile_table(recs))


if __name__ == "__main__":
    main()
