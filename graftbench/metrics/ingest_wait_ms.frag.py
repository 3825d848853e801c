"""Median wait of a one-shot request in the server's ingest queue: from
its submit until one of the ingest threads took it (the server's
``ingest/wait`` spans; every request traced)."""
import statistics


def read(ctx):
    xs = [s["dur_ms"] for s in ctx.get("spans", [])
          if s["name"] == "ingest/wait"]
    return statistics.median(xs) if xs else None
