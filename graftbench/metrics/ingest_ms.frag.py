"""Median time from a one-shot request's submit to its payload leaving
the mobile part: the wait in the server's single ingest queue plus the
mobile blocks [0, p) run there, before any pool batcher sees it (the
server's ``ingest`` spans; every request traced)."""
import statistics


def read(ctx):
    xs = [s["dur_ms"] for s in ctx.get("spans", []) if s["name"] == "ingest"]
    return statistics.median(xs) if xs else None
