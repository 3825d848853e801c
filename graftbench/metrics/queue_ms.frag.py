"""Median wait of a one-shot request in its pool's batcher before its
batch ran: the server's ``queue`` spans (every request traced)."""
import statistics


def read(ctx):
    qs = [s["dur_ms"] for s in ctx.get("spans", []) if s["name"] == "queue"]
    return statistics.median(qs) if qs else None
