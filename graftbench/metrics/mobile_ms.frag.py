"""Median wall of one request's mobile part, blocks [0, p), run on an
ingest thread (the server's ``ingest/mobile`` spans)."""
import statistics


def read(ctx):
    xs = [s["dur_ms"] for s in ctx.get("spans", [])
          if s["name"] == "ingest/mobile"]
    return statistics.median(xs) if xs else None
