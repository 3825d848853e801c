"""Mean host-clock wall of one decode step of the pool's continuous
batch (the pool's ``decode/step`` spans)."""


def read(ctx):
    ds = [s["dur_ms"] for s in ctx.get("spans", [])
          if s["name"] == "decode/step"]
    return sum(ds) / len(ds) if ds else None
