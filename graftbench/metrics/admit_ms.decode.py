"""Mean wall of one decode admission: the prompt's prefill into the
paged arena and the batch (the pool's ``decode/admit`` spans)."""


def read(ctx):
    ds = [s["dur_ms"] for s in ctx.get("spans", [])
          if s["name"] == "decode/admit"]
    return sum(ds) / len(ds) if ds else None
