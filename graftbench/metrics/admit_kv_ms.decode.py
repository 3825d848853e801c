"""Mean host time of an admission's KV trip: the prompt's K/V copied
from the solo prefill to the host and written into the paged arena (the
pool's ``decode/admit/kv_out`` spans)."""


def read(ctx):
    ds = [s["dur_ms"] for s in ctx.get("spans", [])
          if s["name"] == "decode/admit/kv_out"]
    return sum(ds) / len(ds) if ds else None
