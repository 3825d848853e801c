"""Mean residual device wait of a decode step: once the host has
enqueued the whole step, the time until its argmax tokens reach the
host (the pool's ``decode/step/tokens`` spans). It reads the device
work left over when the enqueue ends, so a faster enqueue of the same
kernels raises it: read it beside ``decode_step_ms``."""


def read(ctx):
    ds = [s["dur_ms"] for s in ctx.get("spans", [])
          if s["name"] == "decode/step/tokens"]
    return sum(ds) / len(ds) if ds else None
