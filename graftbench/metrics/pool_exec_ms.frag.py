"""Mean host-clock wall of a pool batch (the pools' ``exec`` spans)."""


def read(ctx):
    ds = [s["dur_ms"] for s in ctx.get("spans", []) if s["name"] == "exec"]
    return sum(ds) / len(ds) if ds else None
