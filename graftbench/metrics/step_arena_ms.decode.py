"""Mean host time of a decode step's KV bookkeeping: the new slots' K/V
copied to the host (``decode/step/kv_out``) plus their append to the
paged host arena and the step's events (``decode/step/arena``), each
the mean over steps."""


def read(ctx):
    by = {"decode/step/kv_out": [], "decode/step/arena": []}
    for s in ctx.get("spans", []):
        if s["name"] in by:
            by[s["name"]].append(s["dur_ms"])
    if not all(by.values()):
        return None
    return sum(sum(v) / len(v) for v in by.values())
