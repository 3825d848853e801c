"""p90 of time to first token over every stream sent in the window (the
server's completion records; a stream never answered ranks last)."""
import math

from graftbench import stats


def read(ctx):
    v = ctx["e2e"].get("ttft_ms") or []
    if not v:
        return None
    p = stats.percentile(v, 0.90)
    return None if math.isinf(p) else p
