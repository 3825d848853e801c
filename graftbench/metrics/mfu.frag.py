"""Share of the card's bf16 peak in the server's pool batches: the FLOPs
of the answered requests' server-side blocks [p, L) and head, over the
summed walls of the batches that ran them (``server/exec_ms``)."""
from graftbench import flops
from graftbench.metrics._work import PEAK, served_oneshots


def read(ctx):
    done = served_oneshots(ctx)
    count, ms = ctx.get("hist", {}).get("server/exec_ms", (0, 0.0))
    if not done or ms <= 0:
        return None
    L = ctx["cfg"].n_layers
    work = sum(flops.prefill_flops(ctx["cfg"], S, L - p, head=True)
               for S, p in done)
    return 100.0 * work / (ms / 1e3) / PEAK
