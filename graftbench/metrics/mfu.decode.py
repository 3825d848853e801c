"""Share of the card's bf16 peak in the decode steps: the FLOPs of every
active row of every step of the completed streams (every block at one
token over its valid cache slots, and the head), over the summed step
walls (``decode/step`` spans)."""
from graftbench import flops
from graftbench.metrics._work import PEAK, decode_rows, spans


def read(ctx):
    ms = sum(s["dur_ms"] for s in spans(ctx, "decode/step"))
    if ms <= 0:
        return None
    work = sum(flops.decode_step_flops(ctx["cfg"], v)
               for v in decode_rows(ctx))
    return 100.0 * work / (ms / 1e3) / PEAK if work else None
