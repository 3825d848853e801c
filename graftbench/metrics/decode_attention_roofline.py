"""Row 3's share of its roofline (``decode_attn_kernel``): the least
time for the valid cache slots every active row of every step of the
completed streams attended, over the kernel's device time in the
trace. Rows of the batch that hold no stream are padding: the kernel
spends time on them, and the count leaves them out."""
from graftbench import flops
from graftbench.metrics._work import decode_rows, kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx, "decode_attn_kernel")
    if t <= 0:
        return None
    f = b = 0.0
    for v in decode_rows(ctx):
        df, db = flops.attention_decode_work(ctx["cfg"], v)
        f, b = f + df, b + db
    return 100.0 * flops.least_seconds(f, b)[0] / t if f else None
