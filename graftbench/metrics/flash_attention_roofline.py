"""Row 1/2's share of its roofline (``attn_fwd_wgmma``): the least time
for the causal attention every answered request needed over all its
blocks (the mobile part [0, p) and the pools' [p, L)), over the
kernel's device time in the trace."""
from graftbench import flops
from graftbench.metrics._work import kernel_seconds, served_oneshots


def read(ctx):
    done = served_oneshots(ctx)
    t = kernel_seconds(ctx, "attn_fwd_")
    if not done or t <= 0:
        return None
    L = ctx["cfg"].n_layers
    f = b = 0.0
    for S, _p in done:
        df, db = flops.attention_prefill_work(ctx["cfg"], S, L)
        f, b = f + df, b + db
    return 100.0 * flops.least_seconds(f, b)[0] / t
