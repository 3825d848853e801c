"""MB framed per answered one-shot request: every request frame of
every hop (the channels' ``TransferStats``) plus the result as framed on
the last hop's reply (its bfloat16 logits, prompt x vocabulary). The
replies of intermediate hops are not counted: ``TransferStats`` logs
request frames only."""
from graftbench.metrics._work import served_oneshots


def read(ctx):
    done = served_oneshots(ctx)
    if not done or "wire_bytes" not in ctx:
        return None
    V = ctx["cfg"].vocab_size
    reply = sum(S * V * 2 for S, _p in done)
    return (ctx["wire_bytes"] + reply) / len(done) / 1e6
