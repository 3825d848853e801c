"""Work reconstructions shared by the readers: what the served requests
of a traced window needed, from the requests the harness sent."""
from __future__ import annotations

from graftbench import flops


def served_oneshots(ctx) -> list:
    """[(prompt length, partition point)] of the one-shot requests that
    were answered in the traced window."""
    sched, win = ctx["sched"], ctx["win"]
    return [(len(r.tokens), sched.clients[r.client].p)
            for r, d, sh in zip(sched.requests, win["done"], win["shed"])
            if d is not None and not sh]


def served_streams(ctx) -> list:
    """[(prompt length, tokens generated)] of the decode streams that
    completed in the traced window."""
    return [(len(req.tokens), len(req.out_tokens))
            for _s, _j, _ts, _td, rec, req, *_ in ctx["win"]["log"]
            if rec is not None and not rec.get("shed") and req.out_tokens]


def decode_rows(ctx):
    """Each decode step row of every completed stream: the valid cache
    slots it attended (step j of a prompt of S attends S + j slots)."""
    for S, n in served_streams(ctx):
        for j in range(1, n):
            yield S + j


def spans(ctx, name: str) -> list:
    return [s for s in ctx.get("spans", []) if s["name"] == name]


def kernel_seconds(ctx, needle: str) -> float:
    prof = ctx.get("profile") or {}
    return sum(v for k, v in prof.get("kernel_s", {}).items()
               if needle in k)


PEAK = flops.PEAK_BF16_FLOPS
