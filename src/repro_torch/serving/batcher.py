"""Batch and token bucket policies of the serving runtime.

Only the shape policies the executor needs are here so far; the
deadline-aware micro-batcher and the shed policy come with the server.
"""
from __future__ import annotations


def bucket_size(n: int, max_batch: int) -> int:
    """Pad-to-bucket target for a batch of ``n``: the smallest power of
    two >= n, capped at ``max_batch`` (the cap itself is always a bucket
    even when not a power of two). Padding partial batches to these
    buckets bounds the distinct batch shapes a pool's jitted program ever
    sees at ~log2(max_batch)+1 instead of one trace per queue-length the
    traffic happens to produce — replans that rebatch pools stop churning
    the compile cache."""
    n = max(int(n), 1)
    cap = max(int(max_batch), 1)
    if n >= cap:
        return n                      # never pad past the planned batch
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def seq_bucket(n_tokens: int, *, floor: int = 8) -> int:
    """Sequence-length bucket: the smallest power of two >= ``n_tokens``
    (>= ``floor``). The pad-to-bucket fallback path pads each payload's
    token axis to this bucket before stacking, so a pool serving mixed
    lengths sees O(log(max_len)) distinct sequence shapes instead of one
    re-trace per length the traffic happens to produce."""
    n = max(int(n_tokens), 1)
    b = max(int(floor), 1)
    while b < n:
        b <<= 1
    return b


def token_bucket(n_tokens: int, *, floor: int = 8, step: int = 16) -> int:
    """Packed-buffer bucket: total token target for a sequence-packed
    batch. Totals at or under ``floor`` get the floor bucket (a lone
    short request must not double its cost); everything else rounds UP
    to the next multiple of ``step``. The packed path concatenates
    heterogeneous-length payloads along the token axis and pads ONLY
    the tail up to this bucket, so waste is bounded by ``step - 1``
    tokens *per flush* no matter how the batch mixes — strictly tighter
    than per-request pad-to-bucket, whose waste scales with the batch.
    Multiples (not powers of two like :func:`seq_bucket`) keep that
    bound flat as totals grow, and the distinct-shape count stays at
    ``~max_total/step + 1`` — below the padded path's seq-buckets x
    batch-buckets product — because totals are capped by the pool's
    batch times the max request length. There is no batch cap: the
    budget is tokens, not rows."""
    n = max(int(n_tokens), 1)
    f = max(int(floor), 1)
    if n <= f:
        return f
    s = max(int(step), 1)
    return ((n + s - 1) // s) * s
