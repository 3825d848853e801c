"""Synthetic token pipeline for the training example and launcher.

A deterministic, infinite stream of (tokens, labels) batches — a zipfian
unigram source so losses are non-degenerate. A copy of the JAX
package's ``data/tokens.py`` (numpy only): the same seed gives the same
batches in both packages.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def token_batches(*, batch: int, seq_len: int, vocab: int,
                  seed: int = 0) -> Iterator[dict]:
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
