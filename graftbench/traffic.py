"""The one traffic generator: a mix's parameters (a JSON file under
``traffic/``) and ``--seed`` -> the request schedule.

Every seed gets the same work in another order: client profiles,
arrival gaps, prompt and output lengths are fixed quantiles of the mix's
distributions, and the seed only permutes them and draws the token ids.
Runs with different seeds then differ in arrangement, not in how much
there is to do.

Two kinds of mix:

``open_oneshot``
    Graft's mobile clients in an open loop. Client ``i`` has a partition
    point, a budget and a rate share (Zipf over the clients); arrivals
    over the window are a Poisson process of the mix's total rate, each
    arrival dealt to a client in proportion to its share. Each request is
    a one-shot prompt run at its client's partition point.
``closed_decode``
    Chat sessions in a closed loop: each sends its next request when the
    last one has finished (think time 0). A request is a prompt of
    ``shared_prefix`` tokens common to every request plus a turn of its
    own, and a number of new tokens to generate.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Client:
    name: str
    p: int
    budget_ms: float
    rate_rps: float


@dataclass
class OneShot:
    due_s: float            # send time, seconds after the window opens
    client: int
    tokens: np.ndarray


@dataclass
class Turn:
    tokens: np.ndarray
    max_new: int


@dataclass
class Schedule:
    kind: str
    clients: list
    requests: list = field(default_factory=list)     # OneShot, by due_s
    sessions: list = field(default_factory=list)     # [[Turn, ...], ...]
    budget_ms: float = 0.0                            # closed_decode


def _quantiles(n: int) -> np.ndarray:
    """Midpoint probabilities (i + 0.5) / n of ``n`` equal strata."""
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the strata of a lognormal of median ``median`` and
    log-sd ``sigma``, rounded and clipped to [lo, hi]."""
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf(q) for q in _quantiles(n)])
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["lo"], spec["hi"]).astype(np.int64)


def clients(mix: dict) -> list:
    """The open loop's clients, the same for every seed: partition points
    and budgets at the strata of their uniform ranges and Zipf rate
    shares, paired by a permutation the mix's ``layout_seed`` draws."""
    rng = np.random.default_rng(int(mix["layout_seed"]))
    n = int(mix["clients"])
    lo, hi = mix["partition"]
    points = np.floor(lo + _quantiles(n) * (hi - lo + 1)).astype(int)
    blo, bhi = mix["budget_ms"]
    budgets = blo + _quantiles(n) * (bhi - blo)
    share = 1.0 / np.arange(1, n + 1) ** float(mix["zipf_s"])
    share /= share.sum()
    points, budgets, share = (rng.permutation(points),
                              rng.permutation(budgets),
                              rng.permutation(share))
    rate = float(mix["rate_rps"])
    return [Client(f"c{i}", int(points[i]), float(budgets[i]),
                   float(share[i] * rate)) for i in range(n)]


def open_oneshot(mix: dict, seed: int, seconds: float, vocab: int,
                 rate_rps: float | None = None) -> Schedule:
    """Open-loop one-shot schedule for a window of ``seconds``. The
    requests (each a client and a prompt length) are the same for every
    seed; the seed draws their order, the order of the Poisson gaps
    between them and the token ids."""
    if rate_rps is not None:
        mix = dict(mix, rate_rps=rate_rps)
    cl = clients(mix)
    rate = float(mix["rate_rps"])
    n = max(int(round(rate * seconds)), 1)
    share = np.array([c.rate_rps for c in cl]) / rate
    counts = np.floor(share * n).astype(int)
    rest = np.argsort(-(share * n - counts), kind="stable")[
        :n - counts.sum()]
    counts[rest] += 1
    layout = np.random.default_rng(int(mix["layout_seed"]) + 1)
    owner = layout.permutation(np.repeat(np.arange(len(cl)), counts))
    lengths = layout.permutation(lognormal_lengths(mix["prompt"], n))
    rng = np.random.default_rng(int(seed))
    order = rng.permutation(n)
    # Poisson arrivals: exponential gaps at their strata, in an order the
    # seed draws
    gaps = -np.log1p(-_quantiles(n)) / rate
    due = np.cumsum(rng.permutation(gaps))
    due *= seconds / max(float(due[-1]), 1e-9) * (n - 0.5) / n
    reqs = [OneShot(float(due[i]), int(owner[order[i]]),
                    rng.integers(0, vocab, int(lengths[order[i]]),
                                 dtype=np.int32))
            for i in range(n)]
    return Schedule("open_oneshot", cl, requests=reqs)


def closed_decode(mix: dict, seed: int, vocab: int) -> Schedule:
    """Closed-loop chat sessions, each with a queue of turns that a
    window cannot exhaust. Round ``j`` (every session's ``j``-th turn)
    takes one length from each of the sessions' equal bands of the
    distribution, at the same offset in every band, the offsets in
    bit-reversed order, so the first rounds cover every band evenly and
    the same on every seed; the seed deals a round's lengths to the
    sessions."""
    rng = np.random.default_rng(int(seed))
    n_sess = int(mix["sessions"])
    per = int(mix["turns_per_session"])
    n = n_sess * per

    bits = max(per - 1, 1).bit_length()
    offs = sorted(range(per), key=lambda o: int(f"{o:0{bits}b}"[::-1], 2))

    def rounds(spec: dict) -> np.ndarray:
        band = lognormal_lengths(spec, n).reshape(n_sess, per)
        return np.stack([rng.permutation(band[:, o]) for o in offs])

    turn, out = rounds(mix["turn"]), rounds(mix["output"])
    prefix = rng.integers(0, vocab, int(mix.get("shared_prefix", 0)),
                          dtype=np.int32)
    sessions = [[Turn(np.concatenate([prefix, rng.integers(
        0, vocab, int(turn[j, s]), dtype=np.int32)]), int(out[j, s]))
        for j in range(per)] for s in range(n_sess)]
    cl = [Client(f"s{s}", 0, float(mix["ttft_budget_ms"]), 0.0)
          for s in range(n_sess)]
    return Schedule("closed_decode", cl, sessions=sessions,
                    budget_ms=float(mix["ttft_budget_ms"]))


def build(mix: dict, seed: int, seconds: float, vocab: int,
          rate_rps: float | None = None) -> Schedule:
    kind = mix["kind"]
    if kind == "open_oneshot":
        return open_oneshot(mix, seed, seconds, vocab, rate_rps)
    if kind == "closed_decode":
        return closed_decode(mix, seed, vocab)
    raise ValueError(f"unknown traffic kind {kind!r}")
