"""CPU tests of the benchmark's yardstick: the traffic generator, the
percentile and goodput arithmetic, the work counters and the profile
reduction."""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from graftbench import flops, stats, traffic  # noqa: E402
from graftbench.trace import union_seconds  # noqa: E402

MIXES = ROOT / "graftbench" / "traffic"
BIG = 2 ** 31 + 12345


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["frag-poisson", "chat-closed"])
def test_same_seed_same_schedule(name):
    a = traffic.build(_mix(name), BIG, 45, 1000)
    b = traffic.build(_mix(name), BIG, 45, 1000)
    if a.kind == "open_oneshot":
        assert [(r.due_s, r.client) for r in a.requests] == \
            [(r.due_s, r.client) for r in b.requests]
        assert all(np.array_equal(x.tokens, y.tokens)
                   for x, y in zip(a.requests, b.requests))
    else:
        assert all(np.array_equal(x.tokens, y.tokens) and
                   x.max_new == y.max_new
                   for s, t in zip(a.sessions, b.sessions)
                   for x, y in zip(s, t))


def test_open_loop_seeds_share_the_work():
    """Another seed sends the same requests (client, prompt length) over
    the same arrival gaps, in another order."""
    mix = _mix("frag-poisson")
    a = traffic.build(mix, 1, 45, 1000)
    b = traffic.build(mix, BIG, 45, 1000)
    reqs = lambda s: sorted((r.client, len(r.tokens)) for r in s.requests)
    assert reqs(a) == reqs(b)
    assert [(r.client, len(r.tokens)) for r in a.requests] != \
        [(r.client, len(r.tokens)) for r in b.requests]
    gaps = lambda s: sorted(np.round(np.diff([0.0] + [r.due_s for r in
                                              s.requests]), 9))
    assert np.allclose(gaps(a), gaps(b))
    assert [(c.p, c.budget_ms, c.rate_rps) for c in a.clients] == \
        [(c.p, c.budget_ms, c.rate_rps) for c in b.clients]
    assert len(a.requests) == round(mix["rate_rps"] * 45)
    assert all(0 < r.due_s <= 45 for r in a.requests)
    lo, hi = mix["partition"]
    assert {c.p for c in a.clients} <= set(range(lo, hi + 1))
    share = sorted(c.rate_rps for c in a.clients)
    assert share[-1] / share[0] == pytest.approx(mix["clients"])  # Zipf


def test_closed_loop_rounds_cover_the_bands():
    mix = _mix("chat-closed")
    a = traffic.build(mix, 3, 45, 1000)
    b = traffic.build(mix, BIG, 45, 1000)
    for s in (a, b):
        assert len(s.sessions) == mix["sessions"]
        first = [len(t.tokens) for sess in s.sessions for t in sess[:4]]
        assert min(first) >= mix["turn"]["lo"]
        assert max(len(t.tokens) + t.max_new for sess in s.sessions
                   for t in sess) <= mix["serve"]["decode_ctx"]
    # the first rounds' mean lengths agree within a band's width
    m = [np.mean([len(t.tokens) for sess in s.sessions for t in sess[:8]])
         for s in (a, b)]
    assert abs(m[0] - m[1]) / m[0] < 0.05


def test_percentile_counts_misses_last():
    vals = [10.0, 20.0, 30.0, stats.MISS]
    assert stats.percentile(vals, 0.5) == 20.0
    assert stats.percentile(vals, 0.75) == 30.0
    assert math.isinf(stats.percentile(vals, 0.9))
    assert stats.percentile(list(range(1, 11)), 0.9) == 9
    assert stats.beyond(list(range(100)), 0.9) == 10


def test_goodput_counts_misses_as_failed():
    lat = [100.0, 2500.0, stats.MISS, 1000.0]
    bud = [2000.0, 2000.0, 4000.0, 1000.0]
    assert stats.goodput(lat, bud, 2.0) == 1.0       # two met, over 2 s


def test_decode_rate_counts_tokens_emitted_by_the_close():
    from graftbench.harness import decode_e2e
    def rec(t_done_ms):
        return {"ttft_ms": 50.0, "n_tokens": 40, "t_done_ms": t_done_ms}
    log = [
        # session, turn, sent, done, record, request, rid, tokens at close
        [0, 0, 0.0, 4.0, rec(4e3), None, 1, None],   # seen in the window
        [0, 1, 4.0, 12.0, rec(12e3), None, 2, 25],   # running at the close
        [1, 0, 0.0, 11.0, {"shed": True}, None, 3, 30],  # shed later
        [2, 0, 9.5, 13.0, rec(13e3), None, 4, 0],    # not admitted by then
        [3, 0, 0.0, 10.1, rec(9.9e3), None, 5, 0],   # done, seen after
    ]
    out = decode_e2e({"log": log, "close_ms": 10e3}, 10.0)
    assert out["tokens"] == 40 + 25 + 40
    assert out["decode_tok_s"] == 10.5
    assert out["completed"] == 2 and out["sent"] == 5
    assert out["missed"] == 1 and math.isinf(max(out["ttft_ms"]))


def test_spread_is_quartile_distance_over_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


class _Cfg:
    """A tiny model's sizes, as the counters read them."""
    def __init__(self, moe=None):
        self.d_model, self.n_heads, self.n_kv_heads = 8, 4, 2
        self.head_dim_, self.d_ff, self.vocab_size = 2, 16, 10
        self.n_layers, self.moe = 3, moe


class _Moe:
    n_experts, top_k, d_ff_expert = 4, 2, 6


def test_counters_against_hand_counts():
    c = _Cfg()
    # projections: q 8x8, k 8x4, v 8x4, o 8x8 -> 192 MACs; mlp 3*8*16=384
    assert flops.layer_token_flops(c) == 2 * (192 + 384)
    m = _Cfg(_Moe())
    # router 8x4 = 32 MACs; two experts of 3*8*6 = 144 MACs each
    assert flops.layer_token_flops(m) == 2 * (192 + 32 + 2 * 144)
    assert flops.causal_pairs(3) == 6
    # 3 tokens: 6 pairs, 4 heads of dim 2, QK^T and PV
    assert flops.pair_flops(c, 6) == 2 * 2 * 6 * 4 * 2
    f, b = flops.attention_prefill_work(c, 3, 2)
    assert f == 2 * 4 * 6 * 4 * 2
    assert b == 2 * 3 * (2 * 4 + 2 * 2) * 2 * 2      # q,k,v,o bf16
    f, b = flops.attention_decode_work(c, 5)
    assert f == 3 * 4 * 5 * 4 * 2
    assert b == 3 * (2 * 2 * 2 * 5 + 2 * 4 * 2) * 2
    assert flops.head_flops(c, 2) == 2 * 2 * 8 * 10
    assert flops.decode_step_flops(c, 5) == 3 * (
        flops.layer_token_flops(c) + flops.pair_flops(c, 5)) + 160
    t, bound = flops.least_seconds(989e12, 1.0)
    assert (t, bound) == (1.0, "flops")


def test_counters_match_a_counted_forward():
    """The prefill count equals the multiply-adds of an explicit causal
    attention and MLP at a tiny shape."""
    c = _Cfg()
    S = 5
    macs = 0
    macs += S * (8 * 8 + 2 * 8 * 4 + 8 * 8)          # projections
    for i in range(S):                               # causal pairs
        macs += (i + 1) * 4 * 2 * 2                  # QK and PV per head
    macs += S * 3 * 8 * 16                           # gated mlp
    assert flops.prefill_flops(c, S, 1, head=False) == 2 * macs


def test_union_of_device_intervals():
    s = np.array([0, 5, 20, 21], np.int64) * 10 ** 9
    e = np.array([10, 8, 25, 22], np.int64) * 10 ** 9
    assert union_seconds(s, e) == 15.0
    assert union_seconds(np.array([], np.int64),
                         np.array([], np.int64)) == 0.0
