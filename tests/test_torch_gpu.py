"""Card-only tests of the port: each Hopper kernel against its plain
PyTorch version on the card, and the serving paths (one-shot and decode)
launching the kernels.

Marked ``gpu``; every test asks the ``cuda`` fixture for the card and
skips where there is none, so every pytest worker collects the same
tests. This file imports no JAX, so it also runs on a machine without
it: ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (``--noconftest`` skips the JAX package's
``tests/conftest.py``). Tolerances: float32 ``atol=2e-5, rtol=1e-3``
(summation order only); bfloat16 ``atol=2e-2, rtol=1e-2`` (both round
the output to bf16: an ulp near 1 is 7.8e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (2e-5, 1e-3), torch.bfloat16: (2e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, B, Sq, Sk, H, KV, hd, segs=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(device=device, dtype=dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    seg = None
    if segs is not None:
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(segs)]
                             + [np.full(Sq - sum(segs), len(segs))])
        seg = torch.tensor(ids, dtype=torch.int32,
                           device=device)[None].expand(B, Sq).contiguous()
    return q, k, v, seg


CASES = [  # B, Sq, Sk, H, KV, hd, causal, window, segments
    (1, 2048, 2048, 16, 8, 128, True, 0, [300, 517, 211, 489, 250, 181]),
    (2, 131, 131, 4, 1, 128, True, 0, None),
    (1, 257, 257, 4, 4, 64, True, 64, None),
    (2, 97, 131, 8, 2, 32, False, 0, None),
    (2, 200, 200, 8, 2, 64, True, 0, [13, 50, 71, 40]),
    (1, 173, 173, 4, 2, 32, True, 24, [5, 90, 61]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain_versions(cuda, dtype, case):
    B, Sq, Sk, H, KV, hd, causal, window, segs = case
    q, k, v, seg = _inputs(cuda, dtype, B, Sq, Sk, H, KV, hd, segs)
    atol, rtol = TOL[dtype]
    kw = dict(causal=causal, window=window)
    got = fa.flash_attention(q, k, v, seg, **kw)
    want = fa.flash_attention_plain(q, k, v, seg, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if seg is None:
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        o2, lse2 = fa.flash_attention_lse_plain(q, k, v, **kw)
        torch.testing.assert_close(o.float(), o2.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, lse2, atol=1e-4, rtol=0)


def test_wrappers_count_launches(cuda):
    q, k, v, seg = _inputs(cuda, torch.bfloat16, 1, 64, 64, 4, 2, 64, [30])
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v, seg)
    fa.flash_attention_lse(q, k, v)
    fa.flash_attention_plain(q, k, v, seg)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_lse"] == \
        before["flash_attention_lse"] + 1


def test_executor_on_the_card_runs_the_kernels(cuda):
    from repro_torch.core import Fragment
    from repro_torch.serving import GraftExecutor, ServeRequest
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           mixed_depth_plan, smoke_setup)

    cfg, book, params = smoke_setup("qwen3-1.7b", n_layers=3)
    assert params["embed"].is_cuda
    frags = [Fragment(cfg.name, p, 50.0, 30.0, client=f"c{i}")
             for i, p in enumerate((0, 1, 1))]
    rng = np.random.RandomState(0)
    reqs = [(ServeRequest(client=f.client,
                          tokens=rng.randint(0, cfg.vocab_size, n)
                          .astype(np.int32)), f.p)
            for f, n in zip(frags, (17, 40, 9))]
    fa.reset_launches()
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params,
                       cfg) as ex:
        ex.serve(reqs)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] > 0
    assert fa.LAUNCHES["flash_attention_lse"] > 0
    check_against_monolithic(cfg, params, reqs)


# ------------------------------------------------------- decode attention

def _decode_case(device, dtype, B, Sk, H, KV, hd, q_pos, ring, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(device=device, dtype=dtype)
               for s in ((B, 1, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kv_pos = np.full((B, Sk), -1, np.int32)
    for b, qp in enumerate(q_pos):
        lo = max(0, qp - Sk + 1) if ring else 0
        for p in range(lo, min(qp + 1, lo + Sk)):
            kv_pos[b, p % Sk if ring else p] = p
    return (q, k, v, torch.tensor(q_pos, dtype=torch.int32, device=device),
            torch.from_numpy(kv_pos).to(device))


DECODE_CASES = [  # B, Sk, H, KV, hd, q_pos, ring, window
    (2, 256, 4, 2, 32, [60, 97], False, 0),
    (3, 128, 8, 8, 64, [60, 97, 127], False, 100),
    (1, 512, 16, 2, 64, [400], False, 100),
    (3, 131, 8, 2, 128, [130, 64, 0], False, 0),      # ragged Sk
    (3, 96, 16, 8, 128, [300, 95, 40], True, 0),      # ring, -1 holes
    (4, 512, 16, 8, 128, [511, 300, 64, 5], False, 0),  # main path
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain_version(cuda, dtype, case):
    B, Sk, H, KV, hd, q_pos, ring, window = case
    q, k, v, qp, kp = _decode_case(cuda, dtype, B, Sk, H, KV, hd, q_pos, ring)
    atol, rtol = TOL[dtype]
    got = da.decode_attention(q, k, v, qp, kp, window=window)
    want = da.decode_attention_plain(q, k, v, qp, kp, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_decode_kernel_row_does_not_depend_on_batch_or_capacity(cuda):
    """Fixed-length splits: a row's output is bit-identical alone, in a
    batch of 4, and against a larger cache whose extra slots are empty."""
    q, k, v, qp, kp = _decode_case(cuda, torch.float32, 4, 512, 16, 8, 128,
                                   [200, 300, 64, 5], False)
    full = da.decode_attention(q, k, v, qp, kp)
    alone = da.decode_attention(q[1:2], k[1:2, :301], v[1:2, :301], qp[1:2],
                                kp[1:2, :301].contiguous())
    assert torch.equal(full[1:2], alone)


def test_decode_wrapper_counts_launches_and_refuses(cuda):
    q, k, v, qp, kp = _decode_case(cuda, torch.bfloat16, 2, 70, 4, 2, 64,
                                   [69, 30], False)
    before = da.LAUNCHES["decode_attention"]
    da.decode_attention(q, k, v, qp, kp)
    da.decode_attention_plain(q, k, v, qp, kp)
    assert da.LAUNCHES["decode_attention"] == before + 1
    with pytest.raises(ValueError, match="on cpu"):
        da.decode_attention(q, k, v, qp, kp.cpu())       # device mix
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q[..., :48], k[..., :48].contiguous(),
                            v[..., :48].contiguous(), qp, kp)
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), k.half(), v.half(), qp, kp)
    assert da.LAUNCHES["decode_attention"] == before + 1


def test_decode_serving_on_the_card_runs_the_kernels(cuda):
    """A tiny continuous-batching decode through GraftExecutor on the
    card (an abort frees a slot for a mid-decode admission) launches the
    decode kernel, and its greedy tokens equal the port's unbatched
    reference."""
    from repro_torch.core import Fragment
    from repro_torch.serving import GraftExecutor
    from repro_torch.serving.smoke import (decode_plan, drive_decode,
                                           reference_decode, smoke_setup)

    cfg, book, params = smoke_setup("qwen3-1.7b", n_layers=3)
    frags = [Fragment(cfg.name, 0, 50.0, 30.0, client=f"c{i}")
             for i in range(2)]
    rng = np.random.RandomState(0)
    prompts = [(f"c{i % 2}", rng.randint(0, cfg.vocab_size, n)
                .astype(np.int32)) for i, n in enumerate((17, 40, 9))]
    da.reset_launches()
    fa.reset_launches()
    with GraftExecutor(decode_plan(cfg, book, frags, batch=2), params, cfg,
                       decode_ctx=64, kv_block_tokens=8) as ex:
        r = drive_decode(ex, prompts, 6, abort_at={0: 2})
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode_attention"] > 0
    assert fa.LAUNCHES["flash_attention_lse"] > 0        # admission prefill
    assert r["aborted"] == [0] and r["mid_admits"] >= 1
    for (_, toks), got in list(zip(prompts, r["tokens"]))[1:]:
        assert got == reference_decode(cfg, params, toks, 6)
