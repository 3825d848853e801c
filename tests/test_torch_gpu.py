"""Card-only tests of the port: each Hopper kernel against its plain
PyTorch version on the card, and the serving path launching the kernels.

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
