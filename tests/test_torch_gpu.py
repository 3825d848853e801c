"""Card-only tests of the port: each Hopper kernel against its plain
PyTorch version on the card (attention forward and backward, decode
attention and the two recurrent scans), the serving paths (one-shot and
decode, dense and hybrid) and a training step launching the kernels,
the kernels without a backward refusing inputs that require grad, and
the expert-parallel MoE over two gloo ranks sharing the card.

Marked ``gpu``; every test asks the ``cuda`` fixture for the card and
skips where there is none, so every pytest worker collects the same
tests. This file imports no JAX, so it also runs on a machine without
it: ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (``--noconftest`` skips the JAX package's
``tests/conftest.py``). Tolerances: float32 ``atol=2e-5, rtol=1e-3``
(summation order only); bfloat16 ``atol=2e-2, rtol=1e-2`` (both round
the output to bf16: an ulp near 1 is 7.8e-3), where a kernel is held
against its plain version with ``atol`` scaled by min(1, max |want|)
(``_assert_kernel_close``: a fixed 2e-2 holds nothing where |o| is far
below 1) and an all-zero output refused.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels import wkv6_scan as wk

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (2e-5, 1e-3), torch.bfloat16: (2e-2, 1e-2)}


def _assert_kernel_close(got, want, dtype):
    """A kernel's output against its plain version's at ``TOL[dtype]``,
    bf16's ``atol`` times min(1, max |want|) (never looser than 2e-2);
    the same limits must refuse an all-zero output."""
    atol, rtol = TOL[dtype]
    if dtype == torch.bfloat16:
        atol *= min(1.0, want.float().abs().max().item())
    assert not torch.allclose(torch.zeros_like(want, dtype=torch.float32),
                              want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, B, Sq, Sk, H, KV, hd, segs=None, seed=0,
            fused=False):
    """q, k, v and seg ids. ``segs``: segment lengths (ids 0, 1, ... in
    order) or (id, length) pairs (any order, an id may recur); the pad
    tail takes the next id. ``fused`` (Sq == Sk): q, k and v are slices
    of one (B, S, H + 2 KV, hd) buffer."""
    g = torch.Generator().manual_seed(seed)
    if fused:
        qkv = torch.randn((B, Sq, H + 2 * KV, hd), generator=g).to(
            device=device, dtype=dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    else:
        q, k, v = (torch.randn(s, generator=g).to(device=device, dtype=dtype)
                   for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                             (B, Sk, KV, hd)))
    seg = None
    if segs is not None:
        pairs = [sg if isinstance(sg, tuple) else (i, sg)
                 for i, sg in enumerate(segs)]
        ids = np.concatenate(
            [np.full(n, i) for i, n in pairs]
            + [np.full(Sq - sum(n for _, n in pairs),
                       max(i for i, _ in pairs) + 1)])
        seg = torch.tensor(ids, dtype=torch.int32,
                           device=device)[None].expand(B, Sq).contiguous()
    return q, k, v, seg


CASES = [  # B, Sq, Sk, H, KV, hd, causal, window, segments, fused qkv
    (1, 2048, 2048, 16, 8, 128, True, 0, [300, 517, 211, 489, 250, 181],
     False),
    (2, 131, 131, 4, 1, 128, True, 0, None, False),
    (1, 257, 257, 4, 4, 64, True, 64, None, False),
    (2, 97, 131, 8, 2, 32, False, 0, None, False),
    (2, 200, 200, 8, 2, 64, True, 0, [13, 50, 71, 40], False),
    (1, 173, 173, 4, 2, 32, True, 24, [5, 90, 61], False),
    # hymba: GQA 5, a window crossed, a ragged last tile
    (1, 1100, 1100, 25, 5, 64, True, 1024, None, False),
    # S = 64k + 1 at hd 128
    (2, 193, 193, 16, 8, 128, True, 0, None, False),
    # q, k and v strided slices of one fused QKV buffer
    (2, 160, 160, 8, 2, 128, True, 0, None, True),
    # segment ids out of order, id 5 in two separate runs
    (1, 300, 300, 8, 2, 64, True, 0,
     [(5, 40), (2, 90), (5, 70), (0, 60), (9, 40)], False),
    # olmoe (GQA 1, hd 128): a packed wave, and a padded prompt
    (1, 2048, 2048, 16, 16, 128, True, 0, [300, 517, 211, 489, 250, 181],
     False),
    (2, 512, 512, 16, 16, 128, True, 0, None, False),
    # llama4-scout (GQA 5, hd 128)
    (1, 1024, 1024, 40, 8, 128, True, 0, None, False),
    # whisper-base (8 heads of 64, 1500 frames): the encoder, the decoder's
    # cross-attention (non-causal, Sq != Sk, a ragged last kv tile), and
    # the same in decode (Sq = 1: a q tile with one live row)
    (2, 1500, 1500, 8, 8, 64, False, 0, None, False),
    (2, 448, 1500, 8, 8, 64, False, 0, None, False),
    (4, 1, 1500, 8, 8, 64, False, 0, None, False),
    # llama-3.2-vision (64 heads / 8 kv of 128, 1601 image tokens)
    (2, 200, 1601, 64, 8, 128, False, 0, None, False),
    (3, 1, 1601, 64, 8, 128, False, 0, None, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain_versions(cuda, dtype, case):
    B, Sq, Sk, H, KV, hd, causal, window, segs, fused = case
    q, k, v, seg = _inputs(cuda, dtype, B, Sq, Sk, H, KV, hd, segs,
                           fused=fused)
    kw = dict(causal=causal, window=window)
    got = fa.flash_attention(q, k, v, seg, **kw)
    want = fa.flash_attention_plain(q, k, v, seg, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_kernel_close(got, want, dtype)
    if seg is None:
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        o2, lse2 = fa.flash_attention_lse_plain(q, k, v, **kw)
        _assert_kernel_close(o, o2, dtype)
        torch.testing.assert_close(lse, lse2, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_decode_reads_views_of_a_stacked_cache(cuda, dtype):
    """Decode's cross-attention reads ``img_k[g]`` / ``xk[l]``, views of
    one stacked cache (G, B, T, KV, hd): the kernel on each view equals
    the plain version on a contiguous copy, and its TMA (bf16) takes the
    views' offset bases."""
    g = torch.Generator().manual_seed(3)
    G, B, T, H, KV, hd = 2, 3, 1601, 64, 8, 128
    kc, vc = (torch.randn((G, B, T, KV, hd), generator=g).to(
        device=cuda, dtype=dtype) for _ in range(2))
    q = torch.randn((B, 1, H, hd), generator=g).to(device=cuda, dtype=dtype)
    atol, rtol = TOL[dtype]
    for i in range(G):
        o, _ = fa.flash_attention_lse(q, kc[i], vc[i], causal=False)
        want, _ = fa.flash_attention_lse_plain(
            q, kc[i].clone(), vc[i].clone(), causal=False)
        torch.testing.assert_close(o.float(), want.float(), atol=atol,
                                   rtol=rtol)


def test_wrappers_count_launches(cuda):
    q, k, v, seg = _inputs(cuda, torch.bfloat16, 1, 64, 64, 4, 2, 64, [30])
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v, seg)
    fa.flash_attention_lse(q, k, v)
    fa.flash_attention_plain(q, k, v, seg)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_lse"] == \
        before["flash_attention_lse"] + 1


def test_bf16_views_tma_cannot_read_raise_on_the_card(cuda):
    """The bf16 kernel loads by TMA: a view with a base off 16 bytes
    raises before any launch; the same view in float32 runs on the
    scalar kernel and matches the plain version."""
    before = dict(fa.LAUNCHES)
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.randn(1, 64, 4 * 32 + 1,
                          generator=torch.Generator().manual_seed(0))
        q = buf.to(device=cuda, dtype=dtype)[:, :, 1:].unflatten(2, (4, 32))
        k = q[:, :, :2]
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="TMA"):
                fa.flash_attention(q, k, k)
            assert fa.LAUNCHES == before
        else:
            torch.testing.assert_close(fa.flash_attention(q, k, k),
                                       fa.flash_attention_plain(q, k, k),
                                       atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_empty_kv_gives_zeros(cuda, dtype):
    """Sk = 0 (no kv at all): both kernels launch and every row is 0,
    as for a row whose kv is all masked."""
    q = torch.randn(1, 70, 4, 64, device=cuda).to(dtype)
    k = torch.zeros(1, 0, 2, 64, device=cuda, dtype=dtype)
    o = fa.flash_attention(q, k, k, causal=False)
    torch.cuda.synchronize()
    assert o.shape == q.shape and not o.any()


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
    (3, 1100, 25, 5, 64, [1099, 700, 30], False, 1024),  # hymba GQA 5
    (4, 512, 16, 16, 128, [511, 300, 64, 5], False, 0),  # olmoe GQA 1
    (4, 512, 40, 8, 128, [511, 300, 64, 5], False, 0),   # llama4 GQA 5
    (4, 448, 8, 8, 64, [447, 200, 31, 16], False, 0),    # whisper self
    (3, 216, 64, 8, 128, [215, 100, 17], False, 0),      # vision self
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain_version(cuda, dtype, case):
    B, Sk, H, KV, hd, q_pos, ring, window = case
    q, k, v, qp, kp = _decode_case(cuda, dtype, B, Sk, H, KV, hd, q_pos, ring)
    got = da.decode_attention(q, k, v, qp, kp, window=window)
    want = da.decode_attention_plain(q, k, v, qp, kp, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_kernel_close(got, want, dtype)


def test_decode_kernel_row_does_not_depend_on_batch_or_capacity(cuda):
    """Fixed-length splits: a row's output is bit-identical alone, in a
    batch of 4, and against a larger cache whose extra slots are empty."""
    q, k, v, qp, kp = _decode_case(cuda, torch.float32, 4, 512, 16, 8, 128,
                                   [200, 300, 64, 5], False)
    full = da.decode_attention(q, k, v, qp, kp)
    alone = da.decode_attention(q[1:2], k[1:2, :301], v[1:2, :301], qp[1:2],
                                kp[1:2, :301].contiguous())
    assert torch.equal(full[1:2], alone)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_merge_does_not_depend_on_arrival_order(cuda, dtype):
    """The splits merge in the launch that makes them: whichever block of
    a (row, kv head) arrives last merges all of them in split order, so
    20 launches on the same inputs give bit-identical outputs, and every
    ticket is back at 0 after each."""
    q, k, v, qp, kp = _decode_case(cuda, dtype, 4, 1100, 25, 5, 64,
                                   [1099, 700, 300, 30], False)
    first = da.decode_attention(q, k, v, qp, kp, window=1024)
    for _ in range(19):
        assert torch.equal(da.decode_attention(q, k, v, qp, kp, window=1024),
                           first)
    _, ticket = da._SCRATCH[q.device]
    assert not ticket.any()


def _assert_scaled(got, want, tol, roll_dim):
    """``chip_smoke.check_scaled``: ``atol`` = ``tol[0]`` x max |want|;
    the same limits refuse zeros and ``want`` rolled along ``roll_dim``."""
    atol = tol[0] * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=tol[1])
    for bad in (torch.zeros_like(want), want.roll(1, roll_dim)):
        assert not torch.allclose(bad.float(), want.float(), atol=atol,
                                  rtol=tol[1])


# row 3 with its log-sum-exp on one rank's slots of a sequence-sharded
# cache: B, Sk, H, KV, hd, the first slot's position, q_pos (a row whose
# q_pos is below the first slot has no valid slot: o 0, lse -inf)
DECODE_LSE_CASES = [
    (1, 2048, 16, 8, 128, 2048, [4607]),      # long_500k's ring on the card
    (8, 2048, 16, 8, 128, 30720,              # opt decode_32k at 16x16
     [32767] * 6 + [31000, 30000]),
    (3, 40, 4, 2, 32, 100, [139, 120, 99]),   # one split, a masked row
]
LSE_ATOL = 1e-4                               # fp32 in both versions


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_LSE_CASES)
def test_decode_kernel_lse_matches_plain_version(cuda, dtype, case):
    """``return_lse``: o as the plain version's (bf16 scaled to max
    |want|, ``chip_smoke.check_scaled``), equal bit for bit to the
    launch without the lse; the lse within 1e-4 where finite and -inf
    exactly where the plain version's is."""
    B, Sk, H, KV, hd, first, q_pos = case
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=g).to(device=cuda, dtype=dtype)
               for s in ((B, 1, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    qp = torch.tensor(q_pos, dtype=torch.int32, device=cuda)
    kp = (first + torch.arange(Sk, dtype=torch.int32, device=cuda))[None] \
        .repeat(B, 1)
    o, lse = da.decode_attention(q, k, v, qp, kp, return_lse=True)
    want, want_lse = da.decode_attention_plain(q, k, v, qp, kp,
                                               return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    if dtype == torch.float32:
        _assert_kernel_close(o, want, dtype)
    else:
        _assert_scaled(o, want, TOL[dtype], 2)
    assert torch.equal(o, da.decode_attention(q, k, v, qp, kp))
    empty = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), empty)
    assert empty.any() == any(p < first for p in q_pos)
    torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=LSE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_empty_shard_launches_nothing(cuda, dtype):
    """A rank with no slots of a sequence-sharded cache (DTensor's uneven
    chunks): o 0 and lse -inf, with no launch."""
    q = torch.randn(2, 1, 4, 64, device=cuda).to(dtype)
    k = torch.zeros(2, 0, 2, 64, device=cuda, dtype=dtype)
    qp = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    kp = torch.zeros(2, 0, dtype=torch.int32, device=cuda)
    before = da.LAUNCHES["decode_attention"]
    o, lse = da.decode_attention(q, k, k, qp, kp, return_lse=True)
    assert da.LAUNCHES["decode_attention"] == before
    assert o.dtype == dtype and not o.any() and torch.isneginf(lse).all()


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


def test_whisper_serving_and_decode_on_the_card_run_the_kernels(cuda):
    """whisper-base (smoke widths, 3 decoder layers) on the card: a
    re-aligned plan serves requests whose fragments read the encoder's
    memory, each result equal to its own forward, launching
    ``flash_attention_lse`` (self and cross); prefill + decode_step
    greedy streams equal the forward re-run on the grown sequence and
    launch ``decode_attention`` (self) and ``flash_attention_lse`` (the
    cross-attention at Sq = 1)."""
    from repro_torch.core import Fragment
    from repro_torch.models import encode_audio, forward, make_extras
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.serving import GraftExecutor, ServeRequest
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           mixed_depth_plan, smoke_setup)

    cfg, book, params = smoke_setup("whisper-base", n_layers=3)
    gen = torch.Generator(device=cuda).manual_seed(0)
    frags = [Fragment(cfg.name, p, 50.0, 30.0, client=f"c{i}")
             for i, p in enumerate((0, 1, 1))]
    rng = np.random.RandomState(0)
    reqs = []
    for f, n in zip(frags, (17, 40, 9)):
        ex = make_extras(cfg, 1, gen)
        ex["memory"] = encode_audio(params, cfg, ex["frames"])
        reqs.append((ServeRequest(client=f.client, extras=ex,
                                  tokens=rng.randint(0, cfg.vocab_size, n)
                                  .astype(np.int32)), f.p))
    fa.reset_launches()
    da.reset_launches()
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params,
                       cfg) as ex:
        ex.serve(reqs)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_lse"] > 0
    check_against_monolithic(cfg, params, reqs)
    fa.reset_launches()
    for req, _ in reqs[:2]:
        frames = {"frames": req.extras["frames"]}
        toks = torch.as_tensor(req.tokens, device=cuda)[None]
        with torch.no_grad():
            logits, cache = prefill(params, cfg, toks, extras=frames,
                                    cache_seq=toks.shape[1] + 6)
            out = [int(logits[0, -1].argmax())]
            for _ in range(5):
                step = torch.tensor([[out[-1]]], dtype=torch.int32,
                                    device=cuda)
                logits, cache = decode_step(params, cfg, cache, step)
                out.append(int(logits[0, -1].argmax()))
            seq = torch.cat([toks[0], torch.tensor(out, device=cuda,
                                                   dtype=toks.dtype)])
            full = forward(params, cfg, seq[None], extras=frames)[0][0]
        assert out == full[toks.shape[1] - 1:-1].argmax(-1).tolist()
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode_attention"] > 0
    assert fa.LAUNCHES["flash_attention_lse"] > 0


# ------------------------------------------------------- recurrent scans

def _ssm_case(device, dtype, B, T, H, hd, N, dt_scale=0.2, seed=0):
    """x, Bm, Cm in ``dtype``; dt, A and the (nonzero) state float32."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g)              # noqa: E731
    x = (rn(B, T, H, hd) * 0.5).to(device=device, dtype=dtype)
    dt = (torch.nn.functional.softplus(rn(B, T, H)) * dt_scale).to(device)
    A = (-rn(H).abs() * 4).to(device)
    Bm = (rn(B, T, N) * 0.5).to(device=device, dtype=dtype)
    Cm = (rn(B, T, N) * 0.5).to(device=device, dtype=dtype)
    h0 = (rn(B, H, hd, N) * 0.1).to(device)
    return x, dt, A, Bm, Cm, h0


def _wkv_case(device, dtype, B, T, H, hd, w=None, seed=0):
    """r, k, v in ``dtype``; w, u and the (nonzero) state float32."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g)              # noqa: E731
    r, k, v = ((rn(B, T, H, hd) * 0.5).to(device=device, dtype=dtype)
               for _ in range(3))
    w = torch.sigmoid(rn(B, T, H, hd)) * 0.85 + 0.1 if w is None else \
        torch.full((B, T, H, hd), float(w))
    u = rn(H, hd) * 0.1
    s0 = rn(B, H, hd, hd) * 0.1
    return r, k, v, w.to(device), u.to(device), s0.to(device)


SSM_CASES = [  # B, T, H, hd, N, dt scale
    (1, 512, 50, 64, 16, 0.2),          # hymba main path
    (1, 32, 1, 16, 8, 0.2), (2, 128, 3, 32, 16, 0.2), (2, 96, 2, 64, 16, 0.2),
    (1, 1, 50, 64, 16, 0.2),            # T = 1
    (2, 37, 4, 64, 16, 0.2),            # prime T
    (1, 100, 8, 64, 16, 0.2),           # T not a multiple of 32
    (1, 64, 2, 16, 8, 50.0),            # dt * A far below -2.5
    (1, 200, 4, 64, 16, 50.0),          # the same over 4 chunks, ragged
    (1, 130, 2, 128, 32, 0.2),          # the widest state, 128 x 32
    (2, 70, 3, 24, 16, 0.2),            # hd padded to 32 in the kernel
    (1, 50, 2, 8, 4, 0.2),              # hd 8, N 4: B and C element-wise
]
WKV_CASES = [  # B, T, H, hd, w (None: random decays)
    (1, 512, 64, 64, None),             # rwkv6 main path
    (1, 32, 1, 16, None), (2, 128, 3, 32, None), (2, 96, 2, 64, None),
    (1, 1, 64, 64, None), (2, 37, 4, 64, None), (1, 100, 8, 64, None),
    (1, 64, 2, 16, 1e-6),               # decay far below the clamp
    (1, 200, 4, 64, 1e-6),              # the same over 4 chunks, ragged
    (1, 64, 8, 64, None), (2, 65, 4, 64, None),   # one chunk, one step past
    (2, 150, 4, 16, None), (1, 250, 4, 32, None),  # hd 16, 32: many chunks
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_kernel_matches_plain_version(cuda, dtype, case):
    *shape, dt_scale = case
    args = _ssm_case(cuda, dtype, *shape, dt_scale=dt_scale)
    y, h = ss.ssm_scan(*args)
    y2, h2 = ss.ssm_scan_plain(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    _assert_kernel_close(y, y2, dtype)
    _assert_kernel_close(h, h2, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_row_does_not_depend_on_length_or_batch(cuda, dtype):
    """Fixed 64-step chunks from t = 0 and fixed summation orders: y[:, :t]
    is bit-identical for a call of length t and one of length T > t with
    the same prefix; the state after t steps equals the final state of
    the length-T call whose steps past t are no-ops (dt = 0: no decay,
    no update); and a row's y and state are the same alone as in a
    batch of 3."""
    x, dt, A, Bm, Cm, h0 = _ssm_case(cuda, dtype, 3, 300, 4, 64, 16)
    t = 150                             # chunks 0 and 1, then 22 steps
    y, s = ss.ssm_scan(x, dt, A, Bm, Cm, h0)
    y_t, s_t = ss.ssm_scan(x[:, :t], dt[:, :t], A, Bm[:, :t], Cm[:, :t], h0)
    assert torch.equal(y[:, :t], y_t)
    dt0 = dt.clone()
    dt0[:, t:] = 0
    y0, s0 = ss.ssm_scan(x, dt0, A, Bm, Cm, h0)
    assert torch.equal(y0[:, :t], y_t) and torch.equal(s0, s_t)
    y1, s1 = ss.ssm_scan(x[1:2], dt[1:2], A, Bm[1:2], Cm[1:2], h0[1:2])
    assert torch.equal(y1, y[1:2]) and torch.equal(s1, s[1:2])
    _, ticket = ss._SCRATCH[x.device]
    assert not ticket.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_plain_version(cuda, dtype, case):
    *shape, w = case
    args = _wkv_case(cuda, dtype, *shape, w=w)
    o, s = wk.wkv6_scan(*args)
    o2, s2 = wk.wkv6_scan_plain(*args)
    assert o.dtype == dtype and s.dtype == torch.float32
    assert torch.isfinite(o.float()).all() and torch.isfinite(s).all()
    _assert_kernel_close(o, o2, dtype)
    _assert_kernel_close(s, s2, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_row_does_not_depend_on_length_or_batch(cuda, dtype):
    """Fixed 64-step chunks from t = 0, masks by select and fixed
    summation orders: o[:, :t] is bit-identical for a call of length t and
    one of length T > t with the same prefix, and a row's o and state are
    the same alone as in a batch of 3 (the carry takes no ticket: it is a
    launch of its own)."""
    r, k, v, w, u, s0 = _wkv_case(cuda, dtype, 3, 300, 4, 64)
    t = 150                             # chunks 0 and 1, then 22 steps
    o, s = wk.wkv6_scan(r, k, v, w, u, s0)
    o_t, _ = wk.wkv6_scan(r[:, :t], k[:, :t], v[:, :t], w[:, :t], u, s0)
    assert torch.equal(o[:, :t], o_t)
    o1, s1 = wk.wkv6_scan(r[1:2], k[1:2], v[1:2], w[1:2], u, s0[1:2])
    assert torch.equal(o1, o[1:2]) and torch.equal(s1, s[1:2])


def test_scan_kernels_read_strided_views_and_count_launches(cuda):
    """Head-interleaved views (the models' reshaped projections) need no
    copy; each launch counts once, the plain versions never."""
    before = (ss.LAUNCHES["ssm_scan"], wk.LAUNCHES["wkv6_scan"])
    x, dt, A, Bm, Cm, h0 = _ssm_case(cuda, torch.bfloat16, 2, 40, 6, 32, 16)
    xw = torch.zeros(2, 40, 6, 64, dtype=torch.bfloat16, device=cuda)
    xw[..., :32] = x
    y, h = ss.ssm_scan(xw[..., :32], dt, A, Bm, Cm, h0)
    y2, h2 = ss.ssm_scan(x, dt, A, Bm, Cm, h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    r, k, v, w, u, s0 = _wkv_case(cuda, torch.float32, 2, 40, 4, 32)
    o, s = wk.wkv6_scan(r, k, v, w, u, s0)
    wk.wkv6_scan_plain(r, k, v, w, u, s0)
    ss.ssm_scan_plain(x, dt, A, Bm, Cm, h0)
    assert (ss.LAUNCHES["ssm_scan"], wk.LAUNCHES["wkv6_scan"]) == \
        (before[0] + 2, before[1] + 1)
    with pytest.raises(ValueError, match="on cpu"):
        wk.wkv6_scan(r, k, v, w.cpu(), u, s0)
    with pytest.raises(TypeError):
        ss.ssm_scan(x, dt.to(torch.bfloat16), A, Bm, Cm, h0)


def test_hybrid_serving_on_the_card_runs_the_scan_kernel(cuda):
    """A tiny hymba (3 layers at smoke width, head_dim 16 raised to 32 for
    the attention kernels) through the padded one-shot path and decode:
    the scan kernel launches in both, and the results equal the port's
    monolithic forward and unbatched reference."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import Fragment, ProfileBook, arch_layer_costs
    from repro_torch.models import init_params
    from repro_torch.serving import GraftExecutor, ServeRequest
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           decode_plan, drive_decode,
                                           mixed_depth_plan, reference_decode)

    cfg = dataclasses.replace(reduced(get_config("hymba-1.5b"), n_layers=3),
                              head_dim=32)
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(cfg, seq_len=16),
                                 name=cfg.name))
    params = init_params(cfg, seed=0)
    frags = [Fragment(cfg.name, p, 50.0, 30.0, client=f"c{i}")
             for i, p in enumerate((0, 1, 1))]
    rng = np.random.RandomState(0)
    reqs = [(ServeRequest(client=f.client,
                          tokens=rng.randint(0, cfg.vocab_size, n)
                          .astype(np.int32)), f.p)
            for f, n in zip(frags, (17, 90, 9))]
    ss.reset_launches()
    with GraftExecutor(mixed_depth_plan(cfg, book, frags, s=1), params,
                       cfg) as ex:
        ex.serve(reqs)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssm_scan"] > 0
    check_against_monolithic(cfg, params, reqs)
    prompts = [(f"c{i % 2}", rng.randint(0, cfg.vocab_size, n)
                .astype(np.int32)) for i, n in enumerate((17, 40, 9))]
    ss.reset_launches()
    da.reset_launches()
    with GraftExecutor(decode_plan(cfg, book, frags[:2], batch=2), params,
                       cfg, decode_ctx=64, kv_block_tokens=8) as ex:
        r = drive_decode(ex, prompts, 6)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssm_scan"] >= len(prompts) * cfg.n_layers
    assert da.LAUNCHES["decode_attention"] > 0
    for (_, toks), got in zip(prompts, r["tokens"]):
        assert got == reference_decode(cfg, params, toks, 6)


# ------------------------------------------------------ attention backward

# the unsegmented CASES (among them hymba's GQA 5 with window 1024 at
# S = 1100, and q, k and v as fused-QKV slices) and the training main
# path: B, Sq, Sk, H, KV, hd, causal, window, fused qkv
BWD_CASES = [c[:8] + c[9:] for c in CASES if c[8] is None] + [
    (2, 512, 512, 16, 8, 128, True, 0, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_kernels_match_plain_version(cuda, dtype, case):
    """float32 on the scalar bodies, bfloat16 on the wgmma bodies."""
    B, Sq, Sk, H, KV, hd, causal, window, fused = case
    q, k, v, _ = _inputs(cuda, dtype, B, Sq, Sk, H, KV, hd, fused=fused)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)) \
        .to(device=cuda, dtype=dtype)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_lse_plain(q, k, v, **kw)
    got = fab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fab.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_kernel_close(g, w, dtype)


def test_backward_counts_launches_and_takes_a_strided_gradient(cuda):
    """dq and dkv count one launch each per backward; the trainable
    attention takes autograd's expanded (stride 0) incoming gradient."""
    q, k, v, _ = _inputs(cuda, torch.float32, 1, 70, 70, 4, 2, 64)
    before = dict(fab.LAUNCHES)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    fab.flash_attention_trainable(q, k, v).sum().backward()
    o, lse = fa.flash_attention_lse_plain(q.detach(), k.detach(), v.detach())
    want = fab.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), o, lse, torch.ones_like(o))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-3)
    assert fab.LAUNCHES == {n: c + 1 for n, c in before.items()}


@pytest.mark.parametrize("reduce", ["all", "over B, S and heads"])
def test_bf16_backward_takes_an_expanded_gradient(cuda, reduce):
    """The trainable attention in bf16 takes autograd's stride-0 dO: of
    ``o.sum()`` (every stride 0) and of ``(o.sum((0, 1, 2)) * w).sum()``
    (a contiguous head_dim axis, the rest stride 0, which TMA cannot
    read): the kernels get a packed copy, launch once each, and match
    the plain backward on the materialised dO."""
    q, k, v, _ = _inputs(cuda, torch.bfloat16, 2, 150, 150, 8, 2, 64)
    w = torch.randn(64, generator=torch.Generator().manual_seed(2)).to(
        device=cuda, dtype=torch.bfloat16)
    before = dict(fab.LAUNCHES)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = fab.flash_attention_trainable(q, k, v)
    if reduce == "all":
        o.sum().backward()
        do = torch.ones_like(o)
    else:
        (o.sum((0, 1, 2)) * w).sum().backward()
        do = w.expand(o.shape).contiguous()
    assert fab.LAUNCHES == {n: c + 1 for n, c in before.items()}
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o2, lse = fa.flash_attention_lse_plain(qd, kd, vd)
    want = fab.flash_attention_bwd_plain(qd, kd, vd, o2, lse, do)
    atol, rtol = TOL[torch.bfloat16]
    for g, ref in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g.float(), ref.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_deterministic(cuda, dtype):
    """Each output element has one owner (no atomics): two launches of
    each kernel on the same inputs give bit-identical dq, D, dk and dv."""
    q, k, v, _ = _inputs(cuda, dtype, 2, 300, 300, 8, 2, 128)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)) \
        .to(device=cuda, dtype=dtype)
    o, lse = fa.flash_attention_lse(q, k, v)
    dq1, d1 = fab.launch_dq(q, k, v, o, lse, do)
    dq2, d2 = fab.launch_dq(q, k, v, o, lse, do)
    dk1, dv1 = fab.launch_dkv(q, k, v, lse, do, d1)
    dk2, dv2 = fab.launch_dkv(q, k, v, lse, do, d2)
    torch.cuda.synchronize()
    for a, b in ((dq1, dq2), (d1, d2), (dk1, dk2), (dv1, dv2)):
        assert torch.equal(a, b)


def test_backward_launches_refuse_bf16_views_tma_cannot_read(cuda):
    """launch_dq and launch_dkv raise on a bf16 q or dO whose base is off
    16 bytes, before any launch; the same views in float32 run on the
    scalar bodies and match the plain backward."""
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.randn(1, 80, 4 * 32 + 1,
                          generator=torch.Generator().manual_seed(0))
        q = buf.to(device=cuda, dtype=dtype)[:, :, 1:].unflatten(2, (4, 32))
        k, v = (torch.randn(1, 80, 2, 32, generator=torch.Generator()
                            .manual_seed(s)).to(device=cuda, dtype=dtype)
                for s in (1, 2))
        do = torch.flip(q, (1,))
        o, lse = fa.flash_attention_lse_plain(q, k, v)
        before = dict(fab.LAUNCHES)
        if dtype == torch.bfloat16:
            dvec = torch.zeros_like(lse)
            with pytest.raises(ValueError, match="TMA"):
                fab.launch_dq(q, k, v, o, lse, q.contiguous())
            with pytest.raises(ValueError, match="TMA"):
                fab.launch_dkv(q.contiguous(), k, v, lse, q, dvec)
            assert fab.LAUNCHES == before
        else:
            got = fab.flash_attention_bwd(q, k, v, o, lse, do)
            want = fab.flash_attention_bwd_plain(q, k, v, o, lse, do)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-3)


def test_train_step_on_the_card_runs_the_backward_kernels(cuda):
    """One make_train_step step of a 2-layer qwen3 smoke model (head_dim
    32) on the card launches dq and dkv once per layer and the forward
    twice (remat recomputes it), and its loss and new params equal the
    same step on the CPU (plain attention)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import token_batches
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), head_dim=32)
    params = init_params(cfg, seed=0)
    batch = next(token_batches(batch=2, seq_len=40, vocab=cfg.vocab_size))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    fa.reset_launches()
    fab.reset_launches()
    p1, _, m = step(params, init_opt_state(params), batch)
    torch.cuda.synchronize()
    assert fab.LAUNCHES == {"flash_attention_bwd_dq": cfg.n_layers,
                            "flash_attention_bwd_dkv": cfg.n_layers}
    assert fa.LAUNCHES["flash_attention_lse"] == 2 * cfg.n_layers
    cpu = tree_map(lambda t: t.cpu(), params)
    p2, _, m2 = step(cpu, init_opt_state(cpu), batch)
    assert abs(float(m["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


def test_kernels_without_backward_refuse_inputs_that_require_grad(cuda):
    """The segmented attention, decode and scan kernels have no backward:
    where autograd records, an input that requires grad raises instead
    of coming back without a grad_fn; under no_grad they run."""
    q, k, v, seg = _inputs(cuda, torch.float32, 1, 64, 64, 4, 2, 64, [30])
    qd, kd, vd, qp, kp = _decode_case(cuda, torch.float32, 2, 70, 4, 2, 64,
                                      [69, 30], False)
    ssm = _ssm_case(cuda, torch.float32, 1, 40, 2, 32, 16)
    wkv = _wkv_case(cuda, torch.float32, 1, 40, 2, 32)
    calls = {
        "flash_attention": (lambda t: fa.flash_attention(t, k, v, seg), q),
        "decode_attention": (
            lambda t: da.decode_attention(t, kd, vd, qp, kp), qd),
        "ssm_scan": (lambda t: ss.ssm_scan(t, *ssm[1:]), ssm[0]),
        "wkv6_scan": (lambda t: wk.wkv6_scan(t, *wkv[1:]), wkv[0]),
    }
    for name, (call, x) in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call(x.clone().requires_grad_(True))
        with torch.no_grad():
            call(x.clone().requires_grad_(True))
        call(x)


# ------------------------------------------------------------- the server

def test_server_one_shot_drivers_beside_decode_on_one_card(cuda):
    """The event-driven server on the card: one-shot clients at three
    partition points (their pool drivers and the ingest threads' mobile
    parts launch kernels) while a decode client streams through the
    continuous batch on its own driver thread. Every thread launches on
    the device's one stream, which the decode kernel's shared scratch
    and tickets assume: the decode tokens must equal the unbatched
    reference exactly, and the one-shot results the monolithic forward
    (float32 ``atol=5e-5, rtol=1e-3``)."""
    import time

    from repro_torch.core import Fragment, GraftPlanner
    from repro_torch.serving import (GraftExecutor, GraftServer,
                                     ServeRequest)
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           reference_decode, smoke_setup)

    cfg, book, params = smoke_setup("qwen3-1.7b", n_layers=4)
    frags = [Fragment(cfg.name, p, 4000.0, 30.0, client=f"c{p}")
             for p in (1, 2, 3)] + [Fragment(cfg.name, 0, 4000.0, 30.0,
                                             client="dec")]
    rng = np.random.RandomState(0)
    da.reset_launches()
    fa.reset_launches()
    ex = GraftExecutor(GraftPlanner(book).plan(frags), params, cfg,
                       decode_ctx=96, kv_blocks=64, kv_block_tokens=8)
    server = GraftServer(ex, book=book).start()
    oneshot, streams = [], []
    try:
        for i in range(6):
            toks = rng.randint(0, cfg.vocab_size, int(rng.randint(9, 40))
                               ).astype(np.int32)
            req = ServeRequest(client="dec", tokens=toks, max_new_tokens=12)
            server.submit(req, 0, 4000.0)
            streams.append(req)
            for f in frags[:3]:
                r = ServeRequest(client=f.client, tokens=rng.randint(
                    0, cfg.vocab_size, int(rng.randint(16, 64)))
                    .astype(np.int32))
                server.submit(r, f.p, f.t)
                oneshot.append((r, f.p))
            time.sleep(0.005)
        assert server.join(timeout=300.0), "the server never drained"
        rep = server.report()
    finally:
        server.stop(drain=False, timeout=10.0)
        ex.close()
    torch.cuda.synchronize()
    assert rep["decode_local"] == 0 and rep["local_finishes"] == 0
    assert rep["decode_served"] == len(streams)
    assert rep["served"] == len(streams) + len(oneshot)
    assert da.LAUNCHES["decode_attention"] > 0
    assert fa.LAUNCHES["flash_attention"] > 0            # packed pools
    assert fa.LAUNCHES["flash_attention_lse"] > 0        # mobile parts
    for req in streams:
        assert req.out_tokens == reference_decode(cfg, params, req.tokens,
                                                  12)
    check_against_monolithic(cfg, params, oneshot)


# ------------------------------------------------- workers and the fleet

def test_remote_workers_on_the_card_equal_the_in_process_pools(cuda):
    """Two pool workers on cuda:0 (each its own process and CUDA
    context, holding only its pool's parameter slice) serve what the
    in-process pools serve, float32 ``atol=5e-5, rtol=1e-3``; the
    forward kernels launch inside the workers, whose counters ride back
    on the stats op."""
    from repro_torch.core import Fragment, GraftPlanner
    from repro_torch.serving import (GraftExecutor, RemoteExecutor,
                                     SocketTransport)
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           smoke_requests, smoke_setup)

    cfg, book, params = smoke_setup("qwen3-1.7b", n_layers=4)
    frags = [Fragment(cfg.name, 0, 4000.0, 30.0, client="c0"),
             Fragment(cfg.name, 2, 4000.0, 30.0, client="c1")]
    plan = GraftPlanner(book).plan(frags)
    reqs_a = smoke_requests(cfg, frags, seq_len=48, seed=3)
    reqs_b = smoke_requests(cfg, frags, seq_len=48, seed=3)
    with GraftExecutor(plan, params, cfg) as ex:
        ex.serve(reqs_a)
    with RemoteExecutor(plan, params, cfg,
                        transport=SocketTransport()) as rex:
        assert rex.n_stage_pools == 2
        assert all(s["device"].startswith("cuda")
                   for s in rex.pool_stats().values())
        rex.kernel_launches(reset=True)
        rex.serve(reqs_b)
        launches = rex.kernel_launches()
    for (a, _), (b, _) in zip(reqs_a, reqs_b):
        np.testing.assert_allclose(b.result.numpy(), a.result.numpy(),
                                   atol=5e-5, rtol=1e-3)
    check_against_monolithic(cfg, params, reqs_b)
    assert launches["flash_attention"] > 0, launches     # packed pools


def test_fleet_decode_tokens_on_the_card_equal_a_single_server(cuda):
    """Two front-ends of a GraftFleet over one decode pool on the card
    give every stream the tokens a lone GraftServer gives it."""
    from repro_torch.core import Fragment
    from repro_torch.serving import (GraftExecutor, GraftFleet, GraftServer,
                                     ServeRequest)
    from repro_torch.serving.smoke import decode_plan, smoke_setup

    cfg, book, params = smoke_setup("qwen3-1.7b", n_layers=4)
    frags = [Fragment(cfg.name, 0, 4000.0, 30.0, client=f"d{i}")
             for i in range(4)]
    rng = np.random.RandomState(1)
    prompts = [(f"d{i % 4}", rng.randint(0, cfg.vocab_size,
                                         int(rng.randint(9, 40)))
                .astype(np.int32)) for i in range(8)]

    def run(make):
        ex = GraftExecutor(decode_plan(cfg, book, frags, batch=4), params,
                           cfg, decode_ctx=96, kv_blocks=64,
                           kv_block_tokens=8)
        srv = make(ex).start()
        reqs = [ServeRequest(client=c, tokens=t, max_new_tokens=10)
                for c, t in prompts]
        try:
            for r in reqs:
                srv.submit(r, 0, 4000.0)
            assert srv.join(timeout=300.0)
            rep = srv.report()
        finally:
            srv.stop(drain=False, timeout=10.0)
            ex.close()
        assert rep["decode_local"] == 0 and rep["shed"] == 0
        return [r.out_tokens for r in reqs], rep

    single, _ = run(lambda ex: GraftServer(ex, book=book))
    fleet, rep = run(lambda ex: GraftFleet(ex, n_frontends=2, book=book))
    assert fleet == single
    assert sum(1 for fe in rep["frontends"].values() if fe["served"]) == 2


def test_build_lock_compiles_each_source_once_across_processes(
        cuda, tmp_path):
    """Two processes that call ``build_all`` at once on a cold build
    directory: one compiles, the other waits on the file lock and finds
    the library built."""
    import ctypes
    import json
    import os
    import subprocess
    import sys
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "tiny.cu").write_text(
        'extern "C" __global__ void tiny_kernel(int *x) { x[0] = 7; }\n'
        'extern "C" int tiny_entry() { return 7; }\n')
    out_dir = tmp_path / "kernels"
    code = ("import json; from pathlib import Path; "
            "from repro_torch.kernels import build; "
            f"build.CSRC = Path({str(csrc)!r}); "
            f"build.BUILD_DIR = Path({str(out_dir)!r}); "
            "print(json.dumps(sorted(build.build_all())))")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    built = sorted(json.loads(o.strip().splitlines()[-1]) for o, _ in outs)
    assert built == [[], ["tiny"]]
    (lib,) = out_dir.glob("tiny-*.so")
    assert ctypes.CDLL(str(lib)).tiny_entry() == 7


# ---------------------------------------------------------------------------
# the workload shapes at full width (launch/specs.py): 32,768 tokens
# ---------------------------------------------------------------------------

def _assert_scaled_close(got, want):
    """bf16's tolerance with ``atol`` scaled to max |want|: over 32,768
    keys |o| is about 0.01, below a fixed atol of 2e-2. The same limits
    refuse an all-zero output and ``want`` with its heads (dim 2) rolled
    by one."""
    atol, rtol = TOL[torch.bfloat16]
    atol *= want.float().abs().max().item()
    for bad in (torch.zeros_like(want), want.roll(1, 2)):
        assert not torch.allclose(bad.float(), want.float(), atol=atol,
                                  rtol=rtol)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_prefill_kernel_at_32k_tokens_matches_plain_last_rows(cuda):
    """Row 2 at qwen3-1.7b's prefill_32k width (Sq = Sk = 32,768, 16
    heads of 128 over 8 kv, bf16): the last 512 query rows of o and lse
    against the plain version over those rows and every key, o at a
    tolerance scaled to its size."""
    from repro_torch.kernels import ref
    B, S, H, KV, hd, n = 1, 32768, 16, 8, 128, 512
    q, k, v, _ = _inputs(cuda, torch.bfloat16, B, S, S, H, KV, hd, seed=7)
    o, lse = fa.flash_attention_lse(q, k, v)
    ar = torch.arange(S, dtype=torch.int32, device=cuda)[None]
    want_o, want_lse = ref.ref_attention(
        q[:, S - n:], k, v, q_pos=ar[:, S - n:], kv_pos=ar, causal=True,
        return_lse=True)
    torch.cuda.synchronize()
    _assert_scaled_close(o[:, S - n:], want_o)
    torch.testing.assert_close(lse[:, :, S - n:], want_lse, atol=1e-4,
                               rtol=0.0)


def test_decode_kernel_at_32k_slots_matches_plain(cuda):
    """Row 3 against a 32,768-slot cache, every slot valid (qwen3's
    decode_32k at batch 4, bf16), and the same cache as a ring past the
    window with -1 holes, at a tolerance scaled to the output's size."""
    B, Sk, H, KV, hd = 4, 32768, 16, 8, 128
    g = torch.Generator().manual_seed(3)
    q = torch.randn((B, 1, H, hd), generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, Sk, KV, hd), generator=g)
            .to(cuda, torch.bfloat16) for _ in range(2))
    q_pos = torch.full((B,), Sk - 1, dtype=torch.int32, device=cuda)
    kv_pos = torch.arange(Sk, dtype=torch.int32,
                          device=cuda)[None].expand(B, Sk).contiguous()
    got = da.decode_attention(q, k, v, q_pos, kv_pos)
    want = da.decode_attention_plain(q, k, v, q_pos, kv_pos)
    torch.cuda.synchronize()
    _assert_scaled_close(got, want)
    ring = kv_pos + 40000                  # positions 40000 on, -1 holes
    ring[:, ::7] = -1
    q_pos = q_pos + 40000
    got = da.decode_attention(q, k, v, q_pos, ring, window=20000)
    want = da.decode_attention_plain(q, k, v, q_pos, ring, window=20000)
    torch.cuda.synchronize()
    _assert_scaled_close(got, want)


def test_dryrun_on_the_card_machine(cuda):
    """launch/dryrun.py runs on meta wherever the card is: one combo at
    one H100 and at the 16x16 mesh, whose collectives it counts on a fake
    group (none on one card)."""
    from repro_torch.distributed import spmd
    from repro_torch.launch import dryrun
    recs = {mesh: dryrun.dryrun_one("qwen3-1.7b", "decode_32k", mesh=mesh,
                                    batch=4, verbose=False)
            for mesh in ("1xH100", "16x16")}
    for rec in recs.values():
        assert rec["ok"], rec.get("error")
        assert rec["roofline"]["flops"] > 0
    assert recs["1xH100"]["collectives"] is None
    coll = recs["16x16"]["collectives"]
    assert coll["bytes"] > 0 and set(coll["per_op"]) <= set(spmd.COLLECTIVES)
    one = recs["1xH100"]["memory"]["argument_bytes"]
    assert recs["16x16"]["memory"]["argument_bytes"] < one
    assert recs["1xH100"]["fits_80gb"] and one > 15e9     # the 15 GB cache


# ---------------------------------------------------------------------------
# expert parallelism: ranks sharing the card over gloo
# ---------------------------------------------------------------------------

def _ep_card_rank(rank, n):
    """One rank of ``test_expert_parallel_on_the_card_equals_grouped``:
    layer 0's MoE of the olmoe smoke config on the card, its own slice of
    the experts under ``moe_mesh``, against ``grouped`` with every expert
    in this process."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import actspec
    from repro_torch.distributed.sharding import to_device_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import torch_dtype
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dm = to_device_mesh(make_host_mesh(model=n), "cuda")
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                                  dtype=dtype, moe_impl="expert_parallel")
        p = {k: v[0] for k, v in
             init_params(cfg, seed=1, device=dev)["blocks"]["moe"].items()}
        g = torch.Generator().manual_seed(2)
        x = (torch.randn((2, 64, cfg.d_model), generator=g) * 0.5).to(
            dev, torch_dtype(dtype))
        want, aux_want = moe_mod.moe_forward(p, cfg, x, impl="grouped")
        mine = moe_mod.shard_experts(p, rank, n)
        with torch.no_grad(), actspec.moe_mesh(dm):
            got, aux = moe_mod.moe_forward(mine, cfg, x)
        torch.cuda.synchronize()
        assert got.dtype == x.dtype and float(aux) == float(aux_want)
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-3)
        else:
            _assert_scaled_close(got, want)


def test_expert_parallel_on_the_card_equals_grouped(cuda):
    """2 gloo ranks sharing the card, each with half the experts: the
    expert-parallel MoE equals ``grouped`` in float32 and, at the scaled
    bf16 check, in bfloat16."""
    from repro_torch.distributed.ranks import spawn_ranks
    spawn_ranks(_ep_card_rank, 2, timeout=300)
