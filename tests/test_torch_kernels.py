"""The port's attention (``repro_torch.kernels``) against the JAX package.

Same numpy inputs (from a seed) go through the JAX function and its
port. On the CPU the port's kernel wrappers run their plain PyTorch
versions; the JAX Pallas kernels run in interpret mode, as the JAX
package's own kernel tests run them. Tolerances: float32 everywhere,
``atol=2e-5, rtol=1e-3`` for outputs (the JAX kernel tests' float32
bound: only the summation order differs) and ``1e-5`` for the fp32
logsumexp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention_bwd import _flash_fwd as j_flash_fwd
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssm_scan as tss
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6_scan as twk

ATOL, RTOL = 2e-5, 1e-3
LSE_ATOL = 1e-5


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, hd).astype(np.float32),
            rng.randn(B, Sk, KV, hd).astype(np.float32),
            rng.randn(B, Sk, KV, hd).astype(np.float32))


def _segments(B, S, splits):
    """(B, S) int32: row b packs segments of lengths splits[b], the rest
    is a pad segment with its own id."""
    seg = np.empty((B, S), np.int32)
    for b, lens in enumerate(splits):
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
        seg[b, :len(ids)] = ids
        seg[b, len(ids):] = len(lens)
    return seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


SHAPES = [(1, 64, 64, 1, 1, 32), (2, 128, 128, 4, 2, 32),
          (2, 96, 96, 6, 2, 64), (1, 256, 256, 8, 8, 16)]
SEGS = {64: [[20, 30]], 96: [[40, 25, 20], [10, 60, 26]],
        128: [[50, 60], [128]], 256: [[100, 90, 33]]}


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", SHAPES)
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("with_seg", [False, True])
def test_ref_attention_matches_jax(B, Sq, Sk, H, KV, hd, window, with_seg):
    q, k, v = _qkv(0, B, Sq, Sk, H, KV, hd)
    seg = _segments(B, Sq, (SEGS[Sq] * B)[:B]) if with_seg else None
    want = jref.ref_attention(q, k, v, seg_q=seg, seg_kv=seg, window=window)
    tseg = None if seg is None else torch.from_numpy(seg)
    got = tref.ref_attention(*_t(q, k, v), seg_q=tseg, seg_kv=tseg,
                             window=window)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_ref_attention_lse_rows(causal):
    """The oracle's logsumexp equals a direct logsumexp of the scaled
    scores, and a fully-masked row gives o = 0, lse = NEG_INF."""
    q, k, v = _qkv(1, 1, 8, 8, 2, 1, 16)
    seg = np.array([[0, 0, 1, 1, 1, 2, 2, 5]], np.int32)
    segk = np.array([[0, 0, 1, 1, 1, 2, 2, 3]], np.int32)
    o, lse = tref.ref_attention(*_t(q, k, v), seg_q=torch.from_numpy(seg),
                                seg_kv=torch.from_numpy(segk), causal=causal,
                                return_lse=True)
    assert torch.all(o[0, -1] == 0)
    assert torch.all(lse[0, :, -1] == tref.NEG_INF)
    s = torch.einsum("qhd,kd->hqk", torch.from_numpy(q[0]),
                     torch.from_numpy(k[0, :, 0])) * 16 ** -0.5
    m = torch.from_numpy(seg[0][:, None] == segk[0][None, :])
    if causal:
        m = m & torch.tril(torch.ones(8, 8, dtype=torch.bool))
    want = torch.logsumexp(s.masked_fill(~m, float("-inf")), dim=-1)
    _close(lse[0, :, :-1], want[:, :-1].numpy(), atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("window", [0, 24])
def test_chunked_attention_matches_jax(with_seg, window):
    """q chunks that do not divide S exercise the -2 q-pad segment
    sentinel of the chunked reference."""
    B, S, H, KV, hd = 2, 96, 4, 2, 32
    q, k, v = _qkv(2, B, S, S, H, KV, hd)
    seg = _segments(B, S, SEGS[96]) if with_seg else None
    want = jref.chunked_attention(q, k, v, seg_ids=seg, window=window,
                                  q_chunk=40)
    got = tref.chunked_attention(
        *_t(q, k, v), seg_ids=None if seg is None else torch.from_numpy(seg),
        window=window, q_chunk=40)
    _close(got, want)
    whole = tref.ref_attention(
        *_t(q, k, v), seg_q=None if seg is None else torch.from_numpy(seg),
        seg_kv=None if seg is None else torch.from_numpy(seg), window=window)
    _close(got, whole.numpy())


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 64, 2, 1, 32),
                                         (2, 96, 4, 2, 32),
                                         (1, 128, 8, 8, 16)])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("with_seg", [False, True])
def test_flash_attention_matches_pallas(B, S, H, KV, hd, window, with_seg):
    """Row 1: the port's ``flash_attention`` (plain version on the CPU)
    against the Pallas ``flash_attention`` in interpret mode, with
    segments starting mid-block."""
    q, k, v = _qkv(3, B, S, S, H, KV, hd)
    splits = {64: [[13, 40]], 96: [[40, 25, 20], [10, 60, 26]],
              128: [[7, 70, 30]]}[S]
    seg = _segments(B, S, splits) if with_seg else None
    want = j_flash(q, k, v, None if seg is None else jnp.asarray(seg),
                   causal=True, window=window, block_q=32, block_k=32,
                   interpret=True)
    got = tfa.flash_attention(
        *_t(q, k, v), None if seg is None else torch.from_numpy(seg),
        causal=True, window=window)
    _close(got, want)


def test_flash_attention_noncausal_matches_pallas():
    q, k, v = _qkv(4, 2, 64, 96, 4, 4, 32)
    want = j_flash(q, k, v, causal=False, block_q=32, block_k=32,
                   interpret=True)
    _close(tfa.flash_attention(*_t(q, k, v), causal=False), want)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 64, 2, 1, 32),
                                         (2, 96, 4, 2, 32),
                                         (1, 128, 8, 8, 16)])
@pytest.mark.parametrize("window", [0, 40])
def test_flash_attention_lse_matches_pallas(B, S, H, KV, hd, window):
    """Row 2: the port's ``flash_attention_lse`` against the Pallas
    ``_flash_fwd`` in interpret mode — both o and the logsumexp."""
    q, k, v = _qkv(5, B, S, S, H, KV, hd)
    scale = hd ** -0.5
    want_o, want_lse = j_flash_fwd(q, k, v, causal=True, window=window,
                                   scale=scale, bq=32, bk=32, interpret=True)
    o, lse = tfa.flash_attention_lse(*_t(q, k, v), causal=True,
                                     window=window)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _close(o, want_o)
    _close(lse, want_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("with_seg", [False, True])
def test_ops_attention_matches_jax_reference(with_seg):
    B, S, H, KV, hd = 2, 96, 4, 2, 32
    q, k, v = _qkv(6, B, S, S, H, KV, hd)
    seg = _segments(B, S, SEGS[96]) if with_seg else None
    with jops.use_impl("reference"):
        want = jops.attention(q, k, v, causal=True, window=24,
                              seg_ids=None if seg is None
                              else jnp.asarray(seg))
    got = tops.attention(*_t(q, k, v), causal=True, window=24,
                         seg_ids=None if seg is None
                         else torch.from_numpy(seg))
    _close(got, want)


def test_plain_bf16_matches_jax_bf16():
    """bf16 inputs: both sides compute in fp32 and round the output to
    bf16, so they agree to a bf16 ulp (2e-2 near |o| ~ 1)."""
    B, S, H, KV, hd = 1, 64, 4, 2, 32
    q, k, v = _qkv(7, B, S, S, H, KV, hd)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jref.ref_attention(jq, jk, jv)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = tfa.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), atol=2e-2, rtol=1e-2)


# ------------------------------------------------------ wrapper contract

def test_launch_counts_are_exact_across_threads():
    """The server's pool-driver and ingest threads count launches at
    once; no increment may be lost."""
    import threading
    counts = {"k": 0}

    def bump():
        for _ in range(20_000):
            tfa.count_launch(counts, "k")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts == {"k": 160_000}


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, k, v = _t(*_qkv(8, 1, 16, 16, 2, 1, 32))
    before = dict(tfa.LAUNCHES)
    o = tfa.flash_attention(q, k, v)
    o2, _ = tfa.flash_attention_lse(q, k, v)
    assert tfa.LAUNCHES == before
    _close(o, tfa.flash_attention_plain(q, k, v).numpy())
    _close(o2, o.numpy())


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        tfa.flash_attention(q, q[:, :, :1], q[:, :, :1])


def _bad_inputs():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    return {
        "head_dim": (torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                     torch.zeros(1, 8, 2, 48), None, 0, ValueError),
        "fp16": (q.half(), k.half(), k.half(), None, 0, TypeError),
        "mixed dtypes": (q, k.to(torch.bfloat16), k, None, 0, TypeError),
        "gqa": (torch.zeros(1, 8, 5, 32), k, k, None, 0, ValueError),
        "kv shape": (q, k, torch.zeros(1, 9, 2, 32), None, 0, ValueError),
        "strided hd": (q.transpose(2, 3).contiguous().transpose(2, 3), k, k,
                       None, 0, ValueError),
        "seg dtype": (q, k, k, seg.long(), 0, ValueError),
        "seg shape": (q, k, k, seg[:, :5], 0, ValueError),
        "seg cross": (q, torch.zeros(1, 9, 2, 32), torch.zeros(1, 9, 2, 32),
                      seg, 0, ValueError),
        "window": (q, k, k, None, -1, ValueError),
        # the bf16 kernel loads q, k and v by TMA: 16-byte aligned bases,
        # strides that are multiples of 16 bytes
        "bf16 base not 16-byte aligned": (
            torch.zeros(1 * 8 * 4 * 32 + 1, dtype=torch.bfloat16)[1:]
            .view(1, 8, 4, 32), k.bfloat16(), k.bfloat16(), None, 0,
            ValueError),
        "bf16 seq stride not a multiple of 16 bytes": (
            torch.zeros(1, 8, 4 * 32 + 4, dtype=torch.bfloat16)[:, :, :128]
            .unflatten(2, (4, 32)), k.bfloat16(), k.bfloat16(), None, 0,
            ValueError),
        "bf16 expanded (stride 0) along S": (
            torch.zeros(1, 1, 4, 32, dtype=torch.bfloat16).expand(1, 8, 4, 32),
            k.bfloat16(), k.bfloat16(), None, 0, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_launch_checks_refuse_what_the_kernel_cannot_take(case):
    q, k, v, seg, window, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        tfa._check(q, k, v, seg, window)


def test_launch_checks_accept_the_main_path_layout():
    q = torch.zeros(1, 40, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 40, 8, 128, dtype=torch.bfloat16)
    tfa._check(q, k, k, torch.zeros(1, 40, dtype=torch.int32), 0)


def test_launch_checks_accept_fused_qkv_slices():
    """q, k and v as slices of one fused (B, S, H + 2 KV, hd) bf16
    buffer: strided, yet every base and stride TMA reads is a multiple
    of 16 bytes."""
    H, KV = 16, 8
    qkv = torch.zeros(2, 40, H + 2 * KV, 128, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous() and k.data_ptr() % 16 == 0
    tfa._check(q, k, v, None, 0)


def test_tma_checks_apply_to_bf16_only():
    """float32 runs on the scalar kernel, which reads through plain
    loads: a view TMA could not take stays accepted there."""
    def view(dtype):
        return torch.zeros(1, 8, 4 * 32 + 1, dtype=dtype)[:, :, 1:] \
            .unflatten(2, (4, 32))
    q, k = view(torch.float32), torch.zeros(1, 8, 2, 32)
    assert q.data_ptr() % 16 and (q.stride(1) * 4) % 16
    tfa._check(q, k, k, None, 0)
    with pytest.raises(ValueError, match="TMA"):
        tfa._check(view(torch.bfloat16), k.bfloat16(), k.bfloat16(), None, 0)


# ------------------------------------- decode and SSM scan launch checks

def _decode_args(dtype=torch.bfloat16, B=2, Sk=70, H=4, KV=2, hd=64):
    q = torch.zeros(B, 1, H, hd, dtype=dtype)
    k = torch.zeros(B, Sk, KV, hd, dtype=dtype)
    return (q, k, k.clone(), torch.zeros(B, dtype=torch.int32),
            torch.zeros(B, Sk, dtype=torch.int32))


def _decode_bad():
    """The decode kernel reads q, k and v in 16-byte pieces (cp.async and
    vector loads): their bases and their B, S and head strides must be
    whole 16-byte units, in both dtypes."""
    q, k, v, qp, kp = _decode_args()
    off = torch.zeros(k.numel() + 1, dtype=torch.bfloat16)[1:].view(k.shape)
    wide = torch.zeros(2, 70, 2 * 64 + 4, dtype=torch.bfloat16)[:, :, :128] \
        .unflatten(2, (2, 64))
    q32, k32, _, _, _ = _decode_args(torch.float32)
    heads = torch.zeros(2, 70, 2, 66)[..., :64]
    return {
        "bf16 k base not 16-byte aligned": (q, off, v, qp, kp),
        "bf16 k seq stride not whole 16 bytes": (q, wide, v, qp, kp),
        "bf16 q base not 16-byte aligned": (
            torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:]
            .view(q.shape), k, v, qp, kp),
        "fp32 v head stride not whole 16 bytes": (q32, k32, heads, qp, kp),
    }


@pytest.mark.parametrize("case", sorted(_decode_bad()))
def test_decode_checks_refuse_views_it_cannot_read_in_16_bytes(case):
    with pytest.raises(ValueError, match="16"):
        tda._check(*_decode_bad()[case], 0)


def test_decode_checks_accept_cache_views():
    """The layer view of a larger cache (a prefix of its slots), an
    expanded batch (stride 0) and the main path's layout all pass."""
    q, k, v, qp, kp = _decode_args(B=4, Sk=512, H=16, KV=8, hd=128)
    tda._check(q, k, v, qp, kp, 0)
    big = torch.zeros(4, 600, 8, 128, dtype=torch.bfloat16)
    tda._check(q, big[:, :512], big[:, :512], qp, kp, 0)
    one = torch.zeros(1, 512, 8, 128, dtype=torch.bfloat16)
    tda._check(q, one.expand(4, -1, -1, -1), one.expand(4, -1, -1, -1), qp,
               kp, 1024)
    q32, k32, v32, _, _ = _decode_args(torch.float32, B=4, Sk=512, H=16,
                                       KV=8, hd=128)
    tda._check(q32, k32, v32, qp, kp, 0)


def test_decode_scratch_is_allocated_once_and_grown(monkeypatch):
    """The partial-state buffer and the tickets are kept per device and
    replaced only by larger ones; tickets start at zero."""
    monkeypatch.setattr(tda, "_SCRATCH", {})
    cpu = torch.device("cpu")
    part, ticket = tda.scratch(cpu, 4, 8, 2, 128, 8)
    assert part.numel() == 4 * 8 * 8 * 2 * (128 + 2)
    assert ticket.numel() == 32 and ticket.dtype == torch.int32
    assert not ticket.any()
    again = tda.scratch(cpu, 2, 8, 2, 64, 3)      # smaller: the same buffers
    assert again[0] is part and again[1] is ticket
    grown = tda.scratch(cpu, 4, 8, 2, 128, 17)    # more splits: a new part
    assert grown[0].numel() == 4 * 8 * 17 * 2 * 130 and grown[1] is ticket
    wider = tda.scratch(cpu, 8, 8, 2, 128, 1)     # more rows: new tickets
    assert wider[0] is grown[0] and wider[1].numel() == 64
    assert not wider[1].any()


def _ssm_args(dtype=torch.bfloat16, B=1, T=100, H=3, hd=64, N=16):
    return (torch.zeros(B, T, H, hd, dtype=dtype), torch.zeros(B, T, H),
            torch.zeros(H), torch.zeros(B, T, N, dtype=dtype),
            torch.zeros(B, T, N, dtype=dtype), torch.zeros(B, H, hd, N))


@pytest.mark.parametrize("hd, N, ok", [
    (64, 16, True), (16, 8, True), (8, 4, True), (128, 32, True),
    (24, 16, True),                      # hd padded to 32 inside the kernel
    (12, 16, False),                     # hd not a multiple of 8
    (136, 16, False),                    # hd past 128
    (64, 12, False), (64, 64, False),    # N not in STATE_DIMS
])
def test_ssm_checks_take_head_dims_of_8_up_to_128(hd, N, ok):
    args = _ssm_args(hd=hd, N=N)
    if ok:
        tss._check(*args)
    else:
        with pytest.raises(ValueError, match="state"):
            tss._check(*args)


def test_ssm_checks_take_any_length_and_strided_views():
    """Any T (the ragged last chunk is masked in the kernel), x as a
    head-interleaved view and dt as a slice; state must be contiguous."""
    for T in (1, 37, 64, 65, 2048):
        tss._check(*_ssm_args(T=T))
    x, dt, A, Bm, Cm, st = _ssm_args(T=40, H=6, hd=32)
    xw = torch.zeros(1, 40, 6, 64, dtype=torch.bfloat16)[..., :32]
    tss._check(xw, torch.zeros(1, 40, 12)[..., ::2], A, Bm, Cm, st)
    with pytest.raises(ValueError, match="contiguous"):
        tss._check(x, dt, A, Bm, Cm,
                   torch.zeros(1, 6, 16, 32).transpose(2, 3))


def test_ssm_reads_16_byte_pieces_only_where_aligned():
    """x, Bm and Cm go to the scan kernel with a flag: read in 16-byte
    pieces (aligned base, strides and rows of whole 16-byte units) or
    element by element (``unaligned`` says why not)."""
    x = torch.zeros(1, 40, 6, 64, dtype=torch.bfloat16)
    assert tfa.unaligned(x) is None and tfa.unaligned(x[..., :32]) is None
    assert "base" in tfa.unaligned(x[..., 1:33])
    assert "rows" in tfa.unaligned(
        torch.zeros(1, 40, 6 * 36, dtype=torch.bfloat16).view(1, 40, 6, 36))
    assert tfa.unaligned(torch.zeros(2, 40, 16, dtype=torch.bfloat16)) \
        is None
    assert "rows" in tfa.unaligned(torch.zeros(2, 40, 4,
                                               dtype=torch.bfloat16))
    assert tfa.unaligned(torch.zeros(2, 40, 4)) is None
    assert "stride" in tfa.unaligned(torch.zeros(2, 40, 5)[..., :4])


def test_ssm_scratch_is_allocated_once_and_grown(monkeypatch):
    """The chunk states and decays, and the tickets, are kept per device
    and replaced only by larger ones; tickets start at zero."""
    monkeypatch.setattr(tss, "_SCRATCH", {})
    cpu = torch.device("cpu")
    n_chunk = -(-512 // tss.CHUNK)
    states, ticket = tss.scratch(cpu, 1, 50, 64, 16, n_chunk)
    assert states.numel() == 50 * n_chunk * (64 * 16 + 1)
    assert ticket.numel() == 50 and not ticket.any()
    same = tss.scratch(cpu, 1, 8, 64, 8, 2)
    assert same[0] is states and same[1] is ticket
    longer = tss.scratch(cpu, 1, 50, 64, 16, -(-2048 // tss.CHUNK))
    assert longer[0].numel() == 50 * 32 * 1025 and longer[1] is ticket
    assert tss.scratch(cpu, 3, 50, 64, 16, 1)[1].numel() == 150


def _wkv_args(dtype=torch.bfloat16, B=1, T=100, H=3, hd=64):
    return (*(torch.zeros(B, T, H, hd, dtype=dtype),) * 3,
            torch.zeros(B, T, H, hd), torch.zeros(H, hd),
            torch.zeros(B, H, hd, hd))


def test_wkv6_checks_take_any_length_and_strided_views():
    """Any T (the kernel masks the ragged last 64-step chunk), r, k and v
    as head-interleaved views of one projection and w as a slice; u and
    the state must be contiguous."""
    for T in (1, 37, 64, 65, 2048):
        twk._check(*_wkv_args(T=T))
    r, k, v, w, u, st = _wkv_args(T=40, H=6, hd=32)
    rkv = torch.zeros(1, 40, 6, 3 * 32, dtype=torch.bfloat16)
    twk._check(rkv[..., :32], rkv[..., 32:64], rkv[..., 64:],
               torch.zeros(1, 40, 12, 32)[:, :, ::2], u, st)
    with pytest.raises(ValueError, match="contiguous"):
        twk._check(r, k, v, w, u, torch.zeros(1, 6, 32, 32).transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        twk._check(r, k, v, torch.zeros(1, 40, 6, 64)[..., ::2], u, st)
    with pytest.raises(ValueError, match="16-byte"):
        twk._check(r, k, v, w, u,
                   torch.zeros(6 * 32 * 32 + 1)[1:].view(1, 6, 32, 32))


def test_wkv6_scratch_is_allocated_once_and_grown(monkeypatch):
    """The chunk states and their decays are kept per device and
    replaced only by a larger buffer when a call needs more."""
    monkeypatch.setattr(twk, "_SCRATCH", {})
    cpu = torch.device("cpu")
    n_chunk = -(-512 // twk.CHUNK)
    states = twk.scratch(cpu, 1, 64, 64, n_chunk)
    assert states.numel() == 64 * n_chunk * (64 * 64 + 64)
    assert states.dtype == torch.float32
    assert twk.scratch(cpu, 2, 8, 32, 3) is states
    longer = twk.scratch(cpu, 1, 64, 64, -(-2048 // twk.CHUNK))
    assert longer.numel() == 64 * 32 * 4160
    assert twk.scratch(cpu, 3, 64, 64, 1) is longer
    assert twk.scratch(cpu, 3, 64, 64, 11).numel() == 3 * 64 * 11 * 4160


# ------------------------------------------------------------ the build

def test_kernel_library_name_hashes_the_shared_headers(tmp_path,
                                                       monkeypatch):
    """A library's file name hashes its source and every csrc/*.cuh, so
    an edited header (hopper.cuh, shared by the attention kernels) is
    rebuilt rather than a stale library loaded. No nvcc needed."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    src, header = csrc / "k.cu", csrc / "hopper.cuh"
    src.write_text('#include "hopper.cuh"\n')
    header.write_text("// v1\n")
    first = build._target(src)
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert build._target(src) == first
    header.write_text("// v2\n")
    second = build._target(src)
    assert second != first
    (csrc / "other.cuh").write_text("// new\n")
    assert build._target(src) not in (first, second)
    src.write_text('#include "hopper.cuh"\n// edited\n')
    assert build._target(src) not in (first, second)
