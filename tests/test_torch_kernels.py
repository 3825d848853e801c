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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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
