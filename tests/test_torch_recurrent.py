"""The port's recurrent families against the JAX package, on the CPU:
hymba (hybrid: attention + mamba2-style SSM heads) and rwkv6 (ssm: the
WKV6 time-mix), from the scan oracles up to served and decoded results.

Same numpy inputs (from a seed) and the same weights (the JAX init
converted by ``from_jax_params``) go through the JAX function and its
port. The JAX side runs its ``reference`` impl, and its Pallas scans
(``ssm_scan``, ``wkv6_scan``) in interpret mode; the port's scan wrappers
run their plain versions on CPU tensors. Tolerances: ``atol=5e-5,
rtol=1e-3`` for float32 outputs and states (the JAX kernel tests' own
scan bound), ``atol=1e-5, rtol=1e-4`` for a single op on small inputs,
``atol=1e-4, rtol=1e-3`` for multi-step decode against the full forward
(as ``tests/test_models.py``); greedy decode token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke_config
from repro.configs import reduced as j_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv6_scan as j_wkv6_scan
from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan
from repro.models import decode as jdec
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.serving import smoke as jsmoke
from repro_torch import models as TM
from repro_torch.configs import get_config, get_smoke_config, reduced
from repro_torch.core import Fragment, ProfileBook, arch_layer_costs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tss
from repro_torch.kernels import wkv6_scan as twk
from repro_torch.models import decode as tdec
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import _layer, slice_blocks
from repro_torch.serving import GraftExecutor, InProcessTransport, ServeRequest
from repro_torch.serving import smoke as tsmoke

ATOL, RTOL = 5e-5, 1e-3
OP_ATOL, OP_RTOL = 1e-5, 1e-4
HYMBA, RWKV = "hymba-1.5b", "rwkv6-7b"


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------ scan inputs

def _wkv_inputs(seed, B, T, H, hd, *, w=None):
    rng = np.random.RandomState(seed)
    r, k, v = ((rng.randn(B, T, H, hd) * 0.5).astype(np.float32)
               for _ in range(3))
    if w is None:
        w = (1 / (1 + np.exp(-rng.randn(B, T, H, hd))) * 0.85 + 0.1)
    w = np.broadcast_to(np.asarray(w, np.float32), (B, T, H, hd)).copy()
    u = (rng.randn(H, hd) * 0.1).astype(np.float32)
    s0 = (rng.randn(B, H, hd, hd) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _ssm_inputs(seed, B, T, H, hd, N, *, dt_scale=0.2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, H, hd) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(B, T, H))) * dt_scale).astype(np.float32)
    A = (-np.abs(rng.randn(H)) * 4).astype(np.float32)
    Bm = (rng.randn(B, T, N) * 0.5).astype(np.float32)
    Cm = (rng.randn(B, T, N) * 0.5).astype(np.float32)
    h0 = (rng.randn(B, H, hd, N) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


# the shapes of tests/test_kernels.py::test_wkv6 / test_ssm_scan, then
# ragged lengths: T=1, a prime and a non-multiple of 32
WKV_SHAPES = [(1, 32, 1, 16), (2, 128, 3, 32), (2, 96, 2, 64),
              (1, 1, 2, 32), (2, 37, 2, 16), (1, 50, 3, 32)]
SSM_SHAPES = [(1, 32, 1, 16, 8), (2, 128, 3, 32, 16), (2, 96, 2, 64, 16),
              (1, 1, 2, 32, 8), (2, 37, 2, 16, 16), (1, 50, 3, 32, 8)]


# ------------------------------------------------------- WKV6 oracles

@pytest.mark.parametrize("B,T,H,hd", WKV_SHAPES)
def test_wkv6_oracles_match_jax(B, T, H, hd):
    """ref_wkv6 and chunked_wkv6 (chunk 16 and 32, ragged tails padded
    with w = 1) against the JAX oracle; outputs and final states."""
    args = _wkv_inputs(3, B, T, H, hd)
    want_o, want_s = jref.ref_wkv6(*map(jnp.asarray, args))
    got_o, got_s = tref.ref_wkv6(*_t(*args))
    _close(got_o, want_o)
    _close(got_s, want_s)
    for chunk in (16, 32):
        got_o, got_s = tref.chunked_wkv6(*_t(*args), chunk=chunk)
        _close(got_o, want_o)
        _close(got_s, want_s)
        jo, js = jref.chunked_wkv6(*map(jnp.asarray, args), chunk=chunk)
        _close(got_o, jo)
        _close(got_s, js)


@pytest.mark.parametrize("B,T,H,hd", WKV_SHAPES)
def test_wkv6_plain_matches_jax_ops_and_pallas(B, T, H, hd):
    """The wrapper's plain version (the JAX chunk rule: the largest
    divisor of T up to 32) against JAX ``ops.wkv6`` (reference impl) and
    the Pallas kernel in interpret mode at the same chunk."""
    args = _wkv_inputs(4, B, T, H, hd)
    got_o, got_s = tops.wkv6(*_t(*args))
    jargs = list(map(jnp.asarray, args))
    want_o, want_s = jops.wkv6(*jargs, impl="reference")
    _close(got_o, want_o)
    _close(got_s, want_s)
    po, ps = j_wkv6_scan(*jargs, chunk=tref.pick_block(T, 32),
                         interpret=True)
    _close(got_o, po)
    _close(got_s, ps)


def test_wkv6_extreme_decay_stays_finite():
    """w = 1e-6, far below the clamp: every version stays finite and
    agrees (tests/test_kernels.py::test_wkv6_extreme_decay)."""
    args = _wkv_inputs(5, 1, 64, 2, 16, w=1e-6)
    args[-1][:] = 0.0
    want_o, want_s = jref.ref_wkv6(*map(jnp.asarray, args))
    for fn in (tref.ref_wkv6, twk.wkv6_scan_plain):
        got_o, got_s = fn(*_t(*args))
        assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
        _close(got_o, want_o)
        _close(got_s, want_s)


@pytest.mark.parametrize("B,T,H,hd,w", [
    (1, 200, 2, 64, 1e-6),             # far below the clamp, 4 chunks, ragged
    (1, 32, 1, 16, None), (2, 128, 3, 32, None), (2, 96, 2, 64, None),
])
def test_wkv6_kernel_algorithm_matches_jax(B, T, H, hd, w):
    """``ref.subchunk_wkv6``, the CUDA kernel's algorithm in plain PyTorch
    (64-step chunks, decays against 16-step sub-chunk references, never
    divided), against the JAX oracle: outputs and final states, finite
    where a quotient of cumulative decays over 64 steps would overflow."""
    args = _wkv_inputs(7, B, T, H, hd, w=w)
    want_o, want_s = jref.ref_wkv6(*map(jnp.asarray, args))
    got_o, got_s = tref.subchunk_wkv6(*_t(*args))
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    _close(got_o, want_o, 2e-5, 1e-3)
    _close(got_s, want_s, 2e-5, 1e-3)


def test_wkv6_step_matches_jax_and_the_scan():
    r, k, v, w, u, s0 = _wkv_inputs(6, 2, 1, 3, 32)
    want_o, want_s = jops.wkv6_step(*map(jnp.asarray, (r, k, v, w, u, s0)))
    got_o, got_s = tops.wkv6_step(*_t(r, k, v, w, u, s0))
    _close(got_o, want_o, OP_ATOL, OP_RTOL)
    _close(got_s, want_s, OP_ATOL, OP_RTOL)
    scan_o, scan_s = tops.wkv6(*_t(r, k, v, w, u, s0))
    _close(got_o, scan_o.numpy(), OP_ATOL, OP_RTOL)
    _close(got_s, scan_s.numpy(), OP_ATOL, OP_RTOL)


# -------------------------------------------------------- SSM oracles

@pytest.mark.parametrize("B,T,H,hd,N", SSM_SHAPES)
def test_ssm_oracles_match_jax(B, T, H, hd, N):
    args = _ssm_inputs(7, B, T, H, hd, N)
    want_y, want_h = jref.ref_ssm_scan(*map(jnp.asarray, args))
    got_y, got_h = tref.ref_ssm_scan(*_t(*args))
    _close(got_y, want_y)
    _close(got_h, want_h)
    for chunk in (16, 32):
        got_y, got_h = tref.chunked_ssm_scan(*_t(*args), chunk=chunk)
        _close(got_y, want_y)
        _close(got_h, want_h)
        jy, jh = jref.chunked_ssm_scan(*map(jnp.asarray, args), chunk=chunk)
        _close(got_y, jy)
        _close(got_h, jh)


@pytest.mark.parametrize("B,T,H,hd,N", SSM_SHAPES)
def test_ssm_plain_matches_jax_ops_and_pallas(B, T, H, hd, N):
    args = _ssm_inputs(8, B, T, H, hd, N)
    got_y, got_h = tops.ssm(*_t(*args))
    jargs = list(map(jnp.asarray, args))
    want_y, want_h = jops.ssm(*jargs, impl="reference")
    _close(got_y, want_y)
    _close(got_h, want_h)
    py, ph = j_ssm_scan(*jargs, chunk=tref.pick_block(T, 32),
                        interpret=True)
    _close(got_y, py)
    _close(got_h, ph)


def test_ssm_extreme_decay_stays_finite():
    """dt * A far below the -2.5 clamp: the clamp holds and every version
    agrees."""
    args = _ssm_inputs(9, 1, 64, 2, 16, 8, dt_scale=50.0)
    want_y, want_h = jref.ref_ssm_scan(*map(jnp.asarray, args))
    assert float(np.min(args[1] * args[2][None, None])) < -100
    for fn in (tref.ref_ssm_scan, tss.ssm_scan_plain):
        got_y, got_h = fn(*_t(*args))
        assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
        _close(got_y, want_y)
        _close(got_h, want_h)


def test_ssm_step_matches_jax_and_the_scan():
    args = _ssm_inputs(10, 2, 1, 3, 32, 8)
    want_y, want_h = jops.ssm_step(*map(jnp.asarray, args))
    got_y, got_h = tops.ssm_step(*_t(*args))
    _close(got_y, want_y, OP_ATOL, OP_RTOL)
    _close(got_h, want_h, OP_ATOL, OP_RTOL)
    scan_y, scan_h = tops.ssm(*_t(*args))
    _close(got_y, scan_y.numpy(), OP_ATOL, OP_RTOL)
    _close(got_h, scan_h.numpy(), OP_ATOL, OP_RTOL)


def test_pick_block_is_the_jax_chunk_rule():
    for n in (1, 2, 31, 32, 37, 50, 96, 128, 513):
        assert tref.pick_block(n, 32) == jops._pick_block(n, 32)


# ---------------------------------------------------- scan wrappers

def test_cpu_tensors_take_the_plain_versions_uncounted():
    wargs = _t(*_wkv_inputs(11, 1, 20, 2, 16))
    sargs = _t(*_ssm_inputs(11, 1, 20, 2, 16, 8))
    before = {**tss.LAUNCHES, **twk.LAUNCHES}
    o, s = twk.wkv6_scan(*wargs)
    y, h = tss.ssm_scan(*sargs)
    assert {**tss.LAUNCHES, **twk.LAUNCHES} == before
    for got, want in zip((o, s, y, h), (*twk.wkv6_scan_plain(*wargs),
                                        *tss.ssm_scan_plain(*sargs))):
        assert torch.equal(got, want)


def test_scan_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no ssm_scan kernel"):
        tss.ssm_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, 0, :8],
                     x[:, :, 0, :8], x[:, :, :, :8])
    with pytest.raises(ValueError, match="no wkv6_scan kernel"):
        twk.wkv6_scan(x, x, x, x, x[0, 0], x[:, :2, :, :].transpose(1, 2))


def _bad_ssm():
    x, dt, A, Bm, Cm, h0 = _t(*_ssm_inputs(12, 2, 8, 2, 16, 8))
    bf = torch.bfloat16
    return {
        "x rank": ((x[0], dt, A, Bm, Cm, h0), ValueError),
        "Bm shape": ((x, dt, A, Bm[:, :5], Cm, h0), ValueError),
        "dt shape": ((x, dt[..., :1], A, Bm, Cm, h0), ValueError),
        "state shape": ((x, dt, A, Bm, Cm, h0[..., :4]), ValueError),
        "empty T": ((x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], h0),
                    ValueError),
        "N 6": ((x, dt, A, Bm[..., :6], Cm[..., :6], h0[..., :6]),
                ValueError),
        # past the kernel's state limit: hd a multiple of 8 up to 128
        # (hd 64 x N 32 is taken since the chunked scan)
        "hd * N > 1024": ((torch.zeros(1, 8, 1, 256), torch.zeros(1, 8, 1),
                           torch.zeros(1), torch.zeros(1, 8, 32),
                           torch.zeros(1, 8, 32), torch.zeros(1, 1, 256, 32)),
                          ValueError),
        "fp16 x": ((x.half(), dt, A, Bm.half(), Cm.half(), h0), TypeError),
        "mixed x/Bm": ((x.to(bf), dt, A, Bm, Cm, h0), TypeError),
        "bf16 dt": ((x.to(bf), dt.to(bf), A, Bm.to(bf), Cm.to(bf), h0),
                    TypeError),
        "bf16 A": ((x, dt, A.to(bf), Bm, Cm, h0), TypeError),
        "bf16 state": ((x, dt, A, Bm, Cm, h0.to(bf)), TypeError),
        "device mix": ((x, dt, A, Bm, Cm.to("meta"), h0), ValueError),
        "strided x": ((x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                       Bm, Cm, h0), ValueError),
        "strided state": ((x, dt, A, Bm, Cm,
                           h0.transpose(0, 1).contiguous().transpose(0, 1)),
                          ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_ssm()))
def test_ssm_launch_checks_refuse_what_the_kernel_cannot_take(case):
    args, exc = _bad_ssm()[case]
    with pytest.raises(exc):
        tss._check(*args)


def _bad_wkv():
    r, k, v, w, u, s0 = _t(*_wkv_inputs(13, 2, 8, 2, 16))
    bf = torch.bfloat16
    return {
        "r rank": ((r[0], k, v, w, u, s0), ValueError),
        "k shape": ((r, k[:, :5], v, w, u, s0), ValueError),
        "u shape": ((r, k, v, w, u[:1], s0), ValueError),
        "state shape": ((r, k, v, w, u, s0[..., :8]), ValueError),
        "empty T": ((r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0),
                    ValueError),
        "head_dim 48": ((*(torch.zeros(1, 4, 1, 48),) * 4, torch.zeros(1, 48),
                         torch.zeros(1, 1, 48, 48)), ValueError),
        "fp16 r": ((r.half(), k.half(), v.half(), w, u, s0), TypeError),
        "mixed r/k": ((r.to(bf), k, v, w, u, s0), TypeError),
        "bf16 w": ((r.to(bf), k.to(bf), v.to(bf), w.to(bf), u, s0),
                   TypeError),
        "bf16 u": ((r, k, v, w, u.to(bf), s0), TypeError),
        "bf16 state": ((r, k, v, w, u, s0.to(bf)), TypeError),
        "device mix": ((r, k, v, w.to("meta"), u, s0), ValueError),
        "strided w": ((r, k, v, w.transpose(2, 3).contiguous()
                       .transpose(2, 3), u, s0), ValueError),
        "strided state": ((r, k, v, w, u,
                           s0.transpose(0, 1).contiguous().transpose(0, 1)),
                          ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_wkv()))
def test_wkv6_launch_checks_refuse_what_the_kernel_cannot_take(case):
    args, exc = _bad_wkv()[case]
    with pytest.raises(exc):
        twk._check(*args)


def test_launch_checks_accept_the_main_path_layouts():
    """The models hand the kernels reshaped projections (B,S,d) ->
    (B,S,H,hd) and float32 decays and step sizes, in bf16 serving."""
    bf = torch.bfloat16
    xc = torch.zeros(1, 40, 3200, dtype=bf)
    tss._check(xc.reshape(1, 40, 50, 64), torch.zeros(1, 40, 50),
               torch.zeros(50), torch.zeros(1, 40, 16, dtype=bf),
               torch.zeros(1, 40, 16, dtype=bf), torch.zeros(1, 50, 64, 16))
    r = torch.zeros(1, 40, 4096, dtype=bf).reshape(1, 40, 64, 64)
    twk._check(r, r, r, torch.zeros(1, 40, 64, 64), torch.zeros(64, 64),
               torch.zeros(1, 64, 64, 64))


# ---------------------------------------------------------------- models

def _family(arch):
    jcfg = j_smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, get_smoke_config(arch), \
        TM.from_jax_params(jax.device_get(jp))


@pytest.fixture(scope="module")
def hymba():
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    return _family(HYMBA)


@pytest.fixture(scope="module")
def rwkv():
    return _family(RWKV)


@pytest.fixture(params=[HYMBA, RWKV])
def family(request, hymba, rwkv):
    return {HYMBA: hymba, RWKV: rwkv}[request.param]


def _flat(t, pre=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def test_init_params_has_jax_layout(family):
    """Same tree, shapes and dtypes as the JAX init, ssm and time/channel
    mix subtrees included."""
    _, jp, cfg, tp = family
    got = TM.init_params(cfg, seed=3, device="cpu")
    assert _flat(got) == _flat(jax.device_get(jp)) == _flat(tp)
    sub = "ssm" if cfg.family == "hybrid" else "time_mix"
    assert any(k.startswith(f"blocks/{sub}/") for k in _flat(got))


def test_init_params_bf16_keeps_fp32_leaves_as_jax():
    jcfg = dataclasses.replace(j_smoke_config(RWKV), dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(RWKV), dtype="bfloat16")
    jp = jax.device_get(JM.init_params(jax.random.PRNGKey(1), jcfg))
    assert _flat(TM.init_params(cfg, seed=1, device="cpu")) == _flat(jp)
    hcfg = dataclasses.replace(get_smoke_config(HYMBA), dtype="bfloat16")
    hj = jax.device_get(JM.init_params(
        jax.random.PRNGKey(1),
        dataclasses.replace(j_smoke_config(HYMBA), dtype="bfloat16")))
    assert _flat(TM.init_params(hcfg, seed=1, device="cpu")) == _flat(hj)


def test_ssm_dims_match_jax():
    for arch in (HYMBA,):
        for cfg, jcfg in ((get_config(arch), None),
                          (get_smoke_config(arch), j_smoke_config(arch))):
            from repro.configs import get_config as jget
            jcfg = jcfg or jget(arch)
            assert tssm.ssm_dims(cfg) == jssm.ssm_dims(jcfg)
    assert tssm.ssm_dims(get_config(HYMBA)) == (3200, 50, 64)
    assert trwkv.rwkv_dims(get_config(RWKV)) == (64, 64)


def test_causal_conv_matches_jax(hymba):
    rng = np.random.RandomState(14)
    x = rng.randn(2, 7, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    tail = rng.randn(2, 3, 12).astype(np.float32)
    _close(tssm._causal_conv(*_t(x, w)), jssm._causal_conv(x, w),
           OP_ATOL, OP_RTOL)
    _close(tssm._causal_conv(*_t(x, w, tail)),
           jssm._causal_conv(x, w, tail=tail), OP_ATOL, OP_RTOL)


@pytest.mark.parametrize("S", [2, 13])
def test_ssm_branch_matches_jax(hymba, S):
    """ssm_forward_with_state (y, conv tail, scan state; S=2 is shorter
    than the conv tail) and one ssm_decode step from that state."""
    jcfg, jp, cfg, tp = hymba
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    tl = _layer(tp["blocks"], 0)["ssm"]
    rng = np.random.RandomState(15 + S)
    x = (rng.randn(2, S, cfg.d_model) * 0.5).astype(np.float32)
    want = jssm.ssm_forward_with_state(jl, jcfg, x)
    got = tssm.ssm_forward_with_state(tl, cfg, torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)
    _close(tssm.ssm_forward(tl, cfg, torch.from_numpy(x)), want[0])
    x1 = (rng.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
    want = jssm.ssm_decode(jl, jcfg, x1, want[1], want[2])
    got = tssm.ssm_decode(tl, cfg, torch.from_numpy(x1), got[1], got[2])
    for g, w in zip(got, want):
        _close(g, w)


def test_rwkv_time_and_channel_mix_match_jax(rwkv):
    jcfg, jp, cfg, tp = rwkv
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])
    tl = _layer(tp["blocks"], 0)
    rng = np.random.RandomState(16)
    x = (rng.randn(2, 11, cfg.d_model) * 0.5).astype(np.float32)
    carry = (rng.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
    want = jrwkv.time_mix_forward(jl["time_mix"], jcfg, x)
    got = trwkv.time_mix_forward(tl["time_mix"], cfg, torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g, w)
    x1 = x[:, :1]
    want_d = jrwkv.time_mix_decode(jl["time_mix"], jcfg, x1, carry, want[2])
    got_d = trwkv.time_mix_decode(tl["time_mix"], cfg, torch.from_numpy(x1),
                                  torch.from_numpy(carry), got[2])
    for g, w in zip(got_d, want_d):
        _close(g, w)
    for c in (None, carry):
        want_c = jrwkv.channel_mix(jl["channel_mix"], jcfg, x,
                                   shift_carry=c)
        got_c = trwkv.channel_mix(
            tl["channel_mix"], cfg, torch.from_numpy(x),
            shift_carry=None if c is None else torch.from_numpy(c))
        for g, w in zip(got_c, want_c):
            _close(g, w)


def test_forward_matches_jax(family):
    jcfg, jp, cfg, tp = family
    toks = np.random.RandomState(17).randint(0, cfg.vocab_size, (2, 21)) \
        .astype(np.int32)
    want, _ = JM.forward(jp, jcfg, toks)
    _close(TM.forward(tp, cfg, torch.from_numpy(toks))[0], want)


def _ranges():
    L = get_smoke_config(HYMBA).n_layers
    assert L == get_smoke_config(RWKV).n_layers
    return [(s, e) for s in range(L) for e in range(s + 1, L + 1)]


@pytest.mark.parametrize("arch", [HYMBA, RWKV])
@pytest.mark.parametrize("start,end", _ranges())
def test_run_fragment_matches_jax(hymba, rwkv, arch, start, end):
    """Every (start, end) of the smoke config, embed and head included."""
    jcfg, jp, cfg, tp = {HYMBA: hymba, RWKV: rwkv}[arch]
    rng = np.random.RandomState(10 * start + end)
    x = rng.randint(0, cfg.vocab_size, (2, 19)).astype(np.int32) \
        if start == 0 else \
        (rng.randn(2, 19, cfg.d_model) * 0.5).astype(np.float32)
    want = JM.run_fragment(jp, jcfg, x, start, end)
    got = TM.run_fragment(tp, cfg, torch.from_numpy(x), start, end)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_rwkv6_padded_batch_gap_matches_jax():
    """A prompt's logits alone against the same prompt in a padded batch
    (3 rows, 60 of 96 tokens real), through the first block and all 4
    blocks of a 4-layer rwkv6 at smoke width, in both packages on the same weights.
    A float32 product's rounding depends on its row count, so neither gap
    is 0; the port's must stay of the size of JAX's at every depth (it
    does not drift where JAX does not), and both inside the serving
    tolerance (atol 5e-5, rtol 1e-3)."""
    L, S, T, rows = 4, 60, 96, 3
    jcfg = j_reduced(j_get_config(RWKV), n_layers=L)
    cfg = reduced(get_config(RWKV), n_layers=L)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.from_jax_params(jax.device_get(jp))
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, S)) \
        .astype(np.int32)
    batch = np.concatenate([toks, np.zeros((1, T - S), np.int32)], 1) \
        .repeat(rows, 0)
    for d in (1, L):
        jc = dataclasses.replace(jcfg, n_layers=d)
        jh = dict(jp, blocks=jax.tree_util.tree_map(lambda a: a[:d],
                                                    jp["blocks"]))
        c = dataclasses.replace(cfg, n_layers=d)
        th = dict(tp, blocks=slice_blocks(tp["blocks"], 0, d))
        gaps = []
        for alone, padded in (
                (np.asarray(JM.forward(jh, jc, toks)[0])[0],
                 np.asarray(JM.run_fragment(jh, jc, batch, 0, d))),
                (TM.forward(th, c, torch.from_numpy(toks))[0][0].numpy(),
                 TM.run_fragment(th, c, torch.from_numpy(batch), 0, d)
                 .numpy())):
            diff = np.abs(padded[rows // 2, :S] - alone)
            gaps.append(float((diff / (ATOL + RTOL * np.abs(alone))).max()))
        j_gap, t_gap = gaps
        print(f"rwkv6 smoke width, {d} of {L} layers: padded batch vs "
              f"alone, worst |diff| / tolerance: jax {j_gap:.4f}, port "
              f"{t_gap:.4f}")
        assert t_gap <= 2 * j_gap + 0.05 and max(gaps) < 1, (d, gaps)


def test_recurrent_families_are_not_packable():
    for arch in (HYMBA, RWKV):
        assert not TM.is_packable(get_smoke_config(arch))


# ---------------------------------------------------- prefill / decode

def _check_cache(got: dict, want: dict):
    assert set(got) == set(want)
    for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        if key in ("pos", "kv_pos"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        else:
            _close(got[key], want[key])


@pytest.mark.parametrize("S,cache_seq", [(12, None), (12, 20), (37, 40)])
def test_prefill_matches_jax(family, S, cache_seq):
    """Logits and every cache entry: KV, conv tails and scan states
    (hybrid), WKV states and shift carries (ssm). S=37 is prime: the JAX
    reference scans it in chunks of 1."""
    jcfg, jp, cfg, tp = family
    toks = np.random.RandomState(18 + S).randint(0, cfg.vocab_size, (2, S)) \
        .astype(np.int32)
    jl, jc = jdec.prefill(jp, jcfg, jnp.asarray(toks), cache_seq=cache_seq)
    tl, tc = tdec.prefill(tp, cfg, torch.from_numpy(toks),
                          cache_seq=cache_seq)
    _close(tl, jl)
    _check_cache(tc, jc)
    if cfg.family == "ssm":
        assert "kv_pos" not in tc and "k" not in tc


def test_decode_step_teacher_forced_matches_jax(family):
    """Six forced steps; the recurrent state is written in place."""
    jcfg, jp, cfg, tp = family
    rng = np.random.RandomState(19)
    toks = rng.randint(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    forced = rng.randint(0, cfg.vocab_size, (6, 2, 1)).astype(np.int32)
    _, jc = jdec.prefill(jp, jcfg, jnp.asarray(toks), cache_seq=16)
    _, tc = tdec.prefill(tp, cfg, torch.from_numpy(toks), cache_seq=16)
    state_key = "wkv" if cfg.family == "ssm" else "ssm_scan"
    state = tc[state_key]
    for step in forced:
        jl, jc = jdec.decode_step(jp, jcfg, jc, jnp.asarray(step))
        tl, tc = tdec.decode_step(tp, cfg, tc, torch.from_numpy(step))
        _close(tl, jl)
    assert tc[state_key] is state                   # written in place
    _check_cache(tc, jc)


@pytest.mark.parametrize("arch", [HYMBA, RWKV])
def test_multi_step_decode_matches_forward(hymba, rwkv, arch):
    """The twins of tests/test_models.py::test_hybrid_multi_step_decode
    and ::test_rwkv_multi_step_decode: decode over several steps equals
    the full forward at those positions, in the port and against JAX."""
    jcfg, jp, cfg, tp = {HYMBA: hymba, RWKV: rwkv}[arch]
    S, n_new = 8, 4
    toks = np.random.RandomState(20).randint(0, cfg.vocab_size,
                                             (1, S + n_new)).astype(np.int32)
    full, _ = TM.forward(tp, cfg, torch.from_numpy(toks))
    jfull, _ = JM.forward(jp, jcfg, toks)
    _close(full, jfull)
    _, cache = tdec.prefill(tp, cfg, torch.from_numpy(toks[:, :S]),
                            cache_seq=S + n_new)
    for i in range(n_new):
        ld, cache = tdec.decode_step(
            tp, cfg, cache, torch.from_numpy(toks[:, S + i:S + i + 1]))
        _close(ld[:, 0], full[:, S + i].numpy(), atol=1e-4, rtol=1e-3)


def test_smoke_steps_check_holds_the_rwkv_state(rwkv, monkeypatch):
    """The smoke's prefill + teacher-forced steps check passes the port
    and catches a WKV state that decode did not inherit."""
    _, _, cfg, tp = rwkv
    toks = np.random.RandomState(24).randint(0, cfg.vocab_size, 14)
    assert tsmoke.check_steps_against_forward(cfg, tp, toks, 4) < 1e-4
    real = tdec.prefill

    def forgetful(*a, **k):
        logits, cache = real(*a, **k)
        cache["wkv"].zero_()
        return logits, cache
    monkeypatch.setattr(tdec, "prefill", forgetful)
    with pytest.raises(AssertionError):
        tsmoke.check_steps_against_forward(cfg, tp, toks, 4)


# -------------------------------------------------------------- serving

def _book(cfg):
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(cfg, seq_len=8),
                                 name=cfg.name))
    return book


def _wave(cfg, frags, lens, rng):
    return [(ServeRequest(client=f.client,
                          tokens=rng.randint(0, cfg.vocab_size, n)
                          .astype(np.int32)), f.p)
            for f, n in zip(frags, lens)]


def _check_vs_jax(jcfg, jp, reqs):
    for req, _ in reqs:
        want, _ = JM.forward(jp, jcfg, np.asarray(req.tokens)[None])
        _close(req.result, want[0])


def test_hymba_served_across_apply_plan_equals_jax(hymba):
    """The pad-to-bucket path (hybrid is not packable): a planner plan,
    then re-aligned depth-2 chains after apply_plan; every result equals
    the JAX monolithic forward."""
    from repro_torch.core import GraftPlanner
    jcfg, jp, cfg, tp = hymba
    book = _book(cfg)
    frags = [Fragment(cfg.name, p, t, 30.0, client=f"c{i}")
             for i, (p, t) in enumerate(zip((0, 1, 1), (60.0, 45.0, 70.0)))]
    rng = np.random.RandomState(21)
    with GraftExecutor(GraftPlanner(book).plan(frags), tp, cfg,
                       device="cpu") as ex:
        reqs = _wave(cfg, frags, (5, 9, 16), rng)
        ex.serve(reqs)
        _check_vs_jax(jcfg, jp, reqs)
        ex.apply_plan(tsmoke.mixed_depth_plan(cfg, book, frags, s=1))
        assert any(len(c) == 2 for c in ex.route_table().values())
        reqs = _wave(cfg, frags, (12, 3, 70), rng)
        ex.serve(reqs)
        _check_vs_jax(jcfg, jp, reqs)
        st = ex.pool_stats()
        assert not any(s["packed"] for s in st.values())
        assert sum(s["pad_tokens"] for s in st.values()) > 0


def test_rwkv_served_one_shot_and_refuses_decode(rwkv):
    """rwkv6 serves one-shot like the JAX forward; its full-range pool
    refuses a decode admission (no KV: ``not_decode_capable``), as in
    the JAX package."""
    jcfg, jp, cfg, tp = rwkv
    from repro.serving.executor import GraftExecutor as JExecutor
    book = _book(cfg)
    frags = [Fragment(cfg.name, p, 50.0, 30.0, client=f"c{i}")
             for i, p in enumerate((0, 1))]
    rng = np.random.RandomState(22)
    with GraftExecutor(tsmoke.mixed_depth_plan(cfg, book, frags, s=1), tp,
                       cfg, device="cpu", decode_ctx=32) as ex:
        reqs = _wave(cfg, frags, (7, 33), rng)
        ex.serve(reqs)
        _check_vs_jax(jcfg, jp, reqs)
        ex.apply_plan(tsmoke.decode_plan(cfg, book, frags))
        h = ex.handle(next(iter(ex.pool_specs())))
        got = h.decode_admit(1, "c0", np.arange(5, dtype=np.int32), 3)
    from repro.core import Fragment as JFragment
    from repro.core import ProfileBook as JBook
    from repro.core import arch_layer_costs as j_costs
    jbook = JBook()
    jbook.add(dataclasses.replace(j_costs(jcfg, seq_len=8), name=jcfg.name))
    jfrags = [JFragment(jcfg.name, 0, 50.0, 30.0, client="c0")]
    jex = JExecutor(jsmoke.decode_plan(jcfg, jbook, jfrags), jp, jcfg,
                    decode_ctx=32)
    jh = jex.handle(next(iter(jex.pool_specs())))
    want = jh.decode_admit(1, "c0", np.arange(5, dtype=np.int32), 3)
    jex.close()
    assert got["admitted"] is want["admitted"] is False
    assert got["reason"] == want["reason"] == "not_decode_capable"


@pytest.fixture(scope="module")
def hymba_served(hymba):
    """Prompts, their JAX reference tokens, and the port's single-pool
    and disaggregated decode runs of them (hymba smoke, window 64)."""
    jcfg, jp, cfg, tp = hymba
    book = _book(cfg)
    frags = tsmoke.smoke_fragments(cfg, 2, seed=0)
    rng = np.random.RandomState(23)
    base = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in (12, 9, 14, 7)]
    prompts = [(f"c{i % 2}", t) for i, t in enumerate(base)]
    # stream 4 repeats stream 0's prompt; stream 5 extends stream 1's
    prompts += [("c0", base[0].copy()),
                ("c1", np.concatenate([base[1], [3, 1, 4]]).astype(np.int32))]
    max_new = 5
    want = [jsmoke.reference_decode(jcfg, jp, t, max_new)
            for _, t in prompts]
    runs = {}
    for disagg in (False, True):
        plan = (tsmoke.disagg_plan if disagg else tsmoke.decode_plan)(
            cfg, book, frags, batch=3)
        with GraftExecutor(plan, tp, cfg, InProcessTransport(),
                           decode_ctx=32, kv_blocks=32, kv_block_tokens=4,
                           decode_disagg=disagg, device="cpu") as ex:
            r = tsmoke.drive_decode(ex, prompts, max_new, disagg=disagg,
                                    abort_at={2: 2})
            r["stats"] = {s["role"]: s for s in ex.pool_stats().values()}
        runs[disagg] = r
    return prompts, want, runs


def test_hymba_single_pool_tokens_equal_jax_reference(hymba_served):
    """Continuous batching (batch 3, 6 streams, a repeated prompt),
    mid-decode admission and an abort: every finished stream equals the
    JAX reference. Hybrid shares no prefix: the repeat recomputes."""
    prompts, want, runs = hymba_served
    r = runs[False]
    assert r["aborted"] == [2] and r["mid_admits"] >= 1
    for i, got in enumerate(r["tokens"]):
        if i != 2:
            assert got == want[i], f"stream {i}"
    st = r["stats"]["both"]
    assert st["decode_active"] == 0 and st["kv"]["active_seqs"] == 0
    assert st["kv"]["prefix_hits"] == 0


def test_hymba_disagg_tokens_equal_single_pool(hymba_served):
    """Disaggregated: the prefill pool exports, the decode pool ignores
    the handoff's blocks (the scan state is not in them) and recomputes
    the prompt; tokens equal the single-pool run."""
    prompts, want, runs = hymba_served
    single, split = runs[False], runs[True]
    assert split["tokens"] == single["tokens"]
    assert split["handoffs"] == len(prompts)
    pre, dec = split["stats"]["prefill"], split["stats"]["decode"]
    assert pre["decode_active"] == 0
    assert pre["prefill_exports"] == len(prompts)
    assert dec["kv_handoffs_in"] == 0
    assert dec["kv"]["handoff_blocks_in"] == 0
    assert dec["kv"]["prefix_hits"] == 0


def test_hymba_port_reference_decode_equals_jax(hymba, hymba_served):
    _, _, cfg, tp = hymba
    prompts, want, _ = hymba_served
    margins = []
    assert tsmoke.reference_decode(cfg, tp, prompts[1][1], 5,
                                   margins=margins) == want[1]
    assert len(margins) == 5 and min(margins) >= 0


def test_hymba_solo_prefill_never_gathers(hymba):
    """A hybrid pool's admission runs the whole prompt through prefill
    even when its arena reports a shared prefix."""
    from repro_torch.core import plan_pools
    from repro_torch.serving.executor import FragmentInstance
    _, _, cfg, tp = hymba
    plan = tsmoke.decode_plan(cfg, _book(cfg), tsmoke.smoke_fragments(cfg, 1),
                              batch=1)
    (spec,) = plan_pools(plan).values()
    inst = FragmentInstance(tp, cfg, spec, decode_ctx=32, kv_block_tokens=4)
    assert not inst._kv_share
    toks = np.arange(9, dtype=np.int32)
    inst._ensure_decode()
    inst.kv.begin(7, ("solo", 7), toks)
    inst.kv.gather = None                      # a gather would fail here
    first, _, ks, _ = inst._solo_prefill(7, toks, n_shared=8)
    logits, _ = tdec.prefill(tp, cfg, torch.from_numpy(toks)[None],
                             cache_seq=32)
    assert first == int(torch.argmax(logits[0, -1]))
    assert ks.shape[0] == 1                    # the suffix past position 8
