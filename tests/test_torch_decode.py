"""The port's decode slice against the JAX package, on the CPU.

Same numpy inputs (from a seed) and the same weights (the JAX init
converted by ``from_jax_params``) go through the JAX function and its
port. Tolerances:

* decode attention, plain version vs the Pallas kernel in interpret mode
  and vs the JAX reference: ``atol=3e-5`` (the JAX kernel tests' own);
* one attention layer (``attn_decode``): ``atol=1e-5, rtol=1e-4``
  (float32, one layer deep); int8 cache values and position bookkeeping
  exactly;
* prefill and teacher-forced decode logits and caches: the reference's
  fragment tolerance ``atol=5e-5, rtol=1e-3``;
* served greedy tokens: token for token against the JAX
  ``serving/smoke.py::reference_decode``;
* the paged KV arena: the same op sequences give the same results,
  counters and KV arrays (exactly: both arenas are numpy float32).
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
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.models import attention as jattn
from repro.models import decode as jdec
from repro.serving import kvcache as jkv
from repro.serving import smoke as jsmoke
from repro.serving import transport as jtp
from repro_torch import models as TM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import from_jax_params
from repro_torch.models.transformer import _layer
from repro_torch.serving import GraftExecutor, InProcessTransport
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import smoke as tsmoke
from repro_torch.serving import transport as ttp

ARCH = "qwen3-1.7b"
KERNEL_ATOL = 3e-5
LAYER_ATOL, LAYER_RTOL = 1e-5, 1e-4
ATOL, RTOL = 5e-5, 1e-3


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def dense():
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg = j_smoke_config(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, get_smoke_config(ARCH), \
        from_jax_params(jax.device_get(jp))


# ------------------------------------------------------- decode attention

def _decode_inputs(seed, B, Sk, H, KV, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, hd).astype(np.float32),
            rng.randn(B, Sk, KV, hd).astype(np.float32),
            rng.randn(B, Sk, KV, hd).astype(np.float32))


def _causal_kv_pos(B, Sk, q_pos):
    kv_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32)[None], (B, Sk))
    return np.where(kv_pos <= q_pos[:, None], kv_pos, -1).astype(np.int32)


@pytest.mark.parametrize("B,Sk,H,KV,hd", [(2, 256, 4, 2, 32),
                                          (3, 128, 8, 8, 64),
                                          (1, 512, 16, 2, 64)])
@pytest.mark.parametrize("window", [0, 100])
def test_decode_attention_plain_matches_pallas(B, Sk, H, KV, hd, window):
    """The shapes of tests/test_kernels.py::test_decode_attention."""
    q, k, v = _decode_inputs(2, B, Sk, H, KV, hd)
    q_pos = (np.arange(B, dtype=np.int32) * 37 + 60).astype(np.int32)
    kv_pos = _causal_kv_pos(B, Sk, q_pos)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(q_pos), jnp.asarray(kv_pos), window=window,
                    block_k=64, interpret=True)
    got = tda.decode_attention(*_t(q, k, v, q_pos, kv_pos), window=window)
    _close(got, want, atol=KERNEL_ATOL, rtol=0)


def _ring_kv_pos(B, Sc, q_pos):
    """Ring-buffer slots: slot = pos % Sc for the last Sc positions up to
    q_pos; rows that have not wrapped keep -1 holes."""
    kv_pos = np.full((B, Sc), -1, np.int32)
    for b, qp in enumerate(q_pos):
        for p in range(max(0, qp - Sc + 1), qp + 1):
            kv_pos[b, p % Sc] = p
    return kv_pos


@pytest.mark.parametrize("case", ["ragged Sk", "ring"])
@pytest.mark.parametrize("window", [0, 40])
def test_attend_cache_matches_jax_reference(case, window):
    B, H, KV, hd = 3, 8, 2, 64
    if case == "ragged Sk":
        Sk = 131
        q_pos = np.array([130, 77, 5], np.int32)
        kv_pos = _causal_kv_pos(B, Sk, q_pos)
    else:
        Sk = 96
        q_pos = np.array([300, 95, 40], np.int32)
        kv_pos = _ring_kv_pos(B, Sk, q_pos)
    q, k, v = _decode_inputs(3, B, Sk, H, KV, hd)
    want = jref.ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos)[:, None], kv_pos=jnp.asarray(kv_pos),
        causal=True, window=window)
    got = tops.attend_cache(*_t(q, k, v, q_pos, kv_pos), window=window)
    _close(got, want, atol=KERNEL_ATOL, rtol=0)


def test_fully_masked_row_gives_zero_as_the_jax_reference():
    """A row with no valid slot: 0, as the JAX reference (and the port's
    plain version and CUDA kernel). The TPU kernel differs from its own
    reference there: it returns the mean of v."""
    B, Sk, H, KV, hd = 2, 128, 4, 2, 32
    q, k, v = _decode_inputs(4, B, Sk, H, KV, hd)
    q_pos = np.array([50, 50], np.int32)
    kv_pos = _causal_kv_pos(B, Sk, q_pos)
    kv_pos[1] = -1                                 # row 1: nothing valid
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = jref.ref_attention(*jargs, q_pos=jnp.asarray(q_pos)[:, None],
                              kv_pos=jnp.asarray(kv_pos), causal=True)
    got = tda.decode_attention(*_t(q, k, v, q_pos, kv_pos))
    _close(got, want, atol=KERNEL_ATOL, rtol=0)
    assert np.all(got[1].numpy() == 0) and np.all(np.asarray(want[1]) == 0)
    tpu = j_decode(*jargs, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                   block_k=64, interpret=True)
    mean_v = v[1].mean(axis=0).repeat(H // KV, axis=0)      # (H, hd)
    np.testing.assert_allclose(np.asarray(tpu[1, 0]), mean_v, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, k, v = _decode_inputs(5, 2, 70, 4, 2, 32)
    q_pos = np.array([69, 30], np.int32)
    args = _t(q, k, v, q_pos, _causal_kv_pos(2, 70, q_pos))
    before = dict(tda.LAUNCHES)
    got = tda.decode_attention(*args, window=16)
    assert tda.LAUNCHES == before
    _close(got, tda.decode_attention_plain(*args, window=16).numpy(),
           atol=0, rtol=0)


def test_wrapper_refuses_other_devices():
    """A device that is neither the CPU nor a card raises; meta tensors
    (a shape pass) take the plain version and launch nothing."""
    class OnDevice:
        device = torch.device("xpu")
    x = OnDevice()
    with pytest.raises(ValueError, match="no attention kernel"):
        tda.decode_attention(x, x, x, x, x)
    q = torch.empty((1, 1, 2, 32), device="meta")
    kv = torch.empty((1, 8, 1, 32), device="meta")
    pos = torch.empty((1,), dtype=torch.int32, device="meta")
    before = dict(tda.LAUNCHES)
    o = tda.decode_attention(q, kv, kv, pos, pos[:, None].expand(1, 8))
    assert tda.LAUNCHES == before
    assert o.device.type == "meta" and o.shape == q.shape


def _bad_decode_inputs():
    q = torch.zeros(2, 1, 4, 32)
    k = torch.zeros(2, 8, 2, 32)
    qp = torch.zeros(2, dtype=torch.int32)
    kp = torch.zeros(2, 8, dtype=torch.int32)
    return {
        "head_dim": (torch.zeros(2, 1, 4, 48), torch.zeros(2, 8, 2, 48),
                     torch.zeros(2, 8, 2, 48), qp, kp, ValueError),
        "fp16": (q.half(), k.half(), k.half(), qp, kp, TypeError),
        "mixed dtypes": (q, k.to(torch.bfloat16), k, qp, kp, TypeError),
        "two q tokens": (torch.zeros(2, 2, 4, 32), k, k, qp, kp, ValueError),
        "gqa": (torch.zeros(2, 1, 5, 32), k, k, qp, kp, ValueError),
        "group > 16": (torch.zeros(2, 1, 34, 32), k, k, qp, kp, ValueError),
        "kv shape": (q, k, torch.zeros(2, 9, 2, 32), qp, kp, ValueError),
        "empty cache": (q, k[:, :0], k[:, :0], qp, kp[:, :0], ValueError),
        "q_pos dtype": (q, k, k, qp.long(), kp, ValueError),
        "kv_pos shape": (q, k, k, qp, kp[:, :5], ValueError),
        "strided kv_pos": (q, k, k, qp, torch.zeros(8, 2, dtype=torch.int32)
                           .T, ValueError),
        "device mix": (q, k, k, qp, kp.to("meta"), ValueError),
        "window": (q, k, k, qp, kp, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_decode_inputs()))
def test_launch_checks_refuse_what_the_kernel_cannot_take(case):
    q, k, v, qp, kp, exc = _bad_decode_inputs()[case]
    with pytest.raises(exc):
        tda._check(q, k, v, qp, kp, -1 if case == "window" else 0)


def test_launch_checks_accept_the_decode_cache_layer_view():
    """The main path hands the kernel one layer of the stacked cache
    (L, B, Sc, KV, hd): a strided view, contiguous along hd."""
    cache = torch.zeros(3, 4, 512, 8, 128, dtype=torch.bfloat16)
    q = torch.zeros(4, 1, 16, 128, dtype=torch.bfloat16)
    kv_pos = torch.full((4, 512), -1, dtype=torch.int32)
    tda._check(q, cache[1], cache[2], torch.zeros(4, dtype=torch.int32),
               kv_pos, 0)


# ------------------------------------------------------ attention decode

def _attn_layer(jp, params):
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["attn"]),
            _layer(params["blocks"], 0)["attn"])


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_attn_decode_matches_jax(dense, kv_dtype):
    jcfg, jp, cfg, params = dense
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    jpa, tpa = _attn_layer(jp, params)
    rng = np.random.RandomState(6)
    B, Sc, KV, hd = 3, 24, cfg.n_kv_heads, cfg.head_dim_
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    kf = rng.randn(B, Sc, KV, hd).astype(np.float32)
    vf = rng.randn(B, Sc, KV, hd).astype(np.float32)
    pos = np.array([10, 23, 30], np.int32)      # row 2: idle past capacity
    kv_pos = _causal_kv_pos(B, Sc, np.minimum(pos, Sc - 1))
    if kv_dtype == "int8":
        jk, jks = jattn.quantize_kv(jnp.asarray(kf))
        jv, jvs = jattn.quantize_kv(jnp.asarray(vf))
        tk, tks = tattn.quantize_kv(torch.from_numpy(kf))
        tv, tvs = tattn.quantize_kv(torch.from_numpy(vf))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        _close(tks, jks, atol=0, rtol=1e-6)
        jscales, tscales = (jks, jvs), (tks, tvs)
    else:
        jk, jv = jnp.asarray(kf), jnp.asarray(vf)
        tk, tv = torch.from_numpy(kf.copy()), torch.from_numpy(vf.copy())
        jscales = tscales = None
    want = jattn.attn_decode(jpa, jcfg, jnp.asarray(x), jk, jv,
                             jnp.asarray(pos), jnp.asarray(kv_pos),
                             scales=jscales)
    got = tattn.attn_decode(tpa, cfg, torch.from_numpy(x), tk, tv,
                            torch.from_numpy(pos), torch.from_numpy(kv_pos),
                            scales=tscales)
    _close(got[0], want[0], atol=LAYER_ATOL, rtol=LAYER_RTOL)
    assert got[1] is tk and got[2] is tv        # written in place
    if kv_dtype == "int8":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for g, w in zip(got[3], want[3]):
            _close(g, w, atol=0, rtol=1e-6)
    else:
        _close(got[1], want[1], atol=LAYER_ATOL, rtol=LAYER_RTOL)
        _close(got[2], want[2], atol=LAYER_ATOL, rtol=LAYER_RTOL)


@pytest.mark.parametrize("window", [0, 8])
def test_update_kv_pos_matches_jax(window):
    """Plain caches clamp the slot (idle rows step past the capacity);
    windowed caches wrap."""
    Sc = 8
    kv_pos = np.full((4, Sc), -1, np.int32)
    kv_pos[0, :3] = [0, 1, 2]
    pos = np.array([3, 7, 12, 40], np.int32)
    want = jattn.update_kv_pos(jnp.asarray(kv_pos), jnp.asarray(pos), Sc,
                               window)
    src = torch.from_numpy(kv_pos.copy())
    got = tattn.update_kv_pos(src, torch.from_numpy(pos), Sc, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(src.numpy(), kv_pos)     # not aliased


# ------------------------------------------------- prefill / decode_step

def _cache_cfgs(dense, kind):
    jcfg, jp, cfg, params = dense
    if kind == "ring":
        jcfg = dataclasses.replace(jcfg, sliding_window=8)
        cfg = dataclasses.replace(cfg, sliding_window=8)
    if kind == "int8":
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return jcfg, jp, cfg, params


def _check_cache(got: dict, want: dict):
    assert set(got) == set(want)
    for key in ("pos", "kv_pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in got:
        if key in ("pos", "kv_pos"):
            continue
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        if got[key].dtype == torch.int8:
            # one rounding step of the quantizer may land either side
            diff = np.abs(got[key].numpy().astype(np.int32)
                          - np.asarray(want[key]).astype(np.int32))
            assert diff.max() <= 1, key
        else:
            _close(got[key], want[key])


@pytest.mark.parametrize("kind,S,cache_seq", [("plain", 12, None),
                                              ("padded", 12, 20),
                                              ("ring", 12, 20),
                                              ("int8", 12, 20)])
def test_prefill_matches_jax(dense, kind, S, cache_seq):
    jcfg, jp, cfg, params = _cache_cfgs(dense, kind)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, S)) \
        .astype(np.int32)
    jl, jc = jdec.prefill(jp, jcfg, jnp.asarray(toks), cache_seq=cache_seq)
    tl, tc = tdec.prefill(params, cfg, torch.from_numpy(toks),
                          cache_seq=cache_seq)
    _close(tl, jl)
    _check_cache(tc, jc)
    if kind == "ring":
        assert tc["k"].shape[2] == 8 < S           # wrapped
    if kind == "padded":
        assert (tc["kv_pos"][:, S:] == -1).all()


@pytest.mark.parametrize("kind", ["padded", "ring", "int8"])
def test_decode_step_teacher_forced_matches_jax(dense, kind):
    jcfg, jp, cfg, params = _cache_cfgs(dense, kind)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    forced = rng.randint(0, cfg.vocab_size, (6, 2, 1)).astype(np.int32)
    _, jc = jdec.prefill(jp, jcfg, jnp.asarray(toks), cache_seq=16)
    _, tc = tdec.prefill(params, cfg, torch.from_numpy(toks), cache_seq=16)
    for step in forced:
        jl, jc = jdec.decode_step(jp, jcfg, jc, jnp.asarray(step))
        pos_ref = tc["pos"]
        tl, tc = tdec.decode_step(params, cfg, tc, torch.from_numpy(step))
        _close(tl, jl)
        assert tc["pos"] is not pos_ref            # no alias of the input
    _check_cache(tc, jc)


def test_other_families_name_their_slice():
    """vlm and audio caches have JAX's keys, shapes and dtypes (their
    decode parity is in tests/test_torch_multimodal.py), the int8 scales
    included; moe decodes (its parity with JAX is in
    tests/test_torch_moe.py)."""
    for arch in ("llama-3.2-vision-90b", "whisper-base"):
        for kv in (None, "int8"):
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      kv_cache_dtype=kv)
            jcfg = dataclasses.replace(j_smoke_config(arch),
                                       kv_cache_dtype=kv)
            got = tdec.init_cache(cfg, 2, 8, device="cpu")
            want = jdec.init_cache(jcfg, 2, 8)
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    cfg = get_smoke_config("olmoe-1b-7b")
    params = TM.init_params(cfg, device="cpu")
    logits, cache = tdec.prefill(params, cfg, torch.zeros((1, 5),
                                 dtype=torch.int32), cache_seq=8)
    logits, cache = tdec.decode_step(params, cfg, cache,
                                     torch.ones((1, 1), dtype=torch.int32))
    assert tuple(logits.shape) == (1, 1, cfg.vocab_size)
    assert int(cache["pos"][0]) == 6
    # the config-only helpers cover every family, as in the JAX package
    for arch in ("hymba-1.5b", "rwkv6-7b", "qwen3-1.7b"):
        assert tdec.cache_len_for(get_config(arch), 4096) == \
            jdec.cache_len_for(j_get_config(arch), 4096)
        assert tdec.decode_window(get_smoke_config(arch)) == \
            jdec.decode_window(j_smoke_config(arch))


# ------------------------------------------------------ paged KV arena
#
# Each scenario runs one op sequence of tests/test_decode_serving.py or
# tests/test_disagg.py on an arena module (and its transport's KV frame
# codec) and returns what it observed; the port's copy must observe
# exactly what the JAX package's arena does.

SIG = ("m", 0, 7)


def _fake(n, base=0.0):
    k = (base + np.arange(n * 2, dtype=np.float32)).reshape(n, 1, 1, 2)
    return k, k + 0.5


def _arena(kv, n_blocks=8, bt=4):
    return kv.PagedKVCache(n_blocks, bt, n_layers=1, n_kv_heads=1,
                           head_dim=2)


def _state(a):
    return {"counters": dict(a.counters), "free": a.n_free,
            "k": a._k.copy(), "v": a._v.copy(),
            "index": sorted(map(repr, a._index))}


def sc_roundtrip(kv, tp):
    a = _arena(kv)
    obs = [a.begin(1, SIG, list(range(6)))]
    ks, vs = _fake(6)
    a.write_prompt_kv(1, ks, vs)
    obs.append(a.gather(1))
    a.append(1, 99, ks[0] + 50, vs[0] + 60)
    obs += [a.gather(1), _state(a)]
    return obs


def sc_double_free(kv, tp):
    a = _arena(kv)
    a.begin(1, SIG, [1, 2, 3])
    blk = a._seqs[1].blocks[0]
    a.release(1)
    with pytest.raises(RuntimeError, match="double free") as e:
        a._free_block(blk)
    return [blk.free, str(e.value), _state(a)]


def sc_release(kv, tp):
    a = _arena(kv, 4)
    obs = [a.n_free]
    a.begin(1, SIG, list(range(10)))
    obs.append(a.n_free)
    a.release(1)
    return obs + [_state(a)]


def sc_oom_unwind(kv, tp):
    a = _arena(kv, 2)
    a.begin(1, SIG, list(range(8)))
    with pytest.raises(kv.KVCacheOOM):
        a.begin(2, SIG, list(range(100, 105)))
    return [2 in a._seqs, _state(a)]


def sc_prefix_share(kv, tp):
    a = _arena(kv)
    toks = list(range(8))
    a.begin(1, SIG, toks)
    ks, vs = _fake(8)
    a.write_prompt_kv(1, ks, vs)
    a.finish(1, retain=True)
    obs = [a.begin(2, SIG, toks), [b.ref for b in a._seqs[2].blocks],
           a.gather(2), a.begin(3, ("m", 0, 99), toks)]
    return obs + [_state(a)]


def sc_partial_tail(kv, tp):
    a = _arena(kv)
    a.begin(1, SIG, list(range(6)))
    ks, vs = _fake(6)
    a.write_prompt_kv(1, ks, vs)
    a.finish(1, retain=True)
    obs = [a.begin(2, SIG, [0, 1, 2, 3, 9, 9])]
    a.release(2)
    return obs + [a.begin(3, SIG, list(range(6))), _state(a)]


def sc_cow(kv, tp):
    a = _arena(kv)
    toks = list(range(6))
    a.begin(1, SIG, toks)
    ks, vs = _fake(6)
    a.write_prompt_kv(1, ks, vs)
    a.finish(1, retain=True)
    a.begin(2, SIG, toks)
    tail = a._seqs[2].blocks[-1]
    a.append(2, 77, ks[0] + 100, vs[0])
    obs = [a._seqs[2].blocks[-1] is tail, a.begin(3, SIG, toks),
           a.gather(3, 6), a.gather(2)]
    return obs + [_state(a)]


def sc_lru(kv, tp):
    a = _arena(kv, 2)
    a.begin(1, SIG, list(range(8)))
    a.write_prompt_kv(1, *_fake(8))
    a.finish(1, retain=True)
    obs = [a.n_free]
    a.begin(2, SIG, [50, 51, 52, 53, 54])
    a.release(2)
    return obs + [a.begin(3, SIG, list(range(8))), _state(a)]


def sc_cow_evict(kv, tp):
    a = _arena(kv, 4)
    toks = list(range(6))
    a.begin(1, SIG, toks)
    ks, vs = _fake(6)
    a.write_prompt_kv(1, ks, vs)
    a.finish(1, retain=True)
    a.begin(2, SIG, toks)
    a.append(2, 7, ks[0] + 100, vs[0])
    a.begin(3, ("m", 1, 0), list(range(200, 208)))
    return [a.gather(2), _state(a)]


def sc_util(kv, tp):
    a = _arena(kv, 4)
    obs = [a.util_frac()]
    a.begin(1, SIG, [1, 2])
    return obs + [a.util_frac(), a.has_room(2, n_resident=2),
                  a.has_room(12, n_resident=2),
                  a.has_room(15, n_resident=2), _state(a)]


def sc_chain_keys(kv, tp):
    return [kv.prompt_chain_keys(SIG, (1, 2, 3, 4, 5), 2),
            kv.prompt_chain_keys(("x",), (1, 2, 3, 4, 5), 2),
            kv.prefix_digest(SIG, np.arange(9), 4)]


def _exported(kv, toks, n_blocks=16):
    src = _arena(kv, n_blocks)
    src.begin(1, SIG, toks)
    src.write_prompt_kv(1, *_fake(len(toks)))
    payload = src.export_prefix(1)
    src.finish(1, retain=True)
    return src, payload


def sc_export_import(kv, tp):
    toks = list(range(8))
    src, payload = _exported(kv, toks)
    dst = _arena(kv, 16)
    obs = [payload["sig"], payload["block_tokens"], len(payload["blocks"]),
           dst.import_prefix(SIG, payload["blocks"]),
           dst.begin(2, SIG, toks)]
    dst.release(2)
    return obs + [dst.import_prefix(SIG, payload["blocks"]), _state(dst),
                  _state(src)]


def sc_import_cow(kv, tp):
    toks = list(range(6))
    _, payload = _exported(kv, toks)
    dst = _arena(kv, 16)
    obs = [dst.import_prefix(SIG, payload["blocks"]),
           dst.begin(2, SIG, toks)]
    k1, v1 = _fake(1, base=100.0)
    dst.append(2, 99, k1[0], v1[0])
    dst.release(2)
    return obs + [_state(dst)]


def sc_import_oom(kv, tp):
    toks = list(range(12))
    _, payload = _exported(kv, toks)
    dst = _arena(kv, 2)
    keys = kv.prompt_chain_keys(SIG, tuple(toks), 4)
    return [dst.import_prefix(SIG, payload["blocks"]),
            [k in dst._index for k in keys], _state(dst)]


def sc_kv_frame(kv, tp):
    toks = list(range(8))
    _, payload = _exported(kv, toks)
    frame = tp.encode_kv_blocks(payload)
    # across the wire: the frame codec listifies the tuples
    dec = tp.decode_kv_blocks(tp.decode_frame(tp.encode_frame(
        {"kv": frame}))["kv"])
    dst = _arena(kv, 16)
    dst.import_prefix(dec["sig"], dec["blocks"])
    bad = dict(frame)
    bad["blocks"] = [dict(frame["blocks"][0], filled=99)]
    with pytest.raises(tp.FrameError):
        tp.decode_kv_blocks(bad)
    return [tp.is_kv_frame(frame), tp.kv_frame_nbytes(frame), dec["sig"],
            _state(dst)]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_roundtrip, sc_double_free, sc_release, sc_oom_unwind, sc_prefix_share,
    sc_partial_tail, sc_cow, sc_lru, sc_cow_evict, sc_util, sc_chain_keys,
    sc_export_import, sc_import_cow, sc_import_oom, sc_kv_frame)}


def _same(got, want, where="obs"):
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_paged_kv_arena_matches_jax(name):
    _same(SCENARIOS[name](tkv, ttp), SCENARIOS[name](jkv, jtp), name)


# ------------------------------------------------------- decode serving

@pytest.fixture(scope="module")
def served(dense):
    """Prompts, their JAX reference tokens, and the port's single-pool
    and disaggregated runs of them."""
    jcfg, jp, cfg, params = dense
    from repro_torch.serving.smoke import smoke_fragments
    from repro_torch.core import ProfileBook, arch_layer_costs
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(cfg, seq_len=8),
                                 name=cfg.name))
    frags = smoke_fragments(cfg, 2, seed=0)
    rng = np.random.RandomState(9)
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
        with GraftExecutor(plan, params, cfg, InProcessTransport(),
                           decode_ctx=32, kv_blocks=32, kv_block_tokens=4,
                           decode_disagg=disagg, device="cpu") as ex:
            r = tsmoke.drive_decode(ex, prompts, max_new, disagg=disagg,
                                    abort_at={2: 2})
            r["stats"] = {s["role"]: s for s in ex.pool_stats().values()}
        runs[disagg] = r
    return cfg, book, params, prompts, want, runs


def test_single_pool_tokens_equal_jax_reference(served):
    """Continuous batching (batch 3, 6 streams), mid-decode admission
    and an abort: every finished stream equals the JAX reference."""
    _, _, _, prompts, want, runs = served
    r = runs[False]
    assert r["aborted"] == [2] and r["tokens"][2] is None
    assert r["mid_admits"] >= 1
    for i, got in enumerate(r["tokens"]):
        if i != 2:
            assert got == want[i], f"stream {i}"
    st = r["stats"]["both"]
    assert st["decode_active"] == 0 and st["kv"]["active_seqs"] == 0
    assert st["kv"]["prefix_hits"] >= 1
    assert st["n_compiles"] == 1                    # ("decode", 3) only
    assert st["decode_steps"] == r["steps"]


def test_disagg_tokens_equal_single_pool_and_share_across_hop(served):
    _, _, _, prompts, want, runs = served
    single, split = runs[False], runs[True]
    assert split["tokens"] == single["tokens"]
    assert split["handoffs"] == len(prompts)
    pre, dec = split["stats"]["prefill"], split["stats"]["decode"]
    assert pre["decode_active"] == 0
    assert pre["prefill_exports"] == len(prompts)
    assert dec["kv_handoffs_in"] >= 1
    assert dec["kv"]["handoff_blocks_in"] >= 1
    # the repeated prompt's blocks were already resident on the decode
    # arena: sharing survived the hop
    assert dec["kv"]["handoff_reused"] + dec["kv"]["prefix_hits"] >= 1
    assert dec["kv"]["active_seqs"] == 0


@pytest.fixture
def pool(served):
    cfg, book, params, *_ = served
    from repro_torch.serving.smoke import smoke_fragments
    plan = tsmoke.decode_plan(cfg, book, smoke_fragments(cfg, 2), batch=3)
    with GraftExecutor(plan, params, cfg, InProcessTransport(),
                       decode_ctx=32, kv_blocks=32, kv_block_tokens=4,
                       device="cpu") as ex:
        yield cfg, ex, ex.handle(next(iter(ex.pool_specs())))


def test_mid_decode_admission_preserves_numerics(served, dense, pool):
    """Admitting B into A's RUNNING decode batch must not change either
    stream's tokens vs decoding each alone (tests/test_decode_serving.py's
    sequence, held against the JAX reference)."""
    jcfg, jp = dense[:2]
    cfg, _, handle = pool
    rng = np.random.RandomState(3)
    tA = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    tB = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    refA = jsmoke.reference_decode(jcfg, jp, tA, 5)
    refB = jsmoke.reference_decode(jcfg, jp, tB, 5)
    rA = handle.decode_admit(101, "c0", tA, 5, sig=("s", 0, 0))
    assert rA["admitted"] and rA["tok"] == refA[0]
    for _ in range(2):
        assert handle.decode_step()["active"] == 1
    rB = handle.decode_admit(102, "c1", tB, 5, sig=("s", 0, 0))
    assert rB["admitted"] and rB["tok"] == refB[0]
    out = {}
    for _ in range(8):
        for ev in handle.decode_step()["events"]:
            if ev.get("done"):
                out[ev["rid"]] = ev["tokens"]
    assert out == {101: refA, 102: refB}


def test_decode_abort_frees_slot_and_blocks(pool):
    cfg, _, handle = pool
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, 8) \
        .astype(np.int32)
    assert handle.decode_admit(201, "c0", toks, 16, sig=("a", 0, 0))[
        "admitted"]
    assert handle.stats()["decode_active"] == 1
    assert handle.decode_abort(201)
    s = handle.stats()
    assert s["decode_active"] == 0 and s["kv"]["active_seqs"] == 0
    assert not handle.decode_abort(201)                  # idempotent


def test_ctx_overflow_refused(pool):
    _, _, handle = pool
    r = handle.decode_admit(301, "c0", np.zeros(8, np.int32), 99,
                            sig=("b", 0, 0))
    assert not r["admitted"] and r["reason"] == "ctx_overflow"


def test_decode_step_copies_only_active_rows_to_host(pool, monkeypatch):
    """A step moves the active rows' new-slot KV to the host, never the
    whole batched cache (which on the card would be every layer's
    (B, decode_ctx, KV, hd) block, every step)."""
    cfg, ex, handle = pool
    toks = np.arange(6, dtype=np.int32)
    assert handle.decode_admit(401, "c0", toks, 4, sig=("c",))["admitted"]
    sizes = []
    real_cpu = torch.Tensor.cpu

    def cpu(t, *a, **k):
        sizes.append(t.numel())
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    handle.decode_step()
    monkeypatch.undo()
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    # one active row: (L, 1, KV, hd) for k and for v, (B,) for positions
    # and tokens; the batched cache is (L, 3, 32, KV, hd)
    assert sizes and max(sizes) == L * KV * hd
    handle.decode_abort(401)


def test_disagg_plan_requires_opt_in(served):
    cfg, book, params, *_ = served
    from repro_torch.serving.smoke import smoke_fragments
    plan = tsmoke.disagg_plan(cfg, book, smoke_fragments(cfg, 2))
    with pytest.raises(ValueError, match="decode_disagg"):
        GraftExecutor(plan, params, cfg, InProcessTransport(),
                      decode_ctx=32, kv_block_tokens=4, device="cpu")


def test_orphaned_decode_pool_removal_refused(served):
    from repro_torch.core.plandiff import PoolSpec, decode_pool_key
    from repro_torch.serving.smoke import mixed_depth_plan, smoke_fragments
    cfg, book, params, *_ = served
    frags = smoke_fragments(cfg, 2)
    L = cfg.n_layers
    with GraftExecutor(tsmoke.disagg_plan(cfg, book, frags, batch=4),
                       params, cfg, InProcessTransport(), decode_ctx=32,
                       kv_block_tokens=4, decode_disagg=True,
                       device="cpu") as ex:
        moved = mixed_depth_plan(
            cfg, book, [dataclasses.replace(f, p=1) for f in frags], s=1)
        dspec = PoolSpec(key=decode_pool_key(cfg.name, 0, L), share=50,
                         batch=4, n_instances=1, role="decode")
        bad = dataclasses.replace(moved, meta={"extra_pools": (dspec,)})
        with pytest.raises(RuntimeError, match="no prefill feeder"):
            ex.apply_plan(bad)


def test_resident_decode_stream_blocks_pool_removal(pool, served):
    cfg, ex, handle = pool
    book = served[1]
    from repro_torch.serving.smoke import mixed_depth_plan, smoke_fragments
    assert handle.decode_admit(501, "c0", np.arange(5, dtype=np.int32), 4,
                               sig=("d",))["admitted"]
    moved = mixed_depth_plan(
        cfg, book, [dataclasses.replace(f, p=1)
                    for f in smoke_fragments(cfg, 2)], s=1)
    with pytest.raises(RuntimeError, match="resident decode"):
        ex.apply_plan(moved)
    handle.decode_abort(501)


def test_decode_executor_needs_a_card_by_default(served, monkeypatch):
    cfg, book, params, *_ = served
    from repro_torch.serving.smoke import smoke_fragments
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraftExecutor(tsmoke.decode_plan(cfg, book, smoke_fragments(cfg, 2)),
                      params, cfg, decode_ctx=32)


def test_port_reference_decode_equals_jax(served, dense):
    jcfg, jp, cfg, params = dense
    _, _, _, prompts, want, _ = served
    margins = []
    got = tsmoke.reference_decode(cfg, params, prompts[0][1], 5,
                                  margins=margins)
    assert got == want[0]
    assert len(margins) == 5 and min(margins) >= 0


def test_int8_cache_repeat_prompt_equals_jax_reference(served, dense):
    """An int8 KV cache with a repeated prompt: the arena keeps no int8
    scales, so the port shares no prefix there and both streams equal
    the JAX reference (the JAX executor shares the prefix and decodes the
    repeat wrong: ROADMAP.md section 3)."""
    jcfg, jp = dense[:2]
    cfg, book, params = served[:3]
    from repro_torch.serving.smoke import smoke_fragments
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    toks = np.random.RandomState(10).randint(0, cfg.vocab_size, 20) \
        .astype(np.int32)
    with GraftExecutor(tsmoke.decode_plan(cfg, book,
                                          smoke_fragments(cfg, 1), batch=1),
                       params, cfg, InProcessTransport(), decode_ctx=32,
                       kv_block_tokens=4, device="cpu") as ex:
        r = tsmoke.drive_decode(ex, [("c0", toks), ("c0", toks.copy())], 4)
        (st,) = ex.pool_stats().values()
    want = jsmoke.reference_decode(jcfg, jp, toks, 4)
    assert r["tokens"] == [want, want]
    assert st["kv"]["prefix_hits"] == 0


def test_check_decode_against_reference(served):
    """The smoke's check passes served streams that equal the port's
    reference and names the stream that does not."""
    from repro_torch.serving import ServeRequest
    cfg, _, params, prompts, _, runs = served
    ok = [(ServeRequest(client=c, tokens=t, max_new_tokens=5,
                        out_tokens=got), 5)
          for (c, t), got in zip(prompts, runs[False]["tokens"])
          if got is not None]
    tsmoke.check_decode_against_reference(cfg, params, ok[:2])
    req, n = ok[0]
    bad = ServeRequest(client="bad", tokens=req.tokens, max_new_tokens=n,
                       out_tokens=req.out_tokens[:-1] + [-1])
    with pytest.raises(AssertionError, match="decode mismatch for bad"):
        tsmoke.check_decode_against_reference(cfg, params, [(bad, n)])
