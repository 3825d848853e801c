"""The port's dense transformer (``repro_torch.models``) against the JAX
package, on the same weights (``from_jax_params``) and the same numpy
inputs. Fragment outputs are held to the reference's own tolerance,
``atol=5e-5, rtol=1e-3`` (``serving/smoke.py::check_against_monolithic``);
layer primitives to ``atol=1e-5`` (float32, one op deep)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_smoke_config as j_smoke_config
from repro.models import layers as jlayers
from repro.models.packed import pack_segments as j_pack_segments
from repro.models.packed import run_fragment_packed as j_run_packed
from repro_torch import models as TM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as tlayers
from repro_torch.models.packed import pack_segments, run_fragment_packed

ATOL, RTOL = 5e-5, 1e-3
ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def dense():
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg = j_smoke_config(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, get_smoke_config(ARCH), \
        TM.from_jax_params(jax.device_get(jp))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _tokens(rng, cfg, *shape):
    return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ primitives

def test_rope_interleaved_pairs_match_jax():
    """The likeliest silent mismatch: RoPE rotates (x[0::2], x[1::2])
    pairs, not the rotate-half layout."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, cfg.head_dim_).astype(np.float32)
    pos = rng.randint(0, 100, (2, 7)).astype(np.int32)
    jcos, jsin = jlayers.rope_freqs(j_smoke_config(ARCH), jnp.asarray(pos))
    cos, sin = tlayers.rope_freqs(cfg, torch.from_numpy(pos))
    _close(cos, jcos, atol=1e-5, rtol=0)
    _close(sin, jsin, atol=1e-5, rtol=0)
    _close(tlayers.apply_rope(torch.from_numpy(x), cos, sin),
           jlayers.apply_rope(x, jcos, jsin), atol=1e-5, rtol=0)
    # and it is not rotate-half
    half = cfg.head_dim_ // 2
    xt = torch.from_numpy(x)
    rot_half = xt * torch.cat([cos, cos], -1)[..., None, :] + torch.cat(
        [-xt[..., half:], xt[..., :half]], -1) * torch.cat(
        [sin, sin], -1)[..., None, :]
    assert not torch.allclose(rot_half, tlayers.apply_rope(xt, cos, sin),
                              atol=1e-3)


@pytest.mark.parametrize("fn", ["apply_norm", "rms_head_norm"])
def test_norms_match_jax(fn):
    """apply_norm eps 1e-5, rms_head_norm eps 1e-6, on tiny-magnitude
    inputs where the eps shows."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 32) * 1e-3).astype(np.float32)
    scale = rng.rand(32).astype(np.float32) + 0.5
    if fn == "apply_norm":
        want = jlayers.apply_norm({"scale": scale}, j_smoke_config(ARCH), x)
        got = tlayers.apply_norm({"scale": torch.from_numpy(scale)},
                                 get_smoke_config(ARCH), torch.from_numpy(x))
    else:
        want = jlayers.rms_head_norm(scale, x)
        got = tlayers.rms_head_norm(torch.from_numpy(scale),
                                    torch.from_numpy(x))
    _close(got, want, atol=1e-5, rtol=1e-5)


def test_mlp_matches_jax(dense):
    jcfg, jp, cfg, tp = dense
    x = np.random.RandomState(2).randn(2, 5, cfg.d_model).astype(np.float32)
    jmlp = jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"])
    tmlp = {k: v[0] for k, v in tp["blocks"]["mlp"].items()}
    _close(tlayers.apply_mlp(tmlp, cfg, torch.from_numpy(x)),
           jlayers.apply_mlp(jmlp, jcfg, x), atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------ full model

def test_forward_matches_jax(dense):
    jcfg, jp, cfg, tp = dense
    toks = _tokens(np.random.RandomState(3), cfg, 2, 13)
    want, _ = JM.forward(jp, jcfg, toks)
    _close(TM.forward(tp, cfg, torch.from_numpy(toks))[0], want)


def _ranges():
    L = get_smoke_config(ARCH).n_layers
    return [(s, e) for s in range(L) for e in range(s + 1, L + 1)]


@pytest.mark.parametrize("start,end", _ranges())
def test_run_fragment_matches_jax(dense, start, end):
    """Every (start, end) of the smoke config, embed and head included."""
    jcfg, jp, cfg, tp = dense
    rng = np.random.RandomState(10 * start + end)
    x = _tokens(rng, cfg, 2, 11) if start == 0 else \
        rng.randn(2, 11, cfg.d_model).astype(np.float32)
    want = JM.run_fragment(jp, jcfg, x, start, end)
    got = TM.run_fragment(tp, cfg, torch.from_numpy(x), start, end)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_fragments_compose_to_forward(dense):
    _, _, cfg, tp = dense
    toks = torch.from_numpy(_tokens(np.random.RandomState(4), cfg, 1, 9))
    h = TM.run_fragment(tp, cfg, toks, 0, 1)
    y = TM.run_fragment(tp, cfg, h, 1, cfg.n_layers)
    _close(y, TM.forward(tp, cfg, toks)[0].numpy())


# ----------------------------------------------------------------- packed

def test_pack_segments_matches_jax():
    for lengths, pad_to in (([3, 5], 16), ([7], 7), ([1, 2, 3, 4], 12)):
        for a, b in zip(pack_segments(lengths, pad_to),
                        j_pack_segments(lengths, pad_to)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pack_segments([9, 9], 16)


@pytest.mark.parametrize("start", [0, 1])
def test_run_fragment_packed_matches_jax(dense, start):
    """Packed ragged execution against JAX's packed output, and against
    the port's own per-request fragments."""
    jcfg, jp, cfg, tp = dense
    rng = np.random.RandomState(5 + start)
    L = cfg.n_layers
    lens = (5, 9, 3) if start == 0 else (4, 7)
    payloads = [_tokens(rng, cfg, n) if start == 0 else
                (rng.randn(n, cfg.d_model) * 0.1).astype(np.float32)
                for n in lens]
    pad_to = 32
    want = j_run_packed(jp, jcfg, payloads, start, L, pad_to=pad_to)
    got = run_fragment_packed(tp, cfg, [torch.from_numpy(p) for p in payloads],
                              start, L, pad_to=pad_to)
    for g, w, p in zip(got, want, payloads):
        _close(g, w)
        solo = TM.run_fragment(tp, cfg, torch.from_numpy(p)[None], start, L)
        _close(g, solo[0].numpy())


# ------------------------------------------------------------------- init

def test_from_jax_params_bf16_is_bit_exact():
    jcfg = dataclasses.replace(j_smoke_config(ARCH), dtype="bfloat16")
    jp = jax.device_get(JM.init_params(jax.random.PRNGKey(1), jcfg))
    tp = TM.from_jax_params(jp)
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["blocks"]["attn"]["q_norm"].dtype == torch.float32
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))
    wq = jp["blocks"]["attn"]["wq"]
    np.testing.assert_array_equal(
        tp["blocks"]["attn"]["wq"].float().numpy(), np.asarray(wq, np.float32))


def test_init_params_has_jax_layout(dense):
    """Same tree, shapes and dtypes as the JAX init — so every module
    that indexes params works on either."""
    _, jp, cfg, _ = dense
    tp = TM.init_params(cfg, seed=3, device="cpu")

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}/"))
            else:
                out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out
    assert flat(tp) == flat(jax.device_get(jp))
    w = tp["blocks"]["attn"]["wq"]
    assert float(w.abs().max()) <= 3.0 / cfg.d_model ** 0.5 + 1e-6


def test_init_params_seeded():
    cfg = get_smoke_config(ARCH)
    a = TM.init_params(cfg, seed=7, device="cpu")
    b = TM.init_params(cfg, seed=7, device="cpu")
    c = TM.init_params(cfg, seed=8, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


def test_init_params_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(get_smoke_config(ARCH))


def test_only_dense_is_ported():
    """Every family builds now (its parity with JAX is in the family's
    own test file): vlm with two leading block axes beside its cross
    blocks, audio with its encoder; a moe model serves its fragments
    (the aux loss comes back with the forward's logits)."""
    vlm = get_smoke_config("llama-3.2-vision-90b")
    tp = TM.init_params(vlm, device="cpu")
    E = vlm.vision.cross_attn_every
    assert tp["blocks"]["attn"]["wq"].shape[:2] == (vlm.n_layers // E, E)
    assert set(tp["cross_blocks"]) == {"ln1", "ln2", "xattn", "mlp",
                                       "gate_attn", "gate_mlp"}
    audio = get_smoke_config("whisper-base")
    tp = TM.init_params(audio, device="cpu")
    assert tp["enc_blocks"]["attn"]["wq"].shape[0] == \
        audio.audio.n_encoder_layers
    assert {"xattn", "lnx"} <= set(tp["blocks"]) and "enc_norm" in tp
    for arch in ("qwen3-1.7b", "hymba-1.5b", "rwkv6-7b"):
        assert TM.init_params(get_smoke_config(arch), device="cpu")["blocks"]
    for arch in ("olmoe-1b-7b", "llama4-scout-17b-a16e"):
        cfg = get_smoke_config(arch)
        tp = TM.init_params(cfg, device="cpu")
        assert "moe" in tp["blocks"] and "mlp" not in tp["blocks"]
        toks = torch.from_numpy(_tokens(np.random.RandomState(5), cfg, 1, 6))
        logits, aux = TM.forward(tp, cfg, toks)
        h = TM.run_fragment(tp, cfg, toks, 0, 1)
        _close(TM.run_fragment(tp, cfg, h, 1, cfg.n_layers),
               logits.numpy())
        assert float(aux) > 0


def test_full_width_config_is_the_registry_one():
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.d_ff, cfg.vocab_size, cfg.n_layers) == \
        (2048, 16, 8, 128, 6144, 151_936, 28)
    assert cfg.qk_norm and cfg.tie_embeddings
