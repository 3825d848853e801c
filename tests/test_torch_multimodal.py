"""The port's vlm and audio families against the JAX package, on the CPU.

Smoke configs: llama-3.2-vision-90b at 4 layers with a cross block every
2 (2 superblocks, 17 image tokens) and whisper-base at 2 decoder and 2
encoder layers over 16 frames. Weights are the JAX init converted by
``from_jax_params``, with the vlm cross blocks' gates set away from the
init's 0 (tanh(0) = 0 would pass every cross block through); stub image
and frame embeddings are the JAX stub's arrays. The JAX side runs on its
reference ops. Tolerance ``atol=5e-5, rtol=1e-3`` (the reference's
fragment tolerance, ``serving/smoke.py::check_against_monolithic``)
unless named; greedy streams token for token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.config import reduced as j_reduced
from repro.configs import get_config as j_get_config
from repro.core import GraftPlanner as JPlanner
from repro.core import arch_layer_costs as j_arch_costs
from repro.core import plan_pools as j_plan_pools
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models.transformer import encode_audio as j_encode_audio
from repro.serving import smoke as jsmoke
from repro.serving.executor import GraftExecutor as JExecutor
from repro.training import lm_loss as j_lm_loss
from repro_torch import models as TM
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.core import (Fragment, GraftPlanner, arch_layer_costs,
                              plan_pools)
from repro_torch.core.measured import measure_layer_costs
from repro_torch.core.plandiff import PoolSpec
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import stubs
from repro_torch.models.transformer import slice_params
from repro_torch.serving import GraftExecutor, ServeRequest
from repro_torch.serving import smoke as tsmoke
from repro_torch.serving.executor import FragmentInstance
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step)
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_step import loss_and_grads

ATOL, RTOL = 5e-5, 1e-3
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-base"
# smoke depths: vlm 2 superblocks of 2; audio the reduced default
DEPTH = {VLM: 4, AUDIO: 2}


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _model(arch, kv_cache_dtype=None):
    """(JAX cfg, JAX params, port cfg, port params) at the smoke depth."""
    jcfg = j_reduced(j_get_config(arch), n_layers=DEPTH[arch])
    cfg = reduced(get_config(arch), n_layers=DEPTH[arch])
    if kv_cache_dtype:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_cache_dtype)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    if "cross_blocks" in jp:
        G = jp["cross_blocks"]["gate_attn"].shape[0]
        jp["cross_blocks"]["gate_attn"] = jnp.linspace(0.6, 1.1, G)
        jp["cross_blocks"]["gate_mlp"] = jnp.linspace(-0.5, 0.8, G)
    return jcfg, jp, cfg, TM.from_jax_params(jax.device_get(jp))


def _extras(jcfg, batch, seed=3):
    """(JAX stub extras, the same arrays as port tensors)."""
    ex = JM.make_extras(jcfg, batch, jax.random.PRNGKey(seed))
    return ex, {k: _t(v) for k, v in ex.items()}


def _with_memory(jp, jcfg, ex, tex):
    """Audio fragments read the encoder's memory: add it (JAX's) to
    both packages' extras."""
    if jcfg.family != "audio":
        return ex, tex
    mem = j_encode_audio(jp, jcfg, ex["frames"])
    return {**ex, "memory": mem}, {**tex, "memory": _t(mem)}


def _tokens(cfg, *shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("length,dim", [(16, 256), (1500, 512), (7, 6)])
def test_sinusoid_pos_emb_matches_jax(length, dim):
    """Angles reach ``length`` radians, where one float32 ulp is about
    length * 2^-24 and the two libraries' exp and sin round apart by a
    few ulps: atol is 4 such ulps, at least 2e-5."""
    _close(tlayers.sinusoid_pos_emb(length, dim),
           jlayers.sinusoid_pos_emb(length, dim),
           atol=max(2e-5, 4 * length * 2.0 ** -24), rtol=0)


def test_encode_audio_matches_jax():
    jcfg, jp, cfg, tp = _model(AUDIO)
    ex, tex = _extras(jcfg, 2)
    _close(TM.encode_audio(tp, cfg, tex["frames"]),
           j_encode_audio(jp, jcfg, ex["frames"]))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_norm_and_mlp_flavours_match_jax(arch):
    """whisper's layernorm with bias and plain GELU MLP, llama's RMSNorm
    and SwiGLU, one op deep on one block's weights."""
    jcfg, jp, cfg, tp = _model(arch)
    x = np.random.RandomState(1).randn(2, 5, cfg.d_model).astype(np.float32)
    ln = {k: np.asarray(v).reshape(-1, v.shape[-1])[0]
          for k, v in jp["blocks"]["ln1"].items()}
    assert ("bias" in ln) == (arch == AUDIO)
    _close(tlayers.apply_norm({k: _t(v) for k, v in ln.items()}, cfg, _t(x)),
           jlayers.apply_norm(ln, jcfg, x), atol=1e-5, rtol=0)
    mlp = {k: np.asarray(v).reshape(-1, *v.shape[-2:])[0] if v.ndim > 2
           else np.asarray(v).reshape(-1, v.shape[-1])[0]
           for k, v in jp["blocks"]["mlp"].items()}
    assert ("w_gate" in mlp) == (arch == VLM)
    _close(tlayers.apply_mlp({k: _t(v) for k, v in mlp.items()}, cfg,
                             _t(x)),
           jlayers.apply_mlp(mlp, jcfg, x), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", [VLM, AUDIO, "qwen3-1.7b"])
def test_make_extras_shapes_and_dtypes_match_jax(arch):
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    want = {k: (tuple(s.shape), str(s.dtype))
            for k, s in JM.extras_shapes(jcfg, 3).items()}
    got = {k: (tuple(s), str(dt).replace("torch.", ""))
           for k, (s, dt) in stubs.extras_shapes(cfg, 3).items()}
    assert got == want
    ex = TM.make_extras(cfg, 3, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in ex.items()} == want
    for v in ex.values():                 # normal x 0.02
        assert 0.015 < float(v.float().std()) < 0.025
    again = TM.make_extras(cfg, 3, torch.Generator().manual_seed(0),
                           device="cpu")
    assert all(torch.equal(ex[k], again[k]) for k in ex)
    bf = TM.make_extras(dataclasses.replace(cfg, dtype="bfloat16"), 1,
                        device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf.values())


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_jax(arch):
    jcfg, jp, cfg, tp = _model(arch)
    ex, tex = _extras(jcfg, 2)
    toks = _tokens(cfg, 2, 12)
    want, jaux = JM.forward(jp, jcfg, jnp.asarray(toks), extras=ex)
    got, aux = TM.forward(tp, cfg, _t(toks), extras=tex)
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0


def test_vlm_cross_blocks_matter():
    """With the gates set, the image embeddings change the logits (the
    parity tests would pass vacuously on zero gates)."""
    jcfg, _, cfg, tp = _model(VLM)
    _, tex = _extras(jcfg, 1)
    toks = _t(_tokens(cfg, 1, 8))
    a, _ = TM.forward(tp, cfg, toks, extras=tex)
    b, _ = TM.forward(tp, cfg, toks,
                      extras={"images": tex["images"] * 3.0})
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_fragment_composition_matches_jax(arch):
    """[0, k) then [k, L) equals [0, L) and the JAX run_fragment of each
    range (audio fragments fed the encoder's memory)."""
    jcfg, jp, cfg, tp = _model(arch)
    ex, tex = _with_memory(jp, jcfg, *_extras(jcfg, 2))
    toks = _tokens(cfg, 2, 12, seed=1)
    L = TM.n_fragment_units(cfg)
    assert L == JM.n_fragment_units(jcfg) == (2 if arch == VLM else 2)
    whole = TM.run_fragment(tp, cfg, _t(toks), 0, L, extras=tex)
    _close(whole, JM.run_fragment(jp, jcfg, jnp.asarray(toks), 0, L,
                                  extras=ex))
    for k in range(1, L):
        mid = TM.run_fragment(tp, cfg, _t(toks), 0, k, extras=tex)
        jmid = JM.run_fragment(jp, jcfg, jnp.asarray(toks), 0, k, extras=ex)
        _close(mid, jmid)
        _close(TM.run_fragment(tp, cfg, mid, k, L, extras=tex), whole)
    full, _ = TM.forward(tp, cfg, _t(toks), extras=tex)
    _close(whole, full.numpy())


def test_vlm_slice_params_with_offset():
    """A worker's slice of superblock 1 (its self stack and its cross
    block) runs [1, 2) with offset 1 as the whole tree does."""
    jcfg, jp, cfg, tp = _model(VLM)
    _, tex = _extras(jcfg, 2)
    toks = _t(_tokens(cfg, 2, 10))
    h = TM.run_fragment(tp, cfg, toks, 0, 1, extras=tex)
    part = slice_params(tp, cfg, 1, 2)
    assert part["cross_blocks"]["gate_attn"].shape == (1,)
    assert part["blocks"]["attn"]["wq"].shape[:2] == (1, 2)
    assert "embed" not in part and "lm_head" in part
    got = TM.run_fragment(part, cfg, h, 1, 2, extras=tex, offset=1)
    _close(got, TM.run_fragment(tp, cfg, h, 1, 2, extras=tex))
    head = slice_params(tp, cfg, 0, 1)
    assert "embed" in head and "final_norm" not in head
    _close(TM.run_fragment(head, cfg, toks, 0, 1, extras=tex), h)


# ------------------------------------------------------------ decode

@pytest.mark.parametrize("arch,kv", [(VLM, None), (VLM, "int8"),
                                     (AUDIO, None), (AUDIO, "int8")])
def test_prefill_and_decode_step_match_jax(arch, kv):
    """prefill(S-1) + decode_step: logits against JAX's and the forward's,
    and every cache entry (self k/v, int8 scales, img_k/img_v, xk/xv)
    against JAX's cache (int8 values within one step of rounding)."""
    jcfg, jp, cfg, tp = _model(arch, kv)
    ex, tex = _extras(jcfg, 2)
    S = 12
    toks = _tokens(cfg, 2, S, seed=2)
    jl, jc = jdec.prefill(jp, jcfg, jnp.asarray(toks[:, :S - 1]), extras=ex,
                          cache_seq=S + 2)
    tl, tc = tdec.prefill(tp, cfg, _t(toks[:, :S - 1]), extras=tex,
                          cache_seq=S + 2)
    _close(tl, jl)
    jl, jc = jdec.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, S - 1:]))
    tl, tc = tdec.decode_step(tp, cfg, tc, _t(toks[:, S - 1:]))
    _close(tl, jl)
    if kv is None:
        full, _ = TM.forward(tp, cfg, _t(toks), extras=tex)
        _close(tl[:, 0], full[:, S - 1].numpy())
    assert set(tc) == set(jc)
    want_keys = {"img_k", "img_v"} if arch == VLM else {"xk", "xv"}
    assert want_keys <= set(tc)
    assert ("k_scale" in tc) == (kv == "int8")
    for key, want in jc.items():
        got = tc[key]
        assert tuple(got.shape) == tuple(want.shape), key
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), key
        if got.dtype == torch.int8:
            diff = np.abs(got.numpy().astype(np.int32)
                          - np.asarray(want).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, key
        elif got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_greedy_stream_is_token_exact_against_jax(arch):
    """A 6-token greedy stream by prefill + decode_step in both packages,
    each row under its own extras."""
    jcfg, jp, cfg, tp = _model(arch)
    ex, tex = _extras(jcfg, 2, seed=5)
    prompt = _tokens(cfg, 2, 9, seed=6)
    jl, jc = jdec.prefill(jp, jcfg, jnp.asarray(prompt), extras=ex,
                          cache_seq=16)
    tl, tc = tdec.prefill(tp, cfg, _t(prompt), extras=tex, cache_seq=16)
    jout, tout = [], []
    for _ in range(6):
        jt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        tt = tl[:, -1].argmax(-1).to(torch.int32)
        jout.append(jt.tolist())
        tout.append(tt.tolist())
        jl, jc = jdec.decode_step(jp, jcfg, jc, jnp.asarray(jt[:, None]))
        tl, tc = tdec.decode_step(tp, cfg, tc, tt[:, None])
    assert tout == jout


def test_cross_attention_decode_reads_the_cache_and_leaves_it():
    """attn_decode with cross_kv attends to all of the precomputed k/v
    (non-causal, Sq = 1) and returns the cache arguments untouched."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jcfg, jp, cfg, tp = _model(AUDIO)
    p = {k: np.asarray(v[0]) for k, v in jp["blocks"]["xattn"].items()}
    rng = np.random.RandomState(9)
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    mem = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    jk, jv = jattn.project_cross_kv(p, jcfg, mem)
    tp_ = {k: _t(v) for k, v in p.items()}
    tk, tv = tattn.project_cross_kv(tp_, cfg, _t(mem))
    _close(tk, jk, atol=1e-5, rtol=1e-4)
    pos = np.array([3, 7], np.int32)
    jo, *_ = jattn.attn_decode(p, jcfg, x, None, None, pos, None,
                               cross_kv=(jk, jv))
    sentinel = torch.zeros(1)
    to, ck, cv, sc = tattn.attn_decode(tp_, cfg, _t(x), sentinel, None,
                                       _t(pos), None, cross_kv=(tk, tv))
    _close(to, jo, atol=1e-5, rtol=1e-4)
    assert ck is sentinel and cv is None and sc is None


# ------------------------------------------------------------ serving

def _spec(cfg, start, end, batch=4):
    return PoolSpec(key=(cfg.name, start, end), share=100, batch=batch,
                    n_instances=1)


def test_padded_executor_mixed_extras_batch_per_request():
    """test_mixed_extras_batch_per_request's twin: a flushed batch whose
    requests carry different images runs each under its own."""
    jcfg, jp, cfg, tp = _model(VLM)
    L = TM.n_fragment_units(cfg)
    inst = FragmentInstance(tp, cfg, _spec(cfg, 0, L))
    assert not inst.packed
    rng = np.random.RandomState(4)
    T = cfg.vision.n_image_tokens
    reqs = []
    for i in range(3):
        img = rng.randn(1, T, cfg.d_model).astype(np.float32) * 0.02
        req = ServeRequest(client=f"c{i}", tokens=_tokens(cfg, 6, seed=i),
                           extras={"images": img})
        inst.submit(req, _t(req.tokens))
        reqs.append(req)
    got = {id(r): y for r, y in inst.flush()}
    assert inst.n_batches == 1
    for req in reqs:
        want = JM.run_fragment(jp, jcfg, np.asarray(req.tokens)[None], 0, L,
                               extras=req.extras)
        _close(got[id(req)], want[0])


def test_padded_executor_splits_extras_shape_groups():
    """test_extras_shape_groups_never_share_a_batch's twin: requests
    whose image shapes differ run as separate executions."""
    jcfg, jp, cfg, tp = _model(VLM)
    L = TM.n_fragment_units(cfg)
    inst = FragmentInstance(tp, cfg, _spec(cfg, 0, L))
    rng = np.random.RandomState(5)
    T = cfg.vision.n_image_tokens
    reqs = []
    for i, t in enumerate((T, 2 * T, T)):
        img = rng.randn(1, t, cfg.d_model).astype(np.float32) * 0.02
        req = ServeRequest(client=f"c{i}", tokens=_tokens(cfg, 6, seed=i),
                           extras={"images": img})
        inst.submit(req, _t(req.tokens))
        reqs.append(req)
    got = {id(r): y for r, y in inst.flush()}
    assert inst.n_batches == 2
    for req in reqs:
        want = JM.run_fragment(jp, jcfg, np.asarray(req.tokens)[None], 0, L,
                               extras=req.extras)
        _close(got[id(req)], want[0])


@functools.lru_cache(maxsize=None)
def _fault_run():
    """The Motivation's input: the vlm smoke config at 4 layers (2
    superblocks), smoke_setup seed 0, smoke_fragments(cfg, 3) (p = 0, 0,
    1), GraftPlanner plans, smoke_requests(seq_len=16, seed=1) each with
    make_extras(cfg, 1); both packages' executors serve them."""
    jcfg, jbook, jp = jsmoke.smoke_setup(VLM, n_layers=4, seed=0)
    jfrags = jsmoke.smoke_fragments(jcfg, 3)
    jplan = JPlanner(jbook).plan(jfrags)
    jreqs = jsmoke.smoke_requests(jcfg, jfrags, seq_len=16, seed=1)
    jex = JM.make_extras(jcfg, 1)
    for r, _ in jreqs:
        r.extras = jex
    jout = JExecutor(jplan, jp, jcfg).serve(jreqs)

    cfg, book, _ = tsmoke.smoke_setup(VLM, n_layers=4, seed=0, device="cpu")
    tp = TM.from_jax_params(jax.device_get(jp))
    frags = tsmoke.smoke_fragments(cfg, 3)
    plan = GraftPlanner(book).plan(frags)
    reqs = tsmoke.smoke_requests(cfg, frags, seq_len=16, seed=1)
    tex = {k: _t(v) for k, v in jex.items()}
    for r, _ in reqs:
        r.extras = tex
    out = GraftExecutor(plan, tp, cfg, device="cpu").serve(reqs)
    return jcfg, jp, jplan, jout, cfg, plan, out, jex


def test_vlm_planner_units_are_superblocks_in_the_port_only():
    """The reference's cost book counts a vlm model's layers, so its
    planner's pools end at unit 4 of 2 and its executor never applies
    the head: every result is a (16, 256) hidden state. The port's book
    counts superblocks (same per-model sums), its pools end at 2, and it
    serves the logits JAX's run_fragment(0, 2) gives."""
    jcfg, jp, jplan, jout, cfg, plan, out, jex = _fault_run()
    assert [f.p for f in jsmoke.smoke_fragments(jcfg, 3)] == [0, 0, 1]
    assert sorted(k[1:] for k in j_plan_pools(jplan)) == [(0, 4), (1, 4)]
    assert all(np.asarray(r.result).shape == (16, cfg.d_model)
               for r in jout)
    assert sorted(k[1:] for k in plan_pools(plan)) == [(0, 2), (1, 2)]
    for r in out:
        want = JM.run_fragment(jp, jcfg, np.asarray(r.tokens)[None], 0, 2,
                               extras=jex)
        assert tuple(r.result.shape) == (16, cfg.vocab_size)
        _close(r.result, want[0])
    for full in (False, True):
        jc = j_get_config(VLM) if full else jcfg
        costs = arch_layer_costs(jc, seq_len=64)
        jcosts = j_arch_costs(jc, seq_len=64)
        G = jc.n_layers // jc.vision.cross_attn_every
        assert costs.n_layers == G == JM.n_fragment_units(jc)
        assert jcosts.n_layers == jc.n_layers
        for f in ("flops_per_item", "weight_bytes"):
            assert getattr(costs, f).sum() == pytest.approx(
                getattr(jcosts, f).sum(), rel=1e-12)
        np.testing.assert_array_equal(costs.act_bytes,
                                      jcosts.act_bytes[:G + 1])
    for arch in (AUDIO, "qwen3-1.7b", "hymba-1.5b"):
        c, jc = arch_layer_costs(j_get_config(arch)), \
            j_arch_costs(j_get_config(arch))
        for f in ("flops_per_item", "weight_bytes", "act_bytes"):
            np.testing.assert_array_equal(getattr(c, f), getattr(jc, f))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_executor_serves_within_tolerance_across_a_realign(arch):
    """A planner plan, then apply_plan onto a re-aligned depth-2 plan:
    every result equals each request's own forward
    (check_against_monolithic: images for vlm, frames for audio, where
    the served fragments read the memory encoded from them)."""
    jcfg, jp, cfg, tp = _model(arch)
    _, book, _ = tsmoke.smoke_setup(arch, n_layers=DEPTH[arch],
                                    device="cpu")
    L = TM.n_fragment_units(cfg)
    frags = [Fragment(cfg.name, p, t, 30.0, client=f"c{i}")
             for i, (p, t) in enumerate(zip((0, 1, 1, 0),
                                            (60.0, 45.0, 70.0, 55.0)))]
    rng = np.random.RandomState(11)

    def wave():
        reqs = []
        for i, f in enumerate(frags):
            ex, tex = _extras(jcfg, 1, seed=20 + i + len(reqs))
            if arch == AUDIO:
                tex = {"frames": tex["frames"],
                       "memory": TM.encode_audio(tp, cfg, tex["frames"])}
            n = int(rng.randint(5, 14))
            reqs.append((ServeRequest(client=f.client,
                                      tokens=_tokens(cfg, n, seed=i),
                                      extras=tex), f.p))
        return reqs
    with GraftExecutor(GraftPlanner(book).plan(frags), tp, cfg,
                       device="cpu") as ex:
        r1 = wave()
        ex.serve(r1)
        ex.apply_plan(tsmoke.mixed_depth_plan(cfg, book, frags, s=1))
        assert any(len(c) == 2 for c in ex.route_table().values())
        r2 = wave()
        ex.serve(r2)
    for reqs in (r1, r2):
        for req, _ in reqs:
            assert tuple(req.result.shape) == (len(req.tokens),
                                               cfg.vocab_size)
        tsmoke.check_against_monolithic(cfg, tp, reqs)
    assert L == 2


def test_measured_audio_units_read_the_encoded_memory_in_the_port_only():
    """The reference's measure_layer_costs passes the stub's frames where
    an audio fragment reads the encoder's memory, and raises KeyError
    'memory'; the port times every unit of both families."""
    from repro.core.measured import measure_layer_costs as j_measure
    jcfg, jp, cfg, tp = _model(AUDIO)
    with pytest.raises(KeyError, match="memory"):
        j_measure(jcfg, jp, seq_len=8, reps=1)
    for arch in (AUDIO, VLM):
        cfg, tp = _model(arch)[2:]
        costs = measure_layer_costs(cfg, tp, seq_len=8, reps=1)
        assert costs.n_layers == TM.n_fragment_units(cfg)
        assert np.isfinite(costs.flops_per_item).all()


# ------------------------------------------------------------ training

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_lm_loss_and_gradients_match_jax(arch):
    """The loss with extras and its gradients (remat on, the default), the
    audio encoder's and the vlm cross blocks' included."""
    jcfg, jp, cfg, tp = _model(arch)
    ex, tex = _extras(jcfg, 2)
    toks = _tokens(cfg, 2, 10, seed=7)
    labels = _tokens(cfg, 2, 10, seed=8)
    (want, _), jgrads = jax.value_and_grad(
        lambda p: j_lm_loss(p, jcfg, toks, labels, extras=ex),
        has_aux=True)(jp)
    loss, _, grads = loss_and_grads(tp, cfg, _t(toks), _t(labels),
                                    extras=tex)
    _close(loss, want, atol=0, rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    jl = {"/".join(str(k.key) for k in path): np.asarray(g)
          for path, g in flat}

    def leaves(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(leaves(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {f"{pre}{k}": v})
        return out
    tl = leaves(grads)
    assert set(tl) == set(jl)
    key = "enc_blocks/attn/wq" if arch == AUDIO else "cross_blocks/xattn/wk"
    assert float(np.abs(jl[key]).max()) > 0
    for name, g in jl.items():
        _close(tl[name], g, atol=1e-6, rtol=1e-3)


def test_vlm_microbatches_match_one_batch():
    """microbatches=2 splits the images with the tokens and accumulates
    to the one-batch step (the port's fp32 sums differ by rounding)."""
    jcfg, _, cfg, tp = _model(VLM)
    _, tex = _extras(jcfg, 4)
    batch = {"tokens": _tokens(cfg, 4, 8, seed=1),
             "labels": _tokens(cfg, 4, 8, seed=2)}
    outs = {}
    for k in (1, 2):
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), microbatches=k)
        p2, _, m = step(tp, init_opt_state(tp), dict(batch), tex)
        outs[k] = (p2, float(m["loss"]), float(m["grad_norm"]))
    assert abs(outs[1][1] - outs[2][1]) < 1e-5
    assert abs(outs[1][2] - outs[2][2]) < 1e-4 * outs[1][2]
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[2][0])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
