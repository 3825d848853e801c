"""The port's moe family (``repro_torch.models.moe`` and its wiring into
the forward, fragments, packing, decode, serving and the training loss)
against the JAX package, on the CPU at the smoke configs of olmoe-1b-7b
(4 experts, top-2) and llama4-scout (4 experts, top-1 + a shared
expert). Weights are the JAX init converted by ``from_jax_params``;
inputs are numpy arrays from a seed. Tolerances:

* routing indices and the grouped dispatch's drop mask exactly (top-k is
  discontinuous: a flipped index moves a token's output by far more than
  any tolerance);
* router probabilities, gates and the aux loss ``atol=1e-6`` (float32,
  one softmax deep);
* MoE outputs, the forward and every fragment: the reference's fragment
  tolerance ``atol=5e-5, rtol=1e-3``
  (``serving/smoke.py::check_against_monolithic``);
* greedy decode token for token against JAX ``reference_decode``;
* the loss ``rtol=1e-5`` and gradients ``atol=1e-6, rtol=1e-3``, as
  ``tests/test_torch_training.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_smoke_config as j_smoke_config
from repro.core import ProfileBook as JBook
from repro.core import arch_layer_costs as j_layer_costs
from repro.core.fragment import Fragment as JFragment
from repro.models import moe as jmoe
from repro.serving import smoke as jsmoke
from repro.serving.executor import GraftExecutor as JExecutor
from repro.serving.transport import InProcessTransport as JTransport
from repro.training.train_step import lm_loss as j_lm_loss
from repro_torch import models as TM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import Fragment, ProfileBook, arch_layer_costs
from repro_torch.models import decode as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import _layer
from repro_torch.serving import GraftExecutor, InProcessTransport, ServeRequest
from repro_torch.serving import smoke as tsmoke
from repro_torch.serving.executor import shares_prefixes
from repro_torch.training.train_step import lm_loss, loss_and_grads

OLMOE, LLAMA4 = "olmoe-1b-7b", "llama4-scout-17b-a16e"
ARCHS = (OLMOE, LLAMA4)
ATOL, RTOL = 5e-5, 1e-3
ROUTE_ATOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _with_moe(cfg, **kw):
    """``cfg`` with MoE fields (``capacity_factor``, ...) or, for
    ``moe_impl``, the dispatch replaced."""
    impl = kw.pop("moe_impl", None)
    if kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
    return cfg if impl is None else dataclasses.replace(cfg, moe_impl=impl)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg = j_smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, get_smoke_config(arch), \
        TM.from_jax_params(jax.device_get(jp))


def _moe_params(arch, layer=0):
    """Layer ``layer``'s MoE params: (JAX tree, port dict)."""
    _, jp, _, tp = _model(arch)
    return jax.tree.map(lambda a: a[layer], jp["blocks"]["moe"]), \
        _layer(tp["blocks"], layer)["moe"]


def _hidden(cfg, seed, B=2, S=13, zero_rows=3):
    """(B, S, d) block inputs; the last row starts with ``zero_rows``
    zero tokens, whose router logits are all 0 (a tie over every
    expert)."""
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model) \
        .astype(np.float32)
    x[-1, :zero_rows] = 0.0
    return x


# ----------------------------------------------------------- routing

@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax_indices_exactly(arch):
    """Indices equal, ties (the zero rows) included; gates and probs to
    1e-6."""
    jcfg, _, cfg, _ = _model(arch)
    jpm, tpm = _moe_params(arch)
    xf = _hidden(cfg, 1).reshape(-1, cfg.d_model)
    jg, ji, jpr = jmoe._route(jpm, jcfg, jnp.asarray(xf))
    tg, ti, tpr = tmoe._route(tpm, cfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, atol=ROUTE_ATOL, rtol=0)
    _close(tpr, jpr, atol=ROUTE_ATOL, rtol=0)


def test_route_ties_pick_the_lower_expert_as_jax_top_k():
    """Uniform probabilities over olmoe's 64 experts, top 8: JAX's
    top_k picks experts 0..7, and so must the port (``torch.topk``
    orders such ties otherwise)."""
    jcfg, cfg = j_smoke_config(OLMOE), get_smoke_config(OLMOE)
    jcfg = _with_moe(jcfg, n_experts=64, top_k=8)
    cfg = _with_moe(cfg, n_experts=64, top_k=8)
    router = np.zeros((cfg.d_model, 64), np.float32)
    xf = np.random.RandomState(2).randn(5, cfg.d_model).astype(np.float32)
    _, ji, _ = jmoe._route({"router": jnp.asarray(router)}, jcfg,
                           jnp.asarray(xf))
    tg, ti, _ = tmoe._route({"router": torch.from_numpy(router)}, cfg,
                            torch.from_numpy(xf))
    np.testing.assert_array_equal(np.asarray(ji), np.tile(np.arange(8),
                                                          (5, 1)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, np.full((5, 8), 1 / 8), atol=ROUTE_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(arch):
    jcfg, _, cfg, _ = _model(arch)
    jpm, tpm = _moe_params(arch, layer=1)
    xf = _hidden(cfg, 3).reshape(-1, cfg.d_model)
    _, ji, jpr = jmoe._route(jpm, jcfg, jnp.asarray(xf))
    _, ti, tpr = tmoe._route(tpm, cfg, torch.from_numpy(xf))
    E = cfg.moe.n_experts
    _close(tmoe._aux_loss(tpr, ti, E), jmoe._aux_loss(jpr, ji, E),
           atol=ROUTE_ATOL, rtol=0)


# ------------------------------------------------------------ dispatch

@pytest.mark.parametrize("impl", ["dense", "grouped", "expert_parallel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, impl):
    """Each dispatch against the JAX one (``expert_parallel`` takes the
    grouped path in both packages without a mesh), the aux too."""
    jcfg, _, cfg, _ = _model(arch)
    jpm, tpm = _moe_params(arch)
    x = _hidden(cfg, 4)
    jy, ja = jmoe.moe_forward(jpm, jcfg, jnp.asarray(x), impl=impl)
    ty, ta = tmoe.moe_forward(tpm, cfg, torch.from_numpy(x), impl=impl)
    assert ty.shape == x.shape
    _close(ty, jy)
    _close(ta, ja, atol=ROUTE_ATOL, rtol=0)
    with pytest.raises(ValueError):
        tmoe.moe_forward(tpm, cfg, torch.from_numpy(x), impl="megablox")


def _jax_drop_mask(jcfg, eidx) -> np.ndarray:
    """The JAX grouped dispatch's keep mask, per sorted (token, choice)
    pair, by ``repro/models/moe.py``'s own steps: a stable argsort of
    the flat expert ids, rank by exclusive cumsum, rank < capacity."""
    e = jcfg.moe
    N, k = eidx.shape
    cap = int(np.ceil(N * k / e.n_experts * e.capacity_factor))
    cap = min(max(8, -(-cap // 8) * 8), N * k)
    flat = jnp.asarray(eidx).reshape(-1)
    se = flat[jnp.argsort(flat)]
    counts = jnp.sum(jax.nn.one_hot(flat, e.n_experts, dtype=jnp.int32), 0)
    rank = jnp.arange(N * k) - (jnp.cumsum(counts) - counts)[se]
    return np.asarray(rank < cap)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_overflow_drops_the_same_tokens_as_jax(arch):
    """capacity_factor 0.1 (``tests/test_models.py``'s drop test): the
    capacity is 8 for 64 tokens, so tokens drop. The drop mask equals
    JAX's exactly and the outputs agree."""
    jcfg, _, cfg, _ = _model(arch)
    jcfg, cfg = (_with_moe(c, capacity_factor=0.1) for c in (jcfg, cfg))
    jpm, tpm = _moe_params(arch)
    x = _hidden(cfg, 5, B=2, S=32)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, ji, _ = jmoe._route(jpm, jcfg, jnp.asarray(xf.numpy()))
    _, ti, _ = tmoe._route(tpm, cfg, xf)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, _, keep, cap = tmoe.dispatch(cfg, ti)
    want = _jax_drop_mask(jcfg, np.asarray(ji))
    np.testing.assert_array_equal(keep.numpy(), want)
    assert cap == 8 and (~want).sum() > 0
    jy, _ = jmoe.moe_forward(jpm, jcfg, jnp.asarray(x), impl="grouped")
    ty, _ = tmoe.moe_forward(tpm, cfg, torch.from_numpy(x), impl="grouped")
    _close(ty, jy)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_and_dropless(arch):
    """The capacity rule at the published configs, and which configs
    never drop (the ones whose prefixes a decode pool shares)."""
    cfg = get_config(arch)
    e = cfg.moe
    for n in (1, 7, 284, 2048):
        cap = tmoe.capacity(cfg, n)
        assert cap % 8 == 0 or cap == n * e.top_k
        assert min(8, n * e.top_k) <= cap <= n * e.top_k
    if arch == OLMOE:                  # cap 48 against a mean load of 35.5
        assert tmoe.capacity(cfg, 284) == 48
    assert not tmoe.dropless(cfg) and not shares_prefixes(cfg)
    assert tmoe.dropless(_with_moe(cfg, moe_impl="dense"))
    wide = _with_moe(cfg, capacity_factor=e.n_experts / e.top_k)
    assert tmoe.dropless(wide) and shares_prefixes(wide)
    assert all(tmoe.capacity(wide, n) >= n for n in (1, 7, 284, 2048))


# ------------------------------------------------------- model wiring

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_jax_layout(arch):
    """The port's own init (seeded generator) gives the JAX tree's
    leaves, shapes and dtypes, in bfloat16 too: the router stays
    float32, llama4's shared expert is d_ff_expert wide."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(j_smoke_config(arch), dtype=dtype)
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
        jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
        tp = TM.init_params(cfg, seed=0, device="cpu")
        flat, _ = jax.tree_util.tree_flatten_with_path(jp)
        want = {"/".join(str(k.key) for k in path):
                (tuple(a.shape), str(a.dtype)) for path, a in flat}
        got = {}

        def walk(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{pre}{k}/")
                else:
                    got[f"{pre}{k}"] = (tuple(v.shape),
                                        str(v.dtype).replace("torch.", ""))
        walk(tp)
        assert got == want
        assert got["blocks/moe/router"][1] == "float32"
    assert ("blocks/moe/shared/w_up" in want) == (arch == LLAMA4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jp, cfg, tp = _model(arch)
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 17)) \
        .astype(np.int32)
    want, jaux = JM.forward(jp, jcfg, toks)
    got, aux = TM.forward(tp, cfg, torch.from_numpy(toks))
    _close(got, want)
    _close(aux, jaux, atol=ROUTE_ATOL, rtol=0)
    assert float(aux) > 0


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_fragment_matches_jax(arch, start):
    """Every fragment [start, L) of the smoke config (2 layers), embed
    and head included."""
    jcfg, jp, cfg, tp = _model(arch)
    L = cfg.n_layers
    rng = np.random.RandomState(7 + start)
    x = rng.randint(0, cfg.vocab_size, (2, 11)).astype(np.int32) \
        if start == 0 else rng.randn(2, 11, cfg.d_model).astype(np.float32)
    want = JM.run_fragment(jp, jcfg, x, start, L)
    got = TM.run_fragment(tp, cfg, torch.from_numpy(x), start, L)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def _book(cfg):
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(cfg, seq_len=8),
                                 name=cfg.name))
    return book


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_dense_dispatch_serves_the_jax_forward(arch):
    """With the dense dispatch a moe pool runs sequence-packed
    (``is_packable``) and drops the aux; every result of a re-aligned
    depth-2 plan equals the JAX forward. The grouped dispatch takes the
    padded path."""
    jcfg, jp, cfg, tp = _model(arch)
    jcfg, cfg = (_with_moe(c, moe_impl="dense") for c in (jcfg, cfg))
    assert TM.is_packable(cfg) and not TM.is_packable(_model(arch)[2])
    frags = [Fragment(cfg.name, p=p, t=50.0, q=30.0, client=f"c{i}")
             for i, p in enumerate((0, 1, 0))]
    rng = np.random.RandomState(8)
    reqs = [(ServeRequest(client=f.client, tokens=rng.randint(
        0, cfg.vocab_size, n).astype(np.int32)), f.p)
        for f, n in zip(frags, (9, 5, 14))]
    with GraftExecutor(tsmoke.mixed_depth_plan(cfg, _book(cfg), frags, s=1),
                       tp, cfg, InProcessTransport(), device="cpu") as ex:
        ex.serve(reqs)
        stats = ex.pool_stats()
    assert all(st["packed"] for st in stats.values())
    for req, _ in reqs:
        want, _ = JM.forward(jp, jcfg, np.asarray(req.tokens)[None])
        _close(req.result, np.asarray(want)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """Prefill, then teacher-forced decode steps of 2 rows, logits and
    KV against JAX's."""
    jcfg, jp, cfg, tp = _model(arch)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    forced = rng.randint(0, cfg.vocab_size, (4, 2, 1)).astype(np.int32)
    from repro.models import decode as jdec
    jl, jc = jdec.prefill(jp, jcfg, jnp.asarray(toks), cache_seq=16)
    tl, tc = tdec.prefill(tp, cfg, torch.from_numpy(toks), cache_seq=16)
    _close(tl, jl)
    for step in forced:
        jl, jc = jdec.decode_step(jp, jcfg, jc, jnp.asarray(step))
        tl, tc = tdec.decode_step(tp, cfg, tc, torch.from_numpy(step))
        _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])


# -------------------------------------------------------------- decode

def _decode_prompts(cfg):
    """Six streams: four fresh prompts, a repeat of the first and an
    extension of the second (prefix hits where the pool shares)."""
    rng = np.random.RandomState(11)
    base = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in (12, 9, 14, 7)]
    return [(f"c{i % 2}", t) for i, t in enumerate(base)] + [
        ("c0", base[0].copy()),
        ("c1", np.concatenate([base[1], [3, 1, 4]]).astype(np.int32))]


@functools.lru_cache(maxsize=None)
def _reference_tokens(arch):
    jcfg, jp, cfg, _ = _model(arch)
    return [jsmoke.reference_decode(jcfg, jp, t, 5)
            for _, t in _decode_prompts(cfg)]


@pytest.mark.parametrize("disagg", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_served_greedy_decode_equals_jax_reference(arch, disagg):
    """Continuous batching (batch 3, six streams, one aborted) through
    the grouped dispatch, single-pool and disaggregated: every finished
    stream equals the JAX reference token for token. The smoke configs
    never drop (capacity factor 4.0), so the arena shares prefixes."""
    jcfg, jp, cfg, tp = _model(arch)
    prompts = _decode_prompts(cfg)
    want = _reference_tokens(arch)
    frags = tsmoke.smoke_fragments(cfg, 2, seed=0)
    plan = (tsmoke.disagg_plan if disagg else tsmoke.decode_plan)(
        cfg, _book(cfg), frags, batch=3)
    with GraftExecutor(plan, tp, cfg, InProcessTransport(), decode_ctx=32,
                       kv_blocks=32, kv_block_tokens=4,
                       decode_disagg=disagg, device="cpu") as ex:
        r = tsmoke.drive_decode(ex, prompts, 5, disagg=disagg,
                                abort_at={2: 2})
        stats = {s["role"]: s for s in ex.pool_stats().values()}
    assert r["aborted"] == [2] and r["mid_admits"] >= 1
    for i, got in enumerate(r["tokens"]):
        if i != 2:
            assert got == want[i], f"stream {i}"
    assert shares_prefixes(cfg)
    if disagg:
        assert stats["decode"]["kv_handoffs_in"] >= 1
    else:
        assert stats["both"]["kv"]["prefix_hits"] >= 1


def _jax_served(jcfg, jp, prompts, max_new):
    """The JAX executor's greedy tokens for ``prompts``, admitted one
    after another into a batch-1 decode pool (a stream finishes before
    the next one admits), and its arena's prefix hits."""
    jbook = JBook()
    jbook.add(dataclasses.replace(j_layer_costs(jcfg, seq_len=8),
                                  name=jcfg.name))
    frags = [JFragment(jcfg.name, 0, 50.0, 30.0, client="c0")]
    out = []
    with JExecutor(jsmoke.decode_plan(jcfg, jbook, frags, batch=1), jp, jcfg,
                   JTransport(), decode_ctx=64, kv_blocks=32,
                   kv_block_tokens=4) as ex:
        full = (jcfg.name, 0, jcfg.n_layers)
        h = ex.handle(full)
        for client, toks in prompts:
            r = h.decode_admit(ex.next_rid(), client, toks, max_new,
                               sig=full)
            got = [r["tok"]]
            while len(got) < max_new:
                (ev,) = h.decode_step()["events"]
                got.append(ev["tok"])
            out.append(got)
        hits = ex.pool_stats()[full]["kv"]["prefix_hits"]
    return out, hits


def test_prefix_sharing_with_drops_is_exact_in_the_port_only():
    """A grouped olmoe at capacity factor 1.0 drops tokens. Prompt B
    extends prompt A by 24 tokens. The JAX executor shares A's prefix
    KV with B: A's prefill routed 16 tokens (capacity 8), B's reference
    prefill routes 40 (capacity 24), so other prefix tokens drop, and
    its served B diverges from ``reference_decode`` (ROADMAP.md section
    3). The port shares no prefix for a dispatch that can drop, and
    serves both prompts token for token as the JAX reference."""
    jcfg, jp, cfg, tp = _model(OLMOE)
    jcfg, cfg = (_with_moe(c, capacity_factor=1.0) for c in (jcfg, cfg))
    assert not tmoe.dropless(cfg) and not shares_prefixes(cfg)
    rng = np.random.RandomState(3)
    a = rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
    b = np.concatenate([a, rng.randint(0, cfg.vocab_size, 24)
                        .astype(np.int32)])
    prompts = [("c0", a), ("c0", b)]
    want = [jsmoke.reference_decode(jcfg, jp, t, 6) for _, t in prompts]
    jgot, jhits = _jax_served(jcfg, jp, prompts, 6)
    assert jhits >= 1 and jgot[0] == want[0] and jgot[1] != want[1]
    frags = [Fragment(cfg.name, 0, 50.0, 30.0, client="c0")]
    with GraftExecutor(tsmoke.decode_plan(cfg, _book(cfg), frags, batch=1),
                       tp, cfg, InProcessTransport(), decode_ctx=64,
                       kv_blocks=32, kv_block_tokens=4, device="cpu") as ex:
        r = tsmoke.drive_decode(ex, prompts, 6)
        (st,) = ex.pool_stats().values()
    assert r["tokens"] == want
    assert st["kv"]["prefix_hits"] == 0


# ------------------------------------------------------------ training

@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    jcfg, jp, _, _ = _model(arch)
    rng = np.random.RandomState(12)
    toks = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    (loss, parts), grads = jax.value_and_grad(
        lambda p: j_lm_loss(p, jcfg, toks, labels), has_aux=True)(jp)
    return toks, labels, float(loss), {k: float(v) for k, v in
                                       parts.items()}, grads


def _leaves(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {f"{pre}{k}": v})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_the_aux_matches_jax(arch):
    """The loss adds router_aux_weight times the forward's aux; the
    loss, its parts and every gradient (router included) equal JAX's."""
    _, _, cfg, tp = _model(arch)
    toks, labels, jloss, jparts, jgrads = _jax_loss_and_grads(arch)
    loss, parts = lm_loss(tp, cfg, torch.from_numpy(toks),
                          torch.from_numpy(labels))
    _close(loss, jloss, atol=0, rtol=1e-5)
    _close(parts["moe_aux"], jparts["moe_aux"], atol=0, rtol=1e-5)
    _close(parts["ce"], jparts["ce"], atol=0, rtol=1e-5)
    assert float(parts["moe_aux"]) > 0
    _close(loss, float(parts["ce"]) + cfg.moe.router_aux_weight
           * float(parts["moe_aux"]), atol=0, rtol=1e-6)
    _, _, grads = loss_and_grads(tp, cfg, torch.from_numpy(toks),
                                 torch.from_numpy(labels))
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in flat}
    got = _leaves(grads)
    assert set(got) == set(want)
    assert float(got["blocks/moe/router"].abs().max()) > 0
    for name, w in want.items():
        try:
            _close(got[name], w, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        except AssertionError as e:
            raise AssertionError(f"leaf {name}: {e}") from None


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_moe_gradients(remat):
    """Recomputing the moe blocks (their forward returns the aux too)
    changes neither the loss nor any gradient."""
    _, _, cfg, tp = _model(OLMOE)
    toks, labels = (torch.from_numpy(a) for a in
                    _jax_loss_and_grads(OLMOE)[:2])
    l0, p0, g0 = loss_and_grads(tp, cfg, toks, labels, remat=False)
    l1, p1, g1 = loss_and_grads(tp, cfg, toks, labels, remat=remat)
    assert float(l0) == float(l1)
    assert float(p0["moe_aux"]) == float(p1["moe_aux"])
    for a, b in zip(_leaves(g0).values(), _leaves(g1).values()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
