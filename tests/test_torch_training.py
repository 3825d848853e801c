"""The port's training path (``repro_torch.training``, the FA-2 backward and
the trainable attention) against the JAX package, on the CPU.

The same numpy inputs (from a seed) and the same weights
(``from_jax_params``) go through the JAX function and its port. On the
CPU the backward wrapper runs its plain version; the JAX Pallas backward
runs in interpret mode, as the JAX package's kernel tests run it.
Tolerances, all float32:

- attention gradients ``atol=2e-5, rtol=1e-3``: the JAX kernel test's
  own bound (``test_flash_attention_backward``), summation order only;
- AdamW ``atol=1e-6, rtol=1e-5`` on float32 leaves and moments (the same
  elementwise formulas; the rest is float rounding of a few ops); a
  bfloat16 parameter within one bf16 ulp (``rtol=2**-7``): both round
  the same fp32 value, which may sit on either side of a rounding edge;
- loss ``rtol=1e-5``; gradients ``atol=1e-6, rtol=1e-3`` (float32 sums
  over a 2-layer model in another order);
- one train step's new parameters ``atol=1e-4`` = lr / 10: AdamW's first
  step is ``g / (|g| + eps)``, so a gradient entry near ``eps`` that the
  summation order moves by a few percent moves its weight by a few
  percent of lr; a wrong update moves most weights by about lr.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_smoke_config as j_smoke_config
from repro.data.tokens import token_batches as j_token_batches
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention_bwd import _flash_bwd as j_flash_bwd
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import adamw_update as j_adamw_update
from repro.training import init_opt_state as j_init_opt_state
from repro.training import lm_loss as j_lm_loss
from repro.training import make_train_step as j_make_train_step
from repro.training import restore_checkpoint as j_restore
from repro.training import save_checkpoint as j_save
from repro_torch.configs import get_smoke_config
from repro_torch.data import token_batches
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention_lse_plain
from repro_torch.kernels.flash_attention_bwd import (FlashAttention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain)
from repro_torch.models import from_jax_params
from repro_torch.training import (AdamWConfig, adamw_update, init_opt_state,
                                  lm_loss, make_train_step,
                                  restore_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_step import loss_and_grads

ATOL, RTOL = 2e-5, 1e-3
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3
STEP_ATOL = 1e-4
LR = 1e-3


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _jax_leaves(tree) -> dict:
    """{"a/b/c": numpy leaf} of a JAX pytree of dicts."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def _port_leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_port_leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


def _trees_close(port: dict, want, atol, rtol):
    want = _jax_leaves(want)
    got = _port_leaves(port)
    assert set(got) == set(want)
    for name, w in want.items():
        try:
            _close(got[name], w, atol=atol, rtol=rtol)
        except AssertionError as e:
            raise AssertionError(f"leaf {name}: {e}") from None


# ------------------------------------------------------ attention backward

# test_kernels.py::test_flash_attention_backward's shapes, windows 0 and 40
BWD_CASES = [(B, S, H, KV, hd, w)
             for B, S, H, KV, hd in ((1, 64, 2, 1, 32), (2, 96, 4, 2, 32),
                                     (1, 128, 8, 8, 16))
             for w in (0, 40)]


@functools.lru_cache(maxsize=None)
def _bwd_case(case):
    """Numpy q, k, v, dO and the forward's o, lse (the port's plain
    forward, fp32), then the JAX Pallas backward (interpret mode) on
    them, and jax.grad of sum(sin(ref_attention)) as the oracle."""
    B, S, H, KV, hd, window = case
    rng = np.random.RandomState(7)
    q = (rng.randn(B, S, H, hd) * 0.5).astype(np.float32)
    k = (rng.randn(B, S, KV, hd) * 0.5).astype(np.float32)
    v = (rng.randn(B, S, KV, hd) * 0.5).astype(np.float32)
    do = rng.randn(B, S, H, hd).astype(np.float32)
    o, lse = flash_attention_lse_plain(*map(torch.from_numpy, (q, k, v)),
                                       window=window)
    o, lse = o.numpy(), lse.numpy()
    scale = hd ** -0.5
    pallas = j_flash_bwd((q, k, v, o, lse), do, causal=True, window=window,
                         scale=scale, bq=32, bk=32, interpret=True)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jref.ref_attention(q, k, v, causal=True,
                                                  window=window)))
    oracle = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return (q, k, v, o, lse, do), [np.asarray(g) for g in pallas], \
        [np.asarray(g) for g in oracle]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_backward_matches_jax(case):
    """The plain backward equals the JAX Pallas backward on the same
    (q, k, v, o, lse, dO); FlashAttention (CPU: plain forward and
    backward) equals jax.grad of the JAX oracle."""
    window = case[-1]
    arrays, pallas, oracle = _bwd_case(case)
    got = flash_attention_bwd(*map(torch.from_numpy, arrays), causal=True,
                              window=window)
    for name, g, w in zip("dq dk dv".split(), got, pallas):
        assert g.dtype == torch.float32, name
        _close(g, w)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
    torch.sin(FlashAttention.apply(q, k, v, True, window, None)).sum() \
        .backward()
    for g, w in zip((q.grad, k.grad, v.grad), oracle):
        _close(g, w)


@pytest.mark.parametrize("causal,window,Sq,Sk,H,KV", [
    (True, 0, 6, 6, 4, 2), (True, 3, 7, 7, 2, 1), (False, 0, 5, 7, 2, 2)])
def test_flash_attention_gradcheck(causal, window, Sq, Sk, H, KV):
    """torch.autograd.gradcheck (float64) of FlashAttention: the FA-2
    backward against finite differences of its own forward."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, Sq, H, 8, generator=g, dtype=torch.float64)
    k = torch.randn(1, Sk, KV, 8, generator=g, dtype=torch.float64)
    v = torch.randn(1, Sk, KV, 8, generator=g, dtype=torch.float64)
    args = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, None),
        args)


def test_plain_backward_zeroes_rows_with_no_valid_kv():
    """Non-causal with window 2 and Sq 10 > Sk 4: rows 5-9 see no kv, so
    their lse is NEG_INF and p = 0 (the mask before the exponential):
    their dq is 0, and their dO adds nothing to dk or dv."""
    rng = np.random.RandomState(3)
    q, do = (torch.from_numpy(rng.randn(1, 10, 2, 8).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 4, 1, 8).astype(np.float32))
            for _ in range(2))
    kw = dict(causal=False, window=2)
    o, lse = flash_attention_lse_plain(q, k, v, **kw)
    assert (lse[:, :, 5:] == -1e30).all() and (lse[:, :, :5] > -1e3).all()
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert (dq[:, 5:] == 0).all() and (dq[:, :5] != 0).any()
    do2 = do.clone()
    do2[:, 5:] = 0
    _, dk2, dv2 = flash_attention_bwd_plain(q, k, v, o, lse, do2, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _unreadable_views(dtype):
    """(B=1, S=8, H=4, hd=32) views TMA cannot load in bf16: a base off
    16 bytes, a sequence stride off 16 bytes, an expanded (stride 0)
    sequence axis."""
    return {
        "base": torch.zeros(1, 8, 4 * 32 + 1, dtype=dtype)[:, :, 1:]
        .unflatten(2, (4, 32)),
        "seq stride": torch.zeros(1, 8, 4 * 32 + 4, dtype=dtype)[:, :, :128]
        .unflatten(2, (4, 32)),
        "expanded": torch.zeros(1, 1, 4, 32, dtype=dtype).expand(1, 8, 4, 32),
    }


@pytest.mark.parametrize("which", ["base", "seq stride", "expanded"])
@pytest.mark.parametrize("role", ["q", "do", "o"])
def test_backward_tma_checks_apply_to_bf16_only(which, role):
    """The twin of test_tma_checks_apply_to_bf16_only for the backward:
    the bf16 bodies load q, k, v and dO by TMA (and read o with 16-byte
    loads), so a view they cannot read raises before any launch; the
    fp32 bodies read through plain loads and accept it."""
    for dtype in (torch.float32, torch.bfloat16):
        t = {n: torch.zeros(1, 8, 4, 32, dtype=dtype)
             for n in ("q", "do", "o")}
        t[role] = _unreadable_views(dtype)[which]
        k = torch.zeros(1, 8, 2, 32, dtype=dtype)
        lse = torch.zeros(1, 4, 8)
        if dtype == torch.float32:
            fab._check(t["q"], k, k, lse, t["do"], 0, o=t["o"])
        else:
            with pytest.raises(ValueError, match="TMA"):
                fab._check(t["q"], k, k, lse, t["do"], 0, o=t["o"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_packs_an_incoming_gradient_the_kernels_cannot_read(
        dtype, monkeypatch):
    """FlashAttention.backward hands the kernels autograd's dO as it is
    where they can read it, and a packed copy where they cannot: a
    stride-0 view (the gradient of ``(o.sum((0, 1, 2)) * w).sum()``, w
    expanded over B, S and heads) is read by the fp32 bodies as it is,
    but not by TMA in bf16."""
    seen = []

    def spy(q, k, v, o, lse, do, **kw):
        seen.append(do)
        return flash_attention_bwd(q, k, v, o, lse, do, **kw)
    monkeypatch.setattr(fab, "flash_attention_bwd", spy)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 32, generator=g).to(dtype).requires_grad_(True)
    k, v = (torch.randn(1, 8, 2, 32, generator=g).to(dtype)
            .requires_grad_(True) for _ in range(2))
    w = torch.randn(32, generator=g).to(dtype)
    (fab.flash_attention_trainable(q, k, v).sum((0, 1, 2)) * w).sum() \
        .backward()
    (do,) = seen
    assert torch.equal(do, w.expand(1, 8, 4, 32))
    if dtype == torch.bfloat16:
        assert do.is_contiguous() and fab.tma_unreadable(do) is None
    else:
        assert do.stride()[1:3] == (0, 0)
    o, lse = flash_attention_lse_plain(q.detach(), k.detach(), v.detach())
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o,
                                     lse, w.expand(1, 8, 4, 32))
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, ref)


def test_ops_attention_is_differentiable_and_matches_jax():
    """The twin of test_flash_trainable_through_ops: gradients of
    sum(ops.attention) (an expanded, stride-0 incoming gradient) equal
    jax.grad of the JAX ops.attention(impl="naive")."""
    rng = np.random.RandomState(8)
    arrays = [(rng.randn(1, 64, H, 32) * 0.5).astype(np.float32)
              for H in (4, 2, 2)]

    def f(q, k, v):
        return jnp.sum(jops.attention(q, k, v, causal=True, impl="naive"))
    want = jax.grad(f, argnums=(0, 1, 2))(*arrays)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    tops.attention(q, k, v, causal=True).sum().backward()
    for g, w in zip((q.grad, k.grad, v.grad), want):
        _close(g, w)


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("clip", [False, True])
def test_adamw_matches_jax(clip):
    """Three AdamW steps on a float32 and a bfloat16 parameter equal the
    JAX update; with grads of 1e6 the clip bounds the update as in
    test_grad_clip_bounds_update."""
    rng = np.random.RandomState(4)
    w = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    jp = {"w": jnp.asarray(w), "layer": {"b": jnp.asarray(b, jnp.bfloat16)}}
    tp = from_jax_params(jax.device_get(jp))
    jst, tst = j_init_opt_state(jp), init_opt_state(tp)
    jcfg, tcfg = JAdamWConfig(lr=1e-2), AdamWConfig(lr=1e-2)
    for step in range(3):
        g = {"w": rng.randn(4, 6).astype(np.float32),
             "layer": {"b": rng.randn(6).astype(np.float32)}}
        if clip:
            g = {"w": np.full((4, 6), 1e6, np.float32),
                 "layer": {"b": np.full(6, 1e6, np.float32)}}
        jg = {"w": jnp.asarray(g["w"]),
              "layer": {"b": jnp.asarray(g["layer"]["b"], jnp.bfloat16)}}
        tg = from_jax_params(jax.device_get(jg))
        jp, jst, jm = j_adamw_update(jp, jg, jst, jcfg)
        tp, tst, tm = adamw_update(tp, tg, tst, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"], atol=0, rtol=1e-5)
        assert tp["layer"]["b"].dtype == torch.bfloat16
        assert tst["m"]["layer"]["b"].dtype == torch.float32
        _close(tp["w"], jp["w"], atol=1e-6, rtol=1e-5)
        _close(tp["layer"]["b"], jp["layer"]["b"].astype(jnp.float32),
               atol=0, rtol=2 ** -7)
        for mom in ("m", "v"):
            _trees_close(tst[mom], jst[mom], atol=1e-6, rtol=1e-5)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
    if clip:
        assert float(tm["grad_norm"]) > 1e5
        assert (tp["w"] - torch.from_numpy(w)).abs().max() < 0.1


# ------------------------------------------------- loss and train step

ARCHS = ("qwen3-1.7b", "olmo-1b")


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX cfg, JAX params, port cfg, port params, batch, JAX loss and
    grads with remat, one JAX train step's params and metrics)."""
    jcfg = j_smoke_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = next(j_token_batches(batch=2, seq_len=32,
                                 vocab=jcfg.vocab_size, seed=0))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: j_lm_loss(p, jcfg, batch["tokens"], batch["labels"]),
        has_aux=True))(jp)
    step = jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=LR)))
    jp2, _, jm = step(jp, j_init_opt_state(jp), batch)
    return (jcfg, jp, get_smoke_config(arch),
            from_jax_params(jax.device_get(jp)), batch, float(loss), grads,
            jp2, {k: float(v) for k, v in jm.items()})


def _tensors(batch):
    return [torch.from_numpy(batch[k]) for k in ("tokens", "labels")]


def _port_grads(params, cfg, batch, **kw):
    return loss_and_grads(params, cfg, *_tensors(batch), **kw)


@pytest.mark.parametrize("ce_impl", ["onehot", "gather"])
def test_lm_loss_matches_jax(ce_impl):
    jcfg, jp, cfg, tp, batch, _, _, _, _ = _model("qwen3-1.7b")
    want, jparts = j_lm_loss(jp, jcfg, batch["tokens"], batch["labels"],
                             ce_impl=ce_impl)
    got, parts = lm_loss(tp, cfg, *_tensors(batch), ce_impl=ce_impl)
    _close(got, want, atol=0, rtol=1e-5)
    _close(parts["ce"], jparts["ce"], atol=0, rtol=1e-5)
    assert float(parts["moe_aux"]) == float(jparts["moe_aux"]) == 0.0
    with pytest.raises(ValueError):
        lm_loss(tp, cfg, *_tensors(batch), ce_impl="dense")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """Loss and gradients (remat on, as the JAX default), then one
    make_train_step step's metrics and new params, against JAX."""
    _, _, cfg, tp, batch, jloss, jgrads, jp2, jm = _model(arch)
    loss, _, grads = _port_grads(tp, cfg, batch, remat=True)
    _close(loss, jloss, atol=0, rtol=1e-5)
    _trees_close(grads, jgrads, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    step = make_train_step(cfg, AdamWConfig(lr=LR))
    tp2, opt, m = step(tp, init_opt_state(tp), batch)
    assert set(m) == {"loss", "ce", "moe_aux", "grad_norm"}
    for key in ("loss", "ce", "grad_norm"):
        _close(m[key], jm[key], atol=0, rtol=1e-5)
    _trees_close(tp2, jp2, atol=STEP_ATOL, rtol=0)
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_remat_variants_give_the_same_gradients(remat):
    """Recomputing the blocks (all of them, or all but the weight
    products) changes no gradient: on the CPU the recomputation repeats
    the same float ops."""
    _, _, cfg, tp, batch, _, _, _, _ = _model("qwen3-1.7b")
    loss0, _, g0 = _port_grads(tp, cfg, batch, remat=False)
    loss1, _, g1 = _port_grads(tp, cfg, batch, remat=remat)
    assert float(loss0) == float(loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError):
        _port_grads(tp, cfg, batch, remat="some")


def test_microbatches_match_one_batch():
    """microbatches=4 accumulates to the same loss and update as one
    batch (test_grad_accumulation_matches_single_batch's twin; the
    port's fp32 sums differ from one batch's by rounding only)."""
    _, _, cfg, tp, _, _, _, _, _ = _model("qwen3-1.7b")
    batch = next(token_batches(batch=8, seq_len=16, vocab=cfg.vocab_size,
                               seed=3))
    outs = {}
    for k in (1, 4):
        step = make_train_step(cfg, AdamWConfig(lr=LR), microbatches=k)
        p2, _, m = step(tp, init_opt_state(tp), dict(batch))
        outs[k] = (p2, float(m["loss"]), float(m["grad_norm"]))
    assert abs(outs[1][1] - outs[4][1]) < 1e-5
    assert abs(outs[1][2] - outs[4][2]) < 1e-4 * outs[1][2]
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0])):
        torch.testing.assert_close(a, b, atol=STEP_ATOL, rtol=0)


def test_loss_decreases():
    """The twin of test_loss_decreases: olmo-1b smoke, 12 steps."""
    _, _, cfg, tp, _, _, _, _, _ = _model("olmo-1b")
    step = make_train_step(cfg, AdamWConfig(lr=3e-3))
    opt = init_opt_state(tp)
    it = token_batches(batch=4, seq_len=32, vocab=cfg.vocab_size, seed=0)
    losses = []
    for _ in range(12):
        tp, opt, m = step(tp, opt, next(it))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1, losses


# ------------------------------------------------------------ checkpoints

def _bf16_tree():
    """A JAX tree with float32, bfloat16 and int32 leaves, nested."""
    rng = np.random.RandomState(5)
    return {"a": jnp.asarray(rng.randn(3, 4).astype(np.float32)),
            "blocks": {"w": jnp.asarray(rng.randn(2, 5), jnp.bfloat16),
                       "n": jnp.arange(4, dtype=jnp.int32)}}


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    """A port tree (bf16 leaves kept as raw bits) saved and restored into
    zeros equals the original bit for bit, with its step."""
    tp = from_jax_params(jax.device_get(_bf16_tree()))
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tp, step=7)
    zeros = {"a": torch.zeros(3, 4),
             "blocks": {"w": torch.zeros(2, 5, dtype=torch.bfloat16),
                        "n": torch.zeros(4, dtype=torch.int32)}}
    restored, step = restore_checkpoint(path, zeros)
    assert step == 7
    want, got = _port_leaves(tp), _port_leaves(restored)
    assert set(want) == set(got)
    for name, a in want.items():
        assert a.dtype == got[name].dtype and torch.equal(a, got[name])


def test_checkpoint_shape_mismatch(tmp_path):
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, {"a": torch.ones(2, 2)})
    with pytest.raises(ValueError):
        restore_checkpoint(path, {"a": torch.ones(3, 3)})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    """float32 trees cross both ways with equal leaves; a bf16 leaf
    crosses from JAX bit for bit, and the JAX restore of the port's bf16
    leaf raises (it cannot cast raw bits) rather than misread it."""
    jcfg = j_smoke_config("qwen2-0.5b")
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.device_get(jp))
    path = os.path.join(tmp_path, "ckpt")
    bf16 = os.path.join(tmp_path, "bf16")
    if direction == "jax_to_port":
        j_save(path, jp, step=3)
        restored, step = restore_checkpoint(path, _zeros_like(tp))
        assert step == 3
        _trees_close(restored, jp, atol=0, rtol=0)
        jt = _bf16_tree()
        j_save(bf16, jt)
        got, _ = restore_checkpoint(bf16, from_jax_params(
            jax.device_get(jax.tree.map(jnp.zeros_like, jt))))
        want = from_jax_params(jax.device_get(jt))
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        save_checkpoint(path, tp, step=4)
        restored, step = j_restore(path, jax.tree.map(jnp.zeros_like, jp))
        assert step == 4
        _trees_close(tp, restored, atol=0, rtol=0)
        save_checkpoint(bf16, from_jax_params(jax.device_get(_bf16_tree())))
        with pytest.raises((ValueError, TypeError)):
            j_restore(bf16, jax.tree.map(jnp.zeros_like, _bf16_tree()))


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


# ------------------------------------------------------------ data, CLI

def test_token_batches_match_jax():
    want = j_token_batches(batch=3, seq_len=16, vocab=500, seed=9)
    got = token_batches(batch=3, seq_len=16, vocab=500, seed=9)
    for _ in range(3):
        a, b = next(got), next(want)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    """launch.train --device cpu: 2 steps of a smoke config, a checkpoint,
    then a resumed run from it; a moe smoke config takes a step (its
    loss carries the router aux), and so does whisper-base's (the stub's
    frames go with every step)."""
    from repro_torch.launch.train import main
    ckpt = os.path.join(tmp_path, "ckpt")
    args = ["--arch", "qwen3-1.7b", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--ckpt", ckpt]
    assert main(args) == 0
    assert os.path.exists(os.path.join(ckpt, "manifest.json"))
    assert main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "step    1" in out and "step    3" in out
    for line in out.splitlines():
        if line.startswith("step"):
            assert np.isfinite(float(line.split()[3]))
    assert main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--steps",
                 "1", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "olmoe-1b-7b-smoke" in out and "step    0" in out
    assert main(["--arch", "whisper-base", "--device", "cpu", "--steps",
                 "1", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    step = [ln for ln in out.splitlines() if ln.startswith("step    0")]
    assert "whisper-base-smoke" in out and len(step) == 1
    assert np.isfinite(float(step[0].split()[3]))
