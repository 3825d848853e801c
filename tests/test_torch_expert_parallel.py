"""The port's expert-parallel MoE (``models/moe.py::
moe_forward_expert_parallel``) over gloo ranks on the CPU, against the
JAX package's shard_map version on forced host devices; and the
residual-stream hooks (``distributed/actspec.py``) at the JAX models'
call sites.

The JAX side runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_models.py``'s expert-parallel test does: for the
olmoe-1b-7b (4 experts, top 2) and llama4-scout (4 experts, top 1 and a
shared expert) smoke configs, one layer's MoE on a seeded x, ``grouped``
and ``moe_forward_expert_parallel`` at model = 4 and 2, each with
``jax.grad`` of sum(y r) + aux by x, the router and the expert stacks.
The port's side runs in 1, 2, 3 and 4 spawned gloo ranks, each holding
its slice of the same weights (``from_jax_params``; all four experts at
3 ranks, where 4 % 3 sends ``expert_parallel`` to ``grouped``). This
module imports no JAX, so the ranks, which import it afresh, do not
either.

Tolerances: y and aux ``atol=2e-5`` (the JAX test's own bound); the
gradients ``atol=1e-6, rtol=1e-3``, as ``tests/test_torch_moe.py``;
the 3-rank run and the hooks exactly.
"""
import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import models as TM
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import actspec
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.distributed.sharding import to_device_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models.packed import run_fragment_packed

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
KEYS = ("router", "w_gate", "w_up", "w_down")
Y_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3
RANK_TIMEOUT_S = 120

JAX_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh
from repro import models as M
from repro.configs import get_smoke_config
from repro.distributed.actspec import moe_mesh
from repro.models import moe as moe_mod

KEYS = ("router", "w_gate", "w_up", "w_down")
out = {}


def flat(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(f"{prefix}/{k}", v)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))


for arch in sys.argv[2:]:
    cfg = get_smoke_config(arch)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    flat(f"{arch}/p", p)
    rs = np.random.RandomState(3)
    x = jnp.asarray(rs.randn(2, 8, cfg.d_model).astype(np.float32) * 0.5)
    r = jnp.asarray(rs.randn(2, 8, cfg.d_model).astype(np.float32))
    out[f"{arch}/x"], out[f"{arch}/r"] = np.asarray(x), np.asarray(r)
    runs = {"grouped": lambda pp, xx: moe_mod.moe_forward(
        pp, cfg, xx, impl="grouped")}
    for n in (4, 2):
        runs[f"ep{n}"] = (lambda m: lambda pp, xx:
                          moe_mod.moe_forward_expert_parallel(
                              pp, cfg, xx, mesh=m))(mesh(n))

    def ep3(pp, xx):                 # 4 % 3: moe_forward takes grouped
        with moe_mesh(mesh(3)):
            return moe_mod.moe_forward(pp, cfg, xx, impl="expert_parallel")
    runs["ep3"] = ep3
    for name, fn in runs.items():
        def loss(xx, sub, fn=fn):
            y, aux = fn(dict(p, **sub), xx)
            return jnp.sum(y * r) + aux
        y, aux = jax.jit(fn)(p, x)
        gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            x, {k: p[k] for k in KEYS})
        out[f"{arch}/{name}/y"] = np.asarray(y)
        out[f"{arch}/{name}/aux"] = np.asarray(aux)
        out[f"{arch}/{name}/g_x"] = np.asarray(gx)
        for k in KEYS:
            out[f"{arch}/{name}/g_{k}"] = np.asarray(gp[k])
np.savez(sys.argv[1], **out)
print("EP-REF-OK")
"""


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The JAX package's arrays (weights, inputs, outputs, gradients)."""
    path = tmp_path_factory.mktemp("jax_ep") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_REFERENCE, str(path),
                          *ARCHS], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0 and "EP-REF-OK" in out.stdout, \
        out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z), str(path)


def _moe_params(ref: dict, arch: str) -> dict:
    """Layer 0's MoE params from the JAX arrays, through
    ``from_jax_params``."""
    tree: dict = {}
    head = f"{arch}/p/"
    for key, a in ref.items():
        if key.startswith(head):
            *path, leaf = key[len(head):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = a
    return TM.from_jax_params(tree)


def _count_all_reduce(counts: dict):
    """Wrap ``torch.distributed.all_reduce`` to count its calls into
    ``counts["n"]``; -> the original."""
    import torch.distributed as dist
    inner = dist.all_reduce

    def counted(*a, **kw):
        counts["n"] += 1
        return inner(*a, **kw)
    dist.all_reduce = counted
    return inner


def _ep_rank(rank: int, n: int, ref_path: str, out_dir: str) -> None:
    """One rank: for each arch, the rank's slice of layer 0's MoE under
    ``moe_mesh`` with ``moe_impl="expert_parallel"``: y, aux, the
    gradients of sum(y r) + aux, the ``all_reduce`` calls of a forward
    without grad and of one with its backward, and y with the whole
    expert stack (views) instead of the slice. Rank 0 also runs
    ``grouped`` with no mesh. Writes ``rank{rank}.npz`` to ``out_dir``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dm = to_device_mesh(make_host_mesh(model=n), "cpu")
    with np.load(ref_path) as z:
        ref = dict(z)
    out, counts = {}, {"n": 0}
    inner = _count_all_reduce(counts)
    try:
        for arch in ARCHS:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      moe_impl="expert_parallel")
            full = _moe_params(ref, arch)
            E = cfg.moe.n_experts
            mine = tmoe.shard_experts(full, rank, n) if E % n == 0 else full
            for v in mine.values():
                if isinstance(v, torch.Tensor):
                    v.requires_grad_(True)
            x = torch.from_numpy(ref[f"{arch}/x"]).requires_grad_(True)
            r = torch.from_numpy(ref[f"{arch}/r"])
            with actspec.moe_mesh(dm):
                counts["n"] = 0
                with torch.no_grad():
                    y_full, _ = tmoe.moe_forward(full, cfg, x)
                out[f"{arch}/calls_no_grad"] = counts["n"]
                counts["n"] = 0
                y, aux = tmoe.moe_forward(mine, cfg, x)
                ((y * r).sum() + aux).backward()
                out[f"{arch}/calls_grad"] = counts["n"]
            out[f"{arch}/y_full"] = y_full.numpy()
            out[f"{arch}/y"] = y.detach().numpy()
            out[f"{arch}/aux"] = aux.detach().numpy()
            out[f"{arch}/g_x"] = x.grad.numpy()
            for k in KEYS:
                out[f"{arch}/g_{k}"] = mine[k].grad.numpy()
            if rank == 0:
                xg = x.detach().requires_grad_(True)
                full = _moe_params(ref, arch)
                for v in full.values():
                    if isinstance(v, torch.Tensor):
                        v.requires_grad_(True)
                yg, ag = tmoe.moe_forward(full, cfg, xg, impl="grouped")
                ((yg * r).sum() + ag).backward()
                out[f"{arch}/grouped/y"] = yg.detach().numpy()
                out[f"{arch}/grouped/aux"] = ag.detach().numpy()
                out[f"{arch}/grouped/g_x"] = xg.grad.numpy()
                for k in KEYS:
                    out[f"{arch}/grouped/g_{k}"] = full[k].grad.numpy()
    finally:
        dist.all_reduce = inner
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module", params=[1, 2, 4, 3], ids=lambda n: f"{n}r")
def ranks(request, jref, tmp_path_factory):
    """(n, [each rank's arrays]) of one ``spawn_ranks`` run."""
    n = request.param
    out_dir = tmp_path_factory.mktemp(f"ep{n}")
    spawn_ranks(_ep_rank, n, jref[1], str(out_dir), timeout=RANK_TIMEOUT_S)
    runs = []
    for r in range(n):
        with np.load(out_dir / f"rank{r}.npz") as z:
            runs.append(dict(z))
    return n, runs


def _jax_name(n: int) -> str:
    """The JAX run a port run of ``n`` ranks is held to."""
    return {1: "grouped", 2: "ep2", 3: "ep3", 4: "ep4"}[n]


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_forward_matches_jax(ranks, jref, arch):
    """y and aux on every rank equal each other exactly and JAX's EP run
    at the same model size (``grouped`` at 1) and JAX's ``grouped``
    within 2e-5; the whole expert stack (sliced to views) gives the
    slice's y exactly."""
    n, runs = ranks
    ref = jref[0]
    for run in runs:
        np.testing.assert_array_equal(run[f"{arch}/y"], runs[0][f"{arch}/y"])
        np.testing.assert_array_equal(run[f"{arch}/y_full"],
                                      run[f"{arch}/y"])
        for want in (_jax_name(n), "grouped"):
            np.testing.assert_allclose(run[f"{arch}/y"],
                                       ref[f"{arch}/{want}/y"], atol=Y_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(run[f"{arch}/aux"],
                                       ref[f"{arch}/{want}/aux"],
                                       atol=Y_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_gradients_match_jax(ranks, jref, arch):
    """The gradients of sum(y r) + aux: by x and the router whole on every
    rank, the expert stacks as the ranks' slices put together, against
    JAX's EP gradients at the same model size and JAX's ``grouped`` (the
    two are the same in JAX here: no reference fault)."""
    n, runs = ranks
    ref = jref[0]
    got = {"g_x": runs[0][f"{arch}/g_x"],
           "g_router": runs[0][f"{arch}/g_router"]}
    for run in runs[1:]:
        for key in ("g_x", "g_router"):
            np.testing.assert_allclose(run[f"{arch}/{key}"], got[key],
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL)
    E = ref[f"{arch}/p/w_gate"].shape[0]
    for k in KEYS[1:]:
        got[f"g_{k}"] = np.concatenate([run[f"{arch}/g_{k}"]
                                        for run in runs]) \
            if E % n == 0 else runs[0][f"{arch}/g_{k}"]
    for want in (_jax_name(n), "grouped"):
        for key, g in got.items():
            np.testing.assert_allclose(g, ref[f"{arch}/{want}/{key}"],
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"{key} against JAX {want}")


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_collectives_per_layer(ranks, arch):
    """Where the mesh's size divides E: one ``all_reduce`` for a forward
    without grad (the combine), three with the backward (the combine, and
    the tokens' and gates' gradients); none where it does not (3 ranks
    on 4 experts take ``grouped``)."""
    n, runs = ranks
    for run in runs:
        want = (1, 3) if n != 3 else (0, 0)
        assert (int(run[f"{arch}/calls_no_grad"]),
                int(run[f"{arch}/calls_grad"])) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_on_a_mesh_that_does_not_divide_the_experts_is_grouped(ranks,
                                                                  arch):
    """At 3 ranks on 4 experts ``expert_parallel`` is ``grouped``, bit
    for bit, gradients included, as in JAX (``ep3``); at 1, 2 and 4 ranks
    it takes the EP path (the ranks hold slices, which ``grouped``
    cannot run) and agrees with ``grouped`` within the forward's
    bound."""
    n, runs = ranks
    want = runs[0]
    for run in runs:
        for key in ("y", "aux", "g_x") + tuple(f"g_{k}" for k in KEYS):
            got, ref = run[f"{arch}/{key}"], want[f"{arch}/grouped/{key}"]
            if n == 3:
                np.testing.assert_array_equal(got, ref, err_msg=key)
            elif key in ("y", "aux"):
                np.testing.assert_allclose(got, ref, atol=Y_ATOL, rtol=0)


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _lm_loss_rank(rank: int, n: int, out_dir: str) -> None:
    """One rank: the olmoe smoke model's ``lm_loss`` (remat on, so the
    blocks' combines run again in the backward) and its gradients, with
    ``grouped`` and the whole model, then with ``expert_parallel`` over
    the mesh and the rank's slice of every layer's experts; the backward
    runs on a thread of its own, outside ``moe_mesh``."""
    from repro_torch.training.train_step import lm_loss
    torch.set_num_threads(1)
    dm = to_device_mesh(make_host_mesh(model=n), "cpu")
    cfg = get_smoke_config(ARCHS[0])
    toks, labels = _tokens(cfg, 2, 16, 3), _tokens(cfg, 2, 16, 4)
    out = {}
    for name, mesh in (("grouped", None), ("expert_parallel", dm)):
        params = TM.init_params(cfg, seed=6, device="cpu")
        if mesh is not None:
            blocks = params["blocks"]
            params["blocks"] = dict(blocks, moe=tmoe.shard_experts(
                blocks["moe"], rank, n))
        for _, v in _leaves(params):
            v.requires_grad_(True)
        with actspec.moe_mesh(mesh):
            loss, _ = lm_loss(params, dataclasses.replace(cfg, moe_impl=name),
                              toks, labels, remat=True)
        # the backward on another thread, as autograd runs a CUDA graph's
        # on its device thread: the recompute must not depend on the
        # hooks' thread-local state
        errors = []

        def backward(loss=loss):
            try:
                loss.backward()
            except BaseException as e:     # re-raised on this thread
                errors.append(e)
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=RANK_TIMEOUT_S)
        assert not worker.is_alive()
        if errors:
            raise errors[0]
        out[f"{name}/loss"] = loss.detach().numpy()
        for key, v in _leaves(params):
            out[f"{name}/{key}"] = v.grad.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def test_ep_lm_loss_and_gradients_equal_grouped(tmp_path):
    """2 ranks: the whole model's loss, under remat, and every gradient
    leaf (each rank's expert slices against the same slices of
    ``grouped``'s) equal the one-process ``grouped`` run's."""
    n = 2
    spawn_ranks(_lm_loss_rank, n, str(tmp_path), timeout=RANK_TIMEOUT_S)
    for r in range(n):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            run = dict(z)
        np.testing.assert_allclose(run["expert_parallel/loss"],
                                   run["grouped/loss"], rtol=1e-6)
        keys = [k[len("grouped/"):] for k in run
                if k.startswith("grouped/") and k != "grouped/loss"]
        assert any(k.endswith("moe/w_down") for k in keys)
        for key in keys:
            want = run[f"grouped/{key}"]
            if key.rsplit("/", 1)[-1] in tmoe.EXPERT_KEYS and "moe" in key:
                m = want.shape[-3] // n
                want = want[..., r * m:(r + 1) * m, :, :]
            np.testing.assert_allclose(run[f"expert_parallel/{key}"], want,
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=key)


def test_expert_parallel_without_a_mesh_is_grouped():
    """No mesh installed, or one without a ``model`` dim: the grouped
    path, bit for bit."""
    cfg = get_smoke_config(ARCHS[0])
    p = TM.init_params(cfg, seed=1, device="cpu")
    p = {k: v[0] for k, v in p["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 7, cfg.d_model).astype(np.float32))
    want = tmoe.moe_forward(p, cfg, x, impl="grouped")

    class NoModelDim:
        mesh_dim_names = ("data",)
    for mesh in (None, NoModelDim()):
        with actspec.moe_mesh(mesh):
            got = tmoe.moe_forward(p, cfg, x, impl="expert_parallel")
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_shard_experts_cuts_the_expert_dim_and_copies():
    """A stacked (L, E, ...) MoE tree: each rank's w_* are its E / n
    experts of every layer, copies (the stack can be freed); the router
    and the shared expert are the same objects; E % n raises."""
    cfg = get_smoke_config(ARCHS[1])
    moe = TM.init_params(cfg, seed=2, device="cpu")["blocks"]["moe"]
    parts = [tmoe.shard_experts(moe, r, 2) for r in range(2)]
    for k in ("w_gate", "w_up", "w_down"):
        assert parts[0][k].shape[1] == moe[k].shape[1] // 2
        assert torch.equal(torch.cat([q[k] for q in parts], 1), moe[k])
        assert parts[0][k].untyped_storage().data_ptr() != \
            moe[k].untyped_storage().data_ptr()
    assert parts[1]["router"] is moe["router"]
    assert parts[1]["shared"] is moe["shared"]
    with pytest.raises(ValueError, match="do not split"):
        tmoe.shard_experts(moe, 0, 3)


# ---------------------------------------------------------------------------
# the residual-stream hooks
# ---------------------------------------------------------------------------

SPEC = ("data", actspec.UNCONSTRAINED, actspec.UNCONSTRAINED)


def _qwen3():
    cfg = get_smoke_config("qwen3-1.7b")
    return cfg, TM.init_params(cfg, seed=3, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32))


def _run(kind, cfg, params):
    if kind == "forward":
        return TM.forward(params, cfg, _tokens(cfg, 2, 24))[0]
    if kind == "packed fragment":
        toks = [t[:n] for t, n in zip(_tokens(cfg, 3, 20, 1), (20, 7, 13))]
        outs = run_fragment_packed(params, cfg, toks, 0,
                                   TM.n_fragment_units(cfg), pad_to=48)
        return torch.cat(outs)
    logits, cache = tdec.prefill(params, cfg, _tokens(cfg, 2, 16, 2),
                                 cache_seq=24)
    return torch.cat([logits.flatten(), cache["k"].flatten(),
                      cache["v"].flatten()])


@pytest.mark.parametrize("kind", ["forward", "packed fragment", "prefill"])
def test_hooks_leave_plain_tensors_bit_identical(kind):
    """With a residual spec installed, a plain-tensor forward, packed
    fragment run and prefill give the same bits as without one."""
    cfg, params = _qwen3()
    want = _run(kind, cfg, params)
    with actspec.residual_spec(SPEC):
        got = _run(kind, cfg, params)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,kind,constrain,batch", [
    # qwen3 (2 layers): one constrain per layer, 3 per attention call
    ("qwen3-1.7b", "forward", 2, 6),
    ("qwen3-1.7b", "prefill", 2, 6),
    # llama-3.2-vision (2 superblocks of 2 self layers and a cross
    # block): each self layer and each superblock, 3 per attention (6
    # self, 2 cross)
    ("llama-3.2-vision-90b", "forward", 6, 18),
])
def test_hooks_are_called_at_the_jax_call_sites(monkeypatch, arch, kind,
                                                 constrain, batch):
    """``constrain`` after every block of ``stack_forward`` and
    ``vlm_stack_forward`` and after every prefill layer;
    ``constrain_batch`` on q, k and v of every attention call; each hook
    handed back the object it was given."""
    calls = {"constrain": 0, "constrain_batch": 0}

    def counted(name):
        inner = getattr(actspec, name)

        def hook(x):
            calls[name] += 1
            out = inner(x)
            assert out is x
            return out
        return hook
    for name in calls:
        monkeypatch.setattr(actspec, name, counted(name))
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, seed=4, device="cpu")
    toks = _tokens(cfg, 1, 12)
    extras = TM.make_extras(cfg, 1, device="cpu") \
        if cfg.family == "vlm" else None
    with actspec.residual_spec(SPEC):
        if kind == "forward":
            TM.forward(params, cfg, toks, extras=extras)
        else:
            tdec.prefill(params, cfg, toks)
    assert calls == {"constrain": constrain, "constrain_batch": batch}
