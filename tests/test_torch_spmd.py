"""The port's entries run as DTensors under the sharding rules
(``distributed/spmd.py``): the collective counter in closed forms on a
fake process group, the out-of-place writes DTensor needs against their
in-place plain twins, the kernels' local-shard layouts, and qwen3 and
olmoe (smoke configs, float32) over 4 gloo ranks as a ``(data 2,
model 2)`` mesh against the JAX package.

The JAX side runs in a subprocess (this module imports no JAX, so the
spawned ranks, which import it afresh, do not either): the smoke
configs' JAX init, a 4 x 16 prompt's ``prefill`` logits and cache, 4
greedy tokens by ``decode_step`` and ``lm_loss`` with ``jax.grad``. The
ranks take the same weights (``from_jax_params``), place them by the
baseline ``ShardingRules`` and run the port's entries under
``implicit_replication``, the residual constraint and the MoE mesh
hook, as ``launch/dryrun.py``'s sharded pass does.

Tolerances: logits ``atol=5e-5, rtol=1e-3`` (the serving tolerance);
tokens exactly; the loss ``rtol=1e-5`` and the gradients ``atol=1e-6,
rtol=1e-3``, as ``tests/test_torch_training.py``; the attention layouts
``atol=2e-5, rtol=1e-3`` (its attention tolerance); the closed forms and
the out-of-place writes exactly.
"""
import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
from collections import defaultdict

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import actspec, spmd
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.distributed.sharding import ShardingRules, to_device_mesh
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import from_jax_params, init_params
from repro_torch.models import moe as tmoe

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("qwen3-1.7b", "olmoe-1b-7b")
B, S, NEW = 4, 16, 4
HOST = MeshShape(("data", "model"), (2, 2))
SERVE_ATOL, SERVE_RTOL = 5e-5, 1e-3
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3
ATTN_ATOL, ATTN_RTOL = 2e-5, 1e-3
RANK_TIMEOUT_S = 150
# the batch-1 decode against a sequence-sharded ring: RING slots (split
# over data, or over data and model), a RING_P-token prompt (the ring
# has wrapped before the first step), RING_NEW greedy tokens
RING, RING_P, RING_NEW = 8, 11, 5

JAX_REFERENCE = r"""
import dataclasses
import sys
sys.path.insert(0, "src")
import jax, numpy as np, jax.numpy as jnp
from repro import models as M
from repro.configs import get_smoke_config
from repro.models import decode as jdec
from repro.training import lm_loss

B, S, NEW, RING, RING_P, RING_NEW = (int(a) for a in sys.argv[2:8])
out = {}


def flat(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(f"{prefix}/{k}", v)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


for arch in sys.argv[8:]:
    cfg = get_smoke_config(arch)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    flat(f"{arch}/p", params)
    rs = np.random.RandomState(5)
    tok = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out[f"{arch}/tokens"], out[f"{arch}/labels"] = tok, lab
    logits, cache = jdec.prefill(params, cfg, jnp.asarray(tok),
                                 cache_seq=S + NEW)
    out[f"{arch}/logits"] = np.asarray(logits)
    t = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    new = [t]
    for _ in range(NEW - 1):
        lg, cache = jdec.decode_step(params, cfg, cache, t[:, None])
        t = jnp.argmax(lg[:, 0], axis=-1).astype(jnp.int32)
        new.append(t)
    out[f"{arch}/new"] = np.stack([np.asarray(x) for x in new], 1)
    loss, grads = jax.value_and_grad(
        lambda p: lm_loss(p, cfg, jnp.asarray(tok), jnp.asarray(lab))[0])(
            params)
    out[f"{arch}/loss"] = np.asarray(loss)
    flat(f"{arch}/g", grads)

# a batch-1 greedy decode whose RING-slot ring wraps, at qwen3's smoke
# width and with one KV head (the kv_seq_shard layout's case)
from repro.serving.smoke import reference_decode
ring = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                           sliding_window=RING)
prompt = np.random.RandomState(9).randint(0, ring.vocab_size, (1, RING_P)) \
    .astype(np.int32)
out["ring/tokens"] = prompt
for name, cfg in (("seq_data", ring),
                  ("kv_seq_shard", dataclasses.replace(ring, n_kv_heads=1))):
    params = M.init_params(jax.random.PRNGKey(3), cfg)
    flat(f"ring/{name}/p", params)
    out[f"ring/{name}/new"] = np.asarray(
        reference_decode(cfg, params, prompt[0], RING_NEW), np.int32)[None]
np.savez(sys.argv[1], **out)
print("SPMD-REF-OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _full(t) -> np.ndarray:
    t = t.full_tensor() if spmd.is_dtensor(t) else t
    return t.detach().numpy()


# ------------------------------------------------------ the sharded ranks

def _attention_layouts(dm, out: dict, B: int) -> None:
    """ops.attention and ops.attend_cache on DTensors (batch over data,
    heads as each layout takes them) against the plain ops on the whole
    tensors, values and (attention) gradients."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    rows = (Shard(0), Replicate())
    for name, H, KV in (("split", 4, 2), ("slice", 4, 1), ("whole", 3, 1)):
        assert spmd.head_layout(dm, H, KV) == name
        g = torch.Generator().manual_seed(H * 10 + KV)
        q, r = (torch.randn(B, 8, H, 16, generator=g) for _ in range(2))
        k, v = (torch.randn(B, 8, KV, 16, generator=g) for _ in range(2))
        dq, dk, dv = (distribute_tensor(t, dm, rows).requires_grad_(True)
                      for t in (q, k, v))
        o = ops.attention(dq, dk, dv)
        grads = torch.autograd.grad(
            (o * distribute_tensor(r, dm, rows)).sum().full_tensor(),
            (dq, dk, dv))
        pq, pk, pv = (t.clone().requires_grad_(True) for t in (q, k, v))
        want = ops.attention(pq, pk, pv)
        wgrads = torch.autograd.grad((want * r).sum(), (pq, pk, pv))
        out[f"attn/{name}/o"] = (_full(o), want.detach().numpy())
        for n_, a, b in zip("qkv", grads, wgrads):
            out[f"attn/{name}/d{n_}"] = (_full(a), b.numpy())
        qd = torch.randn(B, 1, H, 16, generator=g)
        kc, vc = (torch.randn(B, 12, KV, 16, generator=g) for _ in range(2))
        qp = torch.tensor([11, 7, 3, 9][:B], dtype=torch.int32)
        kp = torch.arange(12, dtype=torch.int32)[None].repeat(B, 1)
        kp[1, 8:] = -1
        got = ops.attend_cache(*(distribute_tensor(t, dm, rows)
                                 for t in (qd, kc, vc, qp, kp)))
        out[f"decode/{name}/o"] = (_full(got),
                                   ops.attend_cache(qd, kc, vc, qp,
                                                    kp).numpy())


@contextlib.contextmanager
def counted(module, name: str):
    """``module.name`` wrapped so that the collectives inside its calls
    are counted apart; yields {HLO name: bytes} summed over the calls."""
    inner, sums = getattr(module, name), defaultdict(float)

    def run(*a, **kw):
        with spmd.CollectiveCounter() as cc:
            o = inner(*a, **kw)
        for op, b in cc.per_op.items():
            sums[op] += b
        return o
    setattr(module, name, run)
    try:
        yield sums
    finally:
        setattr(module, name, inner)


def _ring_decode(dm, ref: dict, out: dict) -> None:
    """qwen3's smoke width at batch 1: the prompt prefilled in one
    process into a RING-slot ring (it wraps), the cache placed by the
    rules, then greedy steps as DTensors against the JAX package's
    ``reference_decode``, tokens exactly. Two layouts: the baseline
    rules split the ring over ``data`` (heads over ``model``);
    ``kv_seq_shard`` with one KV head splits it over ``data`` and
    ``model``. The collectives of ``spmd.merge_softmax`` are counted
    apart: a (B, H) max and a (B, H, hd + 1) fp32 sum all-reduced over
    each mesh dim of the sequence, a layer. The rest of
    ``ops.attend_cache``'s make q whole (its pending sum over ``data``,
    from the FSDP-split ``wq``, and its heads over ``model``); none
    moves the cache."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops
    for name, kv_seq in (("seq_data", False), ("kv_seq_shard", True)):
        cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                  sliding_window=RING,
                                  n_kv_heads=1 if kv_seq else 2)
        params = from_jax_params(_nest(ref, f"ring/{name}/p/"))
        rules = ShardingRules(HOST, kv_seq_shard=kv_seq)
        logits, cache = tdec.prefill(
            params, cfg, torch.from_numpy(ref["ring/tokens"]),
            cache_seq=RING_P + RING_NEW)
        t = logits[:, -1].argmax(-1).to(torch.int32)
        P = spmd.distribute_tree(params, rules.params_specs(params), dm)
        C = spmd.distribute_tree(cache, rules.cache_specs(cache), dm)
        seq = spmd.seq_dims(C["k"][0])
        with counted(ops, "attend_cache") as attn, \
                counted(spmd, "merge_softmax") as merged, \
                implicit_replication():
            new = [t]
            for _ in range(RING_NEW - 1):
                lg, C = tdec.decode_step(P, cfg, C, t[:, None])
                t = spmd.whole_dim(lg[:, 0], -1).argmax(-1).to(torch.int32)
                new.append(t)
        steps = cfg.n_layers * (RING_NEW - 1)
        H, hd = cfg.n_heads, cfg.head_dim_
        heads = H if kv_seq else H // 2         # whole, or split over model
        merge = steps * len(seq) * 2 * 4 * heads * (hd + 2)
        q_full = steps * H * hd * 4
        out[f"ring/{name}/new"] = (np.stack([_full(x) for x in new], 1),
                                   ref[f"ring/{name}/new"])
        out[f"ring/{name}/seq_dims"] = (np.array(seq),
                                        np.array([0, 1] if kv_seq else [0]))
        out[f"ring/{name}/merge_bytes"] = (
            np.array([merged["all-reduce"], merged["all-gather"]]),
            np.array([merge, 0]))
        out[f"ring/{name}/q_bytes"] = (
            np.array([attn["all-reduce"] - merged["all-reduce"],
                      attn["all-gather"]]), np.array([2 * q_full, q_full]))


def sharded_rank(rank: int, n: int, ref_path: str, out_dir: str) -> None:
    """One of the 4 ranks: every arch's prefill, greedy decode and loss
    with its gradients on DTensors over the (data 2, model 2) mesh, and
    the attention layouts; rank r saves ``rank{r}.npz`` of (got, want)
    pairs and its counted collectives."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.training.train_step import loss_and_grads
    ref = dict(np.load(ref_path))
    B = len(ref[f"{ARCHS[0]}/tokens"])
    dm = to_device_mesh(HOST, "cpu")
    rules = ShardingRules(HOST)
    out: dict = {}
    act = (rules.batch_dim_axes(B), actspec.UNCONSTRAINED,
           actspec.UNCONSTRAINED)
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = from_jax_params(_nest(ref, f"{arch}/p/"))
        P = spmd.distribute_tree(params, rules.params_specs(params), dm)
        tok = torch.from_numpy(ref[f"{arch}/tokens"])
        lab = torch.from_numpy(ref[f"{arch}/labels"])
        dtok = spmd.distribute_tree(tok, rules.batch_specs(tok), dm)
        dlab = spmd.distribute_tree(lab, rules.batch_specs(lab), dm)
        with implicit_replication(), actspec.residual_spec(act), \
                actspec.moe_mesh(dm), spmd.CollectiveCounter() as cc:
            logits, cache = tdec.prefill(P, cfg, dtok, cache_seq=S + NEW)
            t = spmd.whole_dim(logits[:, -1], -1).argmax(-1) \
                .to(torch.int32)
            new = [t]
            for _ in range(NEW - 1):
                lg, cache = tdec.decode_step(P, cfg, cache, t[:, None])
                t = spmd.whole_dim(lg[:, 0], -1).argmax(-1).to(torch.int32)
                new.append(t)
            loss, _, grads = loss_and_grads(P, cfg, dtok, dlab)
        out[f"{arch}/logits"] = (_full(logits), ref[f"{arch}/logits"])
        out[f"{arch}/new"] = (np.stack([_full(x) for x in new], 1),
                              ref[f"{arch}/new"])
        out[f"{arch}/loss"] = (_full(loss), ref[f"{arch}/loss"])
        for name, g in _leaves(grads):
            out[f"{arch}/g/{name}"] = (_full(g), ref[f"{arch}/g/{name}"])
        out[f"{arch}/collectives"] = (np.array([cc.count, cc.bytes]),
                                      np.zeros(2))
        if cfg.moe:                  # the opt policy's dispatch, dropless
            ep = dataclasses.replace(cfg, moe_impl="expert_parallel")
            with implicit_replication(), actspec.residual_spec(act), \
                    actspec.moe_mesh(dm), spmd.CollectiveCounter() as cc:
                lg, _ = tdec.prefill(P, ep, dtok)
            out[f"{arch}/ep_logits"] = (_full(lg), ref[f"{arch}/logits"])
            out[f"{arch}/ep_all_reduces"] = (
                np.array(cc.per_op_count["all-reduce"]),
                np.array(cfg.n_layers))
        out[f"{arch}/cache_k_is_dtensor"] = (
            np.array(spmd.is_dtensor(cache["k"])), np.array(True))
    _attention_layouts(dm, out, B)
    _ring_decode(dm, ref, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{f"{k}|got": v[0] for k, v in out.items()},
             **{f"{k}|want": v[1] for k, v in out.items()})


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{key: (got, want)} of every rank (``sharded_rank``)."""
    d = tmp_path_factory.mktemp("spmd")
    ref = d / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_REFERENCE, str(ref),
                          str(B), str(S), str(NEW), str(RING), str(RING_P),
                          str(RING_NEW), *ARCHS], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert "SPMD-REF-OK" in res.stdout, res.stderr[-3000:]
    spawn_ranks(sharded_rank, 4, str(ref), str(d), timeout=RANK_TIMEOUT_S)
    runs = []
    for r in range(4):
        z = np.load(d / f"rank{r}.npz")
        keys = {k.split("|")[0] for k in z.files}
        runs.append({k: (z[f"{k}|got"], z[f"{k}|want"]) for k in keys})
    return runs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_logits_equal_jax(sharded, arch):
    for run in sharded:
        got, want = run[f"{arch}/logits"]
        assert got.shape == (B, S, want.shape[-1])
        np.testing.assert_allclose(got, want, atol=SERVE_ATOL,
                                   rtol=SERVE_RTOL)
        assert bool(run[f"{arch}/cache_k_is_dtensor"][0])
        count, nbytes = run[f"{arch}/collectives"][0]
        assert count > 0 and nbytes > 0


def test_sharded_expert_parallel_prefill_equals_jax(sharded):
    """olmoe's expert-parallel dispatch on each rank's tokens (the opt
    policy's; its smoke capacity drops nothing) against JAX's grouped
    forward; each layer's combine is one all-reduce over ``model``."""
    for run in sharded:
        got, want = run["olmoe-1b-7b/ep_logits"]
        np.testing.assert_allclose(got, want[..., :got.shape[-1]],
                                   atol=SERVE_ATOL, rtol=SERVE_RTOL)
        n, layers = run["olmoe-1b-7b/ep_all_reduces"]
        assert n >= layers


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_greedy_decode_equals_jax(sharded, arch):
    for run in sharded:
        got, want = run[f"{arch}/new"]
        assert got.shape == (B, NEW)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_equal_jax(sharded, arch):
    for run in sharded:
        got, want = run[f"{arch}/loss"]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        names = [k for k in run if k.startswith(f"{arch}/g/")]
        assert len(names) >= 10
        for k in names:
            got, want = run[k]
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("layout", ("split", "slice", "whole"))
def test_kernel_entries_on_local_shards_equal_the_plain_ops(sharded, layout):
    for run in sharded:
        for key in (f"attn/{layout}/o", f"attn/{layout}/dq",
                    f"attn/{layout}/dk", f"attn/{layout}/dv",
                    f"decode/{layout}/o"):
            got, want = run[key]
            np.testing.assert_allclose(got, want, atol=ATTN_ATOL,
                                       rtol=ATTN_RTOL, err_msg=key)


@pytest.mark.parametrize("layout", ("seq_data", "kv_seq_shard"))
def test_sequence_sharded_ring_decode_equals_jax(sharded, layout):
    """Batch-1 greedy decode against a wrapped ring split over ``data``
    (the baseline rules) or over ``data`` and ``model`` (``kv_seq_shard``
    with one KV head): token for token the JAX package's
    ``reference_decode``; the merge's all-reduces are the closed form
    exactly, and the rest of attention's collectives (q made whole) stay
    within q's size: the cache never moves."""
    for run in sharded:
        got, want = run[f"ring/{layout}/new"]
        assert got.shape == (1, RING_NEW)
        np.testing.assert_array_equal(got, want)
        got, want = run[f"ring/{layout}/seq_dims"]
        np.testing.assert_array_equal(got, want)
        got, want = run[f"ring/{layout}/merge_bytes"]
        np.testing.assert_array_equal(got, want)
        got, most = run[f"ring/{layout}/q_bytes"]
        assert (got <= most).all(), (got, most)


@pytest.mark.parametrize("shape,policy", [("long_500k", "baseline"),
                                          ("decode_32k", "opt")])
def test_sequence_sharded_decode_merges_in_place_at_16x16(shape, policy):
    """The dry-run's decode entries whose cache sequence is split at
    16x16 (qwen3-1.7b): ``long_500k`` (batch 1, the ring over ``data``)
    and the ``opt`` policy's ``decode_32k`` (8 KV heads do not divide
    ``model`` 16: the sequence over ``model``, the int8 cache). The
    merge's all-reduces equal their closed form, L x (mesh dims of the
    sequence) x 2 (all-reduce) x 4 B x rows x heads x (hd + 2) (a max
    of the lse, a sum of the weighted output and its weight), and it
    gathers nothing; attention's other collectives make q whole (at most
    q's bf16 bytes gathered, twice that all-reduced); so every all-gather
    of the entry outside those is not attention's. The whole entry stays
    under 0.01 GiB a device (long_500k) and 0.5 GiB (decode_32k), where
    gathering the cache cost 0.4389 and 28.15 GiB."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    cfg = get_config("qwen3-1.7b")
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim_
    n = 16
    rows = max(1, SHAPES[shape].global_batch // n)      # batch over data
    seq_dims, heads = (1, H // n) if shape == "long_500k" else (1, H)
    with counted(ops, "attend_cache") as attn, \
            counted(spmd, "merge_softmax") as merged:
        rec = dryrun.dryrun_one("qwen3-1.7b", shape, mesh="16x16",
                                policy=policy, verbose=False)
    assert rec["ok"], rec.get("error")
    merge = L * seq_dims * 2 * 4 * rows * heads * (hd + 2)
    assert dict(merged) == {"all-reduce": merge}
    q_full = L * rows * H * hd * 2
    assert attn["all-reduce"] - merge <= 2 * q_full
    assert attn.get("all-gather", 0) <= q_full
    coll = rec["collectives"]
    assert coll["bytes"] / 2 ** 30 <= (0.01 if shape == "long_500k" else 0.5)


# ------------------------------------------------------ the counter

def _counted(case: str) -> tuple:
    """(the counter's record, the closed form {op: bytes})."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    meta = torch.device("meta")
    if case == "fsdp_all_gather":                # a weight's FSDP gather
        with spmd.fake_group(make_production_mesh()) as dm:
            w = distribute_tensor(torch.empty(2048, 1024, device=meta,
                                              dtype=torch.bfloat16), dm,
                                  (Shard(0), Replicate()))
            with spmd.CollectiveCounter() as cc:
                w.redistribute(dm, (Replicate(), Replicate()))
        return cc.record(), {"all-gather": 2048 * 1024 * 2}
    if case == "tp_mlp_all_reduce":             # column- then row-parallel
        Bx, Sx, d, f = 4, 128, 256, 1024
        with spmd.fake_group(MeshShape(("model",), (16,))) as dm:
            x = distribute_tensor(torch.empty(Bx, Sx, d, device=meta,
                                              dtype=torch.bfloat16), dm,
                                  (Replicate(),))
            w1 = distribute_tensor(torch.empty(d, f, device=meta,
                                               dtype=torch.bfloat16), dm,
                                   (Shard(1),))
            w2 = distribute_tensor(torch.empty(f, d, device=meta,
                                               dtype=torch.bfloat16), dm,
                                   (Shard(0),))
            with spmd.CollectiveCounter() as cc:
                ((x @ w1) @ w2).redistribute(dm, (Replicate(),))
        return cc.record(), {"all-reduce": 2 * Bx * Sx * d * 2}
    M, N = 256, 512                             # (S0, S1) -> (S1, S0)
    with spmd.fake_group(make_production_mesh()) as dm:
        x = distribute_tensor(torch.empty(M, N, device=meta), dm,
                              (Shard(0), Shard(1)))
        with spmd.CollectiveCounter() as cc:
            x.redistribute(dm, (Shard(1), Shard(0)))
    # gather rows over data: (M, N/16); then rows for columns over
    # model: (M/16, N); float32
    return cc.record(), {"all-gather": M * N // 16 * 4,
                         "all-to-all": M // 16 * N * 4}


@pytest.mark.parametrize("case", ("fsdp_all_gather", "tp_mlp_all_reduce",
                                  "s0s1_to_s1s0"))
def test_collective_counter_closed_forms(case):
    rec, want = _counted(case)
    assert rec["per_op"] == want
    assert rec["bytes"] == sum(want.values())
    assert rec["per_op_count"] == {k: 1 for k in want}
    assert rec["count"] == len(want)
    assert set(rec["per_op"]) <= set(spmd.COLLECTIVES)


def test_a_plain_dispatch_mode_misses_the_gathers_the_counter_counts():
    """Trap 1: a mode that does not step aside for DTensor sees the
    product before DTensor splits it, and none of its gathers."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))
    with spmd.fake_group(make_production_mesh()) as dm:
        x = distribute_tensor(torch.empty(64, 256, device="meta"), dm,
                              (Shard(0), Shard(1)))
        w = distribute_tensor(torch.empty(256, 512, device="meta"), dm,
                              (Shard(0), Replicate()))
        with spmd.CollectiveCounter() as cc:
            x @ w
        with Seen() as seen:
            x @ w
    assert cc.per_op_count.get("all-gather", 0) >= 1
    assert not any("all_gather" in n for n in seen.names)


def test_fake_group_enters_twice_at_256_and_512():
    import torch.distributed as dist
    for ms, shape in ((make_production_mesh(), (16, 16)),
                      (make_production_mesh(multi_pod=True), (2, 16, 16))):
        with spmd.fake_group(ms) as dm:
            assert dist.get_world_size() == ms.size
            assert tuple(dm.shape) == shape
            assert dm.device_type == "cuda"
            assert dm.mesh_dim_names == ms.axis_names
        assert not dist.is_initialized()


# ------------------------------------------------------ out-of-place twins

@pytest.fixture
def one_rank():
    """A one-process gloo group and its 1 x 1 (data, model) DeviceMesh:
    DTensors whose values are computed, for the DTensor-only paths."""
    import torch.distributed as dist
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield to_device_mesh(MeshShape(("data", "model"), (1, 1)), "cpu")
    finally:
        dist.destroy_process_group()


def _twins(which: str, dm):
    """(the DTensor path's result, the plain in-place path's)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    g = torch.Generator().manual_seed(7)

    def dt(t):
        return distribute_tensor(t, dm, (Shard(0),) * 2)
    slot = torch.tensor([3, 0, 5], dtype=torch.int32)
    if which in ("write_slot", "write_slot_scale"):
        tail = (2, 4) if which == "write_slot" else (2,)
        cache = torch.randn(3, 6, *tail, generator=g)
        new = torch.randn(3, 1, *tail, generator=g)
        with implicit_replication():
            got = tattn._write_slot(dt(cache), dt(new), slot)
        assert spmd.is_dtensor(got)
        plain = cache.clone()
        assert tattn._write_slot(plain, new, slot) is plain
        return got.full_tensor(), plain
    if which == "kv_pos":
        kv = torch.randint(-1, 9, (3, 6), generator=g, dtype=torch.int32)
        pos = torch.tensor([8, 13, 2], dtype=torch.int32)
        with implicit_replication():
            got = tattn.update_kv_pos(dt(kv), pos, 6, 6)
        return got.full_tensor(), tattn.update_kv_pos(kv, pos, 6, 6)
    if which == "counts":
        idx = torch.randint(0, 5, (40,), generator=g)
        with implicit_replication():
            got = tmoe._counts(distribute_tensor(idx, dm, (Shard(0),) * 2),
                               7)
        return got.full_tensor(), tmoe._counts(idx, 7)
    # prefill's cache capture: a ring of 4 slots past an 11-token prompt,
    # or 16 slots padded past it, stacked from the layers' k and v
    ring = which == "prefill_ring"
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              sliding_window=4 if ring else 0)
    params = init_params(cfg, seed=0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 11), generator=g,
                        dtype=torch.int32)
    rules = ShardingRules(MeshShape(("data", "model"), (1, 1)))
    with implicit_replication():
        _, got = tdec.prefill(
            spmd.distribute_tree(params, rules.params_specs(params), dm),
            cfg, dt(tok), cache_seq=None if ring else 16)
    _, want = tdec.prefill(params, cfg, tok, cache_seq=None if ring else 16)
    assert got["k"].shape[2] == (4 if ring else 16)
    return (torch.stack([got["k"].full_tensor(), got["v"].full_tensor()]),
            torch.stack([want["k"], want["v"]]))


@pytest.mark.parametrize("which", ("write_slot", "write_slot_scale",
                                   "kv_pos", "counts", "prefill_ring",
                                   "prefill_pad"))
def test_dtensor_out_of_place_write_equals_the_in_place_one(one_rank, which):
    got, want = _twins(which, one_rank)
    assert torch.equal(got, want)
