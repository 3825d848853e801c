"""The decode pool's static-buffer step (``serving/executor.py::
StaticDecodeStep``) on the CPU, where it always runs eagerly.

The step writes the new ``pos`` and ``kv_pos`` back into the pool's
batched cache, so the cache's storage never moves; a CUDA graph of it
(captured and replayed on a card only: ``tests/test_torch_gpu.py``)
then reads the rows admissions write. Here: its greedy tokens against
the step as it was before (``decode_step``'s new cache dict replacing
the pool's) and against ``serving/smoke.py::reference_decode``, through
admissions between steps, retirements and an abort, for a dense and a
dropless moe config; the storage across steps; the engage rule; the
counters, the forward span's ``graph`` arg and a failed capture; the
kernel wrappers' capture tally; the benchmark's reader of the share.
"""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import ProfileBook, arch_layer_costs
from repro_torch.core.plandiff import PoolSpec
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import init_params
from repro_torch.serving import GraftExecutor, InProcessTransport
from repro_torch.serving import executor as texec
from repro_torch.serving import smoke as tsmoke
from repro_torch.serving.telemetry import Telemetry

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW = 5


def _config(arch: str):
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:              # dropless: capacity factor 8
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


@pytest.fixture(scope="module", params=["qwen3-1.7b", "olmoe-1b-7b"])
def model(request):
    cfg = _config(request.param)
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(cfg, seq_len=8),
                                 name=cfg.name))
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(5)
    base = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in (12, 9, 14, 7, 11)]
    prompts = [(f"c{i % 2}", t) for i, t in enumerate(base)]
    return cfg, book, params, prompts


class _TodaysStep:
    """The pool's step before static buffers: ``decode_step``'s new
    cache dict (fresh ``pos`` and ``kv_pos``) replaces the pool's."""

    replays = fallbacks = 0

    def __init__(self, inst):
        self.inst = inst

    def __call__(self, toks):
        inst = self.inst
        logits, inst._dc = texec.decode_step(
            inst._params, inst.cfg, inst._dc,
            torch.from_numpy(toks).to(inst.device))
        return torch.argmax(logits[:, -1], dim=-1), False


def _serve(cfg, book, params, prompts) -> dict:
    frags = tsmoke.smoke_fragments(cfg, 2, seed=0)
    with GraftExecutor(tsmoke.decode_plan(cfg, book, frags, batch=3),
                       params, cfg, InProcessTransport(), decode_ctx=32,
                       kv_blocks=32, kv_block_tokens=4, device="cpu") as ex:
        r = tsmoke.drive_decode(ex, prompts, MAX_NEW, abort_at={2: 2})
        r["stats"] = next(iter(ex.pool_stats().values()))
    return r


def test_static_step_tokens_equal_todays_step_and_reference(model,
                                                            monkeypatch):
    """Batch 3 over five streams: admissions while others decode, each
    finished stream retiring its slot, stream 2 aborted after two steps.
    The static-buffer step's tokens equal the replaced-cache step's and
    the unbatched reference's, token for token."""
    cfg, book, params, prompts = model
    now = _serve(cfg, book, params, prompts)
    ensure = texec.FragmentInstance._ensure_decode

    def todays(inst):
        ensure(inst)
        inst._step = _TodaysStep(inst)
    monkeypatch.setattr(texec.FragmentInstance, "_ensure_decode", todays)
    before = _serve(cfg, book, params, prompts)
    assert now["aborted"] == [2] and now["mid_admits"] >= 1
    assert now["tokens"] == before["tokens"]
    for i, (_, toks) in enumerate(prompts):
        if i != 2:
            assert now["tokens"][i] == tsmoke.reference_decode(
                cfg, params, toks, MAX_NEW), f"stream {i}"
    st = now["stats"]
    assert st["decode_steps"] == now["steps"]
    assert st["decode_graph_steps"] == 0
    assert st["decode_graph_fallbacks"] == 0


def _pool(cfg, params, batch=3) -> texec.FragmentInstance:
    spec = PoolSpec(key=(cfg.name, 0, cfg.n_layers), share=1, batch=batch,
                    n_instances=1)
    return texec.FragmentInstance(params, cfg, spec, decode_ctx=32,
                                  kv_blocks=32, kv_block_tokens=4)


def test_cache_storage_stays_put_across_steps(model):
    """Steps, an admission into a retired slot and an abort leave every
    entry of the batched cache in its storage, and the step reads the
    pool's own cache dict."""
    cfg, _, params, prompts = model
    inst = _pool(cfg, params)
    for rid, (c, toks) in enumerate(prompts[:3]):
        assert inst.decode_admit(rid, c, toks, 2 + rid, ())["admitted"]
    dc = inst._dc
    ptrs = {k: v.data_ptr() for k, v in dc.items()}
    pos0 = dc["pos"].clone()
    inst.decode_step_batch()                  # stream 0 retires
    assert inst.decode_admit(3, "c1", prompts[3][1], 4, ())["admitted"]
    inst.decode_step_batch()
    assert inst.decode_abort(2)
    inst.decode_step_batch()
    assert inst._dc is dc and inst._step.cache is dc
    assert {k: v.data_ptr() for k, v in dc.items()} == ptrs
    assert int(dc["pos"][1]) == int(pos0[1]) + 3     # advanced in place
    assert inst.decode_steps == 3 and inst._step.eager_steps == 3


def test_engage_rule_reads_eager_for_cpu_and_dtensor_caches():
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import MeshShape
    from torch.distributed.tensor import Replicate, distribute_tensor
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = {"pos": torch.zeros(2, dtype=torch.int32),
           "k": torch.zeros(1, 2, 4, 1, 8)}
    assert not texec.graph_engages(cpu)
    assert texec.graph_engages({"pos": on_card, "k": cpu["k"]})
    with spmd.fake_group(MeshShape(("model",), (2,))) as dm:
        k = distribute_tensor(torch.zeros(1, 2, 4, 1, 8, device="meta"),
                              dm, (Replicate(),))
        assert not texec.graph_engages({"pos": on_card, "k": k})
        assert not texec.graph_engages(
            {"pos": distribute_tensor(torch.zeros(2, dtype=torch.int32,
                                                  device="meta"),
                                      dm, (Replicate(),)), "k": k})


def test_cpu_forward_spans_say_eager(model):
    """Traced through the server path: every ``decode/step/forward``
    span carries ``graph`` false, and the stats count no replay."""
    cfg, book, params, prompts = model
    tel = Telemetry(process="t", trace=True)
    frags = tsmoke.smoke_fragments(cfg, 2, seed=0)
    with GraftExecutor(tsmoke.decode_plan(cfg, book, frags, batch=2),
                       params, cfg, InProcessTransport(), decode_ctx=32,
                       kv_block_tokens=4, telemetry=tel,
                       device="cpu") as ex:
        h = ex.handle(next(iter(ex.pool_specs())))
        for c, toks in prompts[:2]:
            rid = ex.next_rid()
            assert h.decode_admit(rid, c, toks, 4, trace=True)["admitted"]
        for _ in range(3):
            h.decode_step()
        st = h.stats()
    fwd = [s for s in tel.spans if s["name"] == "decode/step/forward"]
    assert len(fwd) == 3
    assert all(s["args"]["graph"] is False for s in fwd)
    assert st["decode_steps"] == 3 and st["decode_graph_steps"] == 0
    assert st["decode_graph_fallbacks"] == 0


def test_capture_that_raises_is_counted_and_steps_eagerly(model,
                                                          monkeypatch,
                                                          capsys):
    """A pool whose step engages but whose capture raises (here: no
    card) tries once, counts it, and serves every step eagerly with the
    reference's tokens."""
    cfg, _, params, prompts = model
    monkeypatch.setattr(texec, "graph_engages", lambda cache: True)
    inst = _pool(cfg, params, batch=2)
    toks = [prompts[0][1], prompts[1][1]]
    out = {}
    for rid, t in enumerate(toks):
        out[rid] = [inst.decode_admit(rid, "c0", t, MAX_NEW, ())["tok"]]
    while inst.decode_active:
        for ev in inst.decode_step_batch()["events"]:
            out[ev["rid"]].append(ev["tok"])
    assert inst.decode_graph_fallbacks == 1
    assert inst.decode_graph_steps == 0
    assert inst._step.eager_steps == inst.decode_steps == MAX_NEW - 1
    assert "capture failed" in capsys.readouterr().err
    for rid, t in enumerate(toks):
        assert out[rid] == tsmoke.reference_decode(cfg, params, t, MAX_NEW)


def test_capture_tally_counts_replays_and_holds_scratch():
    """Inside ``captured_launches`` a wrapper's launch goes to the tally,
    not ``LAUNCHES``; each replay adds the tally; a scratch handed to a
    capture is held, and one that would have to grow raises."""
    cache: dict = {}
    dev = torch.device("cpu")
    buf, ticket = tfa.grown_scratch(cache, dev, 64, 4)
    n0 = tda.LAUNCHES["decode_attention"]
    with tfa.captured_launches() as tally:
        tfa.count_launch(tda.LAUNCHES, "decode_attention")
        tfa.count_launch(tda.LAUNCHES, "decode_attention")
        got = tfa.grown_scratch(cache, dev, 32, 4)
        with pytest.raises(RuntimeError, match="grow"):
            tfa.grown_scratch(cache, dev, 128, 4)
    assert tda.LAUNCHES["decode_attention"] == n0
    assert got[0] is buf and got[1] is ticket
    assert tally.held == [(buf, ticket)]
    tally.replayed()
    tally.replayed()
    assert tda.LAUNCHES["decode_attention"] == n0 + 4
    tda.LAUNCHES["decode_attention"] = n0
    bigger = tfa.grown_scratch(cache, dev, 128, 4)   # outside: it grows
    assert bigger[0] is not buf and bigger[0].numel() == 128
    tfa.count_launch(tda.LAUNCHES, "decode_attention")
    assert tda.LAUNCHES["decode_attention"] == n0 + 1
    tda.LAUNCHES["decode_attention"] = n0


def _span(name, **args):
    return {"name": name, "dur_ms": 1.0, "args": args, "rid": 0, "sid": 0,
            "parent": None, "t0_ms": 0.0}


def test_graph_share_reader():
    """``decode_graph_pct.decode``: the share of forward spans whose
    ``graph`` arg is true; nothing where the forward spans carry no such
    arg (the parent of the graph) or there are none."""
    sys.path.insert(0, str(ROOT))
    from graftbench import harness
    read = harness._metric_reader("decode_graph_pct.decode")
    spans = [_span("decode/step/forward", cpu_ms=0.5, graph=g)
             for g in (True, True, False, True)]
    spans += [_span("decode/step"), _span("decode/step/tokens")]
    assert read({"spans": spans}) == pytest.approx(75.0)
    old = [_span("decode/step/forward", cpu_ms=0.5), _span("decode/step")]
    assert read({"spans": old}) is None
    assert read({"spans": []}) is None and read({}) is None
