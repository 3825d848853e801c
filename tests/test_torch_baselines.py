"""The port's baselines, serving launcher and measured profiler against the
JAX package, on the CPU.

``core/baselines.py`` (GSLICE/GSLICE+, Static/Static+, Optimal) is a
numpy copy: on one shared profile book (the reference's default book,
its layer costs and rates copied into a port book, as in
``test_torch_controller.py``) each baseline must give the reference's
plan exactly — the same pools, shares, batches and instance counts, and
the same ``total_resource``. ``launch/serve.py``'s planning report must
print the reference's fragment list and chip-share figures on that
book. ``core/measured.py`` times torch fragments instead of jitted JAX
ones, so its latencies differ; the shapes and the byte terms it does not
measure must agree.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest

from repro import models as JM
from repro.configs import get_smoke_config as j_smoke_config
from repro.core import baselines as jbase
from repro.core import default_book as j_default_book
from repro.core.measured import measure_layer_costs as j_measure
from repro.core.plandiff import plan_pools as j_plan_pools
from repro.launch import serve as jserve
from repro.serving.clients import fleet_fragments as j_fleet_fragments
from repro.serving.clients import make_fleet as j_make_fleet
from repro_torch.core import (plan_gslice, plan_optimal, plan_static,
                              plan_pools)
from repro_torch.core.costmodel import LayerCosts
from repro_torch.core.measured import measure_layer_costs
from repro_torch.core.profiles import ProfileBook
from repro_torch.launch import serve as tserve
from repro_torch.models import from_jax_params
from repro_torch.serving import fleet_fragments, make_fleet
from repro_torch.serving.smoke import smoke_setup


@pytest.fixture(scope="module")
def books():
    """(JAX book, port book): the reference's default book and a port
    book over the same layer costs at the same rates."""
    jbook = j_default_book()
    book = ProfileBook()
    for name, jprof in jbook._profiles.items():
        c = jprof.costs
        prof = book.add(LayerCosts(**{f.name: getattr(c, f.name)
                                      for f in dataclasses.fields(c)}))
        prof.cf, prof.cm = jprof.cf, jprof.cm
    return jbook, book


def _frags(books, model, n, t, seed=3):
    """The same fleet's fragments at trace time ``t`` in both packages."""
    jbook, book = books
    jf = j_fleet_fragments(j_make_fleet(model, jbook, n_nano=n, n_tx2=1,
                                        rate=30.0, seed=seed), jbook, t=t)
    tf = fleet_fragments(make_fleet(model, book, n_nano=n, n_tx2=1,
                                    rate=30.0, seed=seed), book, t=t)
    assert [(f.p, f.t, f.q, f.client) for f in jf] == \
        [(f.p, f.t, f.q, f.client) for f in tf] and tf
    return jf, tf


def _pools(pools):
    return {k: (s.share, s.batch, s.n_instances, s.role)
            for k, s in pools.items()}


def _same_plan(got, want):
    assert got.total_resource == want.total_resource
    assert got.n_fragments_in == want.n_fragments_in
    assert got.n_fragments_merged == want.n_fragments_merged
    assert got.meta == want.meta
    assert _pools(plan_pools(got)) == _pools(j_plan_pools(want))


@pytest.mark.parametrize("model", ["inc", "vgg", "qwen3-1.7b"])
@pytest.mark.parametrize("merge_uniform", [False, True])
def test_gslice_plans_equal_jax(books, model, merge_uniform):
    jbook, book = books
    jf, tf = _frags(books, model, 9, t=42.0)
    _same_plan(plan_gslice(tf, book, merge_uniform=merge_uniform),
               jbase.plan_gslice(jf, jbook, merge_uniform=merge_uniform))


@pytest.mark.parametrize("merge_uniform", [False, True])
def test_static_plans_on_average_fragments_equal_jax(books, merge_uniform):
    jbook, book = books
    jf, tf = _frags(books, "res", 8, t=42.0)
    javg, tavg = _frags(books, "res", 8, t=10.0)
    _same_plan(plan_static(tf, book, avg_frags=tavg,
                           merge_uniform=merge_uniform),
               jbase.plan_static(jf, jbook, avg_frags=javg,
                                 merge_uniform=merge_uniform))
    # without average fragments, Static plans the current ones
    _same_plan(plan_static(tf, book), jbase.plan_static(jf, jbook))


def test_optimal_plans_equal_jax_and_refuse_large_fleets(books):
    jbook, book = books
    jf, tf = _frags(books, "mob", 5, t=42.0)
    _same_plan(plan_optimal(tf, book, group_size=3),
               jbase.plan_optimal(jf, jbook, group_size=3))
    jf, tf = _frags(books, "mob", 12, t=42.0)
    with pytest.raises(ValueError, match="limited to 4 fragments"):
        plan_optimal(tf, book, max_fragments=4)
    with pytest.raises(ValueError, match="limited to 4 fragments"):
        jbase.plan_optimal(jf, jbook, max_fragments=4)


# ----------------------------------------------------------- launch.serve

def _report(text):
    """The planning report's lines, the planner's wall time stripped."""
    return [re.sub(r", \d+ ms to plan", "", line)
            for line in text.strip().splitlines()]


def test_serve_planning_report_equals_jax(books, capsys, monkeypatch):
    jbook, book = books
    argv = ["--arch", "qwen3-1.7b", "--clients", "12", "--tx2", "2",
            "--t", "30", "--duration", "4"]
    assert jserve.main(argv) == 0
    want = _report(capsys.readouterr().out)
    monkeypatch.setattr(tserve, "default_book", lambda: book)
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    got = _report(capsys.readouterr().out)
    assert got == want
    assert re.match(r"\d+ fragments: \[", got[0])
    assert [line.split()[0] for line in got[1:4]] == \
        ["Graft", "GSLICE:", "placement:"]


def test_serve_launcher_needs_a_card_or_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--clients", "2"])


# --------------------------------------------------------------- measured

def test_measured_layer_costs_shapes_and_bytes_equal_jax():
    jcfg = j_smoke_config("qwen3-1.7b")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg, _, _ = smoke_setup("qwen3-1.7b", device="cpu")
    params = from_jax_params(jax.device_get(jp))
    want = j_measure(jcfg, jp, seq_len=8, batches=(1, 2), reps=1)
    got = measure_layer_costs(cfg, params, seq_len=8, batches=(1, 2),
                              reps=1)
    assert got.n_layers == want.n_layers == cfg.n_layers
    for name in ("flops_per_item", "weight_bytes", "mobile_flops"):
        g = np.asarray(getattr(got, name))
        assert g.shape == np.asarray(getattr(want, name)).shape
        assert np.isfinite(g).all() and (g > 0).all(), name
    np.testing.assert_array_equal(got.act_bytes, want.act_bytes)
    assert got.input_bytes == want.input_bytes
    assert got.name == want.name
