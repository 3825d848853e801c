"""Shared scaffolding for real-execution serving runs.

The executor tests and ``chip_smoke.py`` need the same setup: a model
config, a profile book built from its analytic layer costs, initialised
parameters, and a fleet of fragments whose partition points are valid
for the layer count. Centralised here so the pieces can't drift apart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.costmodel import arch_layer_costs
from repro_torch.core.fragment import Fragment
from repro_torch.core.profiles import ProfileBook

DEFAULT_ARCH = "qwen3-1.7b"
DEFAULT_SEQ = 16


def smoke_setup(arch: str = DEFAULT_ARCH, *, seq_len: int = DEFAULT_SEQ,
                seed: int = 0, n_layers: Optional[int] = None,
                full_width: bool = False, dtype: Optional[str] = None,
                device=None):
    """-> (cfg, book, params): everything an executor needs.

    By default the reduced smoke config (2 blocks, narrow widths);
    ``n_layers`` sets the depth. ``full_width`` keeps the registry
    config's published widths instead (``n_layers`` may still cut its
    depth). ``dtype`` overrides the config's dtype. ``device`` None
    means the card, and raises when there is none."""
    from repro_torch.configs import get_config, get_smoke_config, reduced
    from repro_torch.models import init_params

    if full_width:
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
    else:
        cfg = get_smoke_config(arch)
        if n_layers is not None and n_layers != cfg.n_layers:
            cfg = reduced(get_config(arch), n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    costs = dataclasses.replace(arch_layer_costs(cfg, seq_len=seq_len),
                                name=cfg.name)
    book = ProfileBook()
    book.add(costs)
    params = init_params(cfg, seed=seed, device=device)
    return cfg, book, params


def smoke_fragments(cfg, n_clients: int = 3, *, rate: float = 30.0,
                    seed: int = 0) -> list[Fragment]:
    """A small fleet with partition points spread over the model."""
    from repro_torch.models import n_fragment_units
    rng = np.random.RandomState(seed)
    L = n_fragment_units(cfg)
    return [Fragment(cfg.name, p=int(rng.randint(0, L)),
                     t=float(40.0 + 40.0 * rng.rand()), q=rate,
                     client=f"c{i}")
            for i in range(n_clients)]


def smoke_requests(cfg, frags, *, seq_len: int = DEFAULT_SEQ,
                   seed: Optional[int] = None, rng=None) -> list:
    """[(ServeRequest, p), ...] with random token payloads per fragment."""
    from repro_torch.serving.executor import ServeRequest
    if rng is None:
        rng = np.random.RandomState(seed or 0)
    return [(ServeRequest(
        client=f.client,
        tokens=rng.randint(0, cfg.vocab_size, seq_len).astype(np.int32)),
        f.p) for f in frags]


def mixed_depth_plan(cfg, book, frags, *, s: int = 1, batch: int = 4):
    """Hand-built ExecutionPlan with REAL depth-2 chains: clients with
    p < s run an alignment stage [p, s) then the shared pool [s, L);
    clients at p == s hit the shared pool directly.

    The analytic cost book is so cheap that ``GraftPlanner`` may prefer
    solo batch-1 pools, but the runtime must be exercised on the paper's
    aligned topology regardless, so this builds the grouped plan
    explicitly.
    """
    from repro_torch.core.planner import ExecutionPlan
    from repro_torch.core.profiles import Allocation, EMPTY_ALLOC
    from repro_torch.core.repartition import GroupPlan, StagePlan
    from repro_torch.models import n_fragment_units

    prof = book[cfg.name]
    L = n_fragment_units(cfg)
    if any(f.p > s for f in frags):
        raise ValueError("clients must start at p <= s")

    def alloc(start, end, b):
        lat = float(prof.latency_ms(start, end, b, 50))
        return Allocation(share=50, batch=b, n_instances=1,
                          latency_ms=lat, throughput=b / lat * 1e3,
                          resource=50.0)

    lead = min(frags, key=lambda f: f.t)
    shared = StagePlan(lead, s, L, lead.t / 2.0, alloc(s, L, batch))
    aligns = tuple(
        StagePlan(f, f.p, s, f.t / 2.0,
                  alloc(f.p, s, batch) if f.p < s else EMPTY_ALLOC)
        for f in frags)
    gp = GroupPlan(model=cfg.name, repartition_point=s, shared=shared,
                   aligns=aligns)
    return ExecutionPlan(plans=[gp], total_resource=gp.resource,
                         n_fragments_in=len(frags),
                         n_fragments_merged=len(frags),
                         schedule_time_s=0.0)


def check_against_monolithic(cfg, params, reqs, *, atol=5e-5,
                             rtol=1e-3) -> float:
    """Assert each served result equals the un-fragmented forward pass
    (``|got - want| <= atol + rtol * |want|`` elementwise). Returns the
    largest absolute difference seen."""
    from repro_torch.models import forward
    dev = params["embed"].device
    worst = 0.0
    for req, _p in reqs:
        toks = torch.as_tensor(np.asarray(req.tokens, np.int32),
                               device=dev)[None]
        want = forward(params, cfg, toks)[0].float().cpu().numpy()
        got = req.result.float().numpy()
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


# ---------------------------------------------------------------------------
# route smoke: weighted routing + cross-front-end work stealing
# ---------------------------------------------------------------------------

def run_route_smoke(*, arch: str = DEFAULT_ARCH, seq_len: int = DEFAULT_SEQ,
                    seed: int = 0, n_hot: int = 4,
                    budget_ms: float = 5000.0, log=None,
                    device=None) -> dict:
    """Blocking CI smoke: the routing subsystem end-to-end.

    Two front-ends over one shared pool under the weighted router. One
    front-end is wedged mid-traffic (drivers stop consuming, host marked
    unhealthy) with a skewed burst queued against it — the survivor must
    STEAL the queued-not-in-flight work through the fleet balancer and
    complete it with exact numerics, nothing shed and nothing doubled.
    Returns the fleet report (with ``numerics_ok``); raises on a
    stranded run. ``device`` None runs on the card and raises without
    one."""
    import time

    from repro_torch.serving.executor import GraftExecutor, ServeRequest
    from repro_torch.serving.fleet import GraftFleet
    from repro_torch.serving.router import rendezvous_route
    from repro_torch.serving.transport import InProcessTransport

    say = log if log is not None else (lambda *_: None)
    cfg, book, params = smoke_setup(arch, seq_len=seq_len, seed=seed,
                                    n_layers=3, device=device)
    # one client per front-end under HRW, all entering the shared pool
    fes = ["fe0", "fe1"]
    frags, got, i = [], {fe: 0 for fe in fes}, 0
    while min(got.values()) < 1 and i < 10_000:
        name = f"rs{i}"
        fe = rendezvous_route(name, fes)
        if got[fe] < 1:
            got[fe] += 1
            frags.append(Fragment(cfg.name, p=1, t=budget_ms, q=30.0,
                                  client=name))
        i += 1
    plan = mixed_depth_plan(cfg, book, frags, s=1, batch=4)
    ex = GraftExecutor(plan, params, cfg, transport=InProcessTransport(),
                       device=params["embed"].device)
    fleet = GraftFleet(ex, n_frontends=len(fes), book=book).start()
    rng = np.random.RandomState(seed)

    def _reqs(frag, n):
        return [(ServeRequest(
            client=frag.client,
            tokens=rng.randint(0, cfg.vocab_size,
                               seq_len).astype(np.int32)), frag.p)
            for _ in range(n)]

    t0 = time.monotonic()
    try:
        warm = [r for f in frags for r in _reqs(f, 1)]
        for req, p in warm:
            fleet.submit(req, p, budget_ms)
        if not fleet.join(timeout=300.0):
            raise RuntimeError("route smoke: warm round never drained")
        table = fleet.routing_table([f.client for f in frags])
        hot = frags[0]
        victim_fe = table[hot.client]
        victim = fleet.frontend(victim_fe)
        say(f"[route-smoke] wedging {victim_fe} with {n_hot} queued "
            f"requests; survivor must steal")
        for drv in victim._drivers.values():
            drv.batcher.pause()
        doomed = _reqs(hot, n_hot)
        for req, p in doomed:          # accepted by victim BEFORE the mark
            victim.submit(req, p, budget_ms)
        deadline = time.monotonic() + 30.0
        while victim.n_queued < len(doomed):
            if time.monotonic() > deadline:
                raise RuntimeError("route smoke: burst never queued on "
                                   "the wedged front-end")
            time.sleep(0.005)
        fleet.set_health(victim_fe, False)
        # the next control tick priority-steals the wedged queue
        while fleet.stats["steals"] < len(doomed):
            if time.monotonic() > deadline:
                raise RuntimeError("route smoke: nothing stolen from the "
                                   "wedged front-end")
            time.sleep(0.005)
        if not fleet.join(timeout=300.0):
            raise RuntimeError("route smoke: stolen work never completed")
        for drv in victim._drivers.values():
            drv.batcher.resume()
        fleet.set_health(victim_fe, True)
        report = fleet.report()
    finally:
        fleet.stop(drain=False, timeout=10.0)
        ex.close()
    report["wall_s"] = time.monotonic() - t0
    done = warm + doomed
    try:
        report["numerics_max_abs"] = check_against_monolithic(cfg, params,
                                                              done)
        report["numerics_ok"] = True
    except AssertionError as e:
        report["numerics_ok"] = False
        report["numerics_error"] = str(e)[:500]
    report["numerics_checked"] = len(done)
    say(f"[route-smoke] served={report['served']} "
        f"steals={report['steals']} shed={report['shed']} "
        f"router={report['router']} "
        f"numerics_ok={report['numerics_ok']} "
        f"({report['wall_s']:.1f}s)")
    return report


def check_steps_against_forward(cfg, params, tokens, n_steps: int, *,
                                atol=1e-4, rtol=1e-3) -> float:
    """Prefill all but the last ``n_steps`` tokens, then teacher-force
    them through ``decode_step`` one at a time: the prefill logits and
    each step's logits must equal the full forward at those positions
    (``tests/test_models.py``'s multi-step decode bound). This holds the
    final recurrent state a prefill hands to decode. Returns the largest
    absolute difference seen."""
    from repro_torch.models import forward
    from repro_torch.models.decode import decode_step, prefill
    dev = params["embed"].device
    toks = torch.as_tensor(np.asarray(tokens, np.int32).reshape(1, -1),
                           device=dev)
    S = int(toks.shape[1]) - n_steps
    full = forward(params, cfg, toks).float()
    logits, cache = prefill(params, cfg, toks[:, :S],
                            cache_seq=int(toks.shape[1]))
    pairs = [(logits.float(), full[:, :S])]
    for i in range(n_steps):
        logits, cache = decode_step(params, cfg, cache,
                                    toks[:, S + i:S + i + 1])
        pairs.append((logits[:, 0].float(), full[:, S + i]))
    worst = 0.0
    for got, want in pairs:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=atol, rtol=rtol)
        worst = max(worst, float((got - want).abs().max()))
    return worst


# ---------------------------------------------------------------------------
# decode: paged-KV continuous batching vs the unbatched reference
# ---------------------------------------------------------------------------

def decode_plan(cfg, book, frags, *, batch: int = 4):
    """Single full-range pool — the decode topology (the paged cache
    lives pool-side, so decode needs one pool spanning the model)."""
    flat = [dataclasses.replace(f, p=0) for f in frags]
    return mixed_depth_plan(cfg, book, flat, s=0, batch=batch)


def disagg_plan(cfg, book, frags, *, batch: int = 4):
    """The decode topology split across roles: the full-range pool is
    re-roled to prefill and a decode-role pool of the same range rides
    along (``ExecutionPlan.with_disagg``) — prompt prefill runs on one
    pool, the KV blocks cross the transport, and the decode pool owns
    the resident streams."""
    from repro_torch.models import n_fragment_units
    plan = decode_plan(cfg, book, frags, batch=batch)
    return plan.with_disagg(cfg.name, n_fragment_units(cfg), batch=batch)


def reference_decode(cfg, params, tokens, max_new: int, *,
                     margins: Optional[list] = None) -> list:
    """Unbatched greedy decode: prefill + one token at a time, no cache
    manager — THE numerics the serving path must reproduce exactly.

    ``margins``, if given, receives the top-1 minus top-2 logit gap at
    each generated position, so a mismatch can be told from a near-tie.
    """
    from repro_torch.models.decode import decode_step, prefill
    dev = params["embed"].device
    toks = torch.as_tensor(np.asarray(tokens, np.int32).reshape(-1),
                           device=dev)
    ctx = int(toks.shape[0]) + max_new

    def pick(logits) -> int:
        row = logits[0, -1].float()
        if margins is not None:
            top = torch.topk(row, 2).values
            margins.append(float(top[0] - top[1]))
        return int(torch.argmax(row))

    logits, cache = prefill(params, cfg, toks[None], cache_seq=ctx)
    out = [pick(logits)]
    while len(out) < max_new:
        step = torch.tensor([[out[-1]]], dtype=torch.int32, device=dev)
        logits, cache = decode_step(params, cfg, cache, step)
        out.append(pick(logits))
    return out


def check_decode_against_reference(cfg, params, served: list) -> None:
    """``served``: [(ServeRequest, max_new), ...] with ``out_tokens``
    filled in. Greedy decode must match the reference token-for-token."""
    for req, max_new in served:
        want = reference_decode(cfg, params, req.tokens, max_new)
        got = list(req.out_tokens or [])
        assert got == want, (
            f"decode mismatch for {req.client}: served {got} != "
            f"reference {want}")


def drive_decode(ex, prompts, max_new: int, *, disagg: bool = False,
                 abort_at: Optional[dict] = None) -> dict:
    """Serve greedy decode streams through an executor's pool handles.

    ``prompts``: [(client, tokens), ...]; every stream generates
    ``max_new`` tokens. Streams are admitted one at a time, in order, at
    step boundaries while the decode pool has free slots — with
    ``disagg``, each first runs ``prefill_export`` on the prefill-role
    pool and its KV blocks ride the ``decode_admit`` hop to the
    decode-role pool; otherwise the full-range pool prefills for itself.
    The batch then steps until every stream is done. ``abort_at``
    ({stream index: step}) aborts a resident stream with
    ``decode_abort`` once that many batch steps have run; the slot it
    frees admits the next stream while the others are mid-decode. Every
    stream shares prompt prefixes under one reuse signature, the model's
    full block range.

    It serves tests and smokes and is not the server: it has no
    shed policy and no SLO logic (TTFT/TPOT deadlines), which
    ``GraftServer`` adds (``run_decode_smoke``, ``run_disagg_smoke``).

    Returns ``{"tokens": [list or None per stream (None = aborted)],
    "aborted": stream indices aborted, "steps": batch steps,
    "mid_admits": streams admitted while others were mid-decode,
    "handoffs": KV handoffs, "admit_s"/"step_s": host seconds spent
    admitting/stepping}``.
    """
    import time

    from repro_torch.models import n_fragment_units
    full = sig = (ex.cfg.name, 0, n_fragment_units(ex.cfg))
    if disagg:
        dkey = ex.decode_pool_keys()[0]
        pre = ex.handle(ex.prefill_pool_keys(full)[0])
    else:
        dkey = full
    dec = ex.handle(dkey)
    free = dec.stats()["decode_free_slots"]
    abort_at = dict(abort_at or {})
    out: list = [None] * len(prompts)
    rid_of: dict = {}                       # stream index -> rid
    resident: dict = {}                     # rid -> stream index
    todo = list(range(len(prompts)))
    aborted: list = []
    steps = mid = handoffs = 0
    t_admit = t_step = 0.0
    while todo or resident:
        while todo and free > 0:
            i = todo[0]
            client, toks = prompts[i]
            rid = ex.next_rid()
            t0 = time.perf_counter()
            handoff = None
            if disagg:
                pr = pre.prefill_export(rid, client, toks, sig=sig)
                if not pr.get("exported"):
                    raise RuntimeError(f"stream {i}: prefill refused: "
                                       f"{pr.get('reason')}")
                handoff = pr["kv"]
            r = dec.decode_admit(rid, client, toks, max_new, sig=sig,
                                 handoff=handoff)
            t_admit += time.perf_counter() - t0
            if not r.get("admitted"):
                if r.get("reason") in ("no_slot", "kv_oom") and resident:
                    break                   # retry at the next boundary
                raise RuntimeError(f"stream {i}: admission refused: "
                                   f"{r.get('reason')}")
            todo.pop(0)
            handoffs += handoff is not None
            mid += bool(resident) and steps > 0
            rid_of[i] = rid
            if r.get("done"):
                out[i] = list(r["tokens"])
            else:
                resident[rid] = i
                free -= 1
        if not resident:
            continue
        t0 = time.perf_counter()
        rep = dec.decode_step()
        t_step += time.perf_counter() - t0
        steps += 1
        for ev in rep["events"]:
            if ev.get("done"):
                if ev.get("oom"):
                    raise RuntimeError(f"stream {resident[ev['rid']]}: KV "
                                       "arena out of blocks mid-decode")
                out[resident.pop(ev["rid"])] = list(ev["tokens"])
        free = rep["free_slots"]
        for i, at in list(abort_at.items()):
            if steps >= at and rid_of.get(i) in resident:
                if not dec.decode_abort(rid_of[i]):
                    raise RuntimeError(f"stream {i}: abort found no stream")
                del resident[rid_of[i]]
                del abort_at[i]
                aborted.append(i)
                free += 1
    return {"tokens": out, "aborted": aborted, "steps": steps,
            "mid_admits": mid,
            "handoffs": handoffs, "admit_s": t_admit, "step_s": t_step}


# ---------------------------------------------------------------------------
# the server's decode smokes (scripts/ci_torch.sh)
# ---------------------------------------------------------------------------

def _decode_prompt(cfg, seed: int, i: int, n_clients: int,
                   seq_len: int) -> np.ndarray:
    """Half the streams share a per-client prompt (the paged cache's
    prefix sharing, across the hop under disaggregation), half are
    fresh."""
    s = seed * 131 + i if i % 2 == 0 else seed * 977 + (i % n_clients)
    return np.random.RandomState(s).randint(
        0, cfg.vocab_size, seq_len).astype(np.int32)


def _serve_decode_smoke(tag: str, *, disagg: bool, arch: str,
                        n_clients: int, n_requests: int, seq_len: int,
                        max_new: int, decode_ctx: int, seed: int,
                        budget_ms: float, tpot_ms: float, log,
                        device) -> dict:
    """Submit ``n_requests`` decode streams to a ``GraftServer`` over a
    single-pool (or disaggregated) decode plan, drain it, and hold every
    stream against the unbatched reference."""
    import time

    from repro_torch.serving.executor import GraftExecutor, ServeRequest
    from repro_torch.serving.server import GraftServer
    from repro_torch.serving.transport import InProcessTransport

    say = log if log is not None else (lambda *_: None)
    cfg, book, params = smoke_setup(arch, seq_len=seq_len, seed=seed,
                                    device=device)
    frags = smoke_fragments(cfg, n_clients, rate=30.0, seed=seed)
    plan = (disagg_plan if disagg else decode_plan)(
        cfg, book, frags, batch=max(n_clients, 2))
    # small blocks so the smoke prompts span FULL blocks — the prefix
    # index only shares full (or clean-partial) blocks, so default-sized
    # blocks would swallow the whole prompt into one unshareable partial
    ex = GraftExecutor(plan, params, cfg, transport=InProcessTransport(),
                       decode_ctx=decode_ctx, kv_block_tokens=4,
                       decode_disagg=disagg, device=params["embed"].device)
    server = GraftServer(ex, book=book).start()
    served: list = []
    say(f"[{tag}] {cfg.name} on {ex.device}: {n_requests} streams x "
        f"{max_new} tokens over {n_clients} clients, decode_ctx="
        f"{decode_ctx}" + (", prefill pool -> KV frame -> decode pool"
                           if disagg else ""))
    t0 = time.monotonic()
    try:
        for i in range(n_requests):
            f = frags[i % len(frags)]
            req = ServeRequest(client=f.client,
                               tokens=_decode_prompt(cfg, seed, i,
                                                     len(frags), seq_len),
                               max_new_tokens=max_new,
                               tpot_budget_ms=tpot_ms)
            server.submit(req, 0, budget_ms)
            served.append((req, max_new))
            time.sleep(0.01)
        if not server.join(timeout=600.0):
            raise RuntimeError(f"{tag} never drained")
        report = server.report()
        kv = {s.get("role", "both"): s["kv"]
              for s in ex.pool_stats().values() if s.get("kv")}
    finally:
        server.stop(drain=False, timeout=10.0)
        ex.close()
    report["wall_s"] = time.monotonic() - t0
    done = [(r, m) for r, m in served if r.out_tokens is not None]
    try:
        check_decode_against_reference(cfg, params, done)
        report["numerics_ok"] = True
    except AssertionError as e:
        report["numerics_ok"] = False
        report["numerics_error"] = str(e)[:500]
    report["numerics_checked"] = len(done)
    if disagg:
        report["pool_kv"] = kv
    else:
        report["kv"] = kv.get("both", {})
    return report


def run_decode_smoke(*, arch: str = DEFAULT_ARCH, n_clients: int = 3,
                     n_requests: int = 12, seq_len: int = 12,
                     max_new: int = 5, decode_ctx: int = 64,
                     seed: int = 0, budget_ms: float = 4000.0,
                     tpot_ms: float = 2000.0, log=None,
                     device=None) -> dict:
    """Blocking CI smoke: run the event-driven server's continuous-
    batching decode path end-to-end in-process and check every stream's
    tokens against the unbatched reference. Returns the server report
    (with ``numerics_ok``); raises on a stranded run. ``device`` None
    runs on the card and raises without one."""
    say = log if log is not None else (lambda *_: None)
    report = _serve_decode_smoke(
        "decode-smoke", disagg=False, arch=arch, n_clients=n_clients,
        n_requests=n_requests, seq_len=seq_len, max_new=max_new,
        decode_ctx=decode_ctx, seed=seed, budget_ms=budget_ms,
        tpot_ms=tpot_ms, log=log, device=device)
    say(f"[decode-smoke] served={report['decode_served']} "
        f"local={report['decode_local']} "
        f"prefix_hits={report['kv'].get('prefix_hits', 0)} "
        f"numerics_ok={report['numerics_ok']} "
        f"({report['wall_s']:.1f}s)")
    return report


def run_disagg_smoke(*, arch: str = DEFAULT_ARCH, n_clients: int = 3,
                     n_requests: int = 10, seq_len: int = 12,
                     max_new: int = 5, decode_ctx: int = 64,
                     seed: int = 0, budget_ms: float = 4000.0,
                     tpot_ms: float = 2000.0, log=None,
                     device=None) -> dict:
    """Blocking CI smoke: the disaggregated serve loop end-to-end.

    A prefill-role pool and a decode-role pool over the same range; the
    server's two-phase admit runs prompt prefill on one and hands the KV
    blocks to the other over the transport. Every stream must match the
    unbatched reference token-for-token AND at least one cross-pool KV
    handoff must actually have happened (otherwise the split silently
    degenerated to decode-pool self-prefill). Raises on a stranded run.
    ``device`` None runs on the card and raises without one."""
    say = log if log is not None else (lambda *_: None)
    report = _serve_decode_smoke(
        "disagg-smoke", disagg=True, arch=arch, n_clients=n_clients,
        n_requests=n_requests, seq_len=seq_len, max_new=max_new,
        decode_ctx=decode_ctx, seed=seed, budget_ms=budget_ms,
        tpot_ms=tpot_ms, log=log, device=device)
    if report["kv_handoffs"] < 1:
        raise RuntimeError(
            "disagg smoke: no cross-pool KV handoff happened "
            f"(kv_handoffs={report['kv_handoffs']}, "
            f"decode_local={report['decode_local']})")
    say(f"[disagg-smoke] served={report['decode_served']} "
        f"handoffs={report['kv_handoffs']} "
        f"handoff_ms={report['kv_handoff_ms']:.2f} "
        f"local={report['decode_local']} "
        f"numerics_ok={report['numerics_ok']} "
        f"({report['wall_s']:.1f}s)")
    return report
