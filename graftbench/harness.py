"""One run of one cell: set the system up, warm it, drive the window,
drain, judge the outputs, and reduce what was recorded to metrics.

The system under test is ``repro_torch`` driven through its public
serving API, in process: the planner and controller for one-shot
fragments (``GraftPlanner``, ``ServingController``), the executor
(``GraftExecutor``) over the in-process transport, and the event-driven
``GraftServer``. The harness only submits requests at their scheduled
times and watches the server's completion records; every end-to-end
number is the harness's own host clock.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from graftbench import check, stats, traffic
from graftbench.weights import make_weights

HERE = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = HERE.parent) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration file,
    traffic mix and limits loaded."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = dict(cells[workload])
    cfgs = {c["name"]: c for c in bench["configs"]}
    cell["config_file"] = load_json(root / cfgs[cell["config"]]["file"])
    cell["mix"] = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    cell["limits"] = load_json(HERE / "limits" / f"{workload}.json")
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if workload in m.get("workloads", [workload])]
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if workload in m.get("workloads", [workload])]
    return cell


# ---------------------------------------------------------------- model
def port_config(cf: dict):
    """The port's registry config, run as the configuration file states
    (dtype; a moe dispatch that never drops), checked against the
    file's sizes."""
    from repro_torch.configs import get_config
    cfg = get_config(cf["port_config"])
    cfg = dataclasses.replace(cfg, dtype=cf["torch_dtype"])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf["capacity_factor"])))
    want = {"n_layers": cf["num_hidden_layers"],
            "d_model": cf["hidden_size"],
            "n_heads": cf["num_attention_heads"],
            "n_kv_heads": cf["num_key_value_heads"],
            "head_dim_": cf["head_dim"], "vocab_size": cf["vocab_size"],
            "rope_theta": cf["rope_theta"],
            "tie_embeddings": cf["tie_word_embeddings"]}
    if cfg.moe is not None:
        want.update(n_experts=cf["num_experts"],
                    top_k=cf["num_experts_per_tok"],
                    d_ff_expert=cf["intermediate_size"])
    else:
        want["d_ff"] = cf["intermediate_size"]
    for k, v in want.items():
        have = getattr(cfg.moe, k) if k in ("n_experts", "top_k",
                                           "d_ff_expert") \
            else getattr(cfg, k)
        if have != v:
            raise ValueError(f"{cf['name']}: port {k}={have}, file {v}")
    return cfg


def reference_model(cf: dict) -> dict:
    """The sizes and conventions the reference reads."""
    return {"layers": cf["num_hidden_layers"],
            "heads": cf["num_attention_heads"],
            "kv_heads": cf["num_key_value_heads"],
            "head_dim": cf["head_dim"], "rope_theta": cf["rope_theta"],
            "norm_eps": cf["rms_norm_eps"],
            "qk_norm": cf["qk_norm"], "qk_norm_eps": cf["qk_norm_eps"],
            "tie_embeddings": cf["tie_word_embeddings"],
            "top_k": cf.get("num_experts_per_tok", 0)}


# --------------------------------------------------------------- system
def make_tap():
    """An in-process transport that keeps every channel it opens, so a
    run can read the channels' transfer logs (``TransferStats``)."""
    from repro_torch.serving.transport import InProcessTransport

    class Tap(InProcessTransport):
        def __init__(self):
            super().__init__()
            self.channels = []

        def connect(self, name):
            ch = super().connect(name)
            self.channels.append(ch)
            return ch
    return Tap()


def wire_bytes(tap) -> int:
    return sum(ch.stats.total_bytes for ch in tap.channels)


def build_system(cfg, params, sched, mix: dict, device, telemetry):
    """-> (server, executor, transport tap). The planner's bootstrap plan
    (or the cell's decode pool) serves the whole window: the server runs
    no controller."""
    from repro_torch.core import GraftPlanner
    from repro_torch.core.costmodel import arch_layer_costs
    from repro_torch.core.fragment import Fragment
    from repro_torch.core.profiles import ProfileBook
    from repro_torch.serving import (GraftExecutor, GraftServer,
                                     ServingController)
    serve = mix["serve"]
    book = ProfileBook()
    book.add(dataclasses.replace(arch_layer_costs(
        cfg, seq_len=int(serve.get("profile_seq_len", 128))),
        name=cfg.name))
    frags = [Fragment(cfg.name, p=c.p, t=c.budget_ms,
                      q=max(c.rate_rps, 1e-3), client=c.name)
             for c in sched.clients]
    tap = make_tap()
    if serve["plan"] == "graft":
        period = float(serve["control_period_ms"])
        ctl = ServingController(book, planner=GraftPlanner(book),
                                control_period_ms=period,
                                min_replan_interval_ms=period,
                                window_ms=float(serve["window_ms"]))
        plan = ctl.bootstrap(frags, now_ms=0.0)
        ex = GraftExecutor(plan, params, cfg, transport=tap,
                           telemetry=telemetry, device=device)
    elif serve["plan"] == "decode_pool":
        from repro_torch.serving.smoke import decode_plan
        plan = decode_plan(cfg, book, frags, batch=int(serve["batch"]))
        ex = GraftExecutor(plan, params, cfg, transport=tap,
                           decode_ctx=int(serve["decode_ctx"]),
                           kv_blocks=int(serve["kv_blocks"]),
                           kv_block_tokens=int(serve["kv_block_tokens"]),
                           telemetry=telemetry, device=device)
    else:
        raise ValueError(f"unknown plan {serve['plan']!r}")
    log(f"[graftbench] plan: {len(plan.plans)} groups, "
        f"{ex.n_stage_pools} stage pools, total_resource "
        f"{plan.total_resource:.1f} (the planner's share units; not a "
        "metric until the cost model is calibrated)")
    server = GraftServer(ex, book=book, telemetry=telemetry)
    return server, ex, tap


# --------------------------------------------------------------- window
class Watch:
    """Follows the server's completion log from a mark on."""

    def __init__(self, server):
        self.server = server
        self.mark = server.mark()

    def poll(self) -> list:
        recs = self.server.records(self.mark)
        self.mark += len(recs)
        return recs

    def wait(self, timeout: float) -> None:
        """Block until a completion lands past the mark, or ``timeout``
        seconds pass. It waits on the condition the server notifies for
        every completion (the one ``join`` waits on), so the harness
        takes the interpreter lock only when there is something to do,
        never to poll."""
        cond = self.server._done_cond
        with cond:
            cond.wait_for(lambda: self.server.mark() > self.mark,
                          max(timeout, 0.0))


def emitted(server, rid: int) -> int:
    """Tokens the server has emitted so far for a decode stream still on
    its books (0 for one not yet admitted or already gone)."""
    st = server._inflight.get(rid)
    return 0 if st is None else int(st.n_gen)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm_oneshot(server, sched, device, vocab: int) -> None:
    """One request per client, lengths across the mix's range."""
    from repro_torch.serving import ServeRequest
    lens = sorted(len(r.tokens) for r in sched.requests)
    rng = np.random.default_rng(0)
    for i, c in enumerate(sched.clients):
        n = lens[(i * (len(lens) - 1)) // max(len(sched.clients) - 1, 1)]
        toks = rng.integers(0, vocab, n, dtype=np.int32)
        server.submit(ServeRequest(client=c.name, tokens=toks), c.p,
                      1e9)
    if not server.join(timeout=600.0):
        raise RuntimeError("warm-up requests never completed")
    sync(device)


def warm_decode(server, sched, device, vocab: int) -> None:
    """Fill the decode batch once: every session admits a prompt of its
    own length band and decodes a few tokens."""
    from repro_torch.serving import ServeRequest
    lens = sorted(len(t.tokens) for s in sched.sessions for t in s)
    rng = np.random.default_rng(0)
    n = len(sched.clients)
    for i, c in enumerate(sched.clients):
        k = lens[(i * (len(lens) - 1)) // max(n - 1, 1)]
        toks = rng.integers(0, vocab, k, dtype=np.int32)
        server.submit(ServeRequest(client=c.name, tokens=toks,
                                   max_new_tokens=8), 0, 1e9)
    if not server.join(timeout=600.0):
        raise RuntimeError("warm-up streams never completed")
    sync(device)


def drive_oneshot(server, sched, seconds: float, drain_s: float,
                  keep: set) -> dict:
    """Open loop: submit each request at its due time; watch the log.
    Results of requests outside ``keep`` are dropped when they land."""
    from repro_torch.serving import ServeRequest
    watch = Watch(server)
    reqs = sched.requests
    by_rid: dict = {}
    sent = [None] * len(reqs)
    done_t = [None] * len(reqs)
    shed = [False] * len(reqs)
    objs = [None] * len(reqs)
    late = 0.0
    i = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    outstanding = 0
    while True:
        now = time.perf_counter()
        while i < len(reqs) and now - t0 >= reqs[i].due_s:
            r = reqs[i]
            c = sched.clients[r.client]
            req = ServeRequest(client=c.name, tokens=r.tokens)
            by_rid[server.submit(req, c.p, c.budget_ms)] = i
            sent[i] = now - t0
            late = max(late, sent[i] - r.due_s)
            objs[i] = req
            outstanding += 1
            i += 1
            now = time.perf_counter()
        for rec in watch.poll():
            j = by_rid.get(rec["rid"])
            if j is None:
                continue
            done_t[j] = time.perf_counter() - t0
            shed[j] = bool(rec.get("shed"))
            outstanding -= 1
            if j not in keep:
                objs[j].result = None
        now = time.perf_counter()
        if i >= len(reqs) and (outstanding == 0
                               or now > end + drain_s):
            break
        nxt = reqs[i].due_s + t0 if i < len(reqs) else end + drain_s
        watch.wait(nxt - now)
    return {"t_close": seconds, "t_end": time.perf_counter() - t0,
            "sent": sent, "done": done_t, "shed": shed, "reqs": objs,
            "late_s": late}


def drive_decode(server, sched, seconds: float, drain_s: float) -> dict:
    """Closed loop: every session sends its next turn as soon as its
    last one has finished, until the window closes; then drain. At the
    close every stream still running has its tokens so far noted."""
    from repro_torch.serving import ServeRequest
    watch = Watch(server)
    n = len(sched.sessions)
    nxt = [0] * n
    by_rid: dict = {}
    # [session, turn, t_send, t_done, rec, req, rid, tokens at the close]
    log_ = []
    close_ms = None           # the close on the server's clock
    t0 = time.perf_counter()
    end = t0 + seconds

    def send(s: int) -> None:
        turn = sched.sessions[s][nxt[s]]
        req = ServeRequest(client=sched.clients[s].name, tokens=turn.tokens,
                           max_new_tokens=turn.max_new)
        rid = server.submit(req, 0, sched.budget_ms)
        by_rid[rid] = len(log_)
        log_.append([s, nxt[s], time.perf_counter() - t0, None, None, req,
                     rid, None])
        nxt[s] += 1

    for s in range(n):
        send(s)
    outstanding = n
    while True:
        closed = close_ms is not None
        if not closed and time.perf_counter() >= end:
            # the close: what each running stream has emitted by now
            close_ms = server.now_ms()
            for row in log_:
                if row[4] is None:
                    row[7] = emitted(server, row[6])
            closed = True
        for rec in watch.poll():
            j = by_rid.get(rec["rid"])
            if j is None:
                continue
            now = time.perf_counter()
            log_[j][3] = now - t0
            log_[j][4] = rec
            outstanding -= 1
            s = log_[j][0]
            if not closed and nxt[s] < len(sched.sessions[s]):
                send(s)
                outstanding += 1
        now = time.perf_counter()
        if closed and (outstanding == 0 or now > end + drain_s):
            break
        watch.wait((end if not closed else end + drain_s) - now)
    return {"t_close": seconds, "t_end": time.perf_counter() - t0,
            "close_ms": close_ms, "log": log_}


# ------------------------------------------------------------ end to end
def oneshot_e2e(sched, win: dict, seconds: float) -> dict:
    """Latency from due time to the observed result; misses are inf."""
    lat, bud = [], []
    for r, d, sh in zip(sched.requests, win["done"], win["shed"]):
        lat.append(stats.MISS if d is None or sh else
                   (d - r.due_s) * 1e3)
        bud.append(sched.clients[r.client].budget_ms)
    answered = [len(r.tokens) for r, d, sh in zip(
        sched.requests, win["done"], win["shed"])
        if d is not None and not sh and d <= seconds]
    return {"latencies_ms": lat, "budgets_ms": bud,
            "frag_tok_s": sum(answered) / seconds,
            "answered_in_window": len(answered),
            "goodput_rps": stats.goodput(lat, bud, seconds),
            "latency_p50_ms": stats.percentile(lat, 0.50),
            "n": len(lat), "beyond_p90": stats.beyond(lat, 0.90),
            "missed": sum(1 for x in lat if math.isinf(x)),
            "met": sum(1 for x, b in zip(lat, bud) if x <= b)}


def decode_e2e(win: dict, seconds: float) -> dict:
    """Output tokens emitted within the window, per second: every token
    of a stream that finished before the close, and the tokens a stream
    still running at the close had emitted by then. A stream that is
    later shed or never answered delivers none. A stream whose record
    says it finished by the close (on the server's clock) counts whole,
    though the harness saw the record after it."""
    toks = 0
    ttft, n_done, n_missed = [], 0, 0
    for s, j, ts, td, rec, req, rid, at_close in win["log"]:
        served = rec is not None and not rec.get("shed")
        if ts < seconds:
            ttft.append(rec["ttft_ms"] if served else stats.MISS)
            n_missed += 0 if served else 1
        if not served:
            continue
        if at_close is None or rec["t_done_ms"] <= win["close_ms"]:
            toks += int(rec.get("n_tokens", 0))
            n_done += 1
        else:
            toks += min(at_close, int(rec.get("n_tokens", 0)))
    return {"decode_tok_s": toks / seconds, "tokens": toks,
            "completed": n_done, "sent": len(ttft), "missed": n_missed,
            "ttft_ms": ttft}


# ------------------------------------------------------------------ run
def _hist(tel, name: str) -> tuple:
    st = tel.histogram(name).state()
    return st["count"], st["sum"]


def _metric_reader(name: str):
    import importlib.util
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"graftbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def stop(server, ex) -> None:
    """Stop the server, wait for its threads (a control tick in flight
    may still apply a plan), then retire the pools."""
    import threading
    server.stop(drain=False, timeout=10.0)
    for t in threading.enumerate():
        if t.name.startswith(f"{server.name}-") or \
                t.name.startswith("pool-driver-"):
            t.join(timeout=10.0)
    ex.close()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             *, t_start: float, rate_rps=None,
             control: bool = False) -> dict:
    """Run ``cell`` once; -> the result object (see ``run.py``).
    ``t_start`` is the process's start on ``time.perf_counter``'s clock.
    ``control`` also reads the fp8 control at the checked positions
    (``control.py``; never in a benchmark run)."""
    from repro_torch.serving.telemetry import Telemetry
    cf, mix = cell["config_file"], cell["mix"]
    cfg = port_config(cf)
    import repro_torch.models  # noqa: F401  (the port's model code)
    log(f"[graftbench] set-up: imports done at "
        f"{time.perf_counter() - t_start:.3f} s")
    params = make_weights(cfg, seed, device)
    sync(device)
    log(f"[graftbench] set-up: weights drawn at "
        f"{time.perf_counter() - t_start:.3f} s")
    sched = traffic.build(mix, seed, seconds, cfg.vocab_size, rate_rps)
    oneshot = sched.kind == "open_oneshot"
    tel = Telemetry(process="graftbench", trace=True, trace_sample=1.0,
                    max_spans=2_000_000) if trace else None
    server, ex, tap = build_system(cfg, params, sched, mix, device, tel)
    server.start()
    log(f"[graftbench] set-up: system built at "
        f"{time.perf_counter() - t_start:.3f} s")
    try:
        (warm_oneshot if oneshot else warm_decode)(server, sched, device,
                                                   cfg.vocab_size)
        rng = np.random.default_rng(int(seed) + 1)
        keep = set()
        if oneshot:
            n = len(sched.requests)
            longest = max(range(n), key=lambda j: len(sched.requests[j]
                                                      .tokens))
            k = min(int(mix["check"]["sample"]), n)
            keep = {longest, *rng.choice(n, k - 1, replace=False).tolist()}
        before = {}
        if trace:
            tel.spans.clear()
            before = {h: _hist(tel, h) for h in ("server/exec_ms",
                                                 "pool/exec_ms")}
            before["wire"] = wire_bytes(tap)
            from graftbench.trace import DeviceTrace
            dtrace = DeviceTrace()
            dtrace.start()
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # what set-up left on the heap is not the garbage collector's to
        # walk again inside the window
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        log(f"[graftbench] set-up: warm-up done at {setup_s:.3f} s")
        drain_s = float(mix.get("drain_s", 60))
        if oneshot:
            win = drive_oneshot(server, sched, seconds, drain_s, keep)
        else:
            win = drive_decode(server, sched, seconds, drain_s)
        sync(device)
        profile = None
        if trace:
            dtrace.stop()
        peak = torch.cuda.max_memory_allocated() \
            if torch.device(device).type == "cuda" else 0
        layer = {}
        if trace:
            profile = dtrace.summary()
            del dtrace
            layer = {"spans": list(tel.spans),
                     "hist": {h: tuple(a - b for a, b in
                                       zip(_hist(tel, h), before[h]))
                              for h in ("server/exec_ms", "pool/exec_ms")},
                     "wire_bytes": wire_bytes(tap) - before["wire"]}
    finally:
        stop(server, ex)
    del server, ex, tap
    gc.unfreeze()
    free(device)
    if oneshot:
        e2e = oneshot_e2e(sched, win, seconds)
        unanswered = e2e["missed"]
        log(f"[graftbench] {e2e['n']} requests due, "
            f"{e2e['answered_in_window']} answered in the window, "
            f"{e2e['met']} within "
            f"budget (goodput {e2e['goodput_rps']:.4f} req/s), "
            f"{unanswered} unanswered; p50 {e2e['latency_p50_ms']:.3f} ms, "
            f"p90 has {e2e['beyond_p90']} beyond it; generator at most "
            f"{win['late_s'] * 1e3:.3f} ms late; last result "
            f"{win['t_end']:.3f} s after the window opened")
    else:
        e2e = decode_e2e(win, seconds)
        unanswered = e2e["missed"]
        log(f"[graftbench] {e2e['sent']} streams sent, {e2e['completed']} "
            f"completed in the window, {e2e['tokens']} tokens emitted in "
            "it, "
            f"{unanswered} unanswered; drain ended "
            f"{win['t_end']:.3f} s after the window opened")
    # ------------------------------------------------- outputs judged
    from graftbench.reference import Reference
    ref = Reference(reference_model(cf), params)
    t_ref = time.perf_counter()
    if oneshot:
        sample = [(sched.requests[j].tokens, win["reqs"][j].result)
                  for j in sorted(keep) if win["reqs"][j] is not None
                  and win["reqs"][j].result is not None]
        tally = check.oneshot_sample(ref, sample, device)
        seqs, starts = [list(t) for t, _ in sample], None
    else:
        served = [(row[5].tokens, row[5].out_tokens) for row in win["log"]
                  if row[5].out_tokens]
        k = min(int(mix["check"]["sample"]), len(served))
        longest = max(range(len(served)),
                      key=lambda j: len(served[j][0]) + len(served[j][1]))
        rng = np.random.default_rng(int(seed) + 1)
        pick = {longest, *rng.choice(len(served), k - 1, replace=False)
                .tolist()}
        chosen = [served[j] for j in sorted(pick)]
        tally = check.decode_sample(ref, chosen, device)
        seqs = [list(p) + list(o[:-1]) for p, o in chosen]
        starts = [len(p) for p, _ in chosen]
    numbers = tally.numbers()
    sync(device)
    log(f"[graftbench] reference over {numbers['positions']} positions "
        f"took {time.perf_counter() - t_ref:.3f} s")
    correct, shown = check.judge(numbers, cell["limits"], unanswered)
    ctrl_numbers = None
    if control:
        from graftbench.reference import Reference as R
        ctrl_numbers = check.control_sample(
            ref, R(reference_model(cf), params, precision="fp8"), seqs,
            device, n_prompt=starts).numbers()
    # ---------------------------------------------------------- metrics
    metrics = {}
    if not trace:
        for m in cell["end_to_end"]:
            v = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        ctx = {"cfg": cfg, "sched": sched, "seconds": seconds, "win": win,
               "e2e": e2e, "profile": profile, **layer}
        on_card = torch.device(device).type == "cuda"
        for m in cell["per_layer"]:
            if not on_card and (m["source"] == "device_trace"
                                or "mfu" in m["name"]):
                continue            # no device number from a CPU run
            v = _metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": bool(correct),
           "attempted": e2e["n"] if oneshot else e2e["sent"],
           "failed": unanswered, "metrics": metrics,
           "device": {"platform": "gpu" if torch.device(device).type
                      == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(0)
                      if torch.device(device).type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = profile["busy_s"]
        out["device"]["window_s"] = profile["window_s"]
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
        log("[graftbench] device groups (s): " + json.dumps(
            profile["groups"]))
    if ctrl_numbers is not None:
        out["control"] = ctrl_numbers
    out["checks"] = shown
    return out
