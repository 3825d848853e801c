"""Serving launcher: plan a fleet of hybrid-DL clients for one architecture,
place instances on the pod, and report resource/SLO outcomes.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --clients 20                       # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``--execute`` additionally drives the *real* data path at smoke scale:
the plan is deployed on an executor constructed against a Transport
(in-process loopback, or worker processes behind localhost sockets), a
few requests are served with numerics checked against the monolithic
forward pass, and the measured uplink is reported per hop.

``--serve-loop`` goes further: the full event-driven runtime
(``serving.server.GraftServer``, or a ``GraftFleet`` of ``--frontends``)
runs WALL-CLOCK for ``--serve-seconds`` — trace-driven client threads,
deadline-aware micro-batching per stage pool, pipelined pool drivers,
and the controller replanning on a timer against live transport-measured
uplinks — then reports per-client SLO attainment, p50/p99 latency, and
the replan count.

``--device`` (default ``cuda``) is where the model and the pools run;
without a card the launcher raises unless it is given ``--device cpu``
(the planning report itself needs no device, but never silently moves to
the CPU either).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (GraftPlanner, plan_gslice, place,
                              default_book)
from repro_torch.models import resolve_device
from repro_torch.serving import make_fleet, fleet_fragments, simulate


def run_execute(arch: str, mode: str, n_clients: int, seed: int,
                advertise_host: str = "127.0.0.1", device=None) -> int:
    """Smoke-scale real execution behind the chosen transport."""
    from repro_torch.serving import (GraftExecutor, InProcessTransport,
                                     RemoteExecutor, SocketTransport)
    from repro_torch.serving.smoke import (check_against_monolithic,
                                           smoke_fragments, smoke_requests,
                                           smoke_setup)
    cfg, book, params = smoke_setup(arch, seed=seed, device=device)
    planner = GraftPlanner(book)
    frags = smoke_fragments(cfg, n_clients, seed=seed)
    plan = planner.plan(frags)
    dev = params["embed"].device
    if mode == "socket":
        ex = RemoteExecutor(plan, params, cfg, transport=SocketTransport(),
                            advertise_host=advertise_host, device=dev,
                            log=print)
    else:
        ex = GraftExecutor(plan, params, cfg, transport=InProcessTransport(),
                           device=dev)
    with ex:
        print(f"[execute:{mode}] {len(frags)} clients -> "
              f"{ex.n_stage_pools} stage pools on {dev}, pids "
              f"{sorted(set(ex.worker_pids().values()))}")
        reqs = smoke_requests(cfg, frags, seed=seed)
        ex.serve(reqs)
        check_against_monolithic(cfg, params, reqs)
        for client, nbytes, ms in ex.drain_uplink():
            print(f"[execute:{mode}]   uplink {client}: {nbytes} B "
                  f"in {ms:.2f} ms")
        print(f"[execute:{mode}] numerics match monolithic forward "
              f"for all {len(reqs)} requests")
    return 0


def run_serve_loop_cli(args) -> int:
    """Wall-clock event-driven runtime; per-client SLO report."""
    from repro_torch.serving import run_serve_loop
    mode = args.execute if args.execute != "off" else "inprocess"
    rep = run_serve_loop(
        arch=args.arch, mode=mode, n_clients=min(args.clients, 4),
        seconds=args.serve_seconds, rate=args.serve_rate, seed=args.seed,
        shift_frac=0.5, shaped=args.shaped, frontends=args.frontends,
        router=args.router, shed_budget_frac=args.shed_budget,
        advertise_host=args.advertise_host,
        trace_out=args.trace_out, metrics_dump=args.metrics_dump,
        decode_max_new=args.decode_tokens, log=print, device=args.device)
    print(f"[serve-loop] served {rep['served']} requests in "
          f"{rep['wall_s']:.1f}s wall "
          f"(mean batch {rep['mean_batch']:.2f}, "
          f"{rep['n_stage_pools']} stage pools)")
    print(f"[serve-loop] replans applied: {rep['replans']} "
          f"({rep['timer_replans']} timer-driven, "
          f"{rep['applies_refused']} refused and retried); triggers "
          f"{rep['controller_triggers']}; "
          f"rerouted {rep['rerouted']}, waited {rep['waited']}")
    if rep.get("n_frontends", 1) > 1 or rep.get("shed", 0):
        fes = rep.get("frontends", {})
        print(f"[serve-loop] fleet: {rep.get('n_frontends', 1)} front-ends "
              f"{ {n: s['served'] for n, s in fes.items()} }, "
              f"shed {rep.get('shed', 0)}/{rep.get('offered', 0)}, "
              f"cross-dispatched {rep.get('cross_dispatched', 0)}, "
              f"stolen {rep.get('steals', 0)} "
              f"({rep.get('router', 'hrw')} router), "
              f"{rep.get('n_chips', 0)} chips")
    print("[serve-loop] client     n   attainment   p50 ms   p99 ms"
          "   budget ms")
    for c, s in rep["clients"].items():
        print(f"[serve-loop] {c:8s} {s['n']:3d}   {s['attainment']:9.1%}"
              f" {s['p50_ms']:8.1f} {s['p99_ms']:8.1f}"
              f" {s['budget_ms']:9.1f}")
    print(f"[serve-loop] overall attainment {rep['attainment']:.1%}, "
          f"p50/p99 = {rep['p50_ms']:.1f}/{rep['p99_ms']:.1f} ms")
    if rep.get("audit"):
        n_stamped = sum(1 for e in rep["audit"]
                        if e.get("apply_ms") is not None)
        print(f"[serve-loop] replan audit: {len(rep['audit'])} entries "
              f"({n_stamped} with apply latency); last triggers "
              f"{rep['audit'][-1]['triggers']}")
    if rep["numerics_ok"]:
        print(f"[serve-loop] numerics matched monolithic forward for "
              f"{rep['numerics_checked']} served requests")
    else:
        print(f"[serve-loop] NUMERICS MISMATCH: "
              f"{rep.get('numerics_error', '?')}")
    decode_ok = rep.get("decode_numerics_ok", True)
    if "decode_numerics_ok" in rep:
        print(f"[serve-loop] decode streams equal the unbatched reference "
              f"for {rep['decode_checked']} streams: {decode_ok}")
    return 0 if rep["drained"] and rep["numerics_ok"] and decode_ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--tx2", type=int, default=0)
    ap.add_argument("--rate", type=float, default=30.0)
    ap.add_argument("--t", type=float, default=42.0,
                    help="trace timestamp to plan at")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--execute", choices=("off", "inprocess", "socket"),
                    default="off",
                    help="also run the real smoke-scale data path behind "
                         "this transport")
    ap.add_argument("--serve-loop", action="store_true",
                    help="run the event-driven GraftServer wall-clock "
                         "(with --execute inprocess|socket; default "
                         "inprocess) and report SLO attainment")
    ap.add_argument("--serve-seconds", type=float, default=8.0,
                    help="serve-loop wall-clock duration")
    ap.add_argument("--serve-rate", type=float, default=6.0,
                    help="serve-loop per-client request rate (RPS)")
    ap.add_argument("--shaped", action="store_true",
                    help="serve-loop: shape uplinks with synthetic 5G "
                         "traces")
    ap.add_argument("--frontends", type=int, default=1,
                    help="serve-loop: run N GraftServer front-ends over "
                         "one shared pool fleet (GraftFleet)")
    ap.add_argument("--router", choices=("hrw", "weighted"),
                    default="weighted",
                    help="serve-loop fleet routing: 'weighted' scores "
                         "front-ends from live queue/shed/health/"
                         "affinity signals with work stealing on "
                         "imbalance; 'hrw' pins clients to the static "
                         "rendezvous ring")
    ap.add_argument("--shed-budget", type=float, default=None,
                    help="serve-loop: enable the admission-control shed "
                         "policy with this per-client shed budget "
                         "fraction (e.g. 0.5)")
    ap.add_argument("--advertise-host", default="127.0.0.1",
                    help="socket mode: the address pool workers dial "
                         "back to — set the parent's routable host when "
                         "workers run on other machines")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="serve-loop: enable request tracing and write "
                         "spans here on exit (.json = Chrome trace-event "
                         "/ Perfetto, .jsonl = one span per line)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="serve-loop: enable telemetry and write the "
                         "merged metrics registry + replan audit log "
                         "here as JSON on exit")
    ap.add_argument("--decode-tokens", type=int, default=0,
                    help="serve-loop: make the last client "
                         "autoregressive, generating this many tokens "
                         "per request (0 = all one-shot)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and its pools run: a CUDA "
                         "device (the default; raises without one) or cpu")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)

    if args.serve_loop:
        return run_serve_loop_cli(args)

    book = default_book()
    fleet = make_fleet(args.arch, book, n_nano=args.clients - args.tx2,
                       n_tx2=args.tx2, rate=args.rate, seed=args.seed)
    frags = fleet_fragments(fleet, book, t=args.t)
    if not frags:
        print("all clients run fully on-device at this instant")
        return 0
    print(f"{len(frags)} fragments: "
          f"{sorted((f.p, round(f.t)) for f in frags)}")

    plan = GraftPlanner(book).plan(frags)
    gs = plan_gslice(frags, book)
    print(f"Graft : {plan.total_resource:7.0f} chip-share% "
          f"({plan.n_fragments_merged} frags after merge, "
          f"{plan.schedule_time_s * 1e3:.0f} ms to plan)")
    print(f"GSLICE: {gs.total_resource:7.0f} chip-share%  "
          f"-> saving {100 * (1 - plan.total_resource / gs.total_resource):.0f}%")

    pl = place(plan)
    print(f"placement: {pl.n_chips} chips @ {pl.utilization:.0%} mean util")
    res = simulate(plan, fleet, book, duration_s=args.duration, t0=args.t)
    lat = res.all_latencies()
    if len(lat):
        print(f"e2e latency p50/p95/p99 = {np.percentile(lat, 50):.0f}/"
              f"{np.percentile(lat, 95):.0f}/{np.percentile(lat, 99):.0f} ms; "
              f"SLO violations {res.violation_rate():.1%}; "
              f"drops {sum(res.drops.values())}")
    if args.execute != "off":
        return run_execute(args.arch, args.execute, min(args.clients, 4),
                           args.seed, advertise_host=args.advertise_host,
                           device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
