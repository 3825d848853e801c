#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Graft on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it fails (non-zero exit, no result line) when
there is no card or no ``src/repro_torch`` beside it. Phases, in order:

1. device  — the card's name, count and power limit; builds the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together, with ``-Xptxas -v``).
2. kernels — fails unless every head-dim instantiation of the bf16
   attention kernels (the forward, and the backward's dq and dkv) holds
   ``HGMMA`` (tensor-core) instructions (``cuobjdump -sass``) and every
   bf16 instantiation of the two scans' two kernels each ``HMMA`` or
   ``HGMMA``, none of them spills a register, nor does any decode or
   scan kernel (their count, registers and spills are printed); then
   each kernel wrapper on the card against its plain PyTorch version on
   the same inputs: main-path shapes and edge shapes (prime S, sliding
   window, non-causal, GQA groups 1, 4 and 5, head_dim 128/64/32,
   segments starting mid-tile, segment ids out of order and recurring,
   S = 64k + 1, a window crossed with a ragged last tile, q, k and v as
   slices of one fused QKV buffer; for the decode kernel ragged Sk, a
   ring-buffer kv_pos with -1 holes, windows, hymba's GQA 5 at hd 64
   with its window crossed; for the two recurrent scans T = 1, a prime
   T, a T that is not a multiple of 32, a nonzero input state and decays
   far past the clamp (in one chunk, and over four 64-step chunks with a
   ragged tail), for the WKV scan also T = 64 and 65 and head dims 16 and
   32 over several chunks, outputs and final states; for the
   two backward kernels dq, dk and dv on the same (q, k, v, o, lse, dO):
   the training shape, the JAX backward test's shapes with windows 0 and
   40, GQA groups 1 and 4, a prime S, Sq != Sk non-causal, rows that see
   no kv, hymba's GQA 5 with window 1024 at S = 1100, fused-QKV slices),
   in float32 (scalar bodies) and bfloat16 (tensor-core bodies).
   timing  — the kernel, its plain version and a PyTorch library call
   (where one exists) at the main-path shapes with CUDA events (the
   library's attention backward under the profiler), the forward with
   logsumexp also at hymba's serving shape and a decode admission's,
   beside SDPA, the decode kernel also at hymba's decode shape, both
   scans also at T = 2048, and each call of the decode kernel and the two
   scans split by kernel under the profiler (the device's gap or overlap
   between launches). It checks nothing of the kernels, so it also
   times an older tree's kernels with this script copied beside them.
3. serve   — full-width qwen3-1.7b (all 28 layers, random weights from a
   seeded generator on the card) through ``GraftPlanner.plan`` and
   ``GraftExecutor.serve`` over an ``InProcessTransport``, then
   ``apply_plan`` onto re-aligned depth-2 chains sharing one packed
   pool and a second wave; both in float32, every result held against
   the port's monolithic forward; then waves in bfloat16 for timing, the
   last one under ``torch.profiler`` (device time by kernel group).
4. decode  — full-width qwen3-1.7b (28 layers) greedy decode through the
   paged-KV continuous batch (``decode_plan``, batch 4, decode_ctx 512,
   16-token KV blocks) in float32 with TF32 off: 8 streams of 64-320
   prompt tokens (half share a prompt or a prefix with an earlier one),
   16 new tokens each, one ``decode_abort`` whose freed slot admits a
   stream mid-decode. Every finished stream must equal the port's
   unbatched ``reference_decode`` token for token (the smallest top-1
   minus top-2 logit margin of the reference is printed), the arena must
   report prefix hits, and the decode kernel must have launched. Then the
   same prompts through ``disagg_plan`` (prefill pool -> KV blocks over
   the transport -> decode pool): tokens equal the single-pool run, KV
   handoffs arrive, no stream is resident on the prefill pool. Then a
   timed bfloat16 run and one decode step under ``torch.profiler``.
5. server  — full-width qwen3-1.7b (28 layers) in float32 with TF32
   off through the event-driven server: ``run_serve_loop`` bootstraps a
   ``ServingController`` (``GraftPlanner`` plans) with four clients at
   partition points 3, 9, 17 and 0, and a ``GraftServer`` over an
   ``InProcessTransport`` serves them wall-clock from client threads
   for 8 s after a warm-up: prompts of 128-496 tokens, 4000 ms budgets,
   client 0 moving to p = 4 halfway (a replan applied under traffic),
   the last client sending decode streams of 16 new tokens (decode_ctx
   512, the first and third on one prompt); the controller's window is
   4 s, so a client silent that long departs. It fails unless the server
   drains, a replan is applied under traffic, the control loop raised
   nothing and the controller's plan is the deployed one (a replan that
   would strand a client's requests or remove a pool holding a decode
   stream is refused, reverted and retried), nothing is shed, finished
   locally or decoded locally, every one-shot result (up to 64) matches
   the monolithic forward and every decode stream the unbatched
   reference token for token (the smallest top-1 minus top-2 margin is
   printed), and ``flash_attention``, ``flash_attention_lse`` and
   ``decode_attention`` each launched. Then the same streams through a
   ``GraftServer`` over ``disagg_plan``: KV handoffs arrive and the
   tokens equal the loop's. Then the loop in bfloat16, whose
   ``summarize_records`` figures (latency p50/p99 and attainment, TTFT
   and TPOT p50/p99, mean batch, replans and their apply times) are
   printed beside the card's name and power limit, checked for nothing
   but finite results and the control loop's state.
6. remote  — full-width qwen3-1.7b in float32 with TF32 off on pool
   workers: a ``RemoteExecutor`` over a ``SocketTransport`` puts each
   pool of the planner's plan for clients at p = 3, 9 and 17 in a worker
   process on the card (each worker loads only its block range's
   parameters; every worker's spawn and load time is printed), serves
   two waves, applies ``mixed_depth_plan`` cut at 17 and serves two more:
   every result must match the forward, the pool kept across the replan
   must keep its worker's pid, and ``flash_attention`` must launch in the
   workers (their own counters, read over the stats op) and
   ``flash_attention_lse`` here (the mobile parts). Then the server
   phase's loop through ``run_serve_loop(mode="socket", frontends=2,
   router="weighted")``, held to the server phase's checks, with the
   three kernels launching inside the workers and both front-ends
   serving. Then ``python -m repro_torch.launch.serve`` as subprocesses
   (``--execute socket``; ``--serve-loop --execute socket
   --serve-seconds 2 --clients 2 --frontends 2``), which must exit 0,
   beside the route smoke (at least one steal, nothing shed, numerics
   exact). Then the fleet loop in bfloat16 and ``measure_layer_costs``
   (per-block alpha and beta beside the analytic cost model's), printed
   only.
7. hybrid  — full-width hymba-1.5b (32 layers: attention with window
   1024 beside 50 SSM heads of 64 x 16 state) in float32: the serve
   phase's path on the pad-to-bucket pools (hybrid is not packable), six
   prompts of 128-1536 tokens, one past the window; then the decode
   phase's streams in both plans. Hybrid shares no prefix: the arena
   reports no hit and the decode pool takes no handoff blocks (it
   recomputes each prompt). ``ssm_scan`` must launch on the serve path
   and in the decode admissions.
8. ssm     — full-width rwkv6-7b (32 layers, 64 WKV heads of 64) in
   float32 through the serve phase's path (pad-to-bucket pools, prompts
   of 128-512 tokens); then one prompt's ``prefill`` and 8 teacher-forced
   ``decode_step``s held against the forward at those positions (the
   WKV state the scan kernel hands to decode); then bfloat16 waves, the
   last one profiled. ``wkv6_scan`` must launch.
9. train   — full-width qwen3-1.7b (28 layers, random weights) on the
   ``token_batches`` stream, batch 2 x 512 tokens, float32 with TF32
   off: the loss and every gradient leaf through the kernels against
   autograd of the plain attention (``ops.attention`` swapped here
   only), then ``remat`` True and "dots" against False; 10 AdamW steps
   (remat=True) whose loss must fall, launching the forward kernel 2 x
   28 and dq and dkv 28 times a step, exactly; a checkpoint of the
   trained params restored bit for bit and a resumed step equal to the
   step without the round trip; then in bfloat16 (fp32 moments) the
   loss and gradients through the kernels against the plain attention's
   (worst leaf's relative L2 within ``BF16_GRAD_REL_L2``), and steps
   launching the forward, dq and dkv exactly as the float32 steps do,
   timed, and one profiled.
Each model is freed before the next one loads. The launch counts in the
kernels' record are the sums over the main paths: the serve waves and
the float32 decode runs (single-pool and disaggregated) of each model,
the float32 server loop and its disaggregated streams, the float32
remote executor's waves and fleet loop (launches in the workers and in
this process), and the float32 AdamW steps and timed bfloat16 steps, each path's
counters zeroed just before it and read just after.
The line before the last is ``nvidia-smi``'s name and power limit, the
one before it the kernels' JSON record, and the last line the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

H100_BF16_FLOPS = 989e12      # dense tensor-core peak (NVIDIA data sheet)
H100_HBM_BPS = 3.35e12        # HBM3 bandwidth
# float32: the kernel and the plain version both accumulate in fp32 and
# differ only in summation order (the JAX kernel tests hold 2e-5).
# bfloat16: both round the output to bf16, one ulp near |o| ~ 1 is
# 7.8e-3, so two ulps plus summation order.
TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 1e-2)}
LSE_ATOL = 1e-4               # lse is fp32 in both versions
# fragment results against the monolithic forward, float32: the
# reference's own tolerance (serving/smoke.py::check_against_monolithic)
SERVE_ATOL, SERVE_RTOL = 5e-5, 1e-3
# prefill + teacher-forced decode steps against the full forward, float32:
# tests/test_models.py's multi-step decode bound
STEP_ATOL, STEP_RTOL = 1e-4, 1e-3
# a shared pool's reply carries full-vocab logits for the whole wave:
# 151,936 x 4 B = 0.6 MB per fp32 token, past the transport's 1 GiB
# default frame cap for a wave of ~2k prompt tokens
MAX_FRAME_BYTES = 4 << 30


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def seg_ids(segments, total, device):
    """(1, total) int32: each segment is a length (ids 0, 1, ... in
    order) or an (id, length) pair (any order, an id may recur); the pad
    tail takes its own id, one past the largest."""
    import torch
    ids = []
    for i, sg in enumerate(segments):
        sid, n = sg if isinstance(sg, tuple) else (i, sg)
        ids += [sid] * n
    ids += [max(ids, default=-1) + 1] * (total - len(ids))
    return torch.tensor(ids, dtype=torch.int32, device=device)[None]


def rand(gen, shape, dtype, device):
    import torch
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def err(got, want):
    d = (got.float() - want.float()).abs()
    rel = d / want.float().abs().clamp_min(1e-6)
    return d.max().item(), rel.max().item()


def check_close(name, got, want, atol, rtol):
    import torch
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    e, r = err(got, want)
    print(f"  {name}: max_abs {e:.3e} max_rel {r:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return e


# (label, B, Sq, Sk, H, KV, hd, causal, window, segments or None (see
# seg_ids), fused): with ``fused``, q, k and v are slices of one
# (B, S, H + 2 KV, hd) buffer, as a fused QKV projection leaves them
MAIN_PACKED = ("main packed", 1, 2048, 2048, 16, 8, 128, True, 0,
               [300, 517, 211, 489, 250, 181], False)
MAIN_PROMPT = ("main prompt", 1, 512, 512, 16, 8, 128, True, 0, None, False)
# row 2 beside the main prompt: hymba's serving shape (window 1024) and
# a decode admission's prompt (timed only)
HYMBA_PROMPT = ("hymba prompt", 1, 2048, 2048, 25, 5, 64, True, 1024, None,
                False)
ADMIT_PROMPT = ("decode admission", 1, 128, 128, 16, 8, 128, True, 0, None,
                False)
CASES = [
    MAIN_PACKED,
    MAIN_PROMPT,
    ("prime S, GQA 4", 2, 131, 131, 4, 1, 128, True, 0, None, False),
    ("window, GQA 1, hd 64", 1, 257, 257, 4, 4, 64, True, 64, None, False),
    ("non-causal Sq!=Sk, hd 32", 2, 97, 131, 8, 2, 32, False, 0, None,
     False),
    ("segments mid-tile, hd 64", 2, 200, 200, 8, 2, 64, True, 0,
     [13, 50, 71, 40], False),
    ("segments + window, hd 32", 1, 173, 173, 4, 2, 32, True, 24,
     [5, 90, 61], False),
    ("hymba GQA 5, window crossed, ragged tile", 1, 1100, 1100, 25, 5, 64,
     True, 1024, None, False),
    ("S = 64k + 1, hd 128", 2, 193, 193, 16, 8, 128, True, 0, None, False),
    ("fused QKV slices", 2, 160, 160, 8, 2, 128, True, 0, None, True),
    ("unsorted, recurring segment ids", 1, 300, 300, 8, 2, 64, True, 0,
     [(5, 40), (2, 90), (5, 70), (0, 60), (9, 40)], False),
]


def attention_inputs(gen, dtype, device, B, Sq, Sk, H, KV, hd, fused):
    """q (B, Sq, H, hd), k and v (B, Sk, KV, hd); with ``fused`` (Sq ==
    Sk) strided slices of one (B, S, H + 2 KV, hd) buffer."""
    if fused:
        qkv = rand(gen, (B, Sq, H + 2 * KV, hd), dtype, device)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    return (rand(gen, (B, Sq, H, hd), dtype, device),
            rand(gen, (B, Sk, KV, hd), dtype, device),
            rand(gen, (B, Sk, KV, hd), dtype, device))


def kernel_phase(device) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa

    print("  tolerances: float32 atol 2e-5 rtol 1e-3 (fp32 accumulation in "
          "both, summation order only); bfloat16 atol 2e-2 rtol 1e-2 (both "
          "round o, or dq, dk and dv, to bf16 from fp32 sums: one ulp is "
          "2^-7 relative, 7.8e-3 near 1); lse atol 1e-4 (fp32 in both)")
    worst = {"flash_attention": {}, "flash_attention_lse": {}}
    gen = torch.Generator().manual_seed(0)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        atol, rtol = TOL[dname]
        for (label, B, Sq, Sk, H, KV, hd, causal, window, segs,
             fused) in CASES:
            q, k, v = attention_inputs(gen, dtype, device, B, Sq, Sk, H, KV,
                                       hd, fused)
            seg = None if segs is None else \
                seg_ids(segs, Sq, device).expand(B, Sq).contiguous()
            kw = dict(causal=causal, window=window)
            tag = f"{dname} {label} {(B, Sq, Sk, H, KV, hd)} {kw}"
            got = fa.flash_attention(q, k, v, seg, **kw)
            want = fa.flash_attention_plain(q, k, v, seg, **kw)
            torch.cuda.synchronize()
            e = check_close(f"flash_attention {tag}", got, want, atol, rtol)
            worst["flash_attention"][(dname, label)] = e
            if seg is None:
                o, lse = fa.flash_attention_lse(q, k, v, **kw)
                o2, lse2 = fa.flash_attention_lse_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                e = check_close(f"flash_attention_lse o {tag}", o, o2,
                                atol, rtol)
                check_close(f"flash_attention_lse lse {tag}", lse, lse2,
                            LSE_ATOL, 0.0)
                worst["flash_attention_lse"][(dname, label)] = e
    worst["decode_attention"] = decode_kernel_cases(device, gen)
    worst.update(scan_kernel_cases(device, gen))
    worst.update(bwd_kernel_cases(device, gen))
    return worst


def decode_inputs(gen, dtype, device, B, Sk, H, KV, hd, q_pos, ring):
    """q, k, v, q_pos and kv_pos for one decode case: a plain cache holds
    positions 0..q_pos in slots 0..q_pos (-1 past them); a ring holds
    the last Sk positions up to q_pos at slot pos % Sk, -1 where the
    ring has not wrapped yet."""
    import numpy as np
    import torch
    q = rand(gen, (B, 1, H, hd), dtype, device)
    k = rand(gen, (B, Sk, KV, hd), dtype, device)
    v = rand(gen, (B, Sk, KV, hd), dtype, device)
    kv_pos = np.full((B, Sk), -1, np.int32)
    for b, qp in enumerate(q_pos):
        lo = max(0, qp - Sk + 1) if ring else 0
        for p in range(lo, min(qp + 1, lo + Sk)):
            kv_pos[b, p % Sk if ring else p] = p
    return (q, k, v, torch.tensor(q_pos, dtype=torch.int32, device=device),
            torch.from_numpy(kv_pos).to(device))


# (label, B, Sk, H, KV, hd, q_pos, ring, window): the shapes of
# tests/test_kernels.py::test_decode_attention x window {0, 100}, then
# a ragged Sk, a ring buffer, hymba's GQA 5 at hd 64 with its window
# crossed and the main-path shape
DECODE_MAIN = ("main path", 4, 512, 16, 8, 128, [511, 511, 511, 511],
               False, 0)
DECODE_CASES = [
    (f"kernel-test shape{', window 100' if w else ''}", B, Sk, H, KV, hd,
     [60 + 37 * b for b in range(B)], False, w)
    for B, Sk, H, KV, hd in ((2, 256, 4, 2, 32), (3, 128, 8, 8, 64),
                             (1, 512, 16, 2, 64))
    for w in (0, 100)] + [
    ("ragged Sk 131", 3, 131, 16, 8, 128, [130, 64, 0], False, 0),
    ("ring with -1 holes", 3, 96, 16, 8, 128, [300, 95, 40], True, 0),
    ("ring, window 40", 3, 96, 16, 8, 128, [300, 95, 40], True, 40),
    ("main path, mixed positions", 4, 512, 16, 8, 128, [511, 300, 64, 5],
     False, 0),
    ("hymba GQA 5, hd 64, window 1024 crossed, ragged Sk", 3, 1100, 25, 5,
     64, [1099, 700, 30], False, 1024),
    DECODE_MAIN,
]


def decode_kernel_cases(device, gen) -> dict:
    import torch
    from repro_torch.kernels import decode_attention as da
    worst = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        atol, rtol = TOL[dname]
        for label, B, Sk, H, KV, hd, q_pos, ring, window in DECODE_CASES:
            args = decode_inputs(gen, dtype, device, B, Sk, H, KV, hd,
                                 q_pos, ring)
            got = da.decode_attention(*args, window=window)
            want = da.decode_attention_plain(*args, window=window)
            torch.cuda.synchronize()
            e = check_close(f"decode_attention {dname} {label} "
                            f"{(B, Sk, H, KV, hd)} window {window}", got,
                            want, atol, rtol)
            worst[(dname, label)] = e
    return worst


# (label, B, Sq, Sk, H, KV, hd, causal, window, fused): the training main
# path, tests/test_kernels.py::test_flash_attention_backward's shapes with
# windows 0 and 40 (hd 16 raised to 32, the kernels' least head dim), GQA
# groups 4 and 1, a prime S, Sq != Sk non-causal, rows that see no kv
# (non-causal, window 2, Sq > Sk: their lse is NEG_INF), hymba's GQA 5
# with a window crossed and a ragged last tile, and q, k and v as slices
# of one fused QKV buffer
BWD_MAIN = ("main path", 2, 512, 512, 16, 8, 128, True, 0, False)
BWD_CASES = [BWD_MAIN] + [
    (f"kernel-test shape, window {w}", B, S, S, H, KV, hd, True, w, False)
    for B, S, H, KV, hd in ((1, 64, 2, 1, 32), (2, 96, 4, 2, 32),
                            (1, 128, 8, 8, 32))
    for w in (0, 40)] + [
    ("prime S, GQA 4", 2, 131, 131, 4, 1, 128, True, 0, False),
    ("window, GQA 1, hd 64", 1, 257, 257, 4, 4, 64, True, 64, False),
    ("non-causal Sq!=Sk, hd 32", 2, 97, 131, 8, 2, 32, False, 0, False),
    ("rows with no valid kv", 1, 100, 40, 4, 2, 64, False, 2, False),
    ("hymba GQA 5, window crossed, ragged tile", 1, 1100, 1100, 25, 5, 64,
     True, 1024, False),
    ("fused QKV slices", 2, 160, 160, 8, 2, 128, True, 0, True),
]


def bwd_inputs(gen, dtype, device, B, Sq, Sk, H, KV, hd, causal, window,
               fused):
    """q, k, v, o, lse, dO for one backward case: o and lse from the
    plain forward, so the kernels and the plain backward see the same
    six tensors."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = attention_inputs(gen, dtype, device, B, Sq, Sk, H, KV, hd,
                               fused)
    do = rand(gen, (B, Sq, H, hd), dtype, device)
    o, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal,
                                          window=window)
    return q, k, v, o, lse, do


def bwd_kernel_cases(device, gen) -> dict:
    """Kernels 4 and 5 (dq; dk and dv) against the plain FA-2 backward
    on the same (q, k, v, o, lse, dO): float32 on the scalar bodies,
    bfloat16 on the wgmma bodies. Every gradient must be finite (rows
    that see no kv give zeros)."""
    import torch
    from repro_torch.kernels import flash_attention_bwd as fab
    worst = {"flash_attention_bwd_dq": {}, "flash_attention_bwd_dkv": {}}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        atol, rtol = TOL[dname]
        for (label, B, Sq, Sk, H, KV, hd, causal, window,
             fused) in BWD_CASES:
            args = bwd_inputs(gen, dtype, device, B, Sq, Sk, H, KV, hd,
                              causal, window, fused)
            kw = dict(causal=causal, window=window)
            got = fab.flash_attention_bwd(*args, **kw)
            want = fab.flash_attention_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            tag = f"{dname} {label} {(B, Sq, Sk, H, KV, hd)} {kw}"
            e = [check_close(f"flash_attention_bwd {n} {tag}", g, w, atol,
                             rtol) for n, g, w in zip(("dq", "dk", "dv"),
                                                      got, want)]
            if not all(bool(torch.isfinite(g).all()) for g in got):
                fail(f"flash_attention_bwd {tag}: a gradient is not finite")
            if not all(g.dtype == dtype for g in got):
                fail(f"flash_attention_bwd {tag}: gradient dtypes "
                     f"{[g.dtype for g in got]}")
            worst["flash_attention_bwd_dq"][(dname, label)] = e[0]
            worst["flash_attention_bwd_dkv"][(dname, label)] = max(e[1:])
    return worst


def ssm_inputs(gen, dtype, device, B, T, H, hd, N, dt_scale):
    """x, Bm, Cm in ``dtype``; dt (softplus, scaled), A (< 0) and a
    nonzero state in float32, as the hymba block hands them over."""
    import torch
    x = rand(gen, (B, T, H, hd), torch.float32, device) * 0.5
    dt = torch.nn.functional.softplus(
        rand(gen, (B, T, H), torch.float32, device)) * dt_scale
    A = -rand(gen, (H,), torch.float32, device).abs() * 4
    Bm = rand(gen, (B, T, N), torch.float32, device) * 0.5
    Cm = rand(gen, (B, T, N), torch.float32, device) * 0.5
    h0 = rand(gen, (B, H, hd, N), torch.float32, device) * 0.1
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), h0


def wkv_inputs(gen, dtype, device, B, T, H, hd, w):
    """r, k, v in ``dtype``; the decay w (random in (0.1, 0.95), or the
    constant given), u and a nonzero state in float32, as the rwkv6
    time-mix hands them over."""
    import torch
    r, k, v = (rand(gen, (B, T, H, hd), torch.float32, device) * 0.5
               for _ in range(3))
    if w is None:
        w = torch.sigmoid(rand(gen, (B, T, H, hd), torch.float32,
                               device)) * 0.85 + 0.1
    else:
        w = torch.full((B, T, H, hd), float(w), device=device)
    u = rand(gen, (H, hd), torch.float32, device) * 0.1
    s0 = rand(gen, (B, H, hd, hd), torch.float32, device) * 0.1
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


# (label, B, T, H, hd, N, dt scale): the hymba main path, the shapes of
# tests/test_kernels.py::test_ssm_scan, T = 1, a prime T, a T that is
# not a multiple of 32, and dt * A far below the -2.5 clamp, in one chunk
# and across several 64-step chunks with a ragged tail (where a divided
# cumulative decay would be 0 / 0), then the widest state the kernel
# takes, a head dim it pads, and B and C too narrow for 16-byte reads;
# every case starts from a nonzero state
SSM_MAIN = ("main path", 1, 512, 50, 64, 16, 0.2)
SSM_CASES = [
    SSM_MAIN,
    ("kernel-test shape", 1, 32, 1, 16, 8, 0.2),
    ("kernel-test shape", 2, 128, 3, 32, 16, 0.2),
    ("kernel-test shape", 2, 96, 2, 64, 16, 0.2),
    ("T = 1", 1, 1, 50, 64, 16, 0.2),
    ("prime T", 2, 37, 4, 64, 16, 0.2),
    ("T = 100", 1, 100, 8, 64, 16, 0.2),
    ("extreme decay", 1, 64, 2, 16, 8, 50.0),
    ("extreme decay, 4 chunks, ragged tail", 1, 200, 4, 64, 16, 50.0),
    ("widest state, 128 x 32", 1, 130, 2, 128, 32, 0.2),
    ("hd 24, padded to 32", 2, 70, 3, 24, 16, 0.2),
    ("hd 8, N 4", 1, 50, 2, 8, 4, 0.2),
]
# (label, B, T, H, hd, w): the rwkv6 main path, the shapes of
# tests/test_kernels.py::test_wkv6, the same ragged lengths, and
# tests/test_kernels.py::test_wkv6_extreme_decay's w = 1e-6, in one chunk
# and over four 64-step chunks with a ragged tail (where a divided
# cumulative decay would overflow); one whole chunk and one step past it;
# head dims 16 and 32 over several chunks; every case starts from a
# nonzero state
WKV_MAIN = ("main path", 1, 512, 64, 64, None)
WKV_CASES = [
    WKV_MAIN,
    ("kernel-test shape", 1, 32, 1, 16, None),
    ("kernel-test shape", 2, 128, 3, 32, None),
    ("kernel-test shape", 2, 96, 2, 64, None),
    ("T = 1", 1, 1, 64, 64, None),
    ("prime T", 2, 37, 4, 64, None),
    ("T = 100", 1, 100, 8, 64, None),
    ("extreme decay", 1, 64, 2, 16, 1e-6),
    ("extreme decay, 4 chunks, ragged tail", 1, 200, 4, 64, 1e-6),
    ("T = 64", 1, 64, 8, 64, None),
    ("T = 65", 2, 65, 4, 64, None),
    ("hd 16, 3 chunks", 2, 150, 4, 16, None),
    ("hd 32, 4 chunks", 1, 250, 4, 32, None),
]


def scan_kernel_cases(device, gen) -> dict:
    """Kernels 6 and 7 against their plain versions (the chunked matmul
    form with the JAX chunk rule): the output and the final state."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import wkv6_scan as wk
    worst = {"ssm_scan": {}, "wkv6_scan": {}}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        atol, rtol = TOL[dname]
        for label, B, T, H, hd, N, dts in SSM_CASES:
            args = ssm_inputs(gen, dtype, device, B, T, H, hd, N, dts)
            y, h = ss.ssm_scan(*args)
            y2, h2 = ss.ssm_scan_plain(*args)
            torch.cuda.synchronize()
            tag = f"{dname} {label} {(B, T, H, hd, N)} dt x{dts:g}"
            worst["ssm_scan"][(dname, label, T)] = max(
                check_close(f"ssm_scan y {tag}", y, y2, atol, rtol),
                check_close(f"ssm_scan state {tag}", h, h2, atol, rtol))
        for label, B, T, H, hd, w in WKV_CASES:
            args = wkv_inputs(gen, dtype, device, B, T, H, hd, w)
            o, st = wk.wkv6_scan(*args)
            o2, st2 = wk.wkv6_scan_plain(*args)
            torch.cuda.synchronize()
            tag = f"{dname} {label} {(B, T, H, hd)} w {w or 'random'}"
            worst["wkv6_scan"][(dname, label, T)] = max(
                check_close(f"wkv6_scan o {tag}", o, o2, atol, rtol),
                check_close(f"wkv6_scan state {tag}", st, st2, atol, rtol))
    return worst


# ~50 ms of device spin at the H100's ~2 GHz SM clock: the timed
# launches queue up behind it
SLEEP_CYCLES = 100_000_000


def time_ms(fn, iters: int = 20) -> tuple:
    """(device ms, host ms) per call of ``fn``, after 3 warm-up calls.

    The timed calls are enqueued behind a device sleep, so the CUDA
    events bracket back-to-back device work alone even where enqueueing
    a call (Python, argument checks, the launch) costs the host more
    than the call costs the device; the host ms is that enqueueing cost.
    Fails if enqueueing outlasted the sleep (the events would then
    include idle gaps)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    c = torch.cuda.Event(enable_timing=True)
    c.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    if host >= c.elapsed_time(a):
        fail(f"timing: enqueueing {iters} calls took {host:.1f} ms, longer "
             f"than the {c.elapsed_time(a):.1f} ms device sleep")
    return a.elapsed_time(b) / iters, host / iters


def profiled_device_ms(fn, names=None) -> float:
    """Device ms of one call of ``fn`` (after 3 warm-up calls): the sum of
    its kernels' device times under ``torch.profiler``. For a plain
    version of many small ops, whose queued launches would fill the
    launch queue behind ``time_ms``'s device sleep and stall the host,
    and for a library call whose kernels are only part of a larger call.
    ``names``, a list, receives the kernels' names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(float(getattr(ev, "self_device_time_total", 0.0)) for ev in evs)
    if names is not None:
        names.extend(ev.key for ev in evs)
    if us <= 0:
        fail("profiled_device_ms: the profiler saw no device time")
    return us / 1e3


def rotating(fn, copies):
    """A callable that runs ``fn`` on the next of ``copies`` each call:
    with more bytes across the copies than the 50 MB L2 holds, every
    launch finds its inputs cold, as a decode step finds each layer's
    cache."""
    it = [0]

    def run():
        fn(*copies[it[0] % len(copies)])
        it[0] += 1
    return run


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    t_b = nbytes / H100_HBM_BPS * 1e3
    t_f = flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def timing_phase(device) -> dict:
    """Kernel, plain version and library call at the main-path shapes
    (bfloat16, the serving dtype), as device time per call (``time_ms``).
    For the prefill kernels the L2 cache is warm, as for a kernel fed by
    the projection just before it. Row 2 is also timed, beside SDPA
    alone, at hymba's serving shape and a decode admission's."""
    import torch
    out = {}
    gen = torch.Generator().manual_seed(1)
    for case, name, record in ((MAIN_PACKED, "flash_attention", True),
                               (MAIN_PROMPT, "flash_attention_lse", True),
                               (HYMBA_PROMPT, "flash_attention_lse", False),
                               (ADMIT_PROMPT, "flash_attention_lse", False)):
        r = time_forward(device, gen, case, name, with_plain=record)
        out[name if record else f"{name} {case[0]}"] = r
    out["decode_attention"] = time_decode(device, gen)
    out.update(time_scans(device, gen))
    out.update(time_bwd(device, gen))
    return out


def time_forward(device, gen, case, name, *, with_plain) -> dict:
    """Row 1 (segmented) or row 2 (o and lse) at one self-attention
    shape. Bound: q, k, v and o in bf16 (and seg ids or lse) once, and
    4 hd FLOPs per valid (head, q, k) pair. Library: one SDPA call on
    the same inputs (o only), ``is_causal`` where the mask is causal
    alone, else the boolean mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import _mask, _positions

    label, B, S, _, H, KV, hd, causal, window, segs, _ = case
    q, k, v = attention_inputs(gen, torch.bfloat16, device, B, S, S, H, KV,
                               hd, False)
    pos = _positions(S, B, device)
    mask = _mask(pos, pos, causal=causal, window=window)
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * 2
    if segs is not None:
        seg = seg_ids(segs, S, device)
        mask = mask & (seg[:, :, None] == seg[:, None, :])
        nbytes += B * S * 4
        run = lambda: fa.flash_attention(q, k, v, seg, window=window)  # noqa
        plain = lambda: fa.flash_attention_plain(                      # noqa
            q, k, v, seg, window=window)
    else:
        nbytes += B * H * S * 4                                 # lse
        run = lambda: fa.flash_attention_lse(q, k, v, window=window)  # noqa
        plain = lambda: fa.flash_attention_lse_plain(                 # noqa
            q, k, v, window=window)
    # QK^T and PV: 2 * hd multiply-adds per valid (q, k) pair and head
    pairs = int(mask.sum().item())
    flops = 4.0 * hd * H * pairs
    bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_kw = dict(is_causal=True) if segs is None and window == 0 else \
        dict(attn_mask=mask[:, None])
    library = lambda: F.scaled_dot_product_attention(           # noqa
        qt, kt, vt, enable_gqa=True, **lib_kw)
    ms, host_ms = time_ms(run)
    r = {"ms": ms, "host_ms": host_ms,
         "plain_ms": time_ms(plain)[0] if with_plain else None,
         "library_ms": time_ms(library)[0], "bound_ms": bms,
         "bound_by": by, "bytes": nbytes, "flops": flops,
         "valid_pairs": pairs, "shape": (B, S, H, KV, hd), "window": window}
    plain_txt = f"plain {r['plain_ms']:.4f} ms, " if with_plain else ""
    lib_txt = "is_causal" if "is_causal" in lib_kw else "boolean mask"
    print(f"  {name} bf16 {label} {r['shape']} window {window}: kernel "
          f"{ms:.4f} ms (host {host_ms:.4f} ms per call), {plain_txt}"
          f"library (SDPA, {lib_txt}) {r['library_ms']:.4f} ms, "
          f"{ms / r['library_ms']:.2f}x SDPA; "
          f"bound {bms:.4f} ms ({by}: {nbytes} B, {flops:.3e} FLOP over "
          f"{pairs} valid pairs), {100 * bms / ms:.1f}% of it; device times")
    return r


def kernel_split(fn, calls: int = 20) -> dict:
    """Where one call of ``fn`` spends its device time: each kernel's mean
    device ms by name, and the span from the call's first kernel start to
    its last kernel end, under ``torch.profiler`` over ``calls`` calls
    (after 3 warm-ups). Each call is queued behind a device sleep, so its
    kernels are all enqueued before the first one starts (the profiler
    slows enqueueing), and ended by a synchronize, so no call overlaps
    another. Span minus the kernels' sum is the device's idle gap between
    a call's launches; a negative gap is overlap (a kernel launched with
    programmatic dependent launch starts before the one it follows
    ends)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            torch.cuda._sleep(SLEEP_CYCLES // 10)
            fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    # one group of kernels per call, each after its sleep (PyTorch's
    # spin_kernel, ~5 ms, longer than any kernel split here); a call whose
    # group the profiler recorded incompletely is left out
    groups: list = []
    for e in evs:
        if "spin_kernel" in e.name or \
                e.time_range.end - e.time_range.start > 2500:
            groups.append([])
        elif groups:
            groups[-1].append(e)
    k = max((len(g) for g in groups), default=0)
    groups = [g for g in groups if len(g) == k]
    if k == 0 or len(groups) < calls // 2:
        fail(f"kernel_split: {len(evs)} device events over {calls} calls, "
             f"{len(groups)} complete")
    calls = len(groups)
    by_name: dict = {}
    span = 0.0
    for call in groups:
        span += call[-1].time_range.end - call[0].time_range.start
        for e in call:
            name = re.sub(r"^void |\(anonymous namespace\)::", "",
                          e.name).split("<")[0].split("(")[0]
            by_name[name] = by_name.get(name, 0.0) + \
                (e.time_range.end - e.time_range.start)
    kernels = {n: us / calls / 1e3 for n, us in by_name.items()}
    span_ms = span / calls / 1e3
    return {"kernels": kernels, "span_ms": span_ms,
            "gap_ms": span_ms - sum(kernels.values()),
            "launches_per_call": k, "calls": calls}


def split_text(split) -> str:
    parts = ", ".join(f"{n} {ms:.4f} ms" for n, ms in split["kernels"].items())
    gap = split["gap_ms"]
    return (f"{split['launches_per_call']} launch(es) per call: {parts}; "
            f"span {split['span_ms']:.4f} ms, "
            f"{'idle gap' if gap >= 0 else 'overlap'} {abs(gap):.4f} ms "
            f"(profiled, mean of {split['calls']} calls)")


# (label, B, Sk, H, KV, hd, q_pos, window): row 3's timed shapes, every
# slot valid: qwen3's decode step (the record's row) and hymba's
DECODE_TIMED = [("qwen3 decode", 4, 512, 16, 8, 128, [511] * 4, 0),
                ("hymba decode", 4, 512, 25, 5, 64, [511] * 4, 1024)]


def time_decode(device, gen) -> dict:
    """Row 3 at each ``DECODE_TIMED`` shape (bf16), L2 cold: 8 copies of
    the inputs (67 MB of k/v at qwen3's shape) in turn, as a decode step
    finds each layer's cache. Library yardstick: SDPA with a (B, H, 1,
    Sk) boolean mask built from kv_pos/q_pos. Also splits one call's
    device time by kernel (``kernel_split``). Returns the qwen3 row;
    the others are printed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import _mask

    out = {}
    for label, B, Sk, H, KV, hd, q_pos, window in DECODE_TIMED:
        copies = [decode_inputs(gen, torch.bfloat16, device, B, Sk, H, KV,
                                hd, q_pos, False) for _ in range(8)]
        q, k, v, qp, kp = copies[0]
        mask = _mask(qp[:, None], kp, causal=True, window=window)
        pairs = int(mask.sum().item()) * H
        # q, k, v, o in bf16, q_pos and kv_pos int32, each once
        nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + qp.numel() * 4 \
            + kp.numel() * 4
        flops = 4.0 * hd * pairs              # QK^T and PV per valid pair
        bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
        lib = [(c[0].transpose(1, 2), c[1].transpose(1, 2),
                c[2].transpose(1, 2),
                _mask(c[3][:, None], c[4], causal=True,
                      window=window)[:, None].expand(B, H, 1, Sk))
               for c in copies]
        run = rotating(lambda *a: da.decode_attention(*a, window=window),
                       copies)
        ms, host_ms = time_ms(run)
        r = {"ms": ms, "host_ms": host_ms,
             "plain_ms": time_ms(rotating(
                 lambda *a: da.decode_attention_plain(*a, window=window),
                 copies))[0],
             "library_ms": time_ms(rotating(
                 lambda qt, kt, vt, m: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=m, enable_gqa=True), lib))[0],
             "bound_ms": bms, "bound_by": by, "bytes": nbytes,
             "flops": flops, "valid_pairs": pairs,
             "shape": (B, Sk, H, KV, hd), "split": kernel_split(run)}
        print(f"  decode_attention bf16 {label} {r['shape']} window "
              f"{window}: kernel {ms:.4f} ms (host {host_ms:.4f} ms per "
              f"call), plain {r['plain_ms']:.4f} ms, library (SDPA, boolean "
              f"mask) {r['library_ms']:.4f} ms, {ms / r['library_ms']:.2f}x "
              f"SDPA; bound {bms:.4f} ms ({by}: {nbytes} B, {flops:.3e} FLOP "
              f"over {pairs} valid (head, slot) pairs), {100 * bms / ms:.1f}%"
              " of it; L2 cold: 8 input copies in turn; device times")
        print(f"    {split_text(r['split'])}")
        out[label] = r
    return out["qwen3 decode"]


# T of the scans' timed calls: the main paths (the record's rows) and
# the longest of hymba's serving buckets
SCAN_TIMED_T = (512, 2048)


def time_scans(device, gen) -> dict:
    """Rows 6 and 7 at their main-path shapes (bf16, as served), both
    also at T = 2048, L2 warm as for kernels fed by the projections just
    before them. Bound: the bytes (each input once, the output and the
    final state once) against the FLOPs of the chunked matmul form the
    TPU kernels run (chunk 32), at the bf16 tensor-core peak. The plain
    versions' device time is their kernels' sum under the profiler
    (``profiled_device_ms``). No single PyTorch call computes either
    scan, so there is no library time."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import wkv6_scan as wk
    from repro_torch.kernels.ref import pick_block

    out = {}
    _, B, _, H, hd, N, dts = SSM_MAIN
    for T in SCAN_TIMED_T:
        args = ssm_inputs(gen, torch.bfloat16, device, B, T, H, hd, N, dts)
        C = pick_block(T, 32)
        n_chunk = -(-T // C)
        # x and y bf16, dt fp32, A fp32, Bm and Cm bf16, state in and out
        # fp32
        nbytes = 2 * (2 * B * T * H * hd) + 4 * B * T * H + 4 * H \
            + 2 * (2 * B * T * N) + 2 * (4 * B * H * hd * N)
        # per (row, head, chunk): C h0, C B^T, scores x, and the update
        flops = 2.0 * B * H * n_chunk * C * (2 * N * hd + C * (N + hd))
        name = "ssm_scan" if T == SSM_MAIN[2] else f"ssm_scan T={T}"
        out[name] = dict(shape=(B, T, H, hd, N), bytes=nbytes, flops=flops,
                         run=lambda a=args: ss.ssm_scan(*a),
                         plain=lambda a=args: ss.ssm_scan_plain(*a))
    _, B, _, H, hd, w = WKV_MAIN
    for T in SCAN_TIMED_T:
        wargs = wkv_inputs(gen, torch.bfloat16, device, B, T, H, hd, w)
        C = pick_block(T, 32)
        n_chunk = -(-T // C)
        # r, k, v and o bf16, w fp32, u fp32, state in and out fp32
        nbytes = 4 * (2 * B * T * H * hd) + 4 * B * T * H * hd \
            + 4 * H * hd + 2 * (4 * B * H * hd * hd)
        # per (row, head, chunk): r S, r k^T, scores v, and the state update
        flops = 4.0 * B * H * n_chunk * C * hd * (hd + C)
        name = "wkv6_scan" if T == WKV_MAIN[2] else f"wkv6_scan T={T}"
        out[name] = dict(shape=(B, T, H, hd), bytes=nbytes, flops=flops,
                         run=lambda a=wargs: wk.wkv6_scan(*a),
                         plain=lambda a=wargs: wk.wkv6_scan_plain(*a))
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"],
                                             H100_BF16_FLOPS)
        run = r.pop("run")
        r["ms"], r["host_ms"] = time_ms(run)
        r["plain_ms"] = profiled_device_ms(r.pop("plain"))
        r["library_ms"] = None
        r["split"] = kernel_split(run)
        print(f"  {name} bf16 {r['shape']}: kernel {r['ms']:.4f} ms (host "
              f"{r['host_ms']:.4f} ms per call), plain {r['plain_ms']:.4f} "
              f"ms (profiled), library none, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} B, {r['flops']:.3e} FLOP of "
              f"the chunked form), {100 * r['bound_ms'] / r['ms']:.1f}% of "
              "it; device times")
        print(f"    {split_text(r['split'])}")
    return out


def time_bwd(device, gen) -> dict:
    """Rows 4 and 5 at the training main path (B=2, S=512, H=16, KV=8,
    hd=128, causal, bf16), L2 warm as in a backward pass that just made
    dO. Each kernel is timed alone (dkv given the D that one dq launch
    wrote). Bound: the bytes of each kernel's function (dq: q, k, v, o,
    dO, lse in, dq and D out; dkv: q, k, v, dO, lse, D in, dk and dv out)
    against 6 (dq) or 8 (dkv) FLOPs per valid (head, q, k) pair and head
    dimension. Plain: the plain backward, which computes dq, dk and dv
    together, so one time stands in both rows. Library: the backward of
    one ``F.scaled_dot_product_attention(is_causal=True)`` call, the
    device time of its kernels under the profiler, also in both rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.ref import _mask, _positions

    _, B, S, _, H, KV, hd, causal, window, _ = BWD_MAIN
    dt = torch.bfloat16
    q = rand(gen, (B, S, H, hd), dt, device)
    k = rand(gen, (B, S, KV, hd), dt, device)
    v = rand(gen, (B, S, KV, hd), dt, device)
    do = rand(gen, (B, S, H, hd), dt, device)
    o, lse = fa.flash_attention_lse(q, k, v)
    _, dvec = fab.launch_dq(q, k, v, o, lse, do)
    pos = _positions(S, B, device)
    pairs = int(_mask(pos, pos, causal=causal, window=window).sum()) * H
    big, kvb, rows = B * S * H * hd * 2, B * S * KV * hd * 2, B * H * S * 4
    plain_ms = time_ms(lambda: fab.flash_attention_bwd_plain(
        q, k, v, o, lse, do))[0]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    lib_names = []
    library_ms = profiled_device_ms(
        lambda: torch.autograd.grad(ot, (qt, kt, vt), do.transpose(1, 2),
                                    retain_graph=True), names=lib_names)
    out = {
        "flash_attention_bwd_dq": dict(
            run=lambda: fab.launch_dq(q, k, v, o, lse, do),
            bytes=4 * big + 2 * kvb + 2 * rows, flops=6.0 * pairs * hd),
        "flash_attention_bwd_dkv": dict(
            run=lambda: fab.launch_dkv(q, k, v, lse, do, dvec),
            bytes=2 * big + 4 * kvb + 2 * rows, flops=8.0 * pairs * hd),
    }
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"],
                                             H100_BF16_FLOPS)
        r["ms"], r["host_ms"] = time_ms(r.pop("run"))
        r.update(plain_ms=plain_ms, library_ms=library_ms,
                 valid_pairs=pairs, shape=(B, S, H, KV, hd))
        print(f"  {name} bf16 {r['shape']}: kernel {r['ms']:.4f} ms (host "
              f"{r['host_ms']:.4f} ms per call), plain {plain_ms:.4f} ms "
              f"(dq, dk and dv together), library (SDPA backward, "
              f"profiled) {library_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} B, {r['flops']:.3e} FLOP over "
              f"{pairs} valid (head, q, k) pairs; {r['bound_ms'] / r['ms']:.1%}"
              f" of it); device times")
    pair = sum(r["ms"] for r in out.values())
    print(f"  dq + dkv {pair:.4f} ms, {pair / library_ms:.2f}x SDPA's whole "
          f"backward; SDPA backward kernels: {sorted(set(lib_names))}")
    return out


# ---------------------------------------------------------------------------
# phase 3: serving the main path
# ---------------------------------------------------------------------------

def make_wave(cfg, frags, rng, *, lo=128, hi=512, n_long=0, exact=False):
    """One request per fragment with lo..hi prompt tokens; the first
    ``n_long`` prompts are longer than 1024 tokens (up to ``hi``). With
    ``exact``, the prompts instead take the distinct lengths of
    ``EXACT_LENGTHS`` in a random order: every pool then runs each
    request alone at its own length, the monolithic forward's shapes."""
    import numpy as np
    from repro_torch.serving import ServeRequest
    order = rng.permutation(EXACT_LENGTHS) if exact else None
    reqs = []
    for i, f in enumerate(frags):
        if exact:
            n = int(order[i])
        elif i < n_long:
            n = int(rng.randint(1025, hi + 1))
        else:
            n = int(rng.randint(lo, hi + 1))
        reqs.append((ServeRequest(client=f.client,
                                  tokens=rng.randint(0, cfg.vocab_size, n)
                                  .astype(np.int32)), f.p))
    return reqs


def serve_wave(ex, reqs, label) -> float:
    import torch
    t0 = time.perf_counter()
    ex.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r, _ in reqs)
    for req, _ in reqs:
        if req.result is None:
            fail(f"{label}: {req.client} got no result")
    print(f"  {label}: {len(reqs)} requests, {toks} prompt tokens, "
          f"{ex.n_stage_pools} pools, wall {wall:.3f} s")
    return wall


# Six distinct powers of two (seq_bucket pads none of them, and no two
# stack into one batch): the float32 waves of the recurrent families. On
# the card a float32 cuBLAS product's rounding depends on its row count,
# and random full-width hymba and rwkv6 amplify that with depth past the
# serving tolerance (``rounding_sweep`` prints by how much); at the
# forward's own shapes the served result must equal it.
EXACT_LENGTHS = (64, 128, 256, 512, 1024, 2048)


# substrings of cuBLAS/CUTLASS matmul kernel names
MATMUL_NAMES = ("gemm", "xmma", "cutlass", "cublas", "nvjet")


# substrings of the port's attention and scan kernels (csrc/*.cu)
ATTENTION_NAMES = ("attn_fwd_", "attn_bwd_", "decode_attn_kernel")
SCAN_NAMES = ("ssm_chunk_", "wkv6_chunk_")


def launch_counters() -> list:
    """Every kernel wrapper module's ``LAUNCHES`` dict."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import wkv6_scan as wk
    return [fa, fab, da, ss, wk]


def reset_launches() -> None:
    for m in launch_counters():
        m.reset_launches()


def read_launches() -> dict:
    return {k: v for m in launch_counters() for k, v in m.LAUNCHES.items()}


def free_device() -> None:
    """Return the freed models' memory before the next one loads."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def profile_run(label, run) -> float:
    """Call ``run`` (which returns its wall seconds, ended by a
    synchronize) under ``torch.profiler`` and print where the device
    time went: kernel time by group, the device's busy share of the wall
    time (profiling slows the host, so the share reads low), the top
    kernels and each attention kernel. Returns the device time in µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    groups = {"attention kernels": 0.0, "scan kernels": 0.0, "matmul": 0.0,
              "memcpy/memset": 0.0, "other kernels": 0.0}
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        name = ev.key
        low = name.lower()
        if any(t in name for t in ATTENTION_NAMES):
            g = "attention kernels"
        elif any(t in name for t in SCAN_NAMES):
            g = "scan kernels"
        elif any(t in low for t in MATMUL_NAMES):
            g = "matmul"
        elif low.startswith(("memcpy", "memset")):
            g = "memcpy/memset"
        else:
            g = "other kernels"
        groups[g] += us
        rows.append((us, name, g))
    total = sum(groups.values())
    if total == 0:
        print(f"  {label}: the profiler saw no device time")
        return 0.0
    print(f"  {label}: device busy {total / 1e3:.1f} ms of {wall * 1e3:.1f} "
          f"ms wall ({100 * total / 1e6 / wall:.1f}%)")
    for g, us in groups.items():
        print(f"    {g}: {us / 1e3:.2f} ms ({100 * us / total:.1f}% of "
              "device time)")
    for us, name, _ in sorted(rows, reverse=True)[:6]:
        print(f"    top: {us / 1e3:.2f} ms {name[:90]}")
    for us, name, g in sorted(rows, reverse=True):
        if g == "attention kernels":
            print(f"    attention: {us / 1e3:.2f} ms {name[:90]}")
    return total


def check_results(cfg, params, reqs, label):
    import torch
    from repro_torch.serving.smoke import check_against_monolithic
    for req, _ in reqs:
        r = req.result
        if tuple(r.shape) != (len(req.tokens), cfg.vocab_size) or \
                not torch.isfinite(r.float()).all():
            fail(f"{label}: {req.client} result {tuple(r.shape)} is not "
                 "finite logits of the expected shape")
    worst = check_against_monolithic(cfg, params, reqs, atol=SERVE_ATOL,
                                     rtol=SERVE_RTOL)
    print(f"  {label}: {len(reqs)} results (prompt lengths "
          f"{[len(r.tokens) for r, _ in reqs]}) match the monolithic forward "
          f"(atol {SERVE_ATOL:g}, rtol {SERVE_RTOL:g}; largest |diff| "
          f"{worst:.3e})")


def serve_phase(device, arch="qwen3-1.7b", *, need, seed=0, hi=512,
                n_long=0, exact=False, after_fp32=None) -> dict:
    """Serve one model's path at full width; returns the kernels' launch
    counts over the two float32 waves. ``need`` names the kernels that
    must have launched there; ``exact`` gives the float32 waves
    ``EXACT_LENGTHS`` prompts (the bfloat16 waves keep lo..hi with
    ``n_long`` long ones); ``after_fp32(cfg, params)`` runs further
    float32 checks before the float32 model is freed."""
    import numpy as np
    import torch
    from repro_torch.core import Fragment, GraftPlanner
    from repro_torch.serving import GraftExecutor, InProcessTransport
    from repro_torch.serving.smoke import mixed_depth_plan, smoke_setup

    t0 = time.perf_counter()
    cfg, book, params = smoke_setup(arch, full_width=True, dtype="float32",
                                    seq_len=512, device=device)
    torch.cuda.synchronize()
    print(f"  {cfg.name} ({cfg.family}): d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, head_dim "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.n_layers} layers, window {cfg.sliding_window}, {cfg.dtype}; "
          f"init {time.perf_counter() - t0:.1f} s")
    L = cfg.n_layers
    rng = np.random.RandomState(seed)
    points = sorted(int(p) for p in rng.choice(L, size=6, replace=False))
    frags = [Fragment(cfg.name, p=p, t=float(40.0 + 40.0 * rng.rand()),
                      q=30.0, client=f"c{i}") for i, p in enumerate(points)]
    print(f"  clients' partition points: {points}")
    s = L // 2
    frags2 = [Fragment(cfg.name, min(f.p, s), f.t, f.q, client=f.client)
              for f in frags]
    wave = dict(hi=hi, n_long=n_long)
    wave32 = dict(wave, exact=exact)
    plan = GraftPlanner(book).plan(frags)
    reset_launches()                        # the main path starts here
    with GraftExecutor(plan, params, cfg,
                       InProcessTransport(max_frame_bytes=MAX_FRAME_BYTES),
                       device=device) as ex:
        reqs1 = make_wave(cfg, frags, rng, **wave32)
        serve_wave(ex, reqs1, "wave 1 (planner plan)")
        after1 = read_launches()
        diff = ex.apply_plan(mixed_depth_plan(cfg, book, frags2, s=s,
                                              batch=8))
        chains = {c: [k[1:] for k in keys]
                  for c, keys in ex.route_table().items()}
        print(f"  apply_plan: kept {diff.n_kept} pools; chains {chains}")
        reqs2 = make_wave(cfg, frags2, rng, **wave32)
        serve_wave(ex, reqs2, "wave 2 (re-aligned, depth-2 chains)")
        torch.cuda.synchronize()
        launches = read_launches()          # ... and ends here
        stats = ex.pool_stats()
    per_wave = [after1, {k: launches[k] - after1[k] for k in launches}]
    print(f"  kernel launches on the serving path: {launches} (per wave: "
          f"{per_wave})")
    for key, st in stats.items():
        print(f"    pool {key[1:]}: batches {st['n_batches']}, real tokens "
              f"{st['real_tokens']}, pad tokens {st['pad_tokens']}, "
              f"packed {st['packed']}, device {st['device']}")
    if not all(launches[n] > 0 for n in need):
        fail(f"a kernel of the serving path never launched: {launches}")
    if not any(len(c) == 2 for c in chains.values()):
        fail("the re-aligned plan has no depth-2 chain")
    check_results(cfg, params, reqs1, "wave 1")
    check_results(cfg, params, reqs2, "wave 2")
    if after_fp32 is not None:
        after_fp32(cfg, params)
    del params
    free_device()

    # the same path in bfloat16, timed (a warm-up wave first)
    cfg16, _, params16 = smoke_setup(arch, full_width=True,
                                     dtype="bfloat16", seq_len=512,
                                     device=device)
    reset_launches()
    with GraftExecutor(mixed_depth_plan(cfg16, book, frags2, s=s, batch=8),
                       params16, cfg16,
                       InProcessTransport(max_frame_bytes=MAX_FRAME_BYTES),
                       device=device) as ex:
        serve_wave(ex, make_wave(cfg16, frags2, rng, **wave),
                   "bf16 warm-up wave")
        reqs3 = make_wave(cfg16, frags2, rng, **wave)
        serve_wave(ex, reqs3, "bf16 wave")
        reqs4 = make_wave(cfg16, frags2, rng, **wave)
        profile_run("bf16 profiled wave",
                    lambda: serve_wave(ex, reqs4, "bf16 profiled wave"))
    print(f"  kernel launches, bf16 waves: {read_launches()}")
    for req, _ in reqs3:
        if not torch.isfinite(req.result.float()).all():
            fail(f"bf16 wave: {req.client} result is not finite")
    return launches


def rounding_sweep(depths):
    """An ``after_fp32`` hook: for the first ``d`` blocks of the model,
    each ``d`` in ``depths``, print how far one 300-token prompt's logits
    move when the same prompt runs in a padded batch (3 rows of 512
    tokens) instead of alone: the worst |difference| over the serving
    tolerance (atol + rtol |forward|). A float32 product's rounding
    depends on its row count; this shows how much of that the model
    amplifies with depth. Informational: it fails nothing."""
    def run(cfg, params):
        import dataclasses

        import numpy as np
        import torch
        from repro_torch.models import forward, run_fragment
        from repro_torch.models.transformer import slice_blocks
        dev = params["embed"].device
        S, T, rows = 300, 512, 3
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (1, S)).astype(np.int32)).to(dev)
        batch = torch.cat([toks, toks.new_zeros((1, T - S))], 1) \
            .repeat(rows, 1)
        for d in depths:
            cut = dataclasses.replace(cfg, n_layers=d)
            head = dict(params, blocks=slice_blocks(params["blocks"], 0, d))
            want = forward(head, cut, toks)[0]
            got = run_fragment(head, cut, batch, 0, d)[rows // 2, :S]
            diff = (got - want).abs()
            ratio = float((diff / (SERVE_ATOL + SERVE_RTOL
                                   * want.abs())).max())
            print(f"  rounding, {d} of {cfg.n_layers} layers: padded batch "
                  f"vs alone, max |diff| {float(diff.max()):.3e}, worst "
                  f"|diff| / tolerance {ratio:.3f} (logit std "
                  f"{float(want.std()):.3f})")
    return run


# layers of rwkv6-7b (of 32, full width) for the prefill + decode steps
# check: the steps run at 1 row, the forward at 308, so cuBLAS rounds
# them differently, and past ~8 layers random rwkv6 amplifies that past
# the bound (``rounding_sweep``)
STEP_LAYERS = 8


def ssm_steps_check(cfg, params) -> None:
    """One prompt's prefill, then 8 teacher-forced decode steps, against
    the forward at those positions, in the first ``STEP_LAYERS`` blocks:
    holds the final WKV state the scan kernel returns and decode
    carries."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.transformer import slice_blocks
    from repro_torch.serving.smoke import check_steps_against_forward
    cut = dataclasses.replace(cfg, n_layers=STEP_LAYERS)
    head = dict(params, blocks=slice_blocks(params["blocks"], 0,
                                            STEP_LAYERS))
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, 300 + 8)
    reset_launches()
    t0 = time.perf_counter()
    try:
        worst = check_steps_against_forward(cut, head, toks, 8,
                                            atol=STEP_ATOL, rtol=STEP_RTOL)
    except AssertionError as e:
        fail(f"rwkv6 prefill + decode steps disagree with the forward: {e}")
    torch.cuda.synchronize()
    n = read_launches()["wkv6_scan"]
    print(f"  {STEP_LAYERS} of {cfg.n_layers} layers: prefill of 300 tokens "
          f"+ 8 decode steps equal the forward at those positions (atol "
          f"{STEP_ATOL:g}, rtol {STEP_RTOL:g}; largest |diff| {worst:.3e}); "
          f"wkv6_scan launches {n}; {time.perf_counter() - t0:.1f} s")
    if n <= 0:
        fail("the prefill never launched wkv6_scan")


# ---------------------------------------------------------------------------
# phase 4: decode serving on the main path
# ---------------------------------------------------------------------------

DECODE_CTX = 512
DECODE_BATCH = 4
KV_BLOCK_TOKENS = 16
# every stream's blocks resident at once, with room to retain finished
# prompts: 8 streams x ceil((320 + 40 + 16) / 16) = 192 blocks at most
KV_BLOCKS = 256
MAX_NEW = 16
ABORT = {2: 4}                # stream 2 aborted after 4 batch steps


def decode_prompts(cfg, rng) -> list:
    """8 streams over 4 clients: streams 0-3 have fresh prompts of
    64-320 tokens; stream 4 repeats stream 0's prompt and stream 5
    stream 1's (whole-prompt prefix hits, a shared partial block that
    copy-on-writes), streams 6 and 7 extend streams 2's and 3's prompts
    by 8-40 fresh tokens (block-aligned prefix hits, the rest stepped)."""
    import numpy as np
    base = [rng.randint(0, cfg.vocab_size, int(rng.randint(64, 321)))
            .astype(np.int32) for _ in range(4)]
    tails = [rng.randint(0, cfg.vocab_size, int(rng.randint(8, 41)))
             .astype(np.int32) for _ in range(2)]
    return [(f"c{i}", t) for i, t in enumerate(base)] + [
        ("c0", base[0].copy()), ("c1", base[1].copy()),
        ("c2", np.concatenate([base[2], tails[0]])),
        ("c3", np.concatenate([base[3], tails[1]]))]


def run_decode(cfg, book, params, prompts, *, disagg, device, label):
    """Drive the prompts through a fresh executor; returns (drive_decode
    result, pool stats by role, wall seconds)."""
    import torch
    from repro_torch.core import Fragment
    from repro_torch.serving import GraftExecutor, InProcessTransport
    from repro_torch.serving.smoke import (decode_plan, disagg_plan,
                                           drive_decode)
    frags = [Fragment(cfg.name, 0, 50.0, 30.0, client=f"c{i}")
             for i in range(4)]
    plan = (disagg_plan if disagg else decode_plan)(cfg, book, frags,
                                                    batch=DECODE_BATCH)
    with GraftExecutor(plan, params, cfg, InProcessTransport(),
                       decode_ctx=DECODE_CTX, kv_blocks=KV_BLOCKS,
                       kv_block_tokens=KV_BLOCK_TOKENS,
                       decode_disagg=disagg, device=device) as ex:
        t0 = time.perf_counter()
        r = drive_decode(ex, prompts, MAX_NEW, disagg=disagg,
                         abort_at=ABORT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = {st["role"]: st for st in ex.pool_stats().values()}
    n_tok = sum(len(t) for t in r["tokens"] if t)
    print(f"  {label}: {len(prompts)} streams, aborted {r['aborted']}, "
          f"{r['mid_admits']} admitted mid-decode, {r['steps']} batch "
          f"steps, {n_tok} tokens, {r['handoffs']} KV handoffs; wall "
          f"{wall:.3f} s (admissions {r['admit_s']:.3f} s, steps "
          f"{r['step_s']:.3f} s)")
    for role, st in stats.items():
        kv = st["kv"] or {}
        print(f"    pool {role}: admits {st['decode_admits']}, steps "
              f"{st['decode_steps']}, prefill exports "
              f"{st['prefill_exports']}, handoffs in {st['kv_handoffs_in']}"
              f", resident {st['decode_active']}; arena prefix_hits "
              f"{kv.get('prefix_hits')}, tokens reused "
              f"{kv.get('prefix_tokens_reused')}, cow {kv.get('cow_copies')}"
              f", evictions {kv.get('evictions')}, handoff blocks in "
              f"{kv.get('handoff_blocks_in')}, handoff reused "
              f"{kv.get('handoff_reused')}, active seqs "
              f"{kv.get('active_seqs')}")
    return r, stats, wall


def decode_phase(device, arch="qwen3-1.7b", *,
                 need=("decode_attention", "flash_attention_lse")) -> dict:
    """Serve one model's decode path; returns the kernels' launch counts
    over the two float32 runs (single-pool, then disaggregated). ``need``
    names the kernels that must have launched there. A family whose
    arena shares prompt prefixes (dense) must show prefix hits and KV
    handoffs taken in; hybrid shares nothing (the arena does not hold
    its scan state): no hit, and its decode pool ignores the handoff's
    blocks and recomputes the prompt."""
    import numpy as np
    import torch
    from repro_torch.serving.smoke import reference_decode, smoke_setup

    t0 = time.perf_counter()
    cfg, book, params = smoke_setup(arch, full_width=True,
                                    dtype="float32", seq_len=DECODE_CTX,
                                    device=device)
    shares = cfg.family in ("dense", "moe")
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; decode_ctx "
          f"{DECODE_CTX}, batch {DECODE_BATCH}, {KV_BLOCKS} KV blocks of "
          f"{KV_BLOCK_TOKENS} tokens, {MAX_NEW} new tokens per stream; "
          f"init {time.perf_counter() - t0:.1f} s")
    prompts = decode_prompts(cfg, np.random.RandomState(1))
    print(f"  prompt lengths: {[len(t) for _, t in prompts]}")
    t0 = time.perf_counter()
    want, worst = [], []
    for i, (_, toks) in enumerate(prompts):
        margins: list = []
        want.append(reference_decode(cfg, params, toks, MAX_NEW,
                                     margins=margins))
        worst.append(min(margins))
    print(f"  reference (unbatched) decode: {time.perf_counter() - t0:.1f} s"
          f"; smallest top-1 minus top-2 logit margin per stream "
          f"{[f'{m:.4g}' for m in worst]}, over all {min(worst):.4g}")

    reset_launches()                        # the decode path starts here
    single, stats, _ = run_decode(cfg, book, params, prompts, disagg=False,
                                  device=device, label="single pool, fp32")
    split, dstats, _ = run_decode(cfg, book, params, prompts, disagg=True,
                                  device=device, label="disaggregated, fp32")
    torch.cuda.synchronize()
    launches = read_launches()              # ... and ends here
    print(f"  kernel launches on the decode path: {launches}")

    for i, got in enumerate(single["tokens"]):
        if i in single["aborted"]:
            continue
        if got != want[i]:
            fail(f"decode stream {i}: served {got} != reference {want[i]} "
                 f"(smallest reference margin {worst[i]:.4g})")
    print(f"  single pool: {len(prompts) - len(single['aborted'])} finished "
          "streams equal the unbatched reference token for token")
    if single["aborted"] != list(ABORT) or single["mid_admits"] < 1:
        fail(f"the abort or the mid-decode admission did not happen: "
             f"{single['aborted']}, {single['mid_admits']}")
    hits = stats["both"]["kv"]["prefix_hits"]
    if (hits < 1) if shares else (hits != 0):
        fail(f"{hits} prefix hits in the single-pool arena of a family "
             f"that {'shares' if shares else 'shares no'} prefixes")
    if split["tokens"] != single["tokens"]:
        fail(f"disaggregated tokens {split['tokens']} != single-pool "
             f"{single['tokens']}")
    taken = dstats["decode"]["kv_handoffs_in"]
    if split["handoffs"] != len(prompts) or \
            ((taken < 1) if shares else (taken != 0)) or \
            dstats["prefill"]["decode_active"] != 0:
        fail(f"disaggregation: {split['handoffs']} handoffs sent, {taken} "
             f"taken in, resident on the prefill pool "
             f"{dstats['prefill']['decode_active']}")
    print(f"  disaggregated: tokens equal the single-pool run; "
          f"{split['handoffs']} KV handoffs sent, {taken} taken in"
          f"{'' if shares else ' (hybrid recomputes each prompt)'}, "
          "nothing resident on the prefill pool")
    if not all(launches[n] > 0 for n in need):
        fail(f"a kernel of the decode path never launched: {launches}")

    # the same path in bfloat16, timed, then one profiled decode step
    del params
    free_device()
    cfg16, _, params16 = smoke_setup(arch, full_width=True,
                                     dtype="bfloat16", seq_len=DECODE_CTX,
                                     device=device)
    r16, _, wall = run_decode(cfg16, book, params16, prompts, disagg=False,
                              device=device, label="single pool, bf16")
    n_tok = sum(len(t) for t in r16["tokens"] if t)
    print(f"  bf16 decode: {r16['steps']} steps, {n_tok} tokens in "
          f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; per batch step "
          f"{1e3 * r16['step_s'] / r16['steps']:.2f} ms wall (host clock; "
          "each step ends in the host copy of its tokens, which "
          "synchronizes)")
    step_ms = 1e3 * r16["step_s"] / r16["steps"]
    dev_us = profile_decode_step(cfg16, book, params16, prompts, device)
    print(f"  bf16 decode step: device busy {dev_us / 1e3:.2f} ms (profiled)"
          f" of a {step_ms:.2f} ms unprofiled step ({dev_us / 10 / step_ms:.1f}"
          "%): the rest of the step the device waits on the host")
    return launches


def profile_decode_step(cfg, book, params, prompts, device) -> float:
    """Fill the batch with four streams, warm one step, then profile one
    decode step of the full batch."""
    import torch
    from repro_torch.core import Fragment
    from repro_torch.serving import GraftExecutor, InProcessTransport
    from repro_torch.serving.smoke import decode_plan
    frags = [Fragment(cfg.name, 0, 50.0, 30.0, client="c0")]
    with GraftExecutor(decode_plan(cfg, book, frags, batch=DECODE_BATCH),
                       params, cfg, InProcessTransport(),
                       decode_ctx=DECODE_CTX, kv_blocks=KV_BLOCKS,
                       kv_block_tokens=KV_BLOCK_TOKENS,
                       device=device) as ex:
        h = ex.handle(next(iter(ex.pool_specs())))
        for i, (client, toks) in enumerate(prompts[:DECODE_BATCH]):
            if not h.decode_admit(ex.next_rid(), client, toks,
                                  MAX_NEW)["admitted"]:
                fail("profiled decode step: admission refused")
        h.decode_step()

        def step():
            t0 = time.perf_counter()
            rep = h.decode_step()
            torch.cuda.synchronize()
            if rep["active"] != DECODE_BATCH:
                fail(f"profiled decode step: {rep['active']} resident")
            return time.perf_counter() - t0
        return profile_run(
            f"bf16 profiled decode step (batch {DECODE_BATCH})", step)


# ---------------------------------------------------------------------------
# phase 5: the event-driven server on the main path
# ---------------------------------------------------------------------------

# four clients; the last one decodes (p = 0: its route is the full-range
# pool, the only one that can hold its KV), client 0 moves from 3 to 4
# halfway through the traffic
SERVER_POINTS = (3, 9, 17, 0)
# requests/s per client, the least the serve loop sends: the card's
# server falls behind at more in float32 (PERF.md §6), as every
# one-shot request's full-vocab logits (0.3 GB at 496 tokens) cross the
# host and the planner's batch-1 pools decode one stream at a time. The
# decode client sends four streams, the first and third on one prompt.
SERVER_RATES = (0.5, 0.5, 0.5, 0.5)
SERVER_BUDGET_MS = 4000.0                      # the reference smokes' budget
SERVER_SECONDS = 8.0
SERVER_PERIOD_MS = 250.0                       # the controller's timer
# every prompt leaves room for 16 new tokens in the 512-slot decode cache
SERVER_PROMPTS = (128, DECODE_CTX - MAX_NEW)
SERVER_CHECK = 64                              # one-shot results checked


def server_loop(cfg, book, params, telemetry) -> dict:
    """``run_serve_loop`` over full-width weights: the planner's plan
    through a ``ServingController`` (its window half the traffic's
    seconds, so a client that falls silent departs), client threads for
    ``SERVER_SECONDS`` with a partition shift halfway, decode streams
    from the last client. Returns the report with the served requests,
    unchecked: the checks' own launches must not count."""
    from repro_torch.core import Fragment
    from repro_torch.serving import run_serve_loop
    frags = [Fragment(cfg.name, p, SERVER_BUDGET_MS, q, client=f"c{i}")
             for i, (p, q) in enumerate(zip(SERVER_POINTS, SERVER_RATES))]
    return run_serve_loop(
        setup=(cfg, book, params), frags=frags, seconds=SERVER_SECONDS,
        seed=0, shift_frac=0.5, control_period_ms=SERVER_PERIOD_MS,
        prompt_lens=SERVER_PROMPTS, decode_max_new=MAX_NEW,
        check_numerics=False, telemetry=telemetry)


def print_server_report(rep, tel, label) -> None:
    hist = {n: tel.histogram(n) for n in ("server/exec_ms",
                                          "server/uplink_ms",
                                          "replan/apply_ms")}
    print(f"  {label}: served {rep['served']} of {rep['offered']} offered "
          f"in {rep['wall_s']:.3f} s of traffic (drained "
          f"{rep['drained']}); shed {rep['shed']}, local finishes "
          f"{rep['local_finishes']}, decode local {rep['decode_local']}, "
          f"rerouted {rep['rerouted']}, parked {rep['waited']}; "
          f"{rep['n_stage_pools']} pools, mean batch "
          f"{rep['mean_batch']:.3f}")
    print("    host clock, ms (count, p50, p99): " + "; ".join(
        f"{n} ({h.count()}, {h.quantile(0.5):.1f}, {h.quantile(0.99):.1f})"
        for n, h in hist.items()))
    print(f"    replans under traffic {rep['controller_replans']} (applied "
          f"by the timer {rep['timer_replans']}, refused and retried "
          f"{rep['applies_refused']}; triggers {rep['controller_triggers']}"
          f"); control-tick errors {rep['tick_errors']}; controller plan "
          f"deployed {rep['plan_in_sync']}")
    for c, r in rep["clients"].items():
        print(f"    client {c}: n {r['n']}, p50 {r['p50_ms']:.1f} ms, p99 "
              f"{r['p99_ms']:.1f} ms against {r['budget_ms']:.0f} ms, "
              f"attainment {r['attainment']:.3f}")


def serve_streams(cfg, book, params, prompts, *, disagg, device) -> tuple:
    """The decode prompts through a ``GraftServer`` over a single-pool
    or a disaggregated decode plan; returns (tokens per stream, report,
    pool stats by role)."""
    from repro_torch.core import Fragment
    from repro_torch.serving import (GraftExecutor, GraftServer,
                                     InProcessTransport, ServeRequest)
    from repro_torch.serving.smoke import decode_plan, disagg_plan
    frags = [Fragment(cfg.name, 0, SERVER_BUDGET_MS, 30.0, client="c3")]
    plan = (disagg_plan if disagg else decode_plan)(cfg, book, frags,
                                                    batch=DECODE_BATCH)
    ex = GraftExecutor(plan, params, cfg, InProcessTransport(),
                       decode_ctx=DECODE_CTX, kv_blocks=KV_BLOCKS,
                       kv_block_tokens=KV_BLOCK_TOKENS,
                       decode_disagg=disagg, device=device)
    server = GraftServer(ex, book=book).start()
    reqs = [ServeRequest(client="c3", tokens=t, max_new_tokens=MAX_NEW)
            for t in prompts]
    try:
        for r in reqs:
            server.submit(r, 0, SERVER_BUDGET_MS)
        if not server.join(timeout=300.0):
            fail("the disaggregated server never drained")
        rep = server.report()
        stats = {st["role"]: st for st in ex.pool_stats().values()}
    finally:
        server.stop(drain=False, timeout=10.0)
        ex.close()
    return [r.out_tokens for r in reqs], rep, stats


def check_control(rep, label) -> None:
    """The control loop raised nothing, every refused replan was reverted
    in the controller, and the controller believes the deployed plan."""
    if rep["tick_errors"] or not rep["plan_in_sync"] or \
            rep["controller_refused"] != rep["applies_refused"]:
        fail(f"{label}: {rep['tick_errors']} control-tick errors, "
             f"controller plan deployed {rep['plan_in_sync']}, refused "
             f"{rep['applies_refused']} by the server and "
             f"{rep['controller_refused']} by the controller")


def server_phase(device) -> dict:
    """The server runtime serving full-width qwen3-1.7b under a live
    replan; returns the kernels' launch counts over the float32 server
    runs (the loop, then the disaggregated streams)."""
    import numpy as np
    import torch
    from repro_torch.serving.server import check_serve_report
    from repro_torch.serving.smoke import smoke_setup
    from repro_torch.serving.telemetry import Telemetry

    t_phase = t0 = time.perf_counter()
    cfg, book, params = smoke_setup("qwen3-1.7b", full_width=True,
                                    dtype="float32", seq_len=512,
                                    device=device)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; clients at "
          f"{SERVER_POINTS} (c0 moves to {SERVER_POINTS[0] + 1} halfway, "
          f"c{len(SERVER_POINTS) - 1} decodes {MAX_NEW} tokens), "
          f"{SERVER_RATES} requests/s, budget {SERVER_BUDGET_MS:.0f} ms, "
          f"prompts {SERVER_PROMPTS[0]}-{SERVER_PROMPTS[1]} tokens, "
          f"{SERVER_SECONDS:.0f} s; init {time.perf_counter() - t0:.1f} s")

    reset_launches()                        # the server path starts here
    t0 = time.perf_counter()
    tel = Telemetry(process="serve")
    rep = server_loop(cfg, book, params, tel)
    torch.cuda.synchronize()
    launches = read_launches()              # ... pauses here for checks
    print(f"  fp32 loop: {time.perf_counter() - t0:.1f} s with warm-up and "
          f"drain; kernel launches {launches}")
    print_server_report(rep, tel, "fp32 loop")
    if not rep["drained"]:
        fail("the server did not drain")
    if rep["controller_replans"] < 1 or rep["timer_replans"] < 1:
        fail("no replan applied under traffic")
    check_control(rep, "fp32 loop")
    if rep["shed"] or rep["local_finishes"] or rep["decode_local"]:
        fail(f"shed {rep['shed']}, local finishes {rep['local_finishes']}, "
             f"decode local {rep['decode_local']}: every request must be "
             "served by the pools")
    if not all(launches[n] > 0 for n in ("flash_attention",
                                         "flash_attention_lse",
                                         "decode_attention")):
        fail(f"a kernel of the server path never launched: {launches}")
    if any(r.result is None for r, _ in rep["requests"]):
        fail("a one-shot request got no result")
    check_serve_report(cfg, params, rep, max_check=SERVER_CHECK)
    if not rep["numerics_ok"]:
        fail(f"fp32 loop: a result is off the monolithic forward: "
             f"{rep['numerics_error']}")
    print(f"  fp32 loop: {rep['numerics_checked']} of "
          f"{len(rep['requests'])} one-shot results match the monolithic "
          f"forward (atol 5e-05, rtol 0.001; largest |diff| "
          f"{rep['numerics_max_abs']:.3e})")
    streams = rep["decoded"]
    prompts = [r.tokens for r, _ in streams]
    if len(streams) < 2 or not any(
            np.array_equal(a, b) for i, a in enumerate(prompts)
            for b in prompts[:i]):
        fail(f"{len(streams)} decode streams, none repeating a prompt")
    if not rep.get("decode_numerics_ok") or \
            rep["decode_checked"] != len(streams):
        fail(f"fp32 loop: {rep.get('decode_checked', 0)} of {len(streams)} "
             "decode streams checked, or one differs from the reference "
             f"(smallest reference margin {rep.get('decode_min_margin')})")
    print(f"  fp32 loop: {len(streams)} decode streams (prompt lengths "
          f"{[len(t) for t in prompts]}) equal the unbatched reference "
          f"token for token; smallest top-1 minus top-2 margin "
          f"{rep['decode_min_margin']:.4g}")

    reset_launches()                        # ... and resumes here
    single = [r.out_tokens for r, _ in streams]
    split, drep, dstats = serve_streams(cfg, book, params, prompts,
                                        disagg=True, device=device)
    torch.cuda.synchronize()
    more = read_launches()                  # ... and ends here
    launches = {k: launches[k] + more[k] for k in launches}
    taken = dstats["decode"]["kv_handoffs_in"]
    print(f"  disaggregated server: {drep['decode_served']} streams, "
          f"{drep['kv_handoffs']} KV handoffs ({drep['kv_handoff_ms']:.2f} "
          f"ms each on average), {taken} taken in, decode local "
          f"{drep['decode_local']}; kernel launches {more}")
    if split != single:
        fail(f"disaggregated server tokens {split} != the loop's {single}")
    if drep["kv_handoffs"] < 1 or taken < 1 or drep["decode_local"]:
        fail("the disaggregated server handed no KV over")
    print(f"  kernel launches on the server path: {launches}")
    del params, rep
    free_device()

    # the same loop in bfloat16, printed only
    cfg16, book16, params16 = smoke_setup("qwen3-1.7b", full_width=True,
                                          dtype="bfloat16", seq_len=512,
                                          device=device)
    tel = Telemetry(process="serve")
    rep16 = server_loop(cfg16, book16, params16, tel)
    print_server_report(rep16, tel, "bf16 loop")
    check_control(rep16, "bf16 loop")
    dec = rep16.get("decode", {})
    apply_ms = [e["apply_ms"] for e in rep16["audit"]
                if e["apply_ms"] is not None]
    print(f"  bf16 server (host clock; {smi_line()}): served "
          f"{rep16['served']} of {rep16['offered']} offered; latency p50 "
          f"{rep16['p50_ms']:.1f} ms, p99 {rep16['p99_ms']:.1f} ms, "
          f"attainment {rep16['attainment']:.3f} at a "
          f"{SERVER_BUDGET_MS:.0f} ms budget; decode TTFT p50 "
          f"{dec.get('ttft_p50_ms', float('nan')):.1f} ms, p99 "
          f"{dec.get('ttft_p99_ms', float('nan')):.1f} ms, TPOT p50 "
          f"{dec.get('tpot_p50_ms', float('nan')):.1f} ms, p99 "
          f"{dec.get('tpot_p99_ms', float('nan')):.1f} ms; mean batch "
          f"{rep16['mean_batch']:.3f}; replans {rep16['controller_replans']}"
          f", apply ms {[round(a, 3) for a in apply_ms]}")
    for req, _ in rep16["requests"]:
        if req.result is None or not torch.isfinite(req.result.float()).all():
            fail(f"bf16 loop: {req.client} result missing or not finite")
    del params16
    free_device()
    print(f"  server phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 6: pool workers on the card, the fleet, the serving launcher
# ---------------------------------------------------------------------------

# the executor's clients; the re-aligned plan cuts at the last of them,
# so its pool survives the replan in its worker
REMOTE_POINTS = (3, 9, 17)
REMOTE_FRONTENDS = 2
CLI_TIMEOUT_S = 300


def indented(*args) -> None:
    print("   ", *args, flush=True)


def print_spawns(spawn_log, label) -> None:
    for key, spawn_s, init_s, nbytes in spawn_log:
        print(f"    {label} worker for pool {key[1:]}: spawn {spawn_s:.2f} s, "
              f"init {init_s:.2f} s ({nbytes / 2**30:.2f} GiB of parameters)")


def remote_executor_check(cfg, book, params, device) -> dict:
    """``RemoteExecutor`` on the card: one worker per pool of the
    planner's plan, two waves, a re-aligned plan, two more waves; every
    result against the forward. Returns the launches on this path: the
    workers' (pool execution) plus this process's (mobile parts)."""
    import numpy as np
    import torch
    from repro_torch.core import Fragment, GraftPlanner
    from repro_torch.serving import RemoteExecutor, SocketTransport
    from repro_torch.serving.smoke import mixed_depth_plan

    rng = np.random.RandomState(4)
    frags = [Fragment(cfg.name, p, float(40.0 + 40.0 * rng.rand()), 30.0,
                      client=f"c{i}") for i, p in enumerate(REMOTE_POINTS)]
    s = REMOTE_POINTS[-1]
    t0 = time.perf_counter()
    reset_launches()                        # the remote path starts here
    with RemoteExecutor(
            GraftPlanner(book).plan(frags), params, cfg,
            SocketTransport(max_frame_bytes=MAX_FRAME_BYTES),
            device=device) as rex:
        print(f"  executor: {rex.n_stage_pools} workers up in "
              f"{time.perf_counter() - t0:.1f} s")
        print_spawns(rex.spawn_log, "fp32")
        rex.kernel_launches(reset=True)     # ... and in the workers here
        pids1 = rex.worker_pids()
        if os.getpid() in pids1.values() or \
                len(set(pids1.values())) != rex.n_stage_pools:
            fail(f"pools are not one worker process each: {pids1}")
        waves = []
        for i in range(2):
            waves.append(make_wave(cfg, frags, rng))
            serve_wave(rex, waves[-1], f"remote wave {i + 1} (planner plan)")
        n_spawned = len(rex.spawn_log)
        t1 = time.perf_counter()
        diff = rex.apply_plan(mixed_depth_plan(cfg, book, frags, s=s,
                                               batch=8))
        print(f"  apply_plan: kept {diff.n_kept}, added "
              f"{len(diff.by_kind('add'))}, removed "
              f"{len(diff.by_kind('remove'))} in "
              f"{time.perf_counter() - t1:.1f} s")
        print_spawns(rex.spawn_log[n_spawned:], "fp32 (replan)")
        pids2 = rex.worker_pids()
        kept = set(pids1) & set(pids2)
        if not kept or any(pids1[k] != pids2[k] for k in kept):
            fail(f"no pool kept its worker across the replan: {pids1} -> "
                 f"{pids2}")
        for i in range(2):
            waves.append(make_wave(cfg, frags, rng))
            serve_wave(rex, waves[-1], f"remote wave {i + 3} (re-aligned)")
        torch.cuda.synchronize()
        workers = rex.kernel_launches()
        uplink = rex.drain_uplink()
    parent = read_launches()                # ... and ends here
    print(f"  kept workers {sorted(k[1:] for k in kept)} (pids "
          f"{sorted(pids2[k] for k in kept)}); kernel launches in the "
          f"workers {workers}, in this process {parent}")
    for client, nbytes, ms in uplink[:6]:
        print(f"    uplink {client}: {nbytes} B in {ms:.2f} ms")
    # the workers run the packed pools (row 1); this process runs the
    # mobile parts [0, p), the unsegmented forward (row 2)
    if workers["flash_attention"] < 1 or parent["flash_attention_lse"] < 1:
        fail(f"the forward kernels did not launch on the remote path: "
             f"workers {workers}, parent {parent}")
    for i, wave in enumerate(waves):
        check_results(cfg, params, wave, f"remote wave {i + 1}")
    return {k: workers[k] + parent[k] for k in workers}


def fleet_loop(cfg, book, params, telemetry, seconds) -> dict:
    """The server phase's loop through ``GraftFleet`` front-ends over a
    ``RemoteExecutor``; returns its report, unchecked."""
    from repro_torch.core import Fragment
    from repro_torch.serving import run_serve_loop
    frags = [Fragment(cfg.name, p, SERVER_BUDGET_MS, q, client=f"c{i}")
             for i, (p, q) in enumerate(zip(SERVER_POINTS, SERVER_RATES))]
    return run_serve_loop(
        setup=(cfg, book, params), frags=frags, seconds=seconds,
        seed=0, shift_frac=0.5, control_period_ms=SERVER_PERIOD_MS,
        prompt_lens=SERVER_PROMPTS, decode_max_new=MAX_NEW,
        check_numerics=False, telemetry=telemetry, mode="socket",
        frontends=REMOTE_FRONTENDS, router="weighted", log=indented)


def print_fleet_report(rep, tel, label) -> None:
    print_server_report(rep, tel, label)
    up = tel.histogram("server/uplink_bytes")
    print(f"    fleet: front-ends {rep['frontends']}, steals "
          f"{rep['steals']}, cross-dispatched {rep['cross_dispatched']}; "
          f"uplink bytes per hop (count, p50, p99) ({up.count()}, "
          f"{up.quantile(0.5):.0f}, {up.quantile(0.99):.0f})")


def start_cli(args) -> tuple:
    """Start ``python -m repro_torch.launch.serve ARGS`` on the card;
    :func:`finish_cli` waits for it."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.serve", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    return args, proc, time.perf_counter()


def finish_cli(run) -> None:
    """Fail unless the launcher exited 0; print the end of its report."""
    args, proc, t0 = run
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"launch.serve {' '.join(args)} ran past {CLI_TIMEOUT_S} s")
    print(f"  launch.serve {' '.join(args)}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in out.strip().splitlines()[-6:]:
        print(f"    {line}")
    if proc.returncode != 0:
        fail(f"launch.serve {' '.join(args)} exited {proc.returncode}: "
             f"{(out + err)[-2000:]}")


def remote_phase(device) -> dict:
    """Pool workers on the card under the executor and under the fleet,
    then the serving launcher; returns the kernels' launch counts over
    the float32 remote paths (the executor's waves, then the fleet
    loop), the workers' and this process's."""
    import numpy as np
    import torch
    from repro_torch.core import arch_layer_costs
    from repro_torch.core.costmodel import (COMPUTE_EFF, HBM_BW, MEMORY_EFF,
                                            PEAK_FLOPS)
    from repro_torch.core.measured import measure_layer_costs
    from repro_torch.serving.server import check_serve_report
    from repro_torch.serving.smoke import run_route_smoke, smoke_setup
    from repro_torch.serving.telemetry import Telemetry

    t_phase = time.perf_counter()
    cfg, book, params = smoke_setup("qwen3-1.7b", full_width=True,
                                    dtype="float32", seq_len=512,
                                    device=device)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; executor clients at "
          f"{REMOTE_POINTS}, re-aligned at {REMOTE_POINTS[-1]}")
    launches = remote_executor_check(cfg, book, params, device)

    reset_launches()                        # the fleet path starts here
    t0 = time.perf_counter()
    tel = Telemetry(process="serve")
    rep = fleet_loop(cfg, book, params, tel, SERVER_SECONDS)
    torch.cuda.synchronize()
    parent = read_launches()                # ... and ends here
    workers = rep["worker_launches"]
    print(f"  fp32 fleet loop: {time.perf_counter() - t0:.1f} s with spawns, "
          f"warm-up and drain; kernel launches in the workers {workers}, "
          f"in this process {parent}")
    print_fleet_report(rep, tel, "fp32 fleet loop")
    if not rep["drained"]:
        fail("the fleet did not drain")
    if rep["controller_replans"] < 1 or rep["timer_replans"] < 1:
        fail("no replan applied under traffic")
    check_control(rep, "fp32 fleet loop")
    if rep["shed"] or rep["local_finishes"] or rep["decode_local"]:
        fail(f"shed {rep['shed']}, local finishes {rep['local_finishes']}, "
             f"decode local {rep['decode_local']}: every request must be "
             "served by the workers")
    if not all(workers[n] > 0 for n in ("flash_attention",
                                        "flash_attention_lse",
                                        "decode_attention")):
        fail(f"a forward or decode kernel never launched in the workers: "
             f"{workers}")
    if sum(1 for fe in rep["frontends"].values() if fe["served"]) \
            != REMOTE_FRONTENDS:
        fail(f"not every front-end served: {rep['frontends']}")
    if any(r.result is None for r, _ in rep["requests"]):
        fail("a one-shot request got no result")
    check_serve_report(cfg, params, rep, max_check=SERVER_CHECK)
    if not rep["numerics_ok"]:
        fail(f"fp32 fleet loop: a result is off the monolithic forward: "
             f"{rep['numerics_error']}")
    streams = rep["decoded"]
    if not streams or not rep.get("decode_numerics_ok") or \
            rep["decode_checked"] != len(streams):
        fail(f"fp32 fleet loop: {rep.get('decode_checked', 0)} of "
             f"{len(streams)} decode streams checked, or one differs from "
             "the reference")
    print(f"  fp32 fleet loop: {rep['numerics_checked']} one-shot results "
          f"match the monolithic forward (largest |diff| "
          f"{rep['numerics_max_abs']:.3e}); {len(streams)} decode streams "
          f"equal the unbatched reference token for token (smallest "
          f"margin {rep['decode_min_margin']:.4g})")
    for k in launches:
        launches[k] += workers[k] + parent[k]
    del params, rep
    free_device()

    # the launcher's two modes as subprocesses beside the route smoke
    t0 = time.perf_counter()
    clis = [start_cli(["--arch", "qwen3-1.7b", "--execute", "socket"]),
            start_cli(["--serve-loop", "--execute", "socket",
                       "--serve-seconds", "2", "--clients", "2",
                       "--frontends", "2"])]
    route = run_route_smoke(device=device, log=indented)
    for run in clis:
        finish_cli(run)
    if not (route["numerics_ok"] and route["steals"] >= 1
            and route["shed"] == 0):
        fail(f"route smoke: steals {route['steals']}, shed "
             f"{route['shed']}, numerics {route.get('numerics_error', 'ok')}")
    print(f"  launcher and route smoke: {time.perf_counter() - t0:.1f} s")

    # bfloat16, printed only
    cfg16, book16, params16 = smoke_setup("qwen3-1.7b", full_width=True,
                                          dtype="bfloat16", seq_len=512,
                                          device=device)
    tel = Telemetry(process="serve")
    rep16 = fleet_loop(cfg16, book16, params16, tel, SERVER_SECONDS)
    print_fleet_report(rep16, tel, "bf16 fleet loop")
    check_control(rep16, "bf16 fleet loop")
    dec = rep16.get("decode", {})
    print(f"  bf16 fleet (host clock; {smi_line()}): latency p50 "
          f"{rep16['p50_ms']:.1f} ms, p99 {rep16['p99_ms']:.1f} ms; decode "
          f"TTFT p50 {dec.get('ttft_p50_ms', float('nan')):.1f} ms, p99 "
          f"{dec.get('ttft_p99_ms', float('nan')):.1f} ms, TPOT p50 "
          f"{dec.get('tpot_p50_ms', float('nan')):.1f} ms, p99 "
          f"{dec.get('tpot_p99_ms', float('nan')):.1f} ms; steals "
          f"{rep16['steals']}, cross-dispatched {rep16['cross_dispatched']}")
    for req, _ in rep16["requests"]:
        if req.result is None or not torch.isfinite(req.result.float()).all():
            fail(f"bf16 fleet loop: {req.client} result missing or not "
                 "finite")
    measured = measure_layer_costs(cfg16, params16, seq_len=128,
                                   batches=(1, 4), reps=3)
    analytic = arch_layer_costs(cfg16, seq_len=128)
    alpha = measured.weight_bytes / (HBM_BW * MEMORY_EFF) * 1e3
    beta = measured.flops_per_item / (PEAK_FLOPS * COMPUTE_EFF) * 1e3
    a_alpha = analytic.weight_bytes / (HBM_BW * MEMORY_EFF) * 1e3
    a_beta = analytic.flops_per_item / (PEAK_FLOPS * COMPUTE_EFF) * 1e3
    print(f"  measure_layer_costs (bf16, 128 tokens, batches 1 and 4; "
          f"{smi_line()}): per block ms, measured alpha / beta against the "
          "analytic cost model's")
    for l in sorted({0, 1, cfg16.n_layers // 2, cfg16.n_layers - 1}):
        print(f"    block {l}: alpha {alpha[l]:.4f} (analytic "
              f"{a_alpha[l]:.4f}), beta {beta[l]:.4f} (analytic "
              f"{a_beta[l]:.4f})")
    print(f"    all {cfg16.n_layers} blocks: alpha mean {np.mean(alpha):.4f} "
          f"(min {np.min(alpha):.4f}, max {np.max(alpha):.4f}; analytic "
          f"{np.mean(a_alpha):.4f}), beta mean {np.mean(beta):.4f} (min "
          f"{np.min(beta):.4f}, max {np.max(beta):.4f}; analytic "
          f"{np.mean(a_beta):.4f})")
    del params16
    free_device()
    print(f"  remote phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 9: training on the main path
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 512
TRAIN_STEPS = 10
TRAIN_LR = 1e-3
# gradients through the kernels against autograd of the plain attention,
# float32: per leaf ||g - g_oracle|| / ||g_oracle||
GRAD_REL_L2 = 1e-3
LOSS_RTOL = 1e-4
BF16_STEPS = 5
# bfloat16 gradients through the kernels against the same bf16 model
# through the plain attention (fp32 inside): both round every activation
# to bf16 (2^-8 relative) at different places, and 28 layers carry those
# roundings into every gradient. Scalar bf16 kernels (fp32 P and dS, as
# the TPU kernels keep them) gave a worst leaf (blocks/attn/wq) of
# 1.761e-2 at this input on the H100; the wgmma bodies also round P and
# dS to bf16 before the second products (2^-9 per term). The bound
# leaves ~40% over the first; a wrong tile or mask moves whole rows and
# lands far above it.
BF16_GRAD_REL_L2 = 2.5e-2


def rel_l2(a, b) -> float:
    import torch
    d = torch.linalg.vector_norm((a.float() - b.float()).flatten())
    return float(d / torch.linalg.vector_norm(b.float().flatten())
                 .clamp_min(1e-30))


def named_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(named_leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


def worst_leaf(grads, want) -> tuple:
    """(largest per-leaf relative L2 distance, its leaf)."""
    a, b = named_leaves(grads), named_leaves(want)
    return max((rel_l2(a[n], b[n]), n) for n in b)


def plain_attention(q, k, v, *, causal=True, window=0, scale=None,
                    seg_ids=None):
    """ops.attention's oracle for the train phase: the plain forward,
    differentiated by autograd."""
    from repro_torch.kernels import flash_attention as fa
    if seg_ids is not None:
        fail("the train phase runs no segmented attention")
    return fa.flash_attention_lse_plain(q, k, v, causal=causal,
                                        window=window, scale=scale)[0]


@contextlib.contextmanager
def oracle_attention():
    """``ops.attention`` is ``plain_attention`` inside the block."""
    from repro_torch.kernels import ops
    saved = ops.attention
    ops.attention = plain_attention
    try:
        yield
    finally:
        ops.attention = saved


def bf16_grads_check(params, cfg, tokens, labels) -> tuple:
    """bfloat16 ``loss_and_grads`` through the kernels against the same
    call through ``plain_attention`` (autograd of the plain forward, fp32
    inside): -> (worst per-leaf relative L2, its leaf, the two losses)."""
    import torch
    from repro_torch.training.train_step import loss_and_grads
    loss_k, _, g_k = loss_and_grads(params, cfg, tokens, labels, remat=False)
    with oracle_attention():
        loss_o, _, g_o = loss_and_grads(params, cfg, tokens, labels,
                                        remat=False)
    torch.cuda.synchronize()
    rel, leaf = worst_leaf(g_k, g_o)
    return rel, leaf, float(loss_k), float(loss_o)


def train_phase(device, cfg=None, *, batch=TRAIN_B, seq=TRAIN_S) -> list:
    """Train full-width qwen3-1.7b (28 layers, random weights from a
    seeded generator on the card) on the ``token_batches`` stream:
    float32 gradients through the kernels against the plain-attention
    oracle, the remat variants, AdamW steps (the counted path: every
    layer's attention launches the forward kernel twice, remat's
    recompute included, and dq and dkv once per step), a checkpoint round
    trip and a resumed step, then bfloat16: gradients through the kernels
    against the plain-attention oracle, then steps (the second counted
    path: the bf16 bodies of the kernels), timed, and one profiled.
    Returns the launch counts of the float32 AdamW steps and of the timed
    bfloat16 steps. ``cfg``, ``batch`` and ``seq`` cut it to size for a
    rehearsal on the CPU."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step, restore_checkpoint,
                                      save_checkpoint)
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_step import loss_and_grads

    cfg = cfg or dataclasses.replace(get_config("qwen3-1.7b"),
                                     dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in named_leaves(params).values())
    data = token_batches(batch=batch, seq_len=seq, vocab=cfg.vocab_size,
                         seed=1)
    b0 = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {n_params / 1e9:.3f}B params, {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; batch {batch} x {seq} tokens; allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; init "
          f"{time.perf_counter() - t0:.1f} s")

    # 1-2. gradients through the kernels, the oracle, the remat variants
    def grads(remat):
        t = time.perf_counter()
        loss, _, g = loss_and_grads(params, cfg, b0["tokens"], b0["labels"],
                                    remat=remat)
        torch.cuda.synchronize()
        return float(loss), g, time.perf_counter() - t
    loss_k, g_k, s_k = grads(False)
    with oracle_attention():
        loss_o, g_o, s_o = grads(False)
    rel, leaf = worst_leaf(g_k, g_o)
    print(f"  fp32 loss through the kernels {loss_k:.6f}, through the plain "
          f"attention {loss_o:.6f} (rel {abs(loss_k - loss_o) / loss_o:.2e}"
          f", bound {LOSS_RTOL:g}); gradients: worst leaf {leaf} rel L2 "
          f"{rel:.3e} (bound {GRAD_REL_L2:g}); {s_k:.2f} s / {s_o:.2f} s")
    if abs(loss_k - loss_o) > LOSS_RTOL * abs(loss_o) or rel > GRAD_REL_L2:
        fail("training gradients through the kernels disagree with the "
             "plain attention's")
    del g_o
    for remat in (True, "dots"):
        loss_r, g_r, s_r = grads(remat)
        rel, leaf = worst_leaf(g_r, g_k)
        print(f"  remat={remat!r}: loss {loss_r:.6f}, worst leaf {leaf} rel "
              f"L2 {rel:.3e} against remat=False; {s_r:.2f} s")
        if abs(loss_r - loss_k) > LOSS_RTOL * abs(loss_k) or \
                rel > GRAD_REL_L2:
            fail(f"remat={remat!r} changes the gradients")
        del g_r
    del g_k
    free_device()

    # 3-4. AdamW steps, the counted path
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
    opt = init_opt_state(params)
    losses, walls = [], []
    reset_launches()                        # the train path starts here
    steps = TRAIN_STEPS
    for _ in range(steps):
        t = time.perf_counter()
        params, opt, m = step(params, opt, next(data))
        losses.append(float(m["loss"]))     # synchronizes
        walls.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    launches = read_launches()              # ... and ends here
    print(f"  fp32 AdamW (lr {TRAIN_LR:g}, remat=True) {steps} steps: "
          f"losses {[round(x, 4) for x in losses]}; s/step "
          f"{[round(w, 3) for w in walls]}; last grad norm "
          f"{float(m['grad_norm']):.3f}")
    print(f"  kernel launches on the train path: {launches}")
    if not np.isfinite(losses).all() or \
            np.mean(losses[-3:]) >= np.mean(losses[:3]):
        fail(f"the loss did not fall: {losses}")
    want = {"flash_attention_lse": 2 * cfg.n_layers * steps,
            "flash_attention_bwd_dq": cfg.n_layers * steps,
            "flash_attention_bwd_dkv": cfg.n_layers * steps}
    if any(launches[n] != c for n, c in want.items()):
        fail(f"train path launches {launches}, expected {want}")

    # 5. checkpoint round trip, and a resumed step
    ckpt_dir = os.path.join(HERE, "build", "train_ckpt")
    os.makedirs(os.path.dirname(ckpt_dir), exist_ok=True)
    nbytes = sum(t.numel() * t.element_size()
                 for t in named_leaves(params).values())
    free = shutil.disk_usage(os.path.dirname(ckpt_dir)).free
    print(f"  checkpoint: {nbytes / 1e9:.2f} GB of params, "
          f"{free / 1e9:.1f} GB free on disk")
    if free < 2 * nbytes:
        fail("not enough disk for the checkpoint")
    batch_r = next(data)
    t = time.perf_counter()
    save_checkpoint(ckpt_dir, params, step=steps)
    t_save = time.perf_counter() - t
    # both steps with deterministic kernels (the embedding's index
    # backward sorts instead of accumulating in arrival order), so that
    # they can be held to bit equality
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        p1, _, m1 = step(params, opt, batch_r)
        t = time.perf_counter()
        restored, at = restore_checkpoint(
            ckpt_dir, tree_map(torch.zeros_like, params))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t
        same = all(torch.equal(a, b) for a, b in zip(
            named_leaves(params).values(), named_leaves(restored).values()))
        print(f"  save {t_save:.1f} s, restore {t_load:.1f} s (step {at});"
              f" restored params equal the trained ones bit for bit: "
              f"{same}")
        if not same or at != steps:
            fail("the checkpoint round trip changed the params")
        del params
        p2, _, m2 = step(restored, opt, batch_r)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    diffs = {n: float((a.float() - b.float()).abs().max())
             for (n, a), b in zip(named_leaves(p1).items(),
                                  named_leaves(p2).values())}
    print(f"  resumed step: loss {float(m2['loss']):.6f} vs "
          f"{float(m1['loss']):.6f} without the round trip; largest "
          f"|param diff| {max(diffs.values()):.3e}")
    if float(m1["loss"]) != float(m2["loss"]) or any(diffs.values()):
        fail(f"the resumed step differs from the step without the round "
             f"trip: {diffs}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del restored, opt, p1, p2
    free_device()

    # 6. bfloat16 (bf16 params, fp32 moments): gradients against the
    # oracle, then steps, timed and profiled
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_params(cfg16, seed=0, device=device)
    rel, leaf, loss_k, loss_o = bf16_grads_check(params, cfg16, b0["tokens"],
                                                 b0["labels"])
    print(f"  bf16 loss through the kernels {loss_k:.6f}, through the plain "
          f"attention {loss_o:.6f}; gradients: worst leaf {leaf} rel L2 "
          f"{rel:.3e} (bound {BF16_GRAD_REL_L2:g})")
    if not rel <= BF16_GRAD_REL_L2:
        fail("bf16 training gradients through the kernels disagree with "
             "the plain attention's")
    free_device()
    step = make_train_step(cfg16, AdamWConfig(lr=TRAIN_LR))
    opt = init_opt_state(params)
    params, opt, m = step(params, opt, next(data))          # warm-up
    torch.cuda.synchronize()
    losses = []
    reset_launches()                        # the bf16 path starts here
    t = time.perf_counter()
    for _ in range(BF16_STEPS):
        params, opt, m = step(params, opt, next(data))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / BF16_STEPS
    launches16 = read_launches()            # ... and ends here
    losses = [float(x) for x in losses]
    print(f"  bf16 steps (remat=True): {wall:.4f} s/step, "
          f"{batch * seq / wall:.1f} tokens/s (host clock over "
          f"{BF16_STEPS} steps, ended by a synchronize); losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"  kernel launches on the bf16 train path: {launches16}")
    if not np.isfinite(losses).all():
        fail(f"bf16 training losses are not finite: {losses}")
    want = {n: c // steps * BF16_STEPS for n, c in want.items()}
    if any(launches16[n] != c for n, c in want.items()):
        fail(f"bf16 train path launches {launches16}, expected {want}")
    nxt = next(data)

    def one_step():
        nonlocal params, opt
        t = time.perf_counter()
        params, opt, _ = step(params, opt, nxt)
        torch.cuda.synchronize()
        return time.perf_counter() - t
    profile_run("bf16 profiled train step", one_step)
    del params, opt
    free_device()
    return [launches, launches16]


def ptxas_usage(log: str) -> dict:
    """{kernel (mangled): {"registers": n, "spills": text}} from an
    ``nvcc -Xptxas -v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = {}
        elif fn is not None and "spill stores" in line:
            out[fn]["spills"] = line.strip()
        elif fn is not None and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(
                line.split("Used")[1].split("registers")[0])
    return out


# source -> (the bf16 kernels it must hold, a substring of the mangled
# name of each bf16 instantiation, how many instantiations each has, the
# tensor-core instructions that count): the attention kernels at hd 32,
# 64 and 128 on wgmma; the SSM scan's two kernels at hd up to 16, 32, 64
# and 128 times N up to 16 and 32, and the WKV scan's two at hd 16, 32
# and 64, on mma.sync
TENSOR_CORE_KERNELS = {
    "flash_attention": (("attn_fwd_wgmma",), "", 3, ("HGMMA",)),
    "flash_attention_bwd": (("attn_bwd_dq_wgmma", "attn_bwd_dkv_wgmma"), "",
                            3, ("HGMMA",)),
    "ssm_scan": (("ssm_chunk_state_kernel", "ssm_chunk_out_kernel"),
                 "bfloat16", 8, ("HMMA", "HGMMA")),
    "wkv6_scan": (("wkv6_chunk_state_kernel", "wkv6_chunk_out_kernel"),
                  "bfloat16", 3, ("HMMA", "HGMMA")),
}
# sources none of whose kernels may spill (every instantiation, both
# dtypes), besides the tensor-core kernels above
NO_SPILL = ("decode_attention", "ssm_scan", "wkv6_scan")


def spilled(usage) -> bool:
    return any(int(x) for x in re.findall(r"(\d+) bytes spill",
                                          (usage or {}).get("spills", "")))


def tensor_core_check(logs: dict) -> None:
    """The bf16 attention kernels and scans run on the tensor cores:
    every bf16 instantiation of the forward's ``attn_fwd_wgmma``, the
    backward's ``attn_bwd_dq_wgmma`` and ``attn_bwd_dkv_wgmma`` (HGMMA)
    and the scans' ``ssm_chunk_{state,out}_kernel`` and
    ``wkv6_chunk_{state,out}_kernel`` (HMMA or HGMMA) in the built
    libraries must hold such instructions
    (``cuobjdump -sass``) and, where this run's ptxas log lists it, spill
    nothing; nor may any kernel of ``NO_SPILL``. Prints each one's count,
    registers and spills."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for stem, (names, sub, count, instrs) in TENSOR_CORE_KERNELS.items():
        lib = build._target(build.CSRC / f"{stem}.cu")
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn is not None and any(i in line for i in instrs):
                counts[fn] += 1
        usage = ptxas_usage(logs.get(stem, ""))
        for name in names:
            tc = {f: n for f, n in counts.items() if name in f and sub in f}
            for f, n in sorted(tc.items()):
                u = usage.get(f)
                print(f"  tensor cores: {f}: {n} {'/'.join(instrs)}; ptxas "
                      f"{u or 'not rebuilt in this run'}")
                if spilled(u):
                    fail(f"{f} spills registers: {u}")
            if len(tc) != count or not all(tc.values()):
                fail(f"the bf16 kernel {name} has instantiations without "
                     f"{' or '.join(instrs)} instructions: {tc}")
    for stem in NO_SPILL:
        for f, u in ptxas_usage(logs.get(stem, "")).items():
            if spilled(u):
                fail(f"{f} spills registers: {u}")


PHASES = ("kernels", "timing", "serve", "decode", "server", "remote",
          "hybrid", "ssm", "train")
# kernel -> (its source under src/repro_torch/kernels/csrc, the TPU
# kernel it replaces)
KERNELS = {
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:141"),
    "flash_attention_lse": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention_bwd.py:86"),
    "decode_attention": ("decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:93"),
    "ssm_scan": ("ssm_scan.cu", "src/repro/kernels/ssm_scan.py:80"),
    "wkv6_scan": ("wkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:85"),
    "flash_attention_bwd_dq": (
        "flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention_bwd.py:196"),
    "flash_attention_bwd_dkv": (
        "flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention_bwd.py:215"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # float32 parity: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    print(f"  {kind}; {count} device(s); nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(ptxas_verbose=True)
    print(f"  kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'already built'})")
    for stem, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {stem}: {line.strip()}")

    # a partial run (``--phases kernels,hybrid``: a first check of a new
    # kernel) checks what it runs and prints no record and no result
    phases = PHASES if len(sys.argv) < 3 or sys.argv[1] != "--phases" \
        else tuple(sys.argv[2].split(","))
    if not set(phases) <= set(PHASES):
        fail(f"unknown phases {phases}; known: {PHASES}")
    runs = []                           # launch counts of each path
    if "kernels" in phases:
        print("== kernels")
        tensor_core_check(logs)
        worst = kernel_phase(device)
    if "timing" in phases:
        print("== timing")
        timing = timing_phase(device)
    if "serve" in phases:
        print("== serve")
        runs.append(serve_phase(device, need=("flash_attention",
                                              "flash_attention_lse"),
                                after_fp32=rounding_sweep((28,))))
    if "decode" in phases:
        print("== decode")
        runs.append(decode_phase(device))
    if "server" in phases:
        print("== server")
        free_device()
        runs.append(server_phase(device))
    if "remote" in phases:
        print("== remote")
        free_device()
        runs.append(remote_phase(device))
    if "hybrid" in phases:
        print("== hybrid")
        free_device()
        runs.append(serve_phase(device, "hymba-1.5b", seed=2, hi=1536,
                                n_long=1, exact=True,
                                need=("flash_attention_lse", "ssm_scan"),
                                after_fp32=rounding_sweep((4, 8, 16, 32))))
        free_device()
        runs.append(decode_phase(device, "hymba-1.5b",
                                 need=("decode_attention",
                                       "flash_attention_lse", "ssm_scan")))
    if "ssm" in phases:
        print("== ssm")
        free_device()
        sweep = rounding_sweep((2, 4, 8, 16, 32))

        def rwkv_checks(cfg, params):
            sweep(cfg, params)
            ssm_steps_check(cfg, params)
        runs.append(serve_phase(device, "rwkv6-7b", seed=3, exact=True,
                                need=("wkv6_scan",), after_fp32=rwkv_checks))
    if "train" in phases:
        print("== train")
        free_device()
        runs.extend(train_phase(device))
    if phases != PHASES:
        print(f"== partial run ({', '.join(phases)}) done in "
              f"{time.perf_counter() - t_start:.1f} s: no record")
        return 0
    launches = {name: sum(r.get(name, 0) for r in runs) for name in KERNELS}
    print(f"  launches per path (serve, decode, server, remote, hybrid "
          f"serve, hybrid decode, ssm serve, fp32 train, bf16 train): "
          f"{runs}")
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import wkv6_scan as wk
    for name, m in (("ssm_scan", ss), ("wkv6_scan", wk)):
        for dev, (buf, _) in m._SCRATCH.items():
            print(f"  {name} scratch on {dev}: {4 * buf.numel()} B of chunk "
                  "states and decays (grown to this run's largest call)")

    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{KERNELS[name][0]}",
         "replaces": KERNELS[name][1],
         "launches": launches[name],
         "max_abs_err": max(worst[name].values()),
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"]}
        for name in KERNELS]}
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
