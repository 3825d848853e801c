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
   slices of one fused QKV buffer, the moe family's layouts (olmoe's 16
   heads of 16 kv at hd 128 packed and padded, llama4-scout's 40 of 8),
   the vlm and audio families' (whisper-base's encoder, decoder and
   cross-attention, 8 heads of 64 over 1500 frames; llama-3.2-vision's
   self and cross-attention, 64 heads / 8 kv of 128 over 1601 image
   tokens; both cross-attentions at Sq = 1 as decode runs them);
   for the decode kernel ragged Sk, a ring-buffer kv_pos with -1 holes,
   windows, hymba's GQA 5 at hd 64 with its window crossed, olmoe's,
   llama4-scout's, whisper's and llama-3.2-vision's decode steps, and
   with its log-sum-exp (``return_lse``) at two ranks' shards of a
   sequence-sharded cache (o and lse, a row with no valid slot, o equal
   to the launch without the lse); for the two recurrent scans T = 1, a prime
   T, a T that is not a multiple of 32, a nonzero input state and decays
   far past the clamp (in one chunk, and over four 64-step chunks with a
   ragged tail), for the WKV scan also T = 64 and 65 and head dims 16 and
   32 over several chunks, outputs and final states; for the
   two backward kernels dq, dk and dv on the same (q, k, v, o, lse, dO):
   the training shape, the JAX backward test's shapes with windows 0 and
   40, GQA groups 1 and 4, a prime S, Sq != Sk non-causal, rows that see
   no kv, hymba's GQA 5 with window 1024 at S = 1100, fused-QKV slices,
   whisper's encoder and cross-attention, vision's cross-attention),
   in float32 (scalar bodies) and bfloat16 (tensor-core bodies); bf16's
   atol 2e-2 scaled by min(1, max |want|) (``check_kernel``), and an
   all-zero output must fail each check.
   timing  — the kernel, its plain version and a PyTorch library call
   (where one exists) at the main-path shapes with CUDA events (the
   library's attention backward under the profiler), the forward with
   logsumexp also at hymba's serving shape and a decode admission's,
   beside SDPA, the decode kernel also at hymba's decode shape, both
   scans also at T = 2048, the forward with logsumexp at the two
   cross-attention decode shapes (Sq = 1; L2 cold) beside SDPA, and each
   call of the decode kernel and the two
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
9. moe     — full-width olmoe-1b-7b (16 layers, 64 experts of 1024,
   top 8) in float32: each layer's MoE on real block inputs (a forward's)
   with the grouped dispatch at a dropless capacity against the dense
   one, and how many of those routes the published capacity factor 1.25
   drops; the serve phase's path with the dense dispatch (packed pools)
   and again with the grouped one at the dropless capacity (padded
   pools), every result held against the forward; the decode phase's
   streams at the published config (a dispatch that can drop shares no
   prefix: no hit, the decode pool recomputes each prompt), token for
   token; then bfloat16 waves at the published config (the warm-up
   wave's drops per layer printed) and a decode step, profiled with the
   kernels inside ``moe_forward`` as their own group. Then
   llama4-scout (published widths, 2 of 48 layers: top 1 plus a shared
   expert, GQA 5) through the block check and both dispatches' waves.
10. ep      — olmoe-1b-7b at full width (16 layers, 64 experts) in
   bfloat16 through the expert-parallel dispatch over 4 gloo ranks
   sharing the card (``distributed/ranks.py``; each rank builds the
   whole model in turn, keeps its 16 experts of every layer and frees
   the rest): the forward of a 2 x 512 prompt batch on every rank,
   rank 0's logits held against the one-process grouped forward with
   the scaled bf16 check (``check_scaled``); each combine's
   ``all_reduce`` (bytes, CUDA-event ms, host ms, per layer and rank;
   gloo sums through host memory) and the EP forward's wall beside the
   grouped one's; then float32 at 2 of 16 layers, on each rank against
   its own grouped run with every expert: the logits (atol 5e-5, rtol
   1e-3), ``lm_loss`` and the gradients of the router, the embedding
   and the rank's expert slices (relative L2 within 1e-3). A rank that
   fails or outlives its timeout fails the phase. Each rank's launches
   come back to this process.
11. spmd    — qwen3-1.7b at its published widths (28 layers, d 2048, 16
   heads, 8 kv of 128) as DTensors placed by the baseline sharding rules
   (FSDP over ``data``, tensor parallelism over ``model``) over 4 gloo
   ranks sharing the card as a cuda ``DeviceMesh`` (data 2, model 2),
   every entry under ``implicit_replication``, the residual constraint
   and the MoE mesh hook, as ``launch/dryrun.py``'s sharded pass runs
   it; the functional collectives DTensor calls are routed to gloo's
   c10d calls (``spmd.gloo_cuda_collectives``), and each rank first
   checks the four collectives on CUDA tensors. float32 with TF32 off:
   ``prefill`` of a 2 x 512 batch into a 1,024-slot cache (the full
   logits held against one process's, atol 5e-5, rtol 1e-3) and 8
   greedy ``decode_step``s (token for token); then long_500k's decode at
   batch 1: a 4,608-token prompt prefilled in one process into the
   4,096-slot ring (it wraps), the cache split by the rules over
   ``data``, 8 greedy steps on the ranks, each rank's softmax over its
   slots merged with the others' (``spmd.merge_softmax``): tokens equal
   to one process's, fp32 logits at the same tolerance, every step's
   collectives equal to the fake group's count of one step, each step's
   bytes and ms, the merge's share and the wall printed; the loss and every
   gradient leaf at 2 of 28 layers against each rank's own one-process
   run (relative L2 1e-3). bfloat16: the prefill entry counted (every
   rank's collectives by op, bytes and counts, equal to the dry-run's
   fake-group count of the same entry on the same mesh) and timed (each
   rank's wall beside one process's, each collective's bytes, CUDA-event
   and host ms), its logits under ``check_scaled``. Rows 2, 3, 4 and 5
   launch on the ranks' local shards, once per attention; each one's
   first call is held against its plain version on the same shards.
12. multimodal — whisper-base at full width (6 encoder and 6 decoder
   layers, 1500 frames), then llama-3.2-vision-90b at its published widths
   cut to 2 of its 20 superblocks (10 layers, 10.7B parameters), float32
   with TF32 off: the serve phase's path, each request carrying its stub
   frontend's embeddings (vision: images; whisper: frames and the
   encoder's memory of them, which its fragments read), every result
   held against that request's own forward; then greedy streams of 16
   tokens by ``prefill`` + ``decode_step`` (4 whisper, 3 vision; prompts
   16-200 tokens), each token equal to the argmax of the forward re-run
   on the grown sequence (the smallest top-1 minus top-2 margin
   printed); vision's int8 KV cache through the kernels against the same
   decode through the plain ops. The vision cross blocks' gates are
   opened to 0.5 (the init's 0 passes them through). bfloat16 waves are
   timed and profiled, whisper's bf16 streams timed. Then whisper-base
   training (batch 2 x 128 tokens with frames): fp32 gradients, the
   encoder's included, against the plain attention's, one counted AdamW
   step, and counted, timed bf16 steps (rows 2, 4 and 5 launching
   exactly once per attention and recompute).
13. train  — full-width qwen3-1.7b (28 layers, random weights) on the
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
14. launch — qwen3-1.7b at its published widths (28 layers, bf16,
   random seeded weights) through ``launch.specs.entry_fn`` at each
   workload shape with only the batch cut to fit one H100 80GB (each cut
   printed): ``prefill`` of 32,768 tokens (B 32 -> 1), ``decode_step``
   against a 32,768-slot cache whose every slot holds random k/v (B 128
   -> 4), against long_500k's 4,096-slot ring (B 1), and one AdamW step
   of 4,096 tokens with remat (B 256 -> 1). Each entry launches its
   kernels exactly once per attention (twice per layer for the forward
   under remat); the first captured calls are held against their plain
   versions (row 2's last 512 query rows over every key at 32k, row 3 on
   the same cache, rows 2, 4 and 5 on the train step's q, k, v, o, lse
   and dO) and timed beside SDPA and their bound; each entry's wall
   (host clock, ended by a synchronize), its device time by kernel
   group, and ``launch/roofline.py``'s compute and memory terms for the
   same config and batch (the meta run) with the wall's share of the
   larger are printed. Then ``python -m repro_torch.launch.dryrun
   --shape all --mesh 1xH100`` runs for every arch, one process each at
   once (meta device: one core each, no device work), after the timed
   entries; its report table and each combo's ``fits_80gb`` are
   printed.
15. examples — each example twin (``examples/*_torch.py``) in this
   process through ``runpy``: the realign demo, the quickstart (each
   served request within the serving tolerance of the forward), the
   serving driver, online serving in the simulator, in in-process and
   socket waves and in the event-driven loop, long-context decode; each
   must exit 0, print its numerics line and launch its kernels.
Each phase prints its seconds. Each model is freed before the next one
loads. The launch counts in the
kernels' record are the sums over the main paths: the serve waves and
the float32 decode runs (single-pool and disaggregated) of each model
(both dispatches' waves for the moe models), the ep phase's bf16
forward and fp32 loss with its backward on every rank, the spmd phase's
fp32 prefill and greedy steps, fp32 loss with its backward, counted
bf16 prefill and long_500k decode steps on every rank, the multimodal
phase's
float32 waves and decode streams and its whisper train steps,
the float32 server loop and its disaggregated streams, the float32
remote executor's waves and fleet loop (launches in the workers and in
this process), the float32 AdamW steps and timed bfloat16 steps, the
launch phase's four counted entries and the examples run in this
process, each path's counters zeroed just before it and read just after.
The line before the last is ``nvidia-smi``'s name and power limit, the
one before it the kernels' JSON record, and the last line the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import threading
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


def check_kernel(name, got, want, dname):
    """A kernel's output against its plain version's: float32 at
    ``TOL["float32"]``; bfloat16 at ``TOL["bfloat16"]`` with ``atol``
    scaled by min(1, max |want|), never looser than the fixed 2e-2, which
    holds nothing where the output is far below 1 (attention over many
    keys, gradients). The same limits must refuse an all-zero output."""
    import torch
    atol, rtol = TOL[dname]
    if dname == "bfloat16":
        atol *= min(1.0, want.float().abs().max().item())
    if torch.allclose(torch.zeros_like(want, dtype=torch.float32),
                      want.float(), atol=atol, rtol=rtol):
        fail(f"{name}: the check would pass an all-zero output")
    return check_close(name, got, want, atol, rtol)


def check_scaled(name, got, want, tol, roll_dim):
    """``check_close`` with ``atol`` = ``tol[0]`` times max |want|: at a
    long context the outputs (and gradients) are far below 1, where a
    fixed atol would hold nothing. The same check must refuse an
    all-zero output and ``want`` rolled by one along ``roll_dim`` (heads,
    say): else it could not see a kernel that writes nothing or writes
    a neighbour's rows. Prints the relative L2 error too."""
    import torch
    got, want = got.detach(), want.detach()
    scale = want.float().abs().max().item()
    atol, rtol = tol[0] * scale, tol[1]
    print(f"  {name}: max |want| {scale:.3e}, relative L2 "
          f"{rel_l2(got, want):.3e}")
    e = check_close(name, got, want, atol, rtol)
    for what, bad in (("zeros", torch.zeros_like(want)),
                      ("a rolled copy", want.roll(1, roll_dim))):
        if torch.allclose(bad.float(), want.float(), atol=atol, rtol=rtol):
            fail(f"{name}: the check would pass {what}")
    print(f"  {name}: zeros and a copy rolled along dim {roll_dim} fail "
          "the same check")
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
    # the moe family's head layouts: olmoe (GQA 1, hd 128) packed and
    # padded, llama4-scout (GQA 5, hd 128)
    ("olmoe packed, GQA 1", 1, 2048, 2048, 16, 16, 128, True, 0,
     [300, 517, 211, 489, 250, 181], False),
    ("olmoe prompt, GQA 1", 2, 512, 512, 16, 16, 128, True, 0, None, False),
    ("llama4 prompt, GQA 5", 1, 1024, 1024, 40, 8, 128, True, 0, None,
     False),
    # the vlm and audio families: whisper-base (8 heads of 64, 1500
    # frames) and llama-3.2-vision (64 heads / 8 kv of 128, 1601 image
    # tokens); cross-attention is non-causal with Sq != Sk (a ragged last
    # kv tile at both lengths), Sq = 1 in decode (a q tile of one row)
    ("whisper encoder", 2, 1500, 1500, 8, 8, 64, False, 0, None, False),
    ("whisper decoder self", 2, 448, 448, 8, 8, 64, True, 0, None, False),
    ("whisper cross", 2, 448, 1500, 8, 8, 64, False, 0, None, False),
    ("whisper cross decode, Sq 1", 4, 1, 1500, 8, 8, 64, False, 0, None,
     False),
    ("vision self", 1, 300, 300, 64, 8, 128, True, 0, None, False),
    ("vision cross", 2, 200, 1601, 64, 8, 128, False, 0, None, False),
    ("vision cross decode, Sq 1", 3, 1, 1601, 64, 8, 128, False, 0, None,
     False),
]
# row 2 at the two cross-attention decode shapes (timed against SDPA)
CROSS_DECODE_TIMED = [c for c in CASES if c[2] == 1]


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
          "both, summation order only); bfloat16 atol 2e-2 x min(1, max "
          "|want|) rtol 1e-2 (both round o, or dq, dk and dv, to bf16 from "
          "fp32 sums: one ulp is 2^-7 relative, 7.8e-3 near 1); an all-zero "
          "output must fail either; lse atol 1e-4 (fp32 in both)")
    worst = {"flash_attention": {}, "flash_attention_lse": {}}
    gen = torch.Generator().manual_seed(0)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
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
            e = check_kernel(f"flash_attention {tag}", got, want, dname)
            worst["flash_attention"][(dname, label)] = e
            if seg is None:
                o, lse = fa.flash_attention_lse(q, k, v, **kw)
                o2, lse2 = fa.flash_attention_lse_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                e = check_kernel(f"flash_attention_lse o {tag}", o, o2,
                                 dname)
                check_close(f"flash_attention_lse lse {tag}", lse, lse2,
                            LSE_ATOL, 0.0)
                worst["flash_attention_lse"][(dname, label)] = e
    worst["decode_attention"] = decode_kernel_cases(device, gen)
    worst["decode_attention"].update(decode_lse_cases(device, gen))
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
    ("olmoe decode, GQA 1", 4, 512, 16, 16, 128, [511, 300, 64, 5], False,
     0),
    ("llama4 decode, GQA 5", 4, 512, 40, 8, 128, [511, 300, 64, 5], False,
     0),
    # the vlm/audio decoders' self-attention: whisper (8 of 64, its 448
    # positions), llama-3.2-vision (64 / 8 of 128)
    ("whisper decode self", 4, 448, 8, 8, 64, [447, 200, 31, 16], False, 0),
    ("vision decode self", 3, 216, 64, 8, 128, [215, 100, 17], False, 0),
    DECODE_MAIN,
]


def decode_kernel_cases(device, gen) -> dict:
    import torch
    from repro_torch.kernels import decode_attention as da
    worst = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for label, B, Sk, H, KV, hd, q_pos, ring, window in DECODE_CASES:
            args = decode_inputs(gen, dtype, device, B, Sk, H, KV, hd,
                                 q_pos, ring)
            got = da.decode_attention(*args, window=window)
            want = da.decode_attention_plain(*args, window=window)
            torch.cuda.synchronize()
            e = check_kernel(f"decode_attention {dname} {label} "
                             f"{(B, Sk, H, KV, hd)} window {window}", got,
                             want, dname)
            worst[(dname, label)] = e
    return worst


# row 3 with its log-sum-exp, as a rank runs it on its slots of a
# sequence-sharded cache (``spmd.merged_cache_shards``): (label, B, Sk,
# H, KV, hd, the first slot's position, q_pos); the slots hold
# consecutive positions from the first, and a row whose q_pos is below
# them has no valid slot here (o 0, lse -inf). The kernels phase checks
# these q_pos; the timing phase puts every row at the largest, as in a
# decode step, where every row sees every slot of the shard
DECODE_LSE_CASES = [
    ("long_500k's 4,096-slot ring, a rank's 2,048 slots on the card", 1,
     2048, 16, 8, 128, 2048, [4607]),
    ("opt decode_32k at 16x16, a rank's 2,048 of 32,768 slots", 8, 2048,
     16, 8, 128, 30720, [32767] * 6 + [31000, 30000]),
]


def decode_lse_inputs(gen, dtype, device, B, Sk, H, KV, hd, first, q_pos):
    import torch
    q = rand(gen, (B, 1, H, hd), dtype, device)
    k = rand(gen, (B, Sk, KV, hd), dtype, device)
    v = rand(gen, (B, Sk, KV, hd), dtype, device)
    kv_pos = (first + torch.arange(Sk, dtype=torch.int32))[None].repeat(B, 1)
    return (q, k, v, torch.tensor(q_pos, dtype=torch.int32, device=device),
            kv_pos.to(device))


def decode_lse_cases(device, gen) -> dict:
    """Row 3 with ``return_lse`` at ``DECODE_LSE_CASES`` in both dtypes:
    o as ``check_kernel`` holds it, the lse within ``LSE_ATOL`` where
    finite and -inf exactly where the plain version's is; o equal, bit
    for bit, to the launch without the lse."""
    import torch
    from repro_torch.kernels import decode_attention as da
    worst = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for label, B, Sk, H, KV, hd, first, q_pos in DECODE_LSE_CASES:
            args = decode_lse_inputs(gen, dtype, device, B, Sk, H, KV, hd,
                                     first, q_pos)
            o, lse = da.decode_attention(*args, return_lse=True)
            o2, lse2 = da.decode_attention_plain(*args, return_lse=True)
            plain_o = da.decode_attention(*args)
            torch.cuda.synchronize()
            tag = f"decode_attention return_lse {dname} {label} " \
                f"{(B, Sk, H, KV, hd)}"
            worst[(dname, f"{label}, return_lse")] = check_kernel(
                f"{tag} o", o, o2, dname)
            empty = torch.isneginf(lse2)
            if not torch.equal(torch.isneginf(lse), empty):
                fail(f"{tag}: lse is -inf at {torch.isneginf(lse).sum()} "
                     f"(row, head)s, the plain version at {empty.sum()}")
            check_close(f"{tag} lse ({int(empty.sum())} -inf)", lse[~empty],
                        lse2[~empty], LSE_ATOL, 0.0)
            if not torch.equal(o, plain_o):
                fail(f"{tag}: o differs from the launch without the lse")
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
    # the vlm and audio training layouts: whisper's encoder and its
    # decoder's cross-attention (the memory's gradient), vision's cross
    ("whisper encoder", 2, 1500, 1500, 8, 8, 64, False, 0, False),
    ("whisper cross", 2, 128, 1500, 8, 8, 64, False, 0, False),
    ("vision cross", 1, 128, 1601, 64, 8, 128, False, 0, False),
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
        for (label, B, Sq, Sk, H, KV, hd, causal, window,
             fused) in BWD_CASES:
            args = bwd_inputs(gen, dtype, device, B, Sq, Sk, H, KV, hd,
                              causal, window, fused)
            kw = dict(causal=causal, window=window)
            got = fab.flash_attention_bwd(*args, **kw)
            want = fab.flash_attention_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            tag = f"{dname} {label} {(B, Sq, Sk, H, KV, hd)} {kw}"
            e = [check_kernel(f"flash_attention_bwd {n} {tag}", g, w, dname)
                 for n, g, w in zip(("dq", "dk", "dv"), got, want)]
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
        for label, B, T, H, hd, N, dts in SSM_CASES:
            args = ssm_inputs(gen, dtype, device, B, T, H, hd, N, dts)
            y, h = ss.ssm_scan(*args)
            y2, h2 = ss.ssm_scan_plain(*args)
            torch.cuda.synchronize()
            tag = f"{dname} {label} {(B, T, H, hd, N)} dt x{dts:g}"
            worst["ssm_scan"][(dname, label, T)] = max(
                check_kernel(f"ssm_scan y {tag}", y, y2, dname),
                check_kernel(f"ssm_scan state {tag}", h, h2, dname))
        for label, B, T, H, hd, w in WKV_CASES:
            args = wkv_inputs(gen, dtype, device, B, T, H, hd, w)
            o, st = wk.wkv6_scan(*args)
            o2, st2 = wk.wkv6_scan_plain(*args)
            torch.cuda.synchronize()
            tag = f"{dname} {label} {(B, T, H, hd)} w {w or 'random'}"
            worst["wkv6_scan"][(dname, label, T)] = max(
                check_kernel(f"wkv6_scan o {tag}", o, o2, dname),
                check_kernel(f"wkv6_scan state {tag}", st, st2, dname))
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
    for case in CROSS_DECODE_TIMED:
        out[f"flash_attention_lse {case[0]}"] = time_cross_decode(
            device, gen, case)
    out["decode_attention"] = time_decode(device, gen)
    out.update(time_decode_lse(device, gen))
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


def time_cross_decode(device, gen, case) -> dict:
    """Row 2 at a cross-attention decode shape (Sq = 1, non-causal, bf16),
    L2 cold: 8 copies of the inputs in turn, as a decode step finds each
    layer's memory k/v. Bound: q, k, v, o in bf16 and the lse once, 4 hd
    FLOPs per (head, k) pair. Library: one SDPA call on the same inputs
    (no mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    label, B, Sq, Sk, H, KV, hd = case[:7]
    copies = [attention_inputs(gen, torch.bfloat16, device, B, Sq, Sk, H,
                               KV, hd, False) for _ in range(8)]
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * 2 \
        + B * H * Sq * 4
    flops = 4.0 * hd * H * B * Sq * Sk
    bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
    lib = [tuple(t.transpose(1, 2) for t in c) for c in copies]
    run = rotating(lambda q, k, v: fa.flash_attention_lse(q, k, v,
                                                          causal=False),
                   copies)
    ms, host_ms = time_ms(run)
    r = {"ms": ms, "host_ms": host_ms,
         "library_ms": time_ms(rotating(
             lambda q, k, v: F.scaled_dot_product_attention(
                 q, k, v, enable_gqa=True), lib))[0],
         "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops,
         "shape": (B, Sq, Sk, H, KV, hd)}
    print(f"  flash_attention_lse bf16 {label} {r['shape']}: kernel "
          f"{ms:.4f} ms (host {host_ms:.4f} ms per call), library (SDPA) "
          f"{r['library_ms']:.4f} ms, {ms / r['library_ms']:.2f}x SDPA; "
          f"bound {bms:.4f} ms ({by}: {nbytes} B, {flops:.3e} FLOP), "
          f"{100 * bms / ms:.1f}% of it; L2 cold: 8 input copies in turn; "
          "device times")
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


def time_decode_lse(device, gen) -> dict:
    """Row 3 with ``return_lse`` at ``DECODE_LSE_CASES``' shapes (bf16),
    every row at the case's largest q_pos (no masked row: a step's rows
    all see the whole shard), L2 cold as ``time_decode``: beside the
    same launch without the lse, its plain version and SDPA with the (B,
    H, 1, Sk) mask (SDPA returns no lse). The bound counts the lse's B H
    fp32 values written too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import _mask

    out = {}
    for label, B, Sk, H, KV, hd, first, q_pos in DECODE_LSE_CASES:
        copies = [decode_lse_inputs(gen, torch.bfloat16, device, B, Sk, H,
                                    KV, hd, first, [max(q_pos)] * B)
                  for _ in range(8 if B > 1 else 16)]
        q, k, v, qp, kp = copies[0]
        mask = _mask(qp[:, None], kp, causal=True, window=0)
        pairs = int(mask.sum().item()) * H
        nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + qp.numel() * 4 \
            + kp.numel() * 4 + B * H * 4
        flops = 4.0 * hd * pairs
        bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
        lib = [(c[0].transpose(1, 2), c[1].transpose(1, 2),
                c[2].transpose(1, 2),
                _mask(c[3][:, None], c[4], causal=True,
                      window=0)[:, None].expand(B, H, 1, Sk))
               for c in copies]
        ms, host_ms = time_ms(rotating(
            lambda *a: da.decode_attention(*a, return_lse=True), copies))
        r = {"ms": ms, "host_ms": host_ms,
             "no_lse_ms": time_ms(rotating(da.decode_attention, copies))[0],
             "plain_ms": time_ms(rotating(
                 lambda *a: da.decode_attention_plain(*a, return_lse=True),
                 copies))[0],
             "library_ms": time_ms(rotating(
                 lambda qt, kt, vt, m: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=m, enable_gqa=True), lib))[0],
             "bound_ms": bms, "bound_by": by, "bytes": nbytes,
             "flops": flops, "shape": (B, Sk, H, KV, hd)}
        print(f"  decode_attention return_lse bf16 {label} {r['shape']}, "
              f"every row at q_pos {max(q_pos)}: kernel {ms:.4f} ms (host "
              f"{host_ms:.4f} ms per call), "
              f"without the lse {r['no_lse_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (SDPA, boolean mask, no "
              f"lse) {r['library_ms']:.4f} ms, {ms / r['library_ms']:.2f}x "
              f"SDPA; bound {bms:.4f} ms ({by}: {nbytes} B, {flops:.3e} "
              f"FLOP over {pairs} valid (head, slot) pairs), "
              f"{100 * bms / ms:.1f}% of it; L2 cold; device times")
        out[f"decode_attention return_lse {label}"] = r
    return out


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

def make_wave(cfg, frags, rng, *, lo=128, hi=512, n_long=0, exact=False,
              extras=None):
    """One request per fragment with lo..hi prompt tokens; the first
    ``n_long`` prompts are longer than 1024 tokens (up to ``hi``). With
    ``exact``, the prompts instead take the distinct lengths of
    ``EXACT_LENGTHS`` in a random order: every pool then runs each
    request alone at its own length, the monolithic forward's shapes.
    ``extras()``, if given, makes each request's extras."""
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
                                  .astype(np.int32),
                                  extras=extras() if extras else None),
                     f.p))
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
    kernels and each attention kernel. Kernels launched inside a
    ``moe_forward`` call (the router, the sort, the gathers and
    scatters, the expert products) form the "moe" group, whatever their
    name. Returns the device time in µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            moe_calls(moe_ranged):
        wall = run()
    groups = {"attention kernels": 0.0, "scan kernels": 0.0, "moe": 0.0,
              "matmul": 0.0, "memcpy/memset": 0.0, "other kernels": 0.0}
    in_moe = moe_kernel_us(prof)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        name = ev.key
        if name == MOE_RANGE:       # the range's span on the device's
            continue                # timeline, not a kernel
        low = name.lower()
        moe_us = min(us, in_moe.get(name, 0.0))
        if moe_us > 0:
            groups["moe"] += moe_us
            rows.append((moe_us, name, "moe"))
            us -= moe_us
        if us <= 0:
            continue
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
    for us, name, _ in sorted(r for r in rows if r[2] == "moe")[::-1][:5]:
        print(f"    moe: {us / 1e3:.2f} ms {name[:90]}")
    return total


def moe_kernel_us(prof) -> dict:
    """Device µs by kernel name of the kernels launched inside a
    ``MOE_RANGE`` (an op whose chain of CPU parents holds the range)."""
    out: dict = {}
    for ev in prof.events():
        if not ev.kernels:
            continue
        a = ev
        while a is not None and a.name != MOE_RANGE:
            a = a.cpu_parent
        if a is not None:
            for k in ev.kernels:
                out[k.name] = out.get(k.name, 0.0) + float(k.duration)
    return out


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


def serve_phase(device, arch="qwen3-1.7b", *, need, seed=0, lo=128, hi=512,
                n_long=0, exact=False, after_fp32=None, n_layers=None,
                dispatches=(("", None, None),), extras=None, prepare=None,
                after_bf16=None) -> dict:
    """Serve one model's path at full width (``n_layers`` cuts its
    depth); returns the kernels' launch counts over the float32 waves.
    ``need`` names the kernels that must have launched there; ``exact``
    gives the float32 waves ``EXACT_LENGTHS`` prompts (the bfloat16
    waves keep lo..hi with ``n_long`` long ones); ``after_fp32(cfg,
    params)`` runs further float32 checks before the float32 model is
    freed. ``dispatches`` are (label, edit, need) triples: each serves
    its own two float32 waves with the config ``edit(cfg)`` (None: as
    published) on the same weights (a moe dispatch or capacity, which
    the weights do not depend on), where the kernels ``need`` (None:
    the phase's) must launch. The bfloat16 waves serve the config as
    published; for a moe model the warm-up wave counts each layer's
    dropped tokens. ``extras(cfg, params, gen)`` makes one request's
    extras (a vlm or audio model's), ``gen`` a generator on the card
    seeded from ``seed``; ``prepare(cfg, params)`` edits each model's
    weights after its init; ``after_bf16(cfg, params)`` runs after the
    bfloat16 waves."""
    import numpy as np
    import torch
    from repro_torch.core import Fragment
    from repro_torch.models import n_fragment_units
    from repro_torch.serving.smoke import smoke_setup

    def bind(c, p):
        if extras is None:
            return None
        gen = torch.Generator(device=device).manual_seed(seed)
        return lambda: extras(c, p, gen)

    t0 = time.perf_counter()
    cfg, book, params = smoke_setup(arch, full_width=True, dtype="float32",
                                    seq_len=512, n_layers=n_layers,
                                    device=device)
    if prepare is not None:
        prepare(cfg, params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in named_leaves(params).values())
    print(f"  {cfg.name} ({cfg.family}): {n_params / 1e9:.3f}B params, "
          f"d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, head_dim "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.n_layers} layers, window {cfg.sliding_window}, {cfg.dtype}"
          f"{moe_text(cfg)}; init {time.perf_counter() - t0:.1f} s")
    L = n_fragment_units(cfg)
    rng = np.random.RandomState(seed)
    points = sorted(int(p) for p in rng.choice(L, size=6, replace=L < 6))
    frags = [Fragment(cfg.name, p=p, t=float(40.0 + 40.0 * rng.rand()),
                      q=30.0, client=f"c{i}") for i, p in enumerate(points)]
    print(f"  clients' partition points: {points}")
    s = L // 2
    frags2 = [Fragment(cfg.name, min(f.p, s), f.t, f.q, client=f.client)
              for f in frags]
    wave = dict(lo=lo, hi=hi, n_long=n_long)
    wave32 = dict(wave, exact=exact, extras=bind(cfg, params))
    launches: dict = {}
    for label, edit, v_need in dispatches:
        c = cfg if edit is None else edit(cfg)
        if label:
            print(f"  float32 waves, {label}{moe_text(c)}")
        got = serve_fp32_waves(c, book, params, frags, frags2, s, rng,
                               wave32, device)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        if not all(got[n] > 0 for n in v_need or need):
            fail(f"a kernel of the serving path never launched: {got}")
    if after_fp32 is not None:
        after_fp32(cfg, params)
    del params, wave32                  # the extras closure holds params
    free_device()

    # the same path in bfloat16, timed (a warm-up wave first)
    cfg16, _, params16 = smoke_setup(arch, full_width=True,
                                     dtype="bfloat16", seq_len=512,
                                     n_layers=n_layers, device=device)
    if prepare is not None:
        prepare(cfg16, params16)
    serve_bf16_waves(cfg16, book, params16, frags2, s, rng,
                     dict(wave, extras=bind(cfg16, params16)), device)
    if after_bf16 is not None:
        after_bf16(cfg16, params16)
    return launches


def serve_fp32_waves(cfg, book, params, frags, frags2, s, rng, wave32,
                     device) -> dict:
    """The planner's plan for ``frags``, then ``apply_plan`` onto
    re-aligned depth-2 chains cut at ``s`` for ``frags2``: a wave on
    each, every result held against the monolithic forward. Returns the
    kernels' launch counts over the two waves (the main path)."""
    import torch
    from repro_torch.core import GraftPlanner
    from repro_torch.serving import GraftExecutor, InProcessTransport
    from repro_torch.serving.smoke import mixed_depth_plan
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
    if not any(len(c) == 2 for c in chains.values()):
        fail("the re-aligned plan has no depth-2 chain")
    check_results(cfg, params, reqs1, "wave 1")
    check_results(cfg, params, reqs2, "wave 2")
    return launches


def serve_bf16_waves(cfg, book, params, frags2, s, rng, wave,
                     device) -> None:
    """The re-aligned plan in bfloat16: a warm-up wave (for a moe model
    under a hook that counts each layer's dropped tokens), a timed wave,
    and a wave under ``torch.profiler``."""
    import torch
    from repro_torch.serving import GraftExecutor, InProcessTransport
    from repro_torch.serving.smoke import mixed_depth_plan
    reset_launches()
    drops: dict = {}
    counting = moe_calls(drop_counter(params, drops)) \
        if cfg.family == "moe" else contextlib.nullcontext()
    with GraftExecutor(mixed_depth_plan(cfg, book, frags2, s=s, batch=8),
                       params, cfg,
                       InProcessTransport(max_frame_bytes=MAX_FRAME_BYTES),
                       device=device) as ex:
        with counting:
            serve_wave(ex, make_wave(cfg, frags2, rng, **wave),
                       "bf16 warm-up wave")
        reqs3 = make_wave(cfg, frags2, rng, **wave)
        serve_wave(ex, reqs3, "bf16 wave")
        reqs4 = make_wave(cfg, frags2, rng, **wave)
        profile_run("bf16 profiled wave",
                    lambda: serve_wave(ex, reqs4, "bf16 profiled wave"))
    print(f"  kernel launches, bf16 waves: {read_launches()}")
    if drops:
        print_drops(drops, "bf16 warm-up wave")
    for req, _ in reqs3:
        if not torch.isfinite(req.result.float()).all():
            fail(f"bf16 wave: {req.client} result is not finite")


# ---------------------------------------------------------------------------
# the moe family: hooks on the port's moe_forward, and the block check
# ---------------------------------------------------------------------------

# the profiler range each moe_forward call runs under in a profiled run
MOE_RANGE = "moe_forward"
# block inputs for the grouped-against-dense check: one prompt this long
MOE_BLOCK_TOKENS = 512


def moe_text(cfg) -> str:
    """A moe config's routing, dispatch and capacity, for the log."""
    if cfg.family != "moe":
        return ""
    e = cfg.moe
    return (f"; {e.n_experts} experts, top {e.top_k}, "
            f"{e.n_shared_experts} shared, d_ff_expert {e.d_ff_expert}, "
            f"{cfg.moe_impl} dispatch, capacity factor {e.capacity_factor:g}")


@contextlib.contextmanager
def moe_calls(hook):
    """Send every call of the port's ``moe_forward`` (the blocks of the
    forward, the fragments, prefill and decode) through ``hook(inner,
    p, cfg, x, **kw)`` inside the block."""
    import functools
    from repro_torch.models import moe as moe_mod
    inner = moe_mod.moe_forward
    moe_mod.moe_forward = functools.partial(hook, inner)
    try:
        yield
    finally:
        moe_mod.moe_forward = inner


def moe_ranged(inner, p, cfg, x, **kw):
    """A ``moe_calls`` hook: the call under the ``MOE_RANGE`` profiler
    range, so ``profile_run`` can tell its kernels (the sort, the
    gathers and scatters, the expert products) from the rest."""
    import torch
    with torch.profiler.record_function(MOE_RANGE):
        return inner(p, cfg, x, **kw)


def drop_counter(params, drops: dict):
    """A ``moe_calls`` hook adding each call's dropped and routed (token,
    choice) pairs to ``drops[layer]``, the layer told by where its
    router view lies in the stacked router tensor."""
    from repro_torch.models import moe as moe_mod
    routers = params["blocks"]["moe"]["router"]
    base = routers.data_ptr()
    step = routers.stride(0) * routers.element_size()

    def hook(inner, p, cfg, x, **kw):
        layer = (p["router"].data_ptr() - base) // step
        _, eidx, _ = moe_mod._route(p, cfg, x.reshape(-1, x.shape[-1]))
        keep = moe_mod.dispatch(cfg, eidx)[2]
        d, n = drops.get(layer, (0, 0))
        drops[layer] = (d + int((~keep).sum()), n + keep.numel())
        return inner(p, cfg, x, **kw)
    return hook


def print_drops(drops: dict, label) -> None:
    per = [drops[k] for k in sorted(drops)]
    d, n = sum(a for a, _ in per), sum(b for _, b in per)
    print(f"  {label}: dropped (token, choice) pairs per layer (pads "
          f"included) {[a for a, _ in per]} of {[b for _, b in per]} routed"
          f" ({d} of {n}, {100 * d / max(n, 1):.2f}%)")


def dropless_capacity(cfg):
    """``cfg`` at capacity factor E / k: the capacity is then N, every
    expert's load fits, and the grouped dispatch drops nothing."""
    import dataclasses
    e = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k))


def moe_block_check(cfg, params) -> None:
    """Every layer's MoE on real block inputs (a forward of one prompt
    at a dropless capacity, factor E / k, so capacity = N): the grouped
    dispatch against the dense one, then how many of the same routes
    the published capacity factor would drop."""
    import numpy as np
    import torch
    from repro_torch.models import forward
    from repro_torch.models import moe as moe_mod
    e = cfg.moe
    wide = dropless_capacity(cfg)
    dev = params["embed"].device
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (1, MOE_BLOCK_TOKENS)).astype(np.int32)).to(dev)
    seen = []

    def capture(inner, p, c, x, **kw):
        seen.append((p, x))
        return inner(p, c, x, **kw)
    with moe_calls(capture):
        forward(params, wide, toks)
    worst, margin, drops = 0.0, float("inf"), []
    for p, x in seen:
        yg, ag = moe_mod.moe_forward(p, wide, x, impl="grouped")
        yd, ad = moe_mod.moe_forward(p, wide, x, impl="dense")
        if not torch.allclose(yg, yd, atol=SERVE_ATOL, rtol=SERVE_RTOL) \
                or float(ag) != float(ad):
            e_, r_ = err(yg, yd)
            fail(f"moe grouped vs dense, layer {len(drops)}: max_abs "
                 f"{e_:.3e} max_rel {r_:.3e}, aux {float(ag)} vs "
                 f"{float(ad)}")
        worst = max(worst, err(yg, yd)[0])
        _, eidx, probs = moe_mod._route(p, cfg, x.reshape(-1, x.shape[-1]))
        top = torch.sort(probs, dim=-1, descending=True).values
        margin = min(margin, float((top[:, e.top_k - 1]
                                    - top[:, e.top_k]).min()))
        drops.append(int((~moe_mod.dispatch(cfg, eidx)[2]).sum()))
    n = MOE_BLOCK_TOKENS * e.top_k
    print(f"  moe blocks: {len(seen)} layers at {MOE_BLOCK_TOKENS} tokens, "
          f"capacity {moe_mod.capacity(wide, MOE_BLOCK_TOKENS)} (dropless): "
          f"grouped equals dense (atol {SERVE_ATOL:g}, rtol {SERVE_RTOL:g}; "
          f"largest |diff| {worst:.3e}), the aux loss exactly; smallest "
          f"k-th minus (k+1)-th router probability {margin:.3e}")
    print(f"  at the published capacity factor {e.capacity_factor:g} "
          f"(capacity {moe_mod.capacity(cfg, MOE_BLOCK_TOKENS)}) the same "
          f"routes drop {drops} of {n} (token, choice) pairs per layer")


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
            want = forward(head, cut, toks)[0][0]
            got = run_fragment(head, cut, batch, 0, d)[rows // 2, :S]
            diff = (got - want).abs()
            ratio = float((diff / (SERVE_ATOL + SERVE_RTOL
                                   * want.abs())).max())
            print(f"  rounding, {d} of {cfg.n_layers} layers: padded batch "
                  f"vs alone, max |diff| {float(diff.max()):.3e}, worst "
                  f"|diff| / tolerance {ratio:.3f} (logit std "
                  f"{float(want.std()):.3f})")
    return run


def moe_phase(device) -> list:
    """olmoe-1b-7b at full width, then llama4-scout at its published
    widths cut to 2 of 48 layers; returns the launch counts of each
    float32 path: olmoe's serve waves (dense, then dropless grouped
    dispatch), its decode runs, llama4's serve waves."""
    import dataclasses

    def dense(cfg):
        return dataclasses.replace(cfg, moe_impl="dense")
    # the dense dispatch packs (row 1 on the pools); the grouped one
    # takes the padded path (row 2 on the pools); row 2 also runs every
    # client's mobile part [0, p)
    dispatches = (("dense dispatch (packed)", dense,
                   ("flash_attention", "flash_attention_lse")),
                  ("grouped dispatch, dropless capacity (padded)",
                   dropless_capacity, ("flash_attention_lse",)))
    runs = []
    t0 = time.perf_counter()
    runs.append(serve_phase(device, "olmoe-1b-7b", seed=4, need=(),
                            n_layers=MOE_OLMOE_SERVE_LAYERS,
                            dispatches=dispatches,
                            after_fp32=moe_block_check))
    free_device()
    runs.append(decode_phase(device, "olmoe-1b-7b"))
    print(f"  olmoe-1b-7b: {time.perf_counter() - t0:.1f} s")
    free_device()
    t0 = time.perf_counter()
    runs.append(serve_phase(device, "llama4-scout-17b-a16e", seed=5,
                            n_layers=MOE_LLAMA4_LAYERS, need=(),
                            lo=MOE_LLAMA4_PROMPTS[0],
                            hi=MOE_LLAMA4_PROMPTS[1],
                            dispatches=dispatches,
                            after_fp32=moe_block_check))
    print(f"  llama4-scout-17b-a16e ({MOE_LLAMA4_LAYERS} of 48 layers): "
          f"{time.perf_counter() - t0:.1f} s")
    return runs


# llama4-scout's depth on the card: 2 of its 48 layers at the published
# widths are 26 GB in float32 (its 107.8B parameters do not fit); its
# waves' prompts are 64..256 tokens, since each served token brings
# 202,048 logits back to the host
MOE_LLAMA4_LAYERS = 2
MOE_LLAMA4_PROMPTS = (64, 256)
# olmoe's serve waves run 8 of its 16 layers (full width); its decode
# streams here and the ep phase run all 16
MOE_OLMOE_SERVE_LAYERS = 8


# ---------------------------------------------------------------------------
# phase ep: expert-parallel olmoe over ranks sharing the card
# ---------------------------------------------------------------------------

EP_ARCH = "olmoe-1b-7b"
EP_RANKS = 4
EP_BATCH, EP_SEQ = 2, 512
EP_SEED = 11
# the float32 check's depth: 2 of olmoe's 16 layers at full width
EP_FP32_LAYERS = 2
# every rank's join; the phase takes well under this
EP_TIMEOUT_S = 400
EP_DIR = os.path.join(HERE, "build", "ep")


def ep_configs():
    """(the bf16 model, the fp32 check's model): olmoe-1b-7b at its
    published widths and depth with the expert-parallel dispatch, and
    the same cut to ``EP_FP32_LAYERS`` layers in float32."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(EP_ARCH), dtype="bfloat16",
                              moe_impl="expert_parallel")
    return cfg, dataclasses.replace(cfg, dtype="float32",
                                    n_layers=EP_FP32_LAYERS)


def ep_tokens(cfg, seed):
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randint(0, cfg.vocab_size, (
        EP_BATCH, EP_SEQ)).astype(np.int32)) for _ in range(2))


def ep_sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_all_reduce(device, log: list):
    """Append (bytes, dtype, device ms, host ms) of each
    ``torch.distributed.all_reduce`` in the block to ``log`` (device ms
    by CUDA events around the call on a card, None on the CPU)."""
    import torch
    import torch.distributed as dist
    inner = dist.all_reduce
    marks = []

    def timed(t, *a, **kw):
        ev = None
        if device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        h = time.perf_counter()
        out = inner(t, *a, **kw)
        h = time.perf_counter() - h
        if ev is not None:
            ev[1].record()
        marks.append((t.numel() * t.element_size(), str(t.dtype), ev,
                      h * 1e3))
        return out
    dist.all_reduce = timed
    try:
        yield
    finally:
        dist.all_reduce = inner
        ep_sync(device)
        log.extend((b, dt, ev[0].elapsed_time(ev[1]) if ev else None, h)
                   for b, dt, ev, h in marks)


def ep_rank(rank, n, cfg, cfg32, device_type, out_dir) -> None:
    """One of ``n`` ranks sharing the card (``ep_phase``): olmoe with
    only its ``1/n`` of every layer's experts, under ``moe_mesh`` on
    ``to_device_mesh(make_host_mesh(model=n))``. The bf16 model is built
    one rank at a time (a whole model is built, then cut to the rank's
    experts and the rest freed, before the next rank builds); its
    forward of the prompt batch runs twice (the first counted: the main
    path; the second timed, each combine's ``all_reduce`` by CUDA
    events); rank 0 saves the logits. Then the fp32 check at
    ``cfg32``'s depth: ``lm_loss`` and its gradients with ``grouped``
    and the whole model, then through the expert-parallel path; the
    logits, the loss, the router's and embedding's gradients and the
    rank's expert slice of each layer held against grouped's. Writes
    ``rank{rank}.json``: launches, combine log, walls, peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import actspec
    from repro_torch.distributed.sharding import to_device_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import forward, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.training.train_step import lm_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dm = to_device_mesh(make_host_mesh(model=n), device_type)
    rep = {"rank": rank}

    def own_experts(params):
        blocks = params["blocks"]
        params["blocks"] = dict(blocks, moe=moe_mod.shard_experts(
            blocks["moe"], rank, n))
        del blocks
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return params

    toks, labels = (t.to(device) for t in ep_tokens(cfg, EP_SEED))
    t0 = time.perf_counter()
    for turn in range(n):
        if turn == rank:
            params = own_experts(init_params(cfg, seed=EP_SEED,
                                             device=device))
            ep_sync(device)
        dist.barrier()
    rep["init_s"] = time.perf_counter() - t0
    rep["expert_bytes"] = sum(
        v.numel() * v.element_size() for k, v in
        params["blocks"]["moe"].items() if k in moe_mod.EXPERT_KEYS)
    rep["param_bytes"] = sum(
        v.numel() * v.element_size() for v in named_leaves(params).values())
    with torch.no_grad(), actspec.moe_mesh(dm):
        reset_launches()
        logits, _ = forward(params, cfg, toks)
        ep_sync(device)
        rep["launches_bf16"] = read_launches()
        dist.barrier()
        log = []
        with timed_all_reduce(device, log):
            t = time.perf_counter()
            logits2, _ = forward(params, cfg, toks)
            ep_sync(device)
            rep["wall_s"] = time.perf_counter() - t
        rep["combine"] = log
        if not torch.equal(logits, logits2):
            raise RuntimeError(f"rank {rank}: two forwards of one batch "
                               "differ")
    if rank == 0:
        torch.save(logits.cpu(), os.path.join(out_dir, "logits.pt"))
    if device.type == "cuda":
        rep["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del params, logits, logits2
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()

    # float32 at cfg32's depth: grouped with the whole model first
    want = {}
    grouped = dataclasses.replace(cfg32, moe_impl="grouped")
    params = init_params(cfg32, seed=EP_SEED, device=device)
    with torch.no_grad():
        want["logits"] = forward(params, grouped, toks)[0]
    for v in named_leaves(params).values():
        v.requires_grad_(True)
    loss, _ = lm_loss(params, grouped, toks, labels)
    loss.backward()
    want["loss"] = float(loss.detach())
    m = cfg32.moe.n_experts // n
    for k, v in named_leaves(params).items():
        if k.startswith("blocks/moe/w_"):
            want[k] = v.grad[:, rank * m:(rank + 1) * m].clone()
        elif k in ("embed", "blocks/moe/router"):
            want[k] = v.grad
    del params, loss, v
    gc.collect()
    params = own_experts(init_params(cfg32, seed=EP_SEED, device=device))
    dist.barrier()
    with actspec.moe_mesh(dm):
        with torch.no_grad():
            got = forward(params, cfg32, toks)[0]
        for v in named_leaves(params).values():
            v.requires_grad_(True)
        reset_launches()
        loss, _ = lm_loss(params, cfg32, toks, labels)
        loss.backward()
        ep_sync(device)
        rep["launches_fp32"] = read_launches()
    if not torch.allclose(got, want["logits"], atol=SERVE_ATOL,
                          rtol=SERVE_RTOL):
        raise RuntimeError(f"rank {rank}: fp32 logits differ from "
                           f"grouped's: max |diff| {err(got, want['logits'])}")
    rep["fp32_logits_max_abs"] = err(got, want["logits"])[0]
    rep["fp32_loss"] = (float(loss.detach()), want["loss"])
    if abs(rep["fp32_loss"][0] - want["loss"]) > LOSS_RTOL * abs(want["loss"]):
        raise RuntimeError(f"rank {rank}: loss {rep['fp32_loss'][0]} vs "
                           f"grouped's {want['loss']}")
    grads = {k: v.grad for k, v in named_leaves(params).items()
             if k in want}
    rel = {k: rel_l2(g, want[k]) for k, g in grads.items()}
    rep["fp32_grad_rel_l2"] = rel
    if len(rel) != 5 or max(rel.values()) > GRAD_REL_L2:
        raise RuntimeError(f"rank {rank}: gradients against grouped's "
                           f"(relative L2, bound {GRAD_REL_L2:g}): {rel}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)


def ep_phase(device, *, need=("flash_attention_lse",)) -> list:
    """olmoe-1b-7b at full width in bf16 through the expert-parallel
    dispatch over ``EP_RANKS`` gloo ranks sharing the card, held against
    the one-process grouped forward (scaled bf16 check); then the fp32
    logits, loss and gradients at ``EP_FP32_LAYERS`` layers, on each
    rank against its own grouped run (``ep_rank``). Returns the launch
    counts of the two main paths, summed over the ranks: the bf16
    forward and the fp32 loss with its backward."""
    import shutil

    import torch
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.models import forward, init_params
    cfg, cfg32 = ep_configs()
    e = cfg.moe
    print(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.vocab_size} vocab{moe_text(cfg)}; {EP_RANKS} gloo ranks on "
          f"one card, {e.n_experts // EP_RANKS} experts each; prompts "
          f"{EP_BATCH} x {EP_SEQ}")
    shutil.rmtree(EP_DIR, ignore_errors=True)
    os.makedirs(EP_DIR)
    toks, _ = (t.to(device) for t in ep_tokens(cfg, EP_SEED))
    grouped = dataclasses.replace(cfg, moe_impl="grouped")
    t0 = time.perf_counter()
    params = init_params(grouped, seed=EP_SEED, device=device)
    ep_sync(device)
    print(f"  grouped reference: init {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        want, _ = forward(params, grouped, toks)
        ep_sync(device)
        t0 = time.perf_counter()
        forward(params, grouped, toks)
        ep_sync(device)
        grouped_wall = time.perf_counter() - t0
    want = want.cpu()
    del params
    free_device()
    try:
        wall = spawn_ranks(ep_rank, EP_RANKS, cfg, cfg32, device.type,
                           EP_DIR, timeout=EP_TIMEOUT_S)
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException,
            TimeoutError) as e:
        fail(f"ep: a rank failed: {e}")
    reps = []
    for r in range(EP_RANKS):
        with open(os.path.join(EP_DIR, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    print(f"  {EP_RANKS} ranks ran in {wall:.1f} s (spawn, imports and "
          "the builds one rank at a time included)")
    for rep in reps:
        print(f"  rank {rep['rank']}: holds {rep['expert_bytes'] / 1e9:.2f} "
              f"GB of experts, {rep['param_bytes'] / 1e9:.2f} GB of "
              f"parameters, peak {rep.get('peak_bytes', 0) / 1e9:.2f} GB "
              f"allocated; init {rep['init_s']:.2f} s (waits included); "
              f"launches bf16 forward {rep['launches_bf16']}, fp32 loss and "
              f"backward {rep['launches_fp32']}")
    got = torch.load(os.path.join(EP_DIR, "logits.pt"))
    check_scaled(f"ep bf16 logits {tuple(got.shape)} against grouped", got,
                 want, TOL["bfloat16"], 1)
    layers = [[] for _ in range(cfg.n_layers)]
    for rep in reps:
        if len(rep["combine"]) != cfg.n_layers:
            fail(f"rank {rep['rank']}: {len(rep['combine'])} combines in a "
                 f"forward of {cfg.n_layers} moe layers")
        for i, c in enumerate(rep["combine"]):
            layers[i].append(c)
    for i, cs in enumerate(layers):
        dev = [c[2] for c in cs]
        print(f"  combine layer {i}: all_reduce of {cs[0][0]} B "
              f"({cs[0][0] / 2**20:.2f} MiB {cs[0][1]}) per rank; device ms"
              f" {'/'.join('-' if d is None else f'{d:.3f}' for d in dev)}, "
              f"host ms {'/'.join(f'{c[3]:.3f}' for c in cs)} (ranks "
              "0-3; gloo through host memory, not NVLink or NCCL)")
    ep_wall = max(rep["wall_s"] for rep in reps)
    print(f"  bf16 forward of {EP_BATCH} x {EP_SEQ}: expert-parallel over "
          f"{EP_RANKS} ranks on one card {ep_wall * 1e3:.1f} ms (slowest "
          f"rank), grouped in one process {grouped_wall * 1e3:.1f} ms "
          f"({ep_wall / grouped_wall:.2f}x)")
    if device.type == "cuda":
        print(f"  ep figures on: {smi_line()}")
    for rep in reps:
        rel = rep["fp32_grad_rel_l2"]
        print(f"  rank {rep['rank']} fp32 at {cfg32.n_layers} layers: "
              f"logits max |diff| {rep['fp32_logits_max_abs']:.3e} (atol "
              f"{SERVE_ATOL:g}, rtol {SERVE_RTOL:g}), loss "
              f"{rep['fp32_loss'][0]:.6f} vs grouped "
              f"{rep['fp32_loss'][1]:.6f}, gradients' relative L2 "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rel.items()))
              + f" (bound {GRAD_REL_L2:g})")
    runs = [{k: sum(rep[key].get(k, 0) for rep in reps)
             for k in reps[0][key]}
            for key in ("launches_bf16", "launches_fp32")]
    for name in need:
        if not all(rep["launches_bf16"].get(name, 0) for rep in reps):
            fail(f"ep: {name} did not launch on every rank's forward")
    return runs


# ---------------------------------------------------------------------------
# spmd: qwen3-1.7b as DTensors under the sharding rules, 4 ranks on one card
# ---------------------------------------------------------------------------

SPMD_ARCH = "qwen3-1.7b"
SPMD_RANKS = 4
SPMD_BATCH, SPMD_SEQ = 2, 512
SPMD_CACHE = 1024             # decode cache slots
SPMD_NEW = 8                  # greedy decode steps after the prompt
SPMD_TRAIN_LAYERS = 2         # the train check's depth, of 28
SPMD_SEED = 13
# long_500k's decode at batch 1: a prompt past the 4,096-slot ring, so
# the ring has wrapped, then greedy steps against the cache sharded over
# ``data`` (``spmd.attention_shards`` merges the ranks' softmaxes)
SPMD_RING_PROMPT = 4608
SPMD_RING_NEW = 8
SPMD_TIMEOUT_S = 400
SPMD_DIR = os.path.join(HERE, "build", "spmd")


def spmd_mesh():
    """A host's (data 2, model 2) mesh of the 4 ranks."""
    from repro_torch.launch.mesh import MeshShape
    return MeshShape(("data", "model"), (2, 2))


def spmd_shape():
    """The prefill entry's workload at the phase's batch and length."""
    from repro_torch.config import ShapeConfig
    return ShapeConfig("spmd_prefill", SPMD_SEQ, SPMD_BATCH, "prefill")


def spmd_configs():
    """(qwen3-1.7b at its published widths in bf16, the same in fp32)."""
    from repro_torch.configs import get_config
    cfg = get_config(SPMD_ARCH)
    return cfg, dataclasses.replace(cfg, dtype="float32")


def spmd_tokens(cfg):
    """(tokens, labels): two seeded (SPMD_BATCH, SPMD_SEQ) int32 draws."""
    import numpy as np
    import torch
    rs = np.random.RandomState(SPMD_SEED)
    return tuple(torch.from_numpy(rs.randint(0, cfg.vocab_size, (
        SPMD_BATCH, SPMD_SEQ)).astype(np.int32)) for _ in range(2))


def spmd_serve(params, cfg, toks):
    """``prefill`` of ``toks`` into a ``SPMD_CACHE``-slot cache, the
    prompt's next token, then ``SPMD_NEW`` greedy ``decode_step``s: ->
    (the prefill's logits, the (B, 1 + SPMD_NEW) tokens). A DTensor's
    vocabulary is gathered before each argmax (``spmd.whole_dim``)."""
    import torch
    from repro_torch.distributed import spmd
    from repro_torch.models.decode import decode_step, prefill

    def pick(lg):
        return spmd.whole_dim(lg, -1).argmax(-1).to(torch.int32)
    logits, cache = prefill(params, cfg, toks, cache_seq=SPMD_CACHE)
    t = pick(logits[:, -1])
    out = [t]
    for _ in range(SPMD_NEW):
        lg, cache = decode_step(params, cfg, cache, t[:, None])
        t = pick(lg[:, 0])
        out.append(t)
    return logits, torch.stack(out, 1)


def spmd_ring_config(cfg):
    """``cfg`` under long_500k's override: its 4,096-slot decode ring."""
    from repro_torch.configs import SHAPES, shape_for
    return shape_for(cfg, SHAPES["long_500k"])


def spmd_ring_count(cfg32, ms) -> dict:
    """The dry-run's count of one fp32 decode step of long_500k's entry
    (batch 1 against the 4,096-slot ring) on a fake group of ``ms``'s
    ranks under the baseline rules: ``launch/dryrun.py``'s sharded pass
    on the inputs of ``input_specs``, made float32 as the ranks run."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.dryrun import count_collectives
    from repro_torch.launch.specs import entry_fn, input_specs
    shape = SHAPES["long_500k"]
    specs = input_specs(SPMD_ARCH, shape)

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float() if tree.is_floating_point() else tree
    p, cache, tok = f32(specs["params"]), f32(specs["cache"]), \
        specs["tokens"]
    rules = ShardingRules(ms)
    with torch.no_grad():
        return count_collectives(
            entry_fn(spmd_ring_config(cfg32), shape),
            [(p, rules.params_specs(p)), (cache, rules.cache_specs(cache)),
             (tok, rules.batch_specs(tok))], ms, rules, shape, "baseline")


def spmd_ring_decode(params, cfg32, device, path) -> tuple:
    """One process: prefill a seeded ``SPMD_RING_PROMPT``-token prompt
    into long_500k's ring (it wraps), save the cache and the next token
    to ``path`` for the ranks, then ``SPMD_RING_NEW`` greedy steps: ->
    (the (1, 1 + SPMD_RING_NEW) tokens, each step's fp32 logits, each
    step's wall ms)."""
    import numpy as np
    import torch
    from repro_torch.models.decode import decode_step, prefill
    cfg = spmd_ring_config(cfg32)
    rs = np.random.RandomState(SPMD_SEED + 1)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (
        1, SPMD_RING_PROMPT)).astype(np.int32)).to(device)
    logits, cache = prefill(params, cfg, toks)
    t = logits[:, -1].argmax(-1).to(torch.int32)
    del logits
    if cache["k"].shape[2] >= SPMD_RING_PROMPT:
        fail(f"spmd: the ring ({cache['k'].shape[2]} slots) did not wrap")
    torch.save({"cache": {k: v.cpu() for k, v in cache.items()},
                "t": t.cpu()}, path)
    out, lgs, walls = [t], [], []
    for _ in range(SPMD_RING_NEW):
        ep_sync(device)
        w = time.perf_counter()
        lg, cache = decode_step(params, cfg, cache, t[:, None])
        ep_sync(device)
        walls.append((time.perf_counter() - w) * 1e3)
        t = lg[:, 0].argmax(-1).to(torch.int32)
        out.append(t)
        lgs.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1).cpu(), torch.stack(lgs), walls


def spmd_gloo_check(device) -> dict:
    """Each of the four collectives of the dry-run's count through gloo
    on tensors on ``device`` (c10d calls), values checked: a rank that
    gloo refuses fails here, before the model runs."""
    import torch
    import torch.distributed as dist
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(4 * n, dtype=torch.float32, device=device) + 100 * r
    ranks = torch.arange(n, dtype=torch.float32, device=device)
    res = {}
    ag = torch.empty(4 * n * n, device=device)
    dist.all_gather_into_tensor(ag, x)
    want = torch.cat([torch.arange(4 * n, device=device) + 100 * i
                      for i in range(n)])
    res["all-gather"] = bool(torch.equal(ag, want))
    rs = torch.empty(4, device=device)
    dist.reduce_scatter_tensor(rs, x)
    res["reduce-scatter"] = bool(torch.equal(
        rs, n * (torch.arange(4, device=device) + 4 * r) + 100 * ranks.sum()))
    a2a = torch.empty(4 * n, device=device)
    dist.all_to_all_single(a2a, x)
    res["all-to-all"] = bool(torch.equal(a2a, torch.cat([
        torch.arange(4, device=device) + 4 * r + 100 * i
        for i in range(n)])))
    ar = x.clone()
    dist.all_reduce(ar)
    res["all-reduce"] = bool(torch.equal(
        ar, n * torch.arange(4 * n, device=device) + 100 * ranks.sum()))
    if not all(res.values()):
        raise RuntimeError(f"rank {r}: gloo on {device.type} tensors: {res}")
    return res


def spmd_ring_rank(rank, P, cfg32, device, dm, rules, sharded, held,
                   out_dir) -> dict:
    """A rank's fp32 decode against long_500k's ring as the rules place
    it (batch 1: the sequence over ``data``, the heads over ``model``),
    from the one-process cache ``spmd_ring_decode`` saved: each step
    counted (``CollectiveCounter``) and logged (each collective's bytes
    and CUDA-event ms), the collectives inside ``spmd.merge_softmax``
    marked; rank 0 saves the tokens and each step's logits. The first
    call of row 3 (with its lse, on the rank's slots) is held against its
    plain version."""
    import torch
    from repro_torch.distributed import spmd
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models.decode import decode_step
    ring = torch.load(os.path.join(out_dir, "ring.pt"), map_location=device)
    C = spmd.distribute_tree(ring["cache"], rules.cache_specs(ring["cache"]),
                             dm)
    t = spmd.distribute_tree(ring["t"], rules.batch_specs(ring["t"]), dm)
    cfg = spmd_ring_config(cfg32)
    log, spans, steps, dec = [], [], [], {}
    merge = spmd.merge_softmax

    def merge_logged(*a, **kw):
        n0 = len(log)
        o = merge(*a, **kw)
        spans.append((n0, len(log)))
        return o
    spmd.merge_softmax = merge_logged
    new, lgs = [t], []
    try:
        with torch.no_grad(), sharded(log, act=None), \
                first_call(ops, "decode_attention", dec):
            reset_launches()
            for _ in range(SPMD_RING_NEW):
                ep_sync(device)
                n0, m0, w = len(log), len(spans), time.perf_counter()
                with spmd.CollectiveCounter() as cc:
                    lg, C = decode_step(P, cfg, C, t[:, None])
                ep_sync(device)
                wall = time.perf_counter() - w
                steps.append({"collectives": cc.record(), "wall_ms":
                              wall * 1e3, "log": (n0, len(log)),
                              "merge": spans[m0:]})
                lg = spmd.whole_dim(lg[:, 0], -1)
                t = lg.argmax(-1).to(torch.int32)
                new.append(t)
                lgs.append(lg.full_tensor().float().cpu())
            ep_sync(device)
            launches = read_launches()
            new = torch.stack([x.full_tensor() for x in new], 1).cpu()
    finally:
        spmd.merge_softmax = merge
    timed = [(b, ev[0].elapsed_time(ev[1])) for _, b, ev, _ in log]
    for st in steps:
        a, b = st.pop("log")
        st["bytes_logged"] = sum(x[0] for x in timed[a:b])
        st["ms"] = sum(x[1] for x in timed[a:b])
        mg = [i for lo, hi in st.pop("merge") for i in range(lo, hi)]
        st["merge_bytes"] = sum(timed[i][0] for i in mg)
        st["merge_ms"] = sum(timed[i][1] for i in mg)
    ql, kl, vl, qp, kp = dec["args"]
    o2, lse2 = da.decode_attention_plain(ql, kl, vl, qp, kp, **dec["kw"])
    held("decode_attention", dec["out"][0], o2, "long_500k decode")
    finite = ~torch.isinf(lse2)
    if not torch.equal(finite, ~torch.isinf(dec["out"][1])):
        raise RuntimeError(f"rank {rank}: row 3's lse is -inf elsewhere "
                           "than its plain version's")
    check_close(f"rank {rank} decode_attention lse on its ring slots",
                dec["out"][1][finite], lse2[finite], LSE_ATOL, 0.0)
    if rank == 0:
        torch.save({"new": new, "logits": torch.stack(lgs)},
                   os.path.join(out_dir, "ring_fp32.pt"))
    return {"ring_steps": steps, "launches_ring": launches,
            "ring_shards": [list(ql.shape), list(kl.shape)],
            "ring_lse_kw": sorted(dec["kw"])}


def spmd_rank(rank, n, cfg, cfg32, device_type, out_dir) -> None:
    """One of the ``n`` ranks of ``spmd_phase``: a cuda ``DeviceMesh``
    (data 2, model 2) over the gloo group, the functional collectives
    routed to gloo's c10d calls (``spmd.gloo_cuda_collectives``), every
    entry run under ``implicit_replication``, the residual constraint
    and the MoE mesh hook, as the dry-run's sharded pass runs it. In
    turn: the fp32 prefill into a 1,024-slot cache and the greedy steps
    (rank 0 saves the logits and tokens); the fp32 loss and gradients at
    ``SPMD_TRAIN_LAYERS`` layers against this rank's own one-process run;
    the bf16 prefill entry counted (collectives, launches), then timed.
    After the fp32 serve, the same placed weights decode long_500k's
    wrapped ring (``spmd_ring_rank``). The first call of rows 2, 3, 4
    and 5 on each path is held against its plain version on the same
    local shards. Writes ``rank{rank}.json``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import actspec, spmd
    from repro_torch.distributed.sharding import ShardingRules, to_device_mesh
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import entry_fn
    from repro_torch.models import init_params
    from repro_torch.training.train_step import loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dname = "float32"
    rep = {"rank": rank, "gloo": spmd_gloo_check(device)}
    ms = spmd_mesh()
    dm = to_device_mesh(ms, device_type)
    rules = ShardingRules(ms)
    act = (rules.batch_dim_axes(SPMD_BATCH), actspec.UNCONSTRAINED,
           actspec.UNCONSTRAINED)

    @contextlib.contextmanager
    def sharded(log=None, act=act):
        with contextlib.ExitStack() as st:
            if device.type == "cuda":
                st.enter_context(spmd.gloo_cuda_collectives(log))
            st.enter_context(implicit_replication())
            st.enter_context(actspec.residual_spec(act))
            st.enter_context(actspec.moe_mesh(dm))
            yield

    def place(tree, specs):
        return spmd.distribute_tree(tree, specs, dm)

    toks, labels = (t.to(device) for t in spmd_tokens(cfg))
    dtoks, dlabels = (place(t, rules.batch_specs(t)) for t in (toks, labels))
    worst = {}

    def held(name, got, want, case):
        worst.setdefault(name, {})[case] = check_kernel(
            f"rank {rank} {name} on local shards, {case}", got, want, dname)

    # fp32 serve: prefill + greedy steps
    params = init_params(cfg32, seed=SPMD_SEED, device=device)
    P = place(params, rules.params_specs(params))
    fwd, dec = {}, {}
    with torch.no_grad(), sharded(), first_call(fab, "flash_attention_lse",
                                                fwd), \
            first_call(ops, "decode_attention", dec):
        reset_launches()
        t = time.perf_counter()
        logits, new = spmd_serve(P, cfg32, dtoks)
        ep_sync(device)
        rep["serve_s"] = time.perf_counter() - t
        rep["launches_serve"] = read_launches()
        logits, new = logits.full_tensor(), new.full_tensor()
    q, k, v = fwd["args"]
    rep["prefill_shards"] = [list(q.shape), list(k.shape)]
    held("flash_attention_lse", fwd["out"][0],
         fa.flash_attention_lse_plain(q, k, v, **fwd["kw"])[0], "prefill")
    held("decode_attention", dec["out"],
         da.decode_attention_plain(*dec["args"], **dec["kw"]), "decode")
    rep["decode_shards"] = [list(dec["args"][0].shape),
                            list(dec["args"][1].shape)]
    if rank == 0:
        torch.save({"logits": logits.cpu(), "new": new.cpu()},
                   os.path.join(out_dir, "fp32.pt"))
    del params, logits, new, fwd, dec, q, k, v
    free_device()
    rep.update(spmd_ring_rank(rank, P, cfg32, device, dm, rules, sharded,
                              held, out_dir))
    del P
    free_device()
    dist.barrier()

    # fp32 loss and gradients at SPMD_TRAIN_LAYERS layers
    cfg2 = dataclasses.replace(cfg32, n_layers=SPMD_TRAIN_LAYERS)
    params = init_params(cfg2, seed=SPMD_SEED, device=device)
    want_loss, _, want = loss_and_grads(params, cfg2, toks, labels)
    want = named_leaves(want)
    P = place(params, rules.params_specs(params))
    dq, dkv = {}, {}
    with sharded(), first_call(fab, "launch_dq", dq), \
            first_call(fab, "launch_dkv", dkv):
        reset_launches()
        loss, _, grads = loss_and_grads(P, cfg2, dtoks, dlabels)
        ep_sync(device)
        rep["launches_train"] = read_launches()
        loss = loss.full_tensor()
        grads = {k: g.full_tensor() for k, g in named_leaves(grads).items()}
    if device.type == "cuda":
        got_b = fab.flash_attention_bwd_plain(*dq["args"], **dq["kw"])
        held("flash_attention_bwd_dq", dq["out"][0], got_b[0], "train")
        held("flash_attention_bwd_dkv", dkv["out"][0], got_b[1], "train")
        held("flash_attention_bwd_dkv", dkv["out"][1], got_b[2], "train dv")
    rep["loss"] = (float(loss), float(want_loss))
    rep["grad_rel_l2"] = {k: rel_l2(g, want[k]) for k, g in grads.items()}
    rel_loss = abs(rep["loss"][0] - rep["loss"][1]) / abs(rep["loss"][1])
    worst_g = max(rep["grad_rel_l2"].values())
    if rel_loss > GRAD_REL_L2 or worst_g > GRAD_REL_L2 or \
            len(grads) != len(want):
        raise RuntimeError(f"rank {rank}: sharded loss {rep['loss']} and "
                           f"gradients (relative L2, bound {GRAD_REL_L2:g}): "
                           f"{rep['grad_rel_l2']}")
    del params, P, grads, want, loss, dq, dkv
    free_device()
    dist.barrier()

    # bf16 prefill entry at full width: counted, then timed
    params = init_params(cfg, seed=SPMD_SEED, device=device)
    P = place(params, rules.params_specs(params))
    del params
    fn = entry_fn(cfg, spmd_shape())
    with torch.no_grad():
        with sharded(), spmd.CollectiveCounter() as cc:
            reset_launches()
            logits, _ = fn(P, dtoks)
            ep_sync(device)
        rep["launches_bf16"] = read_launches()
        rep["collectives"] = cc.record()
        with sharded():
            logits = logits.full_tensor()
        if rank == 0:
            torch.save(logits.cpu(), os.path.join(out_dir, "bf16.pt"))
        del logits
        dist.barrier()
        log = []
        with sharded(log):
            t = time.perf_counter()
            fn(P, dtoks)
            ep_sync(device)
            rep["wall_s"] = time.perf_counter() - t
        rep["timed"] = [(name, b, ev[0].elapsed_time(ev[1]), h)
                        for name, b, ev, h in log]
    if device.type == "cuda":
        rep["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    rep["worst"] = {k: {c: e for c, e in v.items()} for k, v in worst.items()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)


def spmd_ring_report(reps, want_new, want_logits, one_walls, coll, L,
                     device) -> None:
    """The ranks' long_500k decode against one process's: tokens
    exactly, fp32 logits at the serving tolerance; each rank's every
    step's counted collectives equal to the fake group's count, op by
    op; each step's bytes and ms, the merge's share and the wall beside
    one process's step printed."""
    import torch
    got = torch.load(os.path.join(SPMD_DIR, "ring_fp32.pt"))
    if not torch.equal(got["new"], want_new):
        fail(f"spmd long_500k: greedy tokens {got['new'].tolist()} differ "
             f"from one process's {want_new.tolist()}")
    check_close(f"spmd long_500k decode fp32 logits {tuple(want_logits.shape)}"
                " against one process", got["logits"], want_logits,
                SERVE_ATOL, SERVE_RTOL)
    print(f"  spmd long_500k decode: {SPMD_RING_PROMPT}-token prompt into "
          f"the {L}-layer 4,096-slot ring (wrapped), {SPMD_RING_NEW} steps "
          f"as DTensors, tokens equal to one process's: "
          f"{got['new'].tolist()}; one process's step "
          + ", ".join(f"{w:.1f}" for w in one_walls) + " ms")
    for rep in reps:
        r = rep["rank"]
        for i, st in enumerate(rep["ring_steps"]):
            c = st["collectives"]
            if c["per_op"] != coll["per_op"] or \
                    c["per_op_count"] != coll["per_op_count"]:
                fail(f"spmd rank {r} long_500k step {i}: counted "
                     f"collectives {c} differ from the dry-run's {coll}")
        ops_ = rep["ring_steps"][0]["collectives"]["per_op_count"]
        print(f"  rank {r} long_500k: row 3 on q/k shards "
              f"{rep['ring_shards']} ({rep['ring_lse_kw']}); every step's "
              f"collectives {ops_} equal to the dry-run's; per step (wall "
              f"ms, collectives: counted B, logged result B, device ms; the "
              f"merge: logged B, device ms): " + "; ".join(
                  f"{st['wall_ms']:.1f}, {st['collectives']['bytes']:.0f}, "
                  f"{st['bytes_logged']}, {st['ms']:.2f}; {st['merge_bytes']}"
                  f", {st['merge_ms']:.2f}" for st in rep["ring_steps"]))
    if device.type == "cuda":
        print(f"  spmd long_500k figures on: {smi_line()}")


def spmd_phase(device) -> tuple:
    """qwen3-1.7b at its published widths through every entry as
    DTensors placed by the baseline sharding rules over ``SPMD_RANKS``
    gloo ranks sharing the card (``spmd_rank``), held against one
    process: the fp32 prefill logits (atol 5e-5, rtol 1e-3) and greedy
    tokens (exactly), the fp32 loss and gradients at
    ``SPMD_TRAIN_LAYERS`` layers (on each rank), the bf16 logits
    (``check_scaled``); each rank's counted collectives against the
    dry-run's fake-group count of the same entry, op by op. Then
    long_500k's decode at batch 1: a prompt past the 4,096-slot ring
    prefilled in one process, the cache split by the rules over
    ``data``, ``SPMD_RING_NEW`` greedy steps on the ranks, each rank's
    softmax over its slots merged by ``spmd.merge_softmax`` (tokens
    exactly, fp32 logits at the serving tolerance, every step's
    collectives equal to the fake group's count; ``spmd_ring_report``).
    Returns (the launch counts of the four main paths summed over the
    ranks, the first calls' errors by kernel)."""
    import shutil

    import torch
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.launch.dryrun import dryrun_one
    from repro_torch.models import init_params
    from repro_torch.models.decode import prefill
    cfg, cfg32 = spmd_configs()
    ms = spmd_mesh()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.head_dim_}; "
          f"{SPMD_RANKS} gloo ranks on one card as a {dict(ms.shape)} mesh, "
          f"baseline rules; prompts {SPMD_BATCH} x {SPMD_SEQ}")
    shutil.rmtree(SPMD_DIR, ignore_errors=True)
    os.makedirs(SPMD_DIR)
    t0 = time.perf_counter()
    rec = dryrun_one(SPMD_ARCH, spmd_shape(), mesh=ms, verbose=False)
    if not rec["ok"]:
        fail(f"spmd: the dry-run of the prefill entry failed: "
             f"{rec['error']}")
    coll = rec["collectives"]
    print(f"  dry-run on a fake group of {ms.size} ranks "
          f"({time.perf_counter() - t0:.1f} s): {coll['count']} "
          f"collectives, {coll['bytes'] / 2**20:.2f} MiB a device; "
          f"{coll['per_op']}")
    t0 = time.perf_counter()
    ring_coll = spmd_ring_count(cfg32, ms)
    print(f"  dry-run of one fp32 long_500k decode step on the fake group "
          f"({time.perf_counter() - t0:.1f} s): {ring_coll['count']} "
          f"collectives, {ring_coll['bytes']:.0f} B a device; "
          f"{ring_coll['per_op']}")
    toks, _ = (t.to(device) for t in spmd_tokens(cfg))
    params = init_params(cfg32, seed=SPMD_SEED, device=device)
    with torch.no_grad():
        want_logits, want_new = spmd_serve(params, cfg32, toks)
        ring_new, ring_logits, ring_walls = spmd_ring_decode(
            params, cfg32, device, os.path.join(SPMD_DIR, "ring.pt"))
    want_logits, want_new = want_logits.cpu(), want_new.cpu()
    del params
    free_device()
    params = init_params(cfg, seed=SPMD_SEED, device=device)
    with torch.no_grad():
        want16, _ = prefill(params, cfg, toks)
        ep_sync(device)
        t = time.perf_counter()
        prefill(params, cfg, toks)
        ep_sync(device)
        one_wall = time.perf_counter() - t
    want16 = want16.cpu()
    del params
    free_device()
    try:
        wall = spawn_ranks(spmd_rank, SPMD_RANKS, cfg, cfg32, device.type,
                           SPMD_DIR, timeout=SPMD_TIMEOUT_S)
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException,
            TimeoutError) as e:
        fail(f"spmd: a rank failed: {e}")
    reps = []
    for r in range(SPMD_RANKS):
        with open(os.path.join(SPMD_DIR, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    print(f"  {SPMD_RANKS} ranks ran in {wall:.1f} s (spawn and imports "
          f"included); gloo on {device.type} tensors: {reps[0]['gloo']}")
    got = torch.load(os.path.join(SPMD_DIR, "fp32.pt"))
    check_close(f"spmd fp32 prefill logits {tuple(got['logits'].shape)} "
                "against one process", got["logits"], want_logits,
                SERVE_ATOL, SERVE_RTOL)
    if not torch.equal(got["new"], want_new):
        fail(f"spmd: greedy tokens {got['new'].tolist()} differ from one "
             f"process's {want_new.tolist()}")
    print(f"  spmd greedy decode: {SPMD_NEW} steps against a {SPMD_CACHE}"
          f"-slot cache, tokens equal to one process's: "
          f"{got['new'].tolist()}")
    check_scaled(f"spmd bf16 prefill logits {tuple(want16.shape)} against "
                 "one process", torch.load(os.path.join(SPMD_DIR, "bf16.pt")),
                 want16, TOL["bfloat16"], 1)
    L = cfg.n_layers
    spmd_ring_report(reps, ring_new, ring_logits, ring_walls, ring_coll, L,
                     device)
    want_launch = {
        "launches_serve": {"flash_attention_lse": L,
                           "decode_attention": L * SPMD_NEW},
        "launches_train": {"flash_attention_lse": 2 * SPMD_TRAIN_LAYERS,
                           "flash_attention_bwd_dq": SPMD_TRAIN_LAYERS,
                           "flash_attention_bwd_dkv": SPMD_TRAIN_LAYERS},
        "launches_bf16": {"flash_attention_lse": L},
        "launches_ring": {"decode_attention": L * SPMD_RING_NEW,
                          "flash_attention_lse": 0}}
    for rep in reps:
        r = rep["rank"]
        for key, want in want_launch.items():
            got_l = {k: rep[key].get(k, 0) for k in want}
            if device.type == "cuda" and got_l != want:
                fail(f"spmd rank {r}: {key} {rep[key]}, want {want}")
        c = rep["collectives"]
        same = c["per_op"] == coll["per_op"] and \
            c["per_op_count"] == coll["per_op_count"]
        print(f"  rank {r}: prefill shards q/k {rep['prefill_shards']}, "
              f"decode q/cache {rep['decode_shards']}; fp32 serve "
              f"{rep['serve_s']:.2f} s; loss {rep['loss'][0]:.6f} vs one "
              f"process {rep['loss'][1]:.6f}, worst gradient relative L2 "
              f"{max(rep['grad_rel_l2'].values()):.2e} (bound "
              f"{GRAD_REL_L2:g}, {len(rep['grad_rel_l2'])} leaves); bf16 "
              f"collectives {c['per_op_count']} "
              f"{ {k: int(v) for k, v in c['per_op'].items()} } B "
              f"{'equal to' if same else 'DIFFER FROM'} the dry-run's; "
              f"peak {rep.get('peak_bytes', 0) / 1e9:.2f} GB")
        if not same:
            fail(f"spmd rank {r}: counted collectives {c} differ from the "
                 f"dry-run's {coll}")
    for rep in reps:
        by = {}
        for name, b, ms_, h in rep["timed"]:
            s = by.setdefault(name, [0, 0, 0.0, 0.0])
            s[0] += 1
            s[1] += b
            s[2] += ms_
            s[3] += h
        print(f"  rank {rep['rank']} bf16 prefill {rep['wall_s'] * 1e3:.1f} "
              f"ms (one process {one_wall * 1e3:.1f} ms); collectives by op "
              "(calls, result bytes, device ms, host ms): "
              + "; ".join(f"{k} {v[0]}, {v[1]}, {v[2]:.2f}, {v[3]:.2f}"
                          for k, v in sorted(by.items())))
    if device.type == "cuda":
        print(f"  spmd figures on: {smi_line()} (gloo through host memory, "
              "not NVLink or NCCL)")
    runs = [{k: sum(rep[key].get(k, 0) for rep in reps)
             for k in reps[0][key]}
            for key in ("launches_serve", "launches_train", "launches_bf16",
                        "launches_ring")]
    worst = {}
    for rep in reps:
        for name, cases in rep["worst"].items():
            for case, e in cases.items():
                worst.setdefault(name, {})[
                    ("float32", f"spmd rank {rep['rank']} {case}")] = e
    return runs, worst


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
    names the kernels that must have launched there. A model whose
    arena shares prompt prefixes (``shares_prefixes``: dense, a moe
    that never drops) must show prefix hits and KV handoffs taken in;
    hybrid and a moe that can drop share nothing (the arena does not
    hold hybrid's scan state, and a drop depends on the prompt that
    wrote the KV): no hit, and the decode pool ignores the handoff's
    blocks and recomputes the prompt."""
    import numpy as np
    import torch
    from repro_torch.serving.executor import shares_prefixes
    from repro_torch.serving.smoke import reference_decode, smoke_setup

    t0 = time.perf_counter()
    cfg, book, params = smoke_setup(arch, full_width=True,
                                    dtype="float32", seq_len=DECODE_CTX,
                                    device=device)
    shares = shares_prefixes(cfg)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}{moe_text(cfg)}"
          f", allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; decode_ctx "
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
          f"{'' if shares else ' (the decode pool recomputes each prompt)'}"
          ", "
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


def server_loop(cfg, book, params, telemetry,
                seconds=SERVER_SECONDS) -> dict:
    """``run_serve_loop`` over full-width weights: the planner's plan
    through a ``ServingController`` (its window half the traffic's
    seconds, so a client that falls silent departs), client threads for
    ``seconds`` with a partition shift halfway, decode streams
    from the last client. Returns the report with the served requests,
    unchecked: the checks' own launches must not count."""
    from repro_torch.core import Fragment
    from repro_torch.serving import run_serve_loop
    frags = [Fragment(cfg.name, p, SERVER_BUDGET_MS, q, client=f"c{i}")
             for i, (p, q) in enumerate(zip(SERVER_POINTS, SERVER_RATES))]
    return run_serve_loop(
        setup=(cfg, book, params), frags=frags, seconds=seconds,
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

    # the same loop in bfloat16, printed only, for half the seconds
    cfg16, book16, params16 = smoke_setup("qwen3-1.7b", full_width=True,
                                          dtype="bfloat16", seq_len=512,
                                          device=device)
    tel = Telemetry(process="serve")
    rep16 = server_loop(cfg16, book16, params16, tel, SERVER_SECONDS / 2)
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

# the remote phase runs qwen3-1.7b at full width but 8 of its 28 layers
# (the server phase runs the same loop at all 28, in process). The
# executor's clients: the re-aligned plan cuts at the last of them, so
# its pool survives the replan in its worker. The fleet loops' clients
# follow SERVER_POINTS' pattern (the last client, at 0, decodes); the
# printed-only bf16 fleet loop runs a quarter of the fp32 loop's seconds
REMOTE_LAYERS = 8
REMOTE_POINTS = (1, 3, 5)
REMOTE_FLEET_POINTS = (1, 3, 5, 0)
REMOTE_BF16_SECONDS = SERVER_SECONDS / 4
REMOTE_FRONTENDS = 2
CLI_TIMEOUT_S = 300


def indented(*args) -> None:
    print("   ", *args, flush=True)


def print_spawns(spawn_log, label) -> None:
    for key, spawn_s, init_s, nbytes in spawn_log:
        print(f"    {label} worker for pool {key[1:]}: spawn {spawn_s:.2f} s, "
              f"init {init_s:.2f} s ({nbytes / 2**30:.2f} GiB of parameters)")


def remote_executor_check(device) -> dict:
    """``RemoteExecutor`` on the card: one worker per pool of the
    planner's plan, two waves, a re-aligned plan, two more waves; every
    result against the forward. Returns the launches on this path: the
    workers' (pool execution) plus this process's (mobile parts)."""
    import numpy as np
    import torch
    from repro_torch.core import Fragment, GraftPlanner
    from repro_torch.serving import RemoteExecutor, SocketTransport
    from repro_torch.serving.smoke import mixed_depth_plan, smoke_setup

    cfg, book, params = smoke_setup("qwen3-1.7b", full_width=True,
                                    n_layers=REMOTE_LAYERS, dtype="float32",
                                    seq_len=512, device=device)
    print(f"  executor check: {cfg.name} at {cfg.n_layers} of 28 layers, "
          f"full width, {cfg.dtype}; clients at {REMOTE_POINTS}, re-aligned "
          f"at {REMOTE_POINTS[-1]}")
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
    del params
    free_device()
    return {k: workers[k] + parent[k] for k in workers}


def fleet_loop(cfg, book, params, telemetry, seconds) -> dict:
    """The server phase's loop through ``GraftFleet`` front-ends over a
    ``RemoteExecutor``, its clients at ``REMOTE_FLEET_POINTS``; returns
    its report, unchecked."""
    from repro_torch.core import Fragment
    from repro_torch.serving import run_serve_loop
    frags = [Fragment(cfg.name, p, SERVER_BUDGET_MS, q, client=f"c{i}")
             for i, (p, q) in enumerate(zip(REMOTE_FLEET_POINTS,
                                            SERVER_RATES))]
    return run_serve_loop(
        setup=(cfg, book, params), frags=frags, seconds=seconds,
        seed=0, shift_frac=0.5, control_period_ms=SERVER_PERIOD_MS,
        prompt_lens=SERVER_PROMPTS, decode_max_new=MAX_NEW,
        check_numerics=False, telemetry=telemetry, mode="socket",
        frontends=REMOTE_FRONTENDS, router="weighted", log=indented)


# the split-decode check: full width at 4 of 28 layers, one decode pool
# in a worker, 8 streams of 10 tokens admitted half by each front-end
SPLIT_LAYERS = 4
SPLIT_STREAMS = 8
SPLIT_NEW = 10


def fleet_split_decode_check(device) -> None:
    """Decode streams split across the fleet's front-ends over ONE shared
    decode pool in a worker process: each front-end admits half of them,
    either front-end's step advances all of them, and each stream's step
    events reach its owner through the fleet. After the drain every
    driver's decode count must equal the pool's reported occupancy, no
    front-end may still own a stream, and every stream's tokens must
    equal those a lone ``GraftServer`` over the same worker gives it."""
    import numpy as np
    from repro_torch.core import Fragment
    from repro_torch.serving import (GraftFleet, GraftServer, RemoteExecutor,
                                     ServeRequest, SocketTransport)
    from repro_torch.serving.smoke import decode_plan, smoke_setup

    t0 = time.perf_counter()
    cfg, book, params = smoke_setup("qwen3-1.7b", full_width=True,
                                    n_layers=SPLIT_LAYERS, dtype="float32",
                                    seq_len=512, device=device)
    frags = [Fragment(cfg.name, 0, SERVER_BUDGET_MS, 30.0, client=f"d{i}")
             for i in range(REMOTE_FRONTENDS)]
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, int(rng.randint(9, 40)))
               .astype(np.int32) for _ in range(SPLIT_STREAMS)]

    def run(server, frontend) -> tuple:
        reqs = [ServeRequest(client=f"d{i % REMOTE_FRONTENDS}", tokens=t,
                             max_new_tokens=SPLIT_NEW)
                for i, t in enumerate(prompts)]
        server.start()
        try:
            for i, r in enumerate(reqs):
                frontend(i).submit(r, 0, SERVER_BUDGET_MS)
            if not server.join(timeout=300.0):
                fail(f"split decode: a stream stranded ({server.report()})")
            return [r.out_tokens for r in reqs], server.report()
        except BaseException:
            server.stop(drain=False, timeout=10.0)
            raise

    with RemoteExecutor(decode_plan(cfg, book, frags, batch=SPLIT_STREAMS),
                        params, cfg,
                        SocketTransport(max_frame_bytes=MAX_FRAME_BYTES),
                        decode_ctx=64, kv_blocks=4 * SPLIT_STREAMS,
                        kv_block_tokens=16, device=device) as rex:
        (key,) = rex.pool_specs()
        fleet = GraftFleet(rex, n_frontends=REMOTE_FRONTENDS, book=book)
        names = fleet.frontends
        split, rep = run(fleet, lambda i: fleet.frontend(
            names[i % len(names)]))
        drivers = {n: fleet.frontend(n).driver(key) for n in names}
        # a driver that did not take the last step holds the occupancy
        # its own last step reported, until its next step reads 0
        give_up = time.monotonic() + 10.0
        while True:
            occupancy = rex.handle(key).stats()["decode_active"]
            counts = {n: d.decode_active for n, d in drivers.items()}
            owned = {n: len(d.decode_resident) for n, d in drivers.items()}
            if set(counts.values()) == {occupancy} and not any(
                    owned.values()):
                break
            if time.monotonic() > give_up:
                fail(f"split decode: driver counts {counts} against the "
                     f"pool's occupancy {occupancy}, streams still owned "
                     f"{owned}")
            time.sleep(0.05)
        fleet.stop(drain=False, timeout=10.0)
        events = fleet.stats["cross_dispatched"]
        lone = GraftServer(rex, book=book)
        single, lone_rep = run(lone, lambda i: lone)
        lone.stop(drain=False, timeout=10.0)
    served = {n: fe["served"] for n, fe in rep["frontends"].items()}
    for label, r in (("fleet", rep), ("lone server", lone_rep)):
        if r["decode_served"] != SPLIT_STREAMS or r["decode_local"] \
                or r["shed"]:
            fail(f"split decode, {label}: served {r['decode_served']} of "
                 f"{SPLIT_STREAMS}, local {r['decode_local']}, shed "
                 f"{r['shed']}")
    if set(served.values()) != {SPLIT_STREAMS // REMOTE_FRONTENDS}:
        fail(f"split decode: streams served per front-end {served}")
    if not events:
        fail("split decode: no step event crossed to another front-end")
    print(f"  split decode ({cfg.n_layers} of 28 layers, full width, fp32; "
          f"one pool worker): {SPLIT_STREAMS} streams of {SPLIT_NEW} tokens "
          f"over {REMOTE_FRONTENDS} front-ends {served}; {events} decode "
          f"events dispatched across front-ends; drained, every driver's "
          f"count {occupancy} = the pool's occupancy; "
          f"{time.perf_counter() - t0:.1f} s")
    for i, (got, want) in enumerate(zip(split, single)):
        same = got == want
        print(f"    stream {i} (front-end {names[i % len(names)]}): "
              f"{'equal' if same else 'DIFFERENT'} to the lone server's "
              f"{want}")
        if not same:
            fail(f"split decode: stream {i} {got} against the lone "
                 f"server's {want}")
    del params
    free_device()


def beside(fn, *args):
    """Run ``fn(*args)`` on a thread; the returned function waits for it
    and raises what it raised (a ``fail`` included)."""
    raised = []

    def body():
        try:
            fn(*args)
        except BaseException as e:
            raised.append(e)
    t = threading.Thread(target=body, daemon=True, name=fn.__name__)
    t.start()

    def wait():
        t.join()
        if raised:
            raise raised[0]
    return wait


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
    """Pool workers on the card under the executor (the serving
    launcher's two modes beside it), under the fleet, and under split
    decode streams; returns the kernels' launch counts over the float32
    remote paths (the executor's waves, then the fleet loop), the
    workers' and this process's."""
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
    # the launcher's two modes as subprocesses and the split-decode check
    # on a thread, beside the executor check: each waits mostly on its
    # workers' spawns and loads, and none of them is timed
    clis = [start_cli(["--arch", "qwen3-1.7b", "--execute", "socket"]),
            start_cli(["--serve-loop", "--execute", "socket",
                       "--serve-seconds", "2", "--clients", "2",
                       "--frontends", "2"])]
    split = beside(fleet_split_decode_check, device)
    launches = remote_executor_check(device)
    t_check = time.perf_counter() - t_phase
    for run in clis:
        finish_cli(run)
    split()
    print(f"  executor check: {t_check:.1f} s; with the launcher and the "
          f"split-decode check beside it {time.perf_counter() - t_phase:.1f}"
          " s")
    cfg, book, params = smoke_setup("qwen3-1.7b", full_width=True,
                                    n_layers=REMOTE_LAYERS, dtype="float32",
                                    seq_len=512, device=device)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} of 28 layers, {cfg.dtype}, "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; fleet "
          f"clients at {REMOTE_FLEET_POINTS}")

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

    t0 = time.perf_counter()
    route = run_route_smoke(device=device, log=indented)
    if not (route["numerics_ok"] and route["steals"] >= 1
            and route["shed"] == 0):
        fail(f"route smoke: steals {route['steals']}, shed "
             f"{route['shed']}, numerics {route.get('numerics_error', 'ok')}")
    print(f"  route smoke: {time.perf_counter() - t0:.1f} s")

    # bfloat16, printed only
    t0 = time.perf_counter()
    cfg16, book16, params16 = smoke_setup("qwen3-1.7b", full_width=True,
                                          n_layers=REMOTE_LAYERS,
                                          dtype="bfloat16", seq_len=512,
                                          device=device)
    tel = Telemetry(process="serve")
    rep16 = fleet_loop(cfg16, book16, params16, tel, REMOTE_BF16_SECONDS)
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
    print(f"  bf16 fleet loop ({cfg16.n_layers} of 28 layers, "
          f"{REMOTE_BF16_SECONDS:.0f} s of traffic): "
          f"{time.perf_counter() - t0:.1f} s with spawns, warm-up and drain")
    t0 = time.perf_counter()
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
    print(f"  measure_layer_costs: {time.perf_counter() - t0:.1f} s")
    del params16
    free_device()
    print(f"  remote phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the vlm and audio families
# ---------------------------------------------------------------------------

# llama-3.2-vision's depth on the card: 2 of its 20 superblocks (10 of its
# 100 layers, a cross block after every 5) at the published widths, 10.7B
# parameters, 42.6 GB in float32: the fewest superblocks that leave a
# fragment cut (its 90.7B parameters do not fit)
VISION_LAYERS = 10
# a fresh cross block's gates are 0 and tanh(0) passes the block through;
# the phase opens them so the image embeddings reach the logits
VISION_GATE = 0.5
MM_NEW = 16
MM_PROMPTS = (16, 201)
MM_TRAIN_B, MM_TRAIN_S = 2, 128
MM_BF16_STEPS = 3


def mm_extras(cfg, params, gen) -> dict:
    """One request's extras on the params' device: a vlm request's image
    embeddings; an audio request's frame embeddings and the encoder's
    memory of them (what its served fragments read)."""
    import torch
    from repro_torch.models import encode_audio, make_extras
    ex = make_extras(cfg, 1, gen, device=params["embed"].device)
    if cfg.family == "audio":
        with torch.no_grad():
            ex["memory"] = encode_audio(params, cfg, ex["frames"])
    return ex


def open_gates(cfg, params) -> None:
    if cfg.family == "vlm":
        for g in ("gate_attn", "gate_mlp"):
            params["cross_blocks"][g].fill_(VISION_GATE)


@contextlib.contextmanager
def plain_ops():
    """``ops.attention`` and ``ops.attend_cache`` are the kernels' plain
    versions inside the block (the JAX package's reference ops)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    saved = ops.attention, ops.attend_cache
    ops.attention, ops.attend_cache = plain_attention, \
        da.decode_attention_plain
    try:
        yield
    finally:
        ops.attention, ops.attend_cache = saved


def greedy(cfg, params, prompt, ex, max_new, *, forced=None):
    """prefill + ``max_new`` - 1 decode steps of one stream (``forced``:
    feed these tokens instead of the argmax) -> (tokens, each position's
    logits (fp32, on the card), top-1 minus top-2 margins)."""
    import torch
    from repro_torch.models.decode import decode_step, prefill
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, device=dev)[None]
    with torch.no_grad():
        logits, cache = prefill(params, cfg, toks, extras=ex,
                                cache_seq=len(prompt) + max_new)
        out, rows, margins = [], [], []
        for i in range(max_new):
            row = logits[0, -1].float()
            top = torch.topk(row, 2).values
            out.append(int(row.argmax()) if forced is None else forced[i])
            rows.append(row)
            margins.append(float(top[0] - top[1]))
            if i + 1 < max_new:
                step = torch.tensor([[out[-1]]], dtype=torch.int32,
                                    device=dev)
                logits, cache = decode_step(params, cfg, cache, step)
    return out, rows, margins


def mm_streams(cfg, params, n, seed):
    """``n`` prompts of ``MM_PROMPTS`` tokens, each with its own stub
    extras (what ``forward`` and ``prefill`` read)."""
    import numpy as np
    import torch
    from repro_torch.models import make_extras
    rng = np.random.RandomState(seed)
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(rng.randint(0, cfg.vocab_size, int(rng.randint(*MM_PROMPTS)))
             .astype(np.int32), make_extras(cfg, 1, gen, device=dev))
            for _ in range(n)]


def mm_decode_check(cfg, params, n, runs, *, int8=False) -> None:
    """``n`` greedy streams of ``MM_NEW`` tokens by prefill + decode_step
    (the path counted into ``runs``), each token equal to the argmax of
    the forward re-run on the grown sequence. With ``int8``, the first
    stream again with an int8 KV cache through the kernels, against the
    same int8 decode through the plain ops (the JAX package's reference
    ops): the same argmax, and both within the JAX int8 test's bound (0.1
    of the logits' std) of the float forward."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import forward
    streams = mm_streams(cfg, params, n, seed=11)
    print(f"  decode streams: prompts {[len(p) for p, _ in streams]}, "
          f"{MM_NEW} new tokens each")
    reset_launches()                        # the decode path starts here
    t0 = time.perf_counter()
    got = [greedy(cfg, params, p, ex, MM_NEW) for p, ex in streams]
    torch.cuda.synchronize()
    launches = read_launches()              # ... and ends here
    runs.append(launches)
    print(f"  fp32 decode: {n * MM_NEW} tokens in "
          f"{time.perf_counter() - t0:.2f} s; kernel launches {launches}")
    if not all(launches[k] > 0 for k in ("decode_attention",
                                         "flash_attention_lse")):
        fail(f"a kernel of the {cfg.name} decode path never launched: "
             f"{launches}")

    def forward_rows(prompt, toks, ex):
        seq = torch.as_tensor(np.concatenate([prompt, toks]),
                              device=params["embed"].device)[None]
        with torch.no_grad():
            full = forward(params, cfg, seq, extras=ex)[0][0].float()
        return full[len(prompt) - 1:-1]
    worst = []
    for i, ((prompt, ex), (toks, _, margins)) in enumerate(zip(streams,
                                                               got)):
        want = forward_rows(prompt, toks, ex).argmax(-1).tolist()
        if toks != want:
            fail(f"{cfg.name} stream {i}: decoded {toks} != the forward's "
                 f"argmax {want} (margins {margins})")
        worst.append(min(margins))
    print(f"  {n} streams token-exact against the forward re-run on the "
          f"grown sequence; smallest top-1 minus top-2 margin per stream "
          f"{[f'{m:.4g}' for m in worst]}")
    if not int8:
        return
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    prompt, ex = streams[0]
    toks8, rows8, _ = greedy(cfg8, params, prompt, ex, MM_NEW)
    with plain_ops():
        _, rows_p, _ = greedy(cfg8, params, prompt, ex, MM_NEW,
                              forced=toks8)
    ref = forward_rows(prompt, toks8, ex)
    k8, p8 = torch.stack(rows8), torch.stack(rows_p)
    d_plain = float((k8 - p8).abs().max())
    d_float = max(float((k8 - ref).abs().max()),
                  float((p8 - ref).abs().max()))
    bound8 = 0.1 * max(float(ref.std()), 1e-3)
    same = p8.argmax(-1).tolist() == toks8
    print(f"  int8 KV cache, {MM_NEW} tokens: the plain ops' argmax equals "
          f"the kernels' {same}; max |logit diff| kernels against plain ops "
          f"{d_plain:.3e}, either against the float forward {d_float:.3e} "
          f"(bound {bound8:.3e}, 0.1 of its std)")
    if not same or max(d_plain, d_float) > bound8:
        fail(f"{cfg.name} int8 decode disagrees with the plain ops or the "
             "float forward")


def mm_bf16_decode(cfg, params, n) -> None:
    """``n`` bfloat16 streams of ``MM_NEW`` tokens, timed (host clock;
    each step's argmax is copied to the host)."""
    import torch
    streams = mm_streams(cfg, params, n, seed=12)
    greedy(cfg, params, *streams[0], 2)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, ex in streams:
        greedy(cfg, params, p, ex, MM_NEW)
    wall = time.perf_counter() - t0
    print(f"  bf16 decode: {n} streams of {MM_NEW} tokens (prefill + "
          f"{MM_NEW - 1} steps each, batch 1) in {wall:.3f} s = "
          f"{n * MM_NEW / wall:.1f} tokens/s (host clock)")


def mm_train(device, runs) -> None:
    """whisper-base at full width, float32 (TF32 off): the loss and every
    gradient of one batch (2 x 128 tokens with frames) through the
    kernels against autograd of the plain attention, the encoder's
    gradients (through the cross-attention's memory) included; one AdamW
    step counted: the encoder's non-causal attentions run once, the
    decoder's self and cross attentions twice (remat recomputes them),
    and rows 4-5 once per attention; then bfloat16 steps, counted and
    timed."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.models import init_params, make_extras
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.train_step import loss_and_grads

    cfg = dataclasses.replace(get_config("whisper-base"), dtype="float32")
    params = init_params(cfg, seed=0, device=device)
    data = token_batches(batch=MM_TRAIN_B, seq_len=MM_TRAIN_S,
                         vocab=cfg.vocab_size, seed=1)
    b0 = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
    gen = torch.Generator(device=device).manual_seed(7)
    ex = make_extras(cfg, MM_TRAIN_B, gen, device=device)
    loss_k, _, g_k = loss_and_grads(params, cfg, b0["tokens"], b0["labels"],
                                    extras=ex, remat=False)
    with oracle_attention():
        loss_o, _, g_o = loss_and_grads(params, cfg, b0["tokens"],
                                        b0["labels"], extras=ex,
                                        remat=False)
    torch.cuda.synchronize()
    loss_k, loss_o = float(loss_k), float(loss_o)
    rel, leaf = worst_leaf(g_k, g_o)
    enc = worst_leaf({"enc_blocks": g_k["enc_blocks"]},
                     {"enc_blocks": g_o["enc_blocks"]})
    print(f"  {cfg.name} fp32 loss through the kernels {loss_k:.6f}, through "
          f"the plain attention {loss_o:.6f}; gradients: worst leaf {leaf} "
          f"rel L2 {rel:.3e}, the encoder's worst {enc[1]} {enc[0]:.3e} "
          f"(bound {GRAD_REL_L2:g}); batch {MM_TRAIN_B} x {MM_TRAIN_S} "
          f"tokens with {cfg.audio.n_audio_frames} frames each")
    if abs(loss_k - loss_o) > LOSS_RTOL * abs(loss_o) or rel > GRAD_REL_L2:
        fail(f"{cfg.name} gradients through the kernels disagree with the "
             "plain attention's")
    del g_k, g_o
    n_enc, L = cfg.audio.n_encoder_layers, cfg.n_layers
    per_step = {"flash_attention_lse": n_enc + 2 * 2 * L,
                "flash_attention_bwd_dq": n_enc + 2 * L,
                "flash_attention_bwd_dkv": n_enc + 2 * L}
    for label, n in (("fp32", 1), ("bf16", MM_BF16_STEPS)):
        if label == "bf16":
            del params, opt
            free_device()
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
            params = init_params(cfg, seed=0, device=device)
            ex = make_extras(cfg, MM_TRAIN_B, gen, device=device)
        step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
        opt = init_opt_state(params)
        if label == "bf16":                                 # warm-up
            params, opt, _ = step(params, opt, next(data), ex)
        torch.cuda.synchronize()
        reset_launches()                    # the train path starts here
        t0 = time.perf_counter()
        losses = []
        for _ in range(n):
            params, opt, m = step(params, opt, next(data), ex)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
        launches = read_launches()          # ... and ends here
        runs.append(launches)
        losses = [float(x) for x in losses]
        print(f"  {label} AdamW steps (remat=True): {n}, {wall:.4f} s/step, "
              f"{MM_TRAIN_B * MM_TRAIN_S / wall:.1f} tokens/s (host clock, "
              f"ended by a synchronize); losses "
              f"{[round(x, 4) for x in losses]}; kernel launches {launches}")
        want = {k: c * n for k, c in per_step.items()}
        if not all(map(math.isfinite, losses)):
            fail(f"{cfg.name} {label} losses are not finite: {losses}")
        if any(launches[k] != c for k, c in want.items()):
            fail(f"{cfg.name} {label} train path launches {launches}, "
                 f"expected {want}")
    del params, opt
    free_device()


def multimodal_phase(device) -> list:
    """whisper-base at full width, then llama-3.2-vision at its published
    widths cut to 2 of 20 superblocks: each served (float32 waves under
    the planner's plan and a re-aligned one, every result against the
    request's own forward; bfloat16 waves timed and profiled) and
    decoded (float32 streams token-exact against the forward re-run;
    vision's int8 KV cache against the plain ops; whisper's bfloat16
    streams timed); then whisper-base's training step. Returns the
    launch counts of each float32 path and of the bf16 train steps, in
    the order the phase runs them."""
    runs: list = []
    need = ("flash_attention_lse",)          # extras never pack: row 2
    t0 = time.perf_counter()
    runs.append(serve_phase(
        device, "whisper-base", seed=6, lo=32, hi=448, need=need,
        extras=mm_extras,
        after_fp32=lambda c, p: mm_decode_check(c, p, 4, runs),
        after_bf16=lambda c, p: mm_bf16_decode(c, p, 4)))
    print(f"  whisper-base: {time.perf_counter() - t0:.1f} s")
    free_device()
    t0 = time.perf_counter()
    runs.append(serve_phase(
        device, "llama-3.2-vision-90b", seed=7, lo=32, hi=160,
        n_layers=VISION_LAYERS, need=need, extras=mm_extras,
        prepare=open_gates,
        after_fp32=lambda c, p: mm_decode_check(c, p, 3, runs, int8=True)))
    print(f"  llama-3.2-vision-90b ({VISION_LAYERS} of 100 layers, 2 of 20 "
          f"superblocks): {time.perf_counter() - t0:.1f} s")
    free_device()
    t0 = time.perf_counter()
    mm_train(device, runs)
    print(f"  whisper-base training: {time.perf_counter() - t0:.1f} s")
    rows = ("flash_attention_lse", "decode_attention",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    for label, r in zip(("whisper decode", "whisper serve", "vision decode",
                         "vision serve", "whisper fp32 train",
                         "whisper bf16 train"), runs):
        print(f"  launches of rows 2-5, {label}: "
              f"{ {k: r.get(k, 0) for k in rows} }")
    return runs


# ---------------------------------------------------------------------------
# phase 11: training on the main path
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


# ---------------------------------------------------------------------------
# launch: the workload entries of launch/specs.py at full width
# ---------------------------------------------------------------------------

LAUNCH_ARCH = "qwen3-1.7b"
# (workload shape, its global batch cut to fit one H100 80GB)
LAUNCH_SHAPES = (("prefill_32k", 1), ("decode_32k", 4), ("long_500k", 1),
                 ("train_4k", 1))
LAUNCH_ROWS = 512             # prefill: the kernel's last query rows held
DRYRUN_TIMEOUT_S = 900


@contextlib.contextmanager
def first_call(module, name: str, store: dict):
    """``module.name`` (a kernel wrapper, or a module's reference to one)
    wrapped so that its first call's arguments, keywords and result land
    in ``store``."""
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        if not store:
            store.update(args=args, kw=kw, out=out)
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def launch_inputs(shape_name, batch, device, gen) -> dict:
    """``specs.input_specs`` on the card at ``batch``: the seeded bf16
    weights, random tokens, and for decode a cache of random k and v
    whose every slot is valid: it holds the last ``Sc`` positions before
    the step's (slot = position mod Sc), the step at position S - 1."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    s = specs.input_specs(LAUNCH_ARCH, shape_name, batch=batch,
                          device=device)
    V = s["cfg"].vocab_size

    def tokens(like):
        return torch.randint(0, V, tuple(like.shape), generator=gen,
                             device=device, dtype=torch.int32)
    if "batch" in s:
        s["batch"] = {k: tokens(t) for k, t in s["batch"].items()}
    if "tokens" in s:
        s["tokens"] = tokens(s["tokens"])
    if "cache" in s:
        c, S = s["cache"], SHAPES[shape_name].seq_len
        Sc = c["kv_pos"].shape[1]
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
        held = torch.arange(S - Sc, S, dtype=torch.int32, device=device)
        kvp = torch.empty(Sc, dtype=torch.int32, device=device)
        kvp[(held % Sc).long()] = held
        c["kv_pos"] = kvp[None].expand(batch, Sc).contiguous()
        c["pos"] = torch.full((batch,), S - 1, dtype=torch.int32,
                              device=device)
    return s


def launch_checks(kind, fwd, bwd, dec, worst) -> None:
    """The captured kernel calls of one entry against their plain
    versions, in bf16: the prefill's last LAUNCH_ROWS query rows against
    the plain attention over those rows and every key, a decode call
    against ``attend_cache``'s plain version on the same cache, a train
    step's forward and its FA-2 backward against the plain forward and
    the backward's plain formulas on that layer's q, k, v, o, lse and
    dO. Each is held at bf16's tolerance scaled to its largest reference
    value (``check_scaled``): at 32,768 keys |o| is about 0.01, and the
    gradients of one step are about 1e-6."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    tol = TOL["bfloat16"]
    if kind in ("prefill", "train"):
        q, k, v = fwd["args"]
        o, lse = fwd["out"]
        B, S = q.shape[:2]
        n = LAUNCH_ROWS if kind == "prefill" else S
        ar = torch.arange(S, dtype=torch.int32,
                          device=q.device)[None].expand(B, S)
        want_o, want_lse = ref.ref_attention(
            q[:, S - n:], k, v, q_pos=ar[:, S - n:], kv_pos=ar,
            return_lse=True, **fwd["kw"])
        torch.cuda.synchronize()
        tag = f"{kind} layer 0, {tuple(q.shape)} rows {S - n}..{S - 1}"
        e = check_scaled(f"flash_attention_lse o {tag}", o[:, S - n:],
                         want_o, tol, 2)
        check_close(f"flash_attention_lse lse {tag}", lse[:, :, S - n:],
                    want_lse, LSE_ATOL, 0.0)
        worst["flash_attention_lse"][("bfloat16", f"launch {kind}")] = e
    if kind == "train":
        got = bwd["out"]
        want = fab.flash_attention_bwd_plain(*bwd["args"], **bwd["kw"])
        torch.cuda.synchronize()
        tag = f"train, {tuple(bwd['args'][0].shape)}"
        e = [check_scaled(f"flash_attention_bwd {n} {tag}", g, w, tol, 2)
             for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        worst["flash_attention_bwd_dq"][("bfloat16", "launch train")] = e[0]
        worst["flash_attention_bwd_dkv"][("bfloat16", "launch train")] = \
            max(e[1:])
    if kind == "decode":
        want = da.decode_attention_plain(*dec["args"], **dec["kw"])
        torch.cuda.synchronize()
        k = dec["args"][1]
        e = check_scaled(f"decode_attention decode layer 0, cache "
                         f"{tuple(k.shape)} {dec['kw']}", dec["out"], want,
                         tol, 2)
        worst["decode_attention"][("bfloat16", f"launch Sk {k.shape[1]}")] \
            = e


def launch_timing(kind, fwd, bwd, dec, cache) -> None:
    """Rows 2-5 at the workload shapes, on the captured main-path inputs
    (bf16): the kernel's device ms per call (``time_ms``, CUDA events),
    one SDPA call's on the same inputs, and the bound (bytes in and out
    once against the FLOPs of the valid pairs, as ``timing_phase``
    counts them). Decode calls rotate over the cache's 28 layers (L2
    cold, as a step finds them); the others are L2 warm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.ref import _mask

    def show(name, shape, ms, lib_ms, nbytes, flops, note=""):
        bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
        print(f"    time {name} bf16 {shape}: kernel {ms:.4f} ms, library "
              f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x), bound {bms:.4f} ms "
              f"({by}: {nbytes} B, {flops:.4e} FLOP; {100 * bms / ms:.1f}% "
              f"of it){note}; device times")
    if kind in ("prefill", "train"):
        # detached: the train step's q, k and v require grad, and the
        # forward kernel alone refuses inputs that do
        q, k, v = (t.detach() for t in fwd["args"])
        B, S, H, hd = q.shape
        KV = k.shape[2]
        if fwd["kw"].get("window") or not fwd["kw"].get("causal", True):
            fail(f"launch timing: an unexpected mask {fwd['kw']}")
        pairs = B * H * S * (S + 1) // 2
        rows = B * H * S * 4
        big, kvb = B * S * H * hd * 2, B * S * KV * hd * 2
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        show("flash_attention_lse", (B, S, S, H, KV, hd),
             time_ms(lambda: fa.flash_attention_lse(q, k, v,
                                                    **fwd["kw"]))[0],
             time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True))[0],
             2 * big + 2 * kvb + rows, 4.0 * hd * pairs,
             ", library SDPA is_causal")
    if kind == "train":
        q, k, v, o, lse, do = (t.detach() for t in bwd["args"])
        _, dvec = fab.launch_dq(q, k, v, o, lse, do, **bwd["kw"])
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))[0]
        note = ", library the whole SDPA backward"
        show("flash_attention_bwd_dq", tuple(q.shape),
             time_ms(lambda: fab.launch_dq(q, k, v, o, lse, do,
                                           **bwd["kw"]))[0], lib,
             4 * big + 2 * kvb + 2 * rows, 6.0 * hd * pairs, note)
        show("flash_attention_bwd_dkv", tuple(q.shape),
             time_ms(lambda: fab.launch_dkv(q, k, v, lse, do, dvec,
                                            **bwd["kw"]))[0], lib,
             2 * big + 4 * kvb + 2 * rows, 8.0 * hd * pairs, note)
    if kind == "decode":
        q, _, _, qp, kp = dec["args"]
        window = dec["kw"].get("window", 0)
        B, _, H, hd = q.shape
        L, _, Sk, KV, _ = cache["k"].shape
        copies = [(q, cache["k"][i], cache["v"][i], qp, kp)
                  for i in range(L)]
        mask = _mask(qp[:, None], kp, causal=True, window=window)
        pairs = int(mask.sum().item()) * H
        m4 = mask[:, None].expand(B, H, 1, Sk)
        lib = [(q.transpose(1, 2), c[1].transpose(1, 2), c[2].transpose(1, 2))
               for c in copies]
        show("decode_attention", (B, Sk, H, KV, hd),
             time_ms(rotating(lambda *a: da.decode_attention(
                 *a, window=window), copies))[0],
             time_ms(rotating(
                 lambda qt, kt, vt: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=m4, enable_gqa=True), lib))[0],
             (2 * q.numel() + 2 * B * Sk * KV * hd) * 2 + qp.numel() * 4
             + kp.numel() * 4, 4.0 * hd * pairs,
             f", window {window}, L2 cold ({L} layers in turn), library "
             "SDPA with a boolean mask")


DRYRUN_DIR = os.path.join(HERE, "build", "dryrun_1xH100")


def stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def dryrun_sweep(during=None):
    """``python -m repro_torch.launch.dryrun --arch <a> --shape all
    --mesh 1xH100`` for every arch, one process each, all at once (each
    runs on the meta device: one host core, no device work), waited
    for after ``during()`` (the examples phase, which times nothing,
    runs meanwhile): the sweep of ``--arch all`` in a tenth of its
    time, sharing the host with no phase that is timed. Prints the
    report table and each combo's ``fits_80gb``; fails unless every
    combo was analysed. Returns what ``during()`` returned."""
    import shutil
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import report
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    env = dict(os.environ, PYTHONPATH=SRC)
    t = time.perf_counter()
    # each process's output goes to a file: a pipe nobody reads while
    # ``during()`` runs would fill and stall it
    logs = {a: open(os.path.join(DRYRUN_DIR, f"{a}.log"), "w+")
            for a in ARCH_IDS}
    procs = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", "all", "--mesh", "1xH100", "--out",
         os.path.join(DRYRUN_DIR, f"{a}.jsonl")],
        stdout=logs[a], stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE) for a in ARCH_IDS}
    try:
        result = during() if during is not None else None
        for p in procs.values():
            p.wait(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t)))
    finally:
        for p in procs.values():
            stop(p)
    outs = {}
    for a, f in logs.items():
        f.seek(0)
        outs[a] = f.read()
        f.close()
    for a, p in procs.items():
        last = outs[a].strip().splitlines()[-1] if outs[a].strip() else ""
        print(f"  dry-run {a}: {last!r} (exit {p.returncode})")
        if p.returncode != 0:
            print(outs[a][-4000:])
            fail(f"launch.dryrun --arch {a} --shape all --mesh 1xH100 "
                 "failed")
    recs = report.load([os.path.join(DRYRUN_DIR, f"{a}.jsonl")
                        for a in ARCH_IDS])
    print(f"  dry-run: {len(recs)} combos in {time.perf_counter() - t:.1f} "
          f"s ({len(ARCH_IDS)} processes)")
    print(report.roofline_table(recs, mesh="1xH100"))
    for r in recs:
        m = r["memory"]
        print(f"  fits_80gb {r['arch']} {r['shape']} (batch "
              f"{r['global_batch']}): {r['fits_80gb']} (args "
              f"{m['argument_bytes'] / 1e9:.2f} GB + temp "
              f"{m['temp_bytes'] / 1e9:.2f} GB)")
    return result


def launch_phase(device) -> tuple:
    """qwen3-1.7b at its published widths, all 28 layers, bf16, through
    ``launch.specs.entry_fn`` at each workload shape with only the batch
    cut to fit one H100 80GB: ``prefill`` of 32,768 tokens (row 2 at Sq =
    Sk = 32,768), ``decode_step`` against a full 32,768-slot cache (row 3)
    and against long_500k's 4,096-slot ring (row 3), one AdamW step at
    4,096 tokens with remat (rows 2, 4 and 5). Each entry runs three
    times: counted (launches exactly one per attention, the first
    layer's kernel calls held against their plain versions, then timed
    on those inputs beside SDPA and their bound: ``launch_timing``),
    timed on the host clock ended by a synchronize, and profiled (device
    time by kernel group); then its roofline terms on the meta device
    (``launch.dryrun``) at the same batch, and the timed wall's share of
    the larger one. The dry-run of every arch and shape on one H100
    and every combo's ``fits_80gb`` (``dryrun_sweep``) follow, beside
    the examples phase when it runs. Returns (each entry's launch
    counts, the kernel checks' largest errors by kernel)."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, specs

    runs, worst = [], {"flash_attention_lse": {}, "decode_attention": {},
                       "flash_attention_bwd_dq": {},
                       "flash_attention_bwd_dkv": {}}
    gen = torch.Generator(device=device).manual_seed(23)
    # what else holds the host as the walls are taken: threads earlier
    # phases left in this process (their Python competes for the GIL)
    kinds = {t.name.rstrip("0123456789-_") for t in threading.enumerate()}
    print(f"  live threads in this process: {threading.active_count()} "
          f"({sorted(kinds)})")
    for shape_name, batch in LAUNCH_SHAPES:
        shape = SHAPES[shape_name]
        cut = dataclasses.replace(shape, global_batch=batch)
        s = launch_inputs(shape_name, batch, device, gen)
        cfg = s["cfg"]
        L = cfg.n_layers
        fn = specs.entry_fn(cfg, cut, train_remat=True)
        if shape.kind == "train":
            args = (s["params"], s["opt_state"], s["batch"])
            need = {"flash_attention_lse": 2 * L,
                    "flash_attention_bwd_dq": L,
                    "flash_attention_bwd_dkv": L}
        elif shape.kind == "prefill":
            args = (s["params"], s["tokens"])
            need = {"flash_attention_lse": L}
        else:
            args = (s["params"], s["cache"], s["tokens"])
            need = {"decode_attention": L}
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()

        def run():
            t = time.perf_counter()
            with grad:
                out = fn(*args)
            torch.cuda.synchronize()
            del out
            return time.perf_counter() - t
        sc = s.get("cache", {})
        print(f"  {shape_name}: {cfg.name} {L} layers {cfg.dtype}, "
              f"batch {shape.global_batch} -> {batch}, S "
              f"{shape.seq_len}" + (f", cache {tuple(sc['k'].shape)} "
                                    f"window {cfg.sliding_window}"
                                    if sc else ""))
        fwd, bwd, dec = {}, {}, {}
        reset_launches()                  # this entry's path starts
        with first_call(fab, "flash_attention_lse", fwd), \
                first_call(fab, "flash_attention_bwd", bwd), \
                first_call(ops, "decode_attention", dec):
            w0 = run()
        launches = read_launches()        # ... and ends here
        runs.append(launches)
        got = {n: launches[n] for n in need}
        print(f"    counted run {w0:.4f} s; launches {got}")
        if got != need or sum(launches.values()) != sum(need.values()):
            fail(f"{shape_name}: launches {launches}, expected {need}")
        launch_checks(shape.kind, fwd, bwd, dec, worst)
        launch_timing(shape.kind, fwd, bwd, dec, sc)
        del fwd, bwd, dec
        wall = run()
        profile_run(f"{shape_name} (bf16, batch {batch}) profiled", run)
        rec = dryrun.dryrun_one(LAUNCH_ARCH, shape_name, batch=batch,
                                verbose=False)
        if not rec["ok"]:
            fail(f"dryrun {shape_name}: {rec['error']}")
        ro = rec["roofline"]
        top = max(ro["compute_s"], ro["memory_s"])
        print(f"    wall {wall:.4f} s (host clock, ended by a "
              f"synchronize); roofline (launch/roofline.py, the meta "
              f"run at batch {batch}): compute {ro['compute_s']:.6f} s "
              f"({ro['flops']:.4e} FLOPs, plain attention: every pair),"
              f" memory {ro['memory_s']:.6f} s ({ro['hbm_bytes']:.4e} "
              f"B), {ro['dominant']}-bound; the larger is "
              f"{100 * top / wall:.1f}% of the wall")
        del s, args, fn, sc
        free_device()
    return runs, worst


# ---------------------------------------------------------------------------
# examples: the example twins on the card, in this process
# ---------------------------------------------------------------------------

# (script, arguments, the line that must print, kernels that must launch)
EXAMPLE_RUNS = (
    ("realign_demo_torch.py", (), r"^Graft total \d+% vs GSLICE", ()),
    ("quickstart_torch.py", (), r"\|err vs monolithic\| = ",
     ("flash_attention",)),
    ("serve_cluster_torch.py", ("--seconds", "8", "--clients", "4"),
     r"^served \d+ real requests", ("flash_attention",)),
    ("online_serving_torch.py", ("--seconds", "6"),
     r"^controller e2e latency", ()),
    ("online_serving_torch.py", ("--transport", "inprocess", "--waves", "2",
                                 "--clients", "2"),
     r"^numerics matched the monolithic forward pass on every wave$",
     ("flash_attention",)),
    ("online_serving_torch.py", ("--transport", "socket", "--waves", "2",
                                 "--clients", "2"),
     r"^numerics matched the monolithic forward pass on every wave$", ()),
    ("online_serving_torch.py", ("--transport", "inprocess", "--loop",
                                 "--seconds", "4", "--clients", "2",
                                 "--rate", "4"),
     r"numerics matched monolithic forward on all [1-9]\d* checked",
     ("flash_attention",)),
    ("longcontext_torch.py", ("--steps", "24"), r"decode state after",
     ("flash_attention_lse", "decode_attention", "ssm_scan",
      "wkv6_scan")),
)


class Tee:
    """A stdout that prints through and keeps what it printed."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def examples_phase(device) -> list:
    """Each example twin (``examples/*_torch.py``) on the card, run here
    through ``runpy`` with a patched ``sys.argv`` (so the kernel
    counters see its launches; a socket wave's workers count their own):
    the realign demo, the quickstart (each served request within the
    serving tolerance of the forward), the serving driver, online serving
    in the simulator, in in-process and socket waves and in the
    event-driven loop, and long-context decode (rwkv6, hymba and qwen2
    smoke configs). Fails when a twin exits non-zero, does not print its
    numerics line or does not launch its kernels. Returns each run's
    launch counts."""
    import runpy
    runs = []
    for script, argv, line, need in EXAMPLE_RUNS:
        print(f"  -- {script} {' '.join(argv)}")
        tee = Tee(sys.stdout)
        saved = sys.argv
        sys.argv = [script, *argv]
        reset_launches()                      # this twin's path starts
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                runpy.run_path(os.path.join(HERE, "examples", script),
                               run_name="__main__")
        except SystemExit as e:
            if e.code not in (0, None):
                fail(f"{script} {argv} exited {e.code}")
        finally:
            sys.argv = saved
        launches = read_launches()            # ... and ends here
        runs.append(launches)
        text = tee.text()
        print(f"  {script}: {time.perf_counter() - t:.1f} s; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        if not re.search(line, text, re.M):
            fail(f"{script} {argv} printed no line matching {line!r}")
        for err in re.findall(r"\|err vs monolithic\| = (\S+)", text):
            if float(err) > SERVE_ATOL:
                fail(f"{script}: served logits {err} from the forward")
        missing = [n for n in need if not launches[n]]
        if missing:
            fail(f"{script} {argv} launched no {missing}")
        free_device()
    return runs


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
          "hybrid", "ssm", "moe", "ep", "spmd", "multimodal", "train",
          "launch", "examples")
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
    took = {}                           # phase -> seconds

    @contextlib.contextmanager
    def phase(name):
        print(f"== {name}")
        t = time.perf_counter()
        yield
        took[name] = round(time.perf_counter() - t, 1)
        print(f"== {name} took {took[name]:.1f} s")
    if "kernels" in phases:
        with phase("kernels"):
            tensor_core_check(logs)
            worst = kernel_phase(device)
    if "timing" in phases:
        with phase("timing"):
            timing = timing_phase(device)
    if "serve" in phases:
        with phase("serve"):
            runs.append(serve_phase(device, need=("flash_attention",
                                                  "flash_attention_lse"),
                                    after_fp32=rounding_sweep((28,))))
    if "decode" in phases:
        with phase("decode"):
            runs.append(decode_phase(device))
    if "server" in phases:
        with phase("server"):
            free_device()
            runs.append(server_phase(device))
    if "remote" in phases:
        with phase("remote"):
            free_device()
            runs.append(remote_phase(device))
    if "hybrid" in phases:
        with phase("hybrid"):
            free_device()
            runs.append(serve_phase(device, "hymba-1.5b", seed=2, hi=1536,
                                    n_long=1, exact=True,
                                    need=("flash_attention_lse", "ssm_scan"),
                                    after_fp32=rounding_sweep((4, 8, 16,
                                                               32))))
            free_device()
            runs.append(decode_phase(device, "hymba-1.5b",
                                     need=("decode_attention",
                                           "flash_attention_lse",
                                           "ssm_scan")))
    if "ssm" in phases:
        with phase("ssm"):
            free_device()
            sweep = rounding_sweep((2, 4, 8, 16, 32))

            def rwkv_checks(cfg, params):
                sweep(cfg, params)
                ssm_steps_check(cfg, params)
            runs.append(serve_phase(device, "rwkv6-7b", seed=3, exact=True,
                                    need=("wkv6_scan",),
                                    after_fp32=rwkv_checks))
    if "moe" in phases:
        with phase("moe"):
            free_device()
            runs.extend(moe_phase(device))
    if "ep" in phases:
        with phase("ep"):
            free_device()
            runs.extend(ep_phase(device))
    spmd_worst = {}
    if "spmd" in phases:
        with phase("spmd"):
            free_device()
            spmd_runs, spmd_worst = spmd_phase(device)
            runs.extend(spmd_runs)
    if "multimodal" in phases:
        with phase("multimodal"):
            free_device()
            runs.extend(multimodal_phase(device))
    if "train" in phases:
        with phase("train"):
            free_device()
            runs.extend(train_phase(device))
    launch_worst = {}
    if "launch" in phases:
        with phase("launch"):
            free_device()
            launch_runs, launch_worst = launch_phase(device)
            runs.extend(launch_runs)
            if "examples" not in phases:
                dryrun_sweep()
    if "examples" in phases:
        # the launch phase's dry-run sweep takes the host's cores while
        # the examples run
        with phase("examples" + (" and the dry-run sweep"
                                 if "launch" in phases else "")):
            free_device()
            runs.extend(dryrun_sweep(lambda: examples_phase(device))
                        if "launch" in phases else examples_phase(device))
    print(f"  phase seconds: {json.dumps(took)}")
    if phases != PHASES:
        print(f"== partial run ({', '.join(phases)}) done in "
              f"{time.perf_counter() - t_start:.1f} s: no record")
        return 0
    launches = {name: sum(r.get(name, 0) for r in runs) for name in KERNELS}
    print(f"  launches per path (serve, decode, server, remote, hybrid "
          f"serve, hybrid decode, ssm serve, olmoe serve, olmoe decode, "
          f"llama4 serve, ep bf16 forward, ep fp32 loss, spmd fp32 serve, "
          f"spmd fp32 train, spmd bf16 prefill, spmd long_500k decode, "
          f"whisper decode, "
          f"whisper serve, vision decode, vision serve, whisper fp32 "
          f"train, whisper bf16 train, fp32 train, bf16 train, launch "
          f"prefill_32k, decode_32k, long_500k, train_4k, then each "
          f"example run): {runs}")
    for name, errs in (*launch_worst.items(), *spmd_worst.items()):
        worst[name].update(errs)
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
