#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Graft on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it fails (non-zero exit, no result line) when
there is no card or no ``src/repro_torch`` beside it. Phases, in order:

1. device  — the card's name, count and power limit; builds the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (with ``-Xptxas -v``).
2. kernels — each kernel wrapper on the card against its plain PyTorch
   version on the same inputs: main-path shapes and edge shapes (prime
   S, sliding window, non-causal, GQA groups 1 and 4, head_dim 128/64/32,
   segments starting mid-tile), in float32 and bfloat16; then times the
   kernel, the plain version and a PyTorch library call at the main-path
   shapes with CUDA events.
3. serve   — full-width qwen3-1.7b (all 28 layers, random weights from a
   seeded generator on the card) through ``GraftPlanner.plan`` and
   ``GraftExecutor.serve`` over an ``InProcessTransport``, then
   ``apply_plan`` onto re-aligned depth-2 chains sharing one packed
   pool and a second wave; both in float32, every result held against
   the port's monolithic forward; then waves in bfloat16 for timing, the
   last one under ``torch.profiler`` (device time by kernel group).
   The kernels' launch counters are zeroed just before the serve waves
   and read just after; each must be > 0.

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it the kernels' JSON record, and the last line the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import os
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

def seg_ids(lengths, total, device):
    import torch
    ids = []
    for i, n in enumerate(lengths):
        ids += [i] * n
    ids += [len(lengths)] * (total - len(ids))     # pad tail: its own id
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


# (label, B, Sq, Sk, H, KV, hd, causal, window, segment lengths or None)
MAIN_PACKED = ("main packed", 1, 2048, 2048, 16, 8, 128, True, 0,
               [300, 517, 211, 489, 250, 181])
MAIN_PROMPT = ("main prompt", 1, 512, 512, 16, 8, 128, True, 0, None)
CASES = [
    MAIN_PACKED,
    MAIN_PROMPT,
    ("prime S, GQA 4", 2, 131, 131, 4, 1, 128, True, 0, None),
    ("window, GQA 1, hd 64", 1, 257, 257, 4, 4, 64, True, 64, None),
    ("non-causal Sq!=Sk, hd 32", 2, 97, 131, 8, 2, 32, False, 0, None),
    ("segments mid-tile, hd 64", 2, 200, 200, 8, 2, 64, True, 0,
     [13, 50, 71, 40]),
    ("segments + window, hd 32", 1, 173, 173, 4, 2, 32, True, 24,
     [5, 90, 61]),
]


def kernel_phase(device) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa

    print("  tolerances: float32 atol 2e-5 rtol 1e-3 (fp32 accumulation in "
          "both, summation order only); bfloat16 atol 2e-2 rtol 1e-2 (both "
          "round o to bf16, one ulp near 1 is 7.8e-3); lse atol 1e-4 (fp32 "
          "in both)")
    worst = {"flash_attention": {}, "flash_attention_lse": {}}
    gen = torch.Generator().manual_seed(0)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        atol, rtol = TOL[dname]
        for label, B, Sq, Sk, H, KV, hd, causal, window, segs in CASES:
            q = rand(gen, (B, Sq, H, hd), dtype, device)
            k = rand(gen, (B, Sk, KV, hd), dtype, device)
            v = rand(gen, (B, Sk, KV, hd), dtype, device)
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
    return worst


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    t_b = nbytes / H100_HBM_BPS * 1e3
    t_f = flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def timing_phase(device) -> dict:
    """Kernel, plain version and library call at the main-path shapes
    (bfloat16, the serving dtype; the L2 cache is warm, as for a kernel
    fed by the projection just before it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import _mask, _positions

    gen = torch.Generator().manual_seed(1)
    out = {}
    esz = 2
    for case, name in ((MAIN_PACKED, "flash_attention"),
                       (MAIN_PROMPT, "flash_attention_lse")):
        _, B, S, _, H, KV, hd, causal, window, segs = case
        q = rand(gen, (B, S, H, hd), torch.bfloat16, device)
        k = rand(gen, (B, S, KV, hd), torch.bfloat16, device)
        v = rand(gen, (B, S, KV, hd), torch.bfloat16, device)
        pos = _positions(S, B, device)
        mask = _mask(pos, pos, causal=causal, window=window)
        nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * esz
        if segs is not None:
            seg = seg_ids(segs, S, device)
            mask = mask & (seg[:, :, None] == seg[:, None, :])
            nbytes += B * S * 4
            run = lambda: fa.flash_attention(q, k, v, seg)         # noqa
            plain = lambda: fa.flash_attention_plain(q, k, v, seg)  # noqa
        else:
            nbytes += B * H * S * 4                                 # lse
            run = lambda: fa.flash_attention_lse(q, k, v)           # noqa
            plain = lambda: fa.flash_attention_lse_plain(q, k, v)   # noqa
        # QK^T and PV: 2 * hd multiply-adds per valid (q, k) pair and head
        pairs = int(mask.sum().item())
        flops = 4.0 * hd * H * pairs
        bms, by = bound(nbytes, flops, H100_BF16_FLOPS)
        # the library yardstick: SDPA (o only, no lse), with the packed
        # case's causal-and-segment mask given as a boolean mask
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_kw = dict(is_causal=True) if segs is None else \
            dict(attn_mask=mask[:, None])
        library = lambda: F.scaled_dot_product_attention(           # noqa
            qt, kt, vt, enable_gqa=True, **lib_kw)
        out[name] = {"ms": time_ms(run), "plain_ms": time_ms(plain),
                     "library_ms": time_ms(library), "bound_ms": bms,
                     "bound_by": by, "bytes": nbytes, "flops": flops,
                     "valid_pairs": pairs, "shape": (B, S, H, KV, hd)}
        r = out[name]
        print(f"  {name} bf16 {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library (SDPA) "
              f"{r['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}: "
              f"{nbytes} B, {flops:.3e} FLOP over {pairs} valid pairs)")
    return out


# ---------------------------------------------------------------------------
# phase 3: serving the main path
# ---------------------------------------------------------------------------

def make_wave(cfg, frags, rng):
    import numpy as np
    from repro_torch.serving import ServeRequest
    return [(ServeRequest(client=f.client,
                          tokens=rng.randint(0, cfg.vocab_size,
                                             int(rng.randint(128, 513)))
                          .astype(np.int32)), f.p) for f in frags]


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


# substrings of cuBLAS/CUTLASS matmul kernel names
MATMUL_NAMES = ("gemm", "xmma", "cutlass", "cublas", "nvjet")


def profile_wave(ex, reqs, label) -> None:
    """Serve one wave under ``torch.profiler`` and print where the device
    time went: kernel time by group, the device's busy share of the
    wave's wall time (profiling slows the host, so the share reads low)
    and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = serve_wave(ex, reqs, label)
    groups = {"attention kernels": 0.0, "matmul": 0.0, "memcpy/memset": 0.0,
              "other kernels": 0.0}
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        name = ev.key
        low = name.lower()
        if "attn_fwd_kernel" in name:
            g = "attention kernels"
        elif any(t in low for t in MATMUL_NAMES):
            g = "matmul"
        elif low.startswith(("memcpy", "memset")):
            g = "memcpy/memset"
        else:
            g = "other kernels"
        groups[g] += us
        rows.append((us, name))
    total = sum(groups.values())
    if total == 0:
        print(f"  {label}: the profiler saw no device time")
        return
    print(f"  {label}: device busy {total / 1e3:.1f} ms of {wall * 1e3:.1f} "
          f"ms wall ({100 * total / 1e6 / wall:.1f}%)")
    for g, us in groups.items():
        print(f"    {g}: {us / 1e3:.2f} ms ({100 * us / total:.1f}% of "
              "device time)")
    for us, name in sorted(rows, reverse=True)[:6]:
        print(f"    top: {us / 1e3:.2f} ms {name[:90]}")


def check_results(cfg, params, reqs, label):
    import torch
    from repro_torch.serving.smoke import check_against_monolithic
    for req, _ in reqs:
        r = req.result
        if tuple(r.shape) != (len(req.tokens), cfg.vocab_size) or \
                not torch.isfinite(r.float()).all():
            fail(f"{label}: {req.client} result {tuple(r.shape)} is not "
                 "finite logits of the expected shape")
    check_against_monolithic(cfg, params, reqs, atol=SERVE_ATOL,
                             rtol=SERVE_RTOL)
    print(f"  {label}: {len(reqs)} results match the monolithic forward "
          f"(atol {SERVE_ATOL:g}, rtol {SERVE_RTOL:g})")


def serve_phase(device) -> dict:
    """Serve the main path; returns the kernels' launch counts over the
    two float32 waves."""
    import numpy as np
    import torch
    from repro_torch.core import Fragment, GraftPlanner
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import GraftExecutor, InProcessTransport
    from repro_torch.serving.smoke import mixed_depth_plan, smoke_setup

    t0 = time.perf_counter()
    cfg, book, params = smoke_setup("qwen3-1.7b", full_width=True,
                                    dtype="float32", seq_len=512,
                                    device=device)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv, head_dim {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.n_layers} layers, {cfg.dtype}; "
          f"init {time.perf_counter() - t0:.1f} s")
    L = cfg.n_layers
    rng = np.random.RandomState(0)
    points = sorted(int(p) for p in rng.choice(L, size=6, replace=False))
    frags = [Fragment(cfg.name, p=p, t=float(40.0 + 40.0 * rng.rand()),
                      q=30.0, client=f"c{i}") for i, p in enumerate(points)]
    print(f"  clients' partition points: {points}")
    s = L // 2
    frags2 = [Fragment(cfg.name, min(f.p, s), f.t, f.q, client=f.client)
              for f in frags]
    plan = GraftPlanner(book).plan(frags)
    fa.reset_launches()                     # the main path starts here
    with GraftExecutor(plan, params, cfg,
                       InProcessTransport(max_frame_bytes=MAX_FRAME_BYTES),
                       device=device) as ex:
        reqs1 = make_wave(cfg, frags, rng)
        serve_wave(ex, reqs1, "wave 1 (planner plan)")
        after1 = dict(fa.LAUNCHES)
        diff = ex.apply_plan(mixed_depth_plan(cfg, book, frags2, s=s,
                                              batch=8))
        chains = {c: [k[1:] for k in keys]
                  for c, keys in ex.route_table().items()}
        print(f"  apply_plan: kept {diff.n_kept} pools; chains {chains}")
        reqs2 = make_wave(cfg, frags2, rng)
        serve_wave(ex, reqs2, "wave 2 (re-aligned, depth-2 chains)")
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)        # ... and ends here
        stats = ex.pool_stats()
    per_wave = [after1, {k: launches[k] - after1[k] for k in launches}]
    print(f"  kernel launches on the serving path: {launches} (per wave: "
          f"{per_wave})")
    for key, st in stats.items():
        print(f"    pool {key[1:]}: batches {st['n_batches']}, real tokens "
              f"{st['real_tokens']}, pad tokens {st['pad_tokens']}, "
              f"packed {st['packed']}, device {st['device']}")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the serving path never launched: {launches}")
    if not any(len(c) == 2 for c in chains.values()):
        fail("the re-aligned plan has no depth-2 chain")
    check_results(cfg, params, reqs1, "wave 1")
    check_results(cfg, params, reqs2, "wave 2")

    # the same path in bfloat16, timed (a warm-up wave first)
    cfg16, _, params16 = smoke_setup("qwen3-1.7b", full_width=True,
                                     dtype="bfloat16", seq_len=512,
                                     device=device)
    fa.reset_launches()
    with GraftExecutor(mixed_depth_plan(cfg16, book, frags2, s=s, batch=8),
                       params16, cfg16,
                       InProcessTransport(max_frame_bytes=MAX_FRAME_BYTES),
                       device=device) as ex:
        serve_wave(ex, make_wave(cfg16, frags2, rng), "bf16 warm-up wave")
        reqs3 = make_wave(cfg16, frags2, rng)
        serve_wave(ex, reqs3, "bf16 wave")
        profile_wave(ex, make_wave(cfg16, frags2, rng), "bf16 profiled wave")
    launches16 = dict(fa.LAUNCHES)
    print(f"  kernel launches, bf16 waves: {launches16}")
    for req, _ in reqs3:
        if not torch.isfinite(req.result.float()).all():
            fail(f"bf16 wave: {req.client} result is not finite")
    return launches


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

    print("== kernels")
    worst = kernel_phase(device)
    timing = timing_phase(device)

    print("== serve")
    launches = serve_phase(device)

    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:141",
                "flash_attention_lse":
                    "src/repro/kernels/flash_attention_bwd.py:86"}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": replaces[name],
         "launches": launches[name],
         "max_abs_err": max(worst[name].values()),
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"]}
        for name in ("flash_attention", "flash_attention_lse")]}
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
