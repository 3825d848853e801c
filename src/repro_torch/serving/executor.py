"""Real-execution serving data path: an ExecutionPlan run as PyTorch code.

Each stage pool runs ``run_fragment`` for its block range; requests
carry real tensors through mobile-part execution -> alignment stage ->
batched shared stage, exactly the paper's data path. On the card the
attention inside every fragment is the Hopper kernel
(``kernels/flash_attention.py``): the segment-masked one for packed pool
batches, the unsegmented one for the mobile part, the padded fallback
and the monolithic forward.

Every pool hop crosses a :class:`repro_torch.serving.transport.Transport`
channel — tensors are framed (length-prefixed msgpack) on the way in and
out even for the default :class:`InProcessTransport`, so the
serialization the paper's transmission budget pays for is always on the
measured path. A payload that arrives at a pool is moved to the pool's
device.

Pools are keyed by their ``core.plandiff`` identity ``(model, start,
end)``, so :meth:`GraftExecutor.apply_plan` can transition a *live*
deployment to a new plan: pools whose block range survives the replan
keep their queue instead of being rebuilt.

Full-range pools also serve autoregressive decode: a paged KV arena with
prefix sharing (``serving/kvcache.py``), a dense batched decode cache on
the pool's device stepped one token per call for every resident stream
(continuous batching: admissions and aborts at step boundaries), and
prefill/decode disaggregation — a prefill-role pool exports a prompt's
KV blocks over the transport and a decode-role pool imports them. On the
card every decode step's attention is the Hopper kernel
``kernels/decode_attention.py``.
"""
from __future__ import annotations

import functools
import itertools
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.placement import MOVE, migrate, place_pools
from repro_torch.core.plandiff import (diff_plans, plan_pools, pool_range,
                                       PlanDiff, PoolSpec)
from repro_torch.core.repartition import pool_key
from repro_torch.distributed import spmd
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import captured_launches
from repro_torch.models import n_fragment_units, resolve_device, run_fragment
from repro_torch.models import moe as moe_mod
from repro_torch.models.decode import (cache_len_for, decode_step,
                                       init_cache, prefill)
from repro_torch.models.packed import (_packed_forward, is_packable,
                                       pack_segments)
from repro_torch.serving.batcher import bucket_size, seq_bucket, token_bucket
from repro_torch.serving.kvcache import KVCacheOOM, PagedKVCache
from repro_torch.serving.simulator import _routing
from repro_torch.serving.telemetry import NULL as NULL_TELEMETRY
from repro_torch.serving.transport import (Channel, InProcessTransport,
                                           Transport, decode_kv_blocks,
                                           encode_kv_blocks, error_reply)

Tensor = torch.Tensor


@dataclass
class ServeRequest:
    client: str
    tokens: object                       # (S,) int32 numpy array or tensor
    extras: Optional[dict] = None
    result: Optional[Tensor] = None      # on the host, as the wire left it
    # -- decode (autoregressive) requests only --
    max_new_tokens: int = 0              # > 0 marks a decode request
    tpot_budget_ms: float = 0.0          # per-token SLO after the first
    out_tokens: Optional[list] = None    # generated token ids on completion


class PoolDrainingError(RuntimeError):
    """Enqueue refused: the pool was retargeted to batch 0 (draining)."""


class PlanRefused(RuntimeError):
    """``apply_plan`` refused a plan before changing anything: it would
    remove a pool that still holds work, or orphan a decode pool."""


def pool_endpoint(key: tuple) -> str:
    """Transport endpoint name for a pool identity. Role-qualified keys
    (decode pools coexisting with the prefill pool over the same block
    range) get a ``@role`` suffix so both endpoints can be served."""
    name = f"pool/{key[0]}/{key[1]}-{key[2]}"
    if len(key) > 3:
        name += f"@{key[3]}"
    return name


def _sig_tuple(x):
    """Recursively re-tuple a reuse signature that crossed msgpack
    (which decodes tuples as lists) so it is hashable again."""
    if isinstance(x, (list, tuple)):
        return tuple(_sig_tuple(e) for e in x)
    return x


def _params_device(params: dict) -> torch.device:
    """Where ``params`` lie (a worker's slice may hold no embedding)."""
    for v in params.values():
        if isinstance(v, dict):
            if v:
                return _params_device(v)
        else:
            return v.device
    raise ValueError("params hold no tensor")


def _extras_sig(extras: Optional[dict]) -> tuple:
    """Batchability signature of a request's extras: keys AND array
    shapes/dtypes. Requests batch together only when their extras are
    layout-compatible — and the compile-count key includes this."""
    if not extras:
        return ()
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in extras.items()))


def graph_engages(cache: dict) -> bool:
    """Whether a decode pool's step replays from a CUDA graph: its
    batched cache is plain tensors on a CUDA device. A CPU cache, or a
    DTensor one (an entry run under the sharding rules, whose step
    replaces the cache's tensors), steps eagerly."""
    return cache["pos"].device.type == "cuda" and not any(
        spmd.is_dtensor(v) for v in cache.values())


class StaticDecodeStep:
    """A decode pool's model step on static buffers: ``decode_step`` on
    the pool's batched cache and the (B, 1) int32 token buffer
    ``tokens``, with the new ``pos`` and ``kv_pos`` copied back into the
    cache, so that no storage of the cache moves between steps. Calling
    it with the host's tokens returns (the argmax tokens (B,) on the
    device, whether the step replayed a graph); ``logits`` holds the
    step's (B, 1, V) logits until the next step.

    Where :func:`graph_engages`, the first step after an eager one (which
    grew the kernels' scratch, chose the cuBLAS algorithms and loaded the
    libraries) is captured into a ``torch.cuda.CUDAGraph`` on a side
    stream, and it and every later step replay it on the stream eager
    launches use, so row 3's tickets are never shared by two launches in
    flight. The graph reads the cache's rows as admissions left them.
    A capture that raises (a host sync inside the step, say) is counted
    in ``fallbacks``, and the pool steps eagerly from then on; the step
    that tried runs eagerly, since a capture runs nothing."""

    def __init__(self, params, cfg: ModelConfig, cache: dict):
        self.params, self.cfg, self.cache = params, cfg, cache
        pos = cache["pos"]
        self.tokens = torch.zeros((pos.shape[0], 1), dtype=torch.int32,
                                  device=pos.device)
        self.engages = graph_engages(cache)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: tuple = ()         # the captured step's outputs
        self._tally = None            # its launches and scratch
        self.logits: Optional[Tensor] = None
        self.eager_steps = 0
        self.replays = 0
        self.fallbacks = 0

    def _body(self) -> tuple[Tensor, Tensor]:
        logits, new = decode_step(self.params, self.cfg, self.cache,
                                  self.tokens)
        for k, v in new.items():
            if v is not self.cache[k]:
                self.cache[k].copy_(v)
        return logits, torch.argmax(logits[:, -1], dim=-1)

    def _capture(self) -> None:
        dev = self.tokens.device
        try:
            graph = torch.cuda.CUDAGraph()
            torch.cuda.synchronize(dev)
            with captured_launches() as tally, torch.no_grad(), \
                    torch.cuda.stream(torch.cuda.Stream(dev)):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self._body()
                finally:
                    graph.capture_end()
        except Exception as e:           # the pool keeps serving, eagerly
            self.fallbacks += 1
            print(f"decode step capture failed, stepping eagerly: {e!r}",
                  file=sys.stderr)
            return
        self.graph, self._out, self._tally = graph, out, tally

    def __call__(self, toks: np.ndarray) -> tuple[Tensor, bool]:
        self.tokens.copy_(torch.from_numpy(toks))
        if self.graph is None and self.engages and self.eager_steps \
                and not self.fallbacks:
            self._capture()
        if self.graph is not None:
            self.graph.replay()
            self._tally.replayed()
            self.replays += 1
            self.logits, nxt = self._out
            return nxt, True
        self.logits, nxt = self._body()
        self.eager_steps += 1
        return nxt, False


def shares_prefixes(cfg: ModelConfig) -> bool:
    """Whether a decode pool of ``cfg`` reuses prompt prefixes across
    requests from its paged KV arena: the dense family, and moe where
    the dispatch never drops a token (``moe.dropless``), each with a
    float KV cache."""
    return (cfg.family == "dense"
            or (cfg.family == "moe" and moe_mod.dropless(cfg))) \
        and cfg.kv_cache_dtype != "int8"


class FragmentInstance:
    """One stage pool: its fragment program + a batching queue.

    A ``retarget`` to batch 0 puts the pool in *draining* mode: queued
    work still flushes (at batch 1) but new submissions are refused with
    :class:`PoolDrainingError`.

    ``layer_offset`` is the layer ``params["blocks"]`` starts at: a pool
    worker holds only the parameters its block range reads
    (``models.transformer.slice_params``).
    """

    def __init__(self, params, cfg: ModelConfig, spec: PoolSpec,
                 *, packed: bool = True, chips=None, decode_ctx: int = 0,
                 kv_blocks: int = 64, kv_block_tokens: int = 16,
                 telemetry=None, layer_offset: int = 0):
        self.cfg = cfg
        # in-process pools share the server's registry (merge-free);
        # worker processes get their own, which rides back on the
        # ``stats`` op as a snapshot and merges parent-side
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
        # True only when this instance's registry is private to a worker
        # process: then the stats snapshot may DRAIN spans (the parent
        # adopts them). An in-process pool shares the server's registry,
        # which must never be drained through the stats path.
        self.owns_telemetry = False
        self._m_exec_ms = self.telemetry.histogram("pool/exec_ms")
        self._m_batch_tokens = self.telemetry.histogram("pool/batch_tokens")
        self.key = spec.key
        self.start, self.end = spec.start, spec.end
        self.batch = spec.batch
        self.role = spec.role
        self.draining = spec.batch == 0
        # sequence-packed ragged execution for batchable families; the
        # pad-to-bucket path stays the fallback (models.packed.is_packable)
        self.packed = packed and is_packable(cfg)
        self._units = n_fragment_units(cfg)
        self.chips: list = list(chips) if chips else []   # placement binding
        self._params = params
        self.layer_offset = int(layer_offset)
        self.device = _params_device(params)
        self.queue: list = []
        self.n_batches = 0
        self.n_compiles = 0
        self.real_tokens = 0          # payload tokens actually requested
        self.pad_tokens = 0           # bucket-padding tokens executed
        self._shapes_seen: set = set()
        # -- decode (autoregressive) serving state, built lazily on the
        # first admission so one-shot pools pay nothing --
        self.decode_ctx = int(decode_ctx)
        self.kv_blocks = int(kv_blocks)
        self.kv_block_tokens = int(kv_block_tokens)
        self.kv: Optional[PagedKVCache] = None
        self._dc: Optional[dict] = None       # dense batched decode cache
        self._step: Optional[StaticDecodeStep] = None   # its model step
        self._slots: list = []                # per-row sequence state
        self.decode_admits = 0
        self.decode_steps = 0
        self.decode_tokens = 0                # admission firsts + step emits
        self.prefill_exports = 0              # cross-pool KV handoffs out
        self.kv_handoffs_in = 0               # cross-pool KV handoffs in
        # cross-request prefix sharing reconstructs a prompt's KV from the
        # paged arena alone, which only the attention-only families allow.
        # The arena keeps no int8 scales, so an int8 KV cache never shares;
        # nor does a moe dispatch that can drop tokens, since which
        # prefix tokens drop depends on the length of the prompt whose
        # prefill wrote the KV (the JAX package shares in both cases, and
        # a shared admission decodes other tokens than its unbatched
        # reference: ROADMAP.md §3)
        self._kv_share = shares_prefixes(cfg)

    def retarget(self, spec: PoolSpec) -> None:
        """Adopt a new pool shape; the block range is unchanged by
        construction (same PoolKey). Batch 0 is the drain signal."""
        if spec.key != self.key:
            raise ValueError(f"retarget of pool {self.key} to {spec.key}")
        self.batch = spec.batch
        self.role = spec.role
        self.draining = spec.batch == 0

    def submit(self, req: ServeRequest, payload: Tensor):
        if self.draining:
            raise PoolDrainingError(
                f"pool {self.key} is draining (batch=0): enqueue refused")
        self.queue.append((req, payload.to(self.device)))

    def flush(self):
        """Process queued requests in batches; returns [(req, output), ...].

        Each chunk is grouped by extras signature: requests with
        differing extras never share an execution. Packable groups run
        sequence-packed (payloads concatenate along the token axis, only
        the tail pads to ``token_bucket``); the rest take the
        pad-to-bucket path (each payload pads to its ``seq_bucket``,
        same-shape payloads stack, the batch pads to ``bucket_size`` by
        replicating the last row). Pad rows/tokens are sliced off before
        results leave the pool.
        """
        out = []
        step = max(self.batch, 1)
        while self.queue:
            chunk = self.queue[:step]
            del self.queue[:step]
            groups: dict = {}
            for req, payload in chunk:
                groups.setdefault(_extras_sig(req.extras), []).append(
                    (req, payload))
            for sig, grp in groups.items():
                if self.packed and not sig:
                    out.extend(self._run_packed(grp))
                else:
                    out.extend(self._run_padded(sig, grp))
        return out

    def _call_counted(self, fn, *args, shape_key, **kwargs):
        """Run a fragment program, counting distinct input shapes.

        PyTorch runs eagerly and keeps no compile cache, so
        ``n_compiles`` counts first sightings of the full shape key
        (which includes extras shapes/dtypes) — the JAX package's
        fallback count, and the number of programs a shape-keyed
        compiler would build."""
        if shape_key not in self._shapes_seen:
            self._shapes_seen.add(shape_key)
            self.n_compiles += 1
        return fn(*args, **kwargs)

    def _run_packed(self, grp: list) -> list:
        """Sequence-packed execution of one extras-free group."""
        payloads = [p for _, p in grp]
        lengths = [int(p.shape[0]) for p in payloads]
        total = sum(lengths)
        T = token_bucket(total)
        seg, pos, cu = pack_segments(lengths, T)
        cat = torch.cat(payloads, dim=0)
        if T > total:
            cat = torch.cat([cat, cat.new_zeros((T - total, *cat.shape[1:]))])
        dev = self.device
        t0 = time.perf_counter()
        y = self._call_counted(
            _packed_forward, self._params, cat[None],
            torch.from_numpy(seg).to(dev)[None],
            torch.from_numpy(pos).to(dev)[None],
            self.start - self.layer_offset,
            cfg=self.cfg, depth=self.end - self.start,
            embed=self.start == 0, head=self.end == self._units,
            shape_key=("packed", tuple(cat.shape), str(cat.dtype)))
        self._m_exec_ms.record((time.perf_counter() - t0) * 1e3)
        self._m_batch_tokens.record(total)
        self.n_batches += 1
        self.real_tokens += total
        self.pad_tokens += T - total
        return [(req, y[0, int(cu[i]):int(cu[i + 1])])
                for i, (req, _) in enumerate(grp)]

    def _run_padded(self, sig: tuple, grp: list) -> list:
        """Pad-to-bucket execution of one extras-signature group, with
        per-request extras stacked along the batch axis."""
        by_shape: dict = {}
        for req, p in grp:
            S = int(p.shape[0])
            Sp = seq_bucket(S)
            by_shape.setdefault((Sp,) + tuple(p.shape[1:]), []).append(
                (req, p, S))
        out = []
        for shp, items in by_shape.items():
            Sp = shp[0]
            padded = [torch.cat([p, p.new_zeros((Sp - S, *p.shape[1:]))])
                      if Sp != S else p for _, p, S in items]
            n = len(padded)
            tgt = bucket_size(n, max(self.batch, 1))
            padded.extend(padded[-1:] * (tgt - n))
            stacked = torch.stack(padded)
            extras = self._stack_extras([r.extras for r, _, _ in items], tgt,
                                        self.device)
            t0 = time.perf_counter()
            y = self._call_counted(
                run_fragment, self._params, self.cfg, stacked, self.start,
                self.end, extras=extras, offset=self.layer_offset,
                shape_key=(tuple(stacked.shape), str(stacked.dtype), sig))
            self._m_exec_ms.record((time.perf_counter() - t0) * 1e3)
            real = sum(S for _, _, S in items)
            self._m_batch_tokens.record(real)
            self.n_batches += 1
            self.real_tokens += real
            self.pad_tokens += tgt * Sp - real
            out.extend((req, y[i, :S] if Sp != S else y[i])
                       for i, (req, _, S) in enumerate(items))
        return out

    @staticmethod
    def _stack_extras(extras_list: list, tgt: int,
                      device) -> Optional[dict]:
        """Stack per-request extras along the batch axis (replicating the
        last request's extras for batch-bucket pad rows). All entries in
        a group share one extras signature, so shapes line up."""
        if not extras_list or not extras_list[0]:
            return None
        rows = list(extras_list) + [extras_list[-1]] * (tgt - len(extras_list))
        return {k: torch.cat([torch.as_tensor(e[k]) for e in rows]).to(device)
                for k in extras_list[0]}

    # ------------------------------------------------------ decode serving
    @property
    def can_decode(self) -> bool:
        """Decode runs on pools holding the FULL block range (the cache
        spans every layer), for families whose per-row cache state copies
        cleanly between a solo admission cache and the batched one, with
        a context that fits the dense cache without ring wraparound so
        cache slot == absolute position and arena extraction is exact.
        (dense/moe/hybrid — vlm/audio need extras, ssm has no KV.)"""
        return (self.decode_ctx > 0 and self.start == 0
                and self.end == self._units
                and self.cfg.family in ("dense", "moe", "hybrid")
                and cache_len_for(self.cfg, self.decode_ctx)
                == self.decode_ctx)

    def _ensure_decode(self) -> None:
        if self._dc is not None:
            return
        B = max(self.batch, 1)
        dc = init_cache(self.cfg, B, self.decode_ctx, device=self.device)
        self.kv = PagedKVCache(self.kv_blocks, self.kv_block_tokens,
                               n_layers=self.cfg.n_layers,
                               n_kv_heads=self.cfg.n_kv_heads,
                               head_dim=self.cfg.head_dim_,
                               telemetry=self.telemetry)
        self._dc = dc
        self._step = StaticDecodeStep(self._params, self.cfg, dc)
        self._slots = [None] * B

    @staticmethod
    def _row_axis(key: str) -> int:
        """Batch axis of a decode-cache entry: per-row vectors lead with
        it; layer-stacked tensors carry it second."""
        return 0 if key in ("pos", "kv_pos") else 1

    def _copy_row(self, dst: dict, src: dict, i: int) -> dict:
        """Write the B=1 cache ``src`` into row ``i`` of batched ``dst``,
        in place: every entry, hybrid's ``ssm_conv``/``ssm_scan`` too."""
        for k, v in dst.items():
            if self._row_axis(k) == 0:
                v[i].copy_(src[k][0])
            else:
                v[:, i].copy_(src[k][:, 0])
        return dst

    def _solo_prefill(self, rid: int, toks: np.ndarray, n_shared: int):
        """B=1 prompt processing for one admission: the first generated
        token, the cache row, and the arena-bound suffix KV on the host
        (:meth:`_prefill_row`, then :meth:`_suffix_kv`)."""
        first, c1 = self._prefill_row(rid, toks, n_shared)
        return (first, c1, *self._suffix_kv(c1, n_shared,
                                            int(toks.shape[0])))

    def _prefill_row(self, rid: int, toks: np.ndarray, n_shared: int):
        """Gather the shared prefix KV from the paged arena (keeping at
        least the LAST prompt token to recompute, so a fully-shared
        prompt still yields first-token logits), step the remainder, and
        return the first generated token (read on the host) and the B=1
        cache row. A pool that shares no prefix (``_kv_share`` False:
        hybrid, whose scan state the arena does not hold, and an int8
        cache) never gathers: its prompt always runs whole through
        ``prefill``."""
        cfg, S, dev = self.cfg, int(toks.shape[0]), self.device
        # prefix positions gathered
        pop = min(n_shared, S - 1) if self._kv_share else 0
        if pop == 0:
            logits, c1 = prefill(self._params, cfg,
                                 torch.from_numpy(toks).to(dev)[None],
                                 cache_seq=self.decode_ctx)
        else:
            c1 = init_cache(cfg, 1, self.decode_ctx, device=dev)
            k, v = self.kv.gather(rid, pop)   # (pop, L, KV, hd) float32
            c1["k"][:, 0, :pop] = torch.from_numpy(k).to(dev).transpose(0, 1)
            c1["v"][:, 0, :pop] = torch.from_numpy(v).to(dev).transpose(0, 1)
            c1["kv_pos"][0, :pop] = torch.arange(pop, dtype=torch.int32,
                                                 device=dev)
            c1["pos"].fill_(pop)
            logits = None
            for t in toks[pop:]:
                logits, c1 = decode_step(
                    self._params, cfg, c1,
                    torch.tensor([[int(t)]], dtype=torch.int32, device=dev))
        return int(torch.argmax(logits[0, -1])), c1

    @staticmethod
    def _suffix_kv(c1: dict, n_shared: int, S: int) -> tuple:
        """The arena-bound suffix KV of a solo cache, on the host: only
        positions [n_shared, S) cross, never the whole (L, 1, decode_ctx,
        KV, hd) cache."""
        ks = c1["k"][:, 0, n_shared:S].float().transpose(0, 1).cpu().numpy()
        vs = c1["v"][:, 0, n_shared:S].float().transpose(0, 1).cpu().numpy()
        return ks, vs

    def _phase(self, span: tuple, mark, name: str,
               args: Optional[dict] = None) -> None:
        """Close ``mark``, one phase of the traced call ``span`` = (rid,
        parent sid), as the parent's child."""
        self.telemetry.end(mark, name, "pool", rid=span[0],
                           tid=pool_endpoint(self.key), args=args,
                           parent=span[1])

    def prefill_export(self, rid: int, client: str, tokens,
                       sig: tuple) -> dict:
        """Disaggregated prefill: run the prompt through this pool's
        arena (prefix sharing included), export the resulting KV blocks
        for the cross-pool handoff, and return the FIRST generated token.
        No decode slot is consumed: prefill-role pools never hold a
        resident stream. The arena retains the blocks (``_kv_share``
        families) so repeat prompts re-export without recompute."""
        if self.draining:
            raise PoolDrainingError(
                f"pool {self.key} is draining (batch=0): enqueue refused")
        if not self.can_decode or self.role == "decode":
            return {"exported": False, "reason": "not_prefill_capable"}
        self._ensure_decode()
        toks = np.asarray(tokens, np.int32).reshape(-1)
        S = int(toks.shape[0])
        if S + 1 > self.decode_ctx:
            return {"exported": False, "reason": "ctx_overflow"}
        if not self.kv.has_room(S):
            return {"exported": False, "reason": "kv_oom"}
        key = tuple(sig) if self._kv_share else ("solo", rid)
        try:
            n_shared = self.kv.begin(rid, key, toks)
        except KVCacheOOM:
            return {"exported": False, "reason": "kv_oom"}
        first, _c1, ks, vs = self._solo_prefill(rid, toks, n_shared)
        self.kv.write_prompt_kv(rid, ks, vs)
        payload = self.kv.export_prefix(rid)
        self.kv.finish(rid, retain=self._kv_share)
        self.prefill_exports += 1
        self.decode_tokens += 1
        return {"exported": True, "tok": first, "n_shared": n_shared,
                "kv": encode_kv_blocks(payload)}

    def decode_admit(self, rid: int, client: str, tokens, max_new: int,
                     sig: tuple, handoff: Optional[dict] = None,
                     span: Optional[tuple] = None) -> dict:
        """Admit one sequence into the continuous decode batch: paged-KV
        admission (with prefix sharing), solo prefill of the prompt, row
        copy into a free batch slot. Produces the FIRST generated token.
        Refusals are soft (``admitted`` False with a reason).

        ``handoff`` is a decoded KV-block envelope from a prefill pool's
        :meth:`prefill_export`: its blocks seed this arena's prefix index
        under the exporter's chain keys BEFORE ``begin`` runs, so the
        prompt admits fully shared (only the last position recomputes).
        A partial import (receiver OOM) just lowers ``n_shared``.

        ``span`` = (rid, sid) of a traced caller's ``decode/admit`` span:
        the prefill and the KV's trip to the host arena become its
        children."""
        if self.draining:
            raise PoolDrainingError(
                f"pool {self.key} is draining (batch=0): enqueue refused")
        if self.role == "prefill":
            return {"admitted": False, "reason": "role_prefill"}
        if not self.can_decode:
            return {"admitted": False, "reason": "not_decode_capable"}
        self._ensure_decode()
        toks = np.asarray(tokens, np.int32).reshape(-1)
        S = int(toks.shape[0])
        max_new = max(int(max_new), 1)
        if S + max_new > self.decode_ctx:
            return {"admitted": False, "reason": "ctx_overflow"}
        try:
            slot = self._slots.index(None)
        except ValueError:
            return {"admitted": False, "reason": "no_slot"}
        if not self.kv.has_room(S + max_new):
            return {"admitted": False, "reason": "kv_oom"}
        if handoff is not None and self._kv_share:
            self.kv.import_prefix(handoff["sig"], handoff["blocks"])
            self.kv_handoffs_in += 1
        key = tuple(sig) if self._kv_share else ("solo", rid)
        try:
            n_shared = self.kv.begin(rid, key, toks)
        except KVCacheOOM:
            return {"admitted": False, "reason": "kv_oom"}
        if span is not None:
            mark = self.telemetry.begin()
        first, c1 = self._prefill_row(rid, toks, n_shared)
        if span is not None:
            self._phase(span, mark, "decode/admit/prefill",
                        {"n_tokens": S, "n_shared": n_shared})
            mark = self.telemetry.begin()
        ks, vs = self._suffix_kv(c1, n_shared, S)
        self.kv.write_prompt_kv(rid, ks, vs)
        if span is not None:
            self._phase(span, mark, "decode/admit/kv_out",
                        {"d2h_bytes": ks.nbytes + vs.nbytes,
                         "n_tokens": S - n_shared})
        done = max_new == 1
        if done:
            self.kv.finish(rid, retain=self._kv_share)
        else:
            self._copy_row(self._dc, c1, slot)
            self._slots[slot] = {"rid": rid, "client": client,
                                 "max_new": max_new, "n_gen": 1,
                                 "last": first, "out": [first],
                                 "prompt_len": S}
        self.decode_admits += 1
        self.decode_tokens += 1
        return {"admitted": True, "tok": first, "done": done,
                "n_shared": n_shared,
                "tokens": [first] if done else None,
                "active": self.decode_active,
                "free_slots": self.decode_free_slots}

    def resident_rids(self) -> list:
        """The decode streams holding a slot, in slot order."""
        return [s["rid"] for s in self._slots if s]

    def decode_step_batch(self, span: Optional[tuple] = None) -> dict:
        """ONE iteration of the continuous decode batch: every resident
        sequence advances a token; finished sequences free their KV
        blocks and vacate their slot WITHOUT stalling the rest. Returns
        per-sequence events plus slot occupancy, which says how many
        admissions fit at this step boundary.

        ``span`` = (rid, sid) of a traced caller's ``decode/step`` span:
        the step's phases become its children (``prep``, ``forward``,
        ``tokens``: the wait for the step's kernels, ``kv_out``,
        ``arena``)."""
        active = [i for i, s in enumerate(self._slots) if s]
        if not active:
            return {"events": [], "active": 0,
                    "free_slots": len(self._slots)}
        if span is not None:
            tel = self.telemetry
            mark = tel.begin()
        B, dev = len(self._slots), self.device
        toks = np.zeros((B, 1), np.int32)
        for i in active:
            toks[i, 0] = self._slots[i]["last"]
        # a host copy taken before the step: the step advances pos
        pos_before = self._dc["pos"].cpu().numpy().copy()
        if span is not None:
            self._phase(span, mark, "decode/step/prep")
            mark = tel.begin(cpu=True)
        nxt, graphed = self._call_counted(self._step, toks,
                                          shape_key=("decode", B))
        if span is not None:
            self._phase(span, mark, "decode/step/forward",
                        {"graph": graphed})
            mark = tel.begin()
        nxt = nxt.cpu().numpy()
        if span is not None:
            self._phase(span, mark, "decode/step/tokens")
            mark = tel.begin()
        # slice on the device first: only the active rows' new slot
        # ((L, n_active, KV, hd), slot == position under can_decode)
        # crosses to the host, never the whole batched cache
        rows = torch.tensor(active, device=dev)
        at = torch.from_numpy(pos_before[active].astype(np.int64)).to(dev)
        k_new = self._dc["k"][:, rows, at].float().cpu().numpy()
        v_new = self._dc["v"][:, rows, at].float().cpu().numpy()
        if span is not None:
            self._phase(span, mark, "decode/step/kv_out",
                        {"d2h_bytes": k_new.nbytes + v_new.nbytes,
                         "rows": len(active)})
            mark = tel.begin()
        events = []
        for j, i in enumerate(active):
            s = self._slots[i]
            ev = {"rid": s["rid"], "client": s["client"]}
            try:
                self.kv.append(s["rid"], int(toks[i, 0]),
                               k_new[:, j], v_new[:, j])
            except KVCacheOOM:
                # admission reserved nothing: under pressure a boundary
                # alloc can fail mid-stream — surface it as a forced
                # finish instead of wedging the batch
                self.kv.release(s["rid"])
                self._slots[i] = None
                ev.update(done=True, oom=True, n_gen=s["n_gen"],
                          tokens=list(s["out"]))
                events.append(ev)
                continue
            tok = int(nxt[i])
            s["out"].append(tok)
            s["last"] = tok
            s["n_gen"] += 1
            done = s["n_gen"] >= s["max_new"]
            ev.update(tok=tok, done=done, n_gen=s["n_gen"])
            if done:
                ev["tokens"] = list(s["out"])
                self.kv.finish(s["rid"], retain=self._kv_share)
                self._slots[i] = None
            events.append(ev)
        if span is not None:
            self._phase(span, mark, "decode/step/arena",
                        {"rows": len(active)})
        self.decode_steps += 1
        self.decode_tokens += len(active)
        return {"events": events,
                "active": sum(1 for s in self._slots if s),
                "free_slots": sum(1 for s in self._slots if s is None)}

    def decode_abort(self, rid: int) -> bool:
        """Evict one resident sequence (mid-decode shed): free its KV
        blocks without retention, vacate the slot."""
        for i, s in enumerate(self._slots):
            if s and s["rid"] == rid:
                self.kv.release(rid)
                self._slots[i] = None
                return True
        return False

    @property
    def decode_active(self) -> int:
        return sum(1 for s in self._slots if s)

    @property
    def decode_graph_steps(self) -> int:
        """Decode steps that replayed the pool's CUDA graph."""
        return self._step.replays if self._step else 0

    @property
    def decode_graph_fallbacks(self) -> int:
        """Captures of the step that raised (the pool then steps
        eagerly)."""
        return self._step.fallbacks if self._step else 0

    @property
    def decode_free_slots(self) -> int:
        if self._dc is None:
            return max(self.batch, 1) if self.can_decode else 0
        return sum(1 for s in self._slots if s is None)



class PoolService:
    """Server-side adapter: transport messages -> FragmentInstance ops.

    The message vocabulary is the executor<->pool protocol, so local and
    remote pools are interchangeable behind a channel.
    """

    def __init__(self, inst: FragmentInstance):
        self.inst = inst
        # several channels may reach one pool; the pool is one resource,
        # so its ops serialize here
        self._lock = threading.Lock()
        # rids whose wire items carried the trace-sampling flag: their
        # exec/decode spans close here, on the pool side of the hop
        self._traced: set = set()
        self._dtraced: set = set()            # traced resident decode rids
        self._pool_tid = pool_endpoint(inst.key)

    def handle(self, msg: dict) -> dict:
        try:
            with self._lock:
                return self._dispatch(msg)
        except Exception as e:                       # error crosses the wire
            return error_reply(e)

    def _enqueue(self, item: dict) -> None:
        req = ServeRequest(client=item["client"], tokens=None,
                           extras=item.get("extras") or None)
        req._rid = item["req_id"]
        if item.get("trace"):
            self._traced.add(item["req_id"])
        self.inst.submit(req, torch.as_tensor(item["payload"]))

    def _flush_reply(self) -> dict:
        inst = self.inst
        if self._traced:
            mark = inst.telemetry.begin(cpu=True)
            real0, pad0 = inst.real_tokens, inst.pad_tokens
        done = inst.flush()
        rids = [req._rid for req, _ in done]
        traced = [r for r in rids if r in self._traced]
        if traced:
            self._traced.difference_update(traced)
            inst.telemetry.end(
                mark, "exec", "pool", rid=traced[0], tid=self._pool_tid,
                args={"rids": traced, "n_batch": len(rids),
                      "real_tokens": inst.real_tokens - real0,
                      "pad_tokens": inst.pad_tokens - pad0})
        return {"ok": True,
                "results": [{"req_id": req._rid, "payload": y}
                            for req, y in done]}

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        inst = self.inst
        if op == "submit":
            self._enqueue(msg)
            return {"ok": True, "queued": len(inst.queue)}
        if op == "flush":
            return self._flush_reply()
        if op == "execute":
            # batched submit + flush in ONE round trip
            for it in msg["items"]:
                self._enqueue(it)
            return self._flush_reply()
        if op == "retarget":
            inst.retarget(PoolSpec(key=tuple(msg["key"]),
                                   share=msg["share"], batch=msg["batch"],
                                   n_instances=msg["n_instances"],
                                   role=msg.get("role", "both")))
            return {"ok": True}
        if op == "bind":
            # placement binding: which chip each of this pool's instances
            # runs on
            inst.chips = [int(c) for c in msg["chips"]]
            return {"ok": True}
        if op == "prefill":
            trace = msg.get("trace")
            if trace:
                mark = inst.telemetry.begin()
            r = inst.prefill_export(msg["req_id"], msg["client"],
                                    np.asarray(msg["tokens"], np.int32),
                                    _sig_tuple(msg.get("sig") or ()))
            if trace and r.get("exported"):
                inst.telemetry.end(
                    mark, "decode/prefill", "pool", rid=msg["req_id"],
                    tid=self._pool_tid,
                    args={"n_shared": r.get("n_shared", 0)})
            return {"ok": True, **r}
        if op == "dadmit":
            trace = msg.get("trace")
            if trace:
                mark = inst.telemetry.begin()
            handoff = msg.get("kv")
            if handoff is not None:
                # validate on the receiving side of the hop: a mangled
                # envelope is a FrameError reply, not an arena crash
                handoff = decode_kv_blocks(handoff)
            r = inst.decode_admit(msg["req_id"], msg["client"],
                                  np.asarray(msg["tokens"], np.int32),
                                  msg["max_new"],
                                  _sig_tuple(msg.get("sig") or ()),
                                  handoff=handoff,
                                  span=(msg["req_id"], mark.sid)
                                  if trace else None)
            if trace and r.get("admitted"):
                inst.telemetry.end(
                    mark, "decode/admit", "pool", rid=msg["req_id"],
                    tid=self._pool_tid,
                    args={"n_shared": r.get("n_shared", 0)})
                if not r.get("done"):
                    self._dtraced.add(msg["req_id"])
            return {"ok": True, **r}
        if op == "dstep":
            # the traced streams this step advances: its span and its
            # phases' are recorded when there is one
            traced = self._dtraced and [rid for rid in inst.resident_rids()
                                        if rid in self._dtraced]
            if traced:
                mark = inst.telemetry.begin()
            r = inst.decode_step_batch(
                span=(traced[0], mark.sid) if traced else None)
            if traced:
                inst.telemetry.end(
                    mark, "decode/step", "pool", rid=traced[0],
                    tid=self._pool_tid,
                    args={"rids": traced, "active": r["active"]})
                self._dtraced.difference_update(
                    ev["rid"] for ev in r["events"] if ev.get("done"))
            return {"ok": True, **r}
        if op == "dabort":
            self._dtraced.discard(msg["req_id"])
            return {"ok": True, "aborted": inst.decode_abort(msg["req_id"])}
        if op == "stats":
            tel = inst.telemetry
            return {"ok": True, "pid": os.getpid(),
                    "queue_len": len(inst.queue),
                    "n_batches": inst.n_batches,
                    "n_compiles": inst.n_compiles,
                    "real_tokens": inst.real_tokens,
                    "pad_tokens": inst.pad_tokens,
                    "packed": inst.packed,
                    "device": str(inst.device),
                    "chips": list(inst.chips),
                    "draining": inst.draining,
                    "role": inst.role,
                    "decode_active": inst.decode_active,
                    "decode_free_slots": inst.decode_free_slots,
                    "decode_admits": inst.decode_admits,
                    "decode_steps": inst.decode_steps,
                    "decode_graph_steps": inst.decode_graph_steps,
                    "decode_graph_fallbacks": inst.decode_graph_fallbacks,
                    "decode_tokens": inst.decode_tokens,
                    "prefill_exports": inst.prefill_exports,
                    "kv_handoffs_in": inst.kv_handoffs_in,
                    "kv": inst.kv.stats() if inst.kv else None,
                    # prefix-residency digest for KV-affinity pool choice
                    "kv_residency": list(inst.kv.residency_digest())
                    if inst.kv else [],
                    # this process's kernel launches: a worker's ride
                    # back here, so a parent counts them too
                    "launches": launch_counts(),
                    # worker-side registry rides back here and merges
                    # parent-side (span drain hands ownership over)
                    "telemetry": tel.snapshot(
                        drain_spans=inst.owns_telemetry)
                    if tel.enabled else None}
        if op == "launches":
            return {"ok": True, "pid": os.getpid(),
                    "launches": launch_counts(reset=bool(msg.get("reset")))}
        raise ValueError(f"unknown pool op {op!r}")


class PoolHandle:
    """Client-side proxy for one stage pool behind a transport channel.

    A per-handle lock serializes channel use so the handle is safe to
    share between threads; the wire hop measurement in :meth:`submit`
    reads the channel's last sample inside the same critical section."""

    def __init__(self, key: tuple, channel: Channel, telemetry=None):
        self.key = key
        self.channel = channel
        if telemetry is not None:          # the channel's frame spans
            channel.attach(telemetry)
        self._lock = threading.Lock()

    def _check(self, reply: dict) -> dict:
        if not reply.get("ok"):
            err = reply.get("error", "unknown transport error")
            if reply.get("etype") == PoolDrainingError.__name__:
                raise PoolDrainingError(err)
            raise RuntimeError(f"pool {self.key}: {err}")
        return reply

    def _call(self, msg: dict) -> dict:
        with self._lock:
            reply = self.channel.request(msg)
        return self._check(reply)

    def submit(self, req_id: int, client: str, payload: Tensor,
               extras: Optional[dict] = None, *,
               trace: bool = False) -> Optional[tuple]:
        """Enqueue one payload; returns the measured (nbytes, ms) hop,
        or None when the channel produced no sample for this request
        (callers then record nothing). ``trace`` rides the wire so the
        pool-side exec span closes on the right hop."""
        msg = {"op": "submit", "req_id": req_id, "client": client,
               "payload": payload, "extras": extras}
        if trace:
            msg["trace"] = True
        with self._lock:
            reply = self.channel.request(msg)
            sample = self.channel.stats.samples[-1] \
                if self.channel.stats.samples else None
        self._check(reply)
        if sample is None:
            return None
        _, nbytes, ms = sample
        return nbytes, ms

    def flush(self, trace_rid: Optional[int] = None) -> list:
        """Run the pool's queued batch; ``trace_rid``, a traced request
        in it, traces the flush's frames under that id."""
        msg = {"op": "flush"}
        if trace_rid is not None:
            msg.update(trace=True, req_id=trace_rid)
        reply = self._call(msg)
        return [(r["req_id"], r["payload"]) for r in reply["results"]]

    def execute(self, items: list) -> list:
        """Submit a whole batch and flush it in one round trip.

        ``items``: [(req_id, client, payload, extras), ...]; an optional
        fifth element flags a trace-sampled request. Returns
        [(req_id, payload), ...] for everything the flush produced."""
        reply = self._call({"op": "execute", "items": [
            {"req_id": it[0], "client": it[1], "payload": it[2],
             "extras": it[3],
             **({"trace": True} if len(it) > 4 and it[4] else {})}
            for it in items]})
        return [(r["req_id"], r["payload"]) for r in reply["results"]]

    def decode_admit(self, req_id: int, client: str, tokens,
                     max_new: int, sig: tuple = (), *,
                     handoff: Optional[dict] = None,
                     trace: bool = False) -> dict:
        """Admit one sequence into the pool's continuous decode batch;
        the reply carries the FIRST generated token (or a soft refusal
        with ``admitted`` False and a reason). ``handoff`` is an encoded
        KV-block envelope from :meth:`prefill_export` — it crosses this
        hop and seeds the pool arena's prefix index before admission."""
        msg = {"op": "dadmit", "req_id": req_id, "client": client,
               "tokens": np.asarray(tokens, np.int32),
               "max_new": int(max_new), "sig": list(sig)}
        if handoff is not None:
            msg["kv"] = handoff
        if trace:
            msg["trace"] = True
        return self._call(msg)

    def prefill_export(self, req_id: int, client: str, tokens,
                       sig: tuple = (), *, trace: bool = False) -> dict:
        """Disaggregated prompt prefill on a prefill-role pool; the reply
        carries the first generated token plus the KV-block envelope to
        hand a decode pool (or ``exported`` False with a reason)."""
        msg = {"op": "prefill", "req_id": req_id, "client": client,
               "tokens": np.asarray(tokens, np.int32), "sig": list(sig)}
        if trace:
            msg["trace"] = True
        return self._call(msg)

    def decode_step(self) -> dict:
        """Advance the decode batch one iteration; returns events plus
        slot occupancy."""
        return self._call({"op": "dstep"})

    def decode_abort(self, req_id: int) -> bool:
        return bool(self._call({"op": "dabort",
                                "req_id": req_id}).get("aborted"))

    def retarget(self, spec: PoolSpec) -> None:
        self._call({"op": "retarget", "key": list(spec.key),
                    "share": spec.share, "batch": spec.batch,
                    "n_instances": spec.n_instances, "role": spec.role})

    def bind(self, chips: list) -> None:
        """Tell the pool which chip each instance is placed on."""
        self._call({"op": "bind", "chips": [int(c) for c in chips]})

    def stats(self) -> dict:
        return self._call({"op": "stats"})

    def launches(self, *, reset: bool = False) -> dict:
        """Kernel launch counts of the process running this pool
        (``reset`` zeroes them after reading)."""
        return self._call({"op": "launches", "reset": bool(reset)})[
            "launches"]

    def queue_len(self) -> int:
        return int(self.stats()["queue_len"])

    def close(self) -> None:
        self.channel.close()


class GraftExecutor:
    """Deploys an ExecutionPlan for ONE model, routing every pool hop
    through ``transport`` (default: in-process loopback with full wire
    framing). ``device`` (None = the card) is where the pools run; the
    params must already lie there.

    ``decode_ctx`` > 0 makes full-range pools decode-capable: each owns a
    paged KV arena of ``kv_blocks`` x ``kv_block_tokens`` token slots.
    Plans that declare prefill- and decode-role pools deploy only with
    ``decode_disagg=True``."""

    def __init__(self, plan: ExecutionPlan, params, cfg: ModelConfig,
                 transport: Optional[Transport] = None, *,
                 packed: bool = True, decode_ctx: int = 0,
                 kv_blocks: int = 64, kv_block_tokens: int = 16,
                 decode_disagg: bool = False, telemetry=None, device=None):
        self.device = resolve_device(device)
        have = _params_device(params)
        if have.type != self.device.type or (
                self.device.index is not None and have != self.device):
            raise ValueError(f"params lie on {have}, executor device is "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.packed = packed
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
        self.decode_ctx = int(decode_ctx)
        self.kv_blocks = int(kv_blocks)
        self.kv_block_tokens = int(kv_block_tokens)
        # a role-annotated plan never lands on an executor that was not
        # told to run the two-phase (prefill -> KV handoff -> decode) admit
        self.decode_disagg = bool(decode_disagg)
        self.transport = transport if transport is not None \
            else InProcessTransport()
        self.transport.attach(self.telemetry)
        self._handles: dict[tuple, PoolHandle] = {}
        self._fragment_fns: dict[tuple, object] = {}
        self._rid = itertools.count()
        self._by_rid: dict[int, ServeRequest] = {}
        # (client, nbytes, ms) per measured uplink hop, bounded
        self.uplink: deque = deque(maxlen=65_536)
        self.stats = {"pools_created": 0, "pools_reused": 0,
                      "pools_removed": 0, "plan_applies": 0,
                      "instances_spawned": 0, "instances_retired": 0,
                      "instances_moved": 0}
        self.placement = None                 # set by the first _deploy
        self.last_migrations: list = []       # chip actions of the last apply
        self._bound: dict[tuple, tuple] = {}  # key -> chips last pushed
        self._deploy(plan)

    # ------------------------------------------------------------- pools
    def _spawn_pool(self, spec: PoolSpec) -> PoolHandle:
        """Create a pool and return its handle. ``RemoteExecutor``
        overrides this to spawn a worker process instead."""
        svc = PoolService(FragmentInstance(
            self.params, self.cfg, spec, packed=self.packed,
            decode_ctx=self.decode_ctx, kv_blocks=self.kv_blocks,
            kv_block_tokens=self.kv_block_tokens,
            telemetry=self.telemetry))
        name = pool_endpoint(spec.key)
        self.transport.serve(name, svc.handle)
        return PoolHandle(spec.key, self.transport.connect(name),
                          telemetry=self.telemetry)

    def _spawn_pools(self, specs: list) -> dict:
        """Create several pools; returns {key: handle}. Sequential here;
        ``RemoteExecutor`` spawns its workers in parallel, so a replan's
        stall is the slowest spawn, not the sum. All-or-nothing: a failed
        spawn retires the pools already created, so no endpoint (or
        worker process) leaks."""
        created = {}
        try:
            for spec in specs:
                created[spec.key] = self._spawn_pool(spec)
        except Exception:
            for h in created.values():
                try:
                    self._retire_pool(h)
                except Exception:
                    pass
            raise
        return created

    def _retire_pool(self, handle: PoolHandle) -> None:
        handle.close()
        self.transport.stop(pool_endpoint(handle.key))

    def _deploy(self, plan: ExecutionPlan) -> None:
        pools = plan_pools(plan)
        if not self.decode_disagg and any(
                sp.role != "both" for sp in pools.values()):
            raise ValueError(
                "plan declares prefill/decode-role pools; construct the "
                "executor with decode_disagg=True to deploy it")
        self.plan = plan
        self._pools = pools
        new_specs = []
        for key, spec in self._pools.items():
            if key in self._handles:
                self._handles[key].retarget(spec)
            else:
                new_specs.append(spec)
        created = self._spawn_pools(new_specs)
        self._handles.update(created)
        self.stats["pools_created"] += len(created)
        self.routes = _routing(plan)
        self._chains = {
            client: [self._handles[pool_key(sp.fragment.model, sp)]
                     for sp in chain]
            for client, chain in self.routes.items()}
        if self.placement is None:            # initial deploy: pack fresh
            self.placement = place_pools(self._pools)
        self._bind_chips()

    def _bind_chips(self) -> None:
        """Push the current placement's chip binding to every pool whose
        chips changed."""
        for key, handle in self._handles.items():
            chips = tuple(self.placement.chips_of(key))
            if self._bound.get(key) == chips:
                continue
            handle.bind(list(chips))
            self._bound[key] = chips

    def chips_of(self, key: tuple) -> list:
        """Chip index per instance of pool ``key`` (empty pre-placement)."""
        return self.placement.chips_of(key) if self.placement else []

    def prepare_plan(self, new_plan: ExecutionPlan) -> int:
        """Start the pools ``new_plan`` adds ahead of :meth:`apply_plan`,
        without touching the live deployment, so a server can do it
        outside its writer lock. An in-process pool is built inside
        ``apply_plan`` at no cost, so there is nothing to do here;
        ``RemoteExecutor`` starts the pools' worker processes. Returns
        the number of pools started."""
        return 0

    def apply_plan(self, new_plan: ExecutionPlan) -> PlanDiff:
        """Transition the live deployment to ``new_plan``. Pools whose
        (model, start, end) identity survives keep their queue."""
        new_pools = plan_pools(new_plan)
        diff = diff_plans(self._pools, new_pools)
        removed = diff.by_kind("remove")
        feeders = {pool_range(k) for k, sp in new_pools.items()
                   if sp.role in ("both", "prefill")}
        for a in removed:                      # validate before mutating
            s = self._handles[a.key].stats()
            q = int(s["queue_len"])
            dec = int(s.get("decode_active", 0) or 0)
            if q or dec:
                raise PlanRefused(
                    f"cannot remove pool {a.key}: {q} queued requests, "
                    f"{dec} resident decode streams — drain before "
                    f"apply_plan()")
            # removing the last prefill-capable pool of a range while a
            # decode-role pool of that range survives would leave the
            # decode pool with no feeder — refuse
            if a.old is not None and a.old.role in ("both", "prefill"):
                orphans = [k for k, sp in new_pools.items()
                           if sp.role == "decode"
                           and pool_range(k) == pool_range(a.key)]
                if orphans and pool_range(a.key) not in feeders:
                    raise PlanRefused(
                        f"cannot remove pool {a.key}: decode pool(s) "
                        f"{orphans} would be left with no prefill "
                        "feeder over that range")
        for a in removed:
            self._retire_pool(self._handles.pop(a.key))
            self._bound.pop(a.key, None)
            self.stats["pools_removed"] += 1
        self.stats["pools_reused"] += diff.n_kept
        self.stats["plan_applies"] += 1
        # transition the chip packing across the diff instead of
        # re-packing: only the delta spawns/retires/moves
        self.placement, self.last_migrations = migrate(self.placement, diff)
        stat_key = {MOVE: "instances_moved", "spawn": "instances_spawned",
                    "retire": "instances_retired"}
        for act in self.last_migrations:
            self.stats[stat_key[act.kind]] += 1
        self._deploy(new_plan)
        return diff

    # -------------------------------------------------------------- serve
    def fragment_fn(self, start: int, end: int):
        """``run_fragment`` for blocks [start, end), cached — the one place
        fragment programs outside pools are made (mobile parts here)."""
        fn = self._fragment_fns.get((start, end))
        if fn is None:
            fn = self._fragment_fns[(start, end)] = functools.partial(
                run_fragment, cfg=self.cfg, start=start, end=end)
        return fn

    def mobile_part(self, req: ServeRequest, p: int) -> Tensor:
        """Execute the device-side fragment [0, p) locally (simulated
        device). Returns the per-request payload: token ids (S,) when
        p == 0, else the intermediate hidden states (S, d) that cross the
        network."""
        toks = torch.as_tensor(np.asarray(req.tokens, np.int32),
                               device=self.device)[None]     # (1, S)
        if p == 0:
            return toks[0]
        h = self.fragment_fn(0, p)(self.params, inputs=toks,
                                   extras=req.extras)
        return h[0]

    def _wire_extras(self, req: ServeRequest) -> Optional[dict]:
        """A request's extras as they cross a pool hop (tensors and
        arrays both frame; None when the request has none)."""
        if req.extras is None:
            return None
        return dict(req.extras)

    def serve(self, requests: list[tuple[ServeRequest, int]]
              ) -> list[ServeRequest]:
        """requests: [(req, client_partition_point)]. Batched execution of
        every stage pool; returns requests with ``result`` filled.

        If a hop fails mid-wave, requests already queued in healthy pools
        stay queued and tracked — call :meth:`drain` to discard them
        before the next ``apply_plan``."""
        # stage 0 submit — this is the uplink hop the paper budgets for
        stage_of: dict[int, int] = {}        # rid -> index in ITS OWN chain
        for req, p in requests:
            payload = self.mobile_part(req, p)
            rid = next(self._rid)
            self._by_rid[rid] = req
            stage_of[rid] = 0
            chain = self._chains[req.client]
            sample = chain[0].submit(rid, req.client, payload,
                                     extras=req.extras)
            if sample is not None:          # unmeasured hop: record nothing
                self.uplink.append((req.client, sample[0], sample[1]))
        # run chains to completion (stages are a DAG of depth <= 2). A
        # flush can return requests from OTHER chains whose earlier stage
        # fed this pool — route each result by the request's own recorded
        # stage, never by the flushing depth.
        max_depth = max((len(c) for c in self._chains.values()), default=0)
        for depth in range(max_depth):
            seen = set()
            for chain in self._chains.values():
                if depth >= len(chain) or id(chain[depth]) in seen:
                    continue
                seen.add(id(chain[depth]))
                for rid, y in chain[depth].flush():
                    req = self._by_rid[rid]
                    nxt = stage_of[rid] + 1
                    rchain = self._chains[req.client]
                    if nxt < len(rchain):
                        stage_of[rid] = nxt
                        rchain[nxt].submit(rid, req.client, y,
                                           extras=req.extras)
                    else:
                        req.result = y
                        del self._by_rid[rid]
                        del stage_of[rid]
        return [r for r, _ in requests]

    # --------------------------------------------------- server plumbing
    def next_rid(self) -> int:
        """Allocate a fresh request id (shared with the serve() path so
        ids stay unique when a GraftServer drives this executor)."""
        return next(self._rid)

    def client_chain(self, client: str) -> list:
        """The client's stage chain as live PoolHandles (deploy order)."""
        return list(self._chains[client])

    def chain_keys(self, client: str) -> list:
        """The client's stage chain as PoolKeys."""
        return [h.key for h in self._chains[client]]

    def route_table(self) -> dict:
        """client -> [PoolKey, ...] for every routed client."""
        return {c: [h.key for h in chain]
                for c, chain in self._chains.items()}

    def pool_specs(self) -> dict:
        """PoolKey -> PoolSpec of the currently deployed plan."""
        return dict(self._pools)

    def pool_role(self, key: tuple) -> str:
        """Role of a deployed pool (``both`` when unannotated)."""
        sp = self._pools.get(key)
        return sp.role if sp is not None else "both"

    def decode_pool_keys(self) -> list:
        """Keys of the deployed decode-role pools (handoff receivers)."""
        return [k for k, sp in self._pools.items() if sp.role == "decode"]

    def prefill_pool_keys(self, rng: Optional[tuple] = None) -> list:
        """Keys of the pools that can run a disaggregated prefill for
        block range ``rng`` (``(model, start, end)``; None = any range):
        prefill-role first, then dual-role."""
        out = [k for k, sp in self._pools.items()
               if sp.role in ("prefill", "both")
               and (rng is None or pool_range(k) == tuple(rng))]
        return sorted(out, key=lambda k: self._pools[k].role != "prefill")

    def handle(self, key: tuple) -> PoolHandle:
        return self._handles[key]

    def open_handle(self, key: tuple) -> PoolHandle:
        """A NEW channel to pool ``key``: each server (a fleet's
        front-ends each) opens its own so its uplink submits do not
        serialize on the shared deploy handle; the pool itself
        serializes execution in PoolService. ``RemoteExecutor`` opens a
        new dial-back lane to the pool's worker."""
        if key not in self._handles:
            raise KeyError(f"no pool {key}")
        return PoolHandle(key, self.transport.connect(pool_endpoint(key)),
                          telemetry=self.telemetry)

    def record_uplink(self, client: str, nbytes: float, ms: float) -> None:
        """Log one measured first-hop transfer (the server's batch-close
        submit path records here; serve() does it inline)."""
        self.uplink.append((client, nbytes, ms))

    def drain_uplink(self) -> list:
        """Return and clear the (client, nbytes, ms) first-hop samples —
        what ``ServingController.ingest_uplink`` consumes. Safe against
        concurrent ``record_uplink`` from driver threads: samples are
        popped one by one, never dropped by a clear() race."""
        out = []
        while True:
            try:
                out.append(self.uplink.popleft())
            except IndexError:
                return out

    # ------------------------------------------------------------- stats
    def drain(self) -> int:
        """Flush every pool to empty, DISCARDING results — the recovery
        path when a serve() aborted mid-wave. Returns how many queued
        requests were discarded."""
        n = 0
        for handle in self._handles.values():
            for rid, _y in handle.flush():
                if self._by_rid.pop(rid, None) is not None:
                    n += 1
        return n

    def pool_stats(self) -> dict:
        """PoolKey -> live pool stats (pid, queue_len, n_compiles, ...)."""
        return {key: h.stats() for key, h in self._handles.items()}

    def merge_telemetry(self, into=None) -> int:
        """Poll every pool's stats op and fold snapshots of registries
        other than ``into``'s process into it (default: this executor's
        registry). In-process pools share the registry already and are
        skipped, so nothing counts twice. Returns the number of snapshots
        merged."""
        into = into if into is not None else self.telemetry
        if not into.enabled:
            return 0
        n = 0
        for key, s in self.pool_stats().items():
            snap = s.get("telemetry")
            if not snap or snap.get("process") == into.process:
                continue
            label = pool_endpoint(key)[len("pool/"):]
            into.merge_snapshot(snap, source=label,
                                prefix=f"pool/{label}/")
            n += 1
        return n

    def worker_pids(self) -> dict:
        """PoolKey -> pid of the process executing that pool."""
        return {key: s["pid"] for key, s in self.pool_stats().items()}

    @property
    def n_stage_pools(self) -> int:
        return len(self._handles)

    def close(self) -> None:
        for key in list(self._handles):
            self._retire_pool(self._handles.pop(key))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
