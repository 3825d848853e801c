"""Paged KV-cache manager for autoregressive (decode) fragments.

Numpy only: the same arena as the JAX package's, so the port's prefix
sharing, COW and eviction behave identically and the KV it hands back
is bit-identical (float32 on the host; a device-resident arena is later
work).

Each decode-capable stage pool owns ONE :class:`PagedKVCache`: a
preallocated host-side arena of fixed-size token blocks that backs the
KV state of every request resident in that pool's continuous decode
batch. The design is the vLLM paged-attention bookkeeping reduced to
what the serving path needs:

- **Block-granular alloc/free.** A free list over ``n_blocks`` blocks of
  ``block_tokens`` token slots each; sequences hold chains of blocks and
  release them the moment they finish, so a long-running batch never
  holds arena capacity for requests that already completed.
- **Cross-request prefix sharing.** Prompt blocks are indexed under a
  chained hash key rooted at the caller's reuse signature ``sig`` —
  ``(sig, parent_key, block-token-tuple)`` — so two requests whose
  prompts share a block-aligned prefix (same model / partition point /
  SLO bucket) share the underlying KV blocks by refcount instead of
  recomputing prefill. The trailing *partial* prompt block is indexed
  too, which is what makes copy-on-write reachable: a sharer that
  decodes appends into a shared partial block and must COW it first.
- **Retention + LRU eviction.** On ``finish`` a sequence's prompt
  blocks stay allocated (refcount 0, indexed) as reuse candidates;
  allocation pressure evicts the least-recently-touched retained block
  before raising :class:`KVCacheOOM`. Eviction / hit / COW counters are
  surfaced in pool stats.

The arena stores float32 KV stacked over layers — ``(block,
slot, layer, kv_head, head_dim)`` — because it is written from and
gathered back into the pool's dense decode cache on the host side;
dtype conversion happens at the gather/write boundary.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serving.telemetry import NULL as NULL_TELEMETRY


class KVCacheOOM(RuntimeError):
    """Block allocation failed: free list empty and nothing evictable."""


@dataclass
class _Block:
    idx: int
    ref: int = 0                  # active sequences using this block
    filled: int = 0               # token slots with resident KV
    tokens: tuple = ()            # token ids resident in this block
    key: Optional[tuple] = None   # prefix-index key when indexed
    tick: int = 0                 # last-touched stamp (LRU eviction)
    free: bool = True


@dataclass
class _Seq:
    rid: int
    sig: tuple
    blocks: list = field(default_factory=list)     # _Block chain, in order
    n_tokens: int = 0                              # resident tokens (total)
    prompt_len: int = 0
    n_shared: int = 0                              # prefix tokens reused
    prompt_keys: list = field(default_factory=list)  # chain keys per block


def _chunk(tokens: tuple, bt: int) -> list[tuple]:
    return [tokens[i:i + bt] for i in range(0, len(tokens), bt)]


def prompt_chain_keys(sig: tuple, tokens: tuple, bt: int) -> list[tuple]:
    """Chained prefix-index keys for a prompt, one per block. Full blocks
    key as ("B", parent, chunk); the trailing partial as ("P", parent,
    chunk) so a partial block only matches a request whose prompt ends
    with the identical partial chunk."""
    keys, prev = [], ("root", sig)
    for chunk in _chunk(tokens, bt):
        kind = "B" if len(chunk) == bt else "P"
        key = (kind, prev, chunk)
        keys.append(key)
        prev = key
    return keys


def key_digest(key: tuple) -> int:
    """Stable 64-bit digest of one prefix-index key. ``repr`` of the
    chain key is deterministic (ints/strings/tuples only — never the
    salted builtin ``hash``), so digests compare equal across processes
    and front-ends."""
    h = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    return int.from_bytes(h, "big")


def prefix_digest(sig: tuple, tokens, block_tokens: int, *,
                  max_chunks: int = 4) -> tuple:
    """Compact routing digest of one prompt: hashes of its first
    ``max_chunks`` chain keys under ``sig``. A request whose digest
    overlaps a front-end's residency digest has prompt-prefix KV blocks
    already live behind that front-end — the router's affinity signal."""
    toks = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
    if not toks:
        return ()
    keys = prompt_chain_keys(sig, toks, block_tokens)[:max(max_chunks, 1)]
    return tuple(key_digest(k) for k in keys)


class PagedKVCache:
    """Block-granular KV arena with prefix sharing and LRU retention."""

    def __init__(self, n_blocks: int, block_tokens: int, *,
                 n_layers: int, n_kv_heads: int, head_dim: int,
                 telemetry=None):
        if n_blocks <= 0 or block_tokens <= 0:
            raise ValueError("n_blocks and block_tokens must be positive")
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        shape = (n_blocks, block_tokens, n_layers, n_kv_heads, head_dim)
        self._k = np.zeros(shape, np.float32)
        self._v = np.zeros(shape, np.float32)
        self._blocks = [_Block(i) for i in range(n_blocks)]
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))
        self._index: dict[tuple, _Block] = {}
        self._seqs: dict[int, _Seq] = {}
        self._tick = 0
        self.counters = {"allocs": 0, "frees": 0, "evictions": 0,
                         "prefix_hits": 0, "prefix_tokens_reused": 0,
                         "cow_copies": 0, "oom": 0,
                         "handoff_blocks_in": 0, "handoff_tokens_in": 0,
                         "handoff_reused": 0}
        tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self._tel_on = tel.enabled      # gates the O(n_blocks) util scan
        self._m_util = tel.gauge("kv/util_frac")
        self._m_evictions = tel.counter("kv/evictions")
        self._m_cow = tel.counter("kv/cow_copies")
        self._m_oom = tel.counter("kv/oom")

    # ----------------------------------------------------------- internals
    def _touch(self, blk: _Block) -> None:
        self._tick += 1
        blk.tick = self._tick

    def _alloc_block(self) -> _Block:
        if self._free:
            blk = self._blocks[self._free.pop()]
        else:
            blk = self._evict_lru()
        if not blk.free:
            raise RuntimeError(f"allocator invariant: block {blk.idx} "
                               "handed out while not free")
        blk.free = False
        blk.ref = 1
        blk.filled = 0
        blk.tokens = ()
        blk.key = None
        self._touch(blk)
        self.counters["allocs"] += 1
        if self._tel_on:
            self._m_util.set(self.util_frac())
        return blk

    def _evict_lru(self) -> _Block:
        """Reclaim the least-recently-touched retained block (ref 0,
        indexed). Raises KVCacheOOM when every block is actively held."""
        victim = None
        for blk in self._blocks:
            if blk.free or blk.ref > 0:
                continue
            if victim is None or blk.tick < victim.tick:
                victim = blk
        if victim is None:
            self.counters["oom"] += 1
            self._m_oom.inc()
            raise KVCacheOOM(
                f"KV arena exhausted: {self.n_blocks} blocks all actively "
                "referenced (nothing retained to evict)")
        if victim.key is not None:
            self._index.pop(victim.key, None)
        self.counters["evictions"] += 1
        self._m_evictions.inc()
        victim.free = True          # immediately re-handed by _alloc_block
        return victim

    def _free_block(self, blk: _Block) -> None:
        if blk.free:
            raise RuntimeError(f"double free of KV block {blk.idx}")
        if blk.key is not None:
            self._index.pop(blk.key, None)
            blk.key = None
        blk.free = True
        blk.ref = 0
        blk.filled = 0
        blk.tokens = ()
        self._free.append(blk.idx)
        self.counters["frees"] += 1
        if self._tel_on:
            self._m_util.set(self.util_frac())

    def _drop_ref(self, blk: _Block) -> None:
        """Release one sequence's hold. At ref 0 an INDEXED block stays
        allocated as a retained reuse candidate (evictable under
        pressure); anything unindexed frees. Indexed blocks survive even
        an abort-path drop — a sharer releasing early must not destroy
        the donor's retained prefix it merely borrowed."""
        if blk.free:
            raise RuntimeError(f"release of already-freed KV block {blk.idx}")
        blk.ref -= 1
        if blk.ref < 0:
            raise RuntimeError(f"refcount underflow on KV block {blk.idx}")
        if blk.ref == 0 and blk.key is None:
            self._free_block(blk)

    # --------------------------------------------------------------- API
    def begin(self, rid: int, sig: tuple, prompt_tokens) -> int:
        """Admit a sequence: share the longest indexed prefix, allocate
        private blocks for the remainder. Returns the number of prompt
        tokens whose KV is already resident (the caller gathers those
        and prefills only the suffix). KV for the private blocks must be
        written via :meth:`write_prompt_kv` before any gather."""
        if rid in self._seqs:
            raise ValueError(f"sequence {rid} already admitted")
        tokens = tuple(int(t) for t in np.asarray(prompt_tokens).reshape(-1))
        if not tokens:
            raise ValueError("empty prompt")
        seq = _Seq(rid=rid, sig=sig, prompt_len=len(tokens))
        seq.prompt_keys = prompt_chain_keys(sig, tokens, self.block_tokens)
        chunks = _chunk(tokens, self.block_tokens)
        shared = 0
        for key, chunk in zip(seq.prompt_keys, chunks):
            blk = self._index.get(key)
            if blk is None or blk.tokens != chunk:
                break
            blk.ref += 1
            self._touch(blk)
            seq.blocks.append(blk)
            shared += blk.filled
        for chunk in chunks[len(seq.blocks):]:
            try:
                blk = self._alloc_block()
            except KVCacheOOM:
                self._unwind(seq)
                raise
            blk.tokens = chunk
            blk.filled = len(chunk)
            seq.blocks.append(blk)
        seq.n_shared = shared
        seq.n_tokens = len(tokens)
        if shared:
            self.counters["prefix_hits"] += 1
            self.counters["prefix_tokens_reused"] += shared
        self._seqs[rid] = seq
        return shared

    def _unwind(self, seq: _Seq) -> None:
        """Roll back a partially-admitted sequence (OOM mid-begin)."""
        for blk in seq.blocks:
            self._drop_ref(blk)

    def write_prompt_kv(self, rid: int, ks: np.ndarray, vs: np.ndarray
                        ) -> None:
        """Write KV for the non-shared prompt suffix. ``ks``/``vs`` are
        (n, L, KV, hd) with n == prompt_len - n_shared."""
        seq = self._seqs[rid]
        n = seq.prompt_len - seq.n_shared
        if ks.shape[0] != n:
            raise ValueError(f"expected {n} suffix tokens, got {ks.shape[0]}")
        self._write_at(seq, seq.n_shared, ks, vs)

    def _write_at(self, seq: _Seq, pos0: int, ks, vs) -> None:
        bt = self.block_tokens
        for i in range(ks.shape[0]):
            pos = pos0 + i
            blk = seq.blocks[pos // bt]
            self._k[blk.idx, pos % bt] = np.asarray(ks[i], np.float32)
            self._v[blk.idx, pos % bt] = np.asarray(vs[i], np.float32)
            self._touch(blk)

    def _writable_last(self, seq: _Seq) -> _Block:
        """The sequence's last block, copy-on-write'd if shared. A block
        is privately writable only when this sequence is its sole active
        user AND it is not a retained index entry other requests may
        still match."""
        blk = seq.blocks[-1]
        if blk.ref == 1 and blk.key is None:
            return blk
        fresh = self._alloc_block()
        fresh.tokens = blk.tokens
        fresh.filled = blk.filled
        self._k[fresh.idx] = self._k[blk.idx]
        self._v[fresh.idx] = self._v[blk.idx]
        self._drop_ref(blk)
        seq.blocks[-1] = fresh
        self.counters["cow_copies"] += 1
        self._m_cow.inc()
        return fresh

    def append(self, rid: int, token: int, k: np.ndarray, v: np.ndarray
               ) -> None:
        """Append one generated token's KV. Allocates at block
        boundaries; COWs a shared partial block before writing."""
        seq = self._seqs[rid]
        bt = self.block_tokens
        if seq.n_tokens % bt == 0:                     # boundary: new block
            blk = self._alloc_block()
            seq.blocks.append(blk)
        else:
            blk = self._writable_last(seq)
        slot = seq.n_tokens % bt
        self._k[blk.idx, slot] = np.asarray(k, np.float32)
        self._v[blk.idx, slot] = np.asarray(v, np.float32)
        blk.tokens = blk.tokens + (int(token),)
        blk.filled += 1
        seq.n_tokens += 1
        self._touch(blk)

    def gather(self, rid: int, n: Optional[int] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """KV for the sequence's first ``n`` tokens as (n, L, KV, hd)."""
        seq = self._seqs[rid]
        n = seq.n_tokens if n is None else n
        bt = self.block_tokens
        ks, vs, got = [], [], 0
        for blk in seq.blocks:
            if got >= n:
                break
            take = min(blk.filled, bt, n - got)
            ks.append(self._k[blk.idx, :take])
            vs.append(self._v[blk.idx, :take])
            got += take
        if got < n:
            raise ValueError(f"sequence {rid}: asked {n} tokens, "
                             f"only {got} resident")
        return np.concatenate(ks, axis=0), np.concatenate(vs, axis=0)

    def finish(self, rid: int, *, retain: bool = True) -> None:
        """Complete a sequence. Prompt blocks whose content still matches
        the admission-time chain become retained reuse candidates
        (indexed, refcount 0, evictable); everything else frees as its
        refcount drops."""
        seq = self._seqs.pop(rid)
        chunks = _chunk(self._prompt_tokens(seq), self.block_tokens)
        for i, blk in enumerate(seq.blocks):
            indexable = (retain and i < len(seq.prompt_keys)
                         and blk.tokens == chunks[i] and blk.key is None
                         and seq.prompt_keys[i] not in self._index)
            if indexable:
                blk.key = seq.prompt_keys[i]
                self._index[blk.key] = blk
                self._touch(blk)
            self._drop_ref(blk)

    def _prompt_tokens(self, seq: _Seq) -> tuple:
        toks: list[int] = []
        for blk in seq.blocks:
            if len(toks) >= seq.prompt_len:
                break
            toks.extend(blk.tokens[:seq.prompt_len - len(toks)])
        return tuple(toks)

    def release(self, rid: int) -> None:
        """Abort path: drop the sequence without retaining anything new."""
        self.finish(rid, retain=False)

    # ------------------------------------------------- cross-arena handoff
    def export_prefix(self, rid: int) -> dict:
        """Serialize a resident sequence's prompt blocks for a cross-pool
        handoff (prefill pool -> decode pool over the transport). The
        payload carries the signature and the per-block token chunks —
        everything :func:`prompt_chain_keys` needs — so the importing
        arena indexes the blocks under the *identical* chain keys and
        cross-request prefix sharing survives the hop. KV arrays are
        copies: the exporting arena may evict or free the blocks the
        moment the frame is on the wire."""
        seq = self._seqs[rid]
        chunks = _chunk(self._prompt_tokens(seq), self.block_tokens)
        blocks = []
        for i, blk in enumerate(seq.blocks[:len(chunks)]):
            if blk.tokens != chunks[i]:
                break                 # diverged (post-prompt append): stop
            blocks.append({"tokens": [int(t) for t in blk.tokens],
                           "filled": int(blk.filled),
                           "k": self._k[blk.idx, :blk.filled].copy(),
                           "v": self._v[blk.idx, :blk.filled].copy()})
        return {"sig": seq.sig, "block_tokens": self.block_tokens,
                "prompt_len": seq.prompt_len, "blocks": blocks}

    def import_prefix(self, sig: tuple, blocks: list) -> dict:
        """Seed the prefix index with exported prompt blocks. Each block
        lands as a retained reuse candidate (indexed, refcount 0,
        evictable) under the same chain key the exporter held, so the
        next :meth:`begin` for this prompt shares them like any locally
        retained prefix — and so do OTHER requests sharing a block-
        aligned prefix. Chunks already indexed here are skipped (the
        affinity-routed case); an OOM mid-import keeps the contiguous
        prefix imported so far and stops — ``begin`` recomputes the tail,
        degraded, never wrong. Returns counters for the caller's stats."""
        toks = tuple(int(t) for b in blocks for t in b["tokens"])
        keys = prompt_chain_keys(sig, toks, self.block_tokens)
        imported = reused = tokens_in = 0
        pinned: list = []             # chain blocks held until import ends
        for key, b in zip(keys, blocks):
            chunk = tuple(int(t) for t in b["tokens"])
            have = self._index.get(key)
            if have is not None and have.tokens == chunk:
                self._touch(have)     # refresh LRU: it is hot again
                have.ref += 1         # pin: a later alloc must not evict
                pinned.append(have)   # the chain out from under itself
                reused += 1
                continue
            try:
                blk = self._alloc_block()
            except KVCacheOOM:
                break                 # chain keys need contiguity: stop
            n = min(int(b["filled"]), self.block_tokens)
            self._k[blk.idx, :n] = np.asarray(b["k"], np.float32)[:n]
            self._v[blk.idx, :n] = np.asarray(b["v"], np.float32)[:n]
            blk.tokens = chunk
            blk.filled = n
            blk.ref = 1               # pinned while the import runs
            blk.key = key
            self._index[key] = blk
            pinned.append(blk)
            imported += 1
            tokens_in += n
        for blk in pinned:
            blk.ref -= 1              # land retained (ref 0, evictable)
        self.counters["handoff_blocks_in"] += imported
        self.counters["handoff_tokens_in"] += tokens_in
        self.counters["handoff_reused"] += reused
        return {"imported": imported, "reused": reused,
                "tokens_in": tokens_in}

    # ------------------------------------------------------------- stats
    @property
    def n_free(self) -> int:
        return len(self._free)

    def n_resident(self, rid: int) -> int:
        return self._seqs[rid].n_tokens

    def capacity_tokens(self) -> int:
        """Token slots obtainable without OOM: free blocks plus evictable
        retained blocks."""
        evictable = sum(1 for b in self._blocks if not b.free and b.ref == 0)
        return (len(self._free) + evictable) * self.block_tokens

    def has_room(self, n_tokens: int, n_resident: int = 0) -> bool:
        """Admission check: can ``n_tokens`` more tokens be resident,
        given ``n_resident`` already-held tokens round up to blocks."""
        bt = self.block_tokens
        need = (n_resident + n_tokens + bt - 1) // bt \
            - (n_resident + bt - 1) // bt
        evictable = sum(1 for b in self._blocks if not b.free and b.ref == 0)
        return need <= len(self._free) + evictable

    def util_frac(self) -> float:
        """Used token slots / allocated token slots. 1.0 when nothing is
        allocated (an empty arena wastes nothing)."""
        alloc = [b for b in self._blocks if not b.free]
        if not alloc:
            return 1.0
        return sum(b.filled for b in alloc) / (len(alloc) * self.block_tokens)

    def residency_digest(self, cap: int = 512) -> tuple:
        """Compact digest of the prefix index — :func:`key_digest` of the
        most recently touched indexed blocks' keys, newest first. This is
        what a front-end exports into the router's affinity signal: a
        request whose :func:`prefix_digest` overlaps it can reuse resident
        prompt KV here instead of re-prefixing on a cold front-end."""
        blocks = [b for b in self._blocks if b.key is not None and not b.free]
        blocks.sort(key=lambda b: -b.tick)
        return tuple(key_digest(b.key) for b in blocks[:max(int(cap), 0)])

    def stats(self) -> dict:
        return {**self.counters,
                "n_blocks": self.n_blocks,
                "block_tokens": self.block_tokens,
                "free_blocks": len(self._free),
                "active_seqs": len(self._seqs),
                "util_frac": round(self.util_frac(), 4)}
