"""Plain PyTorch oracles and memory-bounded references of every kernel.

These are the plain versions of the Hopper kernels (attention:
``kernels/flash_attention.py``, ``kernels/decode_attention.py``; the
recurrent scans: ``kernels/ssm_scan.py``, ``kernels/wkv6_scan.py``): the
CPU path runs them, and the kernels are held against them on the card.

Conventions
-----------
q:        (B, Sq, H, hd)
k, v:     (B, Sk, KV, hd)           (GQA: KV divides H)
q_pos:    (B, Sq) int32 global positions of the queries
kv_pos:   (B, Sk) int32 global positions of the keys; -1 marks unwritten slots
window:   0 = full (causal) attention, W>0 = only kv with q_pos-kv_pos < W
causal:   mask kv_pos > q_pos (False for encoder/cross attention)
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

NEG_INF = -1e30

# Per-step log-decay clamp shared by the recurrent kernels (WKV6 / SSM).
# Bounds the within-chunk cumulative decay so the matmul-form chunked
# re-association (which divides by cumulative products) stays inside fp32
# range: |chunk * LOG_DECAY_MIN| = 32 * 2.5 = 80, exp(80) ~ 5.5e34 < fp32 max.
LOG_DECAY_MIN = -2.5


def _acc_dtype(x: Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _gqa_scores(q: Tensor, k: Tensor) -> Tensor:
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B, H, Sq, Sk) with GQA grouping, in
    fp32 (fp64 for fp64 inputs, which gradient checks use)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    gs = H // KV
    acc = _acc_dtype(q)
    qg = q.reshape(B, Sq, KV, gs, hd)
    s = torch.einsum("bqgsd,bkgd->bgsqk", qg.to(acc), k.to(acc))
    return s.reshape(B, H, Sq, k.shape[1])


def _mask(q_pos: Tensor, kv_pos: Tensor, *, causal: bool,
          window: int) -> Tensor:
    """(B, Sq, Sk) boolean validity mask."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & ((qp - kp) < window)
    return m


def _positions(n: int, B: int, device) -> Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None].expand(B, n)


def ref_attention(q: Tensor, k: Tensor, v: Tensor, *,
                  q_pos: Optional[Tensor] = None,
                  kv_pos: Optional[Tensor] = None,
                  seg_q: Optional[Tensor] = None,
                  seg_kv: Optional[Tensor] = None,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None,
                  return_lse: bool = False):
    """Naive full-materialisation attention — the oracle.

    seg_q/seg_kv (B, Sq)/(B, Sk) int32: sequence-packing segment ids —
    attention is confined to seg_q == seg_kv. Positions stay GLOBAL
    packed coordinates, so only RoPE (applied by the caller) needs
    per-segment positions. Rows with no valid kv give 0.

    ``return_lse`` also returns the per-row logsumexp (B, H, Sq) fp32 of
    the scaled, masked scores (``NEG_INF`` for rows with no valid kv).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q_pos is None:
        q_pos = _positions(Sq, B, q.device)
    if kv_pos is None:
        kv_pos = _positions(Sk, B, q.device)
    scale = scale if scale is not None else hd ** -0.5
    s = _gqa_scores(q, k) * scale                       # (B,H,Sq,Sk) fp32
    m = _mask(q_pos, kv_pos, causal=causal, window=window)
    if seg_q is not None:
        m = m & (seg_q[:, :, None] == seg_kv[:, None, :])
    m = m[:, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with no valid kv produce uniform junk; zero them for determinism
    valid = m.any(dim=-1, keepdim=True)
    p = torch.where(valid, p, torch.zeros_like(p))
    gs = H // KV
    pv = p.reshape(B, KV, gs, Sq, Sk)
    o = torch.einsum("bgsqk,bkgd->bqgsd", pv, v.to(pv.dtype))
    o = o.reshape(B, Sq, H, hd).to(q.dtype)
    if return_lse:
        lse = torch.where(valid[..., 0], torch.logsumexp(s, dim=-1),
                          torch.full_like(s[..., 0], NEG_INF))
        return o, lse
    return o


def attend_cache_plain(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                       kv_pos: Tensor, *, window: int = 0,
                       scale: Optional[float] = None) -> Tensor:
    """One query token per row against a (possibly ring-buffer) cache:
    q (B,1,H,hd), k/v (B,Sk,KV,hd), q_pos (B,), kv_pos (B,Sk) with -1 for
    unwritten slots. The plain version of the decode kernel
    (``kernels/decode_attention.py``); a row with no valid slot gives 0."""
    return ref_attention(q, k, v, q_pos=q_pos[:, None], kv_pos=kv_pos,
                         causal=True, window=window, scale=scale)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *,
                      q_pos: Optional[Tensor] = None,
                      kv_pos: Optional[Tensor] = None,
                      seg_ids: Optional[Tensor] = None,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      q_chunk: int = 1024) -> Tensor:
    """Memory-bounded reference: loop over query chunks, full softmax inside.

    Peak score memory is (B, H, q_chunk, Sk) instead of (B, H, Sq, Sk).
    seg_ids (B, S): self-attention segment mask for packed batches.
    """
    B, Sq, H, hd = q.shape
    if Sq <= q_chunk:
        return ref_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                             seg_q=seg_ids, seg_kv=seg_ids,
                             causal=causal, window=window, scale=scale)
    if q_pos is None:
        q_pos = _positions(Sq, B, q.device)
    if kv_pos is None:
        kv_pos = _positions(k.shape[1], B, q.device)
    seg_kv = seg_ids
    pad = (-Sq) % q_chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=0)
        if seg_ids is not None:
            # pad q rows with a segment id no kv row carries: fully
            # masked rows, zeroed by the oracle's all-masked guard
            seg_ids = torch.nn.functional.pad(seg_ids, (0, pad), value=-2)
    outs = []
    for i in range(0, q.shape[1], q_chunk):
        sl = slice(i, i + q_chunk)
        outs.append(ref_attention(
            q[:, sl], k, v, q_pos=q_pos[:, sl], kv_pos=kv_pos,
            seg_q=None if seg_ids is None else seg_ids[:, sl],
            seg_kv=seg_kv, causal=causal, window=window, scale=scale))
    return torch.cat(outs, dim=1)[:, :Sq]


# ---------------------------------------------------------------------------
# RWKV6 (Finch) WKV oracle
# ---------------------------------------------------------------------------

def pick_block(size: int, preferred: int) -> int:
    """The JAX package's chunk rule (``repro/kernels/ops.py::_pick_block``):
    the largest divisor of ``size`` not above ``preferred`` — 1 for a
    prime length. The plain recurrent scans run with it, so the CPU path
    chunks as the JAX reference path does."""
    b = min(preferred, size)
    while size % b:
        b -= 1
    return max(b, 1)


def wkv6_log_decay(w: Tensor) -> Tensor:
    """The shared clamp of the per-channel decay, as a log: w clipped to
    [1e-12, 1], then log w to [LOG_DECAY_MIN, -1e-6]."""
    return torch.clamp(torch.log(torch.clamp(w, 1e-12, 1.0)),
                       LOG_DECAY_MIN, -1e-6)


def _zero_state(B, H, a, b, device) -> Tensor:
    return torch.zeros((B, H, a, b), dtype=torch.float32, device=device)


def ref_wkv6(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
             state: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Token-by-token WKV6 recurrence (the oracle).

    r,k,v,w: (B, T, H, hd); w in (0,1) is the data-dependent per-channel
    decay; u: (H, hd) learned bonus; state: (B, H, hd, hd) carrying S
    (k-dim x v-dim).

    o_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

    w is clamped to [exp(LOG_DECAY_MIN), 1) — the shared decay clamp.
    Returns (o (B,T,H,hd), final state).
    """
    B, T, H, hd = r.shape
    S = _zero_state(B, H, hd, hd, r.device) if state is None else state
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(T):
        wt = torch.exp(wkv6_log_decay(wf[:, t]))
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,hd,hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wt[..., None] * S + kv
    o = torch.stack(outs, dim=1) if outs else vf[:, :0].clone()
    return o.to(r.dtype), S


def chunked_wkv6(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                 state: Optional[Tensor] = None,
                 chunk: int = 32) -> tuple[Tensor, Tensor]:
    """Matmul-form chunked WKV6 (the algorithm of the TPU kernel).

    Within a chunk with cumulative decay P_t = prod_{s<=t} w_s:
      o_t = (r_t * P_{t-1}) @ S_in
            + sum_{s<t} ((r_t * P_{t-1} / P_s) . k_s) v_s
            + (r_t * u * k_t) @ v_t
      S_out = diag(P_T) S_in + (k_chunk * (P_T / P_s))^T v_chunk
    """
    B, T, H, hd = r.shape
    S = _zero_state(B, H, hd, hd, r.device) if state is None else state
    pad = (-T) % chunk
    if pad:
        z = lambda x, val=0.0: torch.nn.functional.pad(   # noqa: E731
            x, (0, 0, 0, 0, 0, pad), value=val)
        r, k, v = z(r), z(k), z(v)
        w = z(w, 1.0)
    n = r.shape[1] // chunk
    resh = lambda x: (x.reshape(B, n, chunk, H, hd)       # noqa: E731
                      .permute(1, 0, 3, 2, 4).float())
    rs, ks, vs, ws = map(resh, (r, k, v, w))              # (n,B,H,C,hd)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    uf = u.float()[None, :, None, :]
    outs = []
    for i in range(n):
        rc, kc, vc, wc = rs[i], ks[i], vs[i], ws[i]        # (B,H,C,hd)
        logw = wkv6_log_decay(wc)
        wc = torch.exp(logw)                               # clamped decay
        P = torch.exp(torch.cumsum(logw, dim=-2))          # P_t, (B,H,C,hd)
        r_t = rc * (P / wc)                                # r_t * P_{t-1}
        k_s = kc / P
        inter = torch.einsum("bhck,bhkv->bhcv", r_t, S)
        scores = torch.einsum("bhck,bhsk->bhcs", r_t, k_s) * tri
        diag = torch.sum(rc * (uf * kc), dim=-1)           # (B,H,C)
        intra = torch.einsum("bhcs,bhsv->bhcv", scores, vc) \
            + diag[..., None] * vc
        outs.append(inter + intra)
        PT = P[..., -1:, :]                                # (B,H,1,hd)
        k_carry = kc * (PT / P)
        S = PT[..., 0, :, None] * S + torch.einsum("bhsk,bhsv->bhkv",
                                                   k_carry, vc)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, hd)
    return o[:, :T].to(r.dtype), S


def subchunk_wkv6(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                  state: Optional[Tensor] = None, chunk: int = 64,
                  sub: int = 16) -> tuple[Tensor, Tensor]:
    """The algorithm of ``csrc/wkv6_scan.cu`` in plain PyTorch, fp32: a
    model for the tests (the main path never runs it).

    Fixed ``chunk``-step chunks from t = 0; a step past T has log-decay 0
    and r = k = v = 0. With cum_t the chunk's inclusive sum of log decays
    and ex_t = cum_{t-1} (0 at the chunk's first step), every decay is
    exp of a difference that is <= 0, never a quotient:
      inter  (r_t exp(ex_t)) S_in;
      blocks of ``sub`` steps, t in block a, s in an earlier block, with
        ref = cum at the step before block a:
        (r_t exp(ex_t - ref)) . (k_s exp(ref - cum_s)) v_s;
      s < t in t's own block: t in its upper half and s in its lower
        half the same way against cum at the lower half's last step, the
        rest (two triangles) sum_i r_t k_s exp(ex_t - cum_s) v_s channel
        by channel; and the bonus (r_t . u k_t) v_t;
      S_out = exp(cum_C) S_in + (k_s exp(cum_C - cum_s))^T v_s.
    """
    B, T, H, hd = r.shape
    S = _zero_state(B, H, hd, hd, r.device) if state is None \
        else state.float()
    rf, kf, vf = r.float(), k.float(), v.float()
    lw = wkv6_log_decay(w.float())
    pad = (-T) % chunk
    if pad:
        z = lambda x: torch.nn.functional.pad(          # noqa: E731
            x, (0, 0, 0, 0, 0, pad))
        rf, kf, vf, lw = z(rf), z(kf), z(vf), z(lw)
    n = rf.shape[1] // chunk
    resh = lambda x: x.reshape(B, n, chunk, H, hd).permute(  # noqa: E731
        1, 0, 3, 2, 4)
    rs, ks, vs, ls = map(resh, (rf, kf, vf, lw))          # (n,B,H,C,hd)
    half = sub // 2
    strict = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    strict[half:, :half] = False          # the quadrant, by its reference
    uf = u.float()[None, :, None, :]
    outs = []
    for c in range(n):
        rc, kc, vc = rs[c], ks[c], vs[c]
        cum = torch.cumsum(ls[c], dim=-2)
        ex = torch.cat([torch.zeros_like(cum[..., :1, :]),
                        cum[..., :-1, :]], dim=-2)
        o = torch.einsum("bhck,bhkv->bhcv", rc * torch.exp(ex), S)
        for a in range(chunk // sub):
            ta = slice(a * sub, (a + 1) * sub)
            oa = o[..., ta, :]
            if a:
                tb = slice(0, a * sub)
                ref = cum[..., a * sub - 1:a * sub, :]
                rt = rc[..., ta, :] * torch.exp(ex[..., ta, :] - ref)
                kt = kc[..., tb, :] * torch.exp(ref - cum[..., tb, :])
                oa = oa + (rt @ kt.transpose(-1, -2)) @ vc[..., tb, :]
            d = ex[..., ta, None, :] - cum[..., None, ta, :]   # (t, s, i)
            dec = torch.exp(d.masked_fill(~strict[..., None], -torch.inf))
            sc = torch.einsum("bhti,bhsi,bhtsi->bhts", rc[..., ta, :],
                              kc[..., ta, :], dec)
            bonus = torch.sum(rc[..., ta, :] * uf * kc[..., ta, :], dim=-1)
            sc = sc + torch.diag_embed(bonus)
            tu = slice(a * sub + half, (a + 1) * sub)
            tl = slice(a * sub, a * sub + half)
            ref = cum[..., a * sub + half - 1:a * sub + half, :]
            rt = rc[..., tu, :] * torch.exp(ex[..., tu, :] - ref)
            kt = kc[..., tl, :] * torch.exp(ref - cum[..., tl, :])
            sc[..., half:, :half] = rt @ kt.transpose(-1, -2)
            o[..., ta, :] = oa + sc @ vc[..., ta, :]
        outs.append(o)
        last = cum[..., -1:, :]
        kt = kc * torch.exp(last - cum)
        S = torch.exp(last[..., 0, :, None]) * S \
            + kt.transpose(-1, -2) @ vc
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, hd)
    return o[:, :T].to(r.dtype), S


# ---------------------------------------------------------------------------
# Mamba2-style selective scan oracle (hymba SSM heads)
# ---------------------------------------------------------------------------

def ref_ssm_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                 state: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Per-head scalar-decay selective state-space scan (the oracle).

    x:  (B, T, H, hd)   inner activations split into heads
    dt: (B, T, H)       softplus'd step sizes
    A:  (H,)            negative decay rates (A < 0)
    Bm: (B, T, N)       input->state projection (shared across heads)
    Cm: (B, T, N)       state->output projection
    state: (B, H, hd, N)

    h_t = exp(dt_t A) h_{t-1} + dt_t * (x_t outer B_t);  y_t = h_t @ C_t

    The per-step log-decay dt*A is clamped to [LOG_DECAY_MIN, 0] — the
    same clamp every implementation applies.
    """
    B, T, H, hd = x.shape
    N = Bm.shape[-1]
    h = _zero_state(B, H, hd, N, x.device) if state is None else state
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    outs = []
    for t in range(T):
        a = torch.exp(torch.clamp(dtf[:, t] * A[None], LOG_DECAY_MIN, 0.0))
        upd = dtf[:, t, :, None] * xf[:, t]                # (B,H,hd)
        h = a[..., None, None] * h + upd[..., None] * bf[:, t, None, None, :]
        outs.append(torch.einsum("bhdn,bn->bhd", h, cf[:, t]))
    y = torch.stack(outs, dim=1) if outs else xf[:, :0].clone()
    return y.to(x.dtype), h


def chunked_ssm_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                     Cm: Tensor, state: Optional[Tensor] = None,
                     chunk: int = 32) -> tuple[Tensor, Tensor]:
    """Matmul-form chunked selective scan (the algorithm of the TPU
    kernel).

    With scalar per-head decay a_t = exp(dt_t A), cumulative L_t = prod a_s:
      y_t = C_t @ (L_t h_0 + sum_{s<=t} (L_t/L_s) dt_s x_s B_s^T)
    """
    B, T, H, hd = x.shape
    N = Bm.shape[-1]
    h = _zero_state(B, H, hd, N, x.device) if state is None else state
    pad = (-T) % chunk
    if pad:
        F = torch.nn.functional
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    n = x.shape[1] // chunk
    xs = x.reshape(B, n, chunk, H, hd).permute(1, 0, 3, 2, 4).float()
    dts = dt.reshape(B, n, chunk, H).permute(1, 0, 3, 2).float()
    Bs = Bm.reshape(B, n, chunk, N).permute(1, 0, 2, 3).float()
    Cs = Cm.reshape(B, n, chunk, N).permute(1, 0, 2, 3).float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=x.device))
    outs = []
    for i in range(n):
        xc, dtc, bc, cc = xs[i], dts[i], Bs[i], Cs[i]
        la = torch.clamp(dtc * A[None, :, None], LOG_DECAY_MIN, 0.0)
        L = torch.exp(torch.cumsum(la, dim=-1))            # (B,H,C)
        # inter-chunk: C_t @ (L_t h_0)
        y_inter = torch.einsum("bcn,bhdn->bhcd", cc, h) * L[..., None]
        # intra-chunk: scores_ts = (L_t/L_s) dt_s (C_t . B_s), s<=t
        cb = torch.einsum("bcn,bsn->bcs", cc, bc)          # (B,C,C)
        ratio = L[..., :, None] / L[..., None, :]          # (B,H,C,C)
        scr = cb[:, None] * ratio * dtc[..., None, :] * tri
        outs.append(y_inter + torch.einsum("bhcs,bhsd->bhcd", scr, xc))
        LT = L[..., -1:]                                   # (B,H,1)
        wgt = (LT / L) * dtc                               # (B,H,C)
        h = LT[..., None] * h + torch.einsum("bhc,bhcd,bcn->bhdn", wgt, xc,
                                             bc)
    y = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, hd)
    return y[:, :T].to(x.dtype), h
