"""The plain reference: the model's forward pass in float32 (TF32 off),
one sequence at a time, layer by layer.

It imports nothing of the program. It reads the benchmark's own weights
(the tensors the port was given) and a configuration's sizes from the
benchmark's configuration file, casts one layer's weights at a time to
float32, and computes every product in full: no kernels, no cache, no
batching. The conventions are those the configuration file states
(``rope``: interleaved pairs; ``norm_eps`` and ``qk_norm_eps``; top-k
gates renormalised; every expert dropless).

``precision="fp8"`` is the control: the same computation with every
product's inputs rounded to float8 e4m3 (weights per output channel,
activations per row, each scaled by its absolute maximum), accumulated
in float32 -- the step below the configuration's bfloat16.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
E4M3_MAX = 448.0


@contextmanager
def exact_float32():
    """Float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _fp8(x: Tensor, dim: int) -> Tensor:
    """``x`` rounded to e4m3 with one absmax scale per slice along
    ``dim``, returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = E4M3_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


class Reference:
    """Forward of one model configuration (a dict of the configuration
    file's ``model`` block) over the benchmark's weights."""

    def __init__(self, model: dict, params: dict, *,
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.m = model
        self.p = params
        self.fp8 = precision == "fp8"

    # ------------------------------------------------------------ pieces
    def _mm(self, x: Tensor, w: Tensor) -> Tensor:
        """x (..., k) @ w (k, n) in float32; the control rounds both."""
        w = w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def _bmm(self, a: Tensor, b: Tensor) -> Tensor:
        """Attention's products (..., m, k) @ (..., k, n)."""
        if self.fp8:
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b

    def _norm(self, x: Tensor, scale: Tensor, eps: float) -> Tensor:
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return x * scale.float()

    def _rope(self, x: Tensor, pos: Tensor) -> Tensor:
        """Interleaved pairs (x[2i], x[2i+1]) rotate together."""
        hd = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
            / hd))
        ang = pos.float()[:, None] * inv                       # (S, hd/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    def _attention(self, lp: dict, h: Tensor) -> Tensor:
        m = self.m
        S = h.shape[0]
        H, KV, hd = m["heads"], m["kv_heads"], m["head_dim"]
        q = self._mm(h, lp["wq"]).view(S, H, hd)
        k = self._mm(h, lp["wk"]).view(S, KV, hd)
        v = self._mm(h, lp["wv"]).view(S, KV, hd)
        if m["qk_norm"]:
            q = self._norm(q, lp["q_norm"], m["qk_norm_eps"])
            k = self._norm(k, lp["k_norm"], m["qk_norm_eps"])
        pos = torch.arange(S, device=h.device)
        q, k = self._rope(q, pos), self._rope(k, pos)
        g = H // KV
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = self._bmm(q.transpose(0, 1), k.permute(1, 2, 0)) * hd ** -0.5
        mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = self._bmm(a, v.transpose(0, 1))                    # (H, S, hd)
        return self._mm(o.transpose(0, 1).reshape(S, H * hd), lp["wo"])

    def _mlp(self, lp: dict, h: Tensor) -> Tensor:
        g = F.silu(self._mm(h, lp["w_gate"])) * self._mm(h, lp["w_up"])
        return self._mm(g, lp["w_down"])

    def _moe(self, lp: dict, h: Tensor) -> Tensor:
        """Top-k token choice over every expert, gates renormalised,
        no token dropped."""
        k = self.m["top_k"]
        probs = torch.softmax(self._mm(h, lp["router"]), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        eidx = top.indices[:, :k]
        gates = top.values[:, :k]
        gates = gates / gates.sum(dim=-1, keepdim=True)
        y = torch.zeros_like(h)
        for e in torch.unique(eidx).tolist():
            rows, slot = torch.nonzero(eidx == e, as_tuple=True)
            w = {n: lp[n][e] for n in ("w_gate", "w_up", "w_down")}
            y.index_add_(0, rows, gates[rows, slot, None]
                         * self._mlp(w, h[rows]))
        return y

    # ----------------------------------------------------------- forward
    def logits(self, tokens: Tensor) -> Tensor:
        """tokens (S,) -> logits (S, vocab), float32."""
        m, p = self.m, self.p
        with exact_float32():
            x = p["embed"][tokens.long()].float()
            blocks = p["blocks"]
            for i in range(m["layers"]):
                lp = _layer(blocks, i)
                h = self._norm(x, lp["ln1"]["scale"], m["norm_eps"])
                x = x + self._attention(lp["attn"], h)
                h = self._norm(x, lp["ln2"]["scale"], m["norm_eps"])
                x = x + (self._moe(lp["moe"], h) if "moe" in lp
                         else self._mlp(lp["mlp"], h))
            x = self._norm(x, p["final_norm"]["scale"], m["norm_eps"])
            head = p["embed"].T if m["tie_embeddings"] else p["lm_head"]
            return self._mm(x, head)


def _layer(blocks: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}
