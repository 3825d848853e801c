"""CPU tests of the float32 reference and the fp8 control: against a
hand-built one-layer model in numpy, and against the port's own forward
at a tiny size (the reference must compute what the configuration file
states, in the port's conventions)."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from graftbench import cpu_run  # noqa: E402
from graftbench.reference import Reference  # noqa: E402
from graftbench.weights import make_weights  # noqa: E402


def _rms(x, s, eps):
    return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + eps) * s


def _rope(x, pos, theta):
    hd = x.shape[-1]
    inv = 1.0 / theta ** (np.arange(0, hd, 2) / hd)
    a = pos[:, None] * inv
    c, s = np.cos(a)[:, None], np.sin(a)[:, None]
    out = np.empty_like(x)
    out[..., 0::2] = x[..., 0::2] * c - x[..., 1::2] * s
    out[..., 1::2] = x[..., 1::2] * c + x[..., 0::2] * s
    return out


def test_reference_equals_a_hand_built_layer():
    rng = np.random.default_rng(0)
    d, H, KV, hd, f, V, S = 8, 2, 1, 4, 12, 11, 5
    w = {k: rng.standard_normal(sh) * 0.3 for k, sh in dict(
        wq=(d, H * hd), wk=(d, KV * hd), wv=(d, KV * hd), wo=(H * hd, d),
        g=(d, f), u=(d, f), dn=(f, d), emb=(V, d)).items()}
    ln = rng.uniform(0.5, 1.5, (3, d))
    qn, kn = rng.uniform(0.5, 1.5, hd), rng.uniform(0.5, 1.5, hd)
    toks = np.array([3, 1, 4, 1, 5])
    # numpy, by hand
    x = w["emb"][toks]
    h = _rms(x, ln[0], 1e-5)
    q = _rms((h @ w["wq"]).reshape(S, H, hd), qn, 1e-6)
    k = _rms((h @ w["wk"]).reshape(S, KV, hd), kn, 1e-6)
    v = (h @ w["wv"]).reshape(S, KV, hd)
    pos = np.arange(S, dtype=np.float64)
    q, k = _rope(q, pos, 100.0), _rope(k, pos, 100.0)
    o = np.zeros((S, H, hd))
    for hh in range(H):
        sc = q[:, hh] @ k[:, 0].T / np.sqrt(hd)
        sc = np.where(np.tril(np.ones((S, S))) > 0, sc, -np.inf)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        o[:, hh] = (p / p.sum(-1, keepdims=True)) @ v[:, 0]
    x = x + o.reshape(S, -1) @ w["wo"]
    h = _rms(x, ln[1], 1e-5)
    g = h @ w["g"]
    x = x + (g / (1 + np.exp(-g)) * (h @ w["u"])) @ w["dn"]
    want = _rms(x, ln[2], 1e-5) @ w["emb"].T
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    params = {"embed": t(w["emb"]), "final_norm": {"scale": t(ln[2])},
              "blocks": {"ln1": {"scale": t(ln[:1])},
                         "ln2": {"scale": t(ln[1:2])},
                         "attn": {"wq": t(w["wq"][None]),
                                  "wk": t(w["wk"][None]),
                                  "wv": t(w["wv"][None]),
                                  "wo": t(w["wo"][None]),
                                  "q_norm": t(qn[None]),
                                  "k_norm": t(kn[None])},
                         "mlp": {"w_gate": t(w["g"][None]),
                                 "w_up": t(w["u"][None]),
                                 "w_down": t(w["dn"][None])}}}
    model = {"layers": 1, "heads": H, "kv_heads": KV, "head_dim": hd,
             "rope_theta": 100.0, "norm_eps": 1e-5, "qk_norm": True,
             "qk_norm_eps": 1e-6, "tie_embeddings": True, "top_k": 0}
    got = Reference(model, params).logits(torch.tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_reference_equals_the_port_in_float32(name):
    """Dense and dropless moe: the reference and the port's forward on
    the same float32 weights agree to float32 rounding."""
    from repro_torch.models import forward
    cf = json.loads((ROOT / "graftbench" / "configs" / f"{name}.json")
                    .read_text())
    cfg = dataclasses.replace(cpu_run.tiny_config(cf), dtype="float32")
    params = make_weights(cfg, 2 ** 33 + 1, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(0))
    want = forward(params, cfg, toks.int())[0][0]
    got = Reference(cpu_run.tiny_reference_model(cf), params).logits(
        toks[0])
    torch.testing.assert_close(got, want.float(), rtol=2e-4, atol=2e-4)


def test_fp8_control_departs_from_the_reference():
    cf = json.loads((ROOT / "graftbench" / "configs" / "qwen3-1.7b.json")
                    .read_text())
    cfg = cpu_run.tiny_config(cf)
    params = make_weights(cfg, 5, "cpu")
    m = cpu_run.tiny_reference_model(cf)
    toks = torch.randint(0, cfg.vocab_size, (32,),
                         generator=torch.Generator().manual_seed(1))
    ref = Reference(m, params).logits(toks)
    ctl = Reference(m, params, precision="fp8").logits(toks)
    rel = float((ctl - ref).norm() / ref.norm())
    assert 0.01 < rel < 0.5
