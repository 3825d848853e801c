"""Long-context decode on the PyTorch port: why long_500k runs only on
sub-quadratic archs. The twin of ``examples/longcontext.py``; runs on
the card (the scan kernels in each prefill, the decode kernel in each
attention step; the smoke configs' head_dim 16 raised to 32, the least
the attention kernels take), or with ``--device cpu`` on the CPU.

Decodes N tokens on a reduced RWKV6 (O(1) state), hymba (ring KV + SSM
state) and dense qwen2 (full KV), printing the decode-state bytes as
context grows — the long_500k feasibility argument in runnable form.

  PYTHONPATH=src python examples/longcontext_torch.py --steps 24
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch import models as M
from repro_torch.kernels.ops import kernel_head_dim
from repro_torch.models.decode import decode_step, prefill


def state_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = M.resolve_device(args.device)
    rng = np.random.RandomState(0)

    for arch in ("rwkv6-7b", "hymba-1.5b", "qwen2-0.5b"):
        cfg = get_smoke_config(arch)
        cfg = kernel_head_dim(cfg, device)
        params = M.init_params(cfg, seed=0, device=device)
        prompt = torch.as_tensor(
            rng.randint(0, cfg.vocab_size, (1, 8)).astype(np.int32),
            device=device)
        with torch.no_grad():
            _, cache = prefill(params, cfg, prompt,
                               cache_seq=8 + args.steps)
            tok = prompt[:, -1:]
            for _ in range(args.steps):
                logits, cache = decode_step(params, cfg, cache, tok)
                tok = torch.argmax(logits[:, -1], -1)[:, None] \
                    .to(torch.int32)
        kind = {"ssm": "O(1) recurrent state",
                "hybrid": f"ring KV (window {cfg.sliding_window}) + SSM state",
                "dense": "full KV cache (grows with context)"}[cfg.family]
        print(f"{arch:14s} [{cfg.family:6s}] decode state after "
              f"{8 + args.steps:4d} ctx: {state_bytes(cache) / 2**10:8.1f} KiB"
              f"  <- {kind}")
    print("\nAt 524,288-token context the dense cache scales by ~4000x while"
          "\nrwkv6/hymba stay constant — hence long_500k's arch policy.")


if __name__ == "__main__":
    main()
