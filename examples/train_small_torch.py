"""Train a small decoder (default ~20M params) for a few hundred steps with
the PyTorch port: data pipeline, AdamW, remat, checkpointing. The twin
of ``examples/train_small.py``; runs on the card, or with ``--device
cpu`` on the CPU.

  PYTHONPATH=src python examples/train_small_torch.py --steps 200
"""
import argparse
import os
import tempfile
import time

from repro_torch.config import ModelConfig
from repro_torch.data.tokens import token_batches
from repro_torch.models import init_params, resolve_device
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)
from repro_torch.training.optimizer import tree_leaves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    # head_dim 64 (384 / 6): one of the attention kernels' head dims
    cfg = ModelConfig(
        name="tiny-lm", family="dense", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=2, d_ff=1536, vocab_size=8192,
        dtype="float32", tie_embeddings=True).validate()
    device = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params on {device}")

    opt = init_opt_state(params)
    start = 0
    if args.resume:
        params, start = restore_checkpoint(args.ckpt, params)
        print(f"resumed at step {start}")
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3))
    data = token_batches(batch=args.batch, seq_len=args.seq,
                         vocab=cfg.vocab_size, seed=1)

    t0 = time.perf_counter()
    for i in range(start, start + args.steps):
        params, opt, m = step_fn(params, opt, next(data))
        if i % 20 == 0 or i == start + args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"({dt / max(i - start + 1, 1):.2f}s/step)")
    save_checkpoint(args.ckpt, params, step=start + args.steps)
    print(f"checkpoint saved to {args.ckpt}")


if __name__ == "__main__":
    main()
