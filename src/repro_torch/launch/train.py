"""Training launcher: runs the train loop for an arch (the smoke config
unless ``--full``) on one device, with checkpointing. The CLI twin of
``repro/launch/train.py``; ``--device`` defaults to the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import token_batches
from repro_torch.models import init_params, make_extras, resolve_device
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)
from repro_torch.training.optimizer import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (its published widths)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    device = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=device)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params on {device}")

    opt = init_opt_state(params)
    start = 0
    if args.resume and args.ckpt:
        params, start = restore_checkpoint(args.ckpt, params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr))
    data = token_batches(batch=args.batch, seq_len=args.seq,
                         vocab=cfg.vocab_size, seed=1)
    # the vlm/audio stub frontend's embeddings ({} for the other families)
    extras = make_extras(cfg, args.batch, device=device)

    t0 = time.perf_counter()
    for i in range(start, start + args.steps):
        params, opt, m = step_fn(params, opt, next(data), extras or None)
        if i % 10 == 0 or i == start + args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"{(time.perf_counter() - t0) / max(i - start + 1, 1):.2f}"
                  "s/step")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=start + args.steps)
        print(f"saved {args.ckpt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
