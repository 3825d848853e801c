"""Training for the port: AdamW, the causal-LM train step with remat and
microbatches, and checkpoints in the JAX package's on-disk format."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.train_step import lm_loss, make_train_step
from repro_torch.training.checkpoint import (save_checkpoint,
                                             restore_checkpoint)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lm_loss",
           "make_train_step", "save_checkpoint", "restore_checkpoint"]
