"""Data pipelines of the port: the synthetic token stream for training."""
from repro_torch.data.tokens import token_batches

__all__ = ["token_batches"]
