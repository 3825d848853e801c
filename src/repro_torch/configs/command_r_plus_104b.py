"""command-r-plus-104b [dense] — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    vocab_size=256_000,
    rope_theta=75_000_000.0,
    tie_embeddings=True,               # command-r ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-plus (model card)",
).validate()
