"""hymba-1.5b [hybrid] — parallel attention + mamba heads in each block, meta
tokens, mostly sliding-window attention. [arXiv:2411.13676]"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=1024,               # hymba: SWA in most layers; SSM carries global
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    source="arXiv:2411.13676 (Hymba: A Hybrid-head Architecture for Small LMs)",
).validate()
