"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    nonparametric_ln=True,
    rmsnorm=False,                     # olmo uses (non-parametric) LayerNorm
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.00838 (OLMo: Accelerating the Science of LMs)",
).validate()
