"""llama-3.2-vision-90b [vlm] — cross-attn image layers; vision encoder is a STUB
(precomputed patch embeddings). [hf:meta-llama/Llama-3.2-11B-Vision, 90B sizing]"""
from repro_torch.config import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    rope_theta=500_000.0,
    vision=VisionConfig(n_image_tokens=1601, cross_attn_every=5),
    source="hf:meta-llama/Llama-3.2-11B-Vision (card; 90B decoder sizing)",
).validate()
