"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                        # wkv heads = d_model / rwkv.head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14_336,
    vocab_size=65_536,
    gated_mlp=False,                   # rwkv channel-mix is a 2-matrix relu^2 mlp
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=32),
    source="arXiv:2404.05892 (Eagle and Finch: RWKV-5/6)",
).validate()
