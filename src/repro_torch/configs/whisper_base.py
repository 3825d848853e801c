"""whisper-base [audio] — enc-dec transformer; conv/mel frontend is a STUB
(precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.config import ModelConfig, AudioConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                        # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    gated_mlp=False,                   # whisper uses plain GELU MLP
    rmsnorm=False,                     # layernorm
    rope_theta=0.0,                    # whisper uses learned/sinusoidal abs pos
    audio=AudioConfig(n_audio_frames=1500, n_encoder_layers=6),
    source="arXiv:2212.04356 (Whisper: Robust Speech Recognition)",
).validate()
