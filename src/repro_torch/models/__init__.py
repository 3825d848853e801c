"""The dense transformer in PyTorch: layers, attention, fragments, packing."""
from repro_torch.models.transformer import (
    init_params, forward, fragment_forward, run_fragment, n_fragment_units,
    embed_tokens, unembed, resolve_device,
)
from repro_torch.models.packed import (is_packable, pack_segments,
                                       run_fragment_packed)
from repro_torch.models.convert import from_jax_params

__all__ = [
    "init_params", "forward", "fragment_forward", "run_fragment",
    "n_fragment_units", "embed_tokens", "unembed", "resolve_device",
    "is_packable", "pack_segments", "run_fragment_packed",
    "from_jax_params",
]
