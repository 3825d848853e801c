"""The transformer families in PyTorch: layers, attention, fragments,
packing, and the stub frontends of the vlm and audio families."""
from repro_torch.models.transformer import (
    init_params, forward, fragment_forward, run_fragment, n_fragment_units,
    embed_tokens, unembed, resolve_device, encode_audio,
)
from repro_torch.models.packed import (is_packable, pack_segments,
                                       run_fragment_packed)
from repro_torch.models.convert import from_jax_params
from repro_torch.models.stubs import extras_shapes, make_extras

__all__ = [
    "init_params", "forward", "fragment_forward", "run_fragment",
    "n_fragment_units", "embed_tokens", "unembed", "resolve_device",
    "encode_audio", "is_packable", "pack_segments", "run_fragment_packed",
    "from_jax_params", "extras_shapes", "make_extras",
]
