"""Attention for the port: plain PyTorch versions and Hopper CUDA kernels."""


def launch_counts(*, reset: bool = False) -> dict:
    """Every kernel wrapper's launch count in this process, by kernel
    name (``reset`` zeroes them after reading). A pool worker's ``stats``
    reply carries these, so a parent can count the launches made in its
    worker processes."""
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     flash_attention_bwd, ssm_scan,
                                     wkv6_scan)
    mods = (flash_attention, flash_attention_bwd, decode_attention,
            ssm_scan, wkv6_scan)
    with flash_attention._count_lock:
        out = {k: v for m in mods for k, v in m.LAUNCHES.items()}
        if reset:
            for m in mods:
                m.reset_launches()
    return out
