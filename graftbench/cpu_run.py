"""A cell run on the CPU at a tiny size, for the tests: the same harness,
traffic generator, reference and judgement as a chip run, with the
configuration cut to a few narrow layers and the mix to a few clients
and short prompts. ``python -m graftbench.cpu_run <workload>`` prints
the result line; it never stands for a measurement."""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from graftbench import harness  # noqa: E402

N_LAYERS = 4


def tiny_config(cf: dict):
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    cfg = reduced(get_config(cf["port_config"]), n_layers=N_LAYERS,
                  d_model=512, vocab=1024)
    cfg = dataclasses.replace(cfg, dtype=cf["torch_dtype"])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf["capacity_factor"])))
    return cfg


def tiny_reference_model(cf: dict) -> dict:
    cfg = tiny_config(cf)
    return {"layers": cfg.n_layers, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim_,
            "rope_theta": cfg.rope_theta, "norm_eps": cf["rms_norm_eps"],
            "qk_norm": cf["qk_norm"], "qk_norm_eps": cf["qk_norm_eps"],
            "tie_embeddings": cfg.tie_embeddings,
            "top_k": cfg.moe.top_k if cfg.moe else 0}


def tiny_cell(workload: str) -> dict:
    cell = harness.load_cell(workload, ROOT)
    mix = cell["mix"]
    if mix["kind"] == "open_oneshot":
        mix.update(clients=4, partition=[0, N_LAYERS - 1], rate_rps=4.0,
                   prompt={"median": 16, "sigma": 0.5, "lo": 8, "hi": 32})
        mix["check"] = {"sample": 4}
    else:
        mix.update(sessions=4, turns_per_session=16,
                   turn={"median": 24, "sigma": 0.4, "lo": 16, "hi": 40},
                   output={"median": 12, "sigma": 0.5, "lo": 6, "hi": 20})
        mix["serve"] = dict(mix["serve"], batch=4, decode_ctx=64,
                            kv_blocks=16, kv_block_tokens=16)
        mix["check"] = {"sample": 8}
    mix["drain_s"] = 20
    return cell


class FakeTrace:
    """Stands in for the device trace on the CPU."""

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()

    def summary(self):
        return {"busy_s": 0.0, "window_s": self.t1 - self.t0,
                "kernel_s": {}, "groups": {}, "device_ops": [],
                "idle_gaps": []}


def run(workload: str, *, seed: int = 2 ** 31 + 7, seconds: float = 2.0,
        trace: bool = False, control: bool = False) -> dict:
    """Run ``workload`` tiny on the CPU; -> the result object."""
    import graftbench.trace as gtrace
    saved = (harness.port_config, harness.reference_model,
             gtrace.DeviceTrace)
    harness.port_config = tiny_config
    harness.reference_model = tiny_reference_model
    gtrace.DeviceTrace = FakeTrace
    try:
        return harness.run_cell(tiny_cell(workload), seed, seconds, trace,
                                torch.device("cpu"),
                                t_start=time.perf_counter(),
                                control=control)
    finally:
        (harness.port_config, harness.reference_model,
         gtrace.DeviceTrace) = saved


if __name__ == "__main__":
    out = run(sys.argv[1], trace=len(sys.argv) > 2 and sys.argv[2] == "1")
    from graftbench.run import forbidden_modules
    out["forbidden"] = forbidden_modules()
    print(json.dumps(out))
