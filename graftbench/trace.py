"""Device trace of a window: ``torch.profiler`` (CUPTI) over the whole
traced window, reduced from the raw profiler events without building
the profiler's per-event Python objects.

What a run reads from it: the seconds in which any device operation ran
(the union of kernel, copy and set intervals), each kernel name's summed
device seconds, the kernel groups (the grouping ``chip_smoke.py``
prints: attention, matmul, memcpy/memset, other) and the longest idle
gaps, each named by the innermost host operation running at its middle.
"""
from __future__ import annotations

import time

import numpy as np
import torch

# substrings of cuBLAS/CUTLASS matmul kernel names
MATMUL_NAMES = ("gemm", "xmma", "cutlass", "cublas", "nvjet")
# the port's attention kernels (kernels/csrc/*.cu)
ATTENTION_NAMES = ("attn_fwd_", "attn_bwd_", "decode_attn_kernel")


def _no() -> bool:
    return False


def group_of(name: str) -> str:
    low = name.lower()
    if any(t in name for t in ATTENTION_NAMES):
        return "attention"
    if any(t in low for t in MATMUL_NAMES):
        return "matmul"
    if low.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    return "other"


def union_seconds(starts: np.ndarray, ends: np.ndarray) -> float:
    """Length of the union of intervals [starts, ends) (ns) in s."""
    if starts.size == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    seg_end = np.append(reach[idx[1:] - 1], reach[-1])
    return float((seg_end - s[idx]).sum()) / 1e9


class DeviceTrace:
    """Start before the window, stop after its drain; then ``summary``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self._prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()

    def summary(self, n_gaps: int = 10) -> dict:
        window_s = self.t1 - self.t0
        cuda = torch.autograd.DeviceType.CUDA
        dev_s, dev_e, dev_n = [], [], []
        cpu_s, cpu_e, cpu_n = [], [], []
        for ev in self._prof.profiler.kineto_results.events():
            d = ev.duration_ns()
            if d <= 0:
                continue
            if ev.device_type() == cuda:
                dev_s.append(ev.start_ns())
                dev_e.append(ev.start_ns() + d)
                dev_n.append(ev.name())
            elif not getattr(ev, "is_python_function", _no)():
                cpu_s.append(ev.start_ns())
                cpu_e.append(ev.start_ns() + d)
                cpu_n.append(ev.name())
        s = np.asarray(dev_s, np.int64)
        e = np.asarray(dev_e, np.int64)
        kernel_s: dict = {}
        for name, dur in zip(dev_n, (e - s).tolist()):
            kernel_s[name] = kernel_s.get(name, 0.0) + dur / 1e9
        groups: dict = {}
        for name, sec in kernel_s.items():
            g = group_of(name)
            groups[g] = groups.get(g, 0.0) + sec
        busy = union_seconds(s, e)
        gaps = self._gaps(s, e, np.asarray(cpu_s, np.int64),
                          np.asarray(cpu_e, np.int64), cpu_n, n_gaps)
        top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": window_s,
                "kernel_s": kernel_s, "groups": groups,
                "device_ops": [[n, v] for n, v in top],
                "idle_gaps": gaps, "n_device_events": int(s.size)}

    @staticmethod
    def _gaps(s, e, cs, ce, cn, n: int) -> list:
        """The ``n`` longest gaps between device activity, each named by
        the innermost host operation covering its middle, or, where none
        does (the host was in Python between operators), by the host
        operation that ended last before it."""
        if s.size < 2:
            return []
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e)
        gap = s[1:] - reach[:-1]
        longest = np.argsort(-gap)[:n]
        out = []
        for i in longest:
            if gap[i] <= 0:
                break
            mid = (reach[i] + s[i + 1]) // 2
            cover = np.flatnonzero((cs <= mid) & (ce >= mid))
            if cover.size:
                name = cn[cover[np.argmax(cs[cover])]]
            else:
                before = np.flatnonzero(ce <= mid)
                name = "python after " + cn[before[np.argmax(ce[before])]] \
                    if before.size else "python"
            out.append([name, float(gap[i]) / 1e9])
        return out
