"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``<repo>/build/kernels/`` on first
use (one ``nvcc`` per source, all started together), then loaded with
``ctypes``. A library's file name carries a hash of its source and of
the shared headers (``csrc/*.cuh``), so an edited source or header is
rebuilt and a stale build is never loaded. Nothing is built when this
module is imported: the CPU never needs the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelCompileError(
            "nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _target(src: Path) -> Path:
    """The library built from ``src``: its name hashes the source and
    every header beside it, so an edited header rebuilds too."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(*, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{source stem: nvcc output}`` for the sources compiled in
    this call; ``ptxas_verbose`` adds ``-Xptxas -v`` so that output lists
    each kernel's registers, shared memory and spills. Raises
    :class:`KernelCompileError` if any compile fails.
    """
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for src in sorted(CSRC.glob("*.cu")):
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            if ptxas_verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            jobs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        logs, failed = {}, []
        for stem, (proc, tmp, out) in jobs.items():
            text, _ = proc.communicate()
            logs[stem] = text
            if proc.returncode != 0:
                failed.append(f"{stem} (exit {proc.returncode}):\n{text}")
                continue
            os.replace(tmp, out)
        if failed:
            raise KernelCompileError("nvcc failed for " + "\n".join(failed))
        return logs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on demand)."""
    lib: Optional[ctypes.CDLL] = _libs.get(stem)
    if lib is not None:
        return lib
    src = CSRC / f"{stem}.cu"
    if not src.exists():
        raise KernelCompileError(f"no kernel source {src}")
    out = _target(src)
    if not out.exists():
        build_all()
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs[stem] = ctypes.CDLL(str(out))
    return lib
