"""The ranks of one ``torch.distributed`` group as processes of one host.

:func:`spawn_ranks` starts ``n`` processes (start method ``spawn``: a
CUDA context does not survive ``fork``), gives them a gloo group of
world size ``n`` over ``tcp://localhost`` on a free port, and calls
``fn(rank, n, *args)`` in each. Gloo, because it takes CPU tensors and
CUDA tensors alike and lets several ranks share one card, which NCCL
refuses: ranks that share an H100 sum CUDA tensors through host memory.
``fn`` must be importable by name (a module-level function), since each
process imports its module afresh.
"""
from __future__ import annotations

import socket
import time


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, n: int, port: int, args: tuple) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, *args, timeout: float) -> float:
    """Run ``fn(rank, n, *args)`` in ``n`` processes of one gloo group;
    -> the wall seconds until every rank returned. A rank that raises or
    exits non-zero stops the others and raises here
    (``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``); ranks still running ``timeout`` seconds
    after the start are killed, and :class:`TimeoutError` is raised."""
    import torch.multiprocessing as mp
    t0 = time.monotonic()
    ctx = mp.start_processes(_rank_main, args=(fn, n, free_port(), args),
                             nprocs=n, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(0.0, t0 + timeout - time.monotonic())):
            if time.monotonic() >= t0 + timeout:
                raise TimeoutError(f"{n} ranks of {fn.__name__} still ran "
                                   f"after {timeout:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return time.monotonic() - t0
