"""Which collectives gloo runs on CUDA tensors, as DTensor calls them.

Four ranks of one gloo group share the card (``distributed/ranks.py``).
For each of all-reduce, all-gather, reduce-scatter and all-to-all, and
for a set of DTensor redistributions over a cuda ``DeviceMesh`` (2, 2),
a fresh group runs the functional collective (``torch.distributed.
_functional_collectives``, what DTensor calls) on CUDA tensors, first as
the installed torch has it, then with the functional ops routed to the
c10d calls (``distributed/spmd.py::gloo_cuda_collectives``). Each test
prints every rank's result or the way its group ended (a rank killed by
a signal shows as ``ProcessExitedException``).

  python scripts/gloo_cuda_probe.py            # on the card
  python scripts/gloo_cuda_probe.py --device cpu
"""
import argparse
import contextlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

TESTS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "dtensor")


def run(test: str, x, dev):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    g = dist.group.WORLD
    if test == "all-reduce":
        return f"sum {float((fc.all_reduce(x, 'sum', g) + 0).sum())}"
    if test == "all-gather":
        return f"shape {tuple((fc.all_gather_tensor(x, 0, g) + 0).shape)}"
    if test == "reduce-scatter":
        y = fc.reduce_scatter_tensor(x, "sum", 0, g) + 0
        return f"shape {tuple(y.shape)} sum {float(y.sum())}"
    if test == "all-to-all":
        y = fc.all_to_all_single(x, None, None, g) + 0
        return f"sum {float(y.sum())}"
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    dm = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
    full = torch.arange(16 * 8, dtype=torch.float32, device=dev).reshape(16, 8)
    d = distribute_tensor(full, dm, (Shard(0), Shard(1)), src_data_rank=None)
    swap = torch.equal(d.redistribute(dm, (Shard(1), Shard(0))).full_tensor(),
                       full)
    p = DTensor.from_local(torch.ones(16, 8, device=dev), dm,
                           (Partial(), Partial()))
    summed = torch.equal(p.redistribute(dm, (Shard(0), Shard(0)))
                         .full_tensor(), 4 * torch.ones(16, 8, device=dev))
    whole = torch.equal(d.redistribute(dm, (Replicate(), Replicate()))
                        .to_local(), full)
    return f"(S0,S1)->(S1,S0) {swap}, partial->shard {summed}, " \
        f"gather {whole}"


def rank_fn(rank: int, n: int, test: str, routed: bool, device: str,
            out_dir: str) -> None:
    import torch
    from repro_torch.distributed import spmd
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    x = torch.arange(32, dtype=torch.float32, device=dev).reshape(8, 4) + rank
    t = time.perf_counter()
    ctx = spmd.gloo_cuda_collectives() if routed and dev.type == "cuda" \
        else contextlib.nullcontext()
    try:
        with ctx:
            msg = run(test, x, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res = f"ok {1e3 * (time.perf_counter() - t):.1f} ms: {msg}"
    except Exception as e:          # noqa: BLE001 — report, not raise
        res = f"refused: {type(e).__name__}: {str(e)[:200]}"
    with open(os.path.join(out_dir, f"{test}-{routed}-{rank}.txt"), "w") as f:
        f.write(res)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import torch
    from repro_torch.distributed.ranks import spawn_ranks
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0) if args.device == 'cuda' else 'cpu'}")
    out = tempfile.mkdtemp()
    for routed in (False, True):
        for test in TESTS:
            try:
                st = f"{spawn_ranks(rank_fn, 4, test, routed, args.device, out, timeout=90):.1f} s"
            except Exception as e:   # noqa: BLE001 — a killed rank, say
                st = f"{type(e).__name__}: {str(e).strip()[:120]}"
            ranks = []
            for r in range(4):
                p = os.path.join(out, f"{test}-{routed}-{r}.txt")
                ranks.append(open(p).read() if os.path.exists(p) else "-")
            print(f"{'routed' if routed else 'as installed'} {test}: {st}")
            for r, line in enumerate(ranks):
                print(f"  rank {r}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
