"""Serving runtime: clients, partitioning, simulation, real execution,
cross-process transport and workers, online control, the event-driven
server and its fleet of front-ends."""
from repro_torch.serving.neurosurgeon import partition, PartitionDecision
from repro_torch.serving.clients import MobileClient, make_fleet, fleet_fragments
from repro_torch.serving.simulator import simulate, SimResult
from repro_torch.serving.transport import (Transport, InProcessTransport,
                                           SocketTransport, ShapedTransport,
                                           LinkShape, TransferStats,
                                           FrameError, TruncatedFrameError)
from repro_torch.serving.executor import (GraftExecutor, ServeRequest,
                                          PoolDrainingError)
from repro_torch.serving.remote import (RemoteExecutor, SSHLauncher,
                                        SubprocessLauncher, WorkerDiedError,
                                        WorkerLauncher)
from repro_torch.serving.controller import ServingController, Estimate
from repro_torch.serving.batcher import (BatchItem, MicroBatcher, ShedPolicy,
                                         bucket_size)
from repro_torch.serving.kvcache import KVCacheOOM, PagedKVCache
from repro_torch.serving.server import GraftServer, run_serve_loop
from repro_torch.serving.router import WeightedRouter
from repro_torch.serving.fleet import GraftFleet, rendezvous_route

__all__ = [
    "partition", "PartitionDecision", "MobileClient", "make_fleet",
    "fleet_fragments", "simulate", "SimResult", "GraftExecutor",
    "ServeRequest", "PoolDrainingError", "RemoteExecutor",
    "WorkerLauncher", "SubprocessLauncher", "SSHLauncher",
    "WorkerDiedError", "ServingController", "Estimate",
    "BatchItem", "MicroBatcher", "ShedPolicy", "bucket_size",
    "PagedKVCache", "KVCacheOOM",
    "GraftServer", "run_serve_loop", "GraftFleet", "rendezvous_route",
    "WeightedRouter",
    "Transport", "InProcessTransport", "SocketTransport", "ShapedTransport",
    "LinkShape", "TransferStats", "FrameError", "TruncatedFrameError",
]
