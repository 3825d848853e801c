"""Serving runtime: clients, partitioning, simulation, real execution,
transport, online control and the event-driven server."""
from repro_torch.serving.neurosurgeon import partition, PartitionDecision
from repro_torch.serving.clients import MobileClient, make_fleet, fleet_fragments
from repro_torch.serving.simulator import simulate, SimResult
from repro_torch.serving.transport import (Transport, InProcessTransport,
                                           SocketTransport, ShapedTransport,
                                           LinkShape, TransferStats,
                                           FrameError, TruncatedFrameError)
from repro_torch.serving.executor import (GraftExecutor, ServeRequest,
                                          PoolDrainingError)
from repro_torch.serving.controller import ServingController, Estimate
from repro_torch.serving.batcher import (BatchItem, MicroBatcher, ShedPolicy,
                                         bucket_size)
from repro_torch.serving.kvcache import KVCacheOOM, PagedKVCache
from repro_torch.serving.server import GraftServer, run_serve_loop
from repro_torch.serving.router import WeightedRouter

__all__ = [
    "partition", "PartitionDecision", "MobileClient", "make_fleet",
    "fleet_fragments", "simulate", "SimResult", "GraftExecutor",
    "ServeRequest", "PoolDrainingError", "ServingController", "Estimate",
    "BatchItem", "MicroBatcher", "ShedPolicy", "bucket_size",
    "PagedKVCache", "KVCacheOOM", "GraftServer", "run_serve_loop",
    "WeightedRouter",
    "Transport", "InProcessTransport", "SocketTransport", "ShapedTransport",
    "LinkShape", "TransferStats", "FrameError", "TruncatedFrameError",
]
