"""Serving runtime, one-shot slice: executor, transport, telemetry."""
from repro_torch.serving.transport import (Transport, InProcessTransport,
                                           SocketTransport, ShapedTransport,
                                           LinkShape, TransferStats,
                                           FrameError, TruncatedFrameError)
from repro_torch.serving.executor import (GraftExecutor, ServeRequest,
                                          PoolDrainingError)
from repro_torch.serving.batcher import bucket_size

__all__ = [
    "GraftExecutor", "ServeRequest", "PoolDrainingError", "bucket_size",
    "Transport", "InProcessTransport", "SocketTransport", "ShapedTransport",
    "LinkShape", "TransferStats", "FrameError", "TruncatedFrameError",
]
