"""Cross-process transport for the serving data path.

Graft's real data path crosses the network: the mobile-side fragment
hands its activation tensor to a server-side stage pool over a socket,
and the paper's SLO accounting budgets explicitly for that transmission
hop. This module makes the hop *pluggable* so the same executor code
serves three deployments:

  * :class:`InProcessTransport` — loopback channels that still pass every
    payload through the wire framing (serialization is exercised and
    measured, no sockets). The default for tests/benches.
  * :class:`SocketTransport` — length-prefixed msgpack/numpy frames over
    localhost TCP with persistent connections (one socket per channel,
    reused across requests — connection setup is paid once, as in the
    paper's long-lived client sessions).
  * :class:`ShapedTransport` — wraps another transport and injects
    per-client bandwidth/latency from a bandwidth trace (any object
    with ``.at(t)`` in bytes/s), emulating the 5G uplink the paper replays with
    ``tc`` shaping. Delays are virtual-clock by default (recorded, not
    slept) so benches stay fast; ``realtime=True`` actually sleeps.

Wire format
-----------

A frame is ``u64-be length || msgpack body``. Torch tensors are encoded
as ``{"__pt__": 1, "dtype": str, "shape": [..], "data": bytes}`` — the
dtype tag is torch's own name ("bfloat16", "float32", ...) and the data
its raw bytes, so a bf16 tensor crosses as its 16-bit words and is
rebuilt with torch (numpy cannot hold bf16 without ``ml_dtypes``). A
tensor on the card is copied to the host on the way out; the receiver
moves it to its own device. Numpy arrays keep the reference's ``__nd__``
envelope. Any dtype/shape round-trips bit-exactly. Frames larger than
``max_frame_bytes`` are refused on both ends (:class:`FrameError`);
a peer closing mid-frame surfaces as :class:`TruncatedFrameError` —
never a silent short read.

Every channel records ``(t_wall_s, nbytes, ms)`` per transfer in a
:class:`TransferStats`; ``ServingController.observe_uplink`` consumes
these samples so the bandwidth estimator can run on transport-measured
uplink throughput instead of simulator-fabricated numbers.
"""
from __future__ import annotations

import io
import socket
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import msgpack
import numpy as np
import torch

__all__ = [
    "FrameError", "TruncatedFrameError", "TransferStats", "error_reply",
    "encode_frame", "decode_frame", "read_frame", "write_frame",
    "Channel", "Transport", "InProcessTransport", "SocketTransport",
    "ShapedTransport", "LinkShape", "ZEROCOPY_MIN_BYTES",
    "KV_FRAME", "encode_kv_blocks", "decode_kv_blocks", "is_kv_frame",
    "kv_frame_nbytes",
]

_LEN = struct.Struct(">Q")
DEFAULT_MAX_FRAME = 1 << 30          # 1 GiB: far above any smoke activation
LARGE_FRAME_BYTES = 1 << 16          # bodies this large are sent unjoined
ZEROCOPY_MIN_BYTES = 1 << 16         # arrays >= 64 KiB decode as views into
                                     # the frame buffer (no per-array copy);
                                     # smaller ones copy so they stay
                                     # writable and don't pin big buffers


class FrameError(ValueError):
    """Malformed or oversized frame."""


def error_reply(e: Exception) -> dict:
    """The ONE wire format for handler errors. ``etype`` carries the
    exception class name so peers re-raise typed errors (e.g.
    ``PoolHandle._call`` re-raises ``PoolDrainingError``) without
    matching on message text; every handler must build its envelope
    here."""
    return {"ok": False, "etype": type(e).__name__,
            "error": f"{type(e).__name__}: {e}"}


class TruncatedFrameError(FrameError):
    """The stream ended mid-frame (peer died / short read)."""


# ---------------------------------------------------------------------------
# msgpack body <-> python, with exact ndarray round-trip
# ---------------------------------------------------------------------------

def _raw_bytes(a: np.ndarray) -> memoryview:
    """A contiguous array's bytes as a flat view: msgpack copies them into
    the frame once, with no intermediate ``tobytes`` copy."""
    return memoryview(a.reshape(-1)).cast("B")


def _pack_default(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous().cpu()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return {"__pt__": 1, "dtype": str(t.dtype).removeprefix("torch."),
                "shape": list(t.shape), "data": _raw_bytes(raw.numpy())}
    if isinstance(obj, np.ndarray):
        # ascontiguousarray promotes 0-d to 1-d: keep the ORIGINAL shape
        a = np.ascontiguousarray(obj)
        return {"__nd__": 1, "dtype": a.dtype.str, "shape": list(obj.shape),
                "data": _raw_bytes(a)}
    if isinstance(obj, (np.generic,)):          # numpy scalars
        return obj.item()
    raise TypeError(f"unencodable type {type(obj)!r}")


def _unpack_tensor(obj) -> torch.Tensor:
    dtype = getattr(torch, obj["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise FrameError(f"unknown tensor dtype {obj['dtype']!r}")
    buf = bytearray(obj["data"])          # writable: the tensor owns it
    if not buf:
        return torch.empty(obj["shape"], dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(obj["shape"])


def _unpack_hook(obj):
    if obj.get("__pt__") == 1:
        return _unpack_tensor(obj)
    if obj.get("__nd__") == 1:
        arr = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
        arr = arr.reshape(obj["shape"])
        if arr.nbytes < ZEROCOPY_MIN_BYTES:
            return arr.copy()                     # writable, owns its data
        # large frames: hand out the (read-only) view into the received
        # buffer instead of paying a copy per array
        return arr
    return obj


# ---------------------------------------------------------------------------
# KV-block frame: prefill -> decode pool handoff payload
# ---------------------------------------------------------------------------

KV_FRAME = "__kvblocks__"            # frame-type marker key


def _deep_tuple(x):
    """msgpack flattens tuples to lists; chain keys need the exact tuple
    structure back (sigs nest: ``("m", ("a", 0), 7)``)."""
    if isinstance(x, (list, tuple)):
        return tuple(_deep_tuple(v) for v in x)
    return x


def encode_kv_blocks(payload: dict) -> dict:
    """``PagedKVCache.export_prefix`` payload -> a typed wire envelope.

    The envelope is an ordinary msgpack-able dict (ndarrays ride the
    ``__nd__`` codec at any depth) tagged with :data:`KV_FRAME` so the
    receiving side can validate it as a KV handoff rather than trusting
    whatever shape arrives. Pure restructuring — no copies beyond what
    the arena export already made.
    """
    return {KV_FRAME: 1,
            "sig": payload["sig"],
            "block_tokens": int(payload["block_tokens"]),
            "prompt_len": int(payload["prompt_len"]),
            "blocks": [{"tokens": [int(t) for t in b["tokens"]],
                        "filled": int(b["filled"]),
                        "k": b["k"], "v": b["v"]}
                       for b in payload["blocks"]]}


def is_kv_frame(obj) -> bool:
    return isinstance(obj, dict) and obj.get(KV_FRAME) == 1


def decode_kv_blocks(frame: dict) -> dict:
    """Validate a received KV-block envelope and restore tuple-typed
    keys (msgpack listifies tuples; the prefix-chain keys the importing
    arena derives from ``sig`` must match the exporter's bit-for-bit).
    Malformed envelopes raise :class:`FrameError` — the transport's one
    typed error — never a downstream numpy/KeyError."""
    if not is_kv_frame(frame):
        raise FrameError("not a KV-block frame")
    try:
        bt = int(frame["block_tokens"])
        out = {"sig": _deep_tuple(frame["sig"]), "block_tokens": bt,
               "prompt_len": int(frame["prompt_len"]), "blocks": []}
        if bt <= 0:
            raise FrameError(f"bad block_tokens {bt}")
        for b in frame["blocks"]:
            toks = [int(t) for t in b["tokens"]]
            filled = int(b["filled"])
            k, v = np.asarray(b["k"]), np.asarray(b["v"])
            if not (0 < filled <= bt and len(toks) == filled
                    and k.shape == v.shape and k.shape[:1] == (filled,)):
                raise FrameError(
                    f"inconsistent KV block: filled={filled} "
                    f"ntokens={len(toks)} k={k.shape} v={v.shape}")
            out["blocks"].append({"tokens": toks, "filled": filled,
                                  "k": k, "v": v})
        return out
    except FrameError:
        raise
    except Exception as e:
        raise FrameError(f"malformed KV-block frame: "
                         f"{type(e).__name__}: {e}") from None


def kv_frame_nbytes(frame: dict) -> int:
    """Approximate wire size of a KV envelope (the KV arrays dominate;
    used to charge the handoff hop to the shed-slack model before the
    transfer happens)."""
    n = 0
    for b in frame.get("blocks", ()):
        for part in (b.get("k"), b.get("v")):
            a = np.asarray(part) if part is not None else None
            n += a.nbytes if a is not None else 0
        n += 8 * len(b.get("tokens", ()))
    return n + 64


def _encode_body(msg: dict, max_frame_bytes: int) -> bytes:
    body = msgpack.packb(msg, default=_pack_default, use_bin_type=True)
    if len(body) > max_frame_bytes:
        raise FrameError(f"frame of {len(body)} bytes exceeds "
                         f"max_frame_bytes={max_frame_bytes}")
    return body


def encode_frame(msg: dict, *, max_frame_bytes: int = DEFAULT_MAX_FRAME
                 ) -> bytes:
    """``msg`` (msgpack-able dict, tensors and ndarrays allowed) ->
    framed bytes."""
    body = _encode_body(msg, max_frame_bytes)
    return _LEN.pack(len(body)) + body


def decode_frame(buf: bytes, *, max_frame_bytes: int = DEFAULT_MAX_FRAME
                 ) -> dict:
    """Inverse of :func:`encode_frame` for a fully-buffered frame."""
    return read_frame(io.BytesIO(buf), max_frame_bytes=max_frame_bytes)


def _read_exact(readable, n: int) -> bytearray:
    """Read exactly n bytes from a socket or file-like; raise on EOF.

    Reads straight into ONE preallocated buffer through a memoryview
    (``recv_into``/``readinto``) instead of accumulating per-recv bytes
    chunks and joining them — for a large activation frame the old path
    copied every byte twice (chunk + join) before decoding even started.
    """
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if hasattr(readable, "recv_into"):
            k = readable.recv_into(view[got:n])
        elif hasattr(readable, "readinto"):
            k = readable.readinto(view[got:n])
        else:
            chunk = readable.read(n - got)
            k = len(chunk)
            view[got:got + k] = chunk
        if not k:
            raise TruncatedFrameError(
                f"stream ended after {got}/{n} bytes")
        got += k
    return buf


def read_frame(readable, *, max_frame_bytes: int = DEFAULT_MAX_FRAME
               ) -> dict:
    """Read one length-prefixed frame from a socket or file-like object."""
    header = _read_exact(readable, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > max_frame_bytes:
        raise FrameError(f"incoming frame of {length} bytes exceeds "
                         f"max_frame_bytes={max_frame_bytes}")
    body = _read_exact(readable, length)
    try:
        return msgpack.unpackb(body, object_hook=_unpack_hook, raw=False,
                               strict_map_key=False)
    except FrameError:
        raise
    except Exception as e:
        # garbage bodies (bit flips, hostile peers, ndarray envelopes
        # whose data/shape/dtype disagree) surface as the ONE typed
        # error, never a raw msgpack/numpy internal
        raise FrameError(f"undecodable frame body: "
                         f"{type(e).__name__}: {e}") from None


def write_frame(sock: socket.socket, msg: dict, *,
                max_frame_bytes: int = DEFAULT_MAX_FRAME) -> int:
    """Frame + send; returns bytes written. A large body goes out after
    its length prefix rather than copied behind it."""
    body = _encode_body(msg, max_frame_bytes)
    header = _LEN.pack(len(body))
    if len(body) < LARGE_FRAME_BYTES:
        sock.sendall(header + body)
    else:
        sock.sendall(header)
        sock.sendall(body)
    return len(header) + len(body)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

MAX_STAT_SAMPLES = 65_536      # per channel; long-running servers must
                               # not grow a tuple per request forever


@dataclass
class TransferStats:
    """Per-channel transfer log: what actually crossed the hop. Bounded:
    the oldest samples roll off past MAX_STAT_SAMPLES — consumers that
    want every sample (the controller's bandwidth estimator) should
    ``drain()`` periodically."""
    samples: deque = field(
        default_factory=lambda: deque(maxlen=MAX_STAT_SAMPLES))

    def record(self, nbytes: int, ms: float) -> None:
        self.samples.append((time.time(), int(nbytes), float(ms)))

    @property
    def n_transfers(self) -> int:
        return len(self.samples)

    @property
    def total_bytes(self) -> int:
        return sum(n for _, n, _ in self.samples)

    @property
    def total_ms(self) -> float:
        return sum(ms for _, _, ms in self.samples)

    def mean_bw(self) -> float:
        """Mean measured throughput in bytes/s over all transfers."""
        ms = self.total_ms
        return self.total_bytes / (ms / 1e3) if ms > 0 else 0.0

    def drain(self) -> list:
        """Return and clear the sample log (consumers pull incrementally)."""
        out = list(self.samples)
        self.samples.clear()
        return out


# ---------------------------------------------------------------------------
# transport abstraction
# ---------------------------------------------------------------------------

class Channel:
    """One request/reply lane to a served endpoint."""

    def __init__(self, name: str):
        self.name = name
        self.stats = TransferStats()

    def request(self, msg: dict) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Transport:
    """Factory for channels to named endpoints.

    ``serve(name, handler)`` publishes ``handler(msg) -> reply`` under
    ``name``; ``connect(name)`` returns a :class:`Channel` to it. What a
    *name* resolves to is transport-specific (a dict entry in-process, a
    ``host:port`` for sockets).
    """

    def serve(self, name: str, handler: Callable[[dict], dict]) -> str:
        """Publish a handler; returns the address ``connect`` accepts."""
        raise NotImplementedError

    def connect(self, name: str) -> Channel:
        raise NotImplementedError

    def stop(self, name: str) -> None:
        """Tear down a served endpoint (no-op if unknown)."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------- in-process

class _LoopbackChannel(Channel):
    def __init__(self, name, handler, max_frame_bytes):
        super().__init__(name)
        self._handler = handler
        self._max = max_frame_bytes

    def request(self, msg: dict) -> dict:
        t0 = time.perf_counter()
        wire = encode_frame(msg, max_frame_bytes=self._max)
        reply = self._handler(decode_frame(wire, max_frame_bytes=self._max))
        back = encode_frame(reply, max_frame_bytes=self._max)
        ms = (time.perf_counter() - t0) * 1e3
        self.stats.record(len(wire), ms)
        return decode_frame(back, max_frame_bytes=self._max)


class InProcessTransport(Transport):
    """Loopback transport: full encode/decode on every hop, no sockets.

    The payload path is byte-identical to :class:`SocketTransport` — only
    the copy between peers is skipped — so serialization cost and frame
    errors are exercised even in single-process runs.
    """

    def __init__(self, *, max_frame_bytes: int = DEFAULT_MAX_FRAME):
        self.max_frame_bytes = max_frame_bytes
        self._handlers: dict[str, Callable] = {}

    def serve(self, name: str, handler: Callable[[dict], dict]) -> str:
        self._handlers[name] = handler
        return name

    def connect(self, name: str) -> Channel:
        if name not in self._handlers:
            raise KeyError(f"no endpoint {name!r} served in-process")
        return _LoopbackChannel(name, self._handlers[name],
                                self.max_frame_bytes)

    def stop(self, name: str) -> None:
        self._handlers.pop(name, None)


# ---------------------------------------------------------------- sockets

class SocketChannel(Channel):
    """Persistent TCP connection issuing framed request/reply pairs."""

    def __init__(self, name: str, addr: tuple, max_frame_bytes: int,
                 *, sock: Optional[socket.socket] = None):
        super().__init__(name)
        self._max = max_frame_bytes
        if sock is None:
            sock = socket.create_connection(addr, timeout=60.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._lock = threading.Lock()

    def request(self, msg: dict) -> dict:
        with self._lock:
            t0 = time.perf_counter()
            n = write_frame(self._sock, msg, max_frame_bytes=self._max)
            reply = read_frame(self._sock, max_frame_bytes=self._max)
            self.stats.record(n, (time.perf_counter() - t0) * 1e3)
            return reply

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _SocketServer:
    """One listening socket; each accepted connection gets a serve thread."""

    def __init__(self, handler, max_frame_bytes, host="127.0.0.1"):
        self._handler = handler
        self._max = max_frame_bytes
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, 0))
        self._lsock.listen(16)
        self.addr = self._lsock.getsockname()
        self._closing = False
        self._threads: list[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn):
        try:
            while True:
                try:
                    msg = read_frame(conn, max_frame_bytes=self._max)
                except (TruncatedFrameError, OSError):
                    return                      # peer went away
                try:
                    reply = self._handler(msg)
                except Exception as e:          # surface errors to the peer
                    reply = error_reply(e)
                write_frame(conn, reply, max_frame_bytes=self._max)
        finally:
            conn.close()

    def close(self):
        self._closing = True
        try:
            self._lsock.close()
        except OSError:
            pass


class SocketTransport(Transport):
    """Localhost TCP transport, length-prefixed msgpack/numpy frames.

    Endpoints served here run in *this* process (a thread per
    connection); ``register(name, addr)`` additionally maps names to
    remote listeners (e.g. worker subprocesses) so ``connect`` reaches
    across process boundaries.
    """

    def __init__(self, *, max_frame_bytes: int = DEFAULT_MAX_FRAME,
                 host: str = "127.0.0.1"):
        self.max_frame_bytes = max_frame_bytes
        self.host = host
        self._servers: dict[str, _SocketServer] = {}
        self._remote: dict[str, tuple] = {}

    def serve(self, name: str, handler: Callable[[dict], dict]) -> str:
        srv = _SocketServer(handler, self.max_frame_bytes, host=self.host)
        self._servers[name] = srv
        return f"{srv.addr[0]}:{srv.addr[1]}"

    def register(self, name: str, addr: tuple) -> None:
        """Map ``name`` to an already-listening ``(host, port)``."""
        self._remote[name] = (addr[0], int(addr[1]))

    def connect(self, name: str) -> SocketChannel:
        if name in self._servers:
            addr = self._servers[name].addr
        elif name in self._remote:
            addr = self._remote[name]
        elif ":" in name:                       # literal host:port
            host, port = name.rsplit(":", 1)
            addr = (host, int(port))
        else:
            raise KeyError(f"no endpoint {name!r}")
        return SocketChannel(name, addr, self.max_frame_bytes)

    def stop(self, name: str) -> None:
        srv = self._servers.pop(name, None)
        if srv is not None:
            srv.close()
        self._remote.pop(name, None)

    def close(self) -> None:
        for name in list(self._servers):
            self.stop(name)
        self._remote.clear()


# ----------------------------------------------------------------- shaping

@dataclass
class LinkShape:
    """One client's emulated uplink: a bandwidth trace + fixed RTT."""
    trace: object                     # BandwidthTrace (duck-typed: .at(t))
    rtt_ms: float = 10.0

    def delay_ms(self, nbytes: int, t_s: float) -> float:
        bw = max(float(self.trace.at(t_s)), 1.0)       # bytes/s
        return self.rtt_ms / 2.0 + nbytes / bw * 1e3


class _ShapedChannel(Channel):
    def __init__(self, inner: Channel, owner: "ShapedTransport"):
        super().__init__(inner.name)
        self._inner = inner
        self._owner = owner
        self.stats = inner.stats      # shaped ms overwrite the raw sample

    def request(self, msg: dict) -> dict:
        shape = self._owner.shape_for(msg.get("client"))
        reply = self._inner.request(msg)
        if shape is not None and self._inner.stats.samples:
            t, nbytes, raw_ms = self._inner.stats.samples[-1]
            extra = shape.delay_ms(nbytes, self._owner.clock())
            if self._owner.realtime:
                time.sleep(extra / 1e3)
            self._inner.stats.samples[-1] = (t, nbytes, raw_ms + extra)
        return reply

    def close(self) -> None:
        self._inner.close()


class ShapedTransport(Transport):
    """Inject per-client bandwidth/latency into an inner transport.

    ``shapes`` maps client name -> :class:`LinkShape`; requests whose
    ``msg["client"]`` matches get the trace-driven transfer delay added
    to their recorded hop time (and, with ``realtime=True``, actually
    slept — the two-process demo uses that to make fades *visible* in
    wall time). ``clock`` positions the trace; defaults to wall time
    since construction, matching how the simulator replays traces.
    """

    def __init__(self, inner: Transport, shapes: dict, *,
                 realtime: bool = False,
                 clock: Optional[Callable[[], float]] = None):
        self.inner = inner
        self.shapes = dict(shapes)
        self.realtime = realtime
        self._t0 = time.time()
        self._clock = clock

    def clock(self) -> float:
        return self._clock() if self._clock is not None \
            else time.time() - self._t0

    def shape_for(self, client) -> Optional[LinkShape]:
        if client is None:
            return None
        return self.shapes.get(client)

    def serve(self, name, handler):
        return self.inner.serve(name, handler)

    def connect(self, name) -> Channel:
        return _ShapedChannel(self.inner.connect(name), self)

    def stop(self, name) -> None:
        self.inner.stop(name)

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, item):
        # delegate transport-specific extras (e.g. SocketTransport.register)
        return getattr(self.inner, item)
