"""Worker processes for the serving data path: RemoteExecutor.

``GraftExecutor`` already routes every pool hop through a transport
channel; this module puts the *other end* of those channels in worker
processes, so the serving data path genuinely crosses process (and
socket) boundaries, like the paper's testbed where fragments run behind
a network hop from the clients.

Topology: one worker process per stage pool. The parent listens on an
ephemeral port per worker and the worker **dials back** to the parent's
``advertise_host`` — configurable, so workers on other machines reach a
routable address. How the worker process starts is a pluggable
:class:`WorkerLauncher`:

  * :class:`SubprocessLauncher` — ``python -c`` on this machine (the
    default), with the source tree on ``PYTHONPATH``;
  * :class:`SSHLauncher` — ``ssh <host> env PYTHONPATH=... python -m
    repro_torch.serving.remote --connect <advertise:port> --device
    ...``: the same handshake from a genuinely different machine. The
    ``ssh`` argv prefix is injectable, which is also how tests run the
    launcher without an ssh daemon.

The accepted connection is a persistent framed request/reply channel
(the same ``PoolService`` message vocabulary local pools speak). A
worker builds its ``FragmentInstance`` on the device it was started
with (``--device``: the card unless told ``cpu``; without a card it
raises, it never falls back) from ``load`` frames carrying the
parameters its pool's block range reads — the embedding only for a pool
that starts at block 0 (or whose tied head needs it), the final norm and
head only for one that ends at the last block, each tensor cut along its
leading axis so that no frame outgrows the transport's cap — and an
``init`` frame with the pickled model config and the pool's spec. It
then serves submit/flush/execute/retarget/bind/stats/decode ops until
``shutdown``. Its ``stats`` reply carries the kernels' launch counts in
its own process.

Two cluster-grade behaviors live in the parent-side plumbing:

  * **Reconnect with backoff.** A dropped dial-back connection (worker
    crash, OOM-kill, network partition) does not kill the pool: the
    lane that observed the failure triggers :meth:`WorkerProc.recover`,
    which respawns the worker (kill -> exponential backoff -> relaunch
    -> the same parameter slice and spec again) up to ``max_respawns``
    times. The failed request itself raises :class:`WorkerDiedError` —
    queued state died with the worker, so callers
    (``GraftServer._run_batch``) reroute or finish in-process — but the
    NEXT batch flows through the recovered worker.
  * **Per-front-end channels.** An ``open_channel`` op makes the worker
    dial back an *additional* connection, served by its own worker
    thread against the same ``PoolService`` (whose lock serializes
    actual pool execution) — fleet front-ends overlap their transfers,
    the pool stays one resource.

Because workers are keyed by pool identity ``(model, start, end)``,
:meth:`RemoteExecutor.apply_plan` (inherited) keeps surviving workers —
their pid, their weights on the device, their queue — alive across a
replan; only genuinely new block ranges pay a process spawn, a torch
import, a CUDA context and their weights.

On one card every worker is its own CUDA context and the card
time-slices between them; inside a worker every thread launches on the
device's one stream, as in the parent (``serving/server.py``).
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, Optional, Union

import torch

from repro_torch.core.plandiff import PoolSpec
from repro_torch.models.transformer import resolve_device, slice_params
from repro_torch.serving.executor import (FragmentInstance, GraftExecutor,
                                          PoolHandle, PoolService,
                                          pool_endpoint)
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.transport import (
    Channel, DEFAULT_MAX_FRAME, ShapedTransport, SocketChannel,
    SocketTransport, Transport, TruncatedFrameError, _ShapedChannel,
    error_reply, read_frame, write_frame)

WORKER_SPAWN_TIMEOUT_S = 120.0          # launch -> dial-back bound
PING_TIMEOUT_S = 5.0                    # liveness probe bound in recover()
RESPAWN_HEAL_WINDOW_S = 300.0           # healthy this long => budget renews
# parameter bytes per load frame (at most half the transport's cap)
PARAM_CHUNK_BYTES = 256 << 20

# the source root workers need on PYTHONPATH to import repro_torch.*
SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class WorkerDiedError(RuntimeError):
    """The worker's dial-back connection failed mid-request. The worker
    has been recovered (respawned or the lane re-opened) where possible,
    but THIS request was not delivered — any state queued in the dead
    process is gone, so the caller must reroute or finish in-process."""


def bind_host_for(advertise_host: str) -> str:
    """Where the parent's per-worker listener binds: loopback
    advertisements stay on loopback; any routable advertisement binds
    all interfaces ('') so workers on other machines can reach it."""
    return advertise_host if advertise_host in ("127.0.0.1", "localhost") \
        else ""


# ---------------------------------------------------------------------------
# parameter slices on the wire
# ---------------------------------------------------------------------------

def _flatten(tree: dict, prefix: str = "") -> list:
    """[(path, tensor)] of a nested parameter dict, '/'-joined paths."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_flatten(v, path + "/"))
        else:
            out.append((path, v))
    return out


def param_pieces(params: dict, chunk_bytes: int = PARAM_CHUNK_BYTES) -> list:
    """Cut ``params`` into load frames' contents: [[piece, ...], ...],
    each piece ``{"path", "part", "of", "tensor"}`` a run of rows along
    the tensor's leading axis, each frame at most ``chunk_bytes`` of
    tensor data (a single row larger than that travels alone). The
    tensors stay where they lie: a piece is a view, copied to the host
    only when its frame is encoded."""
    frames, cur, cur_bytes = [], [], 0
    for path, t in _flatten(params):
        rows = t.shape[0] if t.dim() else 1
        row_bytes = max(t.numel() * t.element_size() // max(rows, 1), 1)
        step = max(chunk_bytes // row_bytes, 1)
        parts = [t] if t.dim() == 0 else \
            [t[i:i + step] for i in range(0, rows, step)] or [t]
        for i, p in enumerate(parts):
            nbytes = p.numel() * p.element_size()
            if cur and cur_bytes + nbytes > chunk_bytes:
                frames.append(cur)
                cur, cur_bytes = [], 0
            cur.append({"path": path, "part": i, "of": len(parts),
                        "tensor": p})
            cur_bytes += nbytes
    if cur:
        frames.append(cur)
    return frames


def _assemble(pending: dict, device: torch.device) -> dict:
    """Worker side: the received pieces (already on ``device``) joined
    back into the nested parameter dict."""
    out: dict = {}
    for path, parts in pending.items():
        if any(p is None for p in parts):
            raise ValueError(f"parameter {path}: a piece never arrived")
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        node = out
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

class _WorkerState:
    """State shared by every parent connection into one worker process."""

    def __init__(self, connect_addr, max_frame_bytes, device):
        self.connect_addr = connect_addr      # (host, port) to dial back to
        self.max_frame_bytes = max_frame_bytes
        self.device = device
        self.pending: dict = {}               # path -> [piece, ...]
        self.service: Optional[PoolService] = None


def _hello(conn, max_frame_bytes, **fields) -> None:
    write_frame(conn, {"ok": True, "hello": True, "pid": os.getpid(),
                       **fields}, max_frame_bytes=max_frame_bytes)


def _serve_extra(conn, state: _WorkerState) -> None:
    """Serve one extra (per-front-end) lane until it closes. Requests
    hit the same shared PoolService as the main lane — its lock is what
    serializes pool execution server-side while the lanes' socket I/O
    (and the parent-side shaped sleeps) overlap."""
    try:
        while True:
            try:
                msg = read_frame(conn,
                                 max_frame_bytes=state.max_frame_bytes)
            except (TruncatedFrameError, OSError):
                return                       # lane closed: thread exits
            if state.service is None:
                reply = {"ok": False, "error": "worker not initialised"}
            else:
                reply = state.service.handle(msg)
            try:
                write_frame(conn, reply,
                            max_frame_bytes=state.max_frame_bytes)
            except OSError:
                return
    finally:
        conn.close()


def _load(state: _WorkerState, msg: dict) -> dict:
    """One frame of parameter pieces: each moves to the worker's device
    as it arrives, so the host holds one frame at a time."""
    for p in msg["pieces"]:
        parts = state.pending.setdefault(p["path"], [None] * int(p["of"]))
        parts[int(p["part"])] = p["tensor"].to(state.device)
    return {"ok": True, "pid": os.getpid()}


def _init(state: _WorkerState, msg: dict) -> dict:
    cfg = pickle.loads(msg["cfg"])
    spec = PoolSpec(key=tuple(msg["key"]), share=msg["share"],
                    batch=msg["batch"], n_instances=msg["n_instances"],
                    role=msg.get("role", "both"))
    params = _assemble(state.pending, state.device)
    state.pending = {}
    # a worker owns a PRIVATE registry: its state rides back on the
    # stats op (spans drained — the parent takes ownership) and merges
    # parent-side, keyed by pool
    wtel = Telemetry(process=f"worker-{os.getpid()}") \
        if msg.get("telemetry") else None
    inst = FragmentInstance(params, cfg, spec,
                            packed=bool(msg.get("packed", True)),
                            chips=msg.get("chips"),
                            decode_ctx=int(msg.get("decode_ctx", 0)),
                            kv_blocks=int(msg.get("kv_blocks", 64)),
                            kv_block_tokens=int(msg.get("kv_block_tokens",
                                                        16)),
                            telemetry=wtel,
                            layer_offset=int(msg.get("layer_offset", 0)))
    if wtel is not None:
        inst.owns_telemetry = True
    state.service = PoolService(inst)
    return {"ok": True, "pid": os.getpid(), "device": str(inst.device)}


def _worker_loop(conn: socket.socket, connect_addr=None,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME,
                 device: Optional[torch.device] = None) -> int:
    """Serve one pool over ``conn`` (plus dialed-back extra lanes) until
    shutdown."""
    state = _WorkerState(connect_addr, max_frame_bytes,
                         device if device is not None
                         else torch.device("cpu"))
    _hello(conn, max_frame_bytes)
    while True:
        try:
            msg = read_frame(conn, max_frame_bytes=max_frame_bytes)
        except (TruncatedFrameError, OSError):
            return 0                        # parent went away: exit quietly
        except Exception:                   # anything else must be LOUD
            traceback.print_exc(file=sys.stderr)
            return 1
        op = msg.get("op")
        if op == "shutdown":
            write_frame(conn, {"ok": True, "pid": os.getpid()},
                        max_frame_bytes=max_frame_bytes)
            return 0
        if op == "ping":
            reply = {"ok": True, "pid": os.getpid()}
        elif op == "open_channel":
            # dial an ADDITIONAL lane back to the parent; its serve
            # thread shares this worker's PoolService. Dial before the
            # ok-reply so the parent's accept() can never outwait a
            # connection that was refused.
            try:
                if state.connect_addr is None:
                    raise RuntimeError(
                        "worker has no dial-back address for extra lanes")
                c2 = socket.create_connection(state.connect_addr,
                                              timeout=30.0)
                c2.settimeout(None)     # connect bound; reads idle forever
                c2.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _hello(c2, max_frame_bytes, extra=True)
                threading.Thread(target=_serve_extra, args=(c2, state),
                                 daemon=True).start()
                reply = {"ok": True, "pid": os.getpid()}
            except Exception as e:
                reply = error_reply(e)
        elif op in ("load", "init"):
            try:
                reply = (_load if op == "load" else _init)(state, msg)
            except Exception as e:
                state.pending = {}
                reply = error_reply(e)
        elif state.service is None:
            reply = {"ok": False, "error": "worker not initialised"}
        else:
            reply = state.service.handle(msg)
        write_frame(conn, reply, max_frame_bytes=max_frame_bytes)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.serving.remote")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="parent's per-worker listener to dial back to "
                         "(the parent's --advertise-host)")
    ap.add_argument("--max-frame", type=int, default=DEFAULT_MAX_FRAME,
                    help="frame size cap; must match the parent transport")
    ap.add_argument("--device", default="cuda",
                    help="where the pool runs: a CUDA device (the "
                         "default; raises without one) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    host, port = args.connect.rsplit(":", 1)
    addr = (host, int(port))
    conn = socket.create_connection(addr, timeout=30.0)
    # the 30 s bound applies to the CONNECT only: a persistent socket
    # timeout would make read_frame raise on any >30 s idle stretch and
    # the worker would exit under a perfectly healthy, quiet pool
    conn.settimeout(None)
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    rc = _worker_loop(conn, connect_addr=addr,
                      max_frame_bytes=args.max_frame, device=device)
    # leave at once: extra lanes' threads may still be blocked in a
    # read, and tearing the interpreter (and torch's thread pools) down
    # under them aborts the process
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class WorkerLauncher:
    """How a pool worker process starts. ``argv(connect, max_frame,
    device)`` builds the command line; the handshake on the other side is
    always the same: dial back to ``connect``, send hello, speak
    PoolService."""

    def argv(self, connect: str, max_frame_bytes: int,
             device: Optional[str] = None) -> list:
        raise NotImplementedError

    def popen_kwargs(self) -> dict:
        return {}

    def launch(self, connect: str, max_frame_bytes: int,
               device: Optional[str] = None) -> subprocess.Popen:
        return subprocess.Popen(self.argv(connect, max_frame_bytes, device),
                                **self.popen_kwargs())


def _worker_args(connect: str, max_frame_bytes: int,
                 device: Optional[str]) -> list:
    return ["--connect", connect, "--max-frame", str(max_frame_bytes),
            *(["--device", str(device)] if device is not None else [])]


class SubprocessLauncher(WorkerLauncher):
    """Worker on THIS machine (the default): same interpreter, source
    tree injected on PYTHONPATH."""

    def argv(self, connect: str, max_frame_bytes: int,
             device: Optional[str] = None) -> list:
        # -c instead of -m: runpy would re-execute this module on top of
        # the copy the package __init__ already imported in the worker
        return [sys.executable, "-c",
                "import sys; from repro_torch.serving.remote import main; "
                "sys.exit(main(sys.argv[1:]))",
                *_worker_args(connect, max_frame_bytes, device)]

    def popen_kwargs(self) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        return {"env": env}


class SSHLauncher(WorkerLauncher):
    """Worker on ANOTHER host: ``ssh <host> env PYTHONPATH=<remote src>
    <python> -m repro_torch.serving.remote --connect
    <advertise_host:port> --device ...``.

    The handshake is identical to the local launcher — the parent only
    ever sees a dial-back connection, so the executor cannot tell (and
    must not care) which machine a pool runs on. ``ssh`` is an argv
    prefix, injectable so tests can substitute a local shim (and so real
    deployments can add ``-o`` options or use a wrapper).
    """

    def __init__(self, host: str, *, python: str = "python3",
                 pythonpath: Optional[str] = SRC_ROOT,
                 ssh: tuple = ("ssh",)):
        self.host = host
        self.python = python
        self.pythonpath = pythonpath
        self.ssh = tuple(ssh)

    def argv(self, connect: str, max_frame_bytes: int,
             device: Optional[str] = None) -> list:
        envs = [f"PYTHONPATH={self.pythonpath}"] if self.pythonpath else []
        remote = (["env", *envs] if envs else []) + [
            self.python, "-m", "repro_torch.serving.remote",
            *_worker_args(connect, max_frame_bytes, device)]
        return [*self.ssh, self.host, *remote]


class WorkerChannel(Channel):
    """One lane to a worker that survives worker death.

    The lane lazily (re-)binds to the worker's current generation: after
    a respawn, the next request transparently rides the new process. A
    connection error mid-request triggers :meth:`WorkerProc.recover`
    (respawn with backoff / lane re-open) and then raises
    :class:`WorkerDiedError` — the request was NOT delivered and any
    state queued in the dead worker is gone, which the caller must
    handle; hiding that with a silent retry would strand every
    previously-queued request."""

    def __init__(self, worker: "WorkerProc", *, main: bool):
        super().__init__(f"worker/{worker.key}" + ("" if main else "#lane"))
        self._worker = worker
        self.main = main
        self._inner: Optional[SocketChannel] = None
        self.gen = -1

    def _invalidate(self) -> None:
        self._inner = None

    def attach(self, telemetry) -> None:
        """Frame spans go to ``telemetry`` from the socket lane this
        channel rides, now and after every re-bind."""
        super().attach(telemetry)
        if self._inner is not None:
            self._inner.attach(telemetry)

    def _ensure(self) -> SocketChannel:
        w = self._worker
        with w._lock:
            if w._closed:
                raise WorkerDiedError(f"pool {w.key} worker is shut down")
            if self._inner is None or self.gen != w.gen:
                inner = w._main_raw if self.main else w._connect_lane_locked()
                inner.stats = self.stats      # ONE log across respawns
                inner.attach(self.telemetry)
                self._inner = inner
                self.gen = w.gen
            return self._inner

    def request(self, msg: dict) -> dict:
        try:
            inner = self._ensure()
            reply = inner.request(msg)
        except WorkerDiedError:
            raise
        except (TruncatedFrameError, ConnectionError, OSError) as e:
            self._worker.recover(self)
            raise WorkerDiedError(
                f"pool {self._worker.key}: worker connection lost "
                f"({type(e).__name__}: {e}); worker recovered but this "
                f"request was not delivered") from e
        if reply.get("ok"):
            # only APPLIED retargets/binds update the respawn state — a
            # worker-side failure must not make a later respawn re-init
            # with a spec the live pool never adopted
            self._worker.note_op(msg)
        return reply

    def close(self) -> None:
        self._worker._forget(self)
        inner, self._inner = self._inner, None
        if inner is not None and not self.main:
            inner.close()


class WorkerProc:
    """One spawned pool worker: listener, process, and its lanes.

    The parent's listener stays open for the worker's whole life — it is
    the rendezvous for the initial dial-back, every extra per-front-end
    lane, and every respawned process. ``advertise_host`` is the address
    workers are told to dial (bind is derived: loopback advertisements
    bind loopback, anything else binds all interfaces so remote workers
    can actually reach us). ``device`` is what the worker runs its pool
    on (``--device``). ``spawn_s`` is the last launch's time to dial
    back, ``init_s`` its parameter load and pool build.
    """

    def __init__(self, key: tuple, max_frame_bytes: int = DEFAULT_MAX_FRAME,
                 *, advertise_host: str = "127.0.0.1",
                 bind_host: Optional[str] = None,
                 launcher: Optional[WorkerLauncher] = None,
                 device: Optional[str] = None,
                 max_respawns: int = 3, respawn_backoff_s: float = 0.05,
                 on_respawn: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.key = key
        self._max = max_frame_bytes
        self.advertise_host = advertise_host
        if bind_host is None:
            bind_host = bind_host_for(advertise_host)
        self.launcher = launcher if launcher is not None \
            else SubprocessLauncher()
        self.device = device
        self.max_respawns = max_respawns
        self.respawn_backoff_s = respawn_backoff_s
        self.on_respawn = on_respawn
        self._sleep = sleep
        self._lock = threading.RLock()
        self.gen = 0
        self.respawns = 0
        self.spawn_s = 0.0
        self.init_s = 0.0
        self.init_bytes = 0
        self._last_respawn_t = time.monotonic()
        self._closed = False
        self._init_args: Optional[dict] = None
        self._extras: list = []
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((bind_host, 0))
        self._lsock.listen(16)
        self._lsock.settimeout(WORKER_SPAWN_TIMEOUT_S)
        self._port = self._lsock.getsockname()[1]
        try:
            self._spawn_locked()
        except Exception:
            self._lsock.close()
            raise
        self.channel = WorkerChannel(self, main=True)

    @property
    def connect_str(self) -> str:
        """What workers are told to dial: the ADVERTISED address."""
        return f"{self.advertise_host}:{self._port}"

    # ----------------------------------------------------- spawn / accept
    def _accept_locked(self, *, extra: bool) -> socket.socket:
        """Accept the NEXT matching dial-back, draining mismatches.

        The listener backlog can hold stale connections from a dead
        generation (a worker that dialed an extra lane and died before
        its ok-reply); accepting one of those as the fresh worker's
        main connection would kill a healthy respawn. So: accept,
        validate the hello (direction flag, and pid for extra lanes),
        and DISCARD anything stale until the matching peer shows up or
        the spawn window closes."""
        deadline = time.monotonic() + WORKER_SPAWN_TIMEOUT_S
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                conn = None
            else:
                self._lsock.settimeout(remaining)
                try:
                    conn, _ = self._lsock.accept()
                except (socket.timeout, OSError):
                    conn = None
            if conn is None:
                self.proc.kill()
                rc = self.proc.wait(timeout=10)
                raise RuntimeError(
                    f"worker for pool {self.key} never dialed back to "
                    f"{self.connect_str} within "
                    f"{WORKER_SPAWN_TIMEOUT_S:.0f}s (exit status {rc}); "
                    f"see the worker's stderr above for the crash") \
                    from None
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(10.0)        # hello must arrive promptly —
            try:                         # a silent half-open conn must
                hello = read_frame(conn, max_frame_bytes=self._max)
            except Exception:            # not wedge the accept loop
                conn.close()
                continue
            if (not hello.get("hello")
                    or bool(hello.get("extra")) != extra
                    or (extra and hello.get("pid") != self.pid)):
                conn.close()             # stale generation's lane: drain
                continue
            conn.settimeout(None)        # validated: reads idle forever
            if not extra:
                self.pid = int(hello["pid"])
            return conn

    def _spawn_locked(self) -> None:
        t0 = time.perf_counter()
        self.proc = self.launcher.launch(self.connect_str, self._max,
                                         self.device)
        try:
            conn = self._accept_locked(extra=False)
        except Exception:
            try:                             # never leak the subprocess
                self.proc.kill()
                self.proc.wait(timeout=10)
            except Exception:
                pass
            raise
        self._main_raw = SocketChannel(f"worker/{self.key}", None,
                                       self._max, sock=conn)
        self.spawn_s = time.perf_counter() - t0

    def _connect_lane_locked(self) -> SocketChannel:
        reply = self._main_raw.request({"op": "open_channel"})
        if not reply.get("ok"):
            # a refusal (worker up, dial-back blocked) honors the SAME
            # typed contract as a death — callers are documented against
            # WorkerDiedError, not a raw RuntimeError
            raise WorkerDiedError(
                f"open_channel on {self.key} refused: "
                f"{reply.get('error')}")
        conn = self._accept_locked(extra=True)
        return SocketChannel(f"worker/{self.key}#lane", None, self._max,
                             sock=conn)

    # ------------------------------------------------------------- lanes
    def open_channel(self) -> WorkerChannel:
        """A NEW dial-back lane to this worker (connected lazily on first
        use, re-connected after respawns). Fleet front-ends each take one
        so their uplink transfers overlap on separate TCP streams."""
        ch = WorkerChannel(self, main=False)
        with self._lock:
            self._extras.append(ch)
        return ch

    def _forget(self, ch: WorkerChannel) -> None:
        with self._lock:
            try:
                self._extras.remove(ch)
            except ValueError:
                pass

    # ------------------------------------------------------------- init
    def init(self, cfg_bytes: bytes, pieces: list, spec: PoolSpec,
             chips=None, packed: bool = True, telemetry: bool = False,
             **pool_kw) -> None:
        """Send the pool's parameter slice (``pieces``, from
        :func:`param_pieces`) and build its pool. ``pool_kw`` carries
        ``decode_ctx``, ``kv_blocks``, ``kv_block_tokens`` and
        ``layer_offset``. Kept for respawns, which re-send the same
        slice."""
        with self._lock:
            self._init_args = {"cfg": cfg_bytes, "pieces": pieces,
                               "spec": spec, "packed": bool(packed),
                               "chips": [int(c) for c in (chips or [])],
                               "telemetry": bool(telemetry), **pool_kw}
            self._init_locked()

    def _init_locked(self) -> None:
        a = self._init_args
        spec = a["spec"]
        t0 = time.perf_counter()
        nbytes = 0
        # pipelined: every load frame goes out before the first reply is
        # read, so encoding the next frame here overlaps the worker
        # taking the last one to its device (the replies are a few bytes
        # each: the worker never blocks on writing them)
        ch = self._main_raw
        with ch._lock:
            for frame in a["pieces"]:
                write_frame(ch._sock, {"op": "load", "pieces": frame},
                            max_frame_bytes=self._max)
                nbytes += sum(p["tensor"].numel() * p["tensor"].element_size()
                              for p in frame)
            replies = [read_frame(ch._sock, max_frame_bytes=self._max)
                       for _ in a["pieces"]]
        for reply in replies:
            if not reply.get("ok"):
                raise RuntimeError(f"worker load for {spec.key} failed: "
                                   f"{reply.get('error')}")
        extra = {k: a[k] for k in ("decode_ctx", "kv_blocks",
                                   "kv_block_tokens", "layer_offset")
                 if k in a}
        reply = self._main_raw.request({
            "op": "init", "cfg": a["cfg"],
            "key": list(spec.key), "share": spec.share, "batch": spec.batch,
            "n_instances": spec.n_instances, "role": spec.role,
            "chips": a["chips"], "packed": a.get("packed", True),
            "telemetry": a.get("telemetry", False), **extra})
        if not reply.get("ok"):
            raise RuntimeError(f"worker init for {spec.key} failed: "
                               f"{reply.get('error')}")
        self.init_s = time.perf_counter() - t0
        self.init_bytes = nbytes

    def note_op(self, msg: dict) -> None:
        """Track retarget/bind so a respawn re-creates the CURRENT pool
        shape and placement, not the birth-time one."""
        op = msg.get("op")
        if self._init_args is None or op not in ("retarget", "bind"):
            return
        with self._lock:
            if op == "retarget":
                self._init_args["spec"] = PoolSpec(
                    key=tuple(msg["key"]), share=msg["share"],
                    batch=msg["batch"], n_instances=msg["n_instances"],
                    role=msg.get("role", "both"))
            else:
                self._init_args["chips"] = [int(c) for c in msg["chips"]]

    # ---------------------------------------------------------- recovery
    def recover(self, ch: WorkerChannel) -> None:
        """Reconnect-with-backoff after ``ch`` hit a connection error.

        Liveness is verified HERE, not inferred from the failing lane's
        generation: the current process must exist AND answer a ping on
        the main connection, else it is respawned. That check is what
        serializes concurrent lane failures into ONE respawn (the first
        lane in respawns; later ones find the fresh worker answering)
        and what still respawns when the observer is a never-bound lane
        (gen -1) whose connect attempt found the main connection dead —
        a generation comparison alone would discard that observation and
        leave the pool dead. A lane-only drop on a live worker just
        invalidates the lane so its next use re-dials."""
        with self._lock:
            if self._closed:
                ch._invalidate()
                return
            alive = self.proc.poll() is None and self._reachable_locked()
            if not alive:
                self._respawn_locked()
            ch._invalidate()

    def _reachable_locked(self, timeout_s: float = PING_TIMEOUT_S) -> bool:
        """Bounded liveness probe on the main connection. Bounded twice:
        the channel lock acquire (a request wedged against a hung worker
        must read as unreachable, not block recovery forever) and the
        socket read (a worker that accepted the ping but never answers
        is equally dead for our purposes)."""
        ch = self._main_raw
        if not ch._lock.acquire(timeout=timeout_s):
            return False                 # main lane wedged mid-request
        try:
            sock = ch._sock
            old = sock.gettimeout()
            try:
                sock.settimeout(timeout_s)
                write_frame(sock, {"op": "ping"},
                            max_frame_bytes=self._max)
                return bool(read_frame(
                    sock, max_frame_bytes=self._max).get("ok"))
            finally:
                try:
                    sock.settimeout(old)
                except OSError:
                    pass
        except Exception:
            return False
        finally:
            ch._lock.release()

    def _respawn_locked(self) -> None:
        now = time.monotonic()
        if now - self._last_respawn_t > RESPAWN_HEAL_WINDOW_S:
            # the budget bounds CRASH LOOPS, not lifetime faults: a pool
            # that ran healthy for the heal window earns its slots back,
            # so a long-lived deployment survives occasional deaths
            self.respawns = 0
        if self.respawns >= self.max_respawns:
            raise WorkerDiedError(
                f"worker for pool {self.key} died and exceeded "
                f"max_respawns={self.max_respawns} within "
                f"{RESPAWN_HEAL_WINDOW_S:.0f}s")
        self.respawns += 1
        self._last_respawn_t = now
        try:
            self.proc.kill()
            self.proc.wait(timeout=10)
        except Exception:
            pass
        try:
            self._main_raw.close()
        except Exception:
            pass
        delay = min(self.respawn_backoff_s * (2 ** (self.respawns - 1)),
                    1.0)
        if delay > 0:
            self._sleep(delay)
        self.gen += 1
        self._spawn_locked()
        if self._init_args is not None:
            self._init_locked()
        if self.on_respawn is not None:
            try:
                self.on_respawn(self.key, self.gen)
            except Exception:
                pass

    # ---------------------------------------------------------- teardown
    def shutdown(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._main_raw.request({"op": "shutdown"})
            except Exception:
                pass
            for ch in self._extras:
                inner, ch._inner = ch._inner, None
                if inner is not None:
                    inner.close()
            self._extras.clear()
            self._main_raw.close()
            try:
                self._lsock.close()
            except OSError:
                pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=timeout)


class RemoteExecutor(GraftExecutor):
    """GraftExecutor whose stage pools live in worker processes.

    Only pool creation/retirement differ from the in-process executor —
    serve()/apply_plan()/stats logic is inherited verbatim, so the same
    code path is proven against real process boundaries.

    ``transport`` may be a :class:`SocketTransport` (default) or a
    :class:`ShapedTransport` wrapping one — shaped links apply the
    per-client bandwidth/latency model to every submit hop.

    ``device`` (None = the card) is where the parent's params lie and
    where every worker runs its pool (``--device``). On a card the parent
    builds the kernels before it spawns a worker, so cold workers never
    run ``nvcc`` at once. Each worker receives only the parameters its
    pool's block range reads. ``decode_ctx``, ``kv_blocks``,
    ``kv_block_tokens`` and ``decode_disagg`` are the in-process
    executor's, applied in the workers.

    Multi-host knobs:

    * ``advertise_host`` — the address workers dial back to. Loopback by
      default; set the parent's routable hostname/IP when launchers put
      workers on other machines.
    * ``launcher`` — a :class:`WorkerLauncher`, or a callable
      ``pool_key -> WorkerLauncher`` for heterogeneous placements (some
      pools local, some over ssh).
    * ``per_frontend_channels`` — ``open_handle`` returns a dedicated
      dial-back lane per caller (fleet front-ends overlap their uplink
      transfers) instead of the shared deploy connection. On by default.
    * ``max_respawns`` / ``respawn_backoff_s`` — reconnect-with-backoff
      budget per worker; ``respawn_log`` records ``(key, gen)`` per
      recovery.
    * ``beacon_interval_s`` — health beacons: a per-worker poller thread
      issues a periodic ``stats`` request on a dedicated lane (liveness
      ping + telemetry-snapshot piggyback) and a watchdog publishes
      ``beacon/<pool>/age_s`` / ``wedged`` gauges; a beacon stale for
      ``beacon_stale_s`` (default 3x the interval) triggers the same
      ping-verified recovery path a failed request does — catching the
      wedged-but-connected worker no request ever trips over.

    ``spawn_log`` records ``(key, spawn_s, init_s, init_bytes)`` per
    worker started (the dial-back, then the parameter load and pool
    build); ``log`` (a print-like callable) also reports each one.
    """

    def __init__(self, plan, params, cfg,
                 transport: Optional[Transport] = None, *,
                 advertise_host: str = "127.0.0.1",
                 launcher: Union[WorkerLauncher, Callable, None] = None,
                 per_frontend_channels: bool = True,
                 max_respawns: int = 3, respawn_backoff_s: float = 0.05,
                 packed: bool = True, telemetry=None,
                 beacon_interval_s: float = 0.0,
                 beacon_stale_s: Optional[float] = None,
                 decode_ctx: int = 0, kv_blocks: int = 64,
                 kv_block_tokens: int = 16, decode_disagg: bool = False,
                 device=None, log=None):
        self._workers: dict[tuple, WorkerProc] = {}
        # workers started by prepare_plan, not yet deployed: key -> handle
        self._ready: dict[tuple, PoolHandle] = {}
        self._cfg_bytes = pickle.dumps(cfg)
        self.spawn_log: list = []
        self.respawn_log: list = []             # (key, gen) per recovery
        self._say = log
        self.advertise_host = advertise_host
        self._launcher = launcher
        self.per_frontend_channels = per_frontend_channels
        self._max_respawns = max_respawns
        self._respawn_backoff_s = respawn_backoff_s
        # launches of workers a replan retired, so counts survive them
        self._retired_launches: dict = {}
        self._launch_lock = threading.Lock()
        dev = resolve_device(device)
        self._worker_device = str(dev)
        if dev.type == "cuda":
            # one build, here, before any worker starts: cold workers
            # would otherwise all run nvcc at once
            from repro_torch.kernels import build
            build.build_all()
        # health beacons: per-worker poller threads ride a dedicated
        # dial-back lane; a watchdog turns beacon staleness into a
        # wedged flag + recovery (see _beacon_watchdog)
        self.beacon_interval_s = float(beacon_interval_s)
        self.beacon_stale_s = float(beacon_stale_s) \
            if beacon_stale_s is not None else 3.0 * self.beacon_interval_s
        self.beacon_log: list = []              # (key, kind) staleness events
        self._beacon_seen: dict = {}            # key -> monotonic last-ok
        self._beacon_pollers: dict = {}         # key -> Thread
        self._beacon_recovering: set = set()
        self._beacon_lock = threading.Lock()
        self._beacon_stop = threading.Event()
        tp = transport if transport is not None else SocketTransport()
        base = tp.inner if isinstance(tp, ShapedTransport) else tp
        if not isinstance(base, SocketTransport):
            raise TypeError(
                "RemoteExecutor needs a SocketTransport (optionally "
                f"wrapped in ShapedTransport), got {type(base).__name__}")
        self._shaper = tp if isinstance(tp, ShapedTransport) else None
        self._max_frame = base.max_frame_bytes
        self._chunk_bytes = min(PARAM_CHUNK_BYTES, self._max_frame // 2)
        super().__init__(plan, params, cfg, transport=tp, packed=packed,
                         decode_ctx=decode_ctx, kv_blocks=kv_blocks,
                         kv_block_tokens=kv_block_tokens,
                         decode_disagg=decode_disagg, telemetry=telemetry,
                         device=dev)
        if self.beacon_interval_s > 0:
            t = threading.Thread(target=self._beacon_watchdog,
                                 daemon=True, name="worker-beacons")
            t.start()
            self._beacon_watchdog_thread = t

    def _launcher_for(self, key: tuple) -> Optional[WorkerLauncher]:
        if self._launcher is None or isinstance(self._launcher,
                                                WorkerLauncher):
            return self._launcher
        return self._launcher(key)              # callable: per-pool hosts

    def _spawn_pool(self, spec: PoolSpec) -> PoolHandle:
        w = WorkerProc(spec.key, self._max_frame,
                       advertise_host=self.advertise_host,
                       launcher=self._launcher_for(spec.key),
                       device=self._worker_device,
                       max_respawns=self._max_respawns,
                       respawn_backoff_s=self._respawn_backoff_s,
                       on_respawn=self._note_respawn)
        try:
            # a pool added by a migration-aware replan knows its chips at
            # birth (placement is transitioned before _deploy spawns);
            # the initial deploy binds right after packing instead
            pieces = param_pieces(
                slice_params(self.params, self.cfg, spec.start, spec.end),
                self._chunk_bytes)
            w.init(self._cfg_bytes, pieces, spec,
                   chips=self.chips_of(spec.key), packed=self.packed,
                   telemetry=self.telemetry.enabled,
                   decode_ctx=self.decode_ctx, kv_blocks=self.kv_blocks,
                   kv_block_tokens=self.kv_block_tokens,
                   layer_offset=spec.start)
        except Exception:
            w.shutdown()                 # the spawned proc must not leak
            raise
        self._workers[spec.key] = w
        self.spawn_log.append((spec.key, w.spawn_s, w.init_s, w.init_bytes))
        if self._say is not None:
            self._say(f"[remote] pool {spec.key[1:]}: worker pid {w.pid} on "
                      f"{self._worker_device}, spawn {w.spawn_s:.2f} s, init "
                      f"{w.init_s:.2f} s ({w.init_bytes / 2**20:.0f} MiB of "
                      "parameters)")
        channel = w.channel
        if self._shaper is not None:
            channel = _ShapedChannel(channel, self._shaper)
        h = PoolHandle(spec.key, channel, telemetry=self.telemetry)
        h.pid = w.pid
        return h

    def _note_respawn(self, key: tuple, gen: int) -> None:
        self.respawn_log.append((key, gen))

    def _spawn_pools(self, specs: list) -> dict:
        """Spawn added workers CONCURRENTLY: each pays its own process
        start, torch import, CUDA context and weights, so a replan that
        adds k pools stalls for the slowest spawn instead of the sum.
        Workers :meth:`prepare_plan` already started are taken as they
        are (retargeted to the spec). Each thread touches only its own
        WorkerProc/listener; the shared dicts are appended under the
        GIL. All-or-nothing like the base class: if any spawn fails,
        workers that did come up are shut down instead of leaking as
        orphan processes."""
        handles = {s.key: self._ready.pop(s.key) for s in specs
                   if s.key in self._ready}
        for s in specs:
            if s.key in handles:
                handles[s.key].retarget(s)
        specs = [s for s in specs if s.key not in handles]
        first_err = None
        if len(specs) == 1:
            try:
                handles[specs[0].key] = self._spawn_pool(specs[0])
            except Exception as e:
                first_err = e
        elif specs:
            from concurrent.futures import ThreadPoolExecutor, as_completed
            with ThreadPoolExecutor(max_workers=min(len(specs), 8)) as pool:
                futs = [pool.submit(self._spawn_pool, s) for s in specs]
                for f in as_completed(futs):
                    try:
                        h = f.result()
                        handles[h.key] = h
                    except Exception as e:
                        first_err = first_err or e
        if first_err is not None:
            for h in handles.values():
                try:
                    self._retire_pool(h)
                except Exception:
                    pass
            raise first_err
        return handles

    def prepare_plan(self, new_plan) -> int:
        """Start the worker of every pool ``new_plan`` adds, in parallel,
        while the live deployment serves on: a server calls this outside
        its writer lock, so a replan's pause is the retire and retarget
        of ``apply_plan``, not a process spawn with its weights. Workers
        started for an earlier plan that this one drops are shut down.
        Returns the number of workers started."""
        from repro_torch.core.plandiff import plan_pools
        new_pools = plan_pools(new_plan)
        for key in [k for k in self._ready if k not in new_pools]:
            self._retire_pool(self._ready.pop(key))
        want = [sp for k, sp in new_pools.items()
                if k not in self._handles and k not in self._ready]
        if want:
            self._ready.update(self._spawn_pools(want))
        return len(want)

    def open_handle(self, key: tuple) -> PoolHandle:
        """A dedicated dial-back lane to pool ``key``'s worker, so fleet
        front-ends' shaped uplink transfers overlap on separate TCP
        streams (the worker serializes actual execution on its pool
        lock). With ``per_frontend_channels=False`` every caller shares
        the one deploy connection."""
        if not self.per_frontend_channels:
            return self._handles[key]
        w = self._workers[key]
        channel: Channel = w.open_channel()
        if self._shaper is not None:
            channel = _ShapedChannel(channel, self._shaper)
        h = PoolHandle(key, channel, telemetry=self.telemetry)
        h.pid = w.pid
        return h

    def worker(self, key: tuple) -> WorkerProc:
        """The live WorkerProc for pool ``key`` (fault tests kill it)."""
        return self._workers[key]

    def kernel_launches(self, *, reset: bool = False) -> dict:
        """Kernel launches made inside the workers, by kernel name: the
        live workers' counts plus those of workers a replan retired
        (``reset`` zeroes both after reading)."""
        with self._launch_lock:
            out = dict(self._retired_launches)
            if reset:
                self._retired_launches = {}
        for key, h in list(self._handles.items()):
            for name, n in h.launches(reset=reset).items():
                out[name] = out.get(name, 0) + int(n)
        return out

    # ------------------------------------------------------ health beacons
    def _beacon_poll(self, key: tuple) -> None:
        """One worker's beacon: periodic stats request on a DEDICATED
        dial-back lane (never contends with the deploy channel), whose
        reply piggybacks the worker's telemetry snapshot. Each success
        stamps ``_beacon_seen``; the watchdog turns a stale stamp into
        wedged/recovery. The lane transparently rebinds after respawns,
        so a recovered worker resumes beaconing on its own."""
        lane = None
        while not self._beacon_stop.is_set():
            w = self._workers.get(key)
            if w is None or w._closed:
                break                           # pool retired by a replan
            try:
                if lane is None:
                    lane = w.open_channel()
                reply = lane.request({"op": "stats"})
                if reply.get("ok"):
                    self._beacon_seen[key] = time.monotonic()
                    snap = reply.get("telemetry")
                    if snap and self.telemetry.enabled:
                        label = pool_endpoint(key)[len("pool/"):]
                        self.telemetry.merge_snapshot(
                            snap, source=label, prefix=f"pool/{label}/")
            except WorkerDiedError:
                pass        # recover() already ran; next loop rebinds
            except Exception:
                pass
            self._beacon_stop.wait(self.beacon_interval_s)
        if lane is not None:
            try:
                lane.close()
            except Exception:
                pass

    def _beacon_recover(self, key: tuple) -> None:
        w = self._workers.get(key)
        if w is not None:
            try:
                # ping-verified: a merely-slow worker answers and only
                # the lane is invalidated; a dead/wedged one respawns
                w.recover(w.channel)
            except Exception:
                traceback.print_exc()
        with self._beacon_lock:
            self._beacon_recovering.discard(key)

    def _beacon_watchdog(self) -> None:
        """Separate from the pollers on purpose: a poller blocked inside
        a wedged worker's stats request cannot also be the thing that
        notices the wedge. Each tick re-syncs pollers with the live
        worker set (replans add/retire pools), publishes beacon-age /
        wedged gauges, and kicks recovery when a beacon goes stale."""
        tel = self.telemetry
        while not self._beacon_stop.wait(self.beacon_interval_s):
            now = time.monotonic()
            for key in list(self._workers):
                t = self._beacon_pollers.get(key)
                if t is None or not t.is_alive():
                    self._beacon_seen.setdefault(key, now)
                    t = threading.Thread(target=self._beacon_poll,
                                         args=(key,), daemon=True,
                                         name=f"beacon-{key}")
                    t.start()
                    self._beacon_pollers[key] = t
                label = pool_endpoint(key)
                age = now - self._beacon_seen.get(key, now)
                wedged = age > self.beacon_stale_s
                tel.gauge(f"beacon/{label}/age_s").set(age)
                tel.gauge(f"beacon/{label}/wedged").set(1.0 if wedged
                                                        else 0.0)
                if wedged:
                    with self._beacon_lock:
                        kick = key not in self._beacon_recovering
                        if kick:
                            self._beacon_recovering.add(key)
                    if kick:
                        self.beacon_log.append((key, "stale"))
                        tel.counter("beacon/stale_events").inc()
                        threading.Thread(target=self._beacon_recover,
                                         args=(key,), daemon=True).start()
            for key in list(self._beacon_pollers):
                if key not in self._workers:
                    self._beacon_pollers.pop(key, None)
                    self._beacon_seen.pop(key, None)

    def _retire_pool(self, handle: PoolHandle) -> None:
        w = self._workers.pop(handle.key, None)
        if w is None:
            handle.close()
            return
        try:                     # its launches outlive it in the counts
            got = w.channel.request({"op": "launches"}).get("launches", {})
        except Exception:
            got = {}
        with self._launch_lock:
            for name, n in got.items():
                self._retired_launches[name] = \
                    self._retired_launches.get(name, 0) + int(n)
        w.shutdown()

    def close(self) -> None:
        self._beacon_stop.set()
        for key in list(self._ready):
            self._retire_pool(self._ready.pop(key))
        super().close()
        for key in list(self._workers):         # safety net
            self._workers.pop(key).shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
