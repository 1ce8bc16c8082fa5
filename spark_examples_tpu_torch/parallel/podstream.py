"""Host-side pod window exchange and the depth-D slot pipeline.

The port of the JAX package's ``parallel/podstream.py``. A pod's sparse
accumulation agrees, per protocol step, a small header (liveness, route,
carrier width), a payload confirm and, on scatter steps, the carrier
matrices of every process. That agreement rides a **persistent host TCP
mesh between the pod's processes**: pure socket IO, no ``torch`` and no
``torch.distributed`` call, so a sync thread can run step ``w+1``'s whole
exchange while step ``w``'s kernels run on the card. Three pieces:

- :class:`_PodSocketMesh` — the per-process singleton full mesh of peer
  sockets. Peer addresses are published ONCE, from the main thread, before
  any pipelined work, through the process group
  (:func:`~spark_examples_tpu_torch.parallel.distributed.allgather_objects`);
  after that every protocol byte flows over the sockets. The rule this
  keeps: only the consumer (main) thread calls ``torch.distributed``, in
  the same order on every rank — a second thread issuing collectives would
  reorder them against the main thread's, and NCCL deadlocks on that.
  Sends run on small per-peer sender threads, so a slow peer can never
  cause a mutual send-block deadlock; receives run on the sync thread in
  deterministic per-peer frame order (TCP keeps each peer's post order,
  and the protocol makes every receive's (stream, step, kind) predictable).
- :class:`PodWindowExchange` — one stream's framed post/gather API over
  the mesh (headers, confirms, collective-check digests, payloads).
  Streams open in the same program order on every process, so a
  module-level counter names them consistently; frames carry (stream,
  step, kind) and a mismatch is a loud protocol error.
- :class:`SlotPipeline` — the depth-D bounded pipeline: a daemon thread
  calls a ``produce`` callback (one protocol step a call) and stages its
  results in a bounded queue; the consumer iterates the staged slots. A
  producer exception is re-raised in the consumer AT ITS SLOT POSITION:
  every process sees the same agreed step order, so the raise lands on the
  same step everywhere.

Every failure the protocol raises (a producer's −2 header, a payload
confirm of −2, a route or dtype divergence) is detected from identical
gathered data after the same phase on every process, so all peers stop at
the same frame boundary and no socket holds half-read frames.

Peer DEATH (kill -9, OOM, host loss) is the one failure that cannot be
agreed from gathered data. EOF or ECONNRESET on an established socket
raises :class:`PodPeerDeadError`; the gather paths synthesize the dead
peer's −2 header or confirm (the producer-failure encoding every process
already raises on together); and the mesh tears its sockets down — after
sending what it had queued, so no survivor loses a frame it is owed — so
every survivor detects the death within one receive and all raise at the
same slot. The mesh is poisoned afterwards: a pod minus a member fails and
is relaunched, never continued.
"""

from __future__ import annotations

import itertools
import os
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "POD_EXCHANGE_TIMEOUT_S",
    "PodPeerDeadError",
    "PodSlot",
    "PodWindowExchange",
    "SlotPipeline",
]

# Blocking-receive deadline for one protocol phase: generous (a peer may
# be deep in host ingest for its next window), but finite — a dead peer
# becomes a loud RuntimeError instead of a collective's silent hang.
# --collective-timeout's watchdog stays the tighter fail-stop.
POD_EXCHANGE_TIMEOUT_S = 1800.0

# How long a peer-death teardown waits for this process's queued frames
# to leave before it closes the sockets.
_DRAIN_S = 5.0

_STREAM_IDS = itertools.count()

# Frame kinds on the wire. _KIND_CHECK carries the optional collective
# congruence digest (utils/collectivecheck.py): it is posted only when
# EVERY live process advertised the check in its step header.
_KIND_HEADER = 0
_KIND_CONFIRM = 1
_KIND_PAYLOAD = 2
_KIND_CHECK = 3

# stream (q), step (q), kind (B), byte length (q) — little-endian.
_FRAME = struct.Struct("<qqBq")


class PodPeerDeadError(RuntimeError):
    """An established peer socket died mid-protocol (EOF/ECONNRESET —
    the peer process was killed, ran out of memory, or its host
    vanished). The gather paths convert it into the synchronized −2
    failure shape; ``peer`` is the dead rank when known."""

    def __init__(self, message: str, peer: Optional[int] = None) -> None:
        super().__init__(message)
        self.peer = peer


def _local_ip() -> str:
    """The IP this host uses to reach the group's master
    (``MASTER_ADDR``), by the UDP-connect trick (no packet is sent;
    IPv6 addresses probe over AF_INET6); else the hostname's address,
    else loopback."""
    host = os.environ.get("MASTER_ADDR", "")
    if host:
        family = socket.AF_INET
        if host.startswith("[") and host.endswith("]"):
            host, family = host[1:-1], socket.AF_INET6
        elif ":" in host:
            family = socket.AF_INET6
        try:
            s = socket.socket(family, socket.SOCK_DGRAM)
            try:
                s.connect((host, 1))
                return s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class _PeerSender:
    """One peer's outbound frame queue and daemon sender thread.

    Sends never run on the sync thread: with every process pushing
    payload frames to every peer before reading any, two full TCP buffers
    would deadlock the pod. The queue's depth is bounded by the pipeline
    depth (a handful of frames)."""

    def __init__(self, sock: socket.socket, peer: int) -> None:
        self._sock = sock
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name=f"pod-exchange-send-{peer}", daemon=True
        )
        self._thread.start()

    def send(self, frame: bytes) -> None:
        self._q.put(frame)

    def drain(self, timeout_s: float) -> None:
        """Wait until every queued frame has left (or failed to)."""
        deadline = time.monotonic() + timeout_s
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.002)

    def _run(self) -> None:
        dead = False
        while True:
            frame = self._q.get()
            try:
                if frame is None:
                    return
                if not dead:
                    self._sock.sendall(frame)
            except OSError:
                # The peer is gone (it raised and tore down, or died): the
                # receive side raises the loud error; later frames are
                # dropped, counted done.
                dead = True
            finally:
                self._q.task_done()


class _PodSocketMesh:
    """Per-process full mesh of peer connections (module singleton).

    Setup: every process binds an ephemeral listening socket, publishes
    its address through the process group (one all-gather, on the main
    thread), then connects to every LOWER rank and accepts one connection
    from every HIGHER rank (identified by a hello of its rank) — one
    socket per unordered pair, used both ways for the life of the process.
    """

    _instance: Optional["_PodSocketMesh"] = None
    _instance_lock = threading.Lock()

    def __init__(self, pid: int, world: int, timeout_s: float) -> None:
        self._pid = pid
        self._world = world
        self._timeout_s = timeout_s
        self._socks: Dict[int, socket.socket] = {}
        self._senders: Dict[int, _PeerSender] = {}
        self.poisoned = False
        self.poison_reason = ""
        self._connect(timeout_s)

    def poison(self) -> None:
        """Mark the mesh unusable: an ABANDONED stream (the consumer died
        one-sided) may have left its sync thread blocked mid-read and
        unread frames on the pipes, so a later stream would desync on
        them. Synchronized protocol failures do not poison: every peer
        stopped at the same frame boundary and the pipes are clean."""
        self.poisoned = True
        self.poison_reason = (
            "an abandoned stream (one-sided consumer failure); the "
            "socket pipes may hold half-read frames"
        )

    @classmethod
    def instance(cls, timeout_s: float) -> Optional["_PodSocketMesh"]:
        from spark_examples_tpu_torch.parallel import distributed

        with cls._instance_lock:
            if cls._instance is not None:
                if cls._instance.poisoned:
                    raise RuntimeError(
                        "pod exchange mesh was poisoned by "
                        + (cls._instance.poison_reason or "an abandoned "
                           "stream")
                        + " — pod recovery is fail-stop and relaunch"
                    )
                return cls._instance
            if distributed.process_count() == 1:
                return None
            cls._instance = cls(
                distributed.process_index(),
                distributed.process_count(),
                timeout_s,
            )
            return cls._instance

    def _connect(self, timeout_s: float) -> None:
        from spark_examples_tpu_torch.parallel import distributed

        # The listener's family must match the ADVERTISED address: peers
        # dialing a v6 address against a v4-only listener are refused.
        ip = _local_ip()
        v6 = ":" in ip
        listener = socket.socket(
            socket.AF_INET6 if v6 else socket.AF_INET, socket.SOCK_STREAM
        )
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("::" if v6 else "0.0.0.0", 0))
        listener.listen(self._world)
        port = listener.getsockname()[1]
        addr = f"[{ip}]:{port}" if v6 else f"{ip}:{port}"
        # The one bootstrap collective, on the calling (main) thread.
        addrs = distributed.allgather_objects(addr)
        peers: Dict[int, Tuple[str, int]] = {}
        for p, raw in enumerate(addrs):
            if p == self._pid:
                continue
            host, pstr = raw.rsplit(":", 1)
            peers[p] = (host.strip("[]"), int(pstr))

        dial_exc: List[BaseException] = []

        def _dial() -> None:
            # The outbound side on a helper thread (pure sockets) so that
            # accept and connect cannot deadlock each other; its exception
            # is re-raised below, as ITS error.
            try:
                for p in sorted(peers):
                    if p >= self._pid:
                        continue
                    s = socket.create_connection(peers[p], timeout=timeout_s)
                    s.sendall(struct.pack("<q", self._pid))
                    self._socks[p] = s
            except BaseException as e:  # noqa: BLE001 — re-raised below
                dial_exc.append(e)

        dialer = threading.Thread(target=_dial, daemon=True)
        dialer.start()
        listener.settimeout(timeout_s)
        try:
            for _ in range(self._world - 1 - self._pid):
                conn, _ = listener.accept()
                # Accepted sockets block regardless of the listener's
                # timeout; bound the hello read.
                conn.settimeout(timeout_s)
                (peer,) = struct.unpack("<q", self._recv_exact_raw(conn, 8))
                self._socks[int(peer)] = conn
        finally:
            listener.close()
        dialer.join(timeout=timeout_s)
        if dial_exc:
            raise RuntimeError(
                "pod exchange mesh setup failed dialing a lower-rank peer "
                "(firewalled address, or the peer died before accepting?)"
            ) from dial_exc[0]
        missing = [
            p for p in range(self._world)
            if p != self._pid and p not in self._socks
        ]
        if missing:
            raise RuntimeError(
                f"pod exchange mesh setup failed: no connection to "
                f"process(es) {missing}"
            )
        for p, s in self._socks.items():
            s.settimeout(timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._senders[p] = _PeerSender(s, p)

    @staticmethod
    def _recv_exact_raw(sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise PodPeerDeadError(
                    "pod exchange peer closed its connection "
                    "mid-protocol (peer process died?)"
                )
            buf.extend(chunk)
        return bytes(buf)

    def _peer_died(self, peer: int) -> None:
        """The peer-death cascade: poison the mesh, let this process's
        queued frames leave (a survivor may still be owed a frame of an
        earlier phase), then close every socket, so survivors blocked
        reading THIS process see EOF at once and convert the same way —
        no survivor waits out the receive deadline one phase behind
        another."""
        self.poisoned = True
        self.poison_reason = (
            f"the death of pod process {peer} mid-protocol (mesh sockets "
            "torn down for the synchronized raise)"
        )
        self.flush(min(_DRAIN_S, self._timeout_s))
        for s in self._socks.values():
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def flush(self, timeout_s: float) -> None:
        """Wait until every frame posted so far has left this process."""
        for sender in self._senders.values():
            sender.drain(timeout_s)

    def post(
        self, peer: int, stream: int, step: int, kind: int, body: bytes
    ) -> None:
        self._senders[peer].send(
            _FRAME.pack(stream, step, kind, len(body)) + body
        )

    def recv(self, peer: int, stream: int, step: int, kind: int) -> bytes:
        """The next frame from ``peer``, which the protocol guarantees is
        (stream, step, kind); anything else raises loudly."""
        sock = self._socks[peer]
        try:
            raw = self._recv_exact_raw(sock, _FRAME.size)
            got_stream, got_step, got_kind, length = _FRAME.unpack(raw)
            if (got_stream, got_step, got_kind) != (stream, step, kind):
                raise RuntimeError(
                    "pod exchange protocol desync with peer "
                    f"{peer}: expected (stream={stream}, step={step}, "
                    f"kind={kind}), got (stream={got_stream}, "
                    f"step={got_step}, kind={got_kind}) — "
                    "version-skewed pod or out-of-order stream "
                    "construction"
                )
            # The body is read under the same handler: a peer dying
            # mid-frame surfaces with its stream and step.
            return self._recv_exact_raw(sock, length) if length else b""
        except socket.timeout as e:
            raise RuntimeError(
                f"pod exchange timed out waiting for peer {peer} "
                f"(stream {stream} step {step} kind {kind}) after "
                f"{self._timeout_s:.0f}s; a lockstep collective would "
                "have hung here forever — check the peer's log"
            ) from e
        except (PodPeerDeadError, OSError) as e:
            # EOF or ECONNRESET/EPIPE on an ESTABLISHED socket: the peer
            # died. Cascade the teardown and let the gather paths convert
            # it into the synchronized −2 failure shape.
            self._peer_died(peer)
            raise PodPeerDeadError(
                f"pod exchange peer {peer} died mid-protocol "
                f"(stream {stream} step {step} kind {kind}): {e}",
                peer=peer,
            ) from e


class PodWindowExchange:
    """One stream's post/gather API over the process socket mesh.

    Values are raw little-endian numpy bytes (headers int64, payloads
    int32 carrier matrices); shapes derive from the agreed header
    geometry, so nothing beyond the frame header rides the wire.
    """

    def __init__(self, mesh: _PodSocketMesh, pid: int, world: int) -> None:
        self._mesh = mesh
        self._pid = pid
        self._world = world
        self._stream = next(_STREAM_IDS)
        # Own posted values, folded into gathers (no loopback socket).
        self._own_header = np.zeros(0, np.int64)
        self._own_confirm = np.int64(0)
        self._own_check = np.int64(0)

    @property
    def stream(self) -> int:
        """This stream's process-lifetime id (the same on every process:
        streams open in agreed program order). Rides the spans, since
        step numbers restart per stream."""
        return self._stream

    @classmethod
    def open(
        cls, timeout_s: float = POD_EXCHANGE_TIMEOUT_S
    ) -> Optional["PodWindowExchange"]:
        """The exchange for this process, or ``None`` without a process
        group of more than one rank. Call from the MAIN thread: the first
        call bootstraps the socket mesh through the process group."""
        from spark_examples_tpu_torch.parallel import distributed

        mesh = _PodSocketMesh.instance(timeout_s)
        if mesh is None:
            return None
        return cls(
            mesh, distributed.process_index(), distributed.process_count()
        )

    def _post_all(self, step: int, kind: int, body: bytes) -> None:
        for p in range(self._world):
            if p != self._pid:
                self._mesh.post(p, self._stream, step, kind, body)

    def post_header(self, step: int, fields: np.ndarray) -> None:
        self._own_header = np.asarray(fields, np.int64)
        self._post_all(step, _KIND_HEADER, self._own_header.tobytes())

    def gather_headers(self, step: int, n_fields: int) -> np.ndarray:
        """(world, n_fields) int64 — every process's step header, own row
        included. A peer that DIED contributes a synthesized all-−2 row:
        field 0 = −2 is the producer-failure shape every process already
        raises on together."""
        rows: List[Optional[np.ndarray]] = [None] * self._world
        for p in range(self._world):
            if p == self._pid:
                continue
            try:
                rows[p] = np.frombuffer(
                    self._mesh.recv(p, self._stream, step, _KIND_HEADER),
                    dtype=np.int64,
                )
            except PodPeerDeadError as e:
                print(f"WARNING: {e}; converting to the synchronized "
                      "-2 failure shape.", flush=True)
                rows[p] = np.full(n_fields, -2, np.int64)
        return np.stack(
            [r if r is not None else self._own_header for r in rows]
        ).reshape(self._world, n_fields)

    def post_confirm(self, step: int, ok: bool) -> None:
        self._own_confirm = np.int64(0 if ok else -2)
        self._post_all(
            step,
            _KIND_CONFIRM,
            np.array([self._own_confirm], np.int64).tobytes(),
        )

    def gather_confirms(self, step: int) -> np.ndarray:
        """(world,) int64 — 0 ok, −2 a payload-construction failure (a
        DEAD peer reads as −2 too)."""
        vals = np.empty(self._world, np.int64)
        for p in range(self._world):
            if p == self._pid:
                vals[p] = self._own_confirm
                continue
            try:
                vals[p] = np.frombuffer(
                    self._mesh.recv(p, self._stream, step, _KIND_CONFIRM),
                    dtype=np.int64,
                )[0]
            except PodPeerDeadError as e:
                print(f"WARNING: {e}; converting to the synchronized "
                      "-2 failure shape.", flush=True)
                vals[p] = -2
        return vals

    def post_check(self, step: int, digest: int) -> None:
        """Post this process's collective-congruence digest for one step
        (non-negative int64). Only when the gathered headers agreed that
        every live process has the check on."""
        self._own_check = np.int64(digest)
        self._post_all(
            step, _KIND_CHECK, np.array([self._own_check], np.int64).tobytes()
        )

    def gather_checks(self, step: int) -> np.ndarray:
        """(world,) int64 — every process's step digest, own included."""
        vals = np.empty(self._world, np.int64)
        for p in range(self._world):
            if p == self._pid:
                vals[p] = self._own_check
                continue
            vals[p] = np.frombuffer(
                self._mesh.recv(p, self._stream, step, _KIND_CHECK),
                dtype=np.int64,
            )[0]
        return vals

    def post_payload(self, step: int, mat: np.ndarray) -> None:
        self._post_all(
            step, _KIND_PAYLOAD, np.ascontiguousarray(mat).tobytes()
        )

    def get_payload(
        self,
        step: int,
        peer: int,
        shape: Tuple[int, ...],
        dtype: Any = np.int32,
    ) -> np.ndarray:
        raw = np.frombuffer(
            self._mesh.recv(peer, self._stream, step, _KIND_PAYLOAD),
            dtype=dtype,
        )
        return raw.reshape(shape)

    def flush(self, timeout_s: float = _DRAIN_S) -> None:
        """Wait until every frame this process posted has left it (a
        sender thread holds them until then)."""
        self._mesh.flush(timeout_s)

    def close(self) -> None:
        """Stream teardown: nothing to reclaim — the sockets live as long
        as the process, and a finished stream consumed every frame."""

    def poison(self) -> None:
        """Abandoned-stream teardown: see :meth:`_PodSocketMesh.poison`."""
        self._mesh.poison()


@dataclass
class PodSlot:
    """One agreed protocol step, staged for the consumer."""

    step: int
    route: str  # "scatter" | "dense"
    gathered: Optional[np.ndarray]  # scatter: the global carrier matrix
    local: Optional[np.ndarray]  # dense: this process's packed panel
    nnz: int
    variants: int
    windows: int  # local windows coalesced into this step's gang


_DONE = object()


class SlotPipeline:
    """Depth-D staged pipeline between the sync thread and the consumer.

    ``produce()`` returns a :class:`PodSlot`, ``None`` once the stream has
    drained, or raises (protocol failures, already synchronized across
    processes by the exchange). Results stage in a bounded queue of
    ``depth`` slots; the consumer's iterator yields them in order and
    re-raises the producer's exception at its slot position. ``depth ==
    0`` is inline lockstep (no thread): one protocol step per consumer
    pull — the ablation mode.
    """

    def __init__(
        self, produce: Callable[[], Optional[PodSlot]], depth: int
    ) -> None:
        if depth < 0:
            raise ValueError(f"pipeline depth must be >= 0, got {depth}")
        self._produce = produce
        self._depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _put(self, item: Any) -> bool:
        # A bounded put that gives up when the consumer abandoned the
        # stream (a blocked put with no reader would leak the thread).
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                slot = self._produce()
                if slot is None:
                    self._put(_DONE)
                    return
                if not self._put(slot):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._put(e)

    def __iter__(self) -> Iterator[PodSlot]:
        if self._depth == 0:
            while True:
                slot = self._produce()
                if slot is None:
                    return
                yield slot
        self._thread = threading.Thread(
            target=self._run, name="pod-sparse-sync", daemon=True
        )
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # The consumer abandoned the iterator (close, GeneratorExit or
            # an exception in its loop body): release the sync thread.
            self._stop.set()
