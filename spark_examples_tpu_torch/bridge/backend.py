"""PcaBackend implementations + a newline-JSON TCP bridge.

Protocol (one JSON object per line, UTF-8):

    → {"cmd": "init", "n_samples": N, "num_pc": k}
    → {"cmd": "calls", "batch": [[s0, s1, ...], ...]}   (repeatable)
    → {"cmd": "finish"}
    ← {"coords": [[pc1, pc2, ...], ...], "eigvals": [...]}

Newline-JSON over a socket keeps the bridge dependency-free on both sides
(a JVM client needs ~20 lines; no protobuf/py4j/grpc pinning) while the
payload — integer index lists — is exactly the reference's
``RDD[Seq[Int]]`` stage boundary, so a Spark driver can ship partitions
straight through ``collect``-free ``foreachPartition`` writes. The bytes on
the wire are the JAX package's bridge's, request and reply, so either
package's clients (and the C++ and Java examples) speak to either server.

The in-process backend is meshless: the meshed branch waits for the mesh
layer (ROADMAP.md, Queue 1, item 7).
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Iterable, List, Optional, Protocol, Sequence

import numpy as np

from spark_examples_tpu_torch.device import DEFAULT_DEVICE

__all__ = [
    "PcaBackend",
    "TorchPcaBackend",
    "PcaBridgeServer",
    "PcaBridgeClient",
    "iter_call_batches",
]


def iter_call_batches(
    calls: Iterable[Sequence[int]], batch_size: int
) -> Iterable[List[List[int]]]:
    """Group per-variant index lists into client-side wire batches —
    the one batching rule both bridge clients (newline-JSON TCP and
    gRPC ComputePca) share, so flush semantics can never diverge."""
    batch: List[List[int]] = []
    for c in calls:
        batch.append([int(i) for i in c])
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


class PcaBackend(Protocol):
    """The seam: per-variant sample-index lists in, coordinates out."""

    def compute(
        self, calls: Iterable[Sequence[int]], n_samples: int, num_pc: int
    ): ...


class TorchPcaBackend:
    """In-process backend: blockwise Gramian + PCoA on ``device``.

    The calls are densified into 0/1 blocks of ``block_variants`` variants
    (:func:`~spark_examples_tpu_torch.arrays.blocks.blocks_from_calls`),
    accumulated as int8 products
    (:func:`~spark_examples_tpu_torch.ops.gramian.gramian_blockwise`) and
    finished by dense PCoA (:func:`~spark_examples_tpu_torch.ops.pcoa.
    pcoa`). With a ``mesh`` the blocks accumulate into a tile grid
    (:func:`~spark_examples_tpu_torch.parallel.sharded.
    sharded_gramian_blockwise`) finished by :func:`~spark_examples_tpu_
    torch.parallel.sharded.sharded_pcoa`, on the mesh's devices. The
    device is resolved at the first call, so a server can hold a backend
    before a request needs the card; without CUDA the default ``"cuda"``
    raises then.
    """

    def __init__(
        self, mesh=None, block_variants: int = 8192, device=DEFAULT_DEVICE
    ):
        self.mesh = mesh
        self.block_variants = block_variants
        self.device = device

    def compute(
        self, calls: Iterable[Sequence[int]], n_samples: int, num_pc: int
    ):
        if num_pc < 1 or n_samples < 1:
            raise ValueError(
                f"need n_samples >= 1 and num_pc >= 1, got "
                f"n_samples={n_samples}, num_pc={num_pc}"
            )
        from spark_examples_tpu_torch.arrays.blocks import blocks_from_calls
        from spark_examples_tpu_torch.device import resolve_device
        from spark_examples_tpu_torch.ops.gramian import gramian_blockwise
        from spark_examples_tpu_torch.ops.pcoa import pcoa

        blocks = blocks_from_calls(calls, n_samples, self.block_variants)
        if self.mesh is not None:
            from spark_examples_tpu_torch.parallel.sharded import (
                sharded_gramian_blockwise,
                sharded_pcoa,
            )

            g = sharded_gramian_blockwise(blocks, n_samples, self.mesh)
            return sharded_pcoa(g, num_pc, self.mesh)
        dev = resolve_device(self.device)
        g = gramian_blockwise(blocks, n_samples, device=dev)
        coords, eigvals = pcoa(g, num_pc)
        return coords.cpu().numpy(), eigvals.cpu().numpy()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        backend: PcaBackend = self.server.backend  # type: ignore[attr-defined]
        n_samples = num_pc = None
        batches: List[List[int]] = []
        for raw in self.rfile:
            msg = json.loads(raw)
            cmd = msg.get("cmd")
            if cmd == "init":
                n_samples = int(msg["n_samples"])
                num_pc = int(msg["num_pc"])
            elif cmd == "calls":
                batches.extend(msg["batch"])
            elif cmd == "finish":
                if n_samples is None:
                    self._reply({"error": "finish before init"})
                    return
                try:
                    coords, eigvals = backend.compute(
                        iter(batches), n_samples, num_pc
                    )
                except (ValueError, KeyError) as e:
                    # Validation failures travel back to the client
                    # instead of silently dropping the connection.
                    self._reply({"error": str(e)})
                    return
                self._reply(
                    {
                        "coords": np.asarray(coords).tolist(),
                        "eigvals": np.asarray(eigvals).tolist(),
                    }
                )
                return
            else:
                self._reply({"error": f"unknown cmd {cmd!r}"})
                return

    def _reply(self, obj) -> None:
        self.wfile.write((json.dumps(obj) + "\n").encode())


class PcaBridgeServer:
    """Threaded TCP server wrapping any PcaBackend (by default a
    :class:`TorchPcaBackend` on the card)."""

    def __init__(self, backend: Optional[PcaBackend] = None, port: int = 0):
        self._srv = socketserver.ThreadingTCPServer(
            ("127.0.0.1", port), _Handler
        )
        self._srv.daemon_threads = True
        self._srv.backend = backend or TorchPcaBackend()  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "PcaBridgeServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class PcaBridgeClient:
    """Reference client (the role the Scala driver's PcaBackend stub plays)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.create_connection((host, port))
        self._file = self._sock.makefile("rwb")

    def _send(self, obj) -> None:
        self._file.write((json.dumps(obj) + "\n").encode())
        self._file.flush()

    def compute(
        self,
        calls: Iterable[Sequence[int]],
        n_samples: int,
        num_pc: int,
        batch_size: int = 4096,
    ):
        self._send({"cmd": "init", "n_samples": n_samples, "num_pc": num_pc})
        for batch in iter_call_batches(calls, batch_size):
            self._send({"cmd": "calls", "batch": batch})
        self._send({"cmd": "finish"})
        resp = json.loads(self._file.readline())
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return np.asarray(resp["coords"]), np.asarray(resp["eigvals"])

    def close(self) -> None:
        self._file.close()
        self._sock.close()
