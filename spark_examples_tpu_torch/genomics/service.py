"""HTTP genomics service — the network VariantSource pair.

The JAX package's ``genomics/service.py``, its data plane: either
package's client reads either package's server, through both wire tiers.

Reference mapping: each compute task's server-streaming gRPC request per
shard (``VariantsRDD.scala:205-235``) becomes one HTTP GET per shard, and
the callset metadata lookup (``Paginator.Callsets`` over REST,
``VariantsCommon.scala:40-43``) becomes ``GET /callsets``. The server half
fronts a local source (fixture or JSONL cohort) — a self-hosted
Genomics-compatible service.

Authentication follows ``Client(auth)`` (``Client.scala:49-61``): the
client resolves a :class:`~spark_examples_tpu_torch.genomics.auth.
Credentials` once and ships its token as a ``Bearer`` header on every
request; a token-configured server rejects anything else with 401. Failed
responses feed ``IoStats.unsuccessful_responses`` and transport failures
``IoStats.io_exceptions`` — the reference's client-wrapper counters
(``VariantsRDD.scala:199-203``).

Two wire tiers:

- ``/variants``: the JSONL interchange records of :mod:`.sources`, one per
  line, type-prefixed and ended by an end frame, gzip-encoded when the
  client accepts it;
- ``/variants-csr``: one shard's ``(indices, offsets)`` CSR pair in
  callset ordinals as checksummed binary frames (:mod:`.wire`), for the
  CSR-direct ingest.

``/reads`` streams one shard's reads as interchange records in the
``/variants`` framing.

The client's ``cache_dir`` mirrors the served cohort once, keyed by the
server's ``/identity`` (:mod:`.mirror`, shared with the gRPC transport of
:mod:`.grpc_transport`), and serves every later run from the mirror's CSR
sidecar (and its ``reads.jsonl``).

Not served yet (ROADMAP.md, Queue 1): the analysis job tier
(``POST /analyze``, ``/jobs``; item 6).
"""

from __future__ import annotations

import hmac
import http.client
import json
import os
import platform
import socket
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from importlib import metadata
from typing import Iterator, List, Optional
from urllib.parse import parse_qs, urlencode, urlparse

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics import mirror as mirror_mod
from spark_examples_tpu_torch.genomics import wire
from spark_examples_tpu_torch.genomics.auth import Credentials
from spark_examples_tpu_torch.genomics.shards import Shard
from spark_examples_tpu_torch.genomics.sources import (
    Callset,
    _carrying_keyed_records,
    _carrying_records,
    _read_to_record,
    _variant_to_record,
    csr_pair_from_lists,
    read_from_record,
    variant_from_record,
)
from spark_examples_tpu_torch.genomics.types import Read, Variant
from spark_examples_tpu_torch.resilience import (
    BreakerSet,
    CircuitOpenError,
    RetryPolicy,
    call_with_retry,
    classify_http,
    faults,
    parse_retry_after,
)
from spark_examples_tpu_torch.utils.stats import IoStats

__all__ = ["GenomicsServiceServer", "HttpVariantSource"]

# Explicit application-level framing. HTTP chunked truncation is NOT
# reliably detectable through http.client's line iteration (its read1/peek
# paths swallow IncompleteRead and report a clean EOF), so the stream is
# complete only when the end frame arrives; anything else is a truncated
# shard and must error, never feed partial data downstream. Every line is
# type-prefixed ("d " data / "e" end) so NO record payload — whatever
# bytes a cohort serves — can collide with the end frame.
_DATA_PREFIX = b"d "
_END_FRAME = b"e"

# POST body ceiling: anything megabyte-sized is a broken client or an
# attacker, and buffering it would convert an unauthenticated request
# into server memory.
_MAX_POST_BODY = 1 << 20


class _ServedHttpError(Exception):
    """Carrier for a served HTTP error status (the urllib.HTTPError
    analog for the keep-alive http.client path): _http_code reads
    ``.code`` off an IOError's cause regardless of transport, and the
    retry classifier reads ``.retry_after`` (parsed Retry-After header
    seconds) to honor server-directed backoff."""

    def __init__(
        self, code: int, reason: str, retry_after: Optional[float] = None
    ):
        super().__init__(f"HTTP {code} {reason}")
        self.code = code
        self.retry_after = retry_after


def _http_code(exc: IOError) -> Optional[int]:
    """HTTP status behind an IOError raised by ``_request`` (None when the
    failure was transport-level, not a served response)."""
    cause = exc.__cause__
    return getattr(cause, "code", None)


def _decoded_lines(resp) -> Iterator[bytes]:
    """Response lines, transparently gunzipping Content-Encoding: gzip.

    Incremental: one decompressobj across the stream, lines split as
    bytes arrive — the stream never materializes. A truncated gzip
    stream simply yields fewer lines; the framing layer above detects
    the missing end frame and raises.
    """
    if resp.headers.get("Content-Encoding") != "gzip":
        yield from resp
        return
    d = zlib.decompressobj(31)
    buf = b""
    while True:
        chunk = resp.read(65536)
        if not chunk:
            break
        buf += d.decompress(chunk)
        parts = buf.split(b"\n")
        buf = parts.pop()
        yield from parts
    buf += d.flush()
    if buf:
        yield buf


def _build_fragment() -> dict:
    """Git/build manifest for ``/statusz``: package version plus the
    checkout's HEAD when serving from a git tree."""
    doc: dict = {}
    try:
        doc["version"] = metadata.version("spark-examples-tpu")
    except Exception:  # not installed: a source checkout
        doc["version"] = None
    # HEAD without shelling out: resolve .git/HEAD -> ref file. Absent
    # (installed wheel, no checkout) is normal, not an error.
    try:
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        head_path = os.path.join(root, ".git", "HEAD")
        with open(head_path, encoding="utf-8") as f:
            head = f.read().strip()
        if head.startswith("ref:"):
            ref = head.split(None, 1)[1]
            with open(
                os.path.join(root, ".git", *ref.split("/")),
                encoding="utf-8",
            ) as f:
                doc["git"] = f.read().strip()[:12]
        else:
            doc["git"] = head[:12]
    except OSError:
        doc["git"] = None
    return doc


def _make_handler(source, token: Optional[str]):
    started_unix = time.time()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet: tests run many requests
            pass

        def _send_json(self, code: int, doc: dict) -> None:
            body = (json.dumps(doc) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- the live introspection plane ---------------------------------
        #
        # /metrics and /statusz sit behind the same bearer token as the
        # data endpoints. /healthz alone is served BEFORE auth: liveness
        # probes come from load balancers that hold no tokens, and the
        # reply carries only up/down bits.

        def _handle_metrics(self) -> None:
            # Prometheus text exposition straight off the ambient
            # registry; collector-backed series (IoStats) are summed at
            # scrape time, never per record.
            body = obs.get_registry().to_prometheus().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "text/plain; version=0.0.4; charset=utf-8",
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _handle_healthz(self) -> None:
            # A data server without the job tier has one check: it
            # answered.
            self._send_json(
                200, {"status": "ok", "checks": {"live": True}}
            )

        def _handle_statusz(self) -> None:
            doc: dict = {
                "server": {
                    "started_unix": started_unix,
                    "uptime_seconds": max(
                        0.0, time.time() - started_unix
                    ),
                    "pid": os.getpid(),
                    "host": socket.gethostname(),
                    "python": platform.python_version(),
                },
                "build": _build_fragment(),
                "tier": None,
            }
            self._send_json(200, doc)

        def do_POST(self):  # noqa: N802 — http.server API
            # Drain the body FIRST, whatever the outcome: unread body
            # bytes left on a keep-alive socket are parsed as the next
            # request line and poison the connection. The body length
            # must be KNOWN: chunked framing would be misread as zero
            # bytes, with the chunk bytes left to poison the socket.
            if self.headers.get("Transfer-Encoding"):
                self._send_json(
                    501,
                    {
                        "error": "chunked request bodies are not "
                        "supported; send Content-Length"
                    },
                )
                self.close_connection = True
                return
            if "Content-Length" not in self.headers:
                self._send_json(
                    411, {"error": "Content-Length required"}
                )
                self.close_connection = True  # body may be in flight
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send_json(
                    400, {"error": "malformed Content-Length header"}
                )
                self.close_connection = True  # body length unknowable
                return
            if length > _MAX_POST_BODY:
                # Refuse BEFORE buffering: the bound must hold for
                # unauthenticated requests too.
                self._send_json(
                    413,
                    {
                        "error": "request body too large "
                        f"(> {_MAX_POST_BODY} bytes)"
                    },
                )
                self.close_connection = True  # body left unread
                return
            if length > 0:
                self.rfile.read(length)
            if not self._authorized():
                self._deny()
                return
            # The analysis tier (POST /analyze) is ROADMAP.md Queue 1,
            # item 6; a server without it answers as the JAX package's
            # does without --analyze.
            self.send_error(404, "no analysis tier here")

        def _authorized(self) -> bool:
            if token is None:
                return True
            return hmac.compare_digest(
                self.headers.get("Authorization", ""), f"Bearer {token}"
            )

        def _deny(self) -> None:
            body = b'{"error": "unauthorized"}\n'
            self.send_response(401)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_lines(self, lines: Iterator[bytes]) -> None:
            # Chunked transfer: record count is unknown up front (the
            # server-streaming shape of VariantStreamIterator). Headers go
            # out lazily so a source that fails BEFORE yielding anything
            # still gets a clean 500 from do_GET. When the client accepts
            # gzip, the framed lines ride one gzip member across the whole
            # stream. A mid-stream kill drops the connection unflushed, so
            # the end frame can never be decompressed from a truncated
            # stream.
            comp = (
                zlib.compressobj(6, zlib.DEFLATED, 31)
                if "gzip" in self.headers.get("Accept-Encoding", "")
                else None
            )
            started = False

            def start_headers():
                self.send_response(200)
                self.send_header("Transfer-Encoding", "chunked")
                if comp is not None:
                    self.send_header("Content-Encoding", "gzip")
                self.end_headers()

            def send_chunk(data: bytes):
                if data:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")

            try:
                for line in lines:
                    if not started:
                        start_headers()
                        started = True
                    payload = _DATA_PREFIX + line + b"\n"
                    send_chunk(
                        comp.compress(payload) if comp else payload
                    )
            except Exception:
                if not started:
                    raise
                # Mid-stream source failure with a 200 already on the
                # wire: drop the connection without the end frame — the
                # client treats a frameless stream as truncated.
                self.close_connection = True
                return
            if not started:
                start_headers()
            payload = _END_FRAME + b"\n"
            if comp is not None:
                send_chunk(comp.compress(payload) + comp.flush())
            else:
                send_chunk(payload)
            self.wfile.write(b"0\r\n\r\n")

        def _send_body(self, body: bytes, content_type: str = "") -> None:
            self.send_response(200)
            if content_type:
                self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.split("?", 1)[0] == "/healthz":
                self._handle_healthz()
                return
            if not self._authorized():
                self._deny()
                return
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/callsets":
                    rows = [
                        {
                            "id": c.id,
                            "name": c.name,
                            "variant_set_id": c.variant_set_id,
                        }
                        for c in source.list_callsets(
                            q.get("variant_set_id", "")
                        )
                    ]
                    self._send_body((json.dumps(rows) + "\n").encode())
                elif url.path == "/variants":
                    shard = Shard(
                        q["contig"], int(q["start"]), int(q["end"])
                    )
                    raw = getattr(source, "stream_variant_lines", None)
                    if raw is not None:
                        # Zero-parse passthrough: file-backed sources
                        # serve raw interchange lines straight off the
                        # byte-offset index.
                        self._send_lines(
                            raw(q.get("variant_set_id", ""), shard)
                        )
                    else:
                        self._send_lines(
                            json.dumps(
                                _variant_to_record(v)
                                if isinstance(v, Variant)
                                else v
                            ).encode()
                            for v in source.stream_variants(
                                q.get("variant_set_id", ""), shard
                            )
                        )
                elif url.path == "/variants-csr":
                    # Binary columnar wire tier (genomics/wire.py): the
                    # shard's ordinal CSR pair as checksummed binary
                    # frames. 404 when the source cannot serve ordinal
                    # CSR; clients then fall back to the record tier.
                    frame_fn = getattr(
                        source, "stream_carrying_frame", None
                    )
                    order_fn = getattr(source, "callset_order", None)
                    if frame_fn is None or order_fn is None:
                        self.send_error(
                            404, "source does not serve CSR frames"
                        )
                        return
                    shard = Shard(
                        q["contig"], int(q["start"]), int(q["end"])
                    )
                    min_af = (
                        float(q["min_af"]) if "min_af" in q else None
                    )
                    ident = getattr(source, "cohort_identity", None)
                    ident = ident() if ident else None
                    body = wire.encode_shard_frames(
                        shard,
                        frame_fn(
                            q.get("variant_set_id", ""), shard, min_af
                        ),
                        # The digest is over the SAME normalized ids
                        # /callset-order serves.
                        wire.callsets_digest(
                            [str(c) for c in order_fn()]
                        ),
                        ident,
                    )
                    self._send_body(body, "application/x-sxcf-frames")
                elif url.path == "/callset-order":
                    # The ordinal id table frame payloads index into
                    # (clients fetch it once, remap frames locally).
                    order_fn = getattr(source, "callset_order", None)
                    if order_fn is None:
                        self.send_error(
                            404, "source has no callset order"
                        )
                        return
                    ids = [str(c) for c in order_fn()]
                    doc = {"ids": ids, "digest": wire.callsets_digest(ids)}
                    self._send_body((json.dumps(doc) + "\n").encode())
                elif url.path == "/reads":
                    shard = Shard(
                        q["contig"], int(q["start"]), int(q["end"])
                    )
                    self._send_lines(
                        json.dumps(
                            _read_to_record(r) if isinstance(r, Read) else r
                        ).encode()
                        for r in source.stream_reads(
                            q.get("read_group_set_id", ""), shard
                        )
                    )
                elif url.path == "/identity":
                    # Cohort content digest (the ETag analog). 404 when
                    # the source cannot identify itself.
                    ident = getattr(source, "cohort_identity", None)
                    ident = ident() if ident else None
                    if ident is None:
                        self.send_error(404, "source has no identity")
                        return
                    self._send_body(
                        (json.dumps({"identity": ident}) + "\n").encode()
                    )
                elif url.path == "/export-sidecar":
                    # Binary CSR sidecar export: raw bytes with
                    # Content-Length (the npz is already compressed, and
                    # the length lets the client detect truncation).
                    ensure = getattr(source, "ensure_sidecar", None)
                    path = ensure() if ensure is not None else None
                    if not path:
                        self.send_error(
                            404, "source has no sidecar to export"
                        )
                        return
                    # Open BEFORE stat: a concurrent rebuild os.replace()s
                    # the file, and a header length taken from a different
                    # inode than the streamed body corrupts the download.
                    with open(path, "rb") as f:
                        size = os.fstat(f.fileno()).st_size
                        self.send_response(200)
                        self.send_header("Content-Length", str(size))
                        self.end_headers()
                        remaining = size
                        while remaining > 0:
                            chunk = f.read(min(1 << 20, remaining))
                            if not chunk:
                                break
                            self.wfile.write(chunk)
                            remaining -= len(chunk)
                elif url.path == "/metrics":
                    self._handle_metrics()
                elif url.path == "/statusz":
                    self._handle_statusz()
                elif url.path.startswith("/export/"):
                    # Whole-cohort interchange-file export, framed and
                    # gzip-able like every stream.
                    name = url.path[len("/export/"):]
                    export = getattr(source, "export_lines", None)
                    if export is None:
                        self.send_error(404, "source does not export")
                        return
                    try:
                        lines = export(name)
                        self._send_lines(iter(lines))
                    except KeyError:
                        self.send_error(404, f"no such export: {name}")
                    except FileNotFoundError:
                        self.send_error(404, f"export missing: {name}")
                else:
                    self.send_error(404)
            except (KeyError, ValueError) as e:
                self.send_error(400, str(e))
            except Exception as e:  # noqa: BLE001 — surface, don't hang
                self.send_error(500, str(e))

    return Handler


class GenomicsServiceServer:
    """Serve a cohort source over HTTP (threaded; one shard per request)."""

    def __init__(
        self,
        source,
        port: int = 0,
        token: Optional[str] = None,
        host: str = "127.0.0.1",
    ):
        self._srv = ThreadingHTTPServer(
            (host, port), _make_handler(source, token)
        )
        self._srv.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "GenomicsServiceServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._srv.serve_forever()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)


class HttpVariantSource:
    """Network VariantSource over the HTTP service.

    One request per shard — the unit of data parallelism, exactly the
    reference's one-gRPC-stream-per-partition (``VariantsRDD.scala:
    205-211``). Records pass through the same builder path as every other
    source.

    Two wire tiers:

    - record streams (``/variants``) are gzip-encoded end to end when the
      server supports it;
    - the fused CSR ingest path (``stream_carrying_csr``, the driver's
      CSR-direct tier) rides the BINARY FRAME tier when the server speaks
      it: one checksummed binary frame per shard carrying the
      ``(indices, offsets)`` CSR pair in callset ordinals — no per-record
      JSON anywhere on the path (:mod:`.wire`). A server without
      ``/variants-csr`` degrades to the record tier; ``wire_frames=False``
      is the client-side switch.

    ``cache_dir`` enables the cohort mirror (:mod:`.mirror`): the first
    call downloads the served cohort once, keyed by ``/identity``, and
    every later call is served from a local ``JsonlSource`` over it — the
    CSR sidecar, zero network. ``mirror_mode="light"`` downloads only
    callsets + the sidecar. With ``cold_stream`` (the default) a COLD
    cohort is not a download barrier: shard frames ride the wire at once
    while the mirror downloads write-through on a background thread; the
    next run finds it complete. ``cold_stream=False`` is the phased path:
    the first call downloads the whole mirror, then serves from it.
    """

    def __init__(
        self,
        base_url: str,
        credentials: Optional[Credentials] = None,
        stats: Optional[IoStats] = None,
        timeout: float = 60.0,
        cache_dir: Optional[str] = None,
        mirror_mode: str = "full",
        retry_policy=None,
        breakers=None,
        wire_frames: bool = True,
        cold_stream: bool = True,
    ):
        if mirror_mode not in ("full", "light"):
            raise ValueError(
                f"mirror_mode must be 'full' or 'light', got {mirror_mode!r}"
            )
        self.base_url = base_url.rstrip("/")
        self._url = urlparse(self.base_url)
        self._token = credentials.token if credentials else ""
        self.stats = stats if stats is not None else IoStats()
        self._timeout = timeout
        self._cache_dir = cache_dir
        self._mirror_mode = mirror_mode
        self._cold_stream = cold_stream
        # Declarative failure handling (resilience/policy.py): every
        # request runs under the policy — transport errors and
        # infrastructural statuses (429/502/503/504...) retry with
        # jittered backoff and Retry-After honoring; per-PATH circuit
        # breakers shed load from a down endpoint.
        self._retry_policy = (
            retry_policy if retry_policy is not None else RetryPolicy()
        )
        self._breakers = (
            breakers
            if breakers is not None
            else BreakerSet(f"http:{self._url.netloc}")
        )
        self._mirror = None  # resolved lazily: JsonlSource | False | None
        # Shard-parallel ingest resolves the mirror from worker threads;
        # the download must happen exactly once, not raced.
        self._mirror_lock = threading.Lock()
        # Binary frame tier state: the server's callset-ordinal order
        # ((ids, digest) | False = server has no frame tier | None =
        # unprobed) and the single-slot ordinal→dense-index lookup
        # cache (identity-keyed on the run's shared indexes dict).
        self._wire_frames = wire_frames
        self._frame_order = None
        self._frame_lock = threading.Lock()
        self._frame_lookup = wire.OrdinalLookupCache()
        # Keep-alive: one persistent HTTP/1.1 connection PER WORKER
        # THREAD (http.client connections are not thread-safe); responses
        # are fully drained by the framing layer, which is what keeps the
        # socket reusable.
        self._conns = threading.local()

    def _connection(self):
        conn = getattr(self._conns, "conn", None)
        if conn is None:
            host = self._url.netloc
            cls = (
                http.client.HTTPSConnection
                if self._url.scheme == "https"
                else http.client.HTTPConnection
            )
            conn = cls(host, timeout=self._timeout)
            self._conns.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._conns, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._conns.conn = None

    def _one_attempt(self, path: str, target: str, headers: dict):
        """One wire round-trip: returns the response or raises IOError
        (transport trouble or a served error status, distinguishable by
        :func:`_http_code`). Per-ATTEMPT latency samples."""
        t0 = time.perf_counter()
        try:
            # Injection BEFORE the socket write: a fired fault is
            # indistinguishable from real transport weather downstream.
            faults.inject("transport.http.request", key=path)
            conn = self._connection()
            conn.request("GET", target, headers=headers)
            resp = conn.getresponse()
        except (http.client.HTTPException, OSError) as e:
            # A kept-alive socket the server closed between requests
            # fails exactly here — drop it so the next attempt (the
            # policy's call, not ours) reconnects fresh.
            self._drop_connection()
            obs.observe_rpc(
                "http", path, time.perf_counter() - t0, error=True
            )
            raise IOError(f"{path}: {e}") from e
        if resp.status >= 300:
            # A served error response (401/404/500): the reference
            # counts these as unsuccessfulResponses (Client.scala:59).
            # 3xx is an error too: this client does not follow
            # redirects — point --api-url at the service's final URL.
            reason = resp.reason
            code = resp.status
            retry_after = parse_retry_after(
                resp.headers.get("Retry-After")
            )
            try:
                resp.read()  # drain so the connection stays reusable
            except (http.client.HTTPException, OSError):
                self._drop_connection()
            obs.observe_rpc(
                "http", path, time.perf_counter() - t0, error=True
            )
            raise IOError(f"{path}: HTTP {code} {reason}") from (
                _ServedHttpError(code, reason, retry_after)
            )
        # Header-phase latency: the time to a served response. Shard
        # stream *bodies* are timed by the callers that consume them.
        obs.observe_rpc("http", path, time.perf_counter() - t0)
        return resp

    def _auth_headers(self) -> dict:
        return (
            {"Authorization": f"Bearer {self._token}"} if self._token else {}
        )

    def _retrying(self, path: str, fn):
        return call_with_retry(
            fn,
            self._retry_policy,
            classify_http,
            transport="http",
            method=path,
            breaker=self._breakers.get(path),
        )

    def _count_final_failure(self, e: IOError) -> None:
        """IoStats counting happens ONCE, at the final failure — retried
        attempts are visible on the obs surfaces instead, keeping the
        reference's accumulator semantics (Client.scala:57-61): served
        status → unsuccessful response, anything transport-shaped
        (breaker sheds included) → io exception."""
        if isinstance(e, CircuitOpenError) or _http_code(e) is None:
            self.stats.add(io_exceptions=1)
        else:
            self.stats.add(unsuccessful_responses=1)

    def _request(self, path: str, params: dict, stream: bool = False):
        target = self._url.path + path
        if params:
            target += f"?{urlencode(params)}"
        headers = self._auth_headers()
        if stream:
            # Only the framed stream endpoints decode gzip
            # (_decoded_lines); advertising it on plain-JSON paths would
            # invite a gzip-capable intermediary to encode bodies that
            # json.load reads raw.
            headers["Accept-Encoding"] = "gzip"
        self.stats.add(requests=1)
        try:
            return self._retrying(
                path, lambda: self._one_attempt(path, target, headers)
            )
        except IOError as e:
            self._count_final_failure(e)
            raise

    # -- cohort mirror cache ------------------------------------------------

    def _resolve_mirror(self):
        """JsonlSource over the local mirror, downloading it first if this
        identity has never been mirrored; False = caching unavailable
        (no cache_dir, or server without /identity). The protocol itself
        lives in :mod:`.mirror` (transport-agnostic; the gRPC source
        shares it) — this method supplies the HTTP feed and the once-only
        locking."""
        if self._mirror is not None:
            return self._mirror
        if not self._cache_dir:
            self._mirror = False
            return False
        with self._mirror_lock:
            if self._mirror is not None:
                return self._mirror
            self._mirror = mirror_mod.resolve_mirror(
                _HttpMirrorFeed(self),
                self._cache_dir,
                self._mirror_mode,
                self.stats,
                cold_stream=self._cold_stream,
            )
            return self._mirror

    def cold_stream_active(self) -> bool:
        """Is this run streaming a COLD cohort from the wire while the
        mirror downloads write-through in the background? (With
        cold-stream enabled, resolves the mirror — one /identity
        round-trip — if not yet resolved; with ``cold_stream=False`` this
        is a flag probe only, so the phased download still happens lazily
        at the first data call. The driver consults this before choosing
        its ingest order; the run-boundary tier upgrade is
        :func:`.mirror.refresh_cold_stream`, shared with the gRPC
        source.)"""
        return mirror_mod.refresh_cold_stream(self)

    def _note_cold_shard_fetched(self) -> None:
        mirror_mod.note_cold_shard_fetched(self._mirror)

    # -- binary frame tier --------------------------------------------------

    def _probe_request(self, path: str):
        """A capability probe: the same wire/retry/breaker path as
        ``_request`` but INVISIBLE to IoStats — probes are
        infrastructure, not data-plane requests, and the accumulators are
        pinned reference parity."""
        target = self._url.path + path
        headers = self._auth_headers()
        return self._retrying(
            path, lambda: self._one_attempt(path, target, headers)
        )

    def _frame_order_ids(self):
        """(ids, digest) from /callset-order — the ordinal table frame
        payloads index into — or False when the server has no frame tier
        (the client degrades to the record tier)."""
        if not self._wire_frames:
            return False
        if self._frame_order is None:
            with self._frame_lock:
                if self._frame_order is None:
                    try:
                        with self._probe_request(
                            "/callset-order"
                        ) as resp:
                            doc = json.load(resp)
                        self._frame_order = (
                            [str(i) for i in doc["ids"]],
                            str(doc["digest"]),
                        )
                    except IOError as e:
                        if _http_code(e) == 404:
                            self._frame_order = False
                        else:
                            raise
        return self._frame_order

    def _ordinal_lookup(self, indexes: dict):
        """(lookup array, ids, digest) for the run's shared indexes
        dict (wire.OrdinalLookupCache)."""
        ids, digest = self._frame_order_ids()
        return self._frame_lookup.get(ids, indexes), ids, digest

    def _frame_carrying_csr(
        self, variant_set_id, shard, indexes, min_allele_frequency
    ):
        """CSR ingest over the binary frame tier: one checksummed frame
        stream per shard, fetched+decoded as ONE retryable operation — a
        corrupted or truncated frame fails the CRC/end-frame check loudly
        and the whole shard re-fetches per policy, never a silent record
        drop."""
        path = "/variants-csr"
        lookup, ids, digest = self._ordinal_lookup(indexes)
        params = {
            "variant_set_id": variant_set_id,
            "contig": shard.contig,
            "start": shard.start,
            "end": shard.end,
        }
        if min_allele_frequency is not None:
            params["min_af"] = repr(float(min_allele_frequency))
        target = self._url.path + path + f"?{urlencode(params)}"
        headers = self._auth_headers()
        self.stats.add(
            requests=1, partitions=1, reference_bases=shard.range
        )

        def attempt():
            t0 = time.perf_counter()
            with obs.span("wire_frame_fetch", shard=str(shard)):
                resp = self._one_attempt(path, target, headers)
                decoder = wire.FrameDecoder(expect_digest=digest)
                frames = []
                try:
                    with resp:
                        chunks = iter(lambda: resp.read(1 << 20), b"")
                        # Chaos seam: stream-shaped faults (truncate/
                        # corrupt) on the frame bytes land here; the
                        # CRC + end-frame checks are what detects them.
                        for chunk in faults.wrap_lines(
                            "transport.http.frames", chunks, key=path
                        ):
                            frames.extend(decoder.feed(chunk))
                    decoder.finish()
                except (http.client.HTTPException, OSError) as e:
                    # Transport abort or a decode failure mid-body: the
                    # kept-alive socket may hold unread bytes — poison.
                    self._drop_connection()
                    if isinstance(e, wire.WireFormatError):
                        raise
                    raise IOError(
                        f"{path}: frame stream aborted mid-shard: {e}"
                    ) from e
            wire.note_frame_metrics(
                "http",
                decoder.frames,
                decoder.bytes,
                time.perf_counter() - t0,
            )
            return frames

        try:
            frames = self._retrying(path, attempt)
        except IOError as e:
            self._count_final_failure(e)
            raise
        self.stats.add(
            variants_read=sum(
                int(h.get("variants_read", 0)) for h, _, _ in frames
            )
        )
        return wire.remap_frames(frames, lookup, ids, shard)

    # -- source protocol ----------------------------------------------------

    def list_callsets(self, variant_set_id: str) -> List[Callset]:
        mirror = self._resolve_mirror()
        if mirror:
            return mirror.list_callsets(variant_set_id)
        with self._request(
            "/callsets", {"variant_set_id": variant_set_id}
        ) as resp:
            rows = json.load(resp)
        return [
            Callset(r["id"], r["name"], r.get("variant_set_id", ""))
            for r in rows
        ]

    def _wire_variant_records(self, variant_set_id: str, shard: Shard):
        """One shard request → parsed wire records (shared by the staged
        and both fused streaming paths: stats, params, and framing live
        here once)."""
        self.stats.add(partitions=1, reference_bases=shard.range)
        resp = self._request(
            "/variants",
            {
                "variant_set_id": variant_set_id,
                "contig": shard.contig,
                "start": shard.start,
                "end": shard.end,
            },
            stream=True,
        )
        return (
            json.loads(line)
            for line in self._stream_lines(resp, "/variants")
        )

    def stream_variants(
        self, variant_set_id: str, shard: Shard
    ) -> Iterator[Variant]:
        mirror = self._resolve_mirror()
        if mirror:
            yield from mirror.stream_variants(variant_set_id, shard)
            return
        for rec in self._wire_variant_records(variant_set_id, shard):
            v = variant_from_record(rec)
            if v is None:
                continue
            self.stats.add(variants_read=1)
            yield v

    def _stream_lines(self, resp, path: str) -> Iterator[bytes]:
        """Iterate response lines up to the end sentinel.

        A stream that ends any other way — connection drop, truncation,
        proxy cutoff — counts as an IO exception and raises; partial
        shards must never feed the pipeline silently. An unprefixed line
        means a protocol mismatch and raises rather than guessing.
        """
        complete = False
        unframed = False
        try:
            with resp:
                # Chaos seam: stream-shaped faults applied to the wire
                # lines land HERE, so the framing layer's defenses are
                # what detects them.
                for line in faults.wrap_lines(
                    "transport.http.stream", _decoded_lines(resp), key=path
                ):
                    line = line.rstrip(b"\r\n")
                    if not line:
                        continue
                    if line == _END_FRAME:
                        complete = True
                        break
                    if not line.startswith(_DATA_PREFIX):
                        unframed = True
                        break
                    yield line[len(_DATA_PREFIX):]
                if complete:
                    # Drain the chunked trailer so the kept-alive
                    # connection stays reusable for the next shard.
                    resp.read()
        except (http.client.HTTPException, OSError, zlib.error) as e:
            self.stats.add(io_exceptions=1)
            raise IOError(f"{path}: stream aborted mid-shard: {e}") from e
        if unframed:
            self.stats.add(io_exceptions=1)
            raise IOError(
                f"{path}: unframed line on the wire "
                "(server speaks a different protocol version?)"
            )
        if not complete:
            self.stats.add(io_exceptions=1)
            raise IOError(
                f"{path}: stream aborted mid-shard (no end-of-stream frame)"
            )

    def stream_carrying(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency=None,
    ):
        """Fused fast path over the wire records; the server already
        applied STRICT slicing and the variant-set filter."""
        mirror = self._resolve_mirror()
        if mirror:
            yield from mirror.stream_carrying(
                variant_set_id, shard, indexes, min_allele_frequency
            )
            return
        yield from _carrying_records(
            self._wire_variant_records(variant_set_id, shard),
            indexes,
            variant_set_id,
            self.stats,
            min_allele_frequency,
        )

    def stream_carrying_csr(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency=None,
    ):
        """CSR-direct fused ingest for remote cohorts, tiered fastest
        first: a mirrored sidecar when the cache holds one (zero network,
        zero parse); else the BINARY FRAME tier when the server speaks it;
        else assembled from the wire's JSON record stream (same
        semantics, one (indices, offsets) pair per shard). None for an
        empty shard window, like the local tier."""
        mirror = self._resolve_mirror()
        if mirror:
            return mirror.stream_carrying_csr(
                variant_set_id, shard, indexes, min_allele_frequency
            )
        if self._frame_order_ids():
            pair = self._frame_carrying_csr(
                variant_set_id, shard, indexes, min_allele_frequency
            )
            self._note_cold_shard_fetched()
            return pair
        pair = csr_pair_from_lists(
            _carrying_records(
                self._wire_variant_records(variant_set_id, shard),
                indexes,
                variant_set_id,
                self.stats,
                min_allele_frequency,
            )
        )
        self._note_cold_shard_fetched()
        return pair

    def stream_carrying_keyed(
        self,
        variant_set_id: str,
        shard: Shard,
        indexes: dict,
        min_allele_frequency=None,
    ):
        """Fused multi-dataset fast path over the wire records."""
        mirror = self._resolve_mirror()
        if mirror:
            yield from mirror.stream_carrying_keyed(
                variant_set_id, shard, indexes, min_allele_frequency
            )
            return
        yield from _carrying_keyed_records(
            self._wire_variant_records(variant_set_id, shard),
            indexes,
            variant_set_id,
            self.stats,
            min_allele_frequency,
        )

    def stream_reads(
        self, read_group_set_id: str, shard: Shard
    ) -> Iterator[Read]:
        mirror = self._resolve_mirror()
        if mirror:
            yield from mirror.stream_reads(read_group_set_id, shard)
            return
        self.stats.add(partitions=1, reference_bases=shard.range)
        resp = self._request(
            "/reads",
            {
                "read_group_set_id": read_group_set_id,
                "contig": shard.contig,
                "start": shard.start,
                "end": shard.end,
            },
            stream=True,
        )
        for line in self._stream_lines(resp, "/reads"):
            self.stats.add(reads_read=1)
            yield read_from_record(json.loads(line))


class _HttpMirrorFeed:
    """The HTTP transport behind the shared mirror protocol
    (:mod:`.mirror`): /identity, framed /export/<name> line streams, and
    the Content-Length-enforced /export-sidecar download. Served 404s map
    to the protocol's absent-export signals; transport trouble and auth
    failures surface — they must never silently disable the cache for a
    multi-thousand-shard run."""

    def __init__(self, source: HttpVariantSource):
        self._src = source

    def identity(self) -> Optional[str]:
        try:
            with self._src._request("/identity", {}) as resp:
                return json.load(resp)["identity"]
        except IOError as e:
            if _http_code(e) == 404:
                return None  # older server / unidentifiable source
            raise

    def export_lines(self, name: str):
        try:
            resp = self._src._request(f"/export/{name}", {}, stream=True)
        except IOError as e:
            if _http_code(e) == 404:
                raise mirror_mod.ExportUnavailable(str(e)) from e
            raise
        return self._src._stream_lines(resp, f"/export/{name}")

    def export_sidecar(self):
        try:
            resp = self._src._request("/export-sidecar", {})
        except IOError as e:
            if _http_code(e) == 404:
                raise mirror_mod.ExportUnavailable(str(e)) from e
            raise

        def chunks():
            # Content-Length is enforced by http.client: a premature
            # EOF raises (IncompleteRead) instead of yielding a
            # silently truncated npz.
            with resp:
                while True:
                    block = resp.read(1 << 20)
                    if not block:
                        return
                    yield block

        return chunks()
