"""One byte-path transport substrate (the "narrow waist").

Every hot byte path in this system — ring hops, heal stripes, RAM-ckpt
pushes, durable shards, publication fetches — used to carry its own
private copy of the same transport machinery: Range/resume negotiation,
bearer auth, connection pooling, retry classification, stripe geometry,
and a ``ThreadingHTTPServer`` per tier (four separate spellings of
thread-per-connection serving). ROADMAP items 2 + 4 compose here: this
module is the ONE implementation of each of those, plus the GIL-free
hosting core they all ride.

The substrate has four layers:

* **Geometry** — :func:`chunk_spans` derives every chunk/stripe boundary
  from :func:`torchft_tpu.communicator.shard_bounds`, the same
  ``np.linspace`` spelling the ring and sharded optimizer use, so no
  byte path can drift its own stripe arithmetic again.
* **Classification** — :func:`classify` is the one retry/failover table
  (built on :func:`torchft_tpu.retry.is_transient`); subsystems register
  their domain exceptions (:func:`register_transient` /
  :func:`register_fatal`) instead of spelling their own tables.
  :func:`looks_peer_dead` is the one connection-refused → failover
  short-circuit.
* **Client** — :class:`ConnectionPool` (pooled keep-alive GETs with
  one-retry-on-stale-reuse), :func:`open_url`, :func:`fetch_json`, and
  :func:`push_ranged` (the one ranged, chunked, fault-injectable PUT
  loop). All byte paths are ``memoryview`` end-to-end.
* **Server core** — :func:`serve_http` hosts every HTTP tier
  (checkpoint/heal, publication, RAM tier, parameter server) on a
  SINGLE process-wide asyncio event loop: connections are parsed and
  drained on the loop (socket sends/recvs release the GIL), handlers run
  on a small pool of reusable daemon worker threads (an idle keep-alive
  connection pins NO thread, unlike thread-per-connection), response
  bodies are queued as zero-copy memoryviews and drained under
  **per-path QoS** (ring > heal > publication > demotion, weighted-fair
  so no class starves), with ``os.sendfile`` for file-backed payloads.
  ``TORCHFT_ASYNC_SERVER=0`` falls back to the legacy threaded host —
  same routes, same semantics — for A/B benching.

The handler-facing surface is duck-typed to ``BaseHTTPRequestHandler``
(``path``/``headers``/``send_response``/``wfile``…), so route bodies are
written ONCE and host on either core unchanged. Chaos injection points
are untouched by design: ``serve:``/``heal:``/``ram:`` faults fire at
the client dial/read seams and at server bind (``endpoint_reborn``),
none of which move.
"""

from __future__ import annotations

import asyncio
import collections
import enum
import http.client
import io
import json
import logging
import os
import queue
import re
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from torchft_tpu_torch.communicator import shard_bounds
from torchft_tpu_torch.retry import is_transient

logger: logging.Logger = logging.getLogger(__name__)

_RANGE_RE = re.compile(r"bytes=(\d+)-(\d+)?$")

#: Header a client uses to declare its QoS class to the server; the
#: server core accounts and schedules the response bytes under it.
QOS_HEADER = "X-TFT-QoS"


# --------------------------------------------------------------------- QoS


class QoS(enum.IntEnum):
    """Per-path traffic classes, priority order. RING (collective hops)
    outranks HEAL (recovery stripes) outranks PUBLICATION (weight
    fan-out) outranks DEMOTION (RAM→disk→durable background copies)."""

    RING = 0
    HEAL = 1
    PUBLICATION = 2
    DEMOTION = 3


#: Weighted-fair shares, NOT strict priority: a saturating publication
#: leg must not starve a heal, but a heal must not starve the
#: publication uplink either (both directions are required) — so
#: every backlogged class drains at weight-proportional rate.
QOS_WEIGHTS: Dict[QoS, int] = {
    QoS.RING: 8,
    QoS.HEAL: 4,
    QoS.PUBLICATION: 2,
    QoS.DEMOTION: 1,
}

_QOS_BY_NAME = {c.name.lower(): c for c in QoS}


def qos_from_header(value: Optional[str], default: QoS) -> QoS:
    """Parse a client's ``X-TFT-QoS`` header; unknown/absent → default
    (an unauthenticated peer can only ever *lower* its own priority
    below ring, which is never carried over HTTP)."""
    if not value:
        return default
    got = _QOS_BY_NAME.get(value.strip().lower())
    if got is None or got == QoS.RING:
        return default
    return got


def qos_for_request(method: str, path: str, headers: Any) -> QoS:
    """Default server-side class per route: publication fetches under
    PUBLICATION, replication/demotion PUTs under DEMOTION, everything
    else (checkpoint heal, RAM-rung reads, control JSON) under HEAL."""
    if path.startswith("/publish"):
        default = QoS.PUBLICATION
    elif method == "PUT":
        default = QoS.DEMOTION
    else:
        default = QoS.HEAL
    return qos_from_header(headers.get(QOS_HEADER), default)


class _Counters:
    """Process-wide transport counters (lock-guarded: ring threads, the
    event loop, and push clients all account here)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.qos_bytes: Dict[QoS, int] = {c: 0 for c in QoS}
        self.qos_waits = 0
        self.conns = 0
        self.requests = 0
        self.sendfile_bytes = 0

    def note(self, qos: QoS, nbytes: int) -> None:
        with self._lock:
            self.qos_bytes[qos] += int(nbytes)

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)


_counters = _Counters()


def note_ring_bytes(nbytes: int) -> None:
    """Account collective-ring wire bytes into the RING class. The ring
    rides its own dedicated sockets (it never shares the HTTP uplink's
    scheduler), so its 'priority' is socket-level
    (:func:`mark_socket`) + accounting, not queueing."""
    _counters.note(QoS.RING, nbytes)


def set_nodelay(sock: Optional[socket.socket]) -> None:
    """Best-effort ``TCP_NODELAY`` on a substrate socket. The byte
    paths are request/response over keep-alive connections: with Nagle
    on, every small head/manifest/delta-doc exchange can stall a
    delayed-ACK interval (~40ms) — several round trips per sync, it
    dominates publish-to-visible latency. Failures are ignored (unix
    sockets, platforms without the knob)."""
    if sock is None:
        return
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except (OSError, AttributeError):
        pass


def mark_socket(sock: socket.socket, qos: QoS) -> None:
    """Best-effort kernel-level priority tag for a raw byte-path socket
    (IP DSCP + Linux ``SO_PRIORITY``); failures are ignored — QoS
    degrades to accounting-only on platforms without the knobs."""
    tos = {QoS.RING: 0xB8, QoS.HEAL: 0x68,
           QoS.PUBLICATION: 0x28, QoS.DEMOTION: 0x08}[qos]
    prio = {QoS.RING: 6, QoS.HEAL: 4, QoS.PUBLICATION: 2,
            QoS.DEMOTION: 0}[qos]
    try:
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, tos)
    except OSError:
        pass
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_PRIORITY, prio)
    except (OSError, AttributeError):
        pass


class QoSScheduler:
    """Deficit-round-robin grant scheduler for the async server's
    response bytes. Every queued chunk awaits a grant; while more than
    one class is backlogged, each round hands class ``c`` a budget of
    ``QOS_WEIGHTS[c] * quantum`` bytes, so drain rates converge to the
    weight ratios — higher classes go faster, nobody starves. With a
    single backlogged class the pump degenerates to FIFO (one loop hop
    per chunk, negligible against a 1MB send). Loop-thread only."""

    QUANTUM = 256 << 10

    def __init__(self, counters: _Counters) -> None:
        self._waiters: Dict[QoS, collections.deque] = {
            c: collections.deque() for c in QoS}
        self._deficit: Dict[QoS, float] = {c: 0.0 for c in QoS}
        self._counters = counters
        self._pump_task: Optional[asyncio.Task] = None

    async def grant(self, qos: QoS, nbytes: int) -> None:
        # Every grant rides the pump — a fast path that skips the queue
        # when it LOOKS uncontended would mean the queue can never form
        # and the weights never engage. Uncontended cost is one loop
        # hop per chunk, negligible against a 1MB socket send.
        loop = asyncio.get_event_loop()
        if any(self._waiters[c] for c in QoS if c != qos):
            self._counters.bump("qos_waits")
        fut = loop.create_future()
        self._waiters[qos].append((fut, nbytes))
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = loop.create_task(self._pump())
        await fut

    async def _pump(self) -> None:
        while any(self._waiters[c] for c in QoS):
            for c in QoS:
                q = self._waiters[c]
                if not q:
                    self._deficit[c] = 0.0
                    continue
                self._deficit[c] += QOS_WEIGHTS[c] * self.QUANTUM
                while q and q[0][1] <= self._deficit[c]:
                    fut, n = q.popleft()
                    self._deficit[c] -= n
                    self._counters.note(c, n)
                    if not fut.done():
                        fut.set_result(None)
                if not q:
                    # Emptied mid-round: unused budget must not bank.
                    self._deficit[c] = 0.0
            # Let granted writers run their sends (and likely re-queue
            # their next chunk) before the next round.
            await asyncio.sleep(0)


# ----------------------------------------------------- retry classification


_transient_types: Tuple[type, ...] = ()
_fatal_types: Tuple[type, ...] = ()


def register_transient(*excs: type) -> None:
    """Register exception types the shared table treats as transient
    (retry in place). Subsystems call this at import time instead of
    spelling a private classification — e.g. checkpointing registers
    ``LeafDigestError`` (wire corruption: re-fetch fixes it)."""
    global _transient_types
    _transient_types = tuple(dict.fromkeys(_transient_types + excs))


def register_fatal(*excs: type) -> None:
    """Register exception types the shared table treats as fatal (stop
    retrying this peer; failover may help) — e.g. ``HealCorruptError``
    (the donor's copy itself is corrupt) and
    ``CheckpointCorruptError``."""
    global _fatal_types
    _fatal_types = tuple(dict.fromkeys(_fatal_types + excs))


def classify(exc: BaseException) -> bool:
    """THE retry/failover classification: True = transient (retry), False
    = fatal. Precedence: registered fatal types, registered transient
    types, the HTTP rule (503 is transient BY CONSTRUCTION — a closed
    serve window reopens next step — unless the donor says it is
    shutting down), then the shared :func:`torchft_tpu.retry.is_transient`
    marker table."""
    if isinstance(exc, _fatal_types):
        return False
    if isinstance(exc, _transient_types):
        return True
    if isinstance(exc, urllib.error.HTTPError):
        reason = str(getattr(exc, "reason", "") or exc).lower()
        return exc.code == 503 and "shutting down" not in reason
    return is_transient(exc)


def looks_peer_dead(exc: BaseException) -> bool:
    """Connection-refused means the peer's server socket is GONE (dead
    process / freed port) — unlike the resets and timeouts a live-but-
    flaky peer produces — so callers short-circuit straight to failover
    instead of burning retry budget against a corpse. Walks the
    ``reason``/``__cause__`` chain because urllib wraps the refusal."""
    e: Optional[BaseException] = exc
    for _ in range(5):
        if e is None:
            break
        if isinstance(e, ConnectionRefusedError):
            return True
        reason = getattr(e, "reason", None)
        e = reason if isinstance(reason, BaseException) else e.__cause__
    return "connection refused" in str(exc).lower()


# ------------------------------------------------------------- geometry


def chunk_spans(total: int, max_chunk: int,
                base: int = 0) -> List[Tuple[int, int]]:
    """Balanced chunk boundaries of a ``total``-byte region, derived
    from :func:`torchft_tpu.communicator.shard_bounds` — the ONE stripe/
    chunk geometry source (the same linspace the ring, the sharded
    optimizer, and the striped heal all use). Chunks are ≤ ``max_chunk``
    and within 1 byte of equal, so the last chunk is never a runt.
    ``base`` offsets the spans (for serving a sub-range)."""
    total = int(total)
    if total <= 0:
        return []
    n = -(-total // max(int(max_chunk), 1))  # ceil
    b = shard_bounds(total, n)
    return [(base + int(b[i]), base + int(b[i + 1])) for i in range(n)]


# ------------------------------------------------- server-side body helpers


def check_bearer_auth(handler: Any, token: Optional[str]) -> bool:
    """The ONE bearer-token gate for every HTTP tier; sends the 401
    itself, returns True when authorized.

    Constant-time compare: plain ``!=`` short-circuits and leaks the
    token prefix via response timing. Compare as bytes —
    ``compare_digest`` raises TypeError on non-ASCII str, which an
    attacker could trigger with a latin-1 header to crash the handler
    instead of getting a 401. ``got`` came from the server's latin-1
    header decode, so latin-1 re-encode recovers the client's raw
    bytes; ``want`` encodes UTF-8, the byte form a legitimate client
    sends for a non-ASCII token."""
    if token is None:
        return True
    import hmac
    got = handler.headers.get("Authorization", "") or ""
    want = f"Bearer {token}"
    if not hmac.compare_digest(got.encode("latin-1", "replace"),
                               want.encode("utf-8")):
        handler.send_error(401, "missing/bad bearer token")
        return False
    return True


def negotiate_range(handler: Any, total: int
                    ) -> Optional[Tuple[int, int, int]]:
    """The ONE Range-header negotiation (live-plan bodies, RAM-tier
    images, file payloads): parse the request's Range against ``total``,
    send the 416 itself (returning None), else return
    ``(status, start, end)`` — 206 for a partial span, 200 for the full
    stream (including an unparseable Range, which HTTP permits
    ignoring)."""
    start, end = 0, total
    status = 200
    rng = handler.headers.get("Range")
    if rng:
        m = _RANGE_RE.match(rng.strip())
        if m:
            start = int(m.group(1))
            if m.group(2) is not None:
                end = min(int(m.group(2)) + 1, total)
            if start >= total or start >= end:
                handler.send_response(416)
                handler.send_header("Content-Range", f"bytes */{total}")
                handler.send_header("Content-Length", "0")
                handler.end_headers()
                return None
            status = 206
    return status, start, end


def _send_range_head(handler: Any, status: int, start: int, end: int,
                     total: int, send_timeout_sec: float) -> None:
    handler.send_response(status)
    handler.send_header("Content-Type", "application/octet-stream")
    handler.send_header("Content-Length", str(end - start))
    if status == 206:
        handler.send_header("Content-Range",
                            f"bytes {start}-{end - 1}/{total}")
    handler.end_headers()
    handler.connection.settimeout(send_timeout_sec)


def serve_ranged_body(handler: Any, state: Any, plan: Any,
                      send_timeout_sec: float) -> int:
    """Stream one serialized snapshot's bytes on ``handler`` with HTTP
    Range semantics (200 full / 206 partial + Content-Range / 416) —
    the ONE body-serving implementation shared by the checkpoint heal
    endpoint and the publication tier, so Range behavior cannot drift
    between them. Total length is known from the plan before any
    device data is fetched (Content-Length up front), chunks are
    zero-copy memoryviews, and socket-write backpressure paces the
    fetches. Returns bytes written (0 for a 416)."""
    from torchft_tpu_torch.serialization import iter_pytree_chunks

    total = int(plan[1])
    span = negotiate_range(handler, total)
    if span is None:
        return 0
    status, start, end = span
    _send_range_head(handler, status, start, end, total, send_timeout_sec)
    sent = 0
    for chunk in iter_pytree_chunks(state, plan=plan, start=start,
                                    end=end):
        handler.wfile.write(chunk)
        sent += len(chunk)
    return sent


def serve_ranged_bytes(handler: Any, view: memoryview,
                       send_timeout_sec: float) -> int:
    """Range-serve an immutable in-memory byte region (the RAM
    checkpoint tier's payload serving — docs/design/memory_tier.md).
    Same negotiation as :func:`serve_ranged_body`; chunked memoryview
    writes (boundaries from :func:`chunk_spans`), so a healer's
    backpressure paces us without a full-copy."""
    total = len(view)
    span = negotiate_range(handler, total)
    if span is None:
        return 0
    status, start, end = span
    _send_range_head(handler, status, start, end, total, send_timeout_sec)
    sent = 0
    for a, b in chunk_spans(end - start, 1 << 20, base=start):
        handler.wfile.write(view[a:b])
        sent += b - a
    return sent


def serve_ranged_file(handler: Any, fobj: Any, total: int,
                      send_timeout_sec: float) -> int:
    """Range-serve a file-backed payload. On the async core the body
    goes out via ``os.sendfile`` (zero user-space copies, GIL never
    held); on the threaded fallback it falls back to chunked reads."""
    span = negotiate_range(handler, total)
    if span is None:
        return 0
    status, start, end = span
    _send_range_head(handler, status, start, end, total, send_timeout_sec)
    send_file = getattr(handler, "send_file", None)
    if send_file is not None:
        return send_file(fobj, start, end - start)
    fobj.seek(start)
    sent = 0
    while sent < end - start:
        data = fobj.read(min(1 << 20, end - start - sent))
        if not data:
            break
        handler.wfile.write(data)
        sent += len(data)
    return sent


# ------------------------------------------------------------ fetch client


def open_url(url: str, stall: float, auth_token: Optional[str],
             headers: Optional[Dict[str, str]] = None,
             pool: Optional["ConnectionPool"] = None) -> Any:
    """Dial a substrate URL. ``stall`` becomes the socket-op timeout: it
    bounds how long ANY read may sit with zero bytes arriving — the
    stall watchdog — rather than the whole transfer's wall clock.
    ``pool``, when given, serves the request over a persistent per-peer
    connection instead of a fresh TCP dial per request."""
    if pool is not None:
        return pool.request(url, stall, auth_token, headers=headers)
    req = urllib.request.Request(url)
    if auth_token is not None:
        req.add_header("Authorization", f"Bearer {auth_token}")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    return urllib.request.urlopen(req, timeout=stall)


def fetch_json(url: str, stall: float = 5.0,
               auth_token: Optional[str] = None,
               pool: Optional["ConnectionPool"] = None,
               headers: Optional[Dict[str, str]] = None) -> Any:
    """One-shot JSON probe over the pooled reader (peer step listings,
    parameter-server session grants, status endpoints)."""
    resp = open_url(url, stall, auth_token, headers=headers, pool=pool)
    try:
        return json.loads(resp.read())
    finally:
        resp.close()


class PooledResponse:
    """Response off a pooled connection: returns the connection to its
    pool on close iff the body was consumed to completion
    (``http.client`` marks the response closed at EOF) and the server
    did not ask to close — anything else (exception, partial read,
    ``Connection: close``) drops the connection so a later request can
    never read a previous response's tail bytes."""

    def __init__(self, resp: Any, conn: Any, pool: "ConnectionPool",
                 key: str) -> None:
        self._resp = resp
        self._conn = conn
        self._pool = pool
        self._key = key

    def __getattr__(self, name: str) -> Any:
        return getattr(self._resp, name)

    def getcode(self) -> int:
        return self._resp.status

    def read(self, n: int = -1) -> bytes:
        # Map the file-like -1 to http.client's framing-aware None: a
        # raw read(-1) reads the SOCKET to EOF, which on a kept-alive
        # connection means blocking until the server's idle timeout.
        return self._resp.read(None if n is None or n < 0 else n)

    def readinto(self, b) -> int:
        return self._resp.readinto(b)

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        resp = self._resp
        clean = resp.isclosed() and not resp.will_close
        try:
            resp.close()
        except Exception:  # noqa: BLE001 — a dirty close just drops conn
            clean = False
        if clean:
            self._pool._put_idle(self._key, conn)
        else:
            conn.close()

    def __enter__(self) -> "PooledResponse":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class ConnectionPool:
    """One persistent HTTP connection per ``host:port``, reused across
    the Range/manifest requests of an attempt wave (and across a weight
    subscriber's polling lifetime). Every reuse is a TCP dial avoided —
    counted in ``redials_avoided``, surfaced as ``heal_redials_avoided``
    in ``Manager.metrics()``. Only *idle* connections live in the pool:
    a request pops its peer's connection (or dials fresh) and the
    response returns it on close only when the body was read clean, so
    the striped fetch's one-thread-per-donor concurrency never shares a
    connection — the dict itself is lock-guarded."""

    def __init__(self) -> None:
        self._idle: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.redials = 0
        self.redials_avoided = 0

    def _put_idle(self, key: str, conn: Any) -> None:
        with self._lock:
            if key not in self._idle:
                self._idle[key] = conn
                return
        conn.close()

    def request(self, url: str, stall: float, auth_token: Optional[str],
                headers: Optional[Dict[str, str]] = None,
                method: str = "GET") -> Any:
        u = urllib.parse.urlsplit(url)
        key = u.netloc
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        hdrs = dict(headers or {})
        if auth_token is not None:
            hdrs["Authorization"] = f"Bearer {auth_token}"
        with self._lock:
            conn = self._idle.pop(key, None)
        reused = conn is not None
        resp = None
        for attempt in (0, 1):
            if conn is None:
                conn = http.client.HTTPConnection(u.hostname, u.port,
                                                  timeout=stall)
            try:
                conn.timeout = stall
                if conn.sock is None:
                    conn.connect()
                    set_nodelay(conn.sock)
                conn.sock.settimeout(stall)
                conn.request(method, path, headers=hdrs)
                resp = conn.getresponse()
                break
            except Exception:
                conn.close()
                conn = None
                # A kept-alive connection the server idle-closed between
                # waves looks like a send/recv failure on the FIRST use
                # after reuse: retry once on a fresh dial. Fresh-dial
                # failures propagate — they are the peer's problem, and
                # the caller's retry/failover discipline owns them.
                if not reused or attempt:
                    raise
                reused = False
        with self._lock:
            if reused:
                self.redials_avoided += 1
            else:
                self.redials += 1
        if resp.status >= 400:
            # Error responses carry Connection: close (send_error);
            # capture the bounded body for the HTTPError, drop the conn.
            body = resp.read(65536)
            conn.close()
            raise urllib.error.HTTPError(url, resp.status, resp.reason,
                                         resp.headers, io.BytesIO(body))
        return PooledResponse(resp, conn, self, key)

    def close(self) -> None:
        with self._lock:
            conns = list(self._idle.values())
            self._idle.clear()
        for c in conns:
            c.close()


class CountingReader:
    """Read-through wrapper counting bytes actually delivered to the
    receiver — the truthful transfer-volume source (the sender's
    Content-Length claim is 0 when absent and a lie under
    truncation)."""

    def __init__(self, raw: Any, counter: list) -> None:
        self._raw = raw
        self._counter = counter

    def read(self, n: int = -1) -> bytes:
        data = self._raw.read(n)
        self._counter[0] += len(data)
        return data

    def readinto(self, b) -> int:
        if hasattr(self._raw, "readinto"):
            n = self._raw.readinto(b)
        else:
            data = self._raw.read(len(b))
            n = len(data)
            b[:n] = data
        self._counter[0] += n or 0
        return n


class PushRejectedError(ValueError):
    """The receiver rejected a ranged PUT with 422: the payload failed
    its verification (digest/manifest mismatch). Fatal for this image —
    re-pushing the same bytes cannot help."""

    def __init__(self, netloc: str, path: str, body: bytes) -> None:
        super().__init__(
            f"peer {netloc} rejected PUT {path}: {body[:200]!r}")
        self.netloc = netloc
        self.path = path
        self.body = body


def push_ranged(base_url: str, path: str, view: memoryview,
                auth_token: Optional[str] = None,
                timeout_sec: float = 30.0,
                chunk_bytes: int = 8 << 20,
                qos: QoS = QoS.DEMOTION,
                fault: Optional[Callable[[], None]] = None,
                progress: Optional[Callable[[int], None]] = None) -> int:
    """The ONE ranged-PUT push loop (RAM-tier replication, demotion
    uploads): stream ``view`` to ``{base_url}{path}`` in balanced
    ``Content-Range`` chunks (:func:`chunk_spans` geometry) over a
    single persistent connection. Chunks are zero-copy memoryview
    slices. ``fault``, when given, runs before every chunk — the chaos
    seam (``ram:`` faults) stays exactly where it was. 422 raises
    :class:`PushRejectedError` (receiver-side verification failed —
    fatal for this payload); any other non-2xx raises ``OSError``.
    Bytes are accounted to ``qos``. Returns bytes pushed."""
    u = urllib.parse.urlparse(base_url)
    netloc = u.netloc
    total = len(view)
    conn = http.client.HTTPConnection(u.hostname, u.port,
                                      timeout=timeout_sec)
    pushed = 0
    try:
        conn.connect()
        set_nodelay(conn.sock)
        for start, end in chunk_spans(total, chunk_bytes):
            if fault is not None:
                fault()
            headers = {
                "Content-Range": f"bytes {start}-{end - 1}/{total}",
                "Content-Type": "application/octet-stream",
                QOS_HEADER: qos.name.lower(),
            }
            if auth_token is not None:
                headers["Authorization"] = f"Bearer {auth_token}"
            conn.request("PUT", path, body=view[start:end],
                         headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status == 422:
                raise PushRejectedError(netloc, path, body)
            if resp.status not in (200, 201):
                raise OSError(
                    f"peer {netloc} PUT {path} failed: "
                    f"{resp.status} {body[:200]!r}")
            _counters.note(qos, end - start)
            pushed += end - start
            if progress is not None:
                progress(end - start)
    finally:
        conn.close()
    return pushed


# ----------------------------------------------------------- async hosting


class _Headers(dict):
    """Case-insensitive request-header view (duck-types the
    ``email.message.Message.get`` surface the route bodies use)."""

    def get(self, key: str, default: Any = None) -> Any:  # type: ignore
        return super().get(key.lower(), default)


class _WorkerPool:
    """Reusable daemon worker threads for handler bodies. Unlike
    ``ThreadPoolExecutor`` the threads are daemons (a parked session
    must never block interpreter exit — ``ThreadingHTTPServer`` set
    ``daemon_threads`` for the same reason) and are reclaimed after
    ``idle_sec``. Unlike thread-per-connection, an idle keep-alive
    connection pins no thread at all."""

    def __init__(self, max_workers: int = 512,
                 idle_sec: float = 30.0) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._lk = threading.Lock()
        self._max = max_workers
        self._idle_sec = idle_sec
        self._count = 0
        self._idle = 0

    def size(self) -> int:
        with self._lk:
            return self._count

    def submit(self, fn: Callable[[], Any],
               loop: asyncio.AbstractEventLoop) -> "asyncio.Future":
        fut = loop.create_future()

        def _resolve(setter: Callable, value: Any) -> None:
            if not fut.done():
                setter(value)

        def task() -> None:
            try:
                r = fn()
            except BaseException as e:  # noqa: BLE001 — ferried to loop
                loop.call_soon_threadsafe(_resolve, fut.set_exception, e)
            else:
                loop.call_soon_threadsafe(_resolve, fut.set_result, r)

        with self._lk:
            spawn = self._idle == 0 and self._count < self._max
            if spawn:
                self._count += 1
        if spawn:
            threading.Thread(target=self._worker, args=(task,),
                             daemon=True, name="tft-transport-worker",
                             ).start()
        else:
            self._q.put(task)
        return fut

    def _worker(self, task: Optional[Callable]) -> None:
        while True:
            if task is None:
                with self._lk:
                    self._idle += 1
                try:
                    task = self._q.get(timeout=self._idle_sec)
                    with self._lk:
                        self._idle -= 1
                except queue.Empty:
                    with self._lk:
                        self._idle -= 1
                        # Drain-check under the lock: a task enqueued
                        # against our idle slot must not be orphaned.
                        try:
                            task = self._q.get_nowait()
                        except queue.Empty:
                            self._count -= 1
                            return
            try:
                task()
            except BaseException:  # noqa: BLE001 — worker must survive
                logger.exception("transport worker task failed")
            task = None


class _TransportCore:
    """The single process-wide asyncio event loop + worker pool + QoS
    scheduler every async-hosted server shares. Lazily started on a
    daemon thread; all socket I/O happens here (GIL released inside the
    kernel calls), handler bodies fold on the worker pool."""

    _instance: Optional["_TransportCore"] = None
    _ilock = threading.Lock()

    @classmethod
    def get(cls) -> "_TransportCore":
        with cls._ilock:
            if cls._instance is None or not cls._instance.thread.is_alive():
                cls._instance = cls()
            return cls._instance

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.workers = _WorkerPool(
            max_workers=int(os.environ.get("TORCHFT_TRANSPORT_WORKERS",
                                           "512")))
        self.scheduler = QoSScheduler(_counters)
        started = threading.Event()
        self.thread = threading.Thread(
            target=self._run, args=(started,), daemon=True,
            name="tft-transport-loop")
        self.thread.start()
        started.wait()

    def _run(self, started: threading.Event) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.call_soon(started.set)
        self.loop.run_forever()


class _ResponseStartedError(RuntimeError):
    pass


class _ShimWFile:
    """Worker-thread write surface: enqueues zero-copy chunks onto the
    connection's loop-side drain queue, blocking only on backpressure
    (queue past high-water) — bounded by the handler's send timeout,
    surfacing as ``socket.timeout`` exactly like a blocking
    ``wfile.write`` did."""

    def __init__(self, shim: "_HandlerShim") -> None:
        self._shim = shim

    def write(self, data: Any) -> int:
        self._shim._enqueue(data)
        return len(data)

    def flush(self) -> None:
        pass


class _ShimConnection:
    """Duck-types the one ``handler.connection`` call routes make:
    ``settimeout`` (the per-response send pacing bound)."""

    def __init__(self, shim: "_HandlerShim") -> None:
        self._shim = shim

    def settimeout(self, t: Optional[float]) -> None:
        self._shim._conn.timeout = t


class _ShimRFile:
    """Worker-thread read surface over the connection's StreamReader;
    greedy like a buffered socket rfile (returns short only at EOF)."""

    def __init__(self, shim: "_HandlerShim") -> None:
        self._shim = shim

    def read(self, n: int) -> bytes:
        conn = self._shim._conn
        fut = asyncio.run_coroutine_threadsafe(conn.read_exactly(n),
                                               conn.core.loop)
        return fut.result()


class _HandlerShim:
    """The request object handed to route bodies on the async core.
    Duck-types the ``BaseHTTPRequestHandler`` surface the routes were
    written against (``path``/``command``/``headers``/``send_response``/
    ``send_header``/``end_headers``/``send_error``/``wfile``/``rfile``/
    ``connection``/``close_connection``/``client_address``), plus
    :meth:`send_file` for the sendfile body path. Header/status bytes
    are composed worker-side and enqueued as one blob; body chunks are
    enqueued as the caller's own memoryviews (no copies) and drained on
    the event loop under the request's QoS class."""

    protocol_version = "HTTP/1.1"

    def __init__(self, conn: "_AsyncConnection", command: str, path: str,
                 headers: _Headers, request_version: str = "HTTP/1.1"
                 ) -> None:
        self._conn = conn
        self.command = command
        self.path = path
        self.headers = headers
        self.qos = qos_for_request(command, path, headers)
        # http.server keep-alive rules: persistent only for HTTP/1.1
        # requests (an HTTP/1.0 raw-socket client relies on EOF to
        # delimit the body it asked for), and an explicit Connection
        # header always wins.
        self.close_connection = request_version != "HTTP/1.1"
        conntype = (headers.get("Connection") or "").lower()
        if conntype == "close":
            self.close_connection = True
        elif conntype == "keep-alive":
            self.close_connection = False
        self.client_address = conn.peer
        self.wfile = _ShimWFile(self)
        self.rfile = _ShimRFile(self)
        self.connection = _ShimConnection(self)
        self._status: Optional[int] = None
        self._head: List[str] = []
        self._response_started = False

    # -- response composition (worker thread) --

    def send_response(self, code: int, message: Optional[str] = None
                      ) -> None:
        if message is None:
            message = http.client.responses.get(code, "")
        self._status = code
        self._head = [f"HTTP/1.1 {code} {message}"]

    def send_header(self, key: str, value: str) -> None:
        self._head.append(f"{key}: {value}")
        if key.lower() == "connection" and value.lower() == "close":
            self.close_connection = True

    def end_headers(self) -> None:
        blob = ("\r\n".join(self._head) + "\r\n\r\n").encode("latin-1")
        self._head = []
        self._response_started = True
        self._enqueue(blob)

    def send_error(self, code: int, message: Optional[str] = None) -> None:
        # Mirrors http.server semantics the clients depend on: the
        # custom message rides the STATUS LINE reason (that is how
        # "serve window closed (commit)" reaches the healer's
        # classification), the body is bounded, and error responses
        # close the connection.
        if self._response_started:
            self.close_connection = True
            return
        if message is None:
            message = http.client.responses.get(code, "")
        body = f"error {code}: {message}\n".encode("utf-8", "replace")
        self.send_response(code, message)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.end_headers()
        if self.command != "HEAD" and code >= 200 and code not in (204,
                                                                   304):
            self._enqueue(body)
        self.close_connection = True

    def send_file(self, fobj: Any, offset: int, count: int) -> int:
        """Queue a file-backed body span for ``os.sendfile`` on the
        event loop (zero user-space copies)."""
        self._conn.enqueue_sendfile(self, fobj, offset, count)
        return count

    def _enqueue(self, data: Any) -> None:
        self._conn.enqueue(self, data)

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("transport http: " + fmt, *args)


class _AsyncConnection:
    """One accepted connection on the event loop: requests are parsed
    loop-side, handlers fold on worker threads, response bytes drain
    through a per-connection writer task that takes a QoS grant per
    chunk. An idle keep-alive connection is just a parked read — no
    thread, no buffer."""

    HIGH_WATER = 8 << 20

    def __init__(self, core: _TransportCore, server: "_AsyncHTTPServer",
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.core = core
        self.server = server
        self.reader = reader
        self.writer = writer
        self.peer = writer.get_extra_info("peername") or ("?", 0)
        self.timeout: Optional[float] = None
        self.active = False  # a request is being handled right now
        self._q: collections.deque = collections.deque()
        self._buffered = 0
        self._wcond = threading.Condition()
        self._werr: Optional[BaseException] = None
        self._wake = asyncio.Event()
        self._drained = asyncio.Event()
        self._drained.set()
        self._writer_task: Optional[asyncio.Task] = None

    # -- worker-thread side --

    def enqueue(self, shim: _HandlerShim, data: Any) -> None:
        mv = data if isinstance(data, (bytes, bytearray)) \
            else memoryview(data)
        n = len(mv)
        deadline = (time.monotonic() + self.timeout
                    if self.timeout else None)
        with self._wcond:
            while self._werr is None and self._buffered >= self.HIGH_WATER:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise socket.timeout("transport: send buffer stalled "
                                         "past send timeout")
                if not self._wcond.wait(remaining):
                    raise socket.timeout("transport: send buffer stalled "
                                         "past send timeout")
            if self._werr is not None:
                raise ConnectionError(
                    f"transport: peer connection failed: {self._werr}")
            self._q.append(("data", mv, shim.qos))
            self._buffered += n
        self.core.loop.call_soon_threadsafe(self._wake_up)

    def enqueue_sendfile(self, shim: _HandlerShim, fobj: Any,
                         offset: int, count: int) -> None:
        with self._wcond:
            if self._werr is not None:
                raise ConnectionError(
                    f"transport: peer connection failed: {self._werr}")
            self._q.append(("sendfile", (fobj, offset, count), shim.qos))
            self._buffered += count
        self.core.loop.call_soon_threadsafe(self._wake_up)

    # -- loop side --

    def _wake_up(self) -> None:
        self._wake.set()
        self._drained.clear()

    async def read_exactly(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            got = await self.reader.read(n - len(out))
            if not got:
                break
            out += got
        return bytes(out)

    async def _drain_writes(self) -> None:
        """Per-connection writer: QoS grant → transport write → drain.
        The kernel send inside never holds a handler thread; a drain
        stall past the request's send timeout fails the connection and
        surfaces in the handler as its next write's error."""
        try:
            while True:
                await self._wake.wait()
                while True:
                    with self._wcond:
                        if not self._q:
                            self._wake.clear()
                            break
                        kind, payload, qos = self._q.popleft()
                    if kind == "data":
                        await self.core.scheduler.grant(qos, len(payload))
                        self.writer.write(payload)
                        await self._drain_one(len(payload))
                    else:
                        fobj, offset, count = payload
                        await self._drain_one(0)
                        await self.core.scheduler.grant(qos, count)
                        sent = await self.core.loop.sendfile(
                            self.writer.transport, fobj, offset, count,
                            fallback=True)
                        _counters.bump("sendfile_bytes", sent)
                        with self._wcond:
                            self._buffered -= count
                            self._wcond.notify_all()
                with self._wcond:
                    empty = not self._q and self._buffered == 0
                if empty:
                    self._drained.set()
        except asyncio.CancelledError:
            self._fail(ConnectionResetError("connection closed"))
            raise
        except Exception as e:  # noqa: BLE001 — surfaces to the handler
            self._fail(e)
            self.writer.transport.abort()

    async def _drain_one(self, n: int) -> None:
        if self.timeout:
            await asyncio.wait_for(self.writer.drain(), self.timeout)
        else:
            await self.writer.drain()
        if n:
            with self._wcond:
                self._buffered -= n
                self._wcond.notify_all()

    def _fail(self, exc: BaseException) -> None:
        with self._wcond:
            if self._werr is None:
                self._werr = exc
            self._q.clear()
            self._buffered = 0
            self._wcond.notify_all()
        self._drained.set()

    async def serve(self) -> None:
        self._writer_task = self.core.loop.create_task(
            self._drain_writes())
        try:
            while True:
                # http.server parity: a handler's connection.settimeout()
                # bounds every later socket read, so an idle kept-alive
                # connection is closed after that many seconds — clients
                # doing unbounded reads rely on that EOF.
                try:
                    if self.timeout:
                        line = await asyncio.wait_for(
                            self.reader.readline(), self.timeout)
                    else:
                        line = await self.reader.readline()
                except asyncio.TimeoutError:
                    break
                if not line:
                    break
                if line in (b"\r\n", b"\n"):
                    continue
                try:
                    parts = line.decode("latin-1").split()
                    command, target = parts[0], parts[1]
                    version = parts[2] if len(parts) > 2 else "HTTP/0.9"
                except (UnicodeDecodeError, IndexError):
                    break
                headers = _Headers()
                bad = False
                while True:
                    h = await self.reader.readline()
                    if h in (b"\r\n", b"\n"):
                        break
                    if not h:
                        bad = True
                        break
                    k, sep, v = h.decode("latin-1").partition(":")
                    if sep:
                        headers[k.strip().lower()] = v.strip()
                if bad:
                    break
                shim = _HandlerShim(self, command, target, headers,
                                    request_version=version)
                _counters.bump("requests")
                self.active = True
                try:
                    await self.core.workers.submit(
                        lambda: self.server.route(shim), self.core.loop)
                except Exception:  # noqa: BLE001 — request dies alone
                    logger.exception("transport handler failed (%s %s)",
                                     command, target)
                    shim.close_connection = True
                finally:
                    self.active = False
                # call_soon_threadsafe ordering guarantees every write
                # the handler made is already queued loop-side here.
                await self._drained.wait()
                with self._wcond:
                    if self._werr is not None:
                        break
                if shim.close_connection or self.server.closing:
                    break
        finally:
            if self._writer_task is not None:
                self._writer_task.cancel()
            try:
                self.writer.close()
            except Exception:  # noqa: BLE001
                pass
            self.server.conns.discard(self)


class _AsyncHTTPServer:
    """Host handle for one HTTP tier on the shared event loop. Exposes
    the ``server_address`` / ``shutdown()`` / ``server_close()`` trio
    the tiers were already written against, so swapping the hosting
    core under them is a one-line change."""

    def __init__(self, bind_host: str, port: int,
                 route: Callable[[Any], None], name: str) -> None:
        self.route = route
        self.name = name
        self.closing = False
        self.conns: set = set()
        self.core = _TransportCore.get()
        # Bind synchronously so address conflicts raise in the caller
        # and server_address is available immediately (HTTPServer
        # parity, including SO_REUSEADDR).
        self._sock = socket.create_server((bind_host, port),
                                          family=socket.AF_INET,
                                          backlog=1024)
        self.server_address = self._sock.getsockname()
        self._aserver = asyncio.run_coroutine_threadsafe(
            self._start(), self.core.loop).result()

    async def _start(self) -> Any:
        return await asyncio.start_server(self._on_conn, sock=self._sock)

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        if self.closing:
            writer.close()
            return
        set_nodelay(writer.get_extra_info("socket"))
        _counters.bump("conns")
        conn = _AsyncConnection(self.core, self, reader, writer)
        self.conns.add(conn)
        await conn.serve()

    def shutdown(self) -> None:
        """Stop accepting; in-flight requests finish (a parked healer
        woken by the owner's shutdown still gets its 503 out), idle
        keep-alive connections drop at their next request boundary."""
        self.closing = True

        async def _stop() -> None:
            self._aserver.close()
            for conn in list(self.conns):
                # Close idle parsers (parked in readline between
                # requests — closing the transport unblocks them with
                # EOF). A connection mid-request — e.g. a parked healer
                # the owner's shutdown is about to wake with a 503 —
                # finishes its response first and exits at the request
                # boundary via `closing`.
                if not conn.active:
                    try:
                        conn.writer.close()
                    except Exception:  # noqa: BLE001
                        pass
        asyncio.run_coroutine_threadsafe(_stop(), self.core.loop).result()

    def server_close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _ThreadedHTTPHost(ThreadingHTTPServer):
    """Legacy hosting fallback (``TORCHFT_ASYNC_SERVER=0``): the same
    route body on the historical thread-per-connection core, kept for
    A/B benching the cut-over and as an escape hatch."""

    daemon_threads = True
    address_family = socket.AF_INET
    request_queue_size = 1024

    def __init__(self, bind_host: str, port: int,
                 route: Callable[[Any], None], name: str) -> None:
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Keep-alive request/response pairs: Nagle + delayed-ACK
            # stalls dominate small-exchange latency (see set_nodelay).
            disable_nagle_algorithm = True

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("transport http: " + fmt, *args)

            def do_GET(self) -> None:
                route(self)

            def do_PUT(self) -> None:
                route(self)

        super().__init__((bind_host, port), Handler)
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name=name)
        self._thread.start()


def async_hosting_enabled() -> bool:
    """Read per server start, so one process can A/B both cores."""
    return os.environ.get("TORCHFT_ASYNC_SERVER", "1") != "0"


def serve_http(bind_host: str, port: int, route: Callable[[Any], None],
               name: str) -> Any:
    """Host ``route`` (a duck-handler body dispatching on
    ``handler.command``/``handler.path``) — THE server core every HTTP
    tier calls. Returns a handle with ``server_address``, ``shutdown()``
    and ``server_close()``. Async event-loop hosting by default;
    ``TORCHFT_ASYNC_SERVER=0`` selects the legacy threaded core."""
    if not async_hosting_enabled():
        return _ThreadedHTTPHost(bind_host, port, route, name)
    return _AsyncHTTPServer(bind_host, port, route, name)


# -------------------------------------------------------------- metrics


def metrics() -> Dict[str, float]:
    """Substrate-wide counters, merged into ``Manager.metrics()`` and
    frozen in ``tests/test_metrics_schema.py``."""
    with _counters._lock:
        return {
            "transport_qos_ring_bytes_total":
                float(_counters.qos_bytes[QoS.RING]),
            "transport_qos_heal_bytes_total":
                float(_counters.qos_bytes[QoS.HEAL]),
            "transport_qos_publication_bytes_total":
                float(_counters.qos_bytes[QoS.PUBLICATION]),
            "transport_qos_demotion_bytes_total":
                float(_counters.qos_bytes[QoS.DEMOTION]),
            "transport_qos_waits_total": float(_counters.qos_waits),
            "transport_conns_total": float(_counters.conns),
            "transport_requests_total": float(_counters.requests),
            "transport_sendfile_bytes_total":
                float(_counters.sendfile_bytes),
        }


__all__ = [
    "QoS",
    "QOS_WEIGHTS",
    "QOS_HEADER",
    "QoSScheduler",
    "qos_for_request",
    "classify",
    "register_transient",
    "register_fatal",
    "looks_peer_dead",
    "chunk_spans",
    "check_bearer_auth",
    "negotiate_range",
    "serve_ranged_body",
    "serve_ranged_bytes",
    "serve_ranged_file",
    "open_url",
    "fetch_json",
    "ConnectionPool",
    "PooledResponse",
    "CountingReader",
    "PushRejectedError",
    "push_ranged",
    "note_ring_bytes",
    "mark_socket",
    "serve_http",
    "async_hosting_enabled",
    "metrics",
]
