"""Live-weight checkpoint transfer for healing.

Each worker runs a :class:`CheckpointServer`: a daemon-threaded HTTP server
streaming the **live** state pytree for ``GET /checkpoint/{step}`` — state is
produced lazily inside the request handler, no disk involved, exactly like the
reference (torchft/checkpointing.py:50-72 serving
``torch.save(state_dict())`` per request).

Consistency comes from step gating (reference ``checkpointing.py:123-144``):
the Manager opens the window with :meth:`allow_checkpoint` at step start
(while compute runs) and shuts it with :meth:`disallow_checkpoint` at commit,
so a healer can never observe a half-updated state.

TPU-native differences from the reference:

* The payload is the :mod:`torchft_tpu_torch.serialization` pytree format
  (no pickle — a malicious peer cannot execute code on the healer, unlike
  ``torch.load``), byte-identical to the JAX package's, and restore places
  each leaf on the healer's own device.
* **The donor never stalls at commit.** The reference holds its serve lock
  for the entire transfer, so ``disallow_checkpoint`` (and with it the
  donor's commit, and its training) blocks until every in-flight healer
  download finishes — up to the full send timeout
  (torchft/checkpointing.py:123-144). Here the first GET of
  a step captures an **on-device snapshot** of the state under the lock
  (``Tensor.clone`` per tensor leaf — one pass at HBM bandwidth) and
  streams from the snapshot with no lock held. The copy is what makes the
  snapshot survive the commit-time optimizer update, which writes the
  params and optimizer state IN PLACE. Commit therefore proceeds
  concurrently with any number of slow healer downloads. The price is one
  transient state-sized copy in device memory while a heal is being
  served.

* **Striped heals.** Given two or more donors serving the same step
  (``load_from_address(..., donor_addrs=)``), a healer partitions the
  missing leaves into contiguous byte-balanced stripes, one per donor,
  and fetches them concurrently; a donor that dies mid-stripe is dropped
  and only its remaining leaves move to the survivors. Every leaf
  verifies against the one adopted manifest, whoever served it.
* **Divergence quarantine.** :meth:`CheckpointServer.set_quarantined`
  makes every state-serving GET answer 503 while the owning Manager is
  under a state-attestation verdict.

The port serves heal and observability requests only: the JAX package's
publication (``/publish``) and RAM-tier (``/ramckpt``) routes and its
lock-streaming mode belong to parts not yet ported.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import urllib.parse
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

import numpy as np
import torch

from torchft_tpu_torch import chaos, transport
from torchft_tpu_torch.retry import RetryError, RetryPolicy, RetryStats
from torchft_tpu_torch.tracing import maybe_span
from torchft_tpu_torch.utils import (advertise_host, tree_flatten,
                                     tree_unflatten)
from torchft_tpu_torch.serialization import (
    _carrier,
    _from_carrier,
    _match_entries,
    _read_exact_into,
    balanced_ranges,
    device_put_like,
    manifest_from,
    plan_pytree,
)

T = TypeVar("T")
logger: logging.Logger = logging.getLogger(__name__)

MANIFEST_SUFFIX = "/manifest"
MANIFEST_FORMAT = "tft-manifest-1"
# Re-fetch budget per leaf before a digest mismatch is declared
# persistent (donor-side corruption, not corruption in transit) and the
# heal fails loudly instead of looping.
MAX_LEAF_REFETCHES = 3


class HealCorruptError(ValueError):
    """A leaf's digest mismatched on every re-fetch: the donor's copy
    itself is corrupt (or the manifest lies). Fatal — retrying the same
    donor cannot help; a failover to another donor can."""


class LeafDigestError(ValueError):
    """One or more leaves failed digest verification in transit.
    Transient: the bytes were corrupted on the wire, a re-fetch is the
    fix (bounded per leaf by ``MAX_LEAF_REFETCHES``)."""


def build_manifest(plan: Any, step: int) -> dict:
    """JSON transfer manifest for one serialized snapshot: the header's
    leaf entries (array entries annotated with ``offset``/``nbytes``
    body coordinates and a ``crc32`` content digest) plus the stream
    geometry a resuming healer needs (``preamble_len``, ``total_len``).
    Digests come from :meth:`PytreePlan.digests` — computed once per
    snapshot, cached, shared by every healer. The digest/geometry core
    is :func:`torchft_tpu.serialization.manifest_from`, shared with the
    durable on-disk checkpoint trailer
    (:mod:`torchft_tpu.checkpoint_io`)."""
    return {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        **manifest_from(plan),
    }


def _heal_endpoint(addr: str) -> str:
    """Per-donor chaos endpoint (``heal:<host:port>``): donor-kill
    faults latch a single donor dead while the ``heal`` channel's config
    and RNG stream stay shared across donors."""
    netloc = urllib.parse.urlparse(addr).netloc
    return f"heal:{netloc}" if netloc else "heal"


# Heal-domain entries in the shared classification table
# (:func:`torchft_tpu.transport.classify`): in-transit digest
# mismatches re-fetch (transient); a donor whose own copy is corrupt
# does not (fatal — failover can help, retrying cannot). The 503
# serve-window / shutting-down HTTP rule lives in the table itself.
transport.register_fatal(HealCorruptError)
transport.register_transient(LeafDigestError)


class _HealSession:
    """Cross-attempt, cross-donor state of one resumable heal transfer:
    which leaves are committed (digest-verified and placed), their
    verified digests (the cross-donor identity check), and the truthful
    byte counters. Survives transport failures and donor failovers; a
    fresh attempt re-enters at the first missing leaf."""

    def __init__(self, target: Any,
                 device_put_fn: Optional[Callable]) -> None:
        self.target = target
        self.device_put_fn = device_put_fn
        self.treedef: Any = None
        self.pairs: Optional[list] = None   # [(entry, target_leaf)]
        self.arr_order: List[int] = []      # array pair indices, body order
        self.committed: Dict[int, Any] = {}
        self.crcs: Dict[int, int] = {}      # verified crc32 per pair idx
        self.refetches: Dict[int, int] = {}
        self.preamble_len = 0
        self.total_len = 0
        self.committed_bytes = 0
        self.bytes_read = 0
        self.bytes_resumed = 0
        self.rounds = 0                     # data fetch rounds (attempts)
        self.failovers = 0
        self.digest_mismatches = 0
        # Striped mode: donors that actually landed committed leaves,
        # and the lock making commit/byte accounting safe under the
        # per-donor fetch threads (single-donor fetches never contend).
        self.donors_used: set = set()
        self.stripe_deaths = 0              # striped donors dropped dead
        self.lock = threading.Lock()
        # Persistent per-donor connections shared by every attempt of
        # this transfer: Range waves stop paying a TCP dial per span.
        self.pool = transport.ConnectionPool()
        # Optional span tracer: each Range fetch records a `heal_stripe`
        # span (the JAX package's name), so a stalled donor is visible on
        # the step timeline.
        self.tracer: Optional[Any] = None

    def span(self, stage: str, **tags: Any) -> Any:
        return maybe_span(self.tracer, stage, **tags)

    def adopt_manifest(self, mf: dict) -> None:
        """Validate a donor's manifest against the target (structure,
        shapes, dtypes — the same untrusted-header discipline as the
        byte stream) and reconcile committed progress: leaves stay
        committed iff the new manifest's digest matches the one we
        verified. A mismatch is a VIOLATION of the same-step
        bitwise-identity invariant (a heal failover to another donor of
        the same step) — loud, and counted in ``digest_mismatches``."""
        pairs, treedef = _match_entries({"leaves": mf["leaves"]},
                                        self.target)
        first = self.pairs is None
        self.pairs = pairs
        self.treedef = treedef
        self.arr_order = [i for i, (e, _) in enumerate(pairs)
                          if e["kind"] == "array"]
        self.preamble_len = int(mf["preamble_len"])
        self.total_len = int(mf["total_len"])
        if not first:
            # A fresh donor gets a fresh per-leaf refetch
            # budget: the persistent-mismatch verdict was about the OLD
            # copy. (Re-adopting the SAME manifest is the caller's to
            # avoid — it would reset the budget every round.)
            self.refetches.clear()
            for i in list(self.committed):
                entry = pairs[i][0]
                if entry["kind"] != "array":
                    continue
                want = entry.get("crc32")
                if want is not None and i in self.crcs \
                        and int(want) != self.crcs[i]:
                    logger.warning(
                        "heal: cross-donor digest mismatch on leaf %r "
                        "(had %08x, new donor claims %08x) — same-step "
                        "snapshots should be bitwise identical; "
                        "re-fetching it from the new donor",
                        entry["key"], self.crcs[i], int(want))
                    self.digest_mismatches += 1
                    del self.committed[i]
                    self.crcs.pop(i, None)
                    self.committed_bytes -= int(entry["nbytes"])
        # py leaves and zero-byte arrays commit straight off the
        # manifest — no wire bytes to wait for.
        for i, (entry, tleaf) in enumerate(pairs):
            if i in self.committed:
                continue
            if entry["kind"] == "py":
                self.committed[i] = entry["value"]
            elif int(entry["nbytes"]) == 0:
                arr = np.empty(entry["shape"], _carrier(entry["dtype"]))
                self.commit(i, arr, zlib.crc32(b""))

    def commit(self, i: int, arr: np.ndarray, crc: int,
               donor: Optional[str] = None) -> None:
        entry, tleaf = self.pairs[i]
        leaf = _from_carrier(arr, entry["dtype"])
        placed = (self.device_put_fn(leaf, tleaf)
                  if self.device_put_fn is not None else leaf)
        with self.lock:
            self.committed[i] = placed
            self.crcs[i] = crc
            self.committed_bytes += int(entry["nbytes"])
            if donor is not None:
                self.donors_used.add(donor)

    def note_bytes(self, n: int) -> None:
        with self.lock:
            self.bytes_read += n
            if self.rounds > 1:
                self.bytes_resumed += n

    def missing(self) -> List[int]:
        with self.lock:
            return [i for i in self.arr_order if i not in self.committed]

    def complete(self) -> bool:
        return (self.pairs is not None
                and len(self.committed) == len(self.pairs))

    def spans_for(self, idxs: List[int]) -> List[list]:
        """Coalesce leaf indices (body order) into contiguous ``[start,
        end, [pair indices]]`` byte spans (absolute stream offsets), one
        Range request each."""
        out: List[list] = []
        for i in idxs:
            entry = self.pairs[i][0]
            a = self.preamble_len + int(entry["offset"])
            b = a + int(entry["nbytes"])
            if out and out[-1][1] == a:
                out[-1][1] = b
                out[-1][2].append(i)
            else:
                out.append([a, b, [i]])
        return out

    def spans(self) -> List[list]:
        """Missing leaves as coalesced spans — the first attempt is a
        single span covering the whole body; later attempts cover only
        what's left."""
        return self.spans_for(self.missing())

    def stripes(self, n: int) -> List[List[int]]:
        """Partition the missing leaves into ``n`` contiguous,
        byte-balanced groups (group ``k`` for donor ``k``; may be empty
        when little is left). Contiguity keeps each donor's fetch a
        handful of coalesced Range requests instead of a shotgun of
        per-leaf ones."""
        missing = self.missing()
        sizes = [int(self.pairs[i][0]["nbytes"]) for i in missing]
        return [missing[a:b] for a, b in balanced_ranges(sizes, n)]

    def assemble(self) -> Any:
        leaves = [self.committed[i] for i in range(len(self.pairs))]
        return tree_unflatten(self.treedef, leaves)


def _snapshot_tree(tree: Any) -> Any:
    """A copy that stays valid after the commit-time update, which
    mutates params and optimizer state in place: every tensor leaf is
    cloned on its own device. numpy/scalar leaves pass by reference."""
    leaves, treedef = tree_flatten(tree)
    with torch.no_grad():
        leaves = [leaf.detach().clone() if isinstance(leaf, torch.Tensor)
                  else leaf for leaf in leaves]
    return tree_unflatten(treedef, leaves)


class CheckpointServer:
    """Serves the live state pytree to healing peers, step-gated.

    Args:
        state_fn: zero-arg callable returning the current state pytree.
            Called lazily inside the first GET handler of a step, under the
            serve lock.
        send_timeout_sec: per-socket-write timeout while streaming (bounds a
            hung healer), and the bound on how long a GET waits for a closed
            serve window to reopen.
        bind_host: interface to listen on. Default binds all interfaces
            like the reference (checkpointing.py serves 0.0.0.0); set to an
            internal/VPC address on shared networks — this server streams
            full model weights to anyone who can connect.
        bind_port: port to listen on (default 0 = OS-assigned). A churn
            replacement can pin its predecessor's port so advertised
            addresses stay dialable across the respawn.
        auth_token: when set, every GET must carry
            ``Authorization: Bearer <token>`` or is refused with 401.
            Healers send it automatically when the Manager is constructed
            with the same token (``TORCHFT_AUTH_TOKEN``).
    """

    def __init__(self, state_fn: Callable[[], T],
                 send_timeout_sec: float = 120.0,
                 bind_host: str = "0.0.0.0",
                 auth_token: Optional[str] = None,
                 bind_port: int = 0) -> None:
        self._state_fn = state_fn
        self._send_timeout_sec = send_timeout_sec
        self._auth_token = auth_token
        self._bind_host = bind_host
        # One condition guards the tiny critical sections: the step window
        # and the snapshot cache.
        self._cond = threading.Condition()
        self._allowed = True
        self._step = -1
        self._shutdown = False
        # (step, state, plan): snapshot shared by every GET of the same
        # step, so N concurrent healers cost one copy, not N.
        self._snap: Optional[Tuple[int, Any, Any]] = None
        # Attached observability exports (torchft_tpu.tracing,
        # docs/design/observability.md): GET /trace.json (Chrome trace
        # events from the span ring) and GET /metrics (Prometheus text
        # exposition) on the same socket + auth gate. Snapshot reads of
        # immutable/locked state — like /publish, never step-gated.
        self._obs: Optional[Dict[str, Any]] = None
        # Divergence-verdict serve gate (set_quarantined): while set,
        # every state-serving GET answers 503.
        self._quarantined = False

        # Host on the transport substrate's shared server core (async
        # event loop by default, TORCHFT_ASYNC_SERVER=0 for the legacy
        # threaded host) — the route body below is the same on either.
        self._server = transport.serve_http(bind_host, bind_port,
                                            self._route,
                                            name="checkpoint-server")
        # A fresh server at this address is a REBIRTH for the chaos kill
        # latches: a churn replacement reusing a dead member's host:port
        # must not inherit the corpse's dead latch (chaos.endpoint_reborn
        # is a no-op without an active schedule).
        netloc = urllib.parse.urlparse(self.address()).netloc
        if netloc:
            chaos.endpoint_reborn(f"heal:{netloc}", f"serve:{netloc}",
                                  f"ram:{netloc}")

    def _route(self, handler: Any) -> None:
        """One request on the substrate core (GET heal/manifest/
        observability). Keep-alive:
        healers and weight subscribers reuse one connection across Range
        waves (``transport.ConnectionPool``); every response path sends
        Content-Length, which HTTP/1.1 persistence requires."""
        if handler.command != "GET":
            handler.send_error(501, "Unsupported method "
                               f"({handler.command!r})")
            return
        if not transport.check_bearer_auth(handler, self._auth_token):
            return
        if handler.path.split("?", 1)[0].rstrip("/") in (
                "/trace.json", "/metrics"):
            if self._shutdown:
                handler.close_connection = True
                return
            self._serve_observability(handler)
            return
        if self._quarantined:
            # Divergence verdict latched on the owning Manager: every
            # byte this server could hand out came from state the fleet
            # voted divergent. Refuse hard — a peer holding our cached
            # address rotates to an attested donor — while observability
            # above stays up for the operator reading the verdict.
            handler.send_error(503, "quarantined (divergence verdict)")
            return
        prefix = "/checkpoint/"
        if not handler.path.startswith(prefix):
            handler.send_error(404, "unknown path")
            return
        path = handler.path
        want_manifest = path.endswith(MANIFEST_SUFFIX)
        if want_manifest:
            path = path[:-len(MANIFEST_SUFFIX)]
        try:
            req_step = int(path[len(prefix):])
        except ValueError:
            handler.send_error(400, "bad step")
            return
        deadline = time.monotonic() + self._send_timeout_sec
        with self._cond:
            # A closed window (commit in progress) reopens at the
            # next step start; park briefly rather than bouncing
            # the healer (the reference blocks here too, on its
            # held lock).
            while not self._allowed and not self._shutdown:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    handler.send_error(
                        503, "serve window closed (commit)")
                    return
                self._cond.wait(timeout=remaining)
            if self._shutdown:
                handler.send_error(503, "shutting down")
                return
            if req_step != self._step:
                handler.send_error(
                    400,
                    f"invalid checkpoint requested: serving "
                    f"{self._step} but got {req_step}")
                return
            try:
                state, plan = self._capture_locked()
            except Exception as e:  # surface to healer, keep serving
                logger.exception("checkpoint state capture failed")
                handler.send_error(500, str(e))
                return
        # Stream OUTSIDE the lock: the snapshot is immutable, so a
        # slow healer never delays the donor's commit. Leaf-by-leaf:
        # total length is known from the plan before any device data
        # is fetched, so the response carries Content-Length yet
        # never holds more than one leaf + one chunk in host RAM;
        # socket-write backpressure paces the device_get fetches.
        if want_manifest:
            # Digest pass runs outside the serve lock too (the snapshot
            # is immutable); computed once per snapshot, shared by every
            # healer and attempt.
            body = json.dumps(build_manifest(plan, req_step)).encode()
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.connection.settimeout(self._send_timeout_sec)
            handler.wfile.write(body)
            return
        # Once the status line is committed, a device-to-host failure
        # mid-stream can only short-close the socket (healer sees
        # "truncated"), so log the real cause here.
        try:
            transport.serve_ranged_body(handler, state, plan,
                                        self._send_timeout_sec)
        except Exception:
            logger.exception("checkpoint stream failed mid-transfer "
                             "(healer will see a truncated stream)")
            raise

    def set_quarantined(self, flag: bool) -> None:
        """Sticky divergence-verdict serve gate: while set, every
        state-serving GET (``/checkpoint/*``) refuses with 503, so a peer
        that cached this server's address cannot fetch bytes the fleet
        voted divergent. Cleared when the lighthouse confirms the
        re-attested digest (the Manager's verdict-clear path)."""
        with self._cond:
            self._quarantined = bool(flag)
            self._cond.notify_all()

    def _capture_locked(self) -> Tuple[Any, Any]:
        """State + plan to stream for the current step. Requires _cond held.

        ONE ``(state, plan)`` pair is cached per serve window and shared by
        every manifest/Range request of the step, so healers share one
        :class:`~torchft_tpu_torch.serialization.PytreePlan` and its
        once-computed digests. The first GET of the step copies the state
        (see module docstring)."""
        if self._snap is None or self._snap[0] != self._step:
            state = _snapshot_tree(self._state_fn())
            self._snap = (self._step, state, plan_pytree(state))
        return self._snap[1], self._snap[2]

    def address(self) -> str:
        """Dialable HTTP URL for the current step's checkpoint. When bound
        to a specific interface, that address is what peers can actually
        reach — advertising the hostname's primary interface would hand
        healers a connection-refused URL."""
        port = self._server.server_address[1]
        host = (self._bind_host
                if self._bind_host not in ("", "0.0.0.0", "::")
                else advertise_host())
        if ":" in host:  # bare IPv6 literals need brackets in URLs
            host = f"[{host}]"
        return f"http://{host}:{port}/checkpoint/{self._step}"

    def attach_observability(self, tracer: Any = None,
                             metrics_fn: Optional[Callable[[], Dict]]
                             = None,
                             info_fn: Optional[Callable[[], Dict]]
                             = None,
                             labels: Optional[Dict[str, str]]
                             = None) -> None:
        """Attach the observability exports
        (docs/design/observability.md): ``tracer`` (a
        :class:`torchft_tpu.tracing.Tracer`) backs ``GET
        /trace.json?steps=K`` — the span ring of the last K steps in
        Chrome trace-event format, Perfetto-loadable and the fleet
        merger's input — and ``metrics_fn``/``info_fn`` (the Manager's
        ``metrics``/``metrics_info``) back ``GET /metrics``, Prometheus
        text exposition with ``labels`` on every sample. The Manager
        attaches its own at construction."""
        self._obs = {"tracer": tracer, "metrics_fn": metrics_fn,
                     "info_fn": info_fn, "labels": dict(labels or {})}

    def _serve_observability(self, handler: Any) -> None:
        """Serve one /trace.json or /metrics GET (auth already
        checked). Snapshot reads only — never step-gated, never blocks
        a commit."""
        from torchft_tpu_torch import tracing as tracing_mod

        obs = self._obs
        path, _, query = handler.path.partition("?")
        path = path.rstrip("/")
        try:
            if path == "/trace.json":
                tracer = obs.get("tracer") if obs else None
                if tracer is None:
                    handler.send_error(404, "no tracer attached")
                    return
                qs = urllib.parse.parse_qs(query)
                steps = None
                if "steps" in qs:
                    # 400 only for the client's parse error — a
                    # ValueError from deeper (a metrics/trace snapshot
                    # racing shutdown) must stay a logged 500, not be
                    # misattributed to the request.
                    try:
                        steps = max(int(qs["steps"][0]), 1)
                    except ValueError:
                        handler.send_error(400, "bad steps parameter")
                        return
                # default=str: span tags are open-ended; an exotic tag
                # value degrades to its repr instead of a 500.
                body = json.dumps(tracer.chrome_trace(steps),
                                  default=str).encode()
                ctype = "application/json"
            else:  # /metrics
                metrics_fn = obs.get("metrics_fn") if obs else None
                if metrics_fn is None:
                    handler.send_error(404, "no metrics attached")
                    return
                info_fn = obs.get("info_fn")
                body = tracing_mod.prometheus_text(
                    metrics_fn(),
                    info_fn() if info_fn is not None else None,
                    obs.get("labels")).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
        except Exception as e:  # noqa: BLE001 — surface, keep serving
            logger.exception("observability endpoint failed")
            handler.send_error(500, str(e))
            return
        handler.send_response(200)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.connection.settimeout(self._send_timeout_sec)
        handler.wfile.write(body)

    def allow_checkpoint(self, step: int) -> None:
        """Open the serve window for ``step`` (called at step start, while
        the forward/backward runs — the state is still the pre-update
        one)."""
        with self._cond:
            self._step = step
            # Drop a stale-step snapshot (in-flight streams keep their own
            # references; this only frees the cache).
            if self._snap is not None and self._snap[0] != step:
                self._snap = None
            self._allowed = True
            self._cond.notify_all()

    def disallow_checkpoint(self) -> None:
        """Shut the serve window (called at commit). Returns at once:
        in-flight streams serve their immutable snapshot, so commit can
        update the live state concurrently."""
        with self._cond:
            self._allowed = False
            self._snap = None

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()

    @classmethod
    def load_from_address(cls, address: str, target: T,
                          timeout_sec: float = 300.0,
                          device_put: bool = True,
                          stats: Optional[dict] = None,
                          auth_token: Optional[str] = None,
                          retry_policy: Optional[RetryPolicy] = None,
                          retry_stats: Optional[RetryStats] = None,
                          stall_timeout_sec: Optional[float] = None,
                          donors: Optional[Callable[[int], Optional[str]]]
                          = None,
                          max_donor_failovers: int = 3,
                          donor_addrs: Optional[List[str]] = None,
                          stripe_seed: Optional[int] = None,
                          progress_cb: Optional[Callable[[int, int], None]]
                          = None,
                          tracer: Optional[Any] = None) -> T:
        """Fetch a peer's live checkpoint and restore it into ``target``'s
        structure (on the target leaves' devices, when ``device_put``).
        Streams: each leaf is read off the socket into a preallocated
        buffer, digest-verified against the donor's manifest, and only
        then placed — corrupt or truncated bytes never reach the device.

        The transfer is RESUMABLE: the donor's ``/manifest`` endpoint
        describes the stream (per-leaf offsets + crc32 digests), and each
        fetch uses HTTP ``Range`` to re-enter at the first unverified
        leaf, so a transport failure costs O(remaining), not O(state).
        Transient failures (resets, truncation, a 503 while the donor's
        serve window is closed at commit) retry under ``retry_policy``
        with backoff — and because progress is durable, the attempt
        budget bounds *consecutive zero-progress* failures, not total
        failures, so a huge transfer that keeps advancing is never killed
        by an arbitrary deadline. Step/auth refusals (400/401) stay
        fatal.

        Liveness comes from a stall watchdog, not a wall clock:
        ``stall_timeout_sec`` bounds how long any single socket operation
        may sit with no bytes arriving (default: ``timeout_sec``). A
        black-holed stream dies in seconds; a slow but moving stream runs
        forever.

        ``donors``, when given, enables DONOR FAILOVER: when the current
        donor is classified dead (connection refused — its server socket
        is gone — or a persistently corrupt leaf, or the zero-progress
        budget is exhausted), ``donors(failover_index)`` is asked for a
        fresh data URL and the SAME transfer continues there — committed
        leaves are kept iff the new donor's manifest digests match what
        was already verified, which is the runtime check of the
        same-step-snapshots-are-bitwise-identical invariant.

        ``donor_addrs``, when it names two or more live donors serving
        the SAME step, enables the striped fetch: the missing leaves are
        partitioned into contiguous byte-balanced stripes, one per
        donor, fetched concurrently; every leaf still digest-verifies
        against the one adopted manifest, which is what makes mixing
        donors sound. A donor that dies mid-stripe is dropped and only
        its REMAINING stripe is reassigned to the survivors on the next
        round (``bytes_resumed`` counts exactly that traffic); when the
        whole set dies the ``donors`` failover resolver above is the last
        resort. ``stripe_seed`` deterministically shuffles the donor
        order, as the JAX package's ``random.Random(seed)`` does, so
        concurrent healers spread their load.

        ``stats``, when given, is filled with truthful counters:
        ``bytes`` (payload bytes actually read off the wire, across all
        attempts — NOT the donor's Content-Length claim),
        ``payload_bytes`` (full serialized size), ``bytes_resumed``
        (bytes fetched by resumed attempts after the first),
        ``donor_failovers``, ``digest_mismatches``, ``attempts``,
        ``donors_used`` and ``stripe_donor_deaths`` — filled on failure
        too, so a FAILED heal's wire cost and attempt history still reach
        the caller's metrics.
        ``progress_cb(bytes_committed, payload_bytes)`` fires after every
        verified leaf. Chaos injection uses per-donor endpoints
        ``heal:<host:port>`` (channel ``heal``)."""
        logger.info("fetching checkpoint from %s", address)
        t0 = time.perf_counter()
        pol = (retry_policy if retry_policy is not None
               else RetryPolicy(max_attempts=1))
        stall = (stall_timeout_sec if stall_timeout_sec is not None
                 else timeout_sec)
        deadline = (t0 + pol.overall_deadline_ms / 1e3
                    if pol.overall_deadline_ms > 0 else None)
        session = _HealSession(target,
                               device_put_like if device_put else None)
        session.tracer = tracer
        # Striped donor set: seed-shuffled so concurrent healers spread
        # their first streams; the quorum's primary rides along
        # (deduped) as one donor among equals.
        stripe: List[str] = []
        if donor_addrs:
            stripe = list(dict.fromkeys(list(donor_addrs) + [address]))
            if len(stripe) >= 2:
                random.Random(stripe_seed).shuffle(stripe)
                address = stripe[0]
            else:
                stripe = []
        try:
            out = cls._run_heal_loop(
                session, address, stall, auth_token, pol, deadline,
                donors, max_donor_failovers, progress_cb, retry_stats,
                stripe=stripe)
        finally:
            # Fill stats on BOTH outcomes: a failed heal's wire cost,
            # attempts, and failovers are what a "heal keeps failing"
            # diagnosis reads.
            if stats is not None:
                stats["bytes"] = float(session.bytes_read)
                stats["payload_bytes"] = float(session.total_len)
                stats["bytes_resumed"] = float(session.bytes_resumed)
                stats["donor_failovers"] = float(session.failovers)
                stats["digest_mismatches"] = float(
                    session.digest_mismatches)
                stats["attempts"] = float(session.rounds)
                stats["donors_used"] = float(
                    max(len(session.donors_used), 1))
                stats["stripe_donor_deaths"] = float(
                    session.stripe_deaths)
                stats["redials_avoided"] = float(
                    session.pool.redials_avoided)
            session.pool.close()
        dt = time.perf_counter() - t0
        logger.info(
            "checkpoint transfer: %.1f MB in %.2fs (%.0f MB/s; "
            "%d attempt(s), %d donor(s), %.1f MB resumed, "
            "%d failover(s), %d digest mismatch(es))",
            session.bytes_read / 1e6, dt,
            session.bytes_read / 1e6 / max(dt, 1e-9), session.rounds,
            max(len(session.donors_used), 1),
            session.bytes_resumed / 1e6, session.failovers,
            session.digest_mismatches)
        return out

    @classmethod
    def _run_heal_loop(cls, session: "_HealSession", addr: str,
                       stall: float, auth_token: Optional[str],
                       pol: RetryPolicy, deadline: Optional[float],
                       donors: Optional[Callable[[int], Optional[str]]],
                       max_donor_failovers: int,
                       progress_cb: Optional[Callable[[int, int], None]],
                       retry_stats: Optional[RetryStats],
                       stripe: Optional[List[str]] = None) -> Any:
        stripe = stripe if stripe is not None else []
        endpoint = _heal_endpoint(addr)
        attempts = max(int(pol.max_attempts), 1)
        no_progress = 0
        need_manifest = True
        while True:
            if stripe and addr not in stripe:
                # The striped wave dropped the manifest donor as dead;
                # the SAME transfer continues against the survivors.
                addr = stripe[0]
                endpoint = _heal_endpoint(addr)
            marker = len(session.committed)
            try:
                if need_manifest:
                    session.adopt_manifest(cls._fetch_manifest(
                        addr, stall, auth_token, endpoint,
                        pool=session.pool))
                    need_manifest = False
                if not session.complete():
                    session.rounds += 1
                    if len(stripe) > 1:
                        cls._fetch_striped(session, stripe, stall,
                                           auth_token, progress_cb)
                    else:
                        for span in session.spans():
                            cls._fetch_span(addr, session, span, stall,
                                            auth_token, endpoint,
                                            progress_cb)
                if session.complete():
                    return session.assemble()
                # Remaining leaves either mismatched their digest
                # (corruption in transit — bounded per leaf by
                # MAX_LEAF_REFETCHES inside _fetch_span) or rode a
                # striped donor that died mid-wave: transient either
                # way, the next round re-spans only what's left.
                raise LeafDigestError(
                    f"{len(session.missing())} leaves still missing "
                    "after this round (digest mismatch or dropped "
                    "striped donor); re-fetching")
            except Exception as e:  # noqa: BLE001 — classified below
                transient = transport.classify(e)
                dead = (isinstance(e, HealCorruptError)
                        or transport.looks_peer_dead(e))
                if not transient and not dead:
                    raise
                if len(session.committed) > marker:
                    no_progress = 0
                else:
                    no_progress += 1
                if dead and getattr(e, "_heal_striped_handled", False) \
                        and stripe:
                    # A striped wave already evicted the donor(s) that
                    # actually died — `addr` may well be a healthy
                    # survivor (the exception belongs to ANOTHER donor's
                    # thread). Re-stripe over the survivors; the loop
                    # head re-targets if addr was the victim.
                    no_progress = 0
                    continue
                if dead and addr in stripe and len(stripe) > 1:
                    # A striped peer remains: drop the dead donor and
                    # reassign its stripe instead of burning a failover
                    # (the failover resolver stays the LAST resort, for
                    # when the whole advertised set is gone).
                    stripe.remove(addr)
                    with session.lock:
                        session.stripe_deaths += 1
                    logger.warning(
                        "heal: striped donor %s dead (%s); continuing "
                        "with %d survivor(s)", addr, e, len(stripe))
                    no_progress = 0
                    continue
                if ((dead or no_progress >= attempts)
                        and donors is not None
                        and session.failovers < max_donor_failovers):
                    nxt: Optional[str] = None
                    try:
                        nxt = donors(session.failovers)
                    except Exception:  # noqa: BLE001
                        logger.exception("heal: donor resolver failed")
                    if nxt:
                        logger.warning(
                            "heal: donor %s unusable (%s); failing over "
                            "to %s with %d/%d leaves committed", addr, e,
                            nxt, len(session.committed),
                            len(session.pairs or ()))
                        session.failovers += 1
                        addr = nxt
                        endpoint = _heal_endpoint(addr)
                        # The advertised stripe set is spent — the
                        # resolver's donor is authoritative now, and a
                        # stale stripe entry must not re-capture addr at
                        # the top of the loop.
                        stripe.clear()
                        need_manifest = True
                        no_progress = 0
                        continue
                if not transient or no_progress >= attempts:
                    if retry_stats is not None and no_progress > 0:
                        retry_stats.record_giveup()
                    raise
                delay = pol.delay_ms(min(max(no_progress - 1, 0), 16)) / 1e3
                if (deadline is not None
                        and time.perf_counter() + delay > deadline):
                    if retry_stats is not None:
                        retry_stats.record_giveup()
                    raise RetryError(
                        f"heal.fetch: overall retry deadline "
                        f"({pol.overall_deadline_ms:.0f}ms) exhausted"
                    ) from e
                if retry_stats is not None:
                    retry_stats.record_retry(delay * 1e3)
                logger.warning(
                    "heal fetch attempt failed (%s); retrying from "
                    "%d/%d committed leaves", e, len(session.committed),
                    len(session.pairs or ()))
                time.sleep(delay)

    @staticmethod
    def _fetch_manifest(addr: str, stall: float,
                        auth_token: Optional[str], endpoint: str,
                        pool: Optional[transport.ConnectionPool] = None
                        ) -> dict:
        """GET the donor's transfer manifest."""
        tok = chaos.begin(endpoint, "manifest")
        resp = transport.open_url(addr + MANIFEST_SUFFIX, stall, auth_token,
                                  pool=pool)
        with resp:
            # Read to EOF in bounded pieces: a single read(-1) could be
            # truncated by the chaos kill clamp (or a flaky transport)
            # and then fail as a confusing JSON parse error — looping
            # lets the truncation surface as the transport error it is,
            # and a short body below is checked against Content-Length.
            reader = chaos.wrap_reader(resp, endpoint)
            want = int(resp.headers.get("Content-Length", -1))
            parts = []
            while True:
                piece = reader.read(65536)
                if not piece:
                    break
                parts.append(piece)
            body = b"".join(parts)
            if 0 <= want != len(body):
                raise ValueError("truncated checkpoint manifest")
        chaos.end(tok)
        mf = json.loads(body)
        if mf.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"invalid checkpoint manifest format {mf.get('format')!r}")
        return mf

    @staticmethod
    def _fetch_span(addr: str, session: "_HealSession", span: list,
                    stall: float, auth_token: Optional[str], endpoint: str,
                    progress_cb: Optional[Callable[[int, int], None]]
                    ) -> None:
        """Fetch one contiguous byte span of missing leaves via an HTTP
        Range request; verify + commit each leaf as it lands. Raises on
        transport failure (committed leaves are retained by the session)
        and :class:`HealCorruptError` when a leaf keeps mismatching.
        Requests ride the session's persistent per-donor connection
        pool. Each fetch records a ``heal_stripe`` trace span tagged with
        its donor (a failing fetch's span carries the error)."""
        a, b, idxs = span
        with session.span("heal_stripe", donor=addr, leaves=len(idxs),
                          bytes=b - a):
            tok = chaos.begin(endpoint, "fetch")
            resp = transport.open_url(
                addr, stall, auth_token,
                headers={"Range": f"bytes={a}-{b - 1}"}, pool=session.pool)
            counter = [0]
            try:
                reader = transport.CountingReader(
                    chaos.wrap_reader(resp, endpoint), counter)
                status = getattr(resp, "status", None) or resp.getcode()
                if status == 200 and a > 0:
                    # Server ignored Range: discard the prefix. The
                    # discarded bytes are still counted — they really
                    # crossed the wire.
                    remaining = a
                    while remaining > 0:
                        chunk = reader.read(min(1 << 20, remaining))
                        if not chunk:
                            raise ValueError("truncated checkpoint stream")
                        remaining -= len(chunk)
                for i in idxs:
                    entry, _ = session.pairs[i]
                    arr = np.empty(entry["shape"], _carrier(entry["dtype"]))
                    mv = arr.reshape(-1).view(np.uint8).data
                    _read_exact_into(reader, mv)
                    crc = zlib.crc32(mv)
                    if "crc32" in entry and crc != int(entry["crc32"]):
                        with session.lock:
                            session.digest_mismatches += 1
                            n = session.refetches[i] = \
                                session.refetches.get(i, 0) + 1
                        logger.warning(
                            "heal: leaf %r digest mismatch "
                            "(got %08x, manifest %08x; refetch %d/%d)",
                            entry["key"], crc, int(entry["crc32"]), n,
                            MAX_LEAF_REFETCHES)
                        if n >= MAX_LEAF_REFETCHES:
                            raise HealCorruptError(
                                f"leaf {entry['key']!r} failed digest "
                                f"verification {n} times; the donor's "
                                "copy is corrupt")
                        continue  # stays missing; next round re-spans it
                    session.commit(i, arr, crc, donor=addr)
                    if progress_cb is not None:
                        progress_cb(session.committed_bytes,
                                    session.total_len)
            finally:
                resp.close()
                session.note_bytes(counter[0])
            chaos.end(tok)

    @classmethod
    def _fetch_striped(cls, session: "_HealSession", stripe: List[str],
                       stall: float, auth_token: Optional[str],
                       progress_cb: Optional[Callable[[int, int], None]]
                       ) -> None:
        """One striped wave: partition the missing leaves into
        contiguous byte-balanced stripes, one per live donor, and fetch
        them CONCURRENTLY (one thread per donor; each stripe collapses
        to a handful of coalesced Range requests). Every leaf verifies
        against the one adopted manifest regardless of which donor
        served it.

        Donors whose thread fails DEAD (refused dial, persistently
        corrupt copy) are removed from ``stripe`` in place, so the next
        wave re-partitions only the remaining bytes over the survivors.
        Raises only when NO leaf landed this wave (all donors failed) —
        a partial wave returns so the caller's progress accounting
        resets the retry budget and re-stripes the remainder."""
        groups = session.stripes(len(stripe))
        before = len(session.committed)
        failures: List[Tuple[str, BaseException]] = []
        flock = threading.Lock()

        def fetch(donor: str, idxs: List[int]) -> None:
            try:
                for span in session.spans_for(idxs):
                    cls._fetch_span(donor, session, span, stall,
                                    auth_token, _heal_endpoint(donor),
                                    progress_cb)
            except BaseException as e:  # noqa: BLE001 — classified below
                with flock:
                    failures.append((donor, e))

        threads = [
            threading.Thread(target=fetch, args=(donor, idxs),
                             name=f"heal-stripe-{k}", daemon=True)
            for k, (donor, idxs) in enumerate(zip(stripe, groups))
            if idxs
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        primary_exc: Optional[BaseException] = None
        for donor, e in failures:
            if (isinstance(e, HealCorruptError)
                    or transport.looks_peer_dead(e)) \
                    and donor in stripe and len(stripe) > 1:
                stripe.remove(donor)
                with session.lock:
                    session.stripe_deaths += 1
                logger.warning(
                    "heal: striped donor %s died mid-stripe (%s); its "
                    "remaining leaves reassign to %d survivor(s)",
                    donor, e, len(stripe))
            if primary_exc is None or donor == stripe[0]:
                primary_exc = e
        if failures and len(session.committed) == before:
            # Dead donors were already evicted above — flag that so the
            # caller's own eviction branch doesn't blame the CURRENT
            # manifest donor for a different donor's death.
            primary_exc._heal_striped_handled = True  # noqa: SLF001
            raise primary_exc  # zero-progress wave: let the caller classify
