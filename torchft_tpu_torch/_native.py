"""ctypes bridge to the C++ control plane (``torchft_tpu_torch/_core``).

Plays the role of the reference's pyo3 bridge: exposes embeddable
:class:`Lighthouse` and :class:`ManagerServer` servers, a blocking
:class:`ManagerClient` (``quorum`` / ``checkpoint_address`` /
``should_commit`` / ``kill``), and the KV :class:`Store` used for rendezvous
(the TCPStore analogue). ctypes releases the GIL for every foreign call.

The C++ sources under ``_core/`` are a verbatim copy of the JAX package's
control plane, except ``lighthouse.cc`` and ``lighthouse.h``: they carry
``_core/patches/fast_path_quorum.patch`` and ``fast_path_quorum_h.patch``,
under which the quorum fast path answers only once every member has asked
at the asker's step, and every member of a round reads the decision that
round was given, so that no group counts fewer participants than its
peers. The shared library is built from them with ``g++`` at first
use into ``torchft_tpu_torch/_build/core/`` (never in the source tree),
under an inter-process file lock so concurrent processes build once. The
message classes the core includes as ``torchft.pb.h`` are generated from
``_core/proto/torchft.proto`` by :mod:`._protogen`, with protobuf's wire
format and no protobuf runtime, so the build needs no protobuf
installation. The library's name carries a hash of its inputs, so an
edited source is never served by a stale build.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Optional

from torchft_tpu_torch import _protogen as protogen
from torchft_tpu_torch import chaos
from torchft_tpu_torch._build_util import BUILD_DIR, build_lock, digest
from torchft_tpu_torch.retry import RetryPolicy, RetryStats, call_with_retry

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CORE_DIR = os.path.join(_PKG_DIR, "_core")
_SOURCES = ("rpc.cc", "store.cc", "lighthouse.cc", "manager.cc", "capi.cc")
_PROTO = os.path.join(_CORE_DIR, "proto", "torchft.proto")


def _inputs() -> list:
    names = sorted(n for n in os.listdir(_CORE_DIR)
                   if n.endswith((".cc", ".h")))
    return ([os.path.join(_CORE_DIR, n) for n in names]
            + [_PROTO, protogen.__file__])


def _build_native(out_dir: str, out: str) -> None:
    """Generate ``torchft.pb.h``, then one g++ per translation unit, all
    started together, then one link."""
    gen_dir = os.path.join(out_dir, "obj")
    os.makedirs(gen_dir, exist_ok=True)
    with open(_PROTO) as f:
        header = protogen.generate(f.read())
    with open(os.path.join(gen_dir, "torchft.pb.h"), "w") as f:
        f.write(header)
    flags = ["-std=c++17", "-O2", "-fPIC", "-I", _CORE_DIR, "-I", gen_dir]
    srcs = [os.path.join(_CORE_DIR, s) for s in _SOURCES]
    objs = [os.path.join(gen_dir, os.path.basename(s) + ".o") for s in srcs]
    procs = [subprocess.Popen(["g++", *flags, "-c", s, "-o", o],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    for s, proc in zip(srcs, procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {s}:\n{log}")
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", "-shared", "-o", tmp, *objs, "-pthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"linking the core failed:\n{proc.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(gen_dir)


def library_path() -> str:
    """Path of the built control-plane library, building it if needed."""
    out_dir = os.path.join(BUILD_DIR, "core")
    out = os.path.join(out_dir,
                       f"libtorchft_tpu_core-{digest(_inputs())}.so")
    if not os.path.exists(out):
        with build_lock(out_dir):
            if not os.path.exists(out):
                _build_native(out_dir, out)
    return out


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path())

    c = ctypes.c_char_p
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    i32 = ctypes.c_int32

    lib.tft_free.argtypes = [vp]
    lib.tft_free.restype = None

    lib.tft_lighthouse_new.argtypes = [c, u64, i64, i64, i64, i64, i64, c,
                                       i32, c, i64, i64, c,
                                       ctypes.POINTER(vp)]
    lib.tft_lighthouse_new.restype = vp
    lib.tft_lighthouse_address.argtypes = [vp]
    lib.tft_lighthouse_address.restype = vp
    lib.tft_lighthouse_shutdown.argtypes = [vp]
    lib.tft_lighthouse_free.argtypes = [vp]

    lib.tft_manager_new.argtypes = [c, c, c, c, u64, i64, c,
                                    ctypes.POINTER(vp)]
    lib.tft_manager_new.restype = vp
    lib.tft_manager_address.argtypes = [vp]
    lib.tft_manager_address.restype = vp
    lib.tft_manager_shutdown.argtypes = [vp]
    lib.tft_manager_free.argtypes = [vp]
    lib.tft_manager_set_status.argtypes = [vp, c, i64, i64, i64]
    lib.tft_manager_set_status.restype = None
    dbl = ctypes.c_double
    lib.tft_manager_set_digest.argtypes = [
        vp, i64, dbl, dbl, dbl, dbl, dbl, dbl, dbl, i64, dbl, dbl, i32,
        dbl, dbl, c, i64, c, dbl]
    lib.tft_manager_set_digest.restype = None
    lib.tft_manager_farewell.argtypes = [vp]
    lib.tft_manager_farewell.restype = None
    lib.tft_manager_hard_stop.argtypes = [vp]
    lib.tft_manager_hard_stop.restype = None
    lib.tft_manager_lighthouse_redials.argtypes = [vp]
    lib.tft_manager_lighthouse_redials.restype = i64
    lib.tft_manager_lighthouse_addr.argtypes = [vp]
    lib.tft_manager_lighthouse_addr.restype = vp

    lib.tft_store_new.argtypes = [c, ctypes.POINTER(vp)]
    lib.tft_store_new.restype = vp
    lib.tft_store_address.argtypes = [vp]
    lib.tft_store_address.restype = vp
    lib.tft_store_shutdown.argtypes = [vp]
    lib.tft_store_free.argtypes = [vp]

    lib.tft_store_client_new.argtypes = [c, i64, ctypes.POINTER(vp)]
    lib.tft_store_client_new.restype = vp
    lib.tft_store_client_set.argtypes = [vp, c, c, ctypes.c_size_t,
                                         ctypes.POINTER(vp)]
    lib.tft_store_client_set.restype = i32
    lib.tft_store_client_get.argtypes = [
        vp, c, i64, ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(vp)]
    lib.tft_store_client_get.restype = i32
    lib.tft_store_client_free.argtypes = [vp]

    lib.tft_manager_client_new.argtypes = [c, i64, ctypes.POINTER(vp)]
    lib.tft_manager_client_new.restype = vp
    lib.tft_manager_client_quorum.argtypes = [
        vp, i64, i64, c, i64, ctypes.POINTER(_CQuorumResult),
        ctypes.POINTER(vp)]
    lib.tft_manager_client_quorum.restype = i32
    lib.tft_manager_client_checkpoint_address.argtypes = [
        vp, i64, i64, ctypes.POINTER(vp), ctypes.POINTER(vp)]
    lib.tft_manager_client_checkpoint_address.restype = i32
    lib.tft_manager_client_should_commit.argtypes = [
        vp, i64, i64, i32, i64, ctypes.POINTER(i32), ctypes.POINTER(vp)]
    lib.tft_manager_client_should_commit.restype = i32
    lib.tft_manager_client_kill.argtypes = [vp, c, ctypes.POINTER(vp)]
    lib.tft_manager_client_kill.restype = i32
    lib.tft_manager_client_free.argtypes = [vp]

    lib.tft_lighthouse_client_status.argtypes = [c, i64, ctypes.POINTER(vp),
                                                 ctypes.POINTER(vp)]
    lib.tft_lighthouse_client_status.restype = i32
    return lib


class _CQuorumResult(ctypes.Structure):
    _fields_ = [
        ("quorum_id", ctypes.c_int64),
        ("recover_manager_address", ctypes.c_void_p),
        ("store_address", ctypes.c_void_p),
        ("max_step", ctypes.c_int64),
        ("has_max_rank", ctypes.c_int32),
        ("max_rank", ctypes.c_int64),
        ("max_world_size", ctypes.c_int64),
        ("replica_rank", ctypes.c_int64),
        ("replica_world_size", ctypes.c_int64),
        ("heal", ctypes.c_int32),
        ("fast_path", ctypes.c_int32),
        ("epoch", ctypes.c_int64),
        # Fleet health hint (docs/design/fleet_health.md) — must mirror
        # capi.cc's TftQuorumResult layout exactly.
        ("fleet_p50_ms", ctypes.c_double),
        ("fleet_p95_ms", ctypes.c_double),
        ("fleet_max_ms", ctypes.c_double),
        ("fleet_groups", ctypes.c_int64),
        ("straggler_score", ctypes.c_double),
        ("straggler_stage", ctypes.c_void_p),
        ("straggler_id", ctypes.c_void_p),
        ("slo_breach", ctypes.c_void_p),
        # State attestation verdict (docs/design/state_attestation.md).
        ("sdc_diverged", ctypes.c_int32),
        ("sdc_quarantined", ctypes.c_void_p),
        ("sdc_quarantined_addrs", ctypes.c_void_p),
        # Fleet rebalance hint (docs/design/fleet_rebalance.md).
        ("rebalance_fraction", ctypes.c_double),
        ("rebalance_table", ctypes.c_void_p),
        ("rebalance_seq", ctypes.c_int64),
    ]


_lib: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


class NativeError(RuntimeError):
    """An error surfaced from the C++ control plane (incl. transport errors)."""


def _take_str(p: int) -> str:
    try:
        return ctypes.string_at(p).decode()
    finally:
        lib().tft_free(p)


def _check(rc: int, err: ctypes.c_void_p) -> None:
    if rc != 0:
        msg = _take_str(err.value) if err.value else "unknown native error"
        raise NativeError(msg)


def _check_handle(h, err: ctypes.c_void_p):
    if not h:
        msg = _take_str(err.value) if err.value else "unknown native error"
        raise NativeError(msg)
    return h


class Lighthouse:
    """Embeddable global quorum server (reference ``src/lib.rs:216-256``)."""

    def __init__(self, bind: str = "0.0.0.0:0", min_replicas: int = 1,
                 join_timeout_ms: int = 100, quorum_tick_ms: int = 100,
                 heartbeat_fresh_ms: int = 500,
                 heartbeat_grace_factor: int = 4,
                 eviction_staleness_factor: int = 3,
                 auth_token: str = "",
                 fast_path: bool = True,
                 standby_of: str = "",
                 replicate_ms: int = 100,
                 join_window_ms: int = 0,
                 slo: str = ""):
        """``heartbeat_fresh_ms``/``heartbeat_grace_factor``: a previous
        member absent from the join round but heartbeating within
        ``heartbeat_fresh_ms`` extends the straggler wait to
        ``heartbeat_grace_factor * join_timeout_ms`` (it is alive and en
        route; cutting it out forks the job into split quorums). Factor 1
        restores reference behavior (heartbeats visualized only).

        ``eviction_staleness_factor``: the inverse lever — when every
        previous member missing from a round is provably gone (beats staler
        than ``eviction_staleness_factor * heartbeat_fresh_ms``, or clean
        farewell), the shrunken quorum cuts immediately instead of waiting
        ``join_timeout_ms``. 0 disables (reference behavior: a crashed
        group stalls survivors for the full join timeout).

        ``auth_token``: shared job secret forwarded in dashboard Kill RPCs
        so token-gated managers accept them.

        ``fast_path``: membership-unchanged fast path
        (docs/design/control_plane.md) — when every member of the previous
        quorum is provably live (beats within the eviction staleness
        bound) and no joiner is pending, a Quorum RPC returns the cached
        decision with a bumped epoch immediately instead of parking in the
        tick-loop rendezvous. Any membership delta falls back to the slow
        path, so quorum semantics are unchanged. False restores strict
        reference behavior.

        ``standby_of``: non-empty = run as a WARM STANDBY of the primary
        lighthouse at this address — replicate its quorum state every
        ``replicate_ms``, refuse Quorum RPCs until the primary is provably
        dead, then promote and serve the same membership under the SAME
        quorum_id so managers re-dial mid-step without a ring rebuild.

        ``join_window_ms``: join-coalescing window
        (docs/design/churn.md) — once a joiner lands in a forming
        round, the cut holds open this long from the first joiner's
        arrival so a join storm is admitted as ONE membership delta
        (reconfigures scale with windows, not joiners; the
        ``joins_coalesced`` status counter observes it). 0 disables.

        ``slo``: fleet SLO spec (docs/design/fleet_health.md) —
        ``key=value`` pairs joined by ``;``/``,`` over ``step_p95_ms``
        / ``commit_rate`` / ``heal_ms`` / ``publish_lag_ms`` /
        ``staleness_ms``; a breach lands a fleet event, flips the
        ``slo_breach`` gauge on ``GET /fleet/metrics``, and is echoed
        to the guilty group in its quorum response (triggering its
        local flight-recorder dump). Empty = no SLOs. Validated
        STRICTLY here (unknown key / bad number raises ValueError):
        the C++ parser is lenient by design — atof() would turn a
        typo'd threshold into an always-firing 0.0 SLO."""
        if slo:
            from torchft_tpu_torch.fleet import SLOConfig

            SLOConfig.from_spec(slo)
        err = ctypes.c_void_p()
        self._h = _check_handle(
            lib().tft_lighthouse_new(bind.encode(), min_replicas,
                                     join_timeout_ms, quorum_tick_ms,
                                     heartbeat_fresh_ms,
                                     heartbeat_grace_factor,
                                     eviction_staleness_factor,
                                     auth_token.encode(),
                                     1 if fast_path else 0,
                                     standby_of.encode(), replicate_ms,
                                     join_window_ms, slo.encode(),
                                     ctypes.byref(err)), err)

    def address(self) -> str:
        return _take_str(lib().tft_lighthouse_address(self._h))

    def status(self, timeout_ms: int = 5000) -> dict:
        import json
        out, err = ctypes.c_void_p(), ctypes.c_void_p()
        _check(lib().tft_lighthouse_client_status(
            self.address().encode(), timeout_ms, ctypes.byref(out),
            ctypes.byref(err)), err)
        return json.loads(_take_str(out.value))

    def shutdown(self) -> None:
        if self._h:
            lib().tft_lighthouse_shutdown(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            lib().tft_lighthouse_free(h)


class ManagerServer:
    """Embeddable per-replica-group coordinator (reference ``src/lib.rs:29-78``)."""

    def __init__(self, replica_id: str, lighthouse_addr: str,
                 store_addr: str = "", bind: str = "0.0.0.0:0",
                 world_size: int = 1, heartbeat_ms: int = 100,
                 auth_token: str = ""):
        """``auth_token``: when non-empty, Kill RPCs must carry the
        matching token or are refused (the RPC hard-exits the process)."""
        err = ctypes.c_void_p()
        self._h = _check_handle(
            lib().tft_manager_new(replica_id.encode(),
                                  lighthouse_addr.encode(), bind.encode(),
                                  store_addr.encode(), world_size,
                                  heartbeat_ms, auth_token.encode(),
                                  ctypes.byref(err)), err)

    def address(self) -> str:
        return _take_str(lib().tft_manager_address(self._h))

    def set_status(self, metrics_json: str, heal_count: int = 0,
                   committed_steps: int = 0, aborted_steps: int = 0) -> None:
        """Push an operational snapshot: ``metrics_json`` is served verbatim
        at ``GET http://<manager addr>/metrics.json``; the scalar counters
        ride the lighthouse heartbeat so the dashboard shows per-member
        heal/commit/abort columns."""
        lib().tft_manager_set_status(self._h, metrics_json.encode(),
                                     heal_count, committed_steps,
                                     aborted_steps)

    def set_digest(self, step: int, step_wall_ms: float,
                   fetch_ms: float = 0.0, ring_ms: float = 0.0,
                   put_ms: float = 0.0, vote_ms: float = 0.0,
                   heal_bytes_inflight: float = 0.0,
                   publish_bytes_inflight: float = 0.0,
                   policy_rung: int = -1,
                   capacity_fraction: float = 1.0,
                   churn_per_min: float = 0.0,
                   healing: bool = False,
                   heal_last_ms: float = 0.0,
                   publish_last_ms: float = 0.0,
                   trace_addr: str = "",
                   quorum_id: int = -1,
                   state_digest: str = "",
                   rebalance_fraction: float = 1.0) -> None:
        """Push the per-step telemetry digest
        (docs/design/fleet_health.md): it piggybacks on this server's
        quorum RPC beat (and keepalive beats), feeding the lighthouse's
        fleet aggregates at zero extra RPCs. Never calling this keeps
        beats bit-exact with digest-less builds.

        ``quorum_id``/``state_digest`` carry the state-attestation
        fingerprint (docs/design/state_attestation.md); ``""`` keeps
        this group a non-voter. ``rebalance_fraction`` is the batch
        fraction in force for the measured step
        (docs/design/fleet_rebalance.md) so the rebalancer can
        normalize wall time."""
        lib().tft_manager_set_digest(
            self._h, int(step), float(step_wall_ms), float(fetch_ms),
            float(ring_ms), float(put_ms), float(vote_ms),
            float(heal_bytes_inflight), float(publish_bytes_inflight),
            int(policy_rung), float(capacity_fraction),
            float(churn_per_min), 1 if healing else 0,
            float(heal_last_ms), float(publish_last_ms),
            trace_addr.encode(), int(quorum_id), state_digest.encode(),
            float(rebalance_fraction))

    def lighthouse_redials(self) -> int:
        """Times this manager re-dialed a DIFFERENT lighthouse endpoint
        (primary death -> warm standby, or rotation through a
        comma-separated ``lighthouse_addr`` candidate list). Rides
        ``Manager.metrics()`` as ``lighthouse_redials``."""
        return int(lib().tft_manager_lighthouse_redials(self._h))

    def lighthouse_addr(self) -> str:
        """The lighthouse endpoint currently dialed (observability)."""
        return _take_str(lib().tft_manager_lighthouse_addr(self._h))

    def farewell(self) -> None:
        """Send the quorum farewell (leaving beat) NOW, without shutting
        the server down — the graceful preemption drain's first act
        (docs/design/churn.md): survivors' next quorum round then cuts
        the shrunken membership immediately instead of waiting out
        heartbeat staleness. Idempotent; also silences this manager's
        heartbeat loop so a later beat cannot revive the departed
        record. ``shutdown()`` still sends it for clean non-drain exits."""
        lib().tft_manager_farewell(self._h)

    def hard_stop(self) -> None:
        """SIGKILL simulation (churn benches/soaks only): stop serving
        and beating WITHOUT the farewell, so survivors pay the
        staleness-eviction path — the honest control leg of the
        graceful-drain A/B."""
        lib().tft_manager_hard_stop(self._h)

    def shutdown(self) -> None:
        if self._h:
            lib().tft_manager_shutdown(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            lib().tft_manager_free(h)


class Store:
    """KV store server for rendezvous (the TCPStore analogue)."""

    def __init__(self, bind: str = "0.0.0.0:0"):
        err = ctypes.c_void_p()
        self._h = _check_handle(
            lib().tft_store_new(bind.encode(), ctypes.byref(err)), err)

    def address(self) -> str:
        return _take_str(lib().tft_store_address(self._h))

    def shutdown(self) -> None:
        if self._h:
            lib().tft_store_shutdown(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            lib().tft_store_free(h)


class _RetryingNativeClient:
    """Shared retry + chaos scaffolding for the native RPC clients.
    Subclasses set ``_CHANNEL`` (the chaos endpoint / stats-label
    channel) and implement ``_new_handle`` / ``_free_handle`` for their
    C pair; the handle lifecycle and retry loop live here once, so the
    two clients cannot silently diverge.

    Retries re-invoke on the SAME native handle, never rebuild it: the
    C++ ``RpcClient`` already poisons a desynced socket and reconnects
    internally on the next call, and — critically — its per-handle
    monotonic ``call_seq`` survives those reconnects. A fresh handle
    would restart ``call_seq`` at 0, and the server takes a LOWER seq at
    a done round to be a lost-response replay (``manager.cc``), so a
    rebuilt handle would replay stale quorum/commit rounds for thousands
    of calls — breaking the very idempotency contract that makes retries
    safe.

    ``retry_policy`` defaults to the shared 3-attempt
    exponential-backoff policy; pass ``RetryPolicy(max_attempts=1)`` to
    observe raw transport timing. Chaos injection
    (:mod:`torchft_tpu_torch.chaos`, endpoint ``_CHANNEL``) wraps every call
    so soak runs exercise exactly this retry path."""

    _CHANNEL = ""

    def __init__(self, address: str, connect_timeout_ms: int = 10_000,
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_stats: Optional[RetryStats] = None):
        self._h = None  # __del__ must be safe when the connect raises
        self._address = address
        self._connect_timeout_ms = connect_timeout_ms
        self._retry_policy = (retry_policy if retry_policy is not None
                              else RetryPolicy())
        self._retry_stats = retry_stats
        self._h = self._call("connect", self._connect)

    def _new_handle(self):  # pragma: no cover — subclass contract
        raise NotImplementedError

    def _free_handle(self, h) -> None:  # pragma: no cover
        raise NotImplementedError

    def _connect(self):
        return self._new_handle()

    def _call(self, op: str, fn):
        def attempt():
            tok = chaos.begin(self._CHANNEL, op)
            result = fn()
            try:
                chaos.end(tok)
            except BaseException:
                # A post-phase fault after a successful connect would
                # otherwise strand the freshly-created native handle (and
                # its socket fd) with no owner.
                if op == "connect" and result:
                    self._free_handle(result)
                raise
            return result

        return call_with_retry(attempt, self._retry_policy,
                               stats=self._retry_stats,
                               op=f"{self._CHANNEL}.{op}")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free_handle(h)


class StoreClient(_RetryingNativeClient):
    """KV store client with reconnect-and-retry on transient transport
    errors (see :class:`_RetryingNativeClient`)."""

    _CHANNEL = "store"

    def _new_handle(self):
        err = ctypes.c_void_p()
        return _check_handle(
            lib().tft_store_client_new(self._address.encode(),
                                       self._connect_timeout_ms,
                                       ctypes.byref(err)), err)

    def _free_handle(self, h) -> None:
        lib().tft_store_client_free(h)

    def set(self, key: str, value: bytes) -> None:
        if isinstance(value, str):
            value = value.encode()

        def do_set():
            err = ctypes.c_void_p()
            _check(lib().tft_store_client_set(self._h, key.encode(), value,
                                              len(value), ctypes.byref(err)),
                   err)

        self._call("set", do_set)

    def get(self, key: str, timeout_ms: int = 30_000) -> bytes:
        def do_get():
            out, n, err = (ctypes.c_void_p(), ctypes.c_size_t(),
                           ctypes.c_void_p())
            _check(lib().tft_store_client_get(
                self._h, key.encode(), timeout_ms, ctypes.byref(out),
                ctypes.byref(n), ctypes.byref(err)), err)
            try:
                return ctypes.string_at(out.value, n.value)
            finally:
                lib().tft_free(out.value)

        return self._call("get", do_get)


@dataclass
class QuorumResult:
    """The quorum view a rank receives each step (reference
    ``ManagerQuorumResponse``, ``proto/torchft.proto:77-89``), plus the
    control-plane provenance pair: ``fast_path`` (this round was served
    from the lighthouse's membership-unchanged cache) and ``epoch`` (the
    lighthouse's monotonic decision counter)."""

    quorum_id: int
    recover_manager_address: str
    store_address: str
    max_step: int
    max_rank: Optional[int]
    max_world_size: int
    replica_rank: int
    replica_world_size: int
    heal: bool
    fast_path: bool = False
    epoch: int = 0
    # Fleet health hint (docs/design/fleet_health.md): fleet step-wall
    # quantiles, this group's robust-z straggler score + slowest-stage
    # attribution, the fleet's worst group, and any SLOs THIS group is
    # currently breaching (comma-joined; "" = inside SLOs). All
    # zero/empty when the fleet reports no digests.
    fleet_p50_ms: float = 0.0
    fleet_p95_ms: float = 0.0
    fleet_max_ms: float = 0.0
    fleet_groups: int = 0
    straggler_score: float = 0.0
    straggler_stage: str = ""
    straggler_id: str = ""
    slo_breach: str = ""
    # State attestation verdict (docs/design/state_attestation.md):
    # True while THIS group's state digest is quarantined (it lost a
    # majority vote and has not re-attested); the comma-joined
    # fleet-wide quarantine lists gate every donor resolver.
    sdc_diverged: bool = False
    sdc_quarantined: str = ""
    sdc_quarantined_addrs: str = ""
    # Fleet rebalance hint (docs/design/fleet_rebalance.md): THIS
    # group's advisory batch fraction, the fleet-wide fraction table
    # ("rid=frac,..." — only entries != 1.0), and the table's change
    # sequence number. 0/empty from a pre-rebalance control plane.
    rebalance_fraction: float = 0.0
    rebalance_table: str = ""
    rebalance_seq: int = 0


class ManagerClient(_RetryingNativeClient):
    """Blocking client to a replica group's manager server (reference
    ``src/lib.rs:81-181``), with reconnect-and-retry on transient
    transport errors (see :class:`_RetryingNativeClient`). Retrying is
    safe: every request carries a per-client monotonic ``call_seq``
    (rpc.h), and the server replays a done round idempotently for a
    retried rank while opening a fresh round only for a genuinely new
    step attempt (manager.cc), so a retry after a lost response can
    never double-join or double-commit."""

    _CHANNEL = "manager"

    def _new_handle(self):
        err = ctypes.c_void_p()
        return _check_handle(
            lib().tft_manager_client_new(self._address.encode(),
                                         self._connect_timeout_ms,
                                         ctypes.byref(err)), err)

    def _free_handle(self, h) -> None:
        lib().tft_manager_client_free(h)

    @property
    def address(self) -> str:
        return self._address

    def quorum(self, rank: int, step: int, checkpoint_server_addr: str,
               timeout_ms: int = 0) -> QuorumResult:
        return self._call("quorum", lambda: self._quorum_once(
            rank, step, checkpoint_server_addr, timeout_ms))

    def _quorum_once(self, rank: int, step: int,
                     checkpoint_server_addr: str,
                     timeout_ms: int) -> QuorumResult:
        res, err = _CQuorumResult(), ctypes.c_void_p()
        _check(lib().tft_manager_client_quorum(
            self._h, rank, step, checkpoint_server_addr.encode(), timeout_ms,
            ctypes.byref(res), ctypes.byref(err)), err)
        return QuorumResult(
            quorum_id=res.quorum_id,
            recover_manager_address=_take_str(res.recover_manager_address),
            store_address=_take_str(res.store_address),
            max_step=res.max_step,
            max_rank=res.max_rank if res.has_max_rank else None,
            max_world_size=res.max_world_size,
            replica_rank=res.replica_rank,
            replica_world_size=res.replica_world_size,
            heal=bool(res.heal),
            fast_path=bool(res.fast_path),
            epoch=res.epoch,
            fleet_p50_ms=res.fleet_p50_ms,
            fleet_p95_ms=res.fleet_p95_ms,
            fleet_max_ms=res.fleet_max_ms,
            fleet_groups=res.fleet_groups,
            straggler_score=res.straggler_score,
            straggler_stage=_take_str(res.straggler_stage),
            straggler_id=_take_str(res.straggler_id),
            slo_breach=_take_str(res.slo_breach),
            sdc_diverged=bool(res.sdc_diverged),
            sdc_quarantined=_take_str(res.sdc_quarantined),
            sdc_quarantined_addrs=_take_str(res.sdc_quarantined_addrs),
            rebalance_fraction=res.rebalance_fraction,
            rebalance_table=_take_str(res.rebalance_table),
            rebalance_seq=res.rebalance_seq,
        )

    def checkpoint_address(self, rank: int, timeout_ms: int = 10_000) -> str:
        def once() -> str:
            out, err = ctypes.c_void_p(), ctypes.c_void_p()
            _check(lib().tft_manager_client_checkpoint_address(
                self._h, rank, timeout_ms, ctypes.byref(out),
                ctypes.byref(err)), err)
            return _take_str(out.value)

        return self._call("checkpoint_address", once)

    def should_commit(self, rank: int, step: int, should_commit: bool,
                      timeout_ms: int = 0) -> bool:
        def once() -> bool:
            out, err = ctypes.c_int32(), ctypes.c_void_p()
            _check(lib().tft_manager_client_should_commit(
                self._h, rank, step, 1 if should_commit else 0, timeout_ms,
                ctypes.byref(out), ctypes.byref(err)), err)
            return bool(out.value)

        return self._call("should_commit", once)

    def kill(self, msg: str = "") -> None:
        err = ctypes.c_void_p()
        lib().tft_manager_client_kill(self._h, msg.encode(), ctypes.byref(err))
