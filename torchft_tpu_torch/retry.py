"""Unified retry/backoff/deadline policy for the control and data planes.

Every transport client in the framework (KV store, manager RPC, heal
fetch, host-ring rendezvous) used to have exactly one knob — a connect
timeout — so a transient connection reset during quorum was
indistinguishable from a dead peer. This module is the single policy
layer threaded through all of them:

* :class:`RetryPolicy` — max attempts, exponential backoff with
  deterministic-seedable jitter, and an overall deadline, with the
  backoff math exposed (:meth:`RetryPolicy.delay_ms`) so tests pin it.
* :func:`is_transient` — retryable-vs-fatal error classification shared
  by every call site: connection resets, refusals, timeouts and broken
  pipes retry; protocol errors (bad step, auth refused, invalid quorum)
  surface immediately.
* :func:`call_with_retry` — the one retry loop. Callers pass a zero-arg
  attempt callable; an optional ``reconnect`` hook runs between attempts
  for transports that must rebuild state before redialing. (The native
  clients deliberately do NOT use it: the C++ ``RpcClient`` poisons a
  desynced socket and reconnects internally while preserving its
  ``call_seq`` — rebuilding the handle would reset the seq and break the
  idempotent-replay contract.)
* :class:`RetryStats` — thread-safe counters
  (``retry_count``/``retry_ms_total``/``retry_giveups``) shared by all
  clients of one :class:`~torchft_tpu.manager.Manager` and surfaced in
  ``Manager.metrics()`` and the manager's ``GET /metrics.json``, so
  degraded-but-alive transports are observable before the failure-streak
  circuit breaker above this layer fires.

Retrying the manager RPCs is safe because every request is stamped with
a per-client monotonic ``call_seq`` (``rpc.h``): the server replays a
done round idempotently for a retried seq and only opens a fresh round
for a genuinely new one (``manager.cc handle_quorum``), so a retry after
a lost response can never double-commit or double-join a step.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = [
    "RetryPolicy",
    "RetryStats",
    "RetryError",
    "call_with_retry",
    "is_transient",
]


class RetryError(RuntimeError):
    """All attempts exhausted (or the overall deadline passed). The last
    underlying error is chained as ``__cause__``."""


# Substrings (lowercased) identifying errors worth retrying: the messy
# middle between healthy and dead — resets, refusals, timeouts, partial
# writes. Native transport errors arrive as NativeError(str) from the C++
# layer, so classification is message-based for those; Python-level
# ConnectionError/TimeoutError instances are classified by type first.
_TRANSIENT_MARKERS = (
    "connection reset",
    "reset by peer",
    "connection refused",
    "connection aborted",
    "broken pipe",
    "timed out",
    "timeout",
    "temporarily unavailable",
    "unreachable",
    "peer closed",
    "eof",
    "transport:",  # rpc.cc prefixes all socket-level failures
    "short read",
    "short write",
    "truncated",
    "reconnect",
    # The donor's HTTP 503 while its serve window is shut at commit:
    # transient BY CONSTRUCTION — the window reopens at the donor's next
    # step start. (503 "shutting down" stays fatal via the marker
    # above.)
    "serve window closed",
)

# Markers that must NEVER retry even when a transient marker also matches
# (e.g. "store: get timed out waiting for key" is a *semantic* timeout —
# the key may legitimately never arrive, and the caller's own timeout
# already bounds the wait).
_FATAL_MARKERS = (
    "auth",
    "unauthorized",
    "invalid",
    "unknown method",
    "shutting down",
    "killed",
    # The store's *semantic* wait-timeout: the server held the GET open
    # for the caller's full window and the key never arrived. Retrying
    # would silently multiply the caller's deadline. (Transport-level
    # timeouts arrive "transport:"-prefixed from rpc.cc and DO retry.)
    "waiting for key",
)


def is_transient(exc: BaseException) -> bool:
    """Retryable-vs-fatal classification shared by every transport client.

    ``ConnectionError``/``TimeoutError``/``socket.timeout`` instances are
    transient by type; anything else is judged by message markers, with
    fatal markers (auth/protocol errors) taking precedence.
    """
    msg = str(exc).lower()
    if any(m in msg for m in _FATAL_MARKERS):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    return any(m in msg for m in _TRANSIENT_MARKERS)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter, bounded by attempts and a deadline.

    Attempt ``k`` (0-based) that fails sleeps
    ``min(base_delay_ms * multiplier**k, max_delay_ms)`` scaled by a
    jitter factor drawn uniformly from ``[1 - jitter, 1 + jitter]``
    before attempt ``k+1``. ``max_attempts=1`` disables retries entirely
    (callers that must observe raw transport timing — e.g. the
    lighthouse-outage stall tests — pin this). ``overall_deadline_ms``
    bounds the whole loop including backoff sleeps; 0 means unbounded
    (the per-attempt RPC timeouts still apply).
    """

    max_attempts: int = 3
    base_delay_ms: float = 25.0
    max_delay_ms: float = 2_000.0
    multiplier: float = 2.0
    jitter: float = 0.5
    overall_deadline_ms: float = 0.0

    def delay_ms(self, attempt: int,
                 rng: Optional[random.Random] = None) -> float:
        """Backoff before retrying after failed 0-based ``attempt``."""
        if attempt < 0:
            raise ValueError("attempt must be >= 0")
        base = min(self.base_delay_ms * (self.multiplier ** attempt),
                   self.max_delay_ms)
        if self.jitter <= 0:
            return base
        r = rng if rng is not None else random
        return base * r.uniform(1.0 - self.jitter, 1.0 + self.jitter)


class RetryStats:
    """Thread-safe retry counters, shared across one Manager's clients.

    ``retry_count`` — transient failures that were retried;
    ``retry_ms_total`` — cumulative backoff + failed-attempt wall time;
    ``retry_giveups`` — retry loops that exhausted attempts/deadline.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.retry_count = 0
        self.retry_ms_total = 0.0
        self.retry_giveups = 0

    def record_retry(self, wasted_ms: float) -> None:
        with self._lock:
            self.retry_count += 1
            self.retry_ms_total += wasted_ms

    def record_giveup(self) -> None:
        with self._lock:
            self.retry_giveups += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "retry_count": float(self.retry_count),
                "retry_ms_total": self.retry_ms_total,
                "retry_giveups": float(self.retry_giveups),
            }


def call_with_retry(
    attempt: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    classify: Callable[[BaseException], bool] = is_transient,
    reconnect: Optional[Callable[[], None]] = None,
    stats: Optional[RetryStats] = None,
    op: str = "",
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``attempt`` under ``policy``; retry transient failures.

    ``reconnect`` runs before each retry (exceptions there count as that
    attempt's failure — a peer still down fails fast into the next
    backoff). Fatal errors and errors on the last attempt propagate
    unchanged, so callers' existing ``except`` clauses keep working; an
    exhausted overall deadline raises :class:`RetryError` from the last
    underlying error.
    """
    pol = policy if policy is not None else RetryPolicy()
    attempts = max(int(pol.max_attempts), 1)
    t0 = time.perf_counter()
    deadline = (t0 + pol.overall_deadline_ms / 1e3
                if pol.overall_deadline_ms > 0 else None)
    last: Optional[BaseException] = None
    for k in range(attempts):
        attempt_t0 = time.perf_counter()
        try:
            if k > 0 and reconnect is not None:
                reconnect()
            return attempt()
        except BaseException as e:  # noqa: BLE001 — classified below
            last = e
            if not classify(e) or k == attempts - 1:
                if k > 0 and stats is not None:
                    stats.record_giveup()
                raise
            wasted_ms = (time.perf_counter() - attempt_t0) * 1e3
            delay = pol.delay_ms(k, rng) / 1e3
            if deadline is not None and \
                    time.perf_counter() + delay > deadline:
                if stats is not None:
                    stats.record_giveup()
                raise RetryError(
                    f"{op or 'call'}: overall retry deadline "
                    f"({pol.overall_deadline_ms:.0f}ms) exhausted after "
                    f"{k + 1} attempts") from e
            if stats is not None:
                stats.record_retry(wasted_ms + delay * 1e3)
            sleep(delay)
    raise RetryError(f"{op or 'call'}: unreachable") from last
