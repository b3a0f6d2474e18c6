"""ChaosNet: deterministic, seed-driven transport fault injection.

The framework's fault-tolerance story was proven only against *clean*
failures (a whole replica group killed at a step boundary). Production
failures live in the messy middle: slow peers, connection resets mid-RPC,
partial writes on the host ring, a flapping lighthouse. This module
injects exactly those, deterministically, at every Python-side transport:

* the host-ring sockets (:mod:`torchft_tpu.backends.host`) via
  :func:`wrap_socket`;
* the heal transport (:mod:`torchft_tpu.checkpointing`) via
  :func:`wrap_reader` around the streamed HTTP body;
* the weight-distribution tier (:mod:`torchft_tpu.serving`) on the
  ``serve`` channel — head/manifest/Range fetches of subscribers and
  relays, with per-parent endpoints ``serve:<host:port>`` so a kill
  fault latches ONE parent dead (the relay-death case) while the
  channel config/RNG stream stays shared across the tree;
* the native KV-store / manager-RPC clients (:mod:`torchft_tpu._native`)
  via the :func:`begin`/:func:`end` shims around each foreign call (the
  C++ sockets themselves are out of Python's reach, so faults are
  injected at the call boundary — a "pre" fault models a request that
  never arrived, a "post" fault a lost response, which is the case the
  server-side ``call_seq`` idempotency exists for);
* the manager's cross-group allreduce path via
  :class:`ChaosCommunicator`, a fault-injecting Communicator shim;
* the durable checkpoint writer (:mod:`torchft_tpu.checkpoint_io`) via
  :func:`disk_fault` on the ``disk`` channel (torn writes, post-rename
  bit-flips, ENOSPC, stalled IO).

Faults come from a :class:`ChaosSchedule`: a per-endpoint configuration
(latency, jitter, connection resets, short reads/writes, black-holes,
donor kills — ``kill_rate`` / ``kill_after_bytes`` latch an endpoint
dead so later dials are refused like a dead peer process)
driven by per-channel deterministic RNG streams — the decision sequence
for a channel is a pure function of ``(seed, channel, op index)``, so the
same schedule replayed over the same per-channel op sequence reproduces
the identical injection trace (:meth:`ChaosSchedule.trace`), regardless
of cross-channel thread interleaving.

Activation:

* tests construct a schedule and :func:`install` it (or pass it
  directly, e.g. to :class:`ChaosCommunicator`);
* soak runs set ``TORCHFT_CHAOS`` and every transport picks it up
  lazily. Spec grammar (see docs/design/chaos_and_retry.md)::

      TORCHFT_CHAOS="seed=42;ring:reset_rate=0.02,latency_ms=5;store:reset_rate=0.01;*:jitter_ms=2"

  ``seed=<int>`` first (optional, default 0), then
  ``<channel>:<field>=<value>,...`` clauses separated by ``;`` where
  ``<channel>`` is an endpoint channel (``ring``, ``store``,
  ``manager``, ``heal``, ``serve``, ``allreduce``, ``disk``) or ``*``
  for all, and ``<field>`` is any :class:`EndpointChaos` field.

When nothing is installed and ``TORCHFT_CHAOS`` is unset, every hook is
a no-op costing one global read on the hot path.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from dataclasses import dataclass, fields, replace
from typing import Any, Dict, List, Optional

from concurrent.futures import Future

from torchft_tpu_torch.communicator import Communicator, CommunicatorError

__all__ = [
    "EndpointChaos",
    "ChaosSchedule",
    "ChaosCommunicator",
    "ChaosSocket",
    "parse_spec",
    "install",
    "uninstall",
    "reset",
    "active",
    "wrap_socket",
    "wrap_reader",
    "begin",
    "end",
    "disk_fault",
    "device_fault",
    "ram_fault",
    "slow_fault",
]


@dataclass(frozen=True)
class EndpointChaos:
    """Fault mix for one endpoint channel. Rates are per-operation
    probabilities in ``[0, 1]``; at most one hard fault fires per op
    (drawn from a single uniform sample, so ``reset_rate + short_rate +
    blackhole_rate`` should stay <= 1)."""

    latency_ms: float = 0.0      # fixed delay added to every operation
    jitter_ms: float = 0.0       # extra uniform delay in [0, jitter_ms]
    reset_rate: float = 0.0      # connection reset (pre or post for RPCs)
    short_rate: float = 0.0      # partial read/write, then reset
    blackhole_rate: float = 0.0  # op stalls, then times out
    blackhole_ms: float = 5_000.0  # stall bound for black-holed ops
    # Donor-kill: the endpoint DIES (not just this op). A "kill" fault
    # hangs up the in-flight stream and latches the endpoint dead —
    # every later dial/read against it raises connection-refused, the
    # way a dead peer process behaves — until ChaosSchedule.revive().
    kill_rate: float = 0.0       # per-op probability of dying mid-op
    kill_after_bytes: float = -1.0  # die once this many bytes streamed
    # Disk faults (the ``disk`` channel, honored by
    # :func:`torchft_tpu.checkpoint_io.save` via :func:`disk_fault`):
    #   torn   — the process "crashes" before the atomic rename, leaving
    #            a partial file at the DESTINATION path (modeling a
    #            non-atomic writer or a post-power-loss rename that was
    #            never made durable by a directory fsync);
    #   flip   — the save succeeds, then one byte of the on-disk file is
    #            flipped (silent storage corruption, caught only by
    #            digest verification at load/verify time);
    #   enospc — the write fails with ``OSError(ENOSPC)`` (fatal-but-
    #            reported class, unlike the transient EIO family).
    # Slow/stalled disk IO reuses latency_ms/jitter_ms and
    # blackhole_rate/blackhole_ms (a blackholed save wedges for
    # blackhole_ms, then fails ETIMEDOUT — what the checkpoint stall
    # watchdog exists to bound).
    torn_rate: float = 0.0
    flip_rate: float = 0.0
    enospc_rate: float = 0.0
    # Device faults (the ``device`` channel, honored by
    # :func:`device_fault` — the degraded-mode soak's injection point,
    # docs/design/degraded_mode.md): per-decision probability of one
    # chip dying (``chip_loss_rate``) or one previously-lost chip
    # coming back (``chip_return_rate``) on the endpoint
    # ``device:<replica_id>``. The lost-chip SET is schedule state
    # (:meth:`ChaosSchedule.lost_chips`); which chip is picked derives
    # from the decision's own frac draw, so the event sequence stays a
    # pure function of (seed, channel, n). Appended LAST in the
    # fault-band order (the determinism contract: existing channels'
    # traces are unchanged while these rates are 0).
    chip_loss_rate: float = 0.0
    chip_return_rate: float = 0.0
    # RAM checkpoint-tier faults (the ``ram`` channel, honored by
    # :func:`ram_fault` — the memory-tier battery's injection point,
    # docs/design/memory_tier.md):
    #   ram_loss      — a stored peer-RAM image silently vanishes (host
    #                   OOM-kill of the cache, reclaimed RAM); the store
    #                   drops the image and the healer falls down a rung;
    #   ram_blackhole — a replication push/serve stalls ``blackhole_ms``
    #                   then times out (NIC partition on the replication
    #                   path only — the disk rungs are unaffected).
    # Correlated K-peer death reuses the kill latches
    # (:meth:`ChaosSchedule.kill_endpoint` on ``ram:<name>``). Appended
    # after the device bands (same determinism contract: existing
    # channels' traces are unchanged while these rates are 0).
    ram_loss_rate: float = 0.0
    ram_blackhole_rate: float = 0.0
    # Silent data corruption (the ``sdc`` channel, honored by
    # :func:`sdc_fault` — the state-attestation soak's injection point,
    # docs/design/state_attestation.md): per-commit-boundary
    # probability of one bit flipping in the group's committed params
    # on the endpoint ``sdc:<replica_id>``. Which (leaf, byte, bit) is
    # flipped derives from the decision's own frac draw, so the
    # corruption sequence stays a pure function of (seed, channel, n);
    # the rate scales with the live intensity. Appended LAST in the
    # fault-band order (same determinism contract as the device/ram
    # bands: existing channels' traces are unchanged while this rate
    # is 0).
    sdc_flip_rate: float = 0.0
    # Straggler step-stretch (the ``slow`` channel, honored by
    # :func:`slow_fault` — the rebalance soak's injection point,
    # docs/design/fleet_rebalance.md): per-commit-boundary probability
    # that THIS boundary's step is stretched by ``slow_factor`` on the
    # endpoint ``slow:<replica_id>``. A persistent straggler is minted
    # with ``slow_rate=1`` (every boundary stretches, no wall-clock
    # hacks); the rate scales with the live intensity, so a
    # PhasedChaos stable->storm->stable walk mints and clears the
    # straggler with zero latch bookkeeping. ``slow_factor`` is a
    # multiplier, not a rate — intensity never scales it. Appended
    # LAST in the fault-band order (same determinism contract as the
    # device/ram/sdc bands: existing channels' traces are unchanged
    # while this rate is 0).
    slow_rate: float = 0.0
    slow_factor: float = 2.0
    max_faults: int = -1         # cap on hard faults per channel (-1 = inf)


@dataclass(frozen=True)
class Decision:
    """One injection decision. ``fault`` is ``None``, ``"reset"``,
    ``"short"``, ``"blackhole"``, ``"kill"`` (the endpoint dies and
    stays dead), or a disk fault — ``"torn"``, ``"flip"``, ``"enospc"``
    (see :func:`disk_fault`); ``phase`` is ``"pre"`` (request never
    arrived) or ``"post"`` (response lost) and is honored by the RPC
    shims only — socket faults fire at IO time. ``frac`` is the fraction
    of a short transfer that completes (and doubles as the torn-write
    prefix fraction / flipped-byte position for disk faults)."""

    endpoint: str
    op: str
    n: int                      # per-channel op index
    delay_ms: float
    fault: Optional[str]
    phase: str
    frac: float
    blackhole_ms: float


class ChaosSchedule:
    """Seed-driven per-endpoint fault schedule with a recorded trace.

    Decisions for a channel are drawn from that channel's own RNG stream
    seeded by ``(seed, channel)``: decision ``n`` of a channel is a pure
    function of ``(seed, channel, n)``, so replaying the same per-channel
    op sequence through a fresh ``ChaosSchedule(seed)`` reproduces the
    identical trace even when threads interleave channels differently.
    """

    def __init__(self, seed: int = 0,
                 endpoints: Optional[Dict[str, EndpointChaos]] = None,
                 trace_cap: int = 100_000,
                 intensity: float = 1.0) -> None:
        """``trace_cap`` bounds the recorded trace: a multi-hour soak
        draws a decision per ring segment / RPC / stream read, and an
        unbounded list would grow into gigabytes on the collective hot
        path. Decisions past the cap still DRAW (determinism and fault
        injection are unaffected) but are only counted —
        ``trace_dropped`` says how many; reproducibility asserts must
        fit their op sequence under the cap.

        ``intensity`` scales every hard-fault rate (reset/short/
        blackhole/kill/torn/flip/enospc — latency and jitter are left
        alone) and can be changed live via :meth:`set_intensity`, which
        is what gives a soak *time-varying* chaos: stable -> storm ->
        stable phases for an adaptive policy to adapt across
        (:class:`torchft_tpu.policy.PhasedChaos` drives it
        from a wall-clock phase table). The RNG draw SEQUENCE is
        intensity-independent — only the fault threshold moves — so
        per-channel streams keep their (seed, channel, n) purity and a
        replay that applies the same intensity at the same op indices
        reproduces the identical trace."""
        self.seed = int(seed)
        self.endpoints: Dict[str, EndpointChaos] = dict(endpoints or {})
        self._intensity = float(intensity)
        self.trace_cap = int(trace_cap)
        self.trace_dropped = 0
        self._lock = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self._counts: Dict[str, int] = {}
        self._faults_left: Dict[str, int] = {}
        self._trace: List[Decision] = []
        self._fault_count = 0
        # Donor-kill state: endpoints latched dead, and per-endpoint
        # streamed-byte counters for the kill_after_bytes trigger.
        self._dead: Dict[str, bool] = {}
        self._bytes: Dict[str, int] = {}
        # Device-fault state (channel ``device``): per-endpoint set of
        # lost chip indices, mutated by chip_loss/chip_return decisions
        # (device_fault) or deterministically by tests
        # (lose_chip/return_chip).
        self._lost_chips: Dict[str, set] = {}

    # ------------------------------------------------------------- config

    def set_intensity(self, scale: float) -> None:
        """Scale every channel's hard-fault rates by ``scale`` from the
        next decision on (0 = the storm is over, 1 = as configured,
        >1 = storm). Latency/jitter and ``kill_after_bytes`` are
        unaffected; ``max_faults`` caps keep counting."""
        with self._lock:
            self._intensity = max(0.0, float(scale))

    def intensity(self) -> float:
        with self._lock:
            return self._intensity

    def config_for(self, endpoint: str) -> Optional[EndpointChaos]:
        """Effective config: exact endpoint, else its channel (the part
        before the first ``:``), else the ``*`` wildcard."""
        cfg = self.endpoints.get(endpoint)
        if cfg is None:
            cfg = self.endpoints.get(endpoint.split(":", 1)[0])
        if cfg is None:
            cfg = self.endpoints.get("*")
        return cfg

    # ---------------------------------------------------------- decisions

    def decide(self, endpoint: str, op: str) -> Optional[Decision]:
        """Draw (and record) the next decision for ``endpoint``; ``None``
        when the endpoint has no chaos configured."""
        cfg = self.config_for(endpoint)
        if cfg is None:
            return None
        channel = endpoint.split(":", 1)[0]
        with self._lock:
            rng = self._rngs.get(channel)
            if rng is None:
                # String seeding hashes stably (sha512) across runs and
                # interpreters, unlike tuple/hash() seeding.
                rng = self._rngs[channel] = random.Random(
                    f"{self.seed}/{channel}")
                self._counts[channel] = 0
                self._faults_left[channel] = cfg.max_faults
            n = self._counts[channel]
            self._counts[channel] = n + 1
            delay = cfg.latency_ms
            if cfg.jitter_ms > 0:
                delay += rng.uniform(0.0, cfg.jitter_ms)
            # One uniform draw selects among the fault kinds by
            # cumulative rate (order is part of the determinism
            # contract: reproducing a trace requires these bands to
            # stay stable across versions).
            fault: Optional[str] = None
            u = rng.random()
            acc = 0.0
            scale = self._intensity
            for rate, kind in ((cfg.reset_rate, "reset"),
                               (cfg.short_rate, "short"),
                               (cfg.blackhole_rate, "blackhole"),
                               (cfg.kill_rate, "kill"),
                               (cfg.torn_rate, "torn"),
                               (cfg.flip_rate, "flip"),
                               (cfg.enospc_rate, "enospc"),
                               (cfg.chip_loss_rate, "chip_loss"),
                               (cfg.chip_return_rate, "chip_return"),
                               (cfg.ram_loss_rate, "ram_loss"),
                               (cfg.ram_blackhole_rate, "ram_blackhole"),
                               (cfg.sdc_flip_rate, "sdc_flip"),
                               (cfg.slow_rate, "slow")):
                acc += rate * scale
                if u < acc:
                    fault = kind
                    break
            # Draw phase/frac unconditionally so the stream position does
            # not depend on whether a fault fired (keeps decision n a pure
            # function of (seed, channel, n) even across config edits).
            phase = "pre" if rng.random() < 0.5 else "post"
            frac = rng.uniform(0.1, 0.9)
            if fault is not None and self._faults_left[channel] == 0:
                fault = None  # cap exhausted: latency only
            elif fault is not None and self._faults_left[channel] > 0:
                self._faults_left[channel] -= 1
            d = Decision(endpoint=endpoint, op=op, n=n, delay_ms=delay,
                         fault=fault, phase=phase, frac=frac,
                         blackhole_ms=cfg.blackhole_ms)
            if fault is not None:
                self._fault_count += 1
            if len(self._trace) < self.trace_cap:
                self._trace.append(d)
            else:
                self.trace_dropped += 1
            return d

    def trace(self) -> List[Decision]:
        """Recorded decisions (copy, thread-safe) — the first
        ``trace_cap`` draws; ``trace_dropped`` counts the rest."""
        with self._lock:
            return list(self._trace)

    def fault_count(self) -> int:
        """Hard faults injected so far (counted even past the trace
        cap)."""
        with self._lock:
            return self._fault_count

    # ----------------------------------------------------- donor kills

    def kill_endpoint(self, endpoint: str) -> None:
        """Latch ``endpoint`` dead (tests use this for a deterministic
        donor kill at an exact moment; the ``kill_rate`` /
        ``kill_after_bytes`` faults call it internally). Dead endpoints
        refuse every dial and hang up every in-flight stream."""
        with self._lock:
            self._dead[endpoint] = True

    def revive_endpoint(self, endpoint: str) -> None:
        """Clear a dead latch (a donor "restarted"). The streamed-byte
        account resets with it: a ``kill_after_bytes`` threshold is per
        incarnation, so a replacement reusing the address gets the full
        allowance instead of dying on its first byte."""
        with self._lock:
            self._dead.pop(endpoint, None)
            self._bytes.pop(endpoint, None)

    def is_dead(self, endpoint: str) -> bool:
        with self._lock:
            return self._dead.get(endpoint, False)

    def dead_endpoints(self) -> List[str]:
        with self._lock:
            return [e for e, d in self._dead.items() if d]

    # ---------------------------------------------------- device faults

    def lost_chips(self, endpoint: str) -> frozenset:
        """Current lost chip indices of a ``device:*`` endpoint."""
        with self._lock:
            return frozenset(self._lost_chips.get(endpoint, ()))

    def lose_chip(self, endpoint: str, idx: int) -> None:
        """Latch one chip lost (tests use this for a deterministic
        chip loss at an exact moment; the ``chip_loss_rate`` fault
        calls it internally via :func:`device_fault`)."""
        with self._lock:
            self._lost_chips.setdefault(endpoint, set()).add(int(idx))

    def return_chip(self, endpoint: str, idx: int) -> None:
        """Clear one lost-chip latch (the chip "came back")."""
        with self._lock:
            self._lost_chips.get(endpoint, set()).discard(int(idx))

    def kill_allowance(self, endpoint: str) -> Optional[int]:
        """Bytes this endpoint may still stream before its
        ``kill_after_bytes`` threshold; ``None`` when no threshold is
        configured. Readers clamp their reads to this, so the death
        lands at the EXACT configured byte offset regardless of read
        sizes."""
        cfg = self.config_for(endpoint)
        if cfg is None or cfg.kill_after_bytes < 0:
            return None
        with self._lock:
            return max(0, int(cfg.kill_after_bytes)
                       - self._bytes.get(endpoint, 0))

    def note_bytes(self, endpoint: str, n: int) -> bool:
        """Account ``n`` streamed bytes against ``endpoint``; returns
        True exactly once, when the cumulative count reaches the
        channel's ``kill_after_bytes`` threshold — the endpoint is then
        latched dead (deterministic mid-stream donor death at a byte
        offset, independent of read sizes and thread timing)."""
        cfg = self.config_for(endpoint)
        if cfg is None or cfg.kill_after_bytes < 0:
            return False
        with self._lock:
            before = self._bytes.get(endpoint, 0)
            self._bytes[endpoint] = before + n
            if (before < cfg.kill_after_bytes
                    <= before + n and not self._dead.get(endpoint)):
                self._dead[endpoint] = True
                self._fault_count += 1
                return True
            return False


# ----------------------------------------------------------------- spec


def parse_spec(spec: str) -> ChaosSchedule:
    """Parse a ``TORCHFT_CHAOS`` spec string into a schedule."""
    seed = 0
    intensity = 1.0
    endpoints: Dict[str, EndpointChaos] = {}
    valid = {f.name: f.type for f in fields(EndpointChaos)}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[len("seed="):])
            continue
        if clause.startswith("intensity="):
            # Initial hard-fault-rate scale (set_intensity can move it
            # live — the stable->storm->stable soak knob).
            intensity = float(clause[len("intensity="):])
            continue
        channel, sep, params = clause.partition(":")
        if not sep:
            raise ValueError(
                f"TORCHFT_CHAOS clause {clause!r}: expected "
                "'<channel>:<field>=<value>,...' or 'seed=<int>'")
        cfg = endpoints.get(channel.strip(), EndpointChaos())
        for kv in params.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, sep, value = kv.partition("=")
            key = key.strip()
            if not sep or key not in valid:
                raise ValueError(
                    f"TORCHFT_CHAOS clause {clause!r}: unknown field "
                    f"{key!r} (valid: {sorted(valid)})")
            cast = int if key == "max_faults" else float
            cfg = replace(cfg, **{key: cast(value)})
        endpoints[channel.strip()] = cfg
    return ChaosSchedule(seed=seed, endpoints=endpoints,
                         intensity=intensity)


# ------------------------------------------------------- global activation

_installed: Optional[ChaosSchedule] = None
_env_checked = False
_install_lock = threading.Lock()


def install(schedule: Optional[ChaosSchedule]) -> None:
    """Install a process-wide schedule (tests / soak harnesses)."""
    global _installed, _env_checked
    with _install_lock:
        _installed = schedule
        _env_checked = True  # an explicit install overrides the env


def uninstall() -> None:
    """Disable process-wide chaos. STICKY against the environment: a
    later ``active()`` does NOT re-parse ``TORCHFT_CHAOS`` — otherwise a
    soak's drain-boundary uninstall would be silently re-armed by the
    very next transport op whenever the spec came from the env. Use
    :func:`reset` to also forget the env decision."""
    global _installed, _env_checked
    with _install_lock:
        _installed = None
        _env_checked = True


def reset() -> None:
    """Forget everything: uninstall AND re-arm env parsing, so the next
    ``active()`` re-reads ``TORCHFT_CHAOS`` (test isolation helper)."""
    global _installed, _env_checked
    with _install_lock:
        _installed = None
        _env_checked = False


def active() -> Optional[ChaosSchedule]:
    """The installed schedule, lazily parsing ``TORCHFT_CHAOS`` once."""
    global _env_checked, _installed
    if _env_checked:
        return _installed
    with _install_lock:
        if not _env_checked:
            spec = os.environ.get("TORCHFT_CHAOS")
            if spec:
                _installed = parse_spec(spec)
            _env_checked = True
    return _installed


def endpoint_reborn(*endpoints: str) -> None:
    """A fresh server just bound at these chaos endpoints: clear any
    dead latch a PREVIOUS process at the same address left behind.

    The kill latches (``heal:<host:port>`` / ``serve:<host:port>``)
    model a dead process by address — but under churn a *replacement*
    legitimately reuses a dead member's host:port, and without this
    hook it would inherit the corpse's latch: every dial refused
    forever, which reads as "the replacement never came back" when it
    demonstrably did. Servers call this at bind time
    (:class:`~torchft_tpu.checkpointing.CheckpointServer`,
    :class:`~torchft_tpu.serving.PublicationServer`); no-op without an
    active schedule. The endpoint's ``kill_rate``/``kill_after_bytes``
    faults stay armed — rebirth clears the latch, not the regime."""
    sched = active()
    if sched is None:
        return
    for e in endpoints:
        sched.revive_endpoint(e)


# ------------------------------------------------------------ RPC shims


def begin(endpoint: str, op: str,
          schedule: Optional[ChaosSchedule] = None) -> Optional[Decision]:
    """Pre-call hook for RPC-style clients: applies latency, raises the
    decided pre-phase fault, and returns the decision for :func:`end`.

    Raises ``ConnectionResetError`` for resets/shorts (message-classified
    transient by :func:`torchft_tpu.retry.is_transient`) and
    ``TimeoutError`` after stalling for black-holes.
    """
    sched = schedule if schedule is not None else active()
    if sched is None:
        return None
    if sched.is_dead(endpoint):
        # Dead endpoints refuse dials the way a dead peer process does —
        # no RNG draw, so the channel's decision stream stays pure.
        raise ConnectionRefusedError(
            f"[chaos] {endpoint}/{op}: connection refused (endpoint "
            "dead)")
    d = sched.decide(endpoint, op)
    if d is None:
        return None
    if d.delay_ms > 0:
        time.sleep(d.delay_ms / 1e3)
    if d.fault == "blackhole":
        time.sleep(d.blackhole_ms / 1e3)
        raise TimeoutError(
            f"[chaos] {endpoint}/{op}#{d.n}: black-holed, timed out")
    if d.fault == "kill":
        sched.kill_endpoint(endpoint)
        raise ConnectionResetError(
            f"[chaos] {endpoint}/{op}#{d.n}: connection reset by peer "
            "(peer process died)")
    if d.fault in ("reset", "short") and d.phase == "pre":
        raise ConnectionResetError(
            f"[chaos] {endpoint}/{op}#{d.n}: connection reset by peer "
            "(request lost)")
    return d


def end(decision: Optional[Decision]) -> None:
    """Post-call hook: raises the decided post-phase fault (the RPC
    executed server-side but the response was "lost" — the exact case
    ``call_seq`` idempotency makes safe to retry)."""
    if decision is not None and decision.fault in ("reset", "short") \
            and decision.phase == "post":
        raise ConnectionResetError(
            f"[chaos] {decision.endpoint}/{decision.op}"
            f"#{decision.n}: connection reset by peer (response lost)")


# ---------------------------------------------------------- disk faults


def disk_fault(endpoint: str, op: str = "save",
               schedule: Optional[ChaosSchedule] = None
               ) -> Optional[Decision]:
    """Pre-write hook for durable checkpoint saves (channel ``disk``;
    :func:`torchft_tpu.checkpoint_io.save` calls it per save with
    endpoint ``disk:<filename>``).

    Applies latency, then raises the faults that ARE write errors:
    ``blackhole`` sleeps ``blackhole_ms`` (a wedged NFS write — the
    caller's stall watchdog should fire long before) and raises
    ``OSError(ETIMEDOUT)`` (transient class); ``enospc`` raises
    ``OSError(ENOSPC)`` (fatal-but-reported class); ``reset``/``short``/
    ``kill`` map to ``OSError(EIO)`` (transient flaky-filesystem class).
    ``torn`` and ``flip`` decisions are RETURNED for the writer to act
    on — they need the serialized bytes / the final file: torn = leave a
    ``frac``-prefix of the stream at the DESTINATION path and "crash";
    flip = complete the save, then flip the byte at ``frac`` of the
    file (silent corruption only digest verification can catch)."""
    import errno

    sched = schedule if schedule is not None else active()
    if sched is None:
        return None
    d = sched.decide(endpoint, op)
    if d is None:
        return None
    if d.delay_ms > 0:
        time.sleep(d.delay_ms / 1e3)
    if d.fault == "blackhole":
        time.sleep(d.blackhole_ms / 1e3)
        raise OSError(
            errno.ETIMEDOUT,
            f"[chaos] {endpoint}/{op}#{d.n}: disk IO stalled, timed out")
    if d.fault == "enospc":
        raise OSError(
            errno.ENOSPC,
            f"[chaos] {endpoint}/{op}#{d.n}: no space left on device")
    if d.fault in ("reset", "short", "kill"):
        raise OSError(
            errno.EIO,
            f"[chaos] {endpoint}/{op}#{d.n}: input/output error")
    return d


# --------------------------------------------------------- device faults


def device_fault(endpoint: str, n_devices: int,
                 schedule: Optional[ChaosSchedule] = None) -> frozenset:
    """Per-boundary device-fault hook (channel ``device``; the
    degraded-mode driver polls it once per commit boundary with
    endpoint ``device:<replica_id>``).

    Draws one decision for the endpoint; a ``chip_loss`` fault latches
    one more chip lost, a ``chip_return`` fault revives one previously
    lost chip. The chip index derives from the decision's own ``frac``
    draw, so the whole event sequence is a pure function of
    ``(seed, channel, n)`` — replayable like every other channel — and
    both rates scale with the live intensity, so
    :class:`~torchft_tpu.policy.PhasedChaos` drives chip churn through
    stable -> storm -> stable phases unmodified. A loss that would kill
    the LAST chip is skipped: a group with zero devices is whole-group
    death, which is the eviction path's job, not this channel's.

    Returns the endpoint's CURRENT lost chip indices (empty when no
    chaos targets it)."""
    sched = schedule if schedule is not None else active()
    if sched is None:
        return frozenset()
    if sched.config_for(endpoint) is None:
        # No rates configured: no decision draw (stream purity), but a
        # deterministically latched lost set (lose_chip/return_chip —
        # the tests' exact-moment injection) still applies.
        return sched.lost_chips(endpoint)
    n_devices = max(int(n_devices), 1)
    d = sched.decide(endpoint, "device")
    if d is not None and d.fault == "chip_loss":
        lost = sched.lost_chips(endpoint)
        if len(lost) < n_devices - 1:
            # Deterministic pick among the still-live chips.
            live = [i for i in range(n_devices) if i not in lost]
            sched.lose_chip(endpoint,
                            live[int(d.frac * len(live)) % len(live)])
    elif d is not None and d.fault == "chip_return":
        lost = sorted(sched.lost_chips(endpoint))
        if lost:
            sched.return_chip(endpoint,
                              lost[int(d.frac * len(lost)) % len(lost)])
    return sched.lost_chips(endpoint)


# ------------------------------------------------- silent data corruption


def sdc_fault(endpoint: str,
              schedule: Optional[ChaosSchedule] = None
              ) -> Optional[Decision]:
    """Per-boundary silent-data-corruption hook (channel ``sdc``; the
    Manager polls it once per commit boundary with endpoint
    ``sdc:<replica_id>`` — docs/design/state_attestation.md).

    An ``sdc_flip`` decision is RETURNED for the caller to act on — it
    needs the committed params: flip one bit of one leaf, with the
    (leaf, byte, bit) choice derived from the decision's own ``frac``
    draw so the corruption sequence is a pure function of
    ``(seed, channel, n)`` like every other channel; the rate scales
    with the live intensity, so :class:`~torchft_tpu.policy.PhasedChaos`
    drives SDC storms unmodified. The caller must never poll while
    healing or benched: corrupting a transient mid-restore state would
    both wreck the freshly verified fetch and model a fault the
    attestation vote deliberately abstains on — the injection contract
    is post-commit, participants only (Manager._maybe_chaos_sdc guards
    it; frozen by tests/test_attestation.py)."""
    sched = schedule if schedule is not None else active()
    if sched is None:
        return None
    if sched.config_for(endpoint) is None:
        return None  # no decision draw (stream purity)
    d = sched.decide(endpoint, "sdc")
    if d is None or d.fault != "sdc_flip":
        return None
    return d


def slow_fault(endpoint: str,
               schedule: Optional[ChaosSchedule] = None) -> float:
    """Per-boundary step-stretch hook (channel ``slow``; the Manager
    polls it once per commit boundary with endpoint
    ``slow:<replica_id>`` — docs/design/fleet_rebalance.md).

    Returns the stretch multiplier for THIS boundary: ``slow_factor``
    when a ``slow`` decision fires, else ``1.0`` (no stretch — also
    when no schedule/config is active, with NO decision drawn: stream
    purity, like the sdc band). The caller stretches the step by
    sleeping ``(factor - 1) x`` its natural boundary wall — an honest
    straggler whose slowness the health plane measures end-to-end,
    not a clock hack. A persistent straggler is ``slow_rate=1`` on
    the endpoint; the rate scales with the live intensity, so a
    PhasedChaos walk mints the straggler in its storm phase and
    clears it in the next stable phase with no latch to forget. The
    injection contract mirrors the sdc band: participants only, once
    per boundary (Manager._maybe_chaos_slow guards it; frozen by
    tests/test_rebalance.py)."""
    sched = schedule if schedule is not None else active()
    if sched is None:
        return 1.0
    cfg = sched.config_for(endpoint)
    if cfg is None:
        return 1.0  # no decision draw (stream purity)
    d = sched.decide(endpoint, "slow")
    if d is None or d.fault != "slow":
        return 1.0
    return max(1.0, float(cfg.slow_factor))


# ------------------------------------------------------------ RAM faults


def ram_fault(endpoint: str, op: str = "serve",
              schedule: Optional[ChaosSchedule] = None
              ) -> Optional[Decision]:
    """Per-operation hook of the RAM checkpoint tier (channel ``ram``;
    :mod:`torchft_tpu.ram_ckpt` calls it with endpoint ``ram:<name>`` on
    every replication push, peer-image serve, and staged-PUT accept —
    docs/design/memory_tier.md).

    A dead latch (``kill_endpoint`` on the same name — the correlated
    K-peer death band) refuses the op outright with
    ``ConnectionRefusedError``, no RNG draw, like :func:`begin`.
    Otherwise one decision is drawn: ``ram_blackhole``/``blackhole``
    stall ``blackhole_ms`` then raise ``OSError(ETIMEDOUT)`` (transient
    class — the replication stall watchdog's territory);
    ``reset``/``short``/``kill`` raise ``ConnectionResetError`` (and
    ``kill`` latches the endpoint dead, so the whole peer stays dark);
    ``ram_loss`` is RETURNED for the store to act on — it needs the
    stored image to drop (silent peer-RAM loss only the next heal
    attempt can observe)."""
    import errno

    sched = schedule if schedule is not None else active()
    if sched is None:
        return None
    if sched.is_dead(endpoint):
        raise ConnectionRefusedError(
            f"[chaos] {endpoint}/{op}: connection refused (peer RAM "
            "host dead)")
    if sched.config_for(endpoint) is None:
        return None  # no decision draw (stream purity)
    d = sched.decide(endpoint, op)
    if d is None:
        return None
    if d.delay_ms > 0:
        time.sleep(d.delay_ms / 1e3)
    if d.fault in ("ram_blackhole", "blackhole"):
        time.sleep(d.blackhole_ms / 1e3)
        raise OSError(
            errno.ETIMEDOUT,
            f"[chaos] {endpoint}/{op}#{d.n}: RAM replication stalled, "
            "timed out")
    if d.fault == "kill":
        sched.kill_endpoint(endpoint)
        raise ConnectionResetError(
            f"[chaos] {endpoint}/{op}#{d.n}: connection reset by peer "
            "(peer RAM host died)")
    if d.fault in ("reset", "short"):
        raise ConnectionResetError(
            f"[chaos] {endpoint}/{op}#{d.n}: connection reset by peer "
            "(replication stream lost)")
    return d


# ------------------------------------------------------------- sockets


class ChaosSocket:
    """Socket proxy injecting the schedule's faults at IO time.

    Wraps ``send``/``sendall``/``recv``/``recv_into``; everything else
    delegates. A reset/short fault also closes the real socket so the
    peer observes the failure too (bilateral, like a real RST). A
    black-hole stalls up to ``min(blackhole_ms, socket timeout)`` and
    raises ``socket.timeout``.
    """

    def __init__(self, sock: socket.socket, endpoint: str,
                 schedule: ChaosSchedule,
                 from_global: bool = False) -> None:
        self._sock = sock
        self._endpoint = endpoint
        self._schedule = schedule
        # Wrapped off the process-wide schedule: honor a later
        # uninstall() — long-lived sockets (the ring) must fall quiet
        # when the soak harness ends the chaotic phase.
        self._from_global = from_global

    def __getattr__(self, name: str) -> Any:
        return getattr(self._sock, name)

    def _pre(self, op: str) -> Optional[Decision]:
        if self._from_global and active() is not self._schedule:
            return None
        if self._schedule.is_dead(self._endpoint):
            self._abort()
            raise ConnectionResetError(
                f"[chaos] {self._endpoint}/{op}: connection reset by "
                "peer (endpoint dead)")
        d = self._schedule.decide(self._endpoint, op)
        if d is None:
            return None
        if d.delay_ms > 0:
            time.sleep(d.delay_ms / 1e3)
        if d.fault == "kill":
            self._schedule.kill_endpoint(self._endpoint)
            self._abort()
            raise ConnectionResetError(
                f"[chaos] {self._endpoint}/{op}#{d.n}: connection reset "
                "by peer (peer process died)")
        if d.fault == "blackhole":
            tmo = self._sock.gettimeout()
            stall = d.blackhole_ms / 1e3
            if tmo is not None:
                stall = min(stall, tmo)
            time.sleep(stall)
            raise socket.timeout(
                f"[chaos] {self._endpoint}/{op}#{d.n}: black-holed")
        if d.fault == "reset":
            self._abort()
            raise ConnectionResetError(
                f"[chaos] {self._endpoint}/{op}#{d.n}: "
                "connection reset by peer")
        return d

    def _abort(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _short_write(self, data, d: Decision) -> None:
        """Transfer a partial prefix, then abort — the one spelling of
        the short-write fault shared by send and sendall."""
        part = max(1, int(len(data) * d.frac))
        try:
            self._sock.sendall(memoryview(data)[:part])
        finally:
            self._abort()
        raise ConnectionResetError(
            f"[chaos] {self._endpoint}/send#{d.n}: short write "
            f"({part}/{len(data)} bytes), connection reset")

    def send(self, data, *args) -> int:
        d = self._pre("send")
        if d is not None and d.fault == "short":
            self._short_write(data, d)
        return self._sock.send(data, *args)

    def sendall(self, data, *args) -> None:
        d = self._pre("send")
        if d is not None and d.fault == "short":
            self._short_write(data, d)
        return self._sock.sendall(data, *args)

    def recv(self, bufsize: int, *args) -> bytes:
        d = self._pre("recv")
        if d is not None and d.fault == "short" and bufsize > 1:
            got = self._sock.recv(max(1, int(bufsize * d.frac)), *args)
            self._abort()
            raise ConnectionResetError(
                f"[chaos] {self._endpoint}/recv#{d.n}: short read "
                f"({len(got)}/{bufsize} bytes), connection reset")
        return self._sock.recv(bufsize, *args)

    def recv_into(self, buffer, nbytes: int = 0, *args) -> int:
        d = self._pre("recv")
        n = nbytes or len(buffer)
        if d is not None and d.fault == "short" and n > 1:
            part = max(1, int(n * d.frac))
            self._sock.recv_into(memoryview(buffer)[:part], part, *args)
            self._abort()
            raise ConnectionResetError(
                f"[chaos] {self._endpoint}/recv#{d.n}: short read "
                f"({part}/{n} bytes), connection reset")
        return self._sock.recv_into(buffer, nbytes, *args)


def wrap_socket(sock: socket.socket, endpoint: str,
                schedule: Optional[ChaosSchedule] = None):
    """Wrap ``sock`` when chaos targets ``endpoint``; pass through (zero
    overhead) otherwise. Transport code calls this unconditionally."""
    sched = schedule if schedule is not None else active()
    if sched is None or sched.config_for(endpoint) is None:
        return sock
    return ChaosSocket(sock, endpoint, sched, from_global=schedule is None)


class _ChaosReader:
    """File-like read shim for streamed HTTP bodies (the heal fetch):
    injects latency/short-read/reset per ``read()`` call."""

    def __init__(self, raw: Any, endpoint: str,
                 schedule: ChaosSchedule) -> None:
        self._raw = raw
        self._endpoint = endpoint
        self._schedule = schedule

    def __getattr__(self, name: str) -> Any:
        return getattr(self._raw, name)

    def read(self, n: int = -1) -> bytes:
        if self._schedule.is_dead(self._endpoint):
            # The peer died while this stream was open: RST mid-read.
            raise ConnectionResetError(
                f"[chaos] {self._endpoint}/read: connection reset by "
                "peer (endpoint dead)")
        allow = self._schedule.kill_allowance(self._endpoint)
        if allow is not None:
            if allow <= 0:
                self._schedule.kill_endpoint(self._endpoint)
                raise ConnectionResetError(
                    f"[chaos] {self._endpoint}/read: connection reset "
                    "by peer (peer process died)")
            if n is None or n < 0 or n > allow:
                # Clamp so the hangup lands at the exact configured byte
                # offset; note_bytes latches the endpoint dead when the
                # clamped read delivers the final allowed bytes.
                n = allow
        d = self._schedule.decide(self._endpoint, "read")
        if d is not None:
            if d.delay_ms > 0:
                time.sleep(d.delay_ms / 1e3)
            if d.fault == "blackhole":
                time.sleep(d.blackhole_ms / 1e3)
                raise TimeoutError(
                    f"[chaos] {self._endpoint}/read#{d.n}: black-holed, "
                    "timed out")
            if d.fault == "kill":
                self._schedule.kill_endpoint(self._endpoint)
                raise ConnectionResetError(
                    f"[chaos] {self._endpoint}/read#{d.n}: connection "
                    "reset by peer (peer process died)")
            if d.fault == "reset":
                raise ConnectionResetError(
                    f"[chaos] {self._endpoint}/read#{d.n}: "
                    "connection reset by peer")
            if d.fault == "short" and n is not None and n > 1:
                self._raw.read(max(1, int(n * d.frac)))
                raise ConnectionResetError(
                    f"[chaos] {self._endpoint}/read#{d.n}: short read, "
                    "connection reset")
        data = self._raw.read(n)
        if data:
            # kill_after_bytes: the bytes that crossed the threshold are
            # still delivered (the peer's last packets), the NEXT read
            # hits the dead latch — a mid-stream hangup at a
            # deterministic byte offset.
            self._schedule.note_bytes(self._endpoint, len(data))
        return data

    def readinto(self, b) -> int:
        # load_pytree_from may use readinto on some paths; route through
        # read() so faults apply uniformly.
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)


def wrap_reader(raw: Any, endpoint: str,
                schedule: Optional[ChaosSchedule] = None) -> Any:
    """Wrap a readable stream when chaos targets ``endpoint``."""
    sched = schedule if schedule is not None else active()
    if sched is None or sched.config_for(endpoint) is None:
        return raw
    return _ChaosReader(raw, endpoint, sched)


# --------------------------------------------------------- communicator


class ChaosCommunicator(Communicator):
    """Fault-injecting shim around any Communicator: the manager's
    allreduce path sees latency/resets without touching the backend.

    Faults surface as :class:`CommunicatorError` (sync raise or failed
    Future per the decision's phase) — exactly how a real backend failure
    arrives, so the ErrorSwallowing/commit-vote machinery above is
    exercised unmodified.
    """

    def __init__(self, comm: Communicator,
                 schedule: Optional[ChaosSchedule] = None,
                 endpoint: str = "allreduce") -> None:
        self._comm = comm
        self._schedule = schedule
        self._endpoint = endpoint

    def _sched(self) -> Optional[ChaosSchedule]:
        return self._schedule if self._schedule is not None else active()

    def _inject(self, op: str, submit) -> Future:
        sched = self._sched()
        if sched is None:
            return submit()
        d = sched.decide(f"{self._endpoint}:{op}", op)
        if d is None:
            return submit()
        if d.delay_ms > 0:
            time.sleep(d.delay_ms / 1e3)
        err = CommunicatorError(
            f"[chaos] {self._endpoint}/{op}#{d.n}: connection reset by "
            "peer")
        if d.fault == "blackhole":
            time.sleep(d.blackhole_ms / 1e3)
            raise CommunicatorError(
                f"[chaos] {self._endpoint}/{op}#{d.n}: black-holed, "
                "timed out")
        if d.fault in ("reset", "short"):
            if d.phase == "pre":
                raise err
            fut: Future = Future()
            fut.set_exception(err)
            return fut
        return submit()

    def configure(self, store_addr: str, rank: int,
                  world_size: int) -> None:
        self._comm.configure(store_addr, rank, world_size)

    def allreduce(self, tree: Any, op: str = "sum") -> Future:
        return self._inject("allreduce",
                            lambda: self._comm.allreduce(tree, op))

    def allreduce_wire(self, buffers: Any, orig_dtypes: Any,
                       op: str = "sum") -> Future:
        # Own op stream: the wire path's decision sequence stays
        # reproducible independent of how many plain allreduces ran.
        return self._inject(
            "allreduce_wire",
            lambda: self._comm.allreduce_wire(buffers, orig_dtypes, op))

    def reduce_scatter_wire(self, buffers: Any, orig_dtypes: Any,
                            op: str = "sum") -> Future:
        # Own op stream, like allreduce_wire: the sharded-update path's
        # decision sequence stays reproducible regardless of how many
        # other collectives ran.
        return self._inject(
            "reduce_scatter_wire",
            lambda: self._comm.reduce_scatter_wire(
                buffers, orig_dtypes, op))

    def broadcast(self, tree: Any, root: int = 0) -> Future:
        return self._inject("broadcast",
                            lambda: self._comm.broadcast(tree, root))

    def allgather(self, tree: Any) -> Future:
        return self._inject("allgather",
                            lambda: self._comm.allgather(tree))

    def size(self) -> int:
        return self._comm.size()

    def rank(self) -> int:
        return self._comm.rank()

    @property
    def wants_device_arrays(self) -> bool:
        return self._comm.wants_device_arrays

    def set_allreduce_config_fingerprint(self, fp: str) -> None:
        self._comm.set_allreduce_config_fingerprint(fp)

    def set_retry_policy(self, policy: Any, stats: Any = None) -> None:
        self._comm.set_retry_policy(policy, stats)

    def set_tracer(self, tracer: Any) -> None:
        self._comm.set_tracer(tracer)

    def set_wire_tag(self, tag: str) -> None:
        self._comm.set_wire_tag(tag)

    def set_wire_weight(self, weight: int) -> None:
        self._comm.set_wire_weight(weight)

    def ring_bytes_total(self) -> float:
        return self._comm.ring_bytes_total()

    def int8_ring_bytes_total(self) -> float:
        return self._comm.int8_ring_bytes_total()

    def ring_time_ms_total(self) -> Dict[str, float]:
        return self._comm.ring_time_ms_total()

    def ring_topology(self) -> str:
        return self._comm.ring_topology()

    def hier_intra_bytes_total(self) -> float:
        return self._comm.hier_intra_bytes_total()

    def hier_leader(self) -> float:
        return self._comm.hier_leader()

    def hier_leader_bytes_total(self) -> float:
        return self._comm.hier_leader_bytes_total()

    def shutdown(self) -> None:
        self._comm.shutdown()


# ------------------------------------------------------ churn orchestration


class ChurnOrchestrator:
    """Seeded Poisson preemption driver for churn soaks
    (docs/design/churn.md): the spot/preemptible operating regime —
    groups are reclaimed continuously (a mix of *graceful* 2-minute
    notices and outright SIGKILLs) and cold replacements come back
    after a respawn delay — reduced to a deterministic event stream.

    Pure scheduling logic, no IO: the harness supplies callbacks and
    drives :meth:`tick` with its own clock (wall time in a soak, a
    simulated clock in unit tests — same seed + same tick times ⇒ the
    identical event trace, which is what makes a churn soak
    debuggable).

    Args:
        seed: event-stream seed (victim choice, graceful-vs-kill coin,
            Poisson inter-arrival draws).
        groups: initial live group ids.
        rate_per_min: expected preemptions per minute across the fleet
            (the Poisson intensity; as a fraction of an N-group fleet
            this is ``rate_per_min / N`` per minute — the bench's
            "%/min" knob). :meth:`set_rate` moves it live
            (:class:`~torchft_tpu.policy.PhasedChaos`-style phases).
        graceful_frac: probability a preemption is a *noticed* reclaim
            (the ``notify`` callback — e.g. ``request_preemption``)
            instead of a hard kill (``kill``).
        notify / kill / replace: callbacks taking the group id; any may
            be None (the event is still drawn and recorded, keeping
            the stream identical across A/B legs that wire different
            callbacks).
        replace_delay_s: cold-replacement respawn delay; ``replace``
            fires once the delay elapses. Negative = never replace.
        min_live: never preempt below this many live groups (the soak
            must keep a survivor to measure).
    """

    def __init__(self, seed: int, groups: Any, rate_per_min: float,
                 graceful_frac: float = 0.5,
                 notify: Optional[Any] = None,
                 kill: Optional[Any] = None,
                 replace: Optional[Any] = None,
                 replace_delay_s: float = 0.0,
                 min_live: int = 1) -> None:
        self._rng = random.Random(f"churn:{seed}")
        self.live = set(groups)
        self.dead: Dict[Any, float] = {}  # gid -> respawn due time
        self._rate = float(rate_per_min)
        self.graceful_frac = float(graceful_frac)
        self._notify, self._kill, self._replace = notify, kill, replace
        self.replace_delay_s = float(replace_delay_s)
        self.min_live = int(min_live)
        self._next: Optional[float] = None  # next preemption due time
        self.events: List[tuple] = []  # (t, kind, gid) trace
        self.notices = 0
        self.kills = 0
        self.replacements = 0
        self.skipped_min_live = 0

    def set_rate(self, rate_per_min: float) -> None:
        """Move the Poisson intensity live (phase walker hook). The
        next inter-arrival is re-drawn at the new rate from the next
        tick, so a storm phase takes effect within one tick."""
        if float(rate_per_min) != self._rate:
            self._rate = float(rate_per_min)
            self._next = None  # re-draw at the new intensity

    def _draw_next(self, now: float) -> Optional[float]:
        if self._rate <= 0.0:
            return None
        # Exponential inter-arrival (Poisson process), minutes -> s.
        return now + self._rng.expovariate(self._rate / 60.0)

    def tick(self, now: float) -> List[tuple]:
        """Process every event due by ``now``; returns the actions
        fired this tick as ``(t, kind, gid)`` with kind in
        ``notice | kill | replace | skip``."""
        fired: List[tuple] = []
        # Respawns first: a replacement coming back is what keeps the
        # fleet from draining to min_live and starving the stream.
        for gid in sorted(self.dead, key=str):
            due = self.dead[gid]
            if due <= now:
                del self.dead[gid]
                self.live.add(gid)
                self.replacements += 1
                fired.append((now, "replace", gid))
                if self._replace is not None:
                    self._replace(gid)
        if self._next is None:
            self._next = self._draw_next(now)
        while self._next is not None and self._next <= now:
            t = self._next
            self._next = self._draw_next(t)
            # Draw victim + coin even when the event must be skipped:
            # the stream stays identical across legs and rate regimes.
            pool = sorted(self.live, key=str)
            if not pool:
                continue
            gid = self._rng.choice(pool)
            graceful = self._rng.random() < self.graceful_frac
            if len(self.live) <= self.min_live:
                self.skipped_min_live += 1
                fired.append((t, "skip", gid))
                continue
            self.live.discard(gid)
            if self.replace_delay_s >= 0.0:
                self.dead[gid] = t + self.replace_delay_s
            if graceful:
                self.notices += 1
                fired.append((t, "notice", gid))
                if self._notify is not None:
                    self._notify(gid)
            else:
                self.kills += 1
                fired.append((t, "kill", gid))
                if self._kill is not None:
                    self._kill(gid)
        self.events.extend(fired)
        return fired
