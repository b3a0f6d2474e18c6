"""Fleet health plane: digest aggregation, straggler attribution, SLOs
(docs/design/fleet_health.md).

At 64-256 replica groups the per-group surfaces (``/metrics.json``,
``/trace.json``) answer "what is THIS group doing" but not the question
an operator actually asks: *which group is slowing the quorum, why, and
is the job inside its SLOs?* This module is the pure-Python spelling of
the fleet health plane the Lighthouse runs natively
(``_core/lighthouse.cc``):

* :class:`StepDigest` — the compact per-step metric digest every
  manager piggybacks on its quorum RPC beat (step wall, stage splits
  from the tracer, heal/publish activity, policy rung, capacity,
  churn). Mirrors proto ``StepDigest`` field for field.
* :class:`FleetAggregator` — bounded per-group digest rings plus the
  ranking/attribution math: fleet p50/p95/max step time, per-stage
  fleet medians, and a robust-z **straggler score** per group
  attributed to its slowest stage. This is the SAME math
  ``lighthouse.cc`` serves at ``GET /fleet/status.json`` — kept here in
  Python so it is tier-1-testable without the native toolchain, and so
  the nightly churn soak can cross-check the native endpoint against
  it.
* :class:`SLOEngine` — declarative thresholds (``TORCHFT_SLO`` /
  ``--slo``) evaluated against the aggregate; a breach names the
  guilty group so the flight-recorder dump lands on the straggler
  itself, deduped per (slo, group, step).
* Renderers — ``status_prometheus`` (the ``GET /fleet/metrics``
  exposition), :func:`format_fleet_table` (the ``lighthouse.py
  --dashboard`` terminal view), :func:`resolve_trace_addrs` (the
  ``scripts/tracefleet.py --fleet`` address resolution).

Observability first: the straggler score and SLO hints are SIGNALS
(``PolicySignals.fleet_p95_ms`` / ``straggler_score``, flight dumps) —
nothing here evicts a group.
"""

from __future__ import annotations

import os
import re
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

FLEET_FORMAT = "tft-fleet-1"

# Stage split carried by every digest, in protocol order. The
# attribution tie-break follows this order too ("fetch" wins a tie) —
# frozen by tests/test_fleet.py.
DIGEST_STAGES = ("fetch", "ring", "put", "vote")

# Robust z-score scale: 1/Phi^-1(3/4), the consistency constant that
# makes MAD estimate sigma under normality. The SAME constant is spelled
# in lighthouse.cc's aggregator — the two implementations must rank
# identically.
MAD_SIGMA = 1.4826

# Read-time freshness floor (ms) for baseline / attestation-vote
# membership: below this a single scheduling hiccup could bounce a
# healthy group out of the baseline between two normal boundaries.
MIN_FRESH_MS = 2_000

# How many boundary intervals a group may miss before its last digest
# stops shaping baselines and votes at read time (~2 missed boundaries;
# the 0.5 covers a row legitimately aged up to one interval at read
# time). Same constant in lighthouse.cc — the mirror contract.
FRESH_INTERVALS = 2.5

# The declarative SLO knobs (docs/design/fleet_health.md). Spec string:
# "step_p95_ms=2500;commit_rate=0.95;heal_ms=60000;publish_lag_ms=5000;
#  staleness_ms=30000" — ';' or ',' separated, unknown keys rejected.
SLO_KEYS = ("step_p95_ms", "commit_rate", "heal_ms", "publish_lag_ms",
            "staleness_ms")


def _now_ms() -> int:
    return time.monotonic_ns() // 1_000_000


@dataclass
class StepDigest:
    """One group's per-step telemetry digest (proto ``StepDigest``).

    Attached to the quorum RPC beat once per commit boundary by
    ``Manager._publish_status`` — a few dozen bytes, absent entirely
    when fleet telemetry is off (raw clients stay bit-exact)."""

    replica_id: str = ""
    step: int = 0
    step_wall_ms: float = 0.0
    # Stage splits, from the tracer's per-step span totals
    # (``Tracer.stage_totals``): fetch = fetch_dispatch + fetch_wait.
    fetch_ms: float = 0.0
    ring_ms: float = 0.0
    put_ms: float = 0.0
    vote_ms: float = 0.0
    heal_bytes_inflight: float = 0.0
    publish_bytes_inflight: float = 0.0
    policy_rung: int = -1
    capacity_fraction: float = 1.0
    churn_per_min: float = 0.0
    healing: bool = False
    # Last heal / publish wall this boundary (0 when none happened):
    # the heal-duration and publish-lag SLO inputs.
    heal_last_ms: float = 0.0
    publish_last_ms: float = 0.0
    # The group's checkpoint-server base address — where /trace.json
    # and /metrics live. Lets tracefleet resolve the fleet from
    # /fleet/status.json with no quorum-store access.
    trace_addr: str = ""
    # State attestation (docs/design/state_attestation.md): the quorum
    # incarnation the digest was computed under and the device-fused
    # committed-params fingerprint ("" = attestation off). The majority
    # vote keys on (quorum_id, step) so digests from different quorum
    # incarnations — whose memberships may legitimately hold different
    # state mid-transition — never cross-compare.
    quorum_id: int = -1
    state_digest: str = ""
    # Fleet rebalancing (docs/design/fleet_rebalance.md): the rebalance
    # batch fraction that was IN FORCE for the step this digest
    # measures (1.0 = full slice). Kept separate from
    # capacity_fraction — a rebalanced group is NOT degraded and stays
    # in the straggler baseline; the Rebalancer divides the wall by
    # this to judge the group at its would-be full-batch pace.
    rebalance_fraction: float = 1.0

    def stage_ms(self) -> Dict[str, float]:
        return {"fetch": self.fetch_ms, "ring": self.ring_ms,
                "put": self.put_ms, "vote": self.vote_ms}

    def baseline_eligible(self) -> bool:
        """Whether this digest may shape the fleet baseline: healers
        and degraded-capacity groups are legitimately slow, so they are
        EXCLUDED from the median/MAD (and never ranked straggler) —
        their slowness is already explained."""
        return not self.healing and self.capacity_fraction >= 0.999


def _median(vals: List[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, int(len(s) * q))]


def robust_zscores(values: List[float]) -> List[float]:
    """Robust z-score of each value vs the set's median, scaled by
    ``MAD_SIGMA * MAD``. A zero MAD (uniform fleet, or a single group)
    yields all-zero scores — never a NaN/inf: an undispersed fleet has
    no straggler, and the score must stay a safe PolicySignals input."""
    if not values:
        return []
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    denom = MAD_SIGMA * mad
    if denom <= 1e-9:
        return [0.0 for _ in values]
    return [(v - med) / denom for v in values]


def attribute_stage(stage_ms: Dict[str, float],
                    stage_median_ms: Dict[str, float]) -> str:
    """Name the stage most responsible for a group's slowness: the one
    with the largest excess over the fleet's per-stage median (ties
    break in DIGEST_STAGES protocol order). Falls back to the group's
    own largest stage when it beats every median (then nothing is "in
    excess", but the answer to "where does its time go" still is its
    biggest stage)."""
    best, best_excess = "", float("-inf")
    for s in DIGEST_STAGES:
        excess = stage_ms.get(s, 0.0) - stage_median_ms.get(s, 0.0)
        if excess > best_excess + 1e-12:
            best, best_excess = s, excess
    if best_excess <= 0.0:
        biggest = max(DIGEST_STAGES,
                      key=lambda s: (stage_ms.get(s, 0.0),
                                     -DIGEST_STAGES.index(s)))
        return biggest if stage_ms.get(biggest, 0.0) > 0.0 else ""
    return best


# ------------------------------------------------------------- rebalancing
# Straggler-aware fleet rebalancing (docs/design/fleet_rebalance.md).
# Every constant below is spelled identically in lighthouse.cc — the
# mirror contract: both sides must compute bit-identical fraction
# tables from the same digest stream.

# Bounded skew: no group's data slice ever shrinks below half a batch
# (beyond that, evict — see docs/pod_runbook.md) or grows past 1.5x
# (a boosted group must not become the new straggler).
REBALANCE_FLOOR = 0.5
REBALANCE_CEIL = 1.5
# Ladder granularity: fractions move in exact-binary eighths so the
# C++/Python mirrors cannot drift through accumulated rounding.
REBALANCE_STEP = 0.125
# Multiplicative hysteresis band on the NORMALIZED wall (wall divided
# by the fraction in force) vs the fleet median: "loud" at >= HI x
# median, "quiet" at <= LO x median, dead zone between. A ratio, not
# the MAD-scaled z the straggler *ranking* uses: MAD collapses to zero
# in small uniform-but-for-one fleets (all-zero scores), and the
# restore half needs a threshold that stays meaningful at the shrunken
# equilibrium where the slow group's raw wall matches the fleet's.
REBALANCE_HI = 1.5
REBALANCE_LO = 1.15
# PolicyController-style persistence/cooldown (policy.py): shrink one
# rung after PERSIST consecutive loud boundaries, restore one rung
# after RELAX consecutive quiet ones, never move twice within COOLDOWN
# boundaries of the same group — a transient stall never flaps the
# fleet.
REBALANCE_PERSIST = 3
REBALANCE_RELAX = 6
REBALANCE_COOLDOWN = 4


def format_rebalance_table(fractions: Dict[str, float]) -> str:
    """Canonical wire spelling of a fraction table: ``rid=frac`` pairs,
    comma-joined, sorted by replica_id, fractions at fixed %.4f (the
    exact format lighthouse.cc emits — the decider publishes this
    string verbatim, and mirror parity is asserted on it). Groups at
    exactly 1.0 are omitted: an empty table means a uniform fleet."""
    return ",".join(f"{rid}={fractions[rid]:.4f}"
                    for rid in sorted(fractions)
                    if abs(fractions[rid] - 1.0) > 1e-9)


def parse_rebalance_table(table: str) -> Dict[str, float]:
    """Inverse of :func:`format_rebalance_table`; malformed entries are
    dropped (an old/corrupt table must never poison adoption — a group
    absent from the table is simply at 1.0)."""
    out: Dict[str, float] = {}
    for part in table.split(","):
        rid, sep, val = part.rpartition("=")
        if not sep or not rid:
            continue
        try:
            frac = float(val)
        except ValueError:
            continue
        if REBALANCE_FLOOR - 1e-9 <= frac <= REBALANCE_CEIL + 1e-9:
            out[rid] = frac
    return out


class Rebalancer:
    """Straggler-aware batch-fraction ladder — the pure-Python mirror
    of the lighthouse-side rebalancer (docs/design/fleet_rebalance.md).

    Watches each group's NORMALIZED step wall (wall / the rebalance
    fraction in force when it was measured — so a shrunken group is
    judged at its would-be full-batch pace, which is what prevents the
    shrink -> wall normalizes -> restore -> shrink flap) against the
    fleet median, and walks a per-group fraction ladder with
    PolicyController-style persistence, hysteresis and cooldown:

    * ``>= REBALANCE_HI x median`` for ``REBALANCE_PERSIST``
      consecutive boundaries: shrink one ``REBALANCE_STEP`` rung,
      never below ``REBALANCE_FLOOR``;
    * ``<= REBALANCE_LO x median`` for ``REBALANCE_RELAX`` consecutive
      boundaries: restore one rung toward 1.0 (recovery is symmetric,
      deliberately slower than descent);
    * the dead zone between resets both streaks, and no group moves
      twice within ``REBALANCE_COOLDOWN`` of its own boundaries.

    The fleet sample total is conserved: the trimmed slice is
    reallocated evenly across the headroom groups (ladder fraction
    1.0, eligible), capped at ``REBALANCE_CEIL``. Boosts are DERIVED
    per observation, not ladder state — they follow the shrink ladder
    deterministically and cannot flap on their own.

    Observations are step-driven, not poll-driven: a digest whose step
    has not advanced since the group's last observation is ignored, so
    aggregate-recompute cadence (the lighthouse's 200 ms cache, a
    dashboard poller) never inflates the ladder clock.

    Not thread-safe; the owner (FleetAggregator here, fleet_mu_ in the
    lighthouse) serializes."""

    def __init__(self, floor: float = REBALANCE_FLOOR,
                 ceil: float = REBALANCE_CEIL,
                 step: float = REBALANCE_STEP,
                 hi: float = REBALANCE_HI, lo: float = REBALANCE_LO,
                 persist: int = REBALANCE_PERSIST,
                 relax: int = REBALANCE_RELAX,
                 cooldown: int = REBALANCE_COOLDOWN) -> None:
        self.floor = float(floor)
        self.ceil = float(ceil)
        self.step = float(step)
        self.hi = float(hi)
        self.lo = float(lo)
        self.persist = int(persist)
        self.relax = int(relax)
        self.cooldown = int(cooldown)
        # replica_id -> ladder state. The ladder fraction is the only
        # durable state; boosts are derived each observation.
        self._state: Dict[str, Dict[str, Any]] = {}
        self._table = ""
        self._seq = 0
        self.shrinks_total = 0
        self.restores_total = 0

    def _st(self, rid: str) -> Dict[str, Any]:
        st = self._state.get(rid)
        if st is None:
            st = self._state[rid] = {"fraction": 1.0, "loud": 0,
                                     "quiet": 0, "cooldown": 0,
                                     "last_step": None,
                                     "eligible": False}
        return st

    def forget(self, rid: str) -> None:
        """Farewell/eviction clears the group's fraction immediately:
        its slice is gone, and the next observation re-derives the
        survivors' boosts without it."""
        self._state.pop(rid, None)

    def observe(self, rows: List[Tuple[str, int, float, float, bool]]) \
            -> Dict[str, float]:
        """Advance the ladder one aggregate and return the target
        fraction table (every tracked group, including 1.0 entries).

        ``rows``: one ``(replica_id, step, step_wall_ms,
        reported_fraction, eligible)`` per group currently in the
        aggregate. ``reported_fraction`` is the digest's own
        ``rebalance_fraction`` — the fraction actually in force for
        the measured step, which may trail the assigned one by an
        adoption boundary. ``eligible`` is the straggler-baseline flag
        (fresh, not healing, full capacity): ineligible rows keep
        their ladder fraction sticky but take no observation. Groups
        absent from ``rows`` are dropped (departed)."""
        present = {r[0] for r in rows}
        for rid in [r for r in self._state if r not in present]:
            self._state.pop(rid, None)

        rows = sorted(rows, key=lambda r: r[0])
        norm: Dict[str, float] = {}
        for rid, _step, wall, reported, eligible in rows:
            if eligible:
                rep = min(self.ceil, max(self.floor, float(reported)))
                norm[rid] = float(wall) / rep
        med = _median(list(norm.values()))

        for rid, step, _wall, _reported, eligible in rows:
            st = self._st(rid)
            st["eligible"] = bool(eligible)
            if not eligible:
                # A healer/degraded/stale row is not comparable: freeze
                # the ladder (sticky fraction) and restart persistence.
                st["loud"] = st["quiet"] = 0
                continue
            if st["last_step"] is not None and step == st["last_step"]:
                continue  # no new boundary: not a new observation
            st["last_step"] = step
            if st["cooldown"] > 0:
                st["cooldown"] -= 1
            if med <= 1e-9:
                st["loud"] = st["quiet"] = 0
                continue
            ratio = norm[rid] / med
            if ratio >= self.hi:
                st["loud"] += 1
                st["quiet"] = 0
                if (st["loud"] >= self.persist and st["cooldown"] == 0
                        and st["fraction"] > self.floor + 1e-9):
                    st["fraction"] = max(self.floor,
                                         st["fraction"] - self.step)
                    st["cooldown"] = self.cooldown
                    st["loud"] = 0
                    self.shrinks_total += 1
            elif ratio <= self.lo:
                st["quiet"] += 1
                st["loud"] = 0
                if (st["quiet"] >= self.relax and st["cooldown"] == 0
                        and st["fraction"] < 1.0 - 1e-9):
                    st["fraction"] = min(1.0,
                                         st["fraction"] + self.step)
                    st["cooldown"] = self.cooldown
                    st["quiet"] = 0
                    self.restores_total += 1
            else:
                st["loud"] = st["quiet"] = 0

        fractions = self.fractions()
        table = format_rebalance_table(fractions)
        if table != self._table:
            self._table = table
            self._seq += 1
        return fractions

    def fractions(self) -> Dict[str, float]:
        """Current target table: ladder fractions plus derived boosts.
        The trimmed mass ``sum(1 - ladder)`` over shrunk groups is
        reallocated evenly across headroom groups (ladder 1.0 AND
        eligible at the last observation — a shrunken group that went
        healing still counts as deficit, but a healer never receives
        boost), capped at ``REBALANCE_CEIL``; any remainder past the
        cap goes unallocated (the fleet total shrinks, logged by the
        caller rather than overloading the fast groups)."""
        deficit = sum(1.0 - st["fraction"]
                      for st in self._state.values()
                      if st["fraction"] < 1.0 - 1e-9)
        headroom = [rid for rid in sorted(self._state)
                    if self._state[rid]["fraction"] >= 1.0 - 1e-9
                    and self._state[rid]["eligible"]]
        out: Dict[str, float] = {}
        bonus = deficit / len(headroom) if headroom and deficit > 1e-9 \
            else 0.0
        for rid in sorted(self._state):
            st = self._state[rid]
            if st["fraction"] < 1.0 - 1e-9:
                out[rid] = st["fraction"]
            elif rid in headroom and bonus > 0.0:
                out[rid] = min(self.ceil, 1.0 + bonus)
            else:
                out[rid] = 1.0
        return out

    @property
    def table(self) -> str:
        return self._table

    @property
    def seq(self) -> int:
        return self._seq


class FleetAggregator:
    """Bounded per-group digest rings + the fleet aggregate.

    The native Lighthouse keeps the authoritative copy (lock-striped
    beside its ``BeatTable``); this mirror carries the identical math
    for tier-1 tests, the dashboard renderer, and soak cross-checks.
    Not thread-safe — callers (tests, the dashboard poller) own the
    synchronization.

    Args:
        ring: digests retained per group (the per-group history the
            dashboard's trend column reads; aggregates use the latest).
        stale_ms: a group whose newest digest is older than this is
            dropped from aggregates (and pruned) — a departed group
            must not linger as a phantom straggler.
        slo: when given, retention widens to ``2 * slo.staleness_ms``
            if that exceeds ``stale_ms`` — the staleness SLO must be
            able to SEE a silent group (one already dropped from the
            aggregates could never breach). Mirrors the native
            lighthouse's constructor behavior.
    """

    def __init__(self, ring: int = 8, stale_ms: int = 60_000,
                 slo: Optional["SLOConfig"] = None) -> None:
        self._ring = max(int(ring), 1)
        if slo is not None and slo.staleness_ms is not None:
            stale_ms = max(int(stale_ms), int(2 * slo.staleness_ms))
        self._stale_ms = max(int(stale_ms), 1)
        # replica_id -> deque[(recorded_ms, StepDigest)]
        self._groups: "OrderedDict[str, deque]" = OrderedDict()
        # replica_id -> (committed_steps, aborted_steps) — the beat
        # counters the commit-rate SLO reads (ride the same RPC).
        self._commit_counts: Dict[str, Tuple[int, int]] = {}
        # State attestation (docs/design/state_attestation.md):
        # replica_id -> verdict record for groups a majority vote found
        # divergent. STICKY — a verdict only clears when the group
        # later lands on the winning side of a vote (post-heal
        # re-attestation) or says farewell (remove()); a dead-without-
        # farewell group stays quarantined, since its last attested
        # state is still the corrupt one.
        self._quarantined: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()
        self._sdc_verdicts_total = 0
        self._sdc_clears_total = 0
        # Straggler-aware rebalancing (docs/design/fleet_rebalance.md):
        # advanced once per aggregate from the same latest-digest view
        # the straggler ranking reads. Always on — a uniform fleet
        # yields an empty table, and only rebalance-armed managers
        # adopt it.
        self.rebalancer = Rebalancer()
        # Publication relay tier (docs/design/serving.md): the latest
        # relay-table rows adopted via note_relays(). The publisher
        # owns TTL pruning; this is a mirror for export.
        self._relay_rows: List[Dict[str, Any]] = []

    def ingest(self, digest: StepDigest,
               now_ms: Optional[int] = None) -> None:
        if not digest.replica_id:
            return
        now = _now_ms() if now_ms is None else int(now_ms)
        ring = self._groups.get(digest.replica_id)
        if ring is None:
            ring = self._groups[digest.replica_id] = deque(
                maxlen=self._ring)
        ring.append((now, digest))

    def note_commit_counts(self, replica_id: str, committed: int,
                           aborted: int) -> None:
        self._commit_counts[replica_id] = (int(committed), int(aborted))

    def note_relays(self, rows: List[Dict[str, Any]]) -> None:
        """Adopt the publication tier's relay table
        (:meth:`torchft_tpu.serving.WeightPublisher.relay_rows` — rows
        already TTL-pruned and ``lag_gens``-annotated by the
        publisher). The aggregate and the Prometheus exposition then
        carry the relay tier beside the training fleet, so steering
        and operators read one signal."""
        self._relay_rows = [dict(r) for r in rows]

    def remove(self, replica_id: str) -> None:
        """Drop a departed group immediately (farewell / eviction): its
        history must not shape the baseline or linger in aggregates.
        A farewell also clears any divergence verdict — a clean
        shutdown's replacement rejoins behind max_step and heals from
        the attested majority before it can attest anything."""
        self._groups.pop(replica_id, None)
        self._commit_counts.pop(replica_id, None)
        self._quarantined.pop(replica_id, None)
        # Farewell clears the rebalance fraction immediately: the
        # departed slice must not keep inflating survivors' boosts.
        self.rebalancer.forget(replica_id)

    def prune(self, now_ms: Optional[int] = None) -> None:
        """Age out rows past stale_ms. Unlike a farewell, pruning does
        NOT clear a divergence verdict: a dead-without-farewell corpse's
        last attested state is still the corrupt one, and donor filters
        must keep excluding its address if a cached copy resurfaces."""
        now = _now_ms() if now_ms is None else int(now_ms)
        for rid in [rid for rid, ring in self._groups.items()
                    if not ring or now - ring[-1][0] > self._stale_ms]:
            self._groups.pop(rid, None)
            self._commit_counts.pop(rid, None)

    def group_ids(self) -> List[str]:
        return list(self._groups)

    def commit_counts(self) -> Dict[str, Tuple[int, int]]:
        return dict(self._commit_counts)

    def quarantined(self) -> Dict[str, Dict[str, Any]]:
        """Current divergence verdicts (copy): replica_id -> record
        with the minority/majority digests and the (quorum_id, step)
        the vote fired at."""
        return {rid: dict(rec) for rid, rec in self._quarantined.items()}

    def _fresh_bound_ms(self, ring: "deque") -> int:
        """Read-time freshness bound for baseline / vote membership.

        ``stale_ms`` (60 s default) exists for RETENTION — but a
        SIGKILLed group that never said farewell would keep feeding the
        straggler baseline (and the attestation vote) with its last
        digest for that whole minute. Estimate the group's own boundary
        cadence as the median inter-record interval of its ring and
        stop trusting rows older than ~2 missed boundaries
        (``FRESH_INTERVALS``), floored at ``MIN_FRESH_MS`` and capped
        at ``stale_ms``. Fewer than 2 observed intervals: no cadence
        estimate yet, fall back to ``stale_ms``."""
        if len(ring) >= 3:
            deltas = [ring[i + 1][0] - ring[i][0]
                      for i in range(len(ring) - 1)]
            deltas = [d for d in deltas if d > 0]
            if len(deltas) >= 2:
                interval = _median([float(d) for d in deltas])
                if interval > 0:
                    return int(min(float(self._stale_ms),
                                   max(FRESH_INTERVALS * interval,
                                       float(MIN_FRESH_MS))))
        return self._stale_ms

    def _attest_vote(self, latest: "OrderedDict[str, Tuple[int, StepDigest]]",
                     fresh: Dict[str, bool], now: int) -> None:
        """Majority vote per (quorum_id, step) over fresh, non-healing
        digests carrying a fingerprint (docs/design/state_attestation.md).

        Rules (identical in lighthouse.cc — the mirror contract):
        * a ballot needs a STRICT majority (> half the voters) to
          produce a verdict; a tie or a 50/50 split fails open — no
          group is quarantined on ambiguous evidence;
        * healers never vote: a mid-restore group's transient state is
          legitimately different and must not trip a false verdict;
        * minority groups latch into the sticky quarantined set; a
          quarantined group clears when a fresh digest of its matches
          the majority again (it healed and re-attested) — matching is
          enough, VOTING is not required: the quarantine latch itself
          reports the group healing/non-participating until cleared,
          so demanding a vote from it would deadlock the clear."""
        ballots: Dict[Tuple[int, int], Dict[str, List[str]]] = {}
        for rid, (_, d) in latest.items():
            if (not fresh.get(rid) or d.healing or not d.state_digest
                    or d.quorum_id < 0):
                continue
            ballots.setdefault((d.quorum_id, d.step), {}) \
                .setdefault(d.state_digest, []).append(rid)
        for (qid, step), by_digest in ballots.items():
            voters = sum(len(rids) for rids in by_digest.values())
            # max over (count, digest) — the digest tie-break is inert
            # (a tied winner fails the strict-majority check below) but
            # keeps iteration-order independence with the C++ mirror.
            winner, winner_rids = max(by_digest.items(),
                                      key=lambda kv: (len(kv[1]), kv[0]))
            if 2 * len(winner_rids) <= voters:
                continue  # no strict majority: fail open
            # Non-voter clear: a quarantined group's digests carry the
            # healing flag (its own latch benched it), so they are
            # never IN by_digest — but a fresh digest for this same
            # ballot that MATCHES the winner is proof the restore
            # landed and the bytes re-converged. Clear on match.
            for rid, (_, d) in latest.items():
                if (rid in self._quarantined and fresh.get(rid)
                        and d.state_digest == winner
                        and d.quorum_id == qid and d.step == step):
                    self._quarantined.pop(rid, None)
                    self._sdc_clears_total += 1
            for dg, rids in by_digest.items():
                for rid in rids:
                    if dg == winner:
                        if self._quarantined.pop(rid, None) is not None:
                            self._sdc_clears_total += 1
                    elif rid not in self._quarantined:
                        self._quarantined[rid] = {
                            "replica_id": rid,
                            "quorum_id": qid,
                            "step": step,
                            "digest": dg,
                            "majority_digest": winner,
                            "trace_addr": latest[rid][1].trace_addr,
                            "verdict_ms": now,
                        }
                        self._sdc_verdicts_total += 1

    # ------------------------------------------------------------ aggregate

    def aggregate(self, now_ms: Optional[int] = None) -> Dict[str, Any]:
        """The fleet aggregate (the ``GET /fleet/status.json`` shape).

        Latest fresh digest per group; baseline = non-healing,
        full-capacity groups (see ``StepDigest.baseline_eligible``).
        Scores are robust z vs the BASELINE's median/MAD; non-baseline
        groups score 0.0 with their exclusion reason as the
        attribution (``heal`` / ``degraded``) — their slowness is
        explained, and ranking them would bury the real straggler."""
        now = _now_ms() if now_ms is None else int(now_ms)
        latest: "OrderedDict[str, Tuple[int, StepDigest]]" = OrderedDict()
        fresh: Dict[str, bool] = {}
        for rid in sorted(self._groups):
            ring = self._groups[rid]
            if not ring:
                continue
            rec_ms, d = ring[-1]
            if now - rec_ms > self._stale_ms:
                continue
            latest[rid] = (rec_ms, d)
            # Read-time freshness (the dead-without-farewell fix): a
            # row older than ~2 of the group's own boundary intervals
            # stays VISIBLE (operators should see the silent group age
            # out) but stops shaping baselines and votes.
            fresh[rid] = (now - rec_ms) <= self._fresh_bound_ms(ring)

        self._attest_vote(latest, fresh, now)

        baseline = [(rid, d) for rid, (_, d) in latest.items()
                    if d.baseline_eligible() and fresh[rid]]
        walls = [d.step_wall_ms for _, d in baseline]

        # Rebalance ladder (docs/design/fleet_rebalance.md): one
        # observation per group per NEW step, from the same latest
        # view. Eligibility == the straggler-baseline flag; the digest
        # reports the fraction its measured step actually ran under.
        rebalance_fractions = self.rebalancer.observe(
            [(rid, d.step, d.step_wall_ms,
              getattr(d, "rebalance_fraction", 1.0),
              d.baseline_eligible() and fresh[rid])
             for rid, (_, d) in latest.items()])
        scores = robust_zscores(walls)
        score_by_id = {rid: sc for (rid, _), sc in zip(baseline, scores)}
        stage_median = {
            s: _median([d.stage_ms()[s] for _, d in baseline])
            for s in DIGEST_STAGES}

        groups: List[Dict[str, Any]] = []
        for rid, (rec_ms, d) in latest.items():
            in_baseline = d.baseline_eligible() and fresh[rid]
            score = score_by_id.get(rid, 0.0)
            if in_baseline:
                stage = attribute_stage(d.stage_ms(), stage_median)
            elif not fresh[rid]:
                stage = "stale"
            else:
                stage = "heal" if d.healing else "degraded"
            groups.append({
                "replica_id": rid,
                "step": d.step,
                "age_ms": now - rec_ms,
                "step_wall_ms": round(d.step_wall_ms, 3),
                "stage_ms": {k: round(v, 3)
                             for k, v in d.stage_ms().items()},
                "straggler_score": round(score, 4),
                "straggler_stage": stage,
                "healing": bool(d.healing),
                "capacity_fraction": d.capacity_fraction,
                "policy_rung": d.policy_rung,
                "churn_per_min": d.churn_per_min,
                "heal_bytes_inflight": d.heal_bytes_inflight,
                "publish_bytes_inflight": d.publish_bytes_inflight,
                "heal_last_ms": d.heal_last_ms,
                "publish_last_ms": d.publish_last_ms,
                "baseline": in_baseline,
                "rebalance_fraction": round(
                    rebalance_fractions.get(rid, 1.0), 4),
                "trace_addr": d.trace_addr,
                "attested": bool(d.state_digest) and fresh[rid]
                and not d.healing,
                "sdc_diverged": rid in self._quarantined,
            })
        groups.sort(key=lambda g: (-g["straggler_score"],
                                   g["replica_id"]))

        straggler = {"replica_id": "", "score": 0.0, "stage": ""}
        ranked = [g for g in groups if g["baseline"]]
        if ranked:
            # groups is already sorted (score desc, id asc): the first
            # baseline row IS the straggler — same tie-break as the
            # native aggregator and as this very table's ordering.
            top = ranked[0]
            straggler = {"replica_id": top["replica_id"],
                         "score": top["straggler_score"],
                         "stage": top["straggler_stage"]}
        return {
            "format": FLEET_FORMAT,
            "computed_ms": now,
            "fleet": {
                "groups": len(latest),
                "baseline_groups": len(baseline),
                "p50_ms": round(_percentile(walls, 0.50), 3),
                "p95_ms": round(_percentile(walls, 0.95), 3),
                "max_ms": round(max(walls), 3) if walls else 0.0,
                "stage_median_ms": {k: round(v, 3)
                                    for k, v in stage_median.items()},
                "sdc_quarantined": sorted(self._quarantined),
                "sdc_quarantined_addrs": sorted(
                    {rec.get("trace_addr", "")
                     for rec in self._quarantined.values()
                     if rec.get("trace_addr")}),
                "sdc_verdicts_total": self._sdc_verdicts_total,
                "sdc_clears_total": self._sdc_clears_total,
                # Rebalance fraction table (only entries != 1.0; the
                # canonical wire string is what the decider publishes).
                "rebalance_fractions": {
                    rid: round(f, 4)
                    for rid, f in rebalance_fractions.items()
                    if abs(f - 1.0) > 1e-9},
                "rebalance_table": self.rebalancer.table,
                "rebalance_seq": self.rebalancer.seq,
                "rebalance_shrinks_total":
                    self.rebalancer.shrinks_total,
                "rebalance_restores_total":
                    self.rebalancer.restores_total,
                "relays": len(self._relay_rows),
                "relay_children": sum(
                    int(r.get("children", 0)) for r in self._relay_rows),
                "relay_lag_gens_max": max(
                    (int(r.get("lag_gens", 0))
                     for r in self._relay_rows), default=0),
            },
            "straggler": straggler,
            "groups": groups,
            "relays": self._relay_rows,
        }


# -------------------------------------------------------------------- SLOs


@dataclass
class SLOConfig:
    """Declarative fleet SLO thresholds; ``None`` disables a check.

    * ``step_p95_ms`` — fleet p95 step wall; a breach is attributed to
      the current straggler group (the dump lands on the guilty group).
    * ``commit_rate`` — per-group committed/(committed+aborted) floor,
      judged only past ``min_commit_samples`` boundaries.
    * ``heal_ms`` — per-group last-heal duration ceiling.
    * ``publish_lag_ms`` — per-group last publish-to-visible wall
      ceiling.
    * ``staleness_ms`` — per-group digest age ceiling (a group that
      stopped reporting is itself an incident).
    """

    step_p95_ms: Optional[float] = None
    commit_rate: Optional[float] = None
    heal_ms: Optional[float] = None
    publish_lag_ms: Optional[float] = None
    staleness_ms: Optional[float] = None
    min_commit_samples: int = 8

    @classmethod
    def from_spec(cls, spec: str) -> "SLOConfig":
        """Parse the ``TORCHFT_SLO`` / ``--slo`` spec string (the SAME
        grammar lighthouse.cc parses): ``key=value`` pairs joined by
        ``;`` or ``,``. Unknown keys raise — a typo'd SLO silently
        never firing is worse than a startup error."""
        cfg = cls()
        for part in spec.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or key not in SLO_KEYS:
                raise ValueError(
                    f"bad SLO spec entry {part!r} (known keys: "
                    f"{', '.join(SLO_KEYS)})")
            # Plain NON-NEGATIVE decimal only: Python's float() accepts
            # spellings ("2_500", "nan") the C++ side's atof reads
            # DIFFERENTLY, and a negative threshold means "disabled"
            # to the C++ parser (< 0) but would read as a live
            # always-breaching bound here — the strict gate must
            # reject anything the two parsers could disagree on.
            # Disable an SLO by omitting its key.
            if not re.fullmatch(
                    r"[+]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", val):
                raise ValueError(
                    f"bad SLO threshold {val!r} for {key} "
                    "(plain non-negative decimal required; omit the "
                    "key to disable)")
            setattr(cfg, key, float(val))
        return cfg

    @classmethod
    def from_env(cls) -> "SLOConfig":
        return cls.from_spec(os.environ.get("TORCHFT_SLO", ""))

    def spec(self) -> str:
        parts = [f"{k}={getattr(self, k):g}" for k in SLO_KEYS
                 if getattr(self, k) is not None]
        return ";".join(parts)

    def enabled(self) -> bool:
        return any(getattr(self, k) is not None for k in SLO_KEYS)


class SLOEngine:
    """Evaluate an :class:`SLOConfig` against a fleet aggregate.

    ``evaluate`` returns only NEW breaches — deduped per
    ``(slo, replica_id, step)`` exactly like the flight recorder's
    per-(reason, step) dedup, so a breach that persists across quorum
    rounds of the same step emits one event, not one per round. The
    live ``active`` set (every (slo, group) currently out of SLO) backs
    the ``slo_breach`` gauge."""

    def __init__(self, config: SLOConfig) -> None:
        self.config = config
        self.breaches_total = 0
        self.active: List[Dict[str, Any]] = []
        self._seen: "OrderedDict[Tuple[str, str, int], None]" = \
            OrderedDict()

    def _breach(self, slo: str, replica_id: str, step: int,
                value: float, threshold: float) -> Dict[str, Any]:
        return {"slo": slo, "replica_id": replica_id, "step": int(step),
                "value": round(float(value), 3),
                "threshold": float(threshold)}

    def evaluate(self, status: Dict[str, Any],
                 commit_counts: Optional[Dict[str, Tuple[int, int]]]
                 = None) -> List[Dict[str, Any]]:
        cfg = self.config
        active: List[Dict[str, Any]] = []
        by_id = {g["replica_id"]: g for g in status.get("groups", [])}
        # GC dedup entries for groups that left the aggregate
        # (farewell/staleness) — same discipline as lighthouse.cc, so
        # churn of uuid-suffixed ids can't squeeze live groups' keys
        # out of the bounded dedup memory.
        for key in [k for k in self._seen if k[1] not in by_id]:
            del self._seen[key]

        if cfg.step_p95_ms is not None:
            p95 = status["fleet"]["p95_ms"]
            if p95 > cfg.step_p95_ms:
                guilty = status["straggler"]["replica_id"]
                g = by_id.get(guilty, {})
                active.append(self._breach(
                    "step_p95", guilty, g.get("step", 0), p95,
                    cfg.step_p95_ms))
        for g in by_id.values():
            rid, step = g["replica_id"], g.get("step", 0)
            if cfg.heal_ms is not None and \
                    g.get("heal_last_ms", 0.0) > cfg.heal_ms:
                active.append(self._breach(
                    "heal", rid, step, g["heal_last_ms"], cfg.heal_ms))
            if cfg.publish_lag_ms is not None and \
                    g.get("publish_last_ms", 0.0) > cfg.publish_lag_ms:
                active.append(self._breach(
                    "publish_lag", rid, step, g["publish_last_ms"],
                    cfg.publish_lag_ms))
            if cfg.staleness_ms is not None and \
                    g.get("age_ms", 0) > cfg.staleness_ms:
                active.append(self._breach(
                    "staleness", rid, step, g["age_ms"],
                    cfg.staleness_ms))
            if cfg.commit_rate is not None and commit_counts:
                committed, aborted = commit_counts.get(rid, (0, 0))
                total = committed + aborted
                if total >= cfg.min_commit_samples:
                    rate = committed / total
                    if rate < cfg.commit_rate:
                        active.append(self._breach(
                            "commit_rate", rid, step, rate,
                            cfg.commit_rate))

        self.active = active
        fresh: List[Dict[str, Any]] = []
        for b in active:
            key = (b["slo"], b["replica_id"], b["step"])
            if key in self._seen:
                continue
            self._seen[key] = None
            while len(self._seen) > 1024:  # bounded dedup memory
                self._seen.popitem(last=False)
            fresh.append(b)
        self.breaches_total += len(fresh)
        return fresh

    def breaches_for(self, replica_id: str) -> List[str]:
        """SLO names currently breached BY this group — what the
        lighthouse echoes in that group's quorum response (the hint
        that triggers the local flight dump)."""
        return sorted({b["slo"] for b in self.active
                       if b["replica_id"] == replica_id})


# --------------------------------------------------------------- renderers


def status_prometheus(status: Dict[str, Any],
                      slo_active: int = 0,
                      slo_breaches_total: int = 0) -> str:
    """Render a fleet aggregate as Prometheus text exposition — the
    ``GET /fleet/metrics`` body (lighthouse.cc emits the same names)."""
    # The one label-escaping spelling (backslash, quote, AND newline —
    # a raw newline splits the sample line and breaks the scrape).
    from torchft_tpu_torch.tracing import _escape_label

    f = status["fleet"]
    lines = [
        "# HELP torchft_fleet_groups groups contributing digests",
        "# TYPE torchft_fleet_groups gauge",
        f"torchft_fleet_groups {float(f['groups'])!r}",
        "# HELP torchft_fleet_step_ms fleet step-wall quantiles (ms)",
        "# TYPE torchft_fleet_step_ms summary",
        f'torchft_fleet_step_ms{{quantile="0.5"}} {float(f["p50_ms"])!r}',
        f'torchft_fleet_step_ms{{quantile="0.95"}} '
        f'{float(f["p95_ms"])!r}',
        "# HELP torchft_fleet_step_ms_max slowest group step wall (ms)",
        "# TYPE torchft_fleet_step_ms_max gauge",
        f"torchft_fleet_step_ms_max {float(f['max_ms'])!r}",
        "# HELP torchft_fleet_slo_breach (slo, group) pairs out of SLO",
        "# TYPE torchft_fleet_slo_breach gauge",
        f"torchft_fleet_slo_breach {float(slo_active)!r}",
        "# HELP torchft_fleet_slo_breaches_total breaches detected",
        "# TYPE torchft_fleet_slo_breaches_total counter",
        f"torchft_fleet_slo_breaches_total "
        f"{float(slo_breaches_total)!r}",
        "# HELP torchft_fleet_sdc_quarantined groups under a "
        "divergence verdict",
        "# TYPE torchft_fleet_sdc_quarantined gauge",
        f"torchft_fleet_sdc_quarantined "
        f"{float(len(f.get('sdc_quarantined', [])))!r}",
        "# HELP torchft_fleet_sdc_verdicts_total divergence verdicts "
        "issued",
        "# TYPE torchft_fleet_sdc_verdicts_total counter",
        f"torchft_fleet_sdc_verdicts_total "
        f"{float(f.get('sdc_verdicts_total', 0))!r}",
        "# HELP torchft_fleet_rebalance_groups groups with a "
        "rebalance fraction != 1",
        "# TYPE torchft_fleet_rebalance_groups gauge",
        f"torchft_fleet_rebalance_groups "
        f"{float(len(f.get('rebalance_fractions', {})))!r}",
        "# HELP torchft_fleet_rebalance_seq fraction-table change "
        "counter",
        "# TYPE torchft_fleet_rebalance_seq counter",
        f"torchft_fleet_rebalance_seq "
        f"{float(f.get('rebalance_seq', 0))!r}",
        "# HELP torchft_fleet_stage_median_ms fleet per-stage medians",
        "# TYPE torchft_fleet_stage_median_ms gauge",
    ]
    for stage in DIGEST_STAGES:
        lines.append(
            f'torchft_fleet_stage_median_ms{{stage="{stage}"}} '
            f'{float(f["stage_median_ms"].get(stage, 0.0))!r}')
    lines += [
        "# HELP torchft_fleet_straggler_score robust z of step wall "
        "vs the fleet",
        "# TYPE torchft_fleet_straggler_score gauge",
        "# HELP torchft_fleet_group_step_ms group step wall (ms)",
        "# TYPE torchft_fleet_group_step_ms gauge",
        "# HELP torchft_fleet_rebalance_fraction assigned rebalance "
        "batch fraction",
        "# TYPE torchft_fleet_rebalance_fraction gauge",
    ]
    for g in status.get("groups", []):
        rid = _escape_label(str(g["replica_id"]))
        lines.append(
            f'torchft_fleet_straggler_score{{replica_id="{rid}"}} '
            f'{float(g["straggler_score"])!r}')
        lines.append(
            f'torchft_fleet_group_step_ms{{replica_id="{rid}"}} '
            f'{float(g["step_wall_ms"])!r}')
        lines.append(
            f'torchft_fleet_rebalance_fraction{{replica_id="{rid}"}} '
            f'{float(g.get("rebalance_fraction", 1.0))!r}')
    # Publication relay tier (docs/design/serving.md): the same rows
    # the publisher's steering pick reads, so the operator's "is the
    # uplink saturated" drill and the steering decision never diverge.
    lines += [
        "# HELP torchft_fleet_relays live publication relays",
        "# TYPE torchft_fleet_relays gauge",
        f"torchft_fleet_relays {float(f.get('relays', 0))!r}",
        "# HELP torchft_fleet_relay_children downstream consumers "
        "across the relay tier",
        "# TYPE torchft_fleet_relay_children gauge",
        f"torchft_fleet_relay_children "
        f"{float(f.get('relay_children', 0))!r}",
        "# HELP torchft_fleet_relay_lag_gens_max worst relay staleness "
        "(generations behind the head)",
        "# TYPE torchft_fleet_relay_lag_gens_max gauge",
        f"torchft_fleet_relay_lag_gens_max "
        f"{float(f.get('relay_lag_gens_max', 0))!r}",
        "# HELP torchft_fleet_relay_child_count per-relay downstream "
        "consumers",
        "# TYPE torchft_fleet_relay_child_count gauge",
        "# HELP torchft_fleet_relay_lag_gens per-relay staleness "
        "(generations behind the head)",
        "# TYPE torchft_fleet_relay_lag_gens gauge",
    ]
    for r in status.get("relays", []):
        rlid = _escape_label(str(r.get("id", "")))
        lines.append(
            f'torchft_fleet_relay_child_count{{relay_id="{rlid}"}} '
            f'{float(r.get("children", 0))!r}')
        lines.append(
            f'torchft_fleet_relay_lag_gens{{relay_id="{rlid}"}} '
            f'{float(r.get("lag_gens", 0))!r}')
    return "\n".join(lines) + "\n"


def format_fleet_table(status: Dict[str, Any],
                       breaches: Optional[List[Dict[str, Any]]]
                       = None) -> str:
    """Terminal fleet table (``lighthouse.py --dashboard``): one row
    per group, straggler-ranked, worst first."""
    f = status["fleet"]
    out = [
        f"fleet: {f['groups']} group(s) "
        f"({f['baseline_groups']} in baseline)  "
        f"step p50={f['p50_ms']:.0f}ms p95={f['p95_ms']:.0f}ms "
        f"max={f['max_ms']:.0f}ms",
    ]
    s = status.get("straggler", {})
    if s.get("replica_id"):
        out.append(f"straggler: {s['replica_id']} "
                   f"(score {s['score']:+.2f}, stage "
                   f"{s['stage'] or '-'})")
    hdr = (f"{'group':<20} {'step':>7} {'wall ms':>9} {'score':>7} "
           f"{'stage':<8} {'fetch':>8} {'ring':>8} {'put':>8} "
           f"{'vote':>8} {'cap':>5} {'age':>7}")
    out += [hdr, "-" * len(hdr)]
    for g in status.get("groups", []):
        st = g["stage_ms"]
        flag = " HEAL" if g["healing"] else (
            " DEG" if g["capacity_fraction"] < 0.999 else "")
        if g.get("sdc_diverged"):
            flag = " SDC" + flag
        reb = g.get("rebalance_fraction", 1.0)
        if abs(reb - 1.0) > 1e-9:
            flag += f" REB:{reb:.2f}"
        out.append(
            f"{g['replica_id']:<20.20} {g['step']:>7} "
            f"{g['step_wall_ms']:>9.1f} {g['straggler_score']:>+7.2f} "
            f"{(g['straggler_stage'] or '-'):<8} "
            f"{st.get('fetch', 0.0):>8.1f} {st.get('ring', 0.0):>8.1f} "
            f"{st.get('put', 0.0):>8.1f} {st.get('vote', 0.0):>8.1f} "
            f"{g['capacity_fraction']:>5.2f} "
            f"{g['age_ms'] / 1e3:>6.1f}s{flag}")
    for b in breaches or []:
        out.append(f"SLO BREACH: {b['slo']} on {b['replica_id']} "
                   f"(value {b['value']}, threshold {b['threshold']}, "
                   f"step {b['step']})")
    return "\n".join(out)


def fetch_fleet_status(lighthouse_addr: str,
                       timeout: float = 10.0) -> Dict[str, Any]:
    """GET a lighthouse's ``/fleet/status.json`` (plain HTTP — no
    native client needed). Accepts ``host:port`` or a full URL; shared
    by ``lighthouse.py --dashboard`` and ``tracefleet --fleet``."""
    import json as _json
    import urllib.request

    url = (lighthouse_addr if "://" in lighthouse_addr
           else f"http://{lighthouse_addr}")
    url = url.rstrip("/") + "/fleet/status.json"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return _json.loads(resp.read())


def resolve_trace_addrs(status: Dict[str, Any]) -> List[str]:
    """Per-group ``/trace.json`` base addresses from a fleet status —
    ``scripts/tracefleet.py --fleet``'s resolver (no quorum-store
    access: the digest carries each group's checkpoint-server address).
    Dead/silent groups simply have no entry."""
    out: List[str] = []
    for g in status.get("groups", []):
        addr = g.get("trace_addr") or ""
        if addr and addr not in out:
            out.append(addr)
    return out
