"""Per-step fault-tolerance state machine (sub-slices (a), (b), (c) and
(d1) of the JAX package's ``torchft_tpu/manager.py``).

Every training step the Manager (1) joins the global quorum, overlapped
with the forward pass, (2) reconfigures the cross-group communicator when
membership changed, (3) heals itself from a healthy peer's live weights
when lagging, (4) averages gradients across the participating groups with
a 1/n that tracks membership, and (5) runs a distributed commit vote so
the optimizer update applies only if every rank of every group succeeded.

    manager.step()                 # quorum kicked off async, heal window opens
    grads = ...                    # forward/backward (overlaps the quorum)
    avg = manager.allreduce(grads).result()
    if manager.should_commit():    # drain work, apply a staged heal, vote
        optimizer.step()           # in place, only on a committed step

What this carries, branch for branch with the JAX Manager:
``step`` (:1086), ``_async_quorum_inner`` (:1215) with the single-donor
resumable heal and its donor failover, ``allreduce`` (:1953) on the
synchronous bucketed host path with its wire rungs — exact f32, bf16, and
int8 with error feedback, quantized on the device or on the host —
``should_commit`` (:3882), ``report_error`` with ring poisoning and the
recovery rendezvous, ``state_dict``/``load_state_dict`` with the policy
fields a healer adopts, the accessors and ``shutdown``; the sharded
update's exchange — ``reduce_scatter`` (:2573) into a
:class:`ShardedGrads`, ``allgather_shards`` (:2727) and ``record_update``
(:2758) — and the cross-step overlap engine's deferred commit
(``stage_deferred`` .. ``note_deferred_dropped``, :2830-2905); and the
recovery plane the JAX Manager runs by default: the striped heal across
every live donor (``heal_striped``, healset advertisements on the quorum
store, :1873-1952), the per-boundary fleet digest that rides the quorum
RPC and the fleet hint it echoes (``fleet_telemetry``, ``_push_digest``
:4042, ``_consume_fleet_hint`` :1525), and state attestation
(``attestation``): each commit boundary fingerprints the committed state
on the card (``ops.attest``, 16 bytes to the host), the lighthouse
majority-votes the fingerprints, and a group that loses the vote is
quarantined and re-heals from the attested majority (:1594-1782). The
durability plane and the churn surface: the commit-coupled
``save_durable`` (:4647) through
:class:`~torchft_tpu_torch.checkpoint_io.AsyncCheckpointer`,
``cold_start`` from the newest verified committed file (:4824, the disk
rung), the graceful preemption drain (``install_preemption_handler``,
``request_preemption`` .. ``_execute_drain``, :2922-3175: farewell, final
save, advertisements withdrawn, :class:`PreemptedExit`), ``prejoin_heal``
(:3217) and the join-coalescing count. The participation plane, which
decides who contributes to the fold and with what weight: warm spares
(``world_size_mode=WorldSizeMode.FIXED_WITH_SPARES``, :1294-1305) and the
synchronous quorum (``use_async_quorum=False``, :1186-1197), the atomic
``participant_slot`` snapshot (:4990) the elastic sampler draws by, the
weighted fold's weight (``set_step_samples`` / ``_wire_weight``,
:2289-2318), degraded capacity (``degraded_mode``, ``request_degrade`` /
``request_restore``, :3377-3506), the adoption of the lighthouse's
rebalance table at commit boundaries (``rebalance``, :3508-3633) and the
chaos ``slow`` band (:4610). The policy controller, the RAM tier and
publication are later sub-slices; their constructor arguments are not
accepted.

The device side of the allreduce is torch, on the gradients' device (a
CUDA card, or the CPU in tests): each bucket's gradient leaves are packed
into one buffer per (dtype, wire dtype) pair — cast to bf16 and carried as
int16 bits on the bf16 rung, quantized with the error-feedback residual
into the ``Int8Wire`` payload on the int8 rung — copied into a pinned host
buffer without blocking, and handed to the ring as soon as the copy lands,
while later buckets' copies continue. The reduced buffer is scaled by 1/n
on the host (the same IEEE division the JAX package runs) and copied back
to the leaves' device. The bucket schedule is derived from leaf metadata
exactly as the JAX package derives it, so every rank — and a JAX rank on
the same ring — agrees on the geometry.
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import socket
import sys
import threading
import time
import urllib.request
import uuid
import zlib
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from enum import Enum
from typing import (Any, Callable, Dict, Iterator, List, Optional, TypeVar,
                    cast)

import numpy as np
import torch

from torchft_tpu_torch import chaos as chaos_mod
from torchft_tpu_torch import checkpoint_io
from torchft_tpu_torch import fleet as fleet_mod
from torchft_tpu_torch import policy as policy_mod
from torchft_tpu_torch import serialization
from torchft_tpu_torch import tracing as tracing_mod
from torchft_tpu_torch import transport
from torchft_tpu_torch._native import (ManagerClient, ManagerServer, Store,
                                       StoreClient)
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.ops import attest as attest_ops
from torchft_tpu_torch.communicator import (BF16, INT8_SEG_ELEMS,
                                            Communicator, CommunicatorError,
                                            Int8Wire, dtype_name, host_dtype,
                                            shard_bounds, to_dtype)
from torchft_tpu_torch.retry import RetryPolicy, RetryStats
from torchft_tpu_torch.utils import (advertise_host, div_by_count,
                                     tree_flatten, tree_unflatten)

logger: logging.Logger = logging.getLogger(__name__)

MANAGER_ADDR_KEY: str = "manager/addr"
# Consecutive failed quorum rounds before step() raises instead of spinning.
_MAX_CONSECUTIVE_FAILURES = 20
_MAX_DONOR_FAILOVERS = 3
# How long a healer re-reads a donor's advertisement that is behind the
# heal's max_step before dropping it (_healset_scrape).
_HEALSET_CATCH_UP_SEC = 2.0
# Fixed quorum-store key the rebalance decision rides on: the store has no
# delete, so a per-step key would leak one entry per boundary.
_REBALANCE_KEY: str = "torchft/rebalance"
# Fold weight of a capacity fraction when the caller reports no exact
# sample count: round(fraction * SCALE). Only ratios between groups
# matter; 10_000 keeps three decimals of the fraction.
_CAPACITY_WEIGHT_SCALE = 10_000
T = TypeVar("T")


class WorldSizeMode(Enum):
    """How the participating world follows membership.

    DYNAMIC: every healthy group at max_step takes part (at least
        ``min_replica_size``); the global batch follows the membership.
    FIXED_WITH_SPARES: the participating world is clamped to exactly
        ``min_replica_size``; surplus groups run as warm spares that
        compute, contribute zeros and apply the same update, so one can
        take a dead group's place at the next quorum without a heal.
    """

    DYNAMIC = 0
    FIXED_WITH_SPARES = 1


class _LatencyReservoir:
    """Bounded reservoir (Vitter's algorithm R) over a latency stream with
    the max kept exactly: p50 / p95 stay representative of the whole run
    at O(1) memory. Seeded, so two identically driven managers report the
    same percentiles. Callers hold the manager's metrics lock."""

    def __init__(self, size: int = 256, seed: int = 0xA5) -> None:
        self._size = size
        self._samples: List[float] = []
        self._n = 0
        self._max = 0.0
        self._rng = random.Random(seed)

    def add(self, value_ms: float) -> None:
        self._n += 1
        self._max = max(self._max, value_ms)
        if len(self._samples) < self._size:
            self._samples.append(value_ms)
        else:
            j = self._rng.randrange(self._n)
            if j < self._size:
                self._samples[j] = value_ms

    def percentiles(self) -> Dict[str, float]:
        """``{p50, p95, max}`` in ms (zeros before the first sample)."""
        if not self._samples:
            return {"p50": 0.0, "p95": 0.0, "max": 0.0}
        s = sorted(self._samples)
        return {"p50": s[len(s) // 2],
                "p95": s[min(len(s) - 1, int(len(s) * 0.95))],
                "max": self._max}


class PreemptedExit(RuntimeError):
    """Raised by :meth:`Manager.step` once a graceful preemption drain
    has completed: the manager has said farewell to the quorum, taken its
    final durable save, withdrawn its advertisements and shut down. The
    training loop must exit with status 0 — the noticed-reclaim success
    path, not a failure."""


class Manager:
    """Fault-tolerance manager for one local rank of one replica group.

    Args:
        comm: resizable cross-group communicator
            (:class:`~torchft_tpu_torch.backends.host.HostCommunicator`).
        load_state_dict: restores the user state (params, optimizer
            state) into the live training loop; called on the main thread
            at commit time when healing.
        state_dict: zero-arg callable returning the current user state
            tree; called by the checkpoint server while the heal window is
            open, and for the heal target's structure.
        min_replica_size: minimum number of live replica groups for a
            quorum to be usable.
        use_async_quorum: True (default) runs the quorum round on the
            manager's thread under the caller's forward and backward; a
            healer then sits the step out and contributes zeros. False
            resolves the quorum inside :meth:`step`, where a healer also
            restores its state, so it takes part in that same step.
        timeout_ms / quorum_timeout_ms: RPC timeouts for the commit barrier
            and the quorum.
        rank / world_size: this process's rank within its replica group and
            the group's local world size.
        replica_id: stable name of this replica group; a uuid suffix makes
            a restarted group a fresh quorum member.
        store_addr / lighthouse_addr: the group's KV store (rank 0 starts
            one when omitted) and the global lighthouse (env
            ``TORCHFT_LIGHTHOUSE``).
        world_size_mode: :class:`WorldSizeMode`; ``FIXED_WITH_SPARES``
            clamps the participating world to ``min_replica_size`` and
            benches the groups beyond it as warm spares.
        allreduce_bucket_bytes: target bucket size of the pipelined host
            allreduce, in wire bytes.
        allreduce_wire_dtype: ``torch.bfloat16`` (or ``"bfloat16"``)
            puts float32 gradients on the ring as bf16: each
            contribution is rounded once, the sum and 1/n stay float32.
        overlap_steps: 0 (default) commits synchronously; 1 runs the
            one-step deferred commit: step N's allreduce stays in flight
            across the step boundary (:meth:`stage_deferred`), draining
            under step N+1's forward and backward, and its vote and update
            land at the N+1 boundary
            (:class:`~torchft_tpu_torch.optim.DelayedOptimizer`);
            :meth:`step` refuses to advance over an unsettled deferred
            step. Gradients are then one step stale, and every failure
            path drops them.
        shard_update: the ZeRO-style sharded update: the trainer calls
            :meth:`reduce_scatter` instead of :meth:`allreduce`, each rank
            updates only its canonical stripe of the parameters, keeping
            optimizer state for that stripe alone, and the updated stripes
            are allgathered (:meth:`allgather_shards`). Every group of a
            job must set it alike.
        device_quantize: on the int8 rung, quantize on the gradients'
            device so the device->host copy moves the int8 payload
            (default on; env ``TORCHFT_DEVICE_QUANT=0`` turns it off).
            Off, float32 crosses and the host quantizes; the payloads
            and residuals are bitwise the same. Off also moves a bf16
            wire's cast to the host.
        policy: an :class:`~torchft_tpu_torch.policy.FTPolicy` that
            selects the wire rung (``policy.POLICIES["sync-int8"]`` for
            int8 + error feedback); it wins over
            ``allreduce_wire_dtype``, rides :meth:`state_dict`, and a
            healer adopts the donor's. DiLoCo policies are not ported.
        degraded_mode: arm the weighted fold (env ``TORCHFT_DEGRADED``):
            every wire op carries this group's fold weight — the samples
            it contributes (:meth:`set_step_samples`, reported by an
            :class:`~torchft_tpu_torch.data.ElasticSampler` draw), else
            its capacity fraction at a fixed scale, 0 for a healer or a
            spare — and the ring divides by the total weight instead of
            the participant count. :meth:`request_degrade` /
            :meth:`request_restore` move this group's capacity fraction
            at a commit boundary. A launch flag: every group of a job
            sets it alike.
        rebalance: adopt the lighthouse's straggler rebalance table (env
            ``TORCHFT_REBALANCE``): participating rank 0 publishes the
            table its fleet hint carries on the quorum store at every
            commit boundary, and every group adopts its own entry there
            after the vote, refused mid-heal, mid-deferred or errored.
            The adopted fraction composes with the capacity fraction in
            :meth:`participant_slot`. Arms the weighted fold, as
            ``degraded_mode`` does.
        heal_striped: stripe a heal across ALL live donors at once (env
            ``TORCHFT_HEAL_STRIPED``, default on): participants advertise
            their checkpoint address under a per-rank store key each
            quorum round, and a healer fetches disjoint byte-balanced
            leaf ranges from every donor at the healed step, in a
            per-healer seed-shuffled order. A dead donor only reassigns
            its remaining stripe. Falls back to the single-donor fetch
            when fewer than two donors are advertised.
        fleet_telemetry: push a per-step digest (step wall, tracer stage
            split, heal activity) to the manager server once per commit
            boundary, riding the quorum RPC; the lighthouse echoes a
            fleet hint (fleet p95, straggler score, SLO breaches) in
            every quorum response (env ``TORCHFT_FLEET_TELEMETRY``,
            default on).
        attestation: each commit boundary's digest also carries a
            fingerprint of the committed state, computed on the card
            (env ``TORCHFT_ATTESTATION``, default on; rides the fleet
            digest, so it needs ``fleet_telemetry``). The lighthouse
            majority-votes the fingerprints; a group that loses the vote
            is quarantined — out of the fold, its advertisements
            withdrawn, its checkpoint server answering 503 — and
            re-heals from the attested majority until the lighthouse
            clears it.
        auth_token: shared job secret (env ``TORCHFT_AUTH_TOKEN``) for the
            checkpoint server and Kill RPCs.
        checkpoint_bind_host: interface of the checkpoint server (env
            ``TORCHFT_CHECKPOINT_BIND``, default all interfaces).

    A heal transfer aborts after ``TORCHFT_HEAL_STALL_SEC`` (default 30)
    seconds without bytes, and resumes.
    """

    def __init__(
        self,
        comm: Communicator,
        load_state_dict: Callable[[T], None],
        state_dict: Callable[[], T],
        min_replica_size: int,
        use_async_quorum: bool = True,
        timeout_ms: int = 60_000,
        quorum_timeout_ms: int = 60_000,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        replica_id: Optional[str] = None,
        store_addr: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        allreduce_bucket_bytes: int = 4 << 20,
        allreduce_wire_dtype: Optional[Any] = None,
        overlap_steps: int = 0,
        shard_update: bool = False,
        device_quantize: Optional[bool] = None,
        degraded_mode: Optional[bool] = None,
        rebalance: Optional[bool] = None,
        policy: Optional[policy_mod.FTPolicy] = None,
        heal_striped: Optional[bool] = None,
        fleet_telemetry: Optional[bool] = None,
        attestation: Optional[bool] = None,
        auth_token: Optional[str] = None,
        checkpoint_bind_host: Optional[str] = None,
        _manager_client: Optional[ManagerClient] = None,
    ) -> None:
        if overlap_steps not in (0, 1):
            raise ValueError(
                "overlap_steps must be 0 (sync commit) or 1 (one-step "
                f"deferred commit), got {overlap_steps!r}")
        self._overlap_steps = int(overlap_steps)
        self._shard_update = bool(shard_update)
        # The one in-flight deferred step: (future, timing box, step).
        self._deferred: Optional[tuple] = None
        self._comm = comm
        self._tracer = tracing_mod.Tracer()
        self._bucket_bytes = max(int(allreduce_bucket_bytes), 1)
        self._wire_dtype: Optional[np.dtype] = (
            host_dtype(allreduce_wire_dtype)
            if allreduce_wire_dtype is not None else None)
        # The wire rung lives in one FTPolicy. An explicit policy= wins
        # over allreduce_wire_dtype and makes the manager policy-aware:
        # its state dict carries the policy, a healer adopts the donor's,
        # and the rendezvous fingerprint says "dynamic".
        if policy is not None and not isinstance(policy,
                                                 policy_mod.FTPolicy):
            raise TypeError(f"policy must be an FTPolicy, got {policy!r}")
        self._policy_aware = policy is not None
        if policy is None:
            policy = policy_mod.from_knobs(self._overlap_steps,
                                           self._wire_dtype)
        _check_ported(policy)
        self._policy = policy
        if self._policy_aware:
            self._install_policy_knobs(policy)
        # int8 + error-feedback state: per-chunk residuals folded into the
        # next contribution before it is quantized, keyed by (schedule
        # fingerprint, bucket, chunk) — on the host for host quantizing,
        # on the gradients' device for the device quantize-pack. Mutated
        # only on the caller thread; flushed on a wire-rung change.
        self._ef_residuals: Dict[tuple, np.ndarray] = {}
        self._dev_residuals: Dict[tuple, torch.Tensor] = {}
        if device_quantize is None:
            device_quantize = os.environ.get(
                "TORCHFT_DEVICE_QUANT", "1").strip().lower() \
                not in ("0", "false")
        self._device_quant = bool(device_quantize)
        # The weighted fold is a property of the whole ring (a preamble
        # that mixes weighted and unweighted ranks aborts the op), so both
        # switches that arm it are launch flags; the capacity and
        # rebalance fractions they weight by are live, and move only at
        # commit boundaries. The exact sample count, when reported
        # (set_step_samples), wins over the fraction-derived weight.
        self._degraded = _env_flag(degraded_mode, "TORCHFT_DEGRADED",
                                   default=False)
        self._rebalance = _env_flag(rebalance, "TORCHFT_REBALANCE",
                                    default=False)
        if ((self._degraded or self._rebalance)
                and getattr(comm, "wants_device_arrays", False)):
            raise ValueError(
                "degraded_mode and rebalance require a host-path "
                "communicator: the weighted fold lives in the host ring's "
                "wire ops, which on-device backends never issue")
        self._capacity_fraction = 1.0
        self._step_samples: Optional[int] = None
        self._rebalance_fraction = 1.0
        # The fraction in force for the step the next digest measures:
        # the digest is pushed after this boundary's adoption landed.
        self._rebalance_frac_prev = 1.0
        self._rebalance_table = ""
        self._rebalance_published: Optional[tuple] = None
        # (store address, replica world, max world) of the last quorum
        # round: the rebalance decision rides that store.
        self._policy_round: Optional[tuple] = None
        # The chaos slow band: the last boundary's time and the sleep
        # injected there, so the stretch applies to the natural wall.
        self._chaos_slow_prev: Optional[float] = None
        self._chaos_slow_injected = 0.0
        self._heal_striped = _env_flag(heal_striped, "TORCHFT_HEAL_STRIPED")
        self._fleet_telemetry = _env_flag(fleet_telemetry,
                                          "TORCHFT_FLEET_TELEMETRY")
        self._attestation = _env_flag(attestation, "TORCHFT_ATTESTATION")
        # Previous-boundary snapshot the digest's deltas derive from;
        # None before the first boundary.
        self._digest_prev: Optional[Dict[str, float]] = None
        # The fleet hint's slowest-stage attribution of this group.
        self._fleet_stage = ""
        # (slo, step) pairs already counted: the hint repeats ACTIVE
        # breaches every round.
        self._slo_seen: "OrderedDict[tuple, None]" = OrderedDict()
        # Cached StoreClient of the quorum's store, keyed by address (the
        # healset advertisements ride it); a test may inject (addr, store).
        self._healset_store: Optional[tuple] = None
        # (store address, replica rank, max world) of the last quorum
        # round: what the advertisement withdrawal needs later.
        self._last_round_facts: Optional[tuple] = None
        # The last fingerprint pushed, and the sticky quarantine latch:
        # once the fleet says WE diverged it holds — out of the fold,
        # withdrawn advertisements, re-heal from the attested majority —
        # until a later hint confirms the re-attested digest matched.
        self._last_state_digest = ""
        self._sdc_quarantined = False
        # The step of the last quarantine re-heal (None before any).
        self._sdc_reheal_step: Optional[int] = None
        # Fleet-wide quarantine facts from the hint: replica ids under a
        # verdict and their checkpoint-server bases, which the one donor
        # predicate (_donor_admissible) excludes from every heal.
        self._sdc_quarantined_peers: set = set()
        self._sdc_quarantined_bases: set = set()
        # Recent membership / heal / abort / quarantine events, served in
        # the status at the manager's GET /metrics.json.
        self._history: deque = deque(maxlen=max(int(os.environ.get(
            "TORCHFT_EVENT_HISTORY", 64)), 1))
        self._event_seq = 0
        self._flight: Optional[tracing_mod.FlightRecorder] = None
        self._user_load_state_dict = load_state_dict
        self._user_state_dict = state_dict
        self._min_replica_size = min_replica_size
        self._use_async_quorum = bool(use_async_quorum)
        self._world_size_mode = world_size_mode
        self._timeout_ms = timeout_ms
        self._quorum_timeout_ms = quorum_timeout_ms
        self._rank = rank if rank is not None else int(
            os.environ.get("RANK", 0))
        self._world_size = (world_size if world_size is not None
                            else int(os.environ.get("WORLD_SIZE", 1)))

        # --- per-step protocol state -------------------------------------
        self._step = 0
        self._batches_committed = 0
        self._should_step = True
        self._errored: Optional[Exception] = None
        self._healing = False
        self._quorum_id = -1
        self._participating_rank: Optional[int] = 0
        self._participating_world_size = 0
        self._pending_state_dict: Optional[Dict[str, Any]] = None
        self._pending_work: List[Future] = []
        self._quorum_future: Optional[Future] = None
        self._comm_poisoned = False
        self._quorum_failure_streak = 0
        self._shutdown_done = False
        self._metrics: Dict[str, float] = {
            "quorum_count": 0, "quorum_ms_total": 0.0, "quorum_ms_last": 0.0,
            # Rounds the lighthouse answered on its fast path or its slow
            # path, and the last answer's epoch.
            "quorum_fast_path_hits": 0, "quorum_slow_path_rounds": 0,
            "quorum_epoch_last": 0,
            "reconfigure_count": 0, "reconfigure_ms_total": 0.0,
            "heal_count": 0, "heal_ms_total": 0.0, "heal_bytes_total": 0.0,
            "heal_bytes_resumed_total": 0.0, "heal_donor_failovers": 0.0,
            "heal_attempts_total": 0.0, "heal_leaf_digest_mismatches": 0.0,
            "heal_redials_avoided": 0.0,
            "heal_last_bytes_committed": 0.0, "heal_last_payload_bytes": 0.0,
            "allreduce_count": 0, "allreduce_ms_total": 0.0,
            "allreduce_fetch_ms_total": 0.0,
            "allreduce_fetch_dispatch_ms_total": 0.0,
            "allreduce_fetch_wait_ms_total": 0.0,
            "allreduce_ring_ms_total": 0.0, "allreduce_put_ms_total": 0.0,
            "allreduce_d2h_wire_bytes_total": 0.0,
            "allreduce_wire_bytes_total": 0.0, "allreduce_inflight": 0,
            "wire_quant_residual_bytes": 0.0, "policy_switches_total": 0,
            "commit_count": 0, "commit_ms_total": 0.0,
            "committed_steps": 0, "aborted_steps": 0,
            "overlap_steps_deferred": 0, "allreduce_hidden_ms_total": 0.0,
            "allreduce_drain_wait_ms_total": 0.0,
            "overlap_grads_dropped": 0,
            "reduce_scatter_count": 0, "update_count": 0,
            "update_ms_total": 0.0, "shard_state_bytes": 0.0,
            "shard_state_resets": 0,
            # Donors the last heal fetched from (1 = single donor).
            "heal_striped_donors": 0.0,
            # The fleet hint, refreshed every quorum round.
            "fleet_p95_ms": 0.0, "straggler_score": 0.0,
            "fleet_groups": 0.0, "slo_breach": 0.0,
            "slo_breaches_total": 0.0,
            # State attestation: fingerprints and their wall; this
            # group's verdict (gauge), its quarantines, clears and
            # re-heals; chaos bit flips applied; and the JAX Manager's
            # refusals of save, publish and RAM replication under a
            # verdict, 0 until those paths are ported.
            "sdc_digests_total": 0.0, "sdc_digest_ms_total": 0.0,
            "sdc_quarantined": 0.0, "sdc_quarantines_total": 0.0,
            "sdc_quarantine_clears_total": 0.0, "sdc_reheals_total": 0.0,
            "sdc_refusals_total": 0.0, "sdc_chaos_flips_total": 0.0,
            # Durable checkpoints: corrupt snapshots quarantined and newer
            # candidates skipped by recovery scans, the legacy last
            # resort, cold starts, and commit-coupled saves refused
            # (mid-heal, errored, uncommitted, deferred, quarantined).
            # The writer's own counters (ckpt_save_*) merge in from the
            # attached AsyncCheckpointer in metrics().
            "ckpt_corrupt_quarantined": 0.0, "ckpt_recover_fallbacks": 0.0,
            "ckpt_recover_legacy": 0.0, "ckpt_cold_starts": 0.0,
            "ckpt_save_skipped": 0.0,
            # Spot-instance churn: reclaim notices, drains deferred past
            # an unclean boundary, graceful exits, deadlines that expired
            # before the drain landed, pre-join heals, and joiners
            # admitted as one membership delta (a lower bound: managers
            # see only the net world delta). reconfigures_per_min is
            # computed when metrics() is read.
            "preempt_notices_total": 0.0,
            "preempt_drain_deferrals_total": 0.0,
            "preempt_deadline_expired_total": 0.0,
            "graceful_exits_total": 0.0, "prejoin_heals_total": 0.0,
            "joins_coalesced_total": 0.0,
            # Degraded capacity: the fraction in force (a gauge) and the
            # transitions that landed (refusals ride the event log).
            "degraded_capacity_fraction": 1.0,
            "degrade_events_total": 0.0, "restore_events_total": 0.0,
            # Rebalance: the adopted fraction (a gauge), the adoptions
            # that landed and those a refusal deferred a boundary.
            "rebalance_fraction": 1.0, "rebalance_adoptions_total": 0.0,
            "rebalance_deferred_total": 0.0,
        }
        self._metrics_lock = threading.Lock()
        # p50 / p95 / max of the quorum round's wall (metrics()).
        self._quorum_latency = _LatencyReservoir()
        # Graceful preemption drain: the armed notice ({"deadline":
        # monotonic, "reason", "pending_notices"}), the drain's outcome
        # (landed, or expired to hard-kill behaviour), and the
        # (writer, directory, prefix, user_state_fn) its final save goes
        # to — set by set_durable_target, or remembered from a plain
        # save_durable.
        self._preempt: Optional[Dict[str, Any]] = None
        self._drained = False
        self._preempt_expired = False
        self._durable_target: Optional[tuple] = None
        self._durable_explicit = False
        self._ckpt_writer: Optional[Any] = None
        # Ring rebuild times (the reconfigures_per_min gauge) and the
        # world of the last one (join coalescing).
        self._reconfig_times: deque = deque(maxlen=512)
        self._last_world = 0
        self._retry_policy = RetryPolicy()
        self._retry_stats = RetryStats()
        self._heal_stall_timeout_sec = float(
            os.environ.get("TORCHFT_HEAL_STALL_SEC", 30.0))
        set_rp = getattr(comm, "set_retry_policy", None)
        if set_rp is not None:
            set_rp(self._retry_policy, self._retry_stats)
        set_tr = getattr(comm, "set_tracer", None)
        if set_tr is not None:
            set_tr(self._tracer)
        # One thread: quorum rounds are strictly ordered per rank.
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="async_quorum")
        # The allreduce's put stage: scale + host->device, in order.
        self._put_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="allreduce_put")
        self._sched_cache: Dict[tuple, "_AllreduceSchedule"] = {}
        # Pinned host staging buffers of the device->host fetch, reused
        # across steps, keyed by (schedule fingerprint, bucket, chunk).
        self._pinned: Dict[tuple, torch.Tensor] = {}

        self._auth_token = (auth_token if auth_token is not None
                            else os.environ.get("TORCHFT_AUTH_TOKEN") or None)
        self._ckpt_server = CheckpointServer(
            self._manager_state_dict,
            bind_host=(checkpoint_bind_host
                       or os.environ.get("TORCHFT_CHECKPOINT_BIND",
                                         "0.0.0.0")),
            auth_token=self._auth_token)

        if _manager_client is not None:
            # Test hook: the control plane is wired externally.
            self._store: Optional[StoreClient] = None
            self._store_server: Optional[Store] = None
            self._manager_server: Optional[ManagerServer] = None
            self._client = _manager_client
            self._replica_id = replica_id or "test"
            self._init_observability()
            return

        store_addr = store_addr or os.environ.get("TORCHFT_STORE_ADDR")
        self._store_server = None
        if self._rank == 0 and store_addr is None:
            self._store_server = Store()
            store_addr = self._store_server.address()
        if store_addr is None:
            raise ValueError(
                "store_addr (or TORCHFT_STORE_ADDR) required for rank != 0")
        self._store_addr = store_addr
        self._store = StoreClient(store_addr, connect_timeout_ms=timeout_ms,
                                  retry_policy=self._retry_policy,
                                  retry_stats=self._retry_stats)
        self._manager_server = None
        if self._rank == 0:
            lighthouse_addr = lighthouse_addr or os.environ.get(
                "TORCHFT_LIGHTHOUSE", f"{advertise_host()}:29510")
            base_id = (replica_id if replica_id is not None
                       else socket.gethostname())
            # uuid suffix: a restarted group must be a *new* quorum member
            self._replica_id = f"{base_id}:{uuid.uuid4()}"
            self._manager_server = ManagerServer(
                replica_id=self._replica_id,
                lighthouse_addr=lighthouse_addr, store_addr=store_addr,
                world_size=self._world_size,
                auth_token=self._auth_token or "")
            self._store.set(MANAGER_ADDR_KEY, self._manager_server.address())
        else:
            self._replica_id = replica_id or ""
        addr = self._store.get(MANAGER_ADDR_KEY,
                               timeout_ms=timeout_ms).decode()
        self._client = ManagerClient(addr, connect_timeout_ms=timeout_ms,
                                     retry_policy=self._retry_policy,
                                     retry_stats=self._retry_stats)
        self._init_observability()

    def _init_observability(self) -> None:
        """Once the replica id exists: stamp the tracer's context, create
        the flight recorder (``TORCHFT_FLIGHT_DIR``) and attach the
        trace/metrics endpoints to the checkpoint server."""
        self._tracer.set_context(replica_id=self._replica_id,
                                 step=self._step,
                                 policy_name=self._policy.name)
        self._flight = tracing_mod.FlightRecorder(
            self._tracer, replica_id=self._replica_id,
            metrics_fn=self.metrics, info_fn=self.metrics_info,
            history_fn=self.history)
        attach = getattr(self._ckpt_server, "attach_observability", None)
        if attach is not None:
            attach(tracer=self._tracer, metrics_fn=self.metrics,
                   info_fn=self.metrics_info,
                   labels={"replica_id": self._replica_id})

    def _flight_dump(self, reason: str, **extra: Any) -> None:
        """A flight-recorder dump (no-op without ``TORCHFT_FLIGHT_DIR``;
        never raises)."""
        if self._flight is not None:
            self._flight.dump(reason, extra=extra or None)

    # ------------------------------------------------------------------ step

    def step(self) -> None:
        """Begin a new training step: bump the step counter when the
        previous step committed, re-open the heal window, and start the
        quorum round off the critical path. Refuses to advance while a
        deferred step is in flight: its vote gates this advance."""
        if self._drained:
            raise PreemptedExit(
                f"{self._replica_id}: graceful preemption drain completed "
                f"at step {self._step}; the training loop must exit")
        # A pending reclaim notice lands HERE, the post-apply edge of the
        # last commit boundary: the caller has applied the committed
        # update, so the final save follows the cadence saves'
        # convention. Unclean boundaries defer it to the next one.
        if self._preempt is not None:
            self._maybe_drain(self._should_step)
            if self._drained:
                raise PreemptedExit(
                    f"{self._replica_id}: graceful preemption drain "
                    f"completed at step {self._step}; the training loop "
                    "must exit")
        if self._deferred is not None:
            raise RuntimeError(
                f"{self._replica_id}: step {self._step} has a deferred "
                "allreduce still in flight; settle it "
                "(DelayedOptimizer.settle()/flush()) before starting the "
                "next step")
        with self._metrics_lock:
            streak = self._quorum_failure_streak
        if streak >= _MAX_CONSECUTIVE_FAILURES:
            raise RuntimeError(
                f"{self._replica_id}: control plane unreachable — {streak} "
                "consecutive quorum rounds failed; refusing to spin")
        if streak > 0:
            time.sleep(min(0.05 * streak, 1.0))
        # Chaos sdc band: a post-commit bit flip at this boundary trains
        # this step and loses the attestation vote at the next boundary.
        self._maybe_chaos_sdc()
        # Chaos slow band: stretch this group's step wall at the same
        # edge, a straggler the lighthouse's rebalancer should shrink.
        self._maybe_chaos_slow()
        if self._should_step:
            # Under the metrics lock: participant_slot() never sees the
            # new count with the old rank.
            with self._metrics_lock:
                self._step += 1
                self._batches_committed += self._participating_world_size
        self._errored = None
        with self._metrics_lock:
            self._healing = False
        self._pending_state_dict = None
        self._ckpt_server.allow_checkpoint(self._step)
        self._tracer.set_context(step=self._step)
        self._quorum_future = self._executor.submit(self._async_quorum)
        if not self._use_async_quorum:
            self._quorum_future.result()
            if self._healing:
                # Sync quorum: the state is restored before compute, so
                # the healer takes part in this step. A donor-less
                # quarantine re-heal stages nothing; the latch keeps the
                # group out of the fold and it retries next boundary.
                if self._pending_state_dict is not None:
                    self._apply_pending_state_dict()
                with self._metrics_lock:
                    self._healing = False

    def _async_quorum(self) -> None:
        try:
            self._async_quorum_inner()
            with self._metrics_lock:
                self._quorum_failure_streak = 0
        except Exception:
            with self._metrics_lock:
                self._quorum_failure_streak += 1
            raise

    def _async_quorum_inner(self) -> None:
        t0 = time.perf_counter()
        with self._tracer.span("quorum") as sp:
            q = self._client.quorum(
                rank=self._rank, step=self._step,
                checkpoint_server_addr=self._ckpt_server.address(),
                timeout_ms=self._quorum_timeout_ms)
            # A scripted client's answer may lack the fast_path / epoch
            # fields (or carry mocks there).
            fast = getattr(q, "fast_path", False) is True
            sp.set(fast=fast, quorum_id=q.quorum_id)
        quorum_ms = (time.perf_counter() - t0) * 1e3
        self._record(quorum_count=1, quorum_ms_total=quorum_ms,
                     quorum_fast_path_hits=1 if fast else 0,
                     quorum_slow_path_rounds=0 if fast else 1)
        with self._metrics_lock:
            self._metrics["quorum_ms_last"] = quorum_ms
            self._quorum_latency.add(quorum_ms)
            epoch = getattr(q, "epoch", 0)
            if isinstance(epoch, int):
                self._metrics["quorum_epoch_last"] = epoch
        if (q.replica_world_size <= 0 or q.quorum_id <= 0
                or not 0 <= q.replica_rank < q.replica_world_size):
            raise RuntimeError(
                f"invalid quorum response (quorum_id={q.quorum_id}, "
                f"replica_rank={q.replica_rank}, replica_world_size="
                f"{q.replica_world_size}); treating as a failed round")
        self._tracer.set_context(quorum_id=q.quorum_id)
        logger.debug("%s quorum at step %d: %s", self._replica_id, self._step, q)
        # The lighthouse's fleet hint and attestation verdict for THIS
        # group, echoed on every round.
        self._consume_fleet_hint(q)
        self._last_round_facts = (getattr(q, "store_address", "") or "",
                                  q.replica_rank, q.max_world_size)

        # The store the rebalance decision rides on, and the round's
        # worlds (a max world below the replica world means someone heals).
        self._policy_round = (getattr(q, "store_address", "") or "",
                              q.replica_world_size, q.max_world_size)
        with self._metrics_lock:  # paired with participant_slot()
            if self._use_async_quorum:
                # Healers are not at max_step: they sit this step out
                # (max_rank is None) and contribute zero grads.
                self._participating_rank = q.max_rank
                self._participating_world_size = q.max_world_size
            else:
                # A sync healer restores inside step(), before compute.
                self._participating_rank = q.replica_rank
                self._participating_world_size = q.replica_world_size
            if self._world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
                # Clamp the arithmetic world; the groups beyond it are
                # warm spares with zero contributions.
                self._participating_world_size = min(
                    self._participating_world_size, self._min_replica_size)
                if (self._participating_rank is not None
                        and self._participating_rank
                        >= self._min_replica_size):
                    self._participating_rank = None

        # Rebuild the ring on a membership change, or when a collective
        # error poisoned it with membership unchanged: then every member
        # meets under a recovery prefix keyed by the frozen max_step.
        recovery = self._comm_poisoned and q.quorum_id == self._quorum_id
        if q.quorum_id != self._quorum_id or recovery:
            suffix = (f"{q.quorum_id}.r{q.max_step}" if recovery
                      else f"{q.quorum_id}")
            store_prefixed = (
                f"{q.store_address}/torchft/{suffix}/{self._rank}")
            logger.info("%s reconfiguring communicator: quorum_id=%d "
                        "rank=%d world=%d%s", self._replica_id, q.quorum_id,
                        q.replica_rank, q.replica_world_size,
                        " (recovery)" if recovery else "")
            setter = getattr(self._comm, "set_allreduce_config_fingerprint",
                             None)
            if setter is not None:
                # The JAX package's spelling, so mixed rings agree.
                wire_fp = ("dynamic" if self._policy_aware else
                           dtype_name(self._wire_dtype)
                           if self._wire_dtype is not None else "None")
                setter(f"bucket_bytes={self._bucket_bytes};"
                       f"wire_dtype={wire_fp};"
                       f"degraded={int(self._degraded)};payload=wire-v5")
            reconf_t0 = time.perf_counter()
            self._comm.configure(store_prefixed, q.replica_rank,
                                 q.replica_world_size)
            # Join coalescing: a reconfigure that grew the world by K > 1
            # admitted K joiners as one delta; count K - 1. Not on our own
            # first round (the jump is us discovering the fleet) nor on a
            # recovery rendezvous (membership unchanged).
            if not recovery and self._quorum_id != -1:
                grown = q.replica_world_size - self._last_world
                if grown > 1:
                    self._record(joins_coalesced_total=grown - 1)
            self._last_world = q.replica_world_size
            with self._metrics_lock:
                self._reconfig_times.append(time.monotonic())
            self._quorum_id = q.quorum_id
            self._comm_poisoned = False
            self._record(reconfigure_count=1, reconfigure_ms_total=(
                time.perf_counter() - reconf_t0) * 1e3)
            self._log_event(event="reconfigure", step=self._step,
                            quorum_id=q.quorum_id, rank=q.replica_rank,
                            world=q.replica_world_size, recovery=recovery)

        if not q.heal:
            with self._metrics_lock:
                quarantined = self._sdc_quarantined
            if quarantined:
                # Divergence verdict latched: the lighthouse still has us
                # at max_step (corruption does not lag a step counter),
                # so no heal was assigned — force one anyway, and do not
                # advertise as a donor: our bytes lost the vote.
                if self._sdc_reheal_step == self._step - 1:
                    # Re-healed at the last boundary: this round's verdict
                    # can predate the re-attested digest (the lighthouse
                    # answers from an aggregate cached for up to 200 ms),
                    # so sit this round out of the fold instead of
                    # healing again; a verdict that holds next round
                    # re-heals then. The JAX Manager heals again at once.
                    logger.info("%s: re-healed at step %d; waiting a "
                                "round for the re-attested verdict",
                                self._replica_id, self._sdc_reheal_step)
                    return
                self._sdc_reheal(q)
                return
            # Advertise this participant's checkpoint server so healers
            # can stripe a fetch across every live donor, and its
            # capacity fraction.
            self._publish_healset(q)
            self._publish_capacity(q)
            return
        # Lagging (or a fresh non-primary at step 1): fetch the primary's
        # live state.
        with self._metrics_lock:
            self._healing = True
        self._record(heal_count=1)
        logger.info("%s healing from %s at step %d", self._replica_id,
                    q.recover_manager_address, q.max_step)
        heal_t0 = time.perf_counter()
        heal_stats: Dict[str, float] = {}
        heal_span = self._tracer.span("heal",
                                      source=q.recover_manager_address,
                                      max_step=q.max_step)
        try:
            ckpt_addr = self._resolve_checkpoint_addr(
                q.recover_manager_address)
            with self._metrics_lock:
                self._metrics["heal_last_bytes_committed"] = 0.0
                self._metrics["heal_last_payload_bytes"] = 0.0
            donor_addrs = (self._healset_donors(q, ckpt_addr)
                           if self._heal_striped else None)
            state = cast(Dict[str, Any], CheckpointServer.load_from_address(
                ckpt_addr, self._manager_state_dict(), stats=heal_stats,
                auth_token=self._auth_token,
                retry_policy=self._retry_policy,
                retry_stats=self._retry_stats,
                stall_timeout_sec=self._heal_stall_timeout_sec,
                donors=lambda i: self._resolve_next_donor(i, q),
                max_donor_failovers=_MAX_DONOR_FAILOVERS,
                donor_addrs=donor_addrs,
                stripe_seed=_stripe_seed(self._replica_id),
                progress_cb=self._heal_progress, tracer=self._tracer))
        finally:
            heal_span.set(
                bytes=heal_stats.get("bytes", 0.0),
                donors=heal_stats.get("donors_used", 1.0),
                failovers=heal_stats.get("donor_failovers", 0.0),
            ).__exit__(*sys.exc_info())
            heal_ms = (time.perf_counter() - heal_t0) * 1e3
            self._record(
                heal_ms_total=heal_ms,
                heal_bytes_total=heal_stats.get("bytes", 0.0),
                heal_bytes_resumed_total=heal_stats.get("bytes_resumed", 0.0),
                heal_donor_failovers=heal_stats.get("donor_failovers", 0.0),
                heal_leaf_digest_mismatches=heal_stats.get(
                    "digest_mismatches", 0.0),
                heal_attempts_total=heal_stats.get("attempts", 0.0),
                heal_redials_avoided=heal_stats.get("redials_avoided", 0.0))
            with self._metrics_lock:  # a gauge, not a counter
                self._metrics["heal_striped_donors"] = heal_stats.get(
                    "donors_used", 1.0)
            self._log_event(
                event="heal", step=self._step,
                source=q.recover_manager_address, ms=round(heal_ms, 1),
                bytes=heal_stats.get("bytes", 0.0),
                resumed=heal_stats.get("bytes_resumed", 0.0),
                attempts=heal_stats.get("attempts", 0.0),
                failovers=heal_stats.get("donor_failovers", 0.0),
                donors_used=heal_stats.get("donors_used", 1.0))
        # Manager metadata restores now, on this thread; the user state is
        # staged and applied on the main thread at commit.
        self.load_state_dict(state["torchft"])
        self._pending_state_dict = state

    def _consume_fleet_hint(self, q: Any) -> None:
        """The lighthouse's fleet health hint from one quorum response:
        gauges (``fleet_p95_ms``, ``straggler_score``, ``fleet_groups``,
        ``slo_breach``) refresh every round; a breach names THIS group,
        counted, logged and flight-dumped once per (slo, step). Then the
        attestation half (:meth:`_consume_sdc_verdict`). The rebalance
        table is stored for the commit boundary, tri-state like the
        verdict: a string (empty = a uniform fleet) replaces it, a
        missing field (an older control plane) leaves it alone. Type
        guards everywhere: a hint-less (mocked) client reads as zeros,
        never poisons the numeric metrics."""
        def _num(name: str) -> float:
            v = getattr(q, name, 0.0)
            return (float(v) if isinstance(v, (int, float))
                    and not isinstance(v, bool) else 0.0)

        def _s(name: str) -> str:
            v = getattr(q, name, "")
            return v if isinstance(v, str) else ""

        breaches = [b.strip() for b in _s("slo_breach").split(",")
                    if b.strip()]
        score = _num("straggler_score")
        with self._metrics_lock:
            self._metrics["fleet_groups"] = _num("fleet_groups")
            self._metrics["fleet_p95_ms"] = _num("fleet_p95_ms")
            self._metrics["straggler_score"] = score
            self._metrics["slo_breach"] = 1.0 if breaches else 0.0
            fresh = [b for b in breaches
                     if (b, self._step) not in self._slo_seen]
            for b in fresh:
                self._slo_seen[(b, self._step)] = None
            while len(self._slo_seen) > 1024:  # bounded dedup memory
                self._slo_seen.popitem(last=False)
            self._metrics["slo_breaches_total"] += len(fresh)
            self._fleet_stage = _s("straggler_stage")
            rt = getattr(q, "rebalance_table", None)
            if isinstance(rt, str):
                self._rebalance_table = rt
        self._consume_sdc_verdict(q)
        if not fresh:
            return
        self._log_event(event="slo_breach", step=self._step,
                        slos=",".join(fresh),
                        straggler_score=round(score, 3),
                        stage=self._fleet_stage)
        for slo in fresh:
            self._flight_dump(f"slo_breach_{slo}", slo=slo,
                              straggler_score=round(score, 4),
                              stage=self._fleet_stage,
                              fleet_p95_ms=_num("fleet_p95_ms"))

    def _consume_sdc_verdict(self, q: Any) -> None:
        """The attestation half of the hint: the fleet-wide quarantine
        lists refresh every round (they gate every donor resolver via
        :meth:`_donor_admissible`), and this group's verdict drives its
        latch. The verdict is tri-state: True latches, False clears a
        held latch (the lighthouse saw the re-attested digest match), a
        missing or non-bool field does nothing — a control plane without
        attestation must not read as an all-clear."""
        sd = getattr(q, "sdc_diverged", None)
        rids = getattr(q, "sdc_quarantined", None)
        addrs = getattr(q, "sdc_quarantined_addrs", None)
        with self._metrics_lock:
            if isinstance(rids, str):
                self._sdc_quarantined_peers = {
                    r.strip() for r in rids.split(",") if r.strip()}
            if isinstance(addrs, str):
                self._sdc_quarantined_bases = {
                    _addr_base(a.strip()) for a in addrs.split(",")
                    if a.strip()}
            latched = self._sdc_quarantined
            healing = self._healing
        if not isinstance(sd, bool):
            return
        if sd and not latched:
            self._enter_sdc_quarantine()
        elif not sd and latched and not healing:
            # Cleared only once the re-attested digest matched AND the
            # recovery heal is no longer in flight (a mid-heal all-clear
            # would re-admit us with the restore unapplied).
            with self._metrics_lock:
                self._sdc_quarantined = False
                self._metrics["sdc_quarantined"] = 0.0
            self._record(sdc_quarantine_clears_total=1)
            self._ckpt_server.set_quarantined(False)
            self._log_event(event="sdc_quarantine_clear", step=self._step,
                            digest=self._last_state_digest)
            logger.info("%s: divergence verdict cleared at step %d — "
                        "re-attested digest matched the fleet majority",
                        self._replica_id, self._step)

    def _enter_sdc_quarantine(self) -> None:
        """Latch the quarantine on a fresh divergence verdict: out of the
        fold (:meth:`is_participating` is False), advertisements
        withdrawn, the checkpoint server refusing with 503, one
        ``sdc_divergence`` flight dump naming the digest the fleet voted
        against."""
        with self._metrics_lock:
            self._sdc_quarantined = True
            self._metrics["sdc_quarantined"] = 1.0
        self._record(sdc_quarantines_total=1)
        self._withdraw_advertisements()
        self._ckpt_server.set_quarantined(True)
        self._log_event(event="sdc_divergence", step=self._step,
                        digest=self._last_state_digest)
        self._flight_dump("sdc_divergence", digest=self._last_state_digest)
        logger.error(
            "%s: DIVERGENCE VERDICT at step %d — this group's state "
            "digest %s lost the fleet majority vote; quarantining and "
            "re-healing from the attested majority", self._replica_id,
            self._step, self._last_state_digest or "<none>")

    def _sdc_reheal(self, q: Any) -> None:
        """Quarantine recovery: heal even though the quorum assigned none
        (a corrupt group is still at max_step — only its BYTES are
        wrong), from the healset advertisements that pass
        :meth:`_donor_admissible`, striped when there are several. No
        admissible donor: stay latched and out of the fold, and try
        again next round — healing from nothing beats healing from
        divergent bytes."""
        with self._metrics_lock:
            self._healing = True
        self._record(sdc_reheals_total=1)
        donors: list = []
        try:
            donors = self._healset_scrape(q)
        except Exception:  # noqa: BLE001 — the scrape is best-effort
            logger.debug("sdc reheal donor scrape failed", exc_info=True)
        if not donors and getattr(q, "recover_manager_address", ""):
            try:
                donors = [self._resolve_checkpoint_addr(
                    q.recover_manager_address)]
            except Exception:  # noqa: BLE001 — quarantined/unreachable
                logger.debug("sdc reheal primary resolve failed",
                             exc_info=True)
        if not donors:
            logger.warning(
                "%s: no attested donor for quarantine recovery at step "
                "%d — staying out of the fold, retrying next boundary",
                self._replica_id, self._step)
            return
        self._record(heal_count=1)
        heal_t0 = time.perf_counter()
        heal_stats: Dict[str, float] = {}
        logger.info("%s: quarantine recovery healing from %d attested "
                    "donor(s) at step %d", self._replica_id, len(donors),
                    self._step)
        with self._tracer.span("sdc_reheal", donors=len(donors),
                               max_step=q.max_step):
            state = cast(Dict[str, Any], CheckpointServer.load_from_address(
                donors[0], self._manager_state_dict(), stats=heal_stats,
                auth_token=self._auth_token,
                retry_policy=self._retry_policy,
                retry_stats=self._retry_stats,
                stall_timeout_sec=self._heal_stall_timeout_sec,
                donors=lambda i: None, max_donor_failovers=0,
                donor_addrs=donors if len(donors) > 1 else None,
                stripe_seed=_stripe_seed(self._replica_id),
                progress_cb=self._heal_progress, tracer=self._tracer))
        heal_ms = (time.perf_counter() - heal_t0) * 1e3
        self._record(heal_ms_total=heal_ms,
                     heal_bytes_total=heal_stats.get("bytes", 0.0))
        with self._metrics_lock:
            # The gauge names this heal's donors too (the JAX re-heal
            # leaves it at the previous heal's).
            self._metrics["heal_striped_donors"] = heal_stats.get(
                "donors_used", 1.0)
        self._log_event(event="sdc_reheal", step=self._step,
                        donors=len(donors), ms=round(heal_ms, 1),
                        bytes=heal_stats.get("bytes", 0.0))
        # As the in-quorum heal: manager metadata restores here, the user
        # state applies on the main thread at the commit boundary.
        self.load_state_dict(state["torchft"])
        self._pending_state_dict = state
        self._sdc_reheal_step = self._step

    def _resolve_checkpoint_addr(self, manager_addr: str) -> str:
        """A peer manager's checkpoint-server URL for this rank — the one
        spelling shared by the heal and the donor failover. Raises when
        the donor is SDC-quarantined: a divergence-verdicted group is no
        donor at all (:meth:`_donor_admissible`)."""
        addr = ManagerClient(
            manager_addr, connect_timeout_ms=self._timeout_ms,
            retry_policy=self._retry_policy,
            retry_stats=self._retry_stats,
        ).checkpoint_address(self._rank, timeout_ms=self._timeout_ms)
        if not self._donor_admissible(addr):
            raise RuntimeError(
                f"{self._replica_id}: resolved donor {addr} is "
                "SDC-quarantined (divergence verdict) — refusing to heal "
                "from unattested state")
        return addr

    def _donor_admissible(self, addr: str, step_s: Optional[str] = None,
                          max_step: Optional[int] = None) -> bool:
        """The one admission predicate every donor resolver shares: the
        address is non-empty, its advertisement (when given) is neither
        the ``-1`` withdrawal tombstone nor a stale step, and its server
        base is not on the lighthouse's SDC quarantine list."""
        if not addr:
            return False
        if step_s is not None:
            if not step_s or step_s == "-1":
                return False  # withdrawn (tombstoned) advertisement
            if max_step is not None and step_s != str(max_step):
                return False  # stale advertisement from an older step
        with self._metrics_lock:
            quarantined = _addr_base(addr) in self._sdc_quarantined_bases
        return not quarantined

    def _resolve_next_donor(self, failover_idx: int, q: Any
                            ) -> Optional[str]:
        """The donor died mid-heal: join a new quorum round, whose
        ``recover_manager_address`` names a live peer, and continue the
        resumable transfer there if it serves the same ``max_step``."""
        try:
            q2 = self._client.quorum(
                rank=self._rank, step=self._step,
                checkpoint_server_addr=self._ckpt_server.address(),
                timeout_ms=self._quorum_timeout_ms)
            if not q2.heal or q2.max_step != q.max_step:
                logger.warning("%s: donor failover abandoned (heal=%s "
                               "max_step %d->%d)", self._replica_id,
                               q2.heal, q.max_step, q2.max_step)
                return None
            ckpt_addr = self._resolve_checkpoint_addr(
                q2.recover_manager_address)
            self._log_event(event="heal_failover", step=self._step,
                            n=failover_idx + 1,
                            donor=q2.recover_manager_address)
            self._flight_dump("heal_failover", n=failover_idx + 1,
                              donor=q2.recover_manager_address)
            logger.info("%s: heal failing over to donor %s (#%d)",
                        self._replica_id, q2.recover_manager_address,
                        failover_idx + 1)
            return ckpt_addr
        except Exception:  # noqa: BLE001 — resolver failure ends the heal
            logger.exception("%s: donor re-resolution failed",
                             self._replica_id)
            return None

    def _apply_pending_state_dict(self) -> None:
        assert self._pending_state_dict is not None, "no staged state"
        logger.info("%s applying healed user state", self._replica_id)
        self._user_load_state_dict(self._pending_state_dict["user"])
        self._pending_state_dict = None

    def _heal_progress(self, committed: int, payload: int) -> None:
        with self._metrics_lock:
            self._metrics["heal_last_bytes_committed"] = float(committed)
            self._metrics["heal_last_payload_bytes"] = float(payload)

    # ------------------------------------------------- striped-heal donors

    def _store_client(self, addr: str) -> Optional[Any]:
        """StoreClient of the quorum's shared store (the one the ring
        rendezvous rides), cached per address."""
        if not addr:
            return None
        if self._healset_store is not None \
                and self._healset_store[0] == addr:
            return self._healset_store[1]
        client = StoreClient(addr, connect_timeout_ms=self._timeout_ms,
                             retry_policy=self._retry_policy,
                             retry_stats=self._retry_stats)
        self._healset_store = (addr, client)
        return client

    def _healset_client(self, q: Any) -> Optional[Any]:
        return self._store_client(q.store_address)

    def _publish_healset(self, q: Any) -> None:
        """Advertise this participant's checkpoint address under the
        fixed per-rank key ``torchft/healset/{replica_rank}`` of the
        quorum store, value ``"{max_step}:{addr}"``. Healers discard an
        advertisement whose step is not the one they heal to. The key is
        fixed per rank: the store has no delete, so a per-step key would
        leak one entry per participant per step. Best-effort."""
        if not self._heal_striped or q.replica_world_size <= 1:
            return
        try:
            store = self._healset_client(q)
            if store is None:
                return
            store.set(f"torchft/healset/{q.replica_rank}",
                      f"{q.max_step}:{self._ckpt_server.address()}"
                      .encode())
        except Exception:  # noqa: BLE001 — advertisement is best-effort
            logger.debug("healset publication failed", exc_info=True)

    def _healset_donors(self, q: Any, primary_addr: str
                        ) -> Optional[list]:
        """The live donor set of a striped heal: the quorum's primary
        plus every peer whose advertisement carries this heal's
        ``max_step`` and passes :meth:`_donor_admissible`. None (the
        single-donor fetch) when fewer than two distinct donors
        emerge."""
        addrs = [primary_addr]
        try:
            if self._healset_client(q) is None:
                return None
            for a in self._healset_scrape(q):
                if a not in addrs:
                    addrs.append(a)
        except Exception:  # noqa: BLE001 — resolution is best-effort
            logger.debug("healset donor listing failed", exc_info=True)
            return None
        if len(addrs) < 2:
            return None
        logger.info("%s: striping heal across %d donors",
                    self._replica_id, len(addrs))
        return addrs

    def _healset_scrape(self, q: Any) -> list:
        """The admissible advertised donors of this round, in rank order,
        our own rank left out. Donors re-publish right after the same
        quorum response the healer acts on, so an advertisement behind
        ``max_step`` is read again for up to
        :data:`_HEALSET_CATCH_UP_SEC` before it counts as stale (the JAX
        Manager drops it at once, and on an asynchronous fleet it then
        loses the donor that was about to advertise about as often as
        not); a missing key or a tombstone is skipped at once."""
        store = self._healset_client(q)
        if store is None:
            return []
        deadline = time.monotonic() + _HEALSET_CATCH_UP_SEC
        out: list = []
        for r in range(q.max_world_size):
            if r == q.replica_rank:
                continue  # our own (absent or tombstoned) advertisement
            while True:
                try:
                    v = store.get(f"torchft/healset/{r}",
                                  timeout_ms=200).decode()
                except Exception:  # noqa: BLE001 — absent rank key
                    v = ""
                step_s, _, a = v.partition(":")
                if (step_s.isdigit() and int(step_s) < q.max_step
                        and time.monotonic() < deadline):
                    time.sleep(0.02)  # the donor's publish is due
                    continue
                break
            if (self._donor_admissible(a, step_s=step_s,
                                       max_step=q.max_step)
                    and a not in out):
                out.append(a)
        return out

    def _withdraw_advertisements(self) -> None:
        """Withdraw this group's heal advertisement: tombstone its
        healset key (step ``-1`` never matches a heal's ``max_step``) and
        shut the heal serve window. The JAX Manager also detaches its
        publication store and RAM tier here; those modules are not
        ported yet."""
        facts = self._last_round_facts
        if facts is not None and self._heal_striped:
            try:
                store = self._store_client(facts[0])
                if store is not None:
                    store.set(f"torchft/healset/{facts[1]}", b"-1:")
            except Exception:  # noqa: BLE001 — withdrawal is best-effort
                logger.debug("healset withdrawal failed", exc_info=True)
        self._ckpt_server.disallow_checkpoint()

    # ------------------------------------------------- durable checkpoints

    def set_durable_target(self, writer: Any, directory: str,
                           prefix: str = "ckpt_",
                           user_state_fn: Optional[Callable[[], Any]]
                           = None) -> None:
        """Register where the graceful drain's FINAL durable save goes,
        and attach ``writer``'s counters to :meth:`metrics`.
        ``user_state_fn`` is the snapshot source for that save when the
        durable tree is richer than the manager-registered state (a
        trainer saving its loader position alongside): the drain's file
        must load against the same target as the cadence saves. An
        explicit registration is never overwritten by later
        :meth:`save_durable` calls."""
        self._ckpt_writer = writer
        self._durable_target = (writer, directory, prefix, user_state_fn)
        self._durable_explicit = True

    def save_durable(self, writer: Any, directory: str,
                     prefix: str = "ckpt_",
                     user_state: Optional[Any] = None) -> Optional[Future]:
        """Commit-coupled durable snapshot: write
        ``{directory}/{prefix}{step}`` via ``writer``
        (:class:`~torchft_tpu_torch.checkpoint_io.AsyncCheckpointer`),
        stamping the commit step, the quorum metadata (``quorum_id``,
        ``replica_id``, ``participants``) and the ``committed`` marker
        into the file head. Returns the writer's Future.

        Refuses — returning ``None`` and counting ``ckpt_save_skipped`` —
        when the state is not a settled committed step's: a heal staged,
        an error latched, the last vote aborted, a deferred allreduce in
        flight (metadata and params would describe different steps;
        flush it first), or a divergence verdict (the bytes lost the
        fleet's vote). The next committed step's save covers the gap.

        ``user_state`` overrides the snapshot source (default: the
        registered ``state_dict``). Recovery is :meth:`cold_start`."""
        with self._metrics_lock:
            healing = self._healing
            quarantined = self._sdc_quarantined
        committed = self._should_step
        deferred = self.deferred_pending()
        if healing or self._errored is not None or not committed \
                or deferred or quarantined:
            logger.warning(
                "%s: skipping durable snapshot at step %d (healing=%s "
                "errored=%s committed=%s deferred=%s quarantined=%s) — "
                "state is not a settled committed step's%s",
                self._replica_id, self._step, healing,
                self._errored is not None, committed, deferred, quarantined,
                " (flush() the deferred step first)" if deferred else "")
            self._record(ckpt_save_skipped=1)
            if quarantined:
                self._record(sdc_refusals_total=1)
            self._log_event(
                event="ckpt_skip", step=self._step, healing=healing,
                errored=self._errored is not None, committed=committed,
                deferred=deferred, quarantined=quarantined)
            return None
        self._ckpt_writer = writer
        # The drain's final save reuses a plain save's target. A call with
        # an explicit user_state is not remembered: the drain would write
        # the registered tree while the cadence files hold the richer one,
        # and the newest file would break resume on the mismatch.
        if not self._durable_explicit and user_state is None:
            self._durable_target = (writer, directory, prefix, None)
        meta = {
            "committed": True,
            "quorum_id": self._quorum_id,
            "replica_id": self._replica_id,
            "participants": self._participating_world_size,
        }
        path = os.path.join(directory, f"{prefix}{self._step}")
        state = (user_state if user_state is not None
                 else self._user_state_dict())
        # The span covers the dispatch (the snapshot); the write runs on
        # the writer's thread and is timed by its own counters.
        with self._tracer.span("ckpt_save", path=path):
            fut = writer.save_async(path, state, self.state_dict(),
                                    meta=meta)
        self._log_event(event="ckpt_save", step=self._step, path=path)
        return fut

    def cold_start(self, directory: str,
                   prefix: str = "ckpt_") -> Optional[str]:
        """Correlated-failure recovery: restore this group from the
        newest **verified committed** durable snapshot under
        ``directory`` (:func:`checkpoint_io.recover` quarantines torn or
        corrupt files, never loads them) and return its path, or ``None``
        for a fresh start. Both the user state and the manager metadata
        are restored, so the next :meth:`step` joins the quorum at the
        recovered step; groups that recovered different steps converge
        through the max_step heal."""
        stats: Dict[str, float] = {}
        path = checkpoint_io.recover(directory, prefix=prefix, stats=stats)
        self._record(**stats)
        if path is None:
            self._log_event(
                event="cold_start", recovered=False,
                quarantined=stats.get("ckpt_corrupt_quarantined", 0.0))
            return None
        user, mgr_state = checkpoint_io.load(
            path, target=self._user_state_dict())
        self._user_load_state_dict(user)
        self.load_durable_state(mgr_state, checkpoint_io.read_meta(path))
        self._record(ckpt_cold_starts=1)
        self._log_event(
            event="cold_start", recovered=True, path=path, step=self._step,
            quarantined=stats.get("ckpt_corrupt_quarantined", 0.0),
            fallbacks=stats.get("ckpt_recover_fallbacks", 0.0))
        logger.info(
            "%s cold-started from %s at step %d (%d corrupt quarantined, "
            "%d fallbacks)", self._replica_id, path, self._step,
            int(stats.get("ckpt_corrupt_quarantined", 0.0)),
            int(stats.get("ckpt_recover_fallbacks", 0.0)))
        return path

    def load_durable_state(self, mgr_state: Dict[str, int],
                           head: Dict[str, Any]) -> None:
        """Restore the manager metadata of a durable file (``head`` is its
        :func:`checkpoint_io.read_meta`). A file is written after its step
        committed, but the step's contribution to ``batches_committed``
        lands only at the next :meth:`step`; its head's ``participants``
        is that contribution, and it is restored as the pending one, so
        the resumed count — and an elastic stream's slot — go on where
        the saving run would have (ROADMAP C12: the JAX Manager's resume
        loses it, and redraws the saved step's slots)."""
        self.load_state_dict(mgr_state)
        with self._metrics_lock:
            self._participating_world_size = max(
                int(head.get("participants", 0) or 0), 0)

    # ------------------------------------------- graceful preemption drain
    # A reclaim notice (SIGTERM through install_preemption_handler, or
    # request_preemption) arms a drain that lands at the next CLEAN commit
    # boundary — the step() after it, once the caller has applied the
    # committed update — with save_durable's refusal discipline: a
    # boundary mid-heal, mid-deferred, errored or aborted defers it. The
    # drain: (1) farewell FIRST, so the survivors' next quorum round is
    # cut without us before they run a collective against a peer about
    # to vanish; (2) the final durable save to the registered target;
    # (3) the advertisements withdrawn; (4) shutdown, after which step()
    # raises PreemptedExit. Past the deadline the drain degrades to
    # hard-kill behaviour with a flight dump.

    def request_preemption(self, deadline_s: Optional[float] = None,
                           reason: str = "reclaim",
                           _signal_safe: bool = False) -> float:
        """Arm the graceful drain. Every notice counts; the EARLIEST
        deadline wins; a notice after an expired one re-arms.
        ``deadline_s`` defaults to ``TORCHFT_RECLAIM_SEC`` (120).

        ``_signal_safe`` (the SIGTERM handler passes True) takes no lock:
        a handler runs on the main thread between bytecodes, and a lock
        the interrupted frame holds would deadlock the loop. The
        accounting is staged in plain field writes and flushed by
        :meth:`_maybe_drain`. Returns the deadline in force (s from
        now)."""
        if deadline_s is None:
            deadline_s = float(os.environ.get("TORCHFT_RECLAIM_SEC", 120.0))
        deadline_s = max(float(deadline_s), 0.0)
        now = time.monotonic()
        # A local snapshot: the training thread's drain may null the
        # attribute while a watcher thread's notice arrives.
        p = self._preempt
        if p is None:
            p = {"deadline": now + deadline_s, "reason": str(reason),
                 "pending_notices": 1}
            self._preempt = p
        elif self._preempt_expired:
            p["deadline"] = now + deadline_s
            p["reason"] = str(reason)
            p["pending_notices"] += 1
            self._preempt_expired = False
        else:
            p["deadline"] = min(p["deadline"], now + deadline_s)
            p["pending_notices"] += 1
        remaining = p["deadline"] - now
        if not _signal_safe:
            self._flush_preempt_notices()
            logger.warning(
                "%s: preemption notice (%s) — draining at the next clean "
                "commit boundary, deadline %.1fs", self._replica_id, reason,
                remaining)
        return remaining

    def _flush_preempt_notices(self) -> None:
        """Move signal-staged notice accounting into the locked counters
        and events, on the training thread."""
        p = self._preempt
        if p is None:
            return
        pending = p.get("pending_notices", 0)
        if pending:
            p["pending_notices"] = 0
            self._record(preempt_notices_total=pending)
            self._log_event(
                event="preempt_notice", step=self._step,
                deadline_s=round(p["deadline"] - time.monotonic(), 3),
                reason=p["reason"], notices=pending)

    def install_preemption_handler(
            self, deadline_s: Optional[float] = None,
            signum: int = signal.SIGTERM) -> Any:
        """Turn ``signum`` (the cloud's reclaim signal) into
        :meth:`request_preemption`, chaining a previously installed
        handler. Returns the previous handler. Main thread only."""
        prev = signal.getsignal(signum)

        def handler(sig: int, frame: Any) -> None:
            self.request_preemption(deadline_s, reason=f"signal {sig}",
                                    _signal_safe=True)
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(sig, frame)

        signal.signal(signum, handler)
        return prev

    def preemption_pending(self) -> bool:
        """True while a notice is armed and the drain has neither landed
        nor expired."""
        return (self._preempt is not None and not self._drained
                and not self._preempt_expired)

    def drained(self) -> bool:
        """True once the drain completed; :meth:`step` then raises
        :class:`PreemptedExit`."""
        return self._drained

    def _maybe_drain(self, decision: bool) -> None:
        """Land the drain, defer it past an unclean boundary, or expire
        it; at the top of :meth:`step`, where nothing is in flight."""
        p = self._preempt
        if p is None or self._drained or self._preempt_expired:
            return
        self._flush_preempt_notices()
        with self._metrics_lock:
            healing = self._healing
        blocked = []
        if healing:
            blocked.append("healing")
        if self._deferred is not None:
            blocked.append("deferred in flight")
        if self._errored is not None:
            blocked.append("errored")
        if not decision:
            blocked.append("vote aborted")
        if time.monotonic() > p["deadline"]:
            self._expire_preemption(",".join(blocked) or "notice deadline "
                                    "passed before a boundary")
            return
        if blocked:
            self._record(preempt_drain_deferrals_total=1)
            self._log_event(event="preempt_deferred", step=self._step,
                            why=",".join(blocked))
            logger.warning(
                "%s: preemption drain deferred at step %d (%s); retrying "
                "at the next boundary", self._replica_id, self._step,
                ",".join(blocked))
            return
        self._execute_drain(p)

    def _expire_preemption(self, why: str) -> None:
        """The deadline passed before the drain landed: hard-kill
        behaviour (survivors will see a crash), with a flight dump of
        where the drain was stuck."""
        self._preempt_expired = True
        self._record(preempt_deadline_expired_total=1)
        self._log_event(event="preempt_deadline_expired", step=self._step,
                        why=why)
        self._flight_dump("preempt_deadline_expired", why=why)
        logger.error("%s: preemption deadline expired before the drain "
                     "landed (%s); degrading to hard-kill behavior",
                     self._replica_id, why)

    def _execute_drain(self, p: Dict[str, Any]) -> None:
        self._log_event(event="preempt_drain", step=self._step,
                        reason=p["reason"])
        # (1) Farewell first (section comment).
        self._send_farewell()
        # (2) The final durable save, bounded by the remaining deadline.
        if self._durable_target is not None:
            writer, directory, prefix, user_fn = self._durable_target
            remaining = p["deadline"] - time.monotonic()
            try:
                fut = self.save_durable(
                    writer, directory, prefix=prefix,
                    user_state=user_fn() if user_fn is not None else None)
                if fut is None:
                    # Refused: the state turned unclean after the check.
                    # Completing would claim a final save not written.
                    self._expire_preemption(
                        "final durable save refused (state no longer a "
                        "settled committed step's)")
                    return
                fut.result(timeout=max(remaining, 0.001))
            except Exception as e:  # noqa: BLE001
                self._expire_preemption(f"final durable save failed: {e!r}")
                return
        # (3) Withdraw the advertisements.
        self._withdraw_advertisements()
        # (4) Done; step() raises PreemptedExit from now on.
        self._drained = True
        self._preempt = None
        self._record(graceful_exits_total=1)
        self._log_event(event="graceful_exit", step=self._step,
                        reason=p["reason"])
        logger.warning(
            "%s: graceful preemption drain complete at step %d (farewell "
            "sent, final save %s, advertisements withdrawn)",
            self._replica_id, self._step,
            "taken" if self._durable_target is not None
            else "skipped (no durable target registered)")
        self.shutdown()

    def _send_farewell(self) -> None:
        """The quorum farewell (leaving beat): the survivors' next round
        cuts the shrunken quorum at once instead of waiting out
        staleness. Best-effort — a lost farewell degrades to the
        staleness eviction a crash gets."""
        sent = False
        try:
            fw = (getattr(self._manager_server, "farewell", None)
                  if self._manager_server is not None else None)
            if fw is not None:
                fw()
                sent = True
        except Exception:  # noqa: BLE001
            logger.warning("%s: farewell via manager server failed",
                           self._replica_id, exc_info=True)
        if not sent:
            # An externally wired control plane (tests) carries the
            # leaving intent on its client.
            fw = getattr(self._client, "farewell", None)
            if fw is not None:
                try:
                    fw()
                    sent = True
                except Exception:  # noqa: BLE001
                    logger.warning("%s: farewell via client failed",
                                   self._replica_id, exc_info=True)
        self._log_event(event="farewell", step=self._step, sent=sent)

    # ------------------------------------------- join admission control

    def prejoin_heal(self, fleet: Any,
                     resolve: Optional[Callable[[str], str]] = None,
                     timeout_sec: float = 60.0) -> bool:
        """Join backpressure: fetch the fleet's newest committed state
        BEFORE this manager's first quorum join, so a replacement enters
        the voting quorum already at max_step instead of joining as a
        mid-heal member.

        ``fleet`` is the lighthouse's ``host:port`` (its
        ``GET /status.json`` lists members and steps) or a zero-arg
        callable returning that dict. ``resolve`` maps a member's manager
        address to its checkpoint-server URL (default: the manager's
        ``checkpoint_address`` RPC). The fetch stripes across every
        admissible max-step member and verifies every leaf digest before
        placement. Best-effort: any failure returns False and the
        in-quorum heal covers correctness. True when a newer state was
        adopted."""
        if self._quorum_id != -1:
            raise RuntimeError(
                f"{self._replica_id}: prejoin_heal must run BEFORE the "
                "first quorum join — this manager already joined "
                f"quorum {self._quorum_id}")
        try:
            if callable(fleet):
                status = fleet()
            else:
                with urllib.request.urlopen(
                        f"http://{fleet}/status.json",
                        timeout=timeout_sec) as resp:
                    status = json.loads(resp.read().decode())
            members = list(status.get("members", []))
            if not members:
                return False
            fleet_step = max(int(m.get("step", 0)) for m in members)
            if fleet_step <= self._step:
                return False  # already current: just join
            resolve = resolve or self._resolve_checkpoint_addr
            addrs: list = []
            for m in members:
                if int(m.get("step", 0)) != fleet_step \
                        or not m.get("address"):
                    continue
                try:
                    a = resolve(m["address"])
                    # A custom resolver bypasses _resolve_checkpoint_addr's
                    # check: a quarantined member must not seed us.
                    if a and a not in addrs and self._donor_admissible(a):
                        addrs.append(a)
                except Exception:  # noqa: BLE001 — skip that donor
                    logger.debug("prejoin donor resolve failed",
                                 exc_info=True)
            if not addrs:
                return False
            stats: Dict[str, float] = {}
            with self._tracer.span("prejoin_heal", donors=len(addrs),
                                   fleet_step=fleet_step):
                state = CheckpointServer.load_from_address(
                    addrs[0], self._manager_state_dict(), stats=stats,
                    auth_token=self._auth_token,
                    retry_policy=self._retry_policy,
                    retry_stats=self._retry_stats,
                    stall_timeout_sec=self._heal_stall_timeout_sec,
                    donors=lambda i: None, max_donor_failovers=0,
                    donor_addrs=addrs if len(addrs) > 1 else None,
                    stripe_seed=_stripe_seed(self._replica_id),
                    tracer=self._tracer)
            self.load_state_dict(state["torchft"])
            self._user_load_state_dict(state["user"])
            self._record(prejoin_heals_total=1,
                         heal_bytes_total=stats.get("bytes", 0.0))
            self._log_event(event="prejoin_heal", step=self._step,
                            fleet_step=fleet_step, donors=len(addrs),
                            bytes=stats.get("bytes", 0.0))
            logger.info("%s: pre-join heal adopted fleet step %d from %d "
                        "donor(s) (%d bytes)", self._replica_id, self._step,
                        len(addrs), int(stats.get("bytes", 0.0)))
            return True
        except Exception:  # noqa: BLE001 — backpressure is best-effort
            logger.warning("%s: pre-join heal failed; falling back to the "
                           "in-quorum heal", self._replica_id, exc_info=True)
            return False

    # ------------------------------------------------------------- allreduce

    # ------------------------------------------------- degraded capacity
    # A group that lost part of its devices keeps training at a fraction
    # of its batch; its gradient is weighted by the samples it
    # contributed. Transitions land only at a commit boundary and are
    # refused mid-heal, mid-deferred or errored (save_durable's refusal
    # classes, less its not-committed rule: an aborted step applied
    # nothing, and a chip loss that keeps aborting the vote is exactly
    # when a degrade must land).

    def degraded_mode(self) -> bool:
        """True when built with ``degraded_mode=True``."""
        return self._degraded

    def capacity_fraction(self) -> float:
        """The capacity fraction in force (1.0 = full capacity)."""
        with self._metrics_lock:
            return self._capacity_fraction

    def _capacity_blocked(self) -> list:
        with self._metrics_lock:
            healing = self._healing
        blocked = []
        if healing:
            blocked.append("healing")
        if self._deferred is not None:
            blocked.append("deferred in flight")
        if self._errored is not None:
            blocked.append("errored")
        return blocked

    def _land_capacity(self, fraction: float, samples: Optional[int],
                       event: str, counter: str, reason: str) -> bool:
        blocked = self._capacity_blocked()
        if blocked:
            self._log_event(event=f"{event}_refused", step=self._step,
                            fraction=fraction, why=",".join(blocked))
            logger.warning("%s: %s to capacity %.3f refused (%s); retry "
                           "at the next boundary", self._replica_id, event,
                           fraction, ",".join(blocked))
            return False
        with self._metrics_lock:
            prev = self._capacity_fraction
            self._capacity_fraction = float(fraction)
            self._step_samples = None if samples is None else int(samples)
            self._metrics["degraded_capacity_fraction"] = float(fraction)
            self._metrics[counter] += 1
        self._log_event(event=event, step=self._step, reason=reason,
                        **{"from": prev, "to": fraction})
        self._flight_dump(event, **{"from": prev, "to": fraction,
                                    "why": reason})
        logger.info("%s capacity %.3f -> %.3f at step %d (%s)",
                    self._replica_id, prev, fraction, self._step, reason)
        return True

    def request_degrade(self, fraction: float,
                        samples: Optional[int] = None,
                        reason: str = "device_loss") -> bool:
        """Land a capacity degrade at this commit boundary: the group
        contributes ``fraction`` of its nominal batch from the next step
        on, its gradient weighted by the samples it contributed
        (``samples`` pins the count). Returns False, with a
        ``degrade_refused`` event, mid-heal, mid-deferred or errored;
        the caller retries at the next boundary."""
        if not self._degraded:
            raise RuntimeError(
                f"{self._replica_id}: request_degrade needs "
                "Manager(degraded_mode=True): the weighted fold must be "
                "armed on every group at launch")
        if not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"capacity fraction must be in (0, 1], got {fraction!r}: "
                "a group at fraction 0 is dead, the eviction path's job")
        return self._land_capacity(fraction, samples, "degrade",
                                   "degrade_events_total", reason)

    def request_restore(self, reason: str = "devices_returned") -> bool:
        """Land the restore to full capacity, with
        :meth:`request_degrade`'s boundary rules."""
        if not self._degraded:
            raise RuntimeError(
                f"{self._replica_id}: request_restore needs "
                "Manager(degraded_mode=True)")
        return self._land_capacity(1.0, None, "restore",
                                   "restore_events_total", reason)

    def _publish_capacity(self, q: Any) -> None:
        """Advertise this group's capacity fraction under the fixed
        per-rank key ``torchft/capacity/<replica_rank>`` of the quorum
        store, value ``"<step>:<fraction>"``: the fleet's view of it (the
        fold learns weights from the wire preamble). Best-effort."""
        if not self._degraded:
            return
        try:
            store = self._healset_client(q)
            if store is None:
                return
            with self._metrics_lock:
                frac = self._capacity_fraction
            store.set(f"torchft/capacity/{q.replica_rank}",
                      f"{self._step}:{frac}".encode())
        except Exception:  # noqa: BLE001 — advertisement is best-effort
            logger.debug("capacity publication failed", exc_info=True)

    # --------------------------------------------------- fleet rebalance
    # The lighthouse's rebalancer turns persistent straggler scores into
    # per-group batch fractions and echoes the table in every fleet hint.
    # Participating rank 0 publishes "<step>:<table>" on the quorum store
    # before each vote; every group reads it after the vote and adopts
    # its own entry (absent = 1.0), with the capacity refusal rules. The
    # fraction composes with the capacity fraction in participant_slot().

    def rebalance_enabled(self) -> bool:
        """True when built with ``rebalance=True``."""
        return self._rebalance

    def rebalance_fraction(self) -> float:
        """The rebalance batch fraction in force (1.0 = uniform)."""
        with self._metrics_lock:
            return self._rebalance_fraction

    def _policy_coordination(self) -> tuple:
        """(store address, replica world, max world, coordinated) of the
        current round; coordinated when a quorum store exists and the
        ring has more than one member (else decisions apply locally)."""
        rd = self._policy_round
        if rd is None:
            return "", 0, 0, False
        addr, replica_world, max_world = rd
        if not isinstance(addr, str):  # a scripted control plane
            addr = ""
        coordinated = bool(addr) and self._comm.size() > 1
        return addr, replica_world, max_world, coordinated

    def _land_rebalance(self, fraction: float, reason: str) -> bool:
        """Adopt a lighthouse-assigned fraction at this boundary, or count
        ``rebalance_deferred_total`` and retry at the next one (the table
        is re-read every round)."""
        blocked = self._capacity_blocked()
        if blocked:
            with self._metrics_lock:
                self._metrics["rebalance_deferred_total"] += 1
            self._log_event(event="rebalance_deferred", step=self._step,
                            fraction=fraction, why=",".join(blocked))
            logger.warning("%s: rebalance to fraction %.4f deferred (%s); "
                           "retry at the next boundary", self._replica_id,
                           fraction, ",".join(blocked))
            return False
        with self._metrics_lock:
            prev = self._rebalance_fraction
            self._rebalance_fraction = float(fraction)
            self._metrics["rebalance_fraction"] = float(fraction)
            self._metrics["rebalance_adoptions_total"] += 1
        self._log_event(event="rebalance_adopt", step=self._step,
                        reason=reason, **{"from": prev, "to": fraction})
        self._flight_dump("rebalance_adopt",
                          **{"from": prev, "to": fraction, "why": reason})
        logger.info("%s rebalance fraction %.4f -> %.4f at step %d (%s)",
                    self._replica_id, prev, fraction, self._step, reason)
        return True

    def _rebalance_pre_vote(self) -> None:
        """The decider's half: participating rank 0 publishes
        ``<step>:<table>`` under the fixed key at every boundary, changed
        or not, so a follower's read never waits on a missing key."""
        if not self._rebalance:
            return
        addr, _rw, _mw, coordinated = self._policy_coordination()
        if not coordinated:
            return
        if self._participating_rank != 0 or not self.is_participating():
            return
        with self._metrics_lock:
            table = self._rebalance_table
        try:
            store = self._store_client(addr)
            if store is not None:
                store.set(_REBALANCE_KEY, f"{self._step}:{table}".encode())
                self._rebalance_published = (self._step, table)
        except Exception:  # noqa: BLE001 — retried next boundary
            logger.debug("rebalance publication failed", exc_info=True)

    def _rebalance_post_vote(self) -> None:
        """Every group's half: read the published table (or, uncoordinated,
        this group's own hint copy), take this group's entry — absent is
        1.0, the restore, also a departed group's — clamp it to the
        ladder's bounds and land it. A failed read adopts nothing."""
        if not self._rebalance:
            return
        addr, _rw, _mw, coordinated = self._policy_coordination()
        table: Optional[str] = None
        if coordinated:
            try:
                store = self._store_client(addr)
                if store is not None:
                    raw = store.get(_REBALANCE_KEY, timeout_ms=min(
                        self._timeout_ms, 2000)).decode()
                    table = raw.partition(":")[2]
            except Exception:  # noqa: BLE001 — the next boundary re-reads
                logger.debug("rebalance decision read failed",
                             exc_info=True)
                return
        else:
            with self._metrics_lock:
                table = self._rebalance_table
        if table is None:
            return
        fractions = fleet_mod.parse_rebalance_table(table)
        target = float(fractions.get(self._replica_id, 1.0))
        target = min(fleet_mod.REBALANCE_CEIL,
                     max(fleet_mod.REBALANCE_FLOOR, target))
        with self._metrics_lock:
            cur = self._rebalance_fraction
        if abs(target - cur) < 1e-9:
            return
        self._land_rebalance(target, reason="lighthouse table")

    def allreduce(self, tree: Any) -> Future:
        """Average a gradient tree across the participating groups.

        Joins the quorum, zeroes the contribution when this group is
        healing or a spare, runs the bucketed host ring, and divides by the
        CURRENT participant count. Returns a Future of the averaged tree,
        its leaves placed like the inputs (CUDA tensors in, CUDA tensors
        out). Errors are swallowed into the input tree and latched with
        :meth:`report_error`, so the failure surfaces in the commit vote."""
        if self._errored is not None:
            return _instant(tree)
        try:
            assert self._quorum_future is not None, "call step() first"
            self._quorum_future.result()
            if self.single_group_step():
                return _instant(tree)
            leaves, treedef = tree_flatten(tree)
            if not leaves:
                return _instant(tree)
            return self._host_allreduce_pipelined(tree, leaves, treedef)
        except Exception as e:  # noqa: BLE001
            logger.exception("allreduce failed")
            self.report_error(e)
            return _instant(tree)

    def _host_allreduce_pipelined(self, tree: Any, leaves: list,
                                  treedef: Any) -> Future:
        """Three overlapped stages per bucket: (1) on the caller thread,
        :meth:`_wire_buckets` stages the bucket and hands it to the comm
        worker; (2) the ring; (3) on the put thread, 1/n on the host and
        the copy back to the device. Under the weighted fold the ring
        already divided by the total weight, so the put stage does not."""
        n = 1 if self._weighted() else max(self.num_participants(), 1)
        ar_t0 = time.perf_counter()
        self._set_wire_tag()
        sched = self._get_schedule(treedef, leaves)
        agg: Future = Future()
        out_leaves: list = [None] * len(leaves)
        lock = threading.Lock()
        pending = [len(sched.chunks)]

        def settle_exception(e: BaseException) -> None:
            try:
                agg.set_exception(e)
            except BaseException:  # already settled by another thread
                pass

        def finish_bucket(chunks: list, reduced: list) -> None:
            try:
                put_t0 = time.perf_counter()
                with self._tracer.span("put", chunks=len(chunks)):
                    scaled = _put_bucket_chunks(chunks, reduced, leaves, n)
                self._record(allreduce_put_ms_total=(
                    time.perf_counter() - put_t0) * 1e3)
                with lock:
                    for i, a in scaled.items():
                        out_leaves[i] = a
                    pending[0] -= 1
                    done = pending[0] == 0
                if done:
                    self._record(allreduce_count=1, allreduce_ms_total=(
                        time.perf_counter() - ar_t0) * 1e3)
                    result = tree_unflatten(treedef, out_leaves)
                    try:
                        agg.set_result(result)
                    except BaseException:  # a bucket error settled it
                        pass
            except Exception as e:  # noqa: BLE001
                settle_exception(e)

        def on_bucket(chunks: list, submit_t: float
                      ) -> Callable[[Future], None]:
            def cb(f: Future) -> None:
                self._record(allreduce_ring_ms_total=(
                    time.perf_counter() - submit_t) * 1e3)
                e = f.exception()
                if e is not None:
                    settle_exception(e)
                    return
                if not agg.done():
                    try:
                        self._put_executor.submit(finish_bucket, chunks,
                                                  f.result())
                    except Exception as e2:  # executor shut down mid-step
                        settle_exception(e2)
            return cb

        for chunks, bufs in self._wire_buckets(sched, leaves):
            self._comm.allreduce_wire(
                bufs, [dtype_name(c.orig) for c in chunks], op="sum"
            ).add_done_callback(on_bucket(chunks, time.perf_counter()))
        return self.wrap_future(agg, default=tree)

    def _wire_buckets(self, sched: "_AllreduceSchedule", leaves: list
                      ) -> Iterator[tuple]:
        """Stage 1 of both pipelines: ``(chunks, ring buffers)`` per
        bucket, in order. A participant packs buckets on the device and
        starts their copies into pinned host memory — every bucket up
        front, or a window of them (``TORCHFT_ALLREDUCE_STAGE_AHEAD``) —
        then waits for each bucket's copy and quantizes on the host where
        the int8 rung does so; healers and spares yield zeros in this
        step's wire format, from the shared schedule."""
        participating = self.is_participating()
        n_buckets = len(sched.chunks)
        window = _stage_ahead_window()
        staged: list = [None] * n_buckets
        next_to_stage = 0
        int8 = self._policy.wire == policy_mod.WIRE_INT8
        for b, chunks in enumerate(sched.chunks):
            if not participating:
                yield chunks, [_zero_wire_chunk(c, int8) for c in chunks]
                continue
            hi = n_buckets if window is None else min(b + 1 + window,
                                                      n_buckets)
            while next_to_stage < hi:
                staged[next_to_stage] = self._stage_bucket(
                    sched, next_to_stage, leaves, int8)
                next_to_stage += 1
            bufs = self._wait_bucket(staged[b], bucket=b)
            staged[b] = None  # release the packed device copies
            if int8:
                bufs = self._int8_quantize_bucket(sched, b, chunks, bufs)
            yield chunks, bufs

    def _set_wire_tag(self) -> None:
        """Per-op preamble facts of the ring, stamped on the caller thread
        before the pipeline's ops: payload kind ``step``, and the fold
        weight — :meth:`_wire_weight` under the weighted fold, ``-1``
        (unweighted) otherwise."""
        setter = getattr(self._comm, "set_wire_tag", None)
        if setter is not None:
            setter("step")
        wsetter = getattr(self._comm, "set_wire_weight", None)
        if wsetter is not None:
            wsetter(self._wire_weight() if self._weighted() else -1)

    def _weighted(self) -> bool:
        """True when the ring folds by weight (degraded mode or
        rebalance)."""
        return self._degraded or self._rebalance

    def _wire_weight(self) -> int:
        """This step's fold weight: 0 while healing, benched or
        quarantined (a zero contribution carries zero weight), else the
        samples reported by :meth:`set_step_samples`, else the effective
        fraction (capacity x rebalance, the product
        :meth:`participant_slot` snapshots) at a fixed scale."""
        if not self.is_participating():
            return 0
        with self._metrics_lock:
            samples = self._step_samples
            frac = self._capacity_fraction * self._rebalance_fraction
        if samples is not None:
            return max(int(samples), 0)
        return max(1, int(round(frac * _CAPACITY_WEIGHT_SCALE)))

    def set_step_samples(self, samples: Optional[int]) -> None:
        """Report the samples this group contributes this step: the
        weighted fold's weight. ``None`` reverts to the fraction-derived
        weight. Read only when the weighted fold is armed."""
        with self._metrics_lock:
            self._step_samples = None if samples is None else int(samples)

    def _get_schedule(self, treedef: Any, leaves: list
                      ) -> "_AllreduceSchedule":
        metas = tuple((tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                             else np.shape(leaf)),
                       dtype_name(_np_dtype(leaf))) for leaf in leaves)
        wire = (dtype_name(self._wire_dtype)
                if self._wire_dtype is not None else None)
        key = (treedef, metas, self._bucket_bytes, wire)
        sched = self._sched_cache.get(key)
        if sched is None:
            if len(self._sched_cache) >= 8:
                self._sched_cache.clear()
                self._pinned.clear()
            sched = _derive_schedule(metas, self._bucket_bytes, wire)
            self._sched_cache[key] = sched
        return sched

    def _stage_bucket(self, sched: "_AllreduceSchedule", bucket: int,
                      leaves: list, int8: bool) -> list:
        """Stage 1 for one bucket: pack each chunk of tensor leaves on
        their device and start its copy into a pinned host buffer
        without blocking. A record's kind says what crosses:

        * ``pack`` — the chunk in its wire dtype (bf16 as int16 bits);
        * ``int8dev`` — the int8 rung's ``Int8Wire`` payload, quantized
          on the device with the device-resident residual folded in
          (:func:`_device_quantize_pack`), about 1/4 of the float32
          bytes; the new residual stays on the device;
        * ``hostcast`` — ``device_quantize`` off with a narrower wire:
          the chunk in its own dtype, cast on the host;
        * ``host`` — a chunk holding numpy leaves, packed on the host
          in its wire dtype.

        Returns ``(chunk, kind, host buffer, device buffer, copy
        event)`` per chunk for :meth:`_wait_bucket`."""
        t0 = time.perf_counter()
        recs = []
        dev_quant = False
        with self._tracer.span("fetch_dispatch", bucket=bucket):
            for j, c in enumerate(sched.chunks[bucket]):
                ls = [leaves[i] for i in c.idx]
                if not (ls and all(isinstance(x, torch.Tensor)
                                   for x in ls)):
                    recs.append((c, "host", _host_pack(ls, c.wire), None,
                                 None))
                    continue
                if (int8 and self._device_quant and c.total
                        and np.issubdtype(c.orig, np.floating)):
                    kind = "int8dev"
                    dev_quant = True
                    key = (sched.fingerprint, bucket, j)
                    self._prune_dev_residuals(sched.fingerprint)
                    res = self._dev_residuals.get(key)
                    if (res is None or res.numel() != c.total
                            or res.device != ls[0].device):
                        res = torch.zeros(c.total, dtype=torch.float32,
                                          device=ls[0].device)
                    packed, new_res = _device_quantize_pack(ls, res)
                    # Banked at quantize time, as the host path banks
                    # its residual: an aborted step keeps it either way.
                    self._dev_residuals[key] = new_res
                else:
                    wire = c.wire
                    kind = "pack"
                    if not self._device_quant and wire != c.orig:
                        wire, kind = c.orig, "hostcast"
                    packed = _pack_leaves(ls, wire)
                host, done = self._start_copy(packed,
                                              (sched.fingerprint, bucket, j))
                recs.append((c, kind, host, packed, done))
            if dev_quant:
                self._update_residual_gauge()
        ms = (time.perf_counter() - t0) * 1e3
        self._record(allreduce_fetch_dispatch_ms_total=ms,
                     allreduce_fetch_ms_total=ms)
        return recs

    def _start_copy(self, packed: torch.Tensor, key: tuple) -> tuple:
        """Start the copy of a packed device buffer into its reused
        pinned host buffer; returns ``(host tensor, CUDA event)``. A CPU
        buffer is its own host copy (no event)."""
        if not packed.is_cuda:
            return packed, None
        host = self._pinned.get(key)
        if (host is None or host.numel() != packed.numel()
                or host.dtype != packed.dtype):
            host = torch.empty(packed.numel(), dtype=packed.dtype,
                               pin_memory=True)
            self._pinned[key] = host
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _wait_bucket(self, recs: list, bucket: int) -> list:
        """Stage 1b: block until this bucket's host copies landed; return
        the ring buffers — numpy views of the pinned memory, bf16 viewed
        back as :data:`~torchft_tpu_torch.communicator.BF16`, an
        ``Int8Wire`` decoded from a device-quantized payload, or the
        host cast of a ``hostcast`` chunk."""
        t0 = time.perf_counter()
        bufs = []
        d2h = 0
        with self._tracer.span("fetch_wait", bucket=bucket) as wait_span:
            for c, kind, host, _packed, done in recs:
                if kind == "host":
                    bufs.append(host)
                    continue
                if done is not None:
                    done.synchronize()
                buf = host.numpy()
                d2h += buf.nbytes
                if kind == "int8dev":
                    bufs.append(Int8Wire.from_bytes(buf, c.total))
                elif kind == "hostcast":
                    bufs.append(to_dtype(buf, c.wire))
                elif c.wire == BF16:
                    bufs.append(buf.view(BF16))
                else:
                    bufs.append(buf)
            wait_span.set(bytes=d2h)
        ms = (time.perf_counter() - t0) * 1e3
        self._record(allreduce_fetch_wait_ms_total=ms,
                     allreduce_fetch_ms_total=ms,
                     allreduce_wire_bytes_total=float(d2h),
                     allreduce_d2h_wire_bytes_total=float(d2h))
        return bufs

    def _int8_quantize_bucket(self, sched: "_AllreduceSchedule", b: int,
                              chunks: list, bufs: list) -> list:
        """The int8 + error-feedback rung on the host: fold the chunk's
        banked residual into this step's contribution, quantize it per
        segment (``Int8Wire.quantize``), and bank ``contribution -
        dequant(q)`` for the next step. Device-quantized chunks arrive
        as ``Int8Wire`` already; non-float chunks ride the exact ring.
        Residuals of another schedule fingerprint are dropped first."""
        if any(k[0] != sched.fingerprint for k in self._ef_residuals):
            self._ef_residuals = {
                k: v for k, v in self._ef_residuals.items()
                if k[0] == sched.fingerprint}
        out = []
        for j, (c, buf) in enumerate(zip(chunks, bufs)):
            if (isinstance(buf, Int8Wire)
                    or not np.issubdtype(c.orig, np.floating)):
                out.append(buf)
                continue
            key = (sched.fingerprint, b, j)
            v = np.ravel(np.asarray(buf)).astype(np.float32, copy=False)
            res = self._ef_residuals.get(key)
            if res is not None and res.size == v.size:
                v = v + res
            w = Int8Wire.quantize(v)
            res = v - w.dequantize(np.float32)
            # A non-finite contribution quantizes to zero; its residual
            # would poison every later step, so it is dropped.
            if not np.isfinite(res).all():
                res[~np.isfinite(res)] = 0.0
            self._ef_residuals[key] = res
            out.append(w)
        self._update_residual_gauge()
        return out

    def _prune_dev_residuals(self, fingerprint: str) -> None:
        """Keep the device residual store to the current schedule: a
        stale residual would fold into the wrong elements."""
        if any(k[0] != fingerprint for k in self._dev_residuals):
            self._dev_residuals = {
                k: v for k, v in self._dev_residuals.items()
                if k[0] == fingerprint}

    def _update_residual_gauge(self) -> None:
        """``wire_quant_residual_bytes``: host plus device residuals."""
        total = sum(r.nbytes for r in self._ef_residuals.values())
        total += sum(r.numel() * 4 for r in self._dev_residuals.values())
        with self._metrics_lock:
            self._metrics["wire_quant_residual_bytes"] = float(total)

    # ------------------------------------------------------ sharded update

    def shard_update(self) -> bool:
        """True when this Manager was built with ``shard_update=True``
        (the ZeRO-style sharded update). Read by
        :class:`~torchft_tpu_torch.parallel.step.FTTrainer` to pick the
        reduce-scatter loop and by
        :class:`~torchft_tpu_torch.optim.FTOptimizer` to hold stripe
        state."""
        return self._shard_update

    def reduce_scatter(self, tree: Any) -> Future:
        """Reduce-scatter sibling of :meth:`allreduce`: average a gradient
        tree across the participating groups, but resolve to only this
        rank's canonical stripe of it, as a :class:`ShardedGrads` (one 1-D
        stripe per schedule chunk, placed on the chunk's device, plus the
        geometry the sharded optimizer needs).

        The protocol is :meth:`allreduce`'s: it joins the quorum, healers
        and spares contribute zeros, 1/n tracks membership, and errors are
        swallowed into zero stripes of the same geometry and latched for
        the vote. The concatenation of every rank's stripes is bitwise the
        :meth:`allreduce` result: the ring leg is
        ``Communicator.reduce_scatter_wire``, which folds like the
        allreduce. A step that needs no stripe geometry (single group,
        empty tree) resolves to the plain tree;
        :meth:`FTOptimizer.apply
        <torchft_tpu_torch.optim.FTOptimizer.apply>` dispatches on the
        result's type."""
        if self._errored is not None:
            return _instant(tree)
        try:
            assert self._quorum_future is not None, "call step() first"
            self._quorum_future.result()
            if self.single_group_step():
                return _instant(tree)
            leaves, treedef = tree_flatten(tree)
            if not leaves:
                return _instant(tree)
            return self._host_reduce_scatter_pipelined(leaves, treedef)
        except Exception as e:  # noqa: BLE001
            logger.exception("reduce_scatter failed")
            self.report_error(e)
            return _instant(tree)

    def _host_reduce_scatter_pipelined(self, leaves: list,
                                       treedef: Any) -> Future:
        """The allreduce pipeline with the ring leg swapped for
        ``Communicator.reduce_scatter_wire``: staging (pack, device->host
        copy, host quantize) is shared, the comm worker reduce-scatters
        each bucket, and the put stage carries only this rank's stripe —
        1/n on the host and the copy to the device, about 1/world of the
        allreduce's put bytes."""
        n = 1 if self._weighted() else max(self.num_participants(), 1)
        world = max(self._comm.size(), 1)
        rank = self._comm.rank()
        ar_t0 = time.perf_counter()
        self._set_wire_tag()
        sched = self._get_schedule(treedef, leaves)
        all_chunks = [c for cs in sched.chunks for c in cs]
        agg: Future = Future()
        out_shards: list = [None] * len(all_chunks)
        lock = threading.Lock()
        pending = [len(sched.chunks)]

        def settle_exception(e: BaseException) -> None:
            try:
                agg.set_exception(e)
            except BaseException:  # already settled by another thread
                pass

        def finish_bucket(base: int, chunks: list, stripes: list) -> None:
            try:
                put_t0 = time.perf_counter()
                with self._tracer.span("put", chunks=len(chunks)):
                    placed = _put_stripes(chunks, stripes, leaves, n)
                self._record(allreduce_put_ms_total=(
                    time.perf_counter() - put_t0) * 1e3)
                with lock:
                    out_shards[base:base + len(placed)] = placed
                    pending[0] -= 1
                    done = pending[0] == 0
                if done:
                    self._record(allreduce_count=1, reduce_scatter_count=1,
                                 allreduce_ms_total=(
                                     time.perf_counter() - ar_t0) * 1e3)
                    try:
                        agg.set_result(ShardedGrads(
                            all_chunks, out_shards, rank, world, leaves,
                            treedef))
                    except BaseException:  # a bucket error settled it
                        pass
            except Exception as e:  # noqa: BLE001
                settle_exception(e)

        def on_bucket(base: int, chunks: list, submit_t: float
                      ) -> Callable[[Future], None]:
            def cb(f: Future) -> None:
                self._record(allreduce_ring_ms_total=(
                    time.perf_counter() - submit_t) * 1e3)
                e = f.exception()
                if e is not None:
                    settle_exception(e)
                    return
                if not agg.done():
                    try:
                        self._put_executor.submit(finish_bucket, base,
                                                  chunks, f.result())
                    except Exception as e2:  # executor shut down mid-step
                        settle_exception(e2)
            return cb

        base = 0
        for chunks, bufs in self._wire_buckets(sched, leaves):
            self._comm.reduce_scatter_wire(
                bufs, [dtype_name(c.orig) for c in chunks], op="sum"
            ).add_done_callback(on_bucket(base, chunks, time.perf_counter()))
            base += len(chunks)

        # Error default: zero stripes with the real geometry. The latched
        # error aborts the vote, so the values are never applied, but
        # every rank keeps the same step shape. Built only on failure.
        def zero_default() -> "ShardedGrads":
            zs = []
            for c in all_chunks:
                bd = shard_bounds(c.total, world)
                zs.append(_zeros_like_chunk(c, int(bd[rank + 1] - bd[rank]),
                                            leaves))
            return ShardedGrads(all_chunks, zs, rank, world, leaves,
                                treedef)

        return self.wrap_future(agg, default_fn=zero_default)

    def allgather_shards(self, shards: list) -> Future:
        """Error-swallowed allgather of this rank's updated parameter
        stripes (host arrays), the sharded update's reassembly leg:
        resolves to every ring rank's stripe list, in rank order. On a
        failure the error latches (the vote aborts) and the result repeats
        the local stripes — structure only, never applied."""
        world = max(self._comm.size(), 1)
        try:
            fut = self._comm.allgather(shards)
        except Exception as e:  # noqa: BLE001
            self.report_error(e)
            return _instant([shards] * world)
        return self.wrap_future(fut, default=[shards] * world)

    def prepare_commit(self) -> None:
        """Drain this step's in-flight work and apply a staged heal: the
        pre-vote half of :meth:`should_commit`, exposed so that the
        sharded update computes its stripe after a heal restore lands and
        before the vote, which must still cover the allgather that
        follows. Idempotent."""
        with self._tracer.span("drain", pending=len(self._pending_work)):
            if self._quorum_future is not None:
                self.wait_quorum()
            for work in self._pending_work:
                work.result()  # errors already swallowed into defaults
            self._pending_work = []
            if self._healing and self._pending_state_dict is not None:
                self._apply_pending_state_dict()

    def record_update(self, ms: float, shard_state_bytes: float,
                      resets: int = 0) -> None:
        """The sharded optimizer's accounting: wall ms of its stripe
        update, allgather and reassembly, the live stripe state's bytes (a
        gauge), and the stripe-state resets a geometry change forced."""
        self._record(update_count=1, update_ms_total=ms,
                     shard_state_resets=resets)
        with self._metrics_lock:
            self._metrics["shard_state_bytes"] = float(shard_state_bytes)

    def wait_quorum(self) -> None:
        """Join this step's quorum round; a failure latches via
        :meth:`report_error` instead of raising."""
        assert self._quorum_future is not None, "call step() first"
        try:
            self._quorum_future.result()
        except Exception as e:  # noqa: BLE001
            self.report_error(e)

    def single_group_step(self) -> bool:
        """True when this step needs no cross-group traffic at all."""
        return (self._errored is None and self._comm.size() <= 1
                and self.num_participants() <= 1
                and self.is_participating())

    def wrap_future(self, fut: Future, default: Any = None,
                    default_fn: Optional[Callable[[], Any]] = None
                    ) -> Future:
        """Swallow ``fut``'s error into ``default`` (or ``default_fn()``,
        built only on failure) and latch it; track the future for the
        commit drain."""
        out: Future = Future()
        self._record(allreduce_inflight=1)

        def relay(f: Future) -> None:
            self._record(allreduce_inflight=-1)
            e = f.exception()
            if e is None:
                out.set_result(f.result())
            else:
                self.report_error(e)
                out.set_result(default_fn() if default_fn is not None
                               else default)

        fut.add_done_callback(relay)
        self._pending_work.append(out)
        return out

    # ------------------------------------------------------- deferred commit
    # The cross-step overlap engine (overlap_steps=1): the trainer stages
    # step N's error-swallowed allreduce future here instead of draining
    # it, lets it run under step N+1's forward and backward, and settles it
    # (drain, vote, apply or drop) at the N+1 boundary through
    # DelayedOptimizer. One deferred step at most; step() refuses to
    # advance over it.

    def stage_deferred(self, fut: Future) -> None:
        """Carry the current step's in-flight allreduce across the step
        boundary. ``fut`` is a future this Manager returned from
        :meth:`allreduce` or :meth:`reduce_scatter`: failures latch and
        surface in the deferred vote, never here."""
        if self._deferred is not None:
            raise RuntimeError(
                f"{self._replica_id}: previous deferred step "
                f"{self._deferred[2]} not settled; drain it before "
                "staging another")
        box: Dict[str, Optional[float]] = {
            "dispatch": time.perf_counter(), "done": None}

        def stamp(_f: Future) -> None:
            box["done"] = time.perf_counter()

        fut.add_done_callback(stamp)
        self._deferred = (fut, box, self._step)
        self._record(overlap_steps_deferred=1)

    def deferred_pending(self) -> bool:
        """True while a staged deferred allreduce awaits its settle."""
        return self._deferred is not None

    def deferred_step(self) -> Optional[int]:
        """Step number of the staged deferred allreduce (None if none)."""
        return self._deferred[2] if self._deferred is not None else None

    def drain_deferred(self) -> Any:
        """Block until the staged deferred allreduce resolves and return
        its result. Its wall splits into ``allreduce_hidden_ms_total``
        (ran under the caller's compute since it was staged) and
        ``allreduce_drain_wait_ms_total`` (still blocked on here). The
        caller then votes and applies or drops
        (:class:`~torchft_tpu_torch.optim.DelayedOptimizer`)."""
        if self._deferred is None:
            raise RuntimeError(
                f"{self._replica_id}: no deferred step staged")
        fut, box, step = self._deferred
        t_drain = time.perf_counter()
        try:
            with self._tracer.span("overlap_drain", deferred_step=step):
                res = fut.result()
        finally:
            self._deferred = None
        t_done = box["done"]
        if t_done is None:  # result() raced the done-callback
            t_done = time.perf_counter()
        hidden = max(0.0, min(t_done, t_drain) - box["dispatch"])
        wait = max(0.0, t_done - t_drain)
        self._record(allreduce_hidden_ms_total=hidden * 1e3,
                     allreduce_drain_wait_ms_total=wait * 1e3)
        return res

    def note_deferred_dropped(self) -> None:
        """Count a settled deferred step whose stale gradients were
        dropped (vote abort, latched error, shutdown) in
        ``overlap_grads_dropped``."""
        self._record(overlap_grads_dropped=1)
        logger.info("%s step=%d deferred gradients dropped (errored=%r)",
                    self._replica_id, self._step, self._errored)

    # ---------------------------------------------------------------- commit

    def should_commit(self, timeout_ms: Optional[int] = None) -> bool:
        """Distributed commit gate: drain in-flight collectives, apply a
        staged heal on this thread, then vote. The step commits iff every
        rank of every participating group succeeded and the quorum was
        large enough. With ``rebalance`` the boundary also carries the
        rebalance decision: published before the vote, adopted after it."""
        self.prepare_commit()
        self._rebalance_pre_vote()
        enough = self._participating_world_size >= self._min_replica_size
        local_ok = self._errored is None and enough
        commit_t0 = time.perf_counter()
        with self._tracer.span("vote", local_ok=local_ok) as vote_span:
            decision = self._client.should_commit(
                rank=self._rank, step=self._step, should_commit=local_ok,
                timeout_ms=timeout_ms or self._timeout_ms)
            vote_span.set(decision=bool(decision))
        self._record(
            commit_count=1,
            commit_ms_total=(time.perf_counter() - commit_t0) * 1e3,
            committed_steps=1 if decision else 0,
            aborted_steps=0 if decision else 1)
        logger.info("%s step=%d should_commit=%s (local=%s enough=%s "
                    "errored=%s)", self._replica_id, self._step, decision,
                    local_ok, enough, self._errored)
        if not decision:
            error = repr(self._errored) if self._errored else None
            self._log_event(event="abort", step=self._step,
                            local_ok=local_ok, error=error)
            self._flight_dump("vote_abort", local_ok=local_ok, error=error)
        self._rebalance_post_vote()
        self._publish_status()
        # Shut the heal window before the caller mutates state.
        self._ckpt_server.disallow_checkpoint()
        self._should_step = decision
        return decision

    # ---------------------------------------------------------------- errors

    def report_error(self, e: Exception) -> None:
        """Latch a step-local error; the step abstains from committing. A
        :class:`CommunicatorError` also poisons the communicator, so the
        next quorum round rebuilds the ring."""
        latched_comm = (isinstance(e, CommunicatorError)
                        and not self._comm_poisoned)
        if isinstance(e, CommunicatorError):
            self._comm_poisoned = True
        if self._errored is None:
            self._errored = e
        if latched_comm:
            # The ring just died: the dump's spans show which collective,
            # bucket and step the reset landed in.
            self._flight_dump("comm_error", error=repr(e))

    def errored(self) -> Optional[Exception]:
        return self._errored

    # --------------------------------------------------------------- metrics

    def _record(self, **deltas: float) -> None:
        with self._metrics_lock:
            for key, delta in deltas.items():
                self._metrics[key] += delta

    def _churn_per_min_locked(self, now_mono: float) -> float:
        """Ring reconfigures in the trailing 60 s (``_metrics_lock``
        held): the ``reconfigures_per_min`` gauge."""
        return float(sum(1 for t in self._reconfig_times
                         if now_mono - t <= 60.0))

    def metrics(self) -> Dict[str, float]:
        """Counters and cumulative stage timings (ms) of this manager,
        with the attached durable writer's ``ckpt_save_*`` counters."""
        with self._metrics_lock:
            out = dict(self._metrics)
            out["reconfigures_per_min"] = self._churn_per_min_locked(
                time.monotonic())
            pct = self._quorum_latency.percentiles()
        out["quorum_ms_p50"] = pct["p50"]
        out["quorum_ms_p95"] = pct["p95"]
        out["quorum_ms_max"] = pct["max"]
        # Lighthouse re-dials live in the C++ manager server, which owns
        # the lighthouse connection.
        out["lighthouse_redials"] = (
            float(self._manager_server.lighthouse_redials())
            if self._manager_server is not None else 0.0)
        out.update(self._retry_stats.snapshot())
        # The ring's own counters: bytes on the sockets (all, and the
        # int8 rung's), the fold / transfer split, and the hierarchical
        # transport's legs (0 on a flat ring). getattr: a scripted test
        # communicator may have none of them.
        for key, attr in (
                ("allreduce_ring_wire_bytes_total", "ring_bytes_total"),
                ("allreduce_int8_ring_bytes_total", "int8_ring_bytes_total"),
                ("hier_intra_bytes_total", "hier_intra_bytes_total"),
                ("hier_leader", "hier_leader")):
            getter = getattr(self._comm, attr, None)
            out[key] = float(getter()) if callable(getter) else 0.0
        split = getattr(self._comm, "ring_time_ms_total", dict)()
        out["allreduce_ring_fold_ms_total"] = float(split.get("fold", 0.0))
        out["allreduce_ring_transfer_ms_total"] = float(
            split.get("transfer", 0.0))
        out.update(self._tracer.metrics())
        out.update(self._flight.metrics() if self._flight is not None
                   else {"flight_dumps_total": 0.0})
        # The transport substrate's counters, process-wide.
        out.update(transport.metrics())
        if self._ckpt_writer is not None:
            out.update(self._ckpt_writer.metrics())
        return out

    def metrics_info(self) -> Dict[str, str]:
        """String diagnostics, split from the numeric :meth:`metrics` at
        the source (the Prometheus exposition renders them as one
        ``torchft_info`` label set): the durable writer's last error,
        the policy in force, the newest flight dump, the ring's topology
        and the fleet hint's slowest-stage attribution of this group."""
        topo_fn = getattr(self._comm, "ring_topology", None)
        topo = topo_fn() if callable(topo_fn) else "flat"
        with self._metrics_lock:
            fleet_stage = self._fleet_stage
        last_err = ""
        if self._ckpt_writer is not None:
            last_err = self._ckpt_writer.last_error() or ""
        return {
            "ckpt_last_error": last_err,
            "policy_name": self._policy.name,
            "flight_last_path": (self._flight.last_path
                                 if self._flight is not None else ""),
            "ring_topology": topo if isinstance(topo, str) else "flat",
            "straggler_stage": fleet_stage,
        }

    def _log_event(self, **event: Any) -> None:
        event["t"] = time.time()
        # The monotonic stamp and the sequence number order this
        # manager's events under wall-clock steps and across threads.
        with self._metrics_lock:
            event["t_mono_ns"] = time.monotonic_ns()
            self._event_seq += 1
            event["seq"] = self._event_seq
            self._history.append(event)

    def history(self) -> list:
        """Recent membership / heal / abort / quarantine events (newest
        last), served at the manager's ``GET /metrics.json``."""
        with self._metrics_lock:
            return list(self._history)

    def _publish_status(self) -> None:
        """Push metrics and history to the C++ manager server (rank 0),
        which serves them at ``GET <manager addr>/metrics.json`` and
        carries the counters on lighthouse heartbeats; then the fleet
        digest. Observability never fails a training step."""
        if self._manager_server is None:
            return
        try:
            mx = self.metrics()
            self._manager_server.set_status(
                json.dumps({"replica_id": self._replica_id,
                            "step": self._step,
                            "quorum_id": self._quorum_id, "metrics": mx,
                            "info": self.metrics_info(),
                            "history": self.history()}),
                int(mx["heal_count"]), int(mx["committed_steps"]),
                int(mx["aborted_steps"]))
            self._push_digest(mx)
        except Exception:  # noqa: BLE001
            logger.debug("status publish failed", exc_info=True)

    def _push_digest(self, mx: Dict[str, float]) -> None:
        """Refresh the per-step digest on the C++ manager server; it
        rides the next quorum RPC beat. Called once per commit boundary
        with that boundary's metrics: the step wall is the monotonic
        time between boundaries, the stage split the tracer's span totals
        of this step, the heal duration this boundary's counter delta;
        with attestation, the committed state's fingerprint keyed by the
        quorum id; the capacity fraction, and the rebalance fraction in
        force for the measured step, by which the lighthouse normalizes
        the wall. The first boundary has no wall and pushes nothing."""
        if not self._fleet_telemetry or self._manager_server is None:
            return
        now = time.monotonic()
        prev = self._digest_prev
        snap = {"t": now, "heal_ms_total": mx.get("heal_ms_total", 0.0),
                "heal_count": mx.get("heal_count", 0.0)}
        self._digest_prev = snap
        # The rebalance fraction stamped is the one in force for the step
        # this digest measures (this boundary's adoption has landed
        # already); rolled at every boundary, the skipped first included.
        with self._metrics_lock:
            reb_prev = self._rebalance_frac_prev
            self._rebalance_frac_prev = self._rebalance_fraction
            capacity = self._capacity_fraction
        if prev is None:
            return
        heal_last_ms = (max(snap["heal_ms_total"] - prev["heal_ms_total"],
                            0.0)
                        if snap["heal_count"] > prev["heal_count"] else 0.0)
        stages = self._tracer.stage_totals(self._step)
        try:
            self._manager_server.set_digest(
                step=self._step,
                step_wall_ms=max(now - prev["t"], 0.0) * 1e3,
                fetch_ms=stages.get("fetch_dispatch", 0.0)
                + stages.get("fetch_wait", 0.0),
                ring_ms=stages.get("ring", 0.0),
                put_ms=stages.get("put", 0.0),
                vote_ms=stages.get("vote", 0.0),
                heal_bytes_inflight=mx.get("heal_last_bytes_committed",
                                           0.0),
                capacity_fraction=capacity,
                churn_per_min=mx.get("reconfigures_per_min", 0.0),
                healing=bool(self._healing or not self.is_participating()),
                heal_last_ms=heal_last_ms,
                trace_addr=self._ckpt_server.address(),
                quorum_id=self._quorum_id,
                state_digest=self._compute_state_digest(),
                rebalance_fraction=reb_prev)
        except Exception:  # noqa: BLE001 — observability never fails
            logger.debug("digest push failed", exc_info=True)

    def _compute_state_digest(self) -> str:
        """The committed state's 32-hex attestation digest (four u32
        words, :mod:`torchft_tpu_torch.ops.attest`: the card kernel for
        the tensors on the card, 16 bytes to the host), or ``""`` when
        attestation is off, the state holds no array leaf, or anything
        goes wrong: an absent digest makes this group a non-voter at the
        lighthouse, never a failed step (``sdc_digests_total`` counts the
        digests made)."""
        if not self._attestation:
            return ""
        try:
            t0 = time.monotonic()
            leaves = [leaf for leaf in tree_flatten(
                self._user_state_dict())[0]
                if serialization._is_array_leaf(leaf)
                and serialization._leaf_nbytes(leaf)]
            if not leaves:
                return ""
            digest = serialization.attest_combine(
                attest_ops.attest_words(leaves))
            self._record(sdc_digests_total=1,
                         sdc_digest_ms_total=(time.monotonic() - t0) * 1e3)
            self._last_state_digest = digest
            return digest
        except Exception:  # noqa: BLE001 — attestation never fails a step
            logger.debug("state digest failed", exc_info=True)
            return ""

    # ----------------------------------------------- sdc chaos injection

    def _maybe_chaos_sdc(self) -> None:
        """:meth:`step`'s chaos hook: poll the ``sdc`` chaos channel once
        per commit boundary and, on a decision, flip ONE bit of one
        committed leaf. Participants only (a healer is mid-restore). No
        schedule or no config for this endpoint draws nothing, so every
        other channel's faults stay the same with the band off."""
        with self._metrics_lock:
            healing = self._healing
            quarantined = self._sdc_quarantined
        if healing or quarantined:
            return
        try:
            d = chaos_mod.sdc_fault(f"sdc:{self._replica_id}")
            if d is None:
                return
            self._apply_sdc_flip(d.frac)
        except Exception:  # noqa: BLE001 — chaos never fails a step
            logger.debug("sdc chaos injection failed", exc_info=True)

    def _maybe_chaos_slow(self) -> None:
        """:meth:`step`'s hook for the chaos ``slow`` band: poll it once
        per boundary and, on a decision, sleep ``(factor - 1)`` times the
        natural wall of the boundary just finished (the measured wall
        less the sleep injected there, so the stretch converges to
        ``factor`` times instead of compounding). Participants only, and
        no draw otherwise: a healer or spare reports no wall the
        rebalancer reads."""
        now = time.monotonic()
        prev = self._chaos_slow_prev
        injected = self._chaos_slow_injected
        self._chaos_slow_prev = now
        self._chaos_slow_injected = 0.0
        if not self.is_participating():
            return
        try:
            factor = chaos_mod.slow_fault(f"slow:{self._replica_id}")
        except Exception:  # noqa: BLE001 — chaos never fails a step
            logger.debug("slow chaos injection failed", exc_info=True)
            return
        if factor <= 1.0 or prev is None:
            return
        sleep_s = (factor - 1.0) * max(0.0, (now - prev) - injected)
        if sleep_s <= 0.0:
            return
        self._chaos_slow_injected = sleep_s
        time.sleep(sleep_s)

    def _apply_sdc_flip(self, frac: float) -> None:
        """Flip one bit of the committed state: the (leaf, byte, bit)
        choice is a pure function of the decision's ``frac``, so a seeded
        schedule corrupts the same bit run over run. A tensor leaf flips
        in place, on its own device; any other leaf goes back through the
        registered ``load_state_dict``."""
        leaves, treedef = tree_flatten(self._user_state_dict())
        idxs = [i for i, leaf in enumerate(leaves)
                if serialization._is_array_leaf(leaf)
                and serialization._leaf_nbytes(leaf)]
        if not idxs:
            return
        li = idxs[int(frac * len(idxs)) % len(idxs)]
        leaf = leaves[li]
        nbytes = serialization._leaf_nbytes(leaf)
        byte = int(frac * nbytes) % nbytes
        bit = int(frac * 8) % 8
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if not t.is_contiguous():
                t = t.contiguous()
            with torch.no_grad():
                t.reshape(-1).view(torch.uint8)[byte] ^= 1 << bit
            if t.data_ptr() != leaf.data_ptr():
                leaves[li] = t
        else:
            a = np.array(leaf)  # contiguous host copy, any dtype
            a.view(np.uint8).reshape(-1)[byte] ^= np.uint8(1 << bit)
            leaves[li] = a
        if leaves[li] is not leaf:
            self._user_load_state_dict(tree_unflatten(treedef, leaves))
        self._record(sdc_chaos_flips_total=1)
        self._log_event(event="sdc_chaos_flip", step=self._step, leaf=li,
                        byte=byte, bit=bit)
        logger.warning("%s: chaos sdc_flip at step %d — leaf %d byte %d "
                       "bit %d", self._replica_id, self._step, li, byte,
                       bit)

    # ----------------------------------------------------------- state dicts

    def _manager_state_dict(self) -> Dict[str, Any]:
        return {"user": self._user_state_dict(), "torchft": self.state_dict()}

    def state_dict(self) -> Dict[str, int]:
        """Manager metadata that rides along with user checkpoints; a
        policy-aware manager adds its policy's knobs, so a healer or a
        cold start adopts the job's wire rung."""
        out = {"step": self._step,
               "batches_committed": self._batches_committed}
        if self._policy_aware:
            out.update(self._policy.to_state())
        return out

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        with self._metrics_lock:
            self._step = int(state_dict["step"])
            self._batches_committed = int(state_dict["batches_committed"])
        # A policy-aware manager adopts the donor's policy here, on the
        # quorum thread before this step's allreduce, so a healer's zero
        # contribution is already in the fleet's wire format.
        if self._policy_aware and "policy_wire" in state_dict:
            p = policy_mod.FTPolicy.from_state(state_dict,
                                               ladder=policy_mod.LADDER)
            if p.knobs() != self._policy.knobs():
                self._install_policy(p, reason="adopted with restored state")

    # ---------------------------------------------------------------- policy

    def policy(self) -> policy_mod.FTPolicy:
        """The policy in force (its wire rung selects the allreduce's)."""
        return self._policy

    def _install_policy_knobs(self, p: policy_mod.FTPolicy) -> None:
        self._overlap_steps = int(p.overlap_steps)
        wd = p.wire_dtype()
        self._wire_dtype = host_dtype(wd) if wd is not None else None

    def _install_policy(self, p: policy_mod.FTPolicy, reason: str) -> None:
        """Adopt ``p``: its knobs, and a flush of both residual stores
        when the wire rung changes — the int8 rung's residuals belong to
        the outgoing format and must never fold into another's."""
        _check_ported(p)
        old = self._policy
        wire_changed = old.wire != p.wire
        self._policy = p
        self._install_policy_knobs(p)
        self._tracer.set_context(policy_name=p.name)
        if wire_changed:
            self._ef_residuals.clear()
            self._dev_residuals.clear()
        with self._metrics_lock:
            self._metrics["policy_switches_total"] += 1
            if wire_changed:
                self._metrics["wire_quant_residual_bytes"] = 0.0
        logger.info("%s policy %s -> %s at step %d (%s)", self._replica_id,
                    old.name, p.name, self._step, reason)

    # ------------------------------------------------------------- accessors

    def overlap_steps(self) -> int:
        """Cross-step overlap depth: 0 commits synchronously, 1 runs the
        deferred commit. Read by the trainer to pick its loop."""
        return self._overlap_steps

    def num_participants(self) -> int:
        """Groups contributing real gradients this step (clamped to
        ``min_replica_size`` under ``FIXED_WITH_SPARES``)."""
        return self._participating_world_size

    def participant_rank(self) -> Optional[int]:
        """This group's rank among the step's participants, or ``None``
        while healing or benched: the elastic sampler's slot offset."""
        if self._participating_rank is None or self._healing:
            return None
        return self._participating_rank

    def participant_slot(self) -> tuple:
        """Atomic ``(participant_rank, batches_committed,
        effective_fraction)``, the fraction being the capacity fraction
        times the rebalance fraction: what
        :class:`~torchft_tpu_torch.data.ElasticSampler` draws by.

        The three are written under the metrics lock (:meth:`step` bumps
        the count, the quorum thread installs the rank, the capacity and
        rebalance transitions move the fractions), so this never returns
        a torn combination — a new rank with the old count would draw a
        wrong slot with no error. It first joins the step's in-flight
        quorum round, so the rank is this step's, not the previous
        membership's; a failed round is swallowed here (the step aborts
        through the vote)."""
        fut = self._quorum_future
        if fut is not None and not fut.done():
            try:
                fut.result()
            except Exception:  # noqa: BLE001 — latches via wait_quorum
                pass
        with self._metrics_lock:
            if self._participating_rank is None or self._healing:
                rank: Optional[int] = None
            else:
                rank = self._participating_rank
            frac = self._capacity_fraction * self._rebalance_fraction
            return rank, self._batches_committed, frac

    def is_participating(self) -> bool:
        """False while healing (async quorum), benched as a spare, or held
        out of the fold by a divergence verdict."""
        return (self._participating_rank is not None
                and not self._sdc_quarantined and not self._healing)

    def is_healing(self) -> bool:
        return self._healing

    def quorum_id(self) -> int:
        return self._quorum_id

    def current_step(self) -> int:
        return self._step

    def batches_committed(self) -> int:
        return self._batches_committed

    def replica_id(self) -> str:
        return self._replica_id

    def tracer(self) -> "tracing_mod.Tracer":
        return self._tracer

    def shutdown(self) -> None:
        if self._shutdown_done:
            return
        self._shutdown_done = True
        if self._deferred is not None:
            # At most the one in-flight step is lost, as on a vote abort;
            # FTTrainer.shutdown flushes it first.
            self.note_deferred_dropped()
            logger.warning(
                "%s: shutdown with a deferred step in flight; its "
                "gradients are dropped (flush before shutdown to apply "
                "them)", self._replica_id)
            self._deferred = None
        if self._flight is not None:
            self._flight.close()
        self._ckpt_server.shutdown()
        self._executor.shutdown(wait=False, cancel_futures=True)
        # A queued put must still run: it resolves the aggregate future.
        self._put_executor.shutdown(wait=False)
        self._comm.shutdown()
        if self._manager_server is not None:
            self._manager_server.shutdown()
        if self._store_server is not None:
            self._store_server.shutdown()


def _env_flag(value: Optional[bool], name: str,
              default: bool = True) -> bool:
    """A switch: ``value`` when given, else the environment variable
    ``name`` — a default-on switch unless it says ``0`` or ``false``, a
    default-off one only when it says ``1`` or ``true``."""
    if value is not None:
        return bool(value)
    raw = os.environ.get(name, "").strip().lower()
    if default:
        return raw not in ("0", "false")
    return raw in ("1", "true")


def _addr_base(addr: str) -> str:
    """Canonical server base of a checkpoint-plane URL — the one spelling
    shared by the quarantine ledger and every donor resolver, so a group
    quarantined by its trace address is recognized whatever route
    (``…/checkpoint/{step}``, ``…/ramckpt/{step}``, bare base) a
    consumer holds."""
    if "/checkpoint/" in addr:
        return addr.rsplit("/checkpoint/", 1)[0]
    if "/ramckpt/" in addr:
        return addr.rsplit("/ramckpt/", 1)[0]
    return addr.rstrip("/")


def _stripe_seed(replica_id: str) -> int:
    """Per-healer stripe-shuffle seed: replica ids carry a per-process
    uuid suffix, so concurrent healers derive different donor orders and
    spread their first streams over the donor set."""
    return zlib.crc32(replica_id.encode())


# --------------------------------------------------------------- schedule


def _np_dtype(leaf: Any) -> np.dtype:
    """Host dtype a leaf crosses the ring in (bfloat16 as
    :data:`~torchft_tpu_torch.communicator.BF16`)."""
    if isinstance(leaf, torch.Tensor):
        return host_dtype(leaf.dtype)
    return np.asarray(leaf).dtype


def _torch_dtype(d: np.dtype) -> torch.dtype:
    """The torch dtype of a host dtype."""
    if d == BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, d)).dtype


def _check_ported(p: policy_mod.FTPolicy) -> None:
    if p.diloco:
        raise ValueError(f"policy {p.name!r}: DiLoCo is not ported yet")


class _ChunkPlan:
    """Geometry of one packed ring chunk: the leaves (by flat index) that
    concatenate into one contiguous 1-D buffer of one (accumulator, wire)
    dtype pair."""

    __slots__ = ("orig", "wire", "idx", "sizes", "shapes", "total")

    def __init__(self, orig: np.dtype, wire: np.dtype) -> None:
        self.orig = orig
        self.wire = wire
        self.idx: list = []
        self.sizes: list = []
        self.shapes: list = []
        self.total = 0


class _AllreduceSchedule:
    __slots__ = ("buckets", "chunks", "fingerprint")

    def __init__(self, buckets: list, chunks: list,
                 fingerprint: str) -> None:
        self.buckets = buckets
        self.chunks = chunks
        self.fingerprint = fingerprint


def _wire_pair(dtype: Any, wire: Optional[np.dtype]) -> tuple:
    """(accumulator, wire) dtype pair of a leaf, from metadata: the wire
    dtype applies to float leaves wider than it. bf16 leaves keep their
    dtype on every rung: ml_dtypes' bfloat16, which the JAX package
    decides by, is not a numpy floating type, and neither is
    :data:`~torchft_tpu_torch.communicator.BF16`."""
    orig = host_dtype(dtype)
    if (wire is not None and np.issubdtype(orig, np.floating)
            and orig.itemsize > wire.itemsize):
        return orig, wire
    return orig, orig


def _derive_schedule(metas: tuple, bucket_bytes: int,
                     wire_dtype: Optional[Any] = None
                     ) -> _AllreduceSchedule:
    """Bucket + chunk schedule from per-leaf (shape, dtype) metadata only,
    as the JAX package derives it: participants, healers and spares must
    produce identical geometry or the ring wedges. Buckets are sized in
    wire bytes and close once they reach ``bucket_bytes``; within a
    bucket, leaves group into one chunk per (accumulator, wire) dtype
    pair in first-occurrence order. The fingerprint spells each chunk
    ``orig:wire:sizes`` with numpy's dtype names (``bfloat16`` for
    bf16), as the JAX package does."""
    wire = host_dtype(wire_dtype) if wire_dtype is not None else None
    pairs = [_wire_pair(dt, wire) for _, dt in metas]
    adv = [int(np.prod(shape) or 1) * pairs[i][1].itemsize
           for i, (shape, _) in enumerate(metas)]
    buckets: list = []
    cur: list = []
    cur_bytes = 0
    for i, nbytes in enumerate(adv):
        cur.append(i)
        cur_bytes += nbytes
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    chunks: list = []
    for idx in buckets:
        by_key: Dict[tuple, _ChunkPlan] = {}
        cs: list = []
        for i in idx:
            orig, wdt = pairs[i]
            key = (dtype_name(orig), dtype_name(wdt))
            c = by_key.get(key)
            if c is None:
                c = by_key[key] = _ChunkPlan(orig, wdt)
                cs.append(c)
            c.idx.append(i)
            c.sizes.append(int(np.prod(metas[i][0])))
            c.shapes.append(tuple(metas[i][0]))
        for c in cs:
            c.total = int(sum(c.sizes))
        chunks.append(cs)
    fingerprint = "wire-v2|" + "|".join(
        ";".join(f"{dtype_name(c.orig)}:{dtype_name(c.wire)}:"
                 f"{','.join(map(str, c.sizes))}" for c in cs)
        for cs in chunks)
    return _AllreduceSchedule(buckets, chunks, fingerprint)


def _host_pack(leaves: list, wire: np.dtype) -> np.ndarray:
    """One fresh contiguous host buffer of host leaves (tensors or numpy)
    in the wire dtype — the ring reduces it in place."""
    parts = [np.ravel(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x)) for x in leaves]
    if not parts:
        return np.empty(0, wire)
    flat = np.concatenate(parts)
    return flat if flat.dtype == wire else to_dtype(flat, wire)


def _pack_leaves(leaves: list, wire: np.dtype) -> torch.Tensor:
    """The chunk's tensor leaves as one flat tensor in the wire dtype, on
    their device (``_pack_leaves``, JAX :5189): a concat and a cast; bf16
    is carried as its int16 bits, numpy's view of which is
    :data:`~torchft_tpu_torch.communicator.BF16`."""
    with torch.no_grad():
        flat = torch.cat([x.detach().reshape(-1) for x in leaves])
        flat = flat.to(_torch_dtype(wire))
        return flat.view(torch.int16) if wire == BF16 else flat


def _device_quantize_pack(leaves: list, residual: torch.Tensor,
                          seg_elems: int = INT8_SEG_ELEMS) -> tuple:
    """The int8 rung's quantize-pack on the leaves' device
    (``_device_quantize_pack``, JAX :5313), operation for operation in
    float32: concat, upcast, the residual fold, the per-segment quantize
    with a power-of-two scale, and the new residual. Returns
    ``(payload, new residual)``: the payload is one uint8 tensor laid out
    as ``Int8Wire.to_bytes`` (``scales | zeros | q``, little-endian), the
    residual ``v - dequant(q)`` with non-finite entries zeroed.

    Bitwise equal to ``Int8Wire.quantize`` on the host: min, max, the
    subtractions, the divisions and the round (half to even, as
    ``np.rint``) are exact or round once, the scale comes from exponent
    bits, and ``q * scale`` is exact. The divisors are tensors on the
    device: CUDA torch divides by a host scalar as a multiply by its
    reciprocal, which rounds differently."""
    with torch.no_grad():
        v = torch.cat([x.detach().reshape(-1).to(torch.float32)
                       for x in leaves]) + residual
        n = v.numel()
        nseg = max(1, -(-n // seg_elems))
        pad = nseg * seg_elems - n
        # Pad with the last element: it belongs to the last segment, so
        # the padded min/max are the true segment min/max.
        vp = torch.cat([v, v[n - 1].expand(pad)]) if pad else v
        m = vp.view(nseg, seg_elems)
        lo = m.amin(dim=1)
        hi = m.amax(dim=1)
        zero = (hi + lo) / hi.new_full((), 2.0)
        s0 = (hi - lo) / hi.new_full((), 254.0)
        finite = torch.isfinite(zero) & torch.isfinite(s0)
        ok = finite & (s0 > 0)
        zeros = torch.where(finite, zero, 0.0)
        # Smallest power of two >= s0 from its exponent bits; s0 > 0 so
        # the sign bit is clear and int32 holds the bits.
        bits = torch.where(ok, s0, 1.0).view(torch.int32)
        e = (bits >> 23) + ((bits & 0x7FFFFF) != 0).to(torch.int32)
        e = e.clamp(1, 254)
        scales = torch.where(ok, (e << 23).view(torch.float32), 0.0)
        qf = torch.clamp(torch.round((m - zeros[:, None]) / scales[:, None]),
                         -127, 127)
        qm = torch.where(scales[:, None] > 0, qf, 0.0).to(torch.int8)
        deq = (qm.to(torch.float32) * scales[:, None]
               + zeros[:, None]).reshape(-1)[:n]
        new_res = v - deq
        new_res = torch.where(torch.isfinite(new_res), new_res, 0.0)
        payload = torch.cat([scales.view(torch.uint8),
                             zeros.view(torch.uint8),
                             qm.reshape(-1)[:n].view(torch.uint8)])
    return payload, new_res


def _stage_ahead_window() -> Optional[int]:
    """How many buckets beyond the one being waited on may hold packed
    copies on the device: ``None`` (the default) stages every bucket up
    front, ``TORCHFT_ALLREDUCE_STAGE_AHEAD=<K>`` caps it for jobs tight on
    device memory (a value that is not an integer caps it at 0)."""
    raw = os.environ.get("TORCHFT_ALLREDUCE_STAGE_AHEAD", "").strip()
    if not raw:
        return None
    try:
        return max(int(raw), 0)
    except ValueError:
        logger.warning("non-integer TORCHFT_ALLREDUCE_STAGE_AHEAD=%r; "
                       "treating as 0 (no stage-ahead)", raw)
        return 0


def _zero_wire_chunk(c: _ChunkPlan, int8: bool) -> Any:
    """A healer's or spare's zero contribution to one chunk, in this
    step's wire format: ``Int8Wire`` zeros for float chunks on the int8
    rung, zeros of the wire dtype otherwise (bf16 zero is all-zero
    bits)."""
    if int8 and np.issubdtype(c.orig, np.floating):
        return Int8Wire.zeros_like(c.total)
    return np.zeros(c.total, c.wire)


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor sharing its memory (bf16 from the
    :data:`~torchft_tpu_torch.communicator.BF16` carrier's bits)."""
    if arr.dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _put_bucket_chunks(chunks: list, reduced: list, leaves: list,
                       n: int) -> Dict[int, Any]:
    """Put stage of one bucket: 1/n on the host, then one host->device
    copy per chunk whose leaves live on a CUDA device, split into views
    shaped like the leaves. Returns ``{flat leaf index: placed leaf}``."""
    scaled: Dict[int, Any] = {}
    for c, arr in zip(chunks, reduced):
        arr = div_by_count(np.asarray(arr), n)
        ref = leaves[c.idx[0]] if c.idx else None
        if isinstance(ref, torch.Tensor):
            flat = _host_tensor(arr).to(ref.device)
            parts = torch.split(flat, c.sizes)
        else:
            parts = np.split(arr, np.cumsum(c.sizes)[:-1])
        for i, shape, part in zip(c.idx, c.shapes, parts):
            scaled[i] = part.reshape(shape)
    return scaled


def _put_stripes(chunks: list, stripes: list, leaves: list,
                 n: int) -> list:
    """Put stage of one reduce-scattered bucket: 1/n of each stripe on the
    host, then its copy to the device of the chunk's tensor leaves (host
    chunks keep the host array)."""
    out = []
    for c, arr in zip(chunks, stripes):
        arr = div_by_count(np.asarray(arr), n)
        ref = leaves[c.idx[0]] if c.idx else None
        out.append(_host_tensor(arr).to(ref.device)
                   if isinstance(ref, torch.Tensor) else arr)
    return out


def _zeros_like_chunk(c: _ChunkPlan, size: int, leaves: list) -> Any:
    """Zeros of ``size`` elements in the chunk's dtype, placed like its
    leaves."""
    ref = leaves[c.idx[0]] if c.idx else None
    if isinstance(ref, torch.Tensor):
        return torch.zeros(size, dtype=_torch_dtype(c.orig),
                           device=ref.device)
    return np.zeros(size, c.orig)


class ShardedGrads:
    """This rank's canonical stripe of an averaged gradient tree, and the
    geometry the sharded optimizer needs (JAX ``manager.py:5564``).
    ``chunks`` are the schedule's :class:`_ChunkPlan` objects in order;
    ``shards[k]`` is the 1/n-scaled 1-D stripe
    ``[bounds[rank], bounds[rank + 1])`` of chunk k
    (:func:`~torchft_tpu_torch.communicator.shard_bounds` over the ring
    world), a tensor on the device of the chunk's leaves. ``leaves`` are
    the gradient leaves, templates of placement only. Produced by
    :meth:`Manager.reduce_scatter`, consumed by
    :meth:`FTOptimizer.apply <torchft_tpu_torch.optim.FTOptimizer.apply>`.
    """

    __slots__ = ("chunks", "shards", "rank", "world", "leaves", "treedef")

    def __init__(self, chunks: list, shards: list, rank: int, world: int,
                 leaves: list, treedef: Any) -> None:
        self.chunks = chunks
        self.shards = shards
        self.rank = rank
        self.world = world
        self.leaves = leaves
        self.treedef = treedef

    def geometry_key(self) -> tuple:
        """The stripe geometry: stripe optimizer state is valid only while
        it is unchanged. A membership change moves every rank's stripe,
        so every rank resets together; params stay lockstep, only the
        moments restart."""
        return (self.world, self.rank,
                tuple(int(s.numel() if isinstance(s, torch.Tensor)
                          else np.size(s)) for s in self.shards),
                tuple(dtype_name(c.orig) for c in self.chunks))

    def _check_leaves(self, pleaves: list) -> None:
        if len(pleaves) != len(self.leaves):
            raise ValueError(
                f"params have {len(pleaves)} leaves, grads had "
                f"{len(self.leaves)} — the sharded update needs matching "
                "structures")

    def param_shards(self, params: Any) -> list:
        """This rank's stripe of ``params``, chunk-aligned with
        :attr:`shards`: one fresh 1-D tensor per chunk, sliced on the
        params' device, so only this rank's 1/world of each leaf is
        read."""
        pleaves, _ = tree_flatten(params)
        self._check_leaves(pleaves)
        out = []
        with torch.no_grad():
            for c in self.chunks:
                bd = shard_bounds(c.total, self.world)
                lo, hi = int(bd[self.rank]), int(bd[self.rank + 1])
                pieces = []
                off = 0
                for i, size in zip(c.idx, c.sizes):
                    a, b = max(lo, off), min(hi, off + size)
                    if a < b:
                        pieces.append(
                            pleaves[i].detach().reshape(-1)[a - off:b - off])
                    off += size
                ref = pleaves[c.idx[0]]
                out.append(torch.cat(pieces).to(_torch_dtype(c.orig))
                           if pieces else
                           torch.empty(0, dtype=_torch_dtype(c.orig),
                                       device=ref.device))
        return out

    def host_stripes(self, stripes: list) -> list:
        """This rank's updated stripes as host tensors for
        :meth:`Manager.allgather_shards`, each padded to its chunk's widest
        stripe. The host ring's allgather restores every peer's payload
        into the shapes of the local one, and stripes of one chunk differ
        by up to one element across ranks; the JAX package sends them
        unpadded, so its allgather fails, and the step aborts, whenever
        they differ. :meth:`assemble_params` trims the padding."""
        out = []
        for c, s in zip(self.chunks, stripes):
            width = int(np.diff(shard_bounds(c.total, self.world)).max())
            host = s.detach().cpu()
            if host.numel() < width:
                host = torch.cat([host, host.new_zeros(width - host.numel())])
            out.append(host)
        return out

    def assemble_params(self, gathered: list, params: Any,
                        own: Optional[list] = None) -> Any:
        """Write every rank's updated stripes into ``params`` in place and
        return ``params``. ``gathered[r][k]`` is rank r's host stripe of
        chunk k (:meth:`Manager.allgather_shards`), exact or padded by
        :meth:`host_stripes`; ``own``, when given, holds this rank's
        stripes on the device, which are then copied on the device instead
        of back from the host. Every rank writes the same bytes, so params
        stay bitwise lockstep."""
        pleaves, _ = tree_flatten(params)
        self._check_leaves(pleaves)
        with torch.no_grad():
            for k, c in enumerate(self.chunks):
                bd = shard_bounds(c.total, self.world)
                width = int(np.diff(bd).max())
                for r in range(self.world):
                    lo, hi = int(bd[r]), int(bd[r + 1])
                    if own is not None and r == self.rank:
                        seg = own[k]
                    else:
                        g = gathered[r][k]
                        seg = (g.reshape(-1) if isinstance(g, torch.Tensor)
                               else _host_tensor(np.ascontiguousarray(
                                   np.ravel(np.asarray(g)))))
                        if seg.numel() == width:
                            seg = seg[:hi - lo]
                    if seg.numel() != hi - lo:
                        raise ValueError(
                            f"rank {r} published a {seg.numel()}-element "
                            f"stripe for chunk {k}; the geometry expects "
                            f"{hi - lo} — is shard_update set alike on "
                            "every group?")
                    off = 0
                    for i, size in zip(c.idx, c.sizes):
                        a, b = max(lo, off), min(hi, off + size)
                        if a < b:
                            pleaves[i].detach().view(-1)[a - off:b - off] \
                                .copy_(seg[a - lo:b - lo])
                        off += size
        return params


def _instant(value: Any) -> Future:
    f: Future = Future()
    f.set_result(value)
    return f
