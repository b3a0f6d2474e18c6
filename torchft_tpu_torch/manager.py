"""Per-step fault-tolerance state machine, sync path (sub-slice (a) of the
JAX package's ``torchft_tpu/manager.py``).

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

What this sub-slice carries, branch for branch with the JAX Manager:
``step`` (:1086), ``_async_quorum_inner`` (:1215) with the single-donor
resumable heal and its donor failover, ``allreduce`` (:1953) on the
synchronous bucketed host path with an exact f32 wire, ``should_commit``
(:3882), ``report_error`` with ring poisoning and the recovery rendezvous,
``state_dict``/``load_state_dict``, the accessors and ``shutdown``. The
cross-step overlap engine, the sharded update, wire quantization, state
digests, the adaptive policy, rebalancing, degraded mode, the RAM tier,
publication, preemption drains and striped heals are later sub-slices;
their constructor arguments are not accepted.

The device side of the allreduce is torch: each bucket's gradient leaves
are packed on the device into one buffer per dtype, copied into a pinned
host buffer without blocking, and handed to the ring as soon as the copy
lands, while later buckets' copies continue. The reduced buffer is scaled
by 1/n on the host (the same IEEE division the JAX package runs) and
copied back to the leaves' device. The bucket schedule is derived from
leaf metadata exactly as the JAX package derives it, so every rank — and a
JAX rank on the same ring — agrees on the geometry.
"""

from __future__ import annotations

import logging
import os
import socket
import sys
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, TypeVar, cast

import numpy as np
import torch

from torchft_tpu_torch import tracing as tracing_mod
from torchft_tpu_torch._native import (ManagerClient, ManagerServer, Store,
                                       StoreClient)
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.communicator import Communicator, CommunicatorError
from torchft_tpu_torch.retry import RetryPolicy, RetryStats
from torchft_tpu_torch.utils import (advertise_host, div_by_count,
                                     tree_flatten, tree_unflatten)

logger: logging.Logger = logging.getLogger(__name__)

MANAGER_ADDR_KEY: str = "manager/addr"
# Consecutive failed quorum rounds before step() raises instead of spinning.
_MAX_CONSECUTIVE_FAILURES = 20
_MAX_DONOR_FAILOVERS = 3
T = TypeVar("T")


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
        timeout_ms / quorum_timeout_ms: RPC timeouts for the commit barrier
            and the quorum.
        rank / world_size: this process's rank within its replica group and
            the group's local world size.
        replica_id: stable name of this replica group; a uuid suffix makes
            a restarted group a fresh quorum member.
        store_addr / lighthouse_addr: the group's KV store (rank 0 starts
            one when omitted) and the global lighthouse (env
            ``TORCHFT_LIGHTHOUSE``).
        allreduce_bucket_bytes: target bucket size of the pipelined host
            allreduce.
        overlap_steps: only 0 (synchronous commit) is ported.
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
        timeout_ms: int = 60_000,
        quorum_timeout_ms: int = 60_000,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        replica_id: Optional[str] = None,
        store_addr: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        allreduce_bucket_bytes: int = 4 << 20,
        overlap_steps: int = 0,
        auth_token: Optional[str] = None,
        checkpoint_bind_host: Optional[str] = None,
        _manager_client: Optional[ManagerClient] = None,
    ) -> None:
        if overlap_steps != 0:
            raise ValueError(
                "overlap_steps must be 0: the cross-step overlap engine "
                f"is not ported yet (got {overlap_steps!r})")
        self._comm = comm
        self._tracer = tracing_mod.Tracer()
        self._bucket_bytes = max(int(allreduce_bucket_bytes), 1)
        self._user_load_state_dict = load_state_dict
        self._user_state_dict = state_dict
        self._min_replica_size = min_replica_size
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
            "reconfigure_count": 0, "reconfigure_ms_total": 0.0,
            "heal_count": 0, "heal_ms_total": 0.0, "heal_bytes_total": 0.0,
            "heal_bytes_resumed_total": 0.0, "heal_donor_failovers": 0.0,
            "heal_attempts_total": 0.0,
            "heal_last_bytes_committed": 0.0, "heal_last_payload_bytes": 0.0,
            "allreduce_count": 0, "allreduce_ms_total": 0.0,
            "allreduce_fetch_ms_total": 0.0,
            "allreduce_fetch_dispatch_ms_total": 0.0,
            "allreduce_fetch_wait_ms_total": 0.0,
            "allreduce_ring_ms_total": 0.0, "allreduce_put_ms_total": 0.0,
            "allreduce_d2h_wire_bytes_total": 0.0, "allreduce_inflight": 0,
            "commit_count": 0, "commit_ms_total": 0.0,
            "committed_steps": 0, "aborted_steps": 0,
        }
        self._metrics_lock = threading.Lock()
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
        self._tracer.set_context(replica_id=self._replica_id,
                                 step=self._step, policy_name="sync-f32")
        attach = getattr(self._ckpt_server, "attach_observability", None)
        if attach is not None:
            attach(tracer=self._tracer, metrics_fn=self.metrics,
                   labels={"replica_id": self._replica_id})

    # ------------------------------------------------------------------ step

    def step(self) -> None:
        """Begin a new training step: bump the step counter when the
        previous step committed, re-open the heal window, and start the
        quorum round off the critical path."""
        with self._metrics_lock:
            streak = self._quorum_failure_streak
        if streak >= _MAX_CONSECUTIVE_FAILURES:
            raise RuntimeError(
                f"{self._replica_id}: control plane unreachable — {streak} "
                "consecutive quorum rounds failed; refusing to spin")
        if streak > 0:
            time.sleep(min(0.05 * streak, 1.0))
        if self._should_step:
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
            sp.set(quorum_id=q.quorum_id)
        quorum_ms = (time.perf_counter() - t0) * 1e3
        self._record(quorum_count=1, quorum_ms_total=quorum_ms)
        with self._metrics_lock:
            self._metrics["quorum_ms_last"] = quorum_ms
        if (q.replica_world_size <= 0 or q.quorum_id <= 0
                or not 0 <= q.replica_rank < q.replica_world_size):
            raise RuntimeError(
                f"invalid quorum response (quorum_id={q.quorum_id}, "
                f"replica_rank={q.replica_rank}, replica_world_size="
                f"{q.replica_world_size}); treating as a failed round")
        self._tracer.set_context(quorum_id=q.quorum_id)
        logger.debug("%s quorum at step %d: %s", self._replica_id, self._step, q)

        with self._metrics_lock:
            # Healers are not at max_step: they sit this step out
            # (max_rank is None) and contribute zero grads.
            self._participating_rank = q.max_rank
            self._participating_world_size = q.max_world_size

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
                setter(f"bucket_bytes={self._bucket_bytes};"
                       "wire_dtype=None;degraded=0;payload=wire-v5")
            reconf_t0 = time.perf_counter()
            self._comm.configure(store_prefixed, q.replica_rank,
                                 q.replica_world_size)
            self._quorum_id = q.quorum_id
            self._comm_poisoned = False
            self._record(reconfigure_count=1, reconfigure_ms_total=(
                time.perf_counter() - reconf_t0) * 1e3)

        if not q.heal:
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
            state = cast(Dict[str, Any], CheckpointServer.load_from_address(
                ckpt_addr, self._manager_state_dict(), stats=heal_stats,
                auth_token=self._auth_token,
                retry_policy=self._retry_policy,
                retry_stats=self._retry_stats,
                stall_timeout_sec=self._heal_stall_timeout_sec,
                donors=lambda i: self._resolve_next_donor(i, q),
                max_donor_failovers=_MAX_DONOR_FAILOVERS,
                progress_cb=self._heal_progress, tracer=self._tracer))
        finally:
            heal_span.set(bytes=heal_stats.get("bytes", 0.0)).__exit__(
                *sys.exc_info())
            heal_ms = (time.perf_counter() - heal_t0) * 1e3
            self._record(
                heal_ms_total=heal_ms,
                heal_bytes_total=heal_stats.get("bytes", 0.0),
                heal_bytes_resumed_total=heal_stats.get("bytes_resumed", 0.0),
                heal_donor_failovers=heal_stats.get("donor_failovers", 0.0),
                heal_attempts_total=heal_stats.get("attempts", 0.0))
        # Manager metadata restores now, on this thread; the user state is
        # staged and applied on the main thread at commit.
        self.load_state_dict(state["torchft"])
        self._pending_state_dict = state

    def _resolve_checkpoint_addr(self, manager_addr: str) -> str:
        """A peer manager's checkpoint-server URL for this rank."""
        return ManagerClient(
            manager_addr, connect_timeout_ms=self._timeout_ms,
            retry_policy=self._retry_policy,
            retry_stats=self._retry_stats,
        ).checkpoint_address(self._rank, timeout_ms=self._timeout_ms)

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
            logger.info("%s: heal failing over to donor %s (#%d)",
                        self._replica_id, q2.recover_manager_address,
                        failover_idx + 1)
            return self._resolve_checkpoint_addr(q2.recover_manager_address)
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

    # ------------------------------------------------------------- allreduce

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
        pack every bucket on the device and start its copy into pinned
        host memory; then per bucket, in order, wait for its copy and hand
        it to the comm worker; (2) the ring; (3) on the put thread, 1/n on
        the host and the copy back to the device."""
        n = max(self.num_participants(), 1)
        participating = self.is_participating()
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

        staged = (self._stage_all(sched, leaves) if participating
                  else None)
        for b, chunks in enumerate(sched.chunks):
            if staged is not None:
                bufs = self._wait_bucket(staged[b], bucket=b)
                staged[b] = None  # release the packed device copies
            else:
                # Healers and spares: zeros, from the shared schedule.
                bufs = [np.zeros(c.total, c.orig) for c in chunks]
            self._comm.allreduce_wire(
                bufs, [str(c.orig) for c in chunks], op="sum"
            ).add_done_callback(on_bucket(chunks, time.perf_counter()))
        return self.wrap_future(agg, default=tree)

    def _set_wire_tag(self) -> None:
        """Per-op preamble facts of the ring (the JAX package's values for
        a sync-f32 step): payload kind ``step``, unweighted fold."""
        setter = getattr(self._comm, "set_wire_tag", None)
        if setter is not None:
            setter("step")
        wsetter = getattr(self._comm, "set_wire_weight", None)
        if wsetter is not None:
            wsetter(-1)

    def _get_schedule(self, treedef: Any, leaves: list
                      ) -> "_AllreduceSchedule":
        metas = tuple((tuple(leaf.shape), str(_np_dtype(leaf)))
                      for leaf in leaves)
        key = (treedef, metas, self._bucket_bytes)
        sched = self._sched_cache.get(key)
        if sched is None:
            if len(self._sched_cache) >= 8:
                self._sched_cache.clear()
                self._pinned.clear()
            sched = _derive_schedule(metas, self._bucket_bytes)
            self._sched_cache[key] = sched
        return sched

    def _stage_all(self, sched: "_AllreduceSchedule", leaves: list
                   ) -> list:
        """Stage 1: pack every bucket's device leaves (one ``torch.cat``
        per chunk) and start each packed buffer's copy into its pinned
        host buffer without blocking. Host leaves pack on the host."""
        t0 = time.perf_counter()
        staged = []
        with self._tracer.span("fetch_dispatch", buckets=len(sched.chunks)):
            for b, chunks in enumerate(sched.chunks):
                recs = []
                for j, c in enumerate(chunks):
                    ls = [leaves[i] for i in c.idx]
                    dev = (ls and all(isinstance(x, torch.Tensor)
                                      and x.is_cuda for x in ls))
                    if not dev:
                        recs.append((c, _host_pack(ls, c.orig), None, None))
                        continue
                    with torch.no_grad():
                        packed = torch.cat([x.detach().reshape(-1)
                                            for x in ls])
                    key = (sched.fingerprint, b, j)
                    host = self._pinned.get(key)
                    if host is None or host.numel() != c.total:
                        host = torch.empty(c.total, dtype=packed.dtype,
                                           pin_memory=True)
                        self._pinned[key] = host
                    host.copy_(packed, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    recs.append((c, host, packed, done))
                staged.append(recs)
        ms = (time.perf_counter() - t0) * 1e3
        self._record(allreduce_fetch_dispatch_ms_total=ms,
                     allreduce_fetch_ms_total=ms)
        return staged

    def _wait_bucket(self, recs: list, bucket: int) -> list:
        """Stage 1b: block until this bucket's host copies landed; return
        the ring buffers (numpy views of the pinned memory)."""
        t0 = time.perf_counter()
        bufs = []
        d2h = 0
        with self._tracer.span("fetch_wait", bucket=bucket):
            for c, host, packed, done in recs:
                if done is None:
                    bufs.append(host)
                    continue
                done.synchronize()
                buf = host.numpy()
                d2h += buf.nbytes
                bufs.append(buf)
        ms = (time.perf_counter() - t0) * 1e3
        self._record(allreduce_fetch_wait_ms_total=ms,
                     allreduce_fetch_ms_total=ms,
                     allreduce_d2h_wire_bytes_total=float(d2h))
        return bufs

    def prepare_commit(self) -> None:
        """Drain this step's in-flight work and apply a staged heal."""
        with self._tracer.span("drain", pending=len(self._pending_work)):
            if self._quorum_future is not None:
                self.wait_quorum()
            for work in self._pending_work:
                work.result()  # errors already swallowed into defaults
            self._pending_work = []
            if self._healing and self._pending_state_dict is not None:
                self._apply_pending_state_dict()

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

    def wrap_future(self, fut: Future, default: Any = None) -> Future:
        """Swallow ``fut``'s error into ``default`` and latch it; track the
        future for the commit drain."""
        out: Future = Future()
        self._record(allreduce_inflight=1)

        def relay(f: Future) -> None:
            self._record(allreduce_inflight=-1)
            e = f.exception()
            if e is None:
                out.set_result(f.result())
            else:
                self.report_error(e)
                out.set_result(default)

        fut.add_done_callback(relay)
        self._pending_work.append(out)
        return out

    # ---------------------------------------------------------------- commit

    def should_commit(self, timeout_ms: Optional[int] = None) -> bool:
        """Distributed commit gate: drain in-flight collectives, apply a
        staged heal on this thread, then vote. The step commits iff every
        rank of every participating group succeeded and the quorum was
        large enough."""
        self.prepare_commit()
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
        # Shut the heal window before the caller mutates state.
        self._ckpt_server.disallow_checkpoint()
        self._should_step = decision
        return decision

    # ---------------------------------------------------------------- errors

    def report_error(self, e: Exception) -> None:
        """Latch a step-local error; the step abstains from committing. A
        :class:`CommunicatorError` also poisons the communicator, so the
        next quorum round rebuilds the ring."""
        if isinstance(e, CommunicatorError):
            self._comm_poisoned = True
        if self._errored is None:
            self._errored = e

    def errored(self) -> Optional[Exception]:
        return self._errored

    # --------------------------------------------------------------- metrics

    def _record(self, **deltas: float) -> None:
        with self._metrics_lock:
            for key, delta in deltas.items():
                self._metrics[key] += delta

    def metrics(self) -> Dict[str, float]:
        """Counters and cumulative stage timings (ms) of this manager."""
        with self._metrics_lock:
            out = dict(self._metrics)
        out["allreduce_ring_wire_bytes_total"] = float(
            getattr(self._comm, "ring_bytes_total", lambda: 0.0)())
        return out

    # ----------------------------------------------------------- state dicts

    def _manager_state_dict(self) -> Dict[str, Any]:
        return {"user": self._user_state_dict(), "torchft": self.state_dict()}

    def state_dict(self) -> Dict[str, int]:
        """Manager metadata that rides along with user checkpoints."""
        return {"step": self._step,
                "batches_committed": self._batches_committed}

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        with self._metrics_lock:
            self._step = int(state_dict["step"])
            self._batches_committed = int(state_dict["batches_committed"])

    # ------------------------------------------------------------- accessors

    def num_participants(self) -> int:
        return self._participating_world_size

    def is_participating(self) -> bool:
        """False while healing (and so not at max_step)."""
        return self._participating_rank is not None and not self._healing

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
        self._ckpt_server.shutdown()
        self._executor.shutdown(wait=False, cancel_futures=True)
        # A queued put must still run: it resolves the aggregate future.
        self._put_executor.shutdown(wait=False)
        self._comm.shutdown()
        if self._manager_server is not None:
            self._manager_server.shutdown()
        if self._store_server is not None:
            self._store_server.shutdown()


# --------------------------------------------------------------- schedule


_TORCH_TO_NP = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64, torch.uint8: np.uint8,
    torch.bool: np.bool_,
}


def _np_dtype(leaf: Any) -> np.dtype:
    """numpy dtype a leaf crosses the ring in. bfloat16 leaves need the
    bf16 wire, which is not ported."""
    if isinstance(leaf, torch.Tensor):
        try:
            return np.dtype(_TORCH_TO_NP[leaf.dtype])
        except KeyError:
            raise TypeError(f"allreduce of {leaf.dtype} leaves is not "
                            "ported (exact f32/int wire only)") from None
    return np.asarray(leaf).dtype


class _ChunkPlan:
    """Geometry of one packed ring chunk: the leaves (by flat index) that
    concatenate into one contiguous 1-D buffer of one dtype."""

    __slots__ = ("orig", "idx", "sizes", "shapes", "total")

    def __init__(self, orig: np.dtype) -> None:
        self.orig = orig
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


def _derive_schedule(metas: tuple, bucket_bytes: int) -> _AllreduceSchedule:
    """Bucket + chunk schedule from per-leaf (shape, dtype) metadata only,
    as the JAX package derives it with no wire dtype: participants,
    healers and spares must produce identical geometry or the ring wedges.
    Buckets close once they reach ``bucket_bytes``; within a bucket,
    leaves group into one chunk per dtype in first-occurrence order."""
    adv = [int(np.prod(shape) or 1) * np.dtype(dt).itemsize
           for shape, dt in metas]
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
        by_dtype: Dict[str, _ChunkPlan] = {}
        cs: list = []
        for i in idx:
            shape, dt = metas[i]
            c = by_dtype.get(dt)
            if c is None:
                c = by_dtype[dt] = _ChunkPlan(np.dtype(dt))
                cs.append(c)
            c.idx.append(i)
            c.sizes.append(int(np.prod(shape)))
            c.shapes.append(tuple(shape))
        for c in cs:
            c.total = int(sum(c.sizes))
        chunks.append(cs)
    fingerprint = "wire-v2|" + "|".join(
        ";".join(f"{c.orig}:{c.orig}:{','.join(map(str, c.sizes))}"
                 for c in cs)
        for cs in chunks)
    return _AllreduceSchedule(buckets, chunks, fingerprint)


def _host_pack(leaves: list, dtype: np.dtype) -> np.ndarray:
    """One fresh contiguous host buffer of host leaves (CPU tensors or
    numpy) — the ring reduces it in place."""
    parts = [np.ravel(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x)) for x in leaves]
    return np.concatenate(parts).astype(dtype, copy=False) if parts \
        else np.empty(0, dtype)


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
            flat = torch.from_numpy(arr).to(ref.device)
            parts = torch.split(flat, c.sizes)
        else:
            parts = np.split(arr, np.cumsum(c.sizes)[:-1])
        for i, shape, part in zip(c.idx, c.shapes, parts):
            scaled[i] = part.reshape(shape)
    return scaled


def _instant(value: Any) -> Future:
    f: Future = Future()
    f.set_result(value)
    return f
