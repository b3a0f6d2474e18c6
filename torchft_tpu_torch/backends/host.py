"""Host-mediated TCP communicator: the cross-replica-group collective backend.

This is the Gloo-role backend of the framework (reference
``ProcessGroupGloo``, torchft/process_group.py:246-257):
rank-``r`` hosts of every replica group form a TCP ring over DCN and run
bandwidth-optimal ring collectives on host numpy buffers. It is
reconfigure-friendly by construction — sockets are rebuilt per
``configure()`` from a store rendezvous namespaced by quorum id, and closing
them aborts in-flight work immediately (no wedged NCCL-style aborts, the
problem that forced the reference into subprocess isolation,
``process_group.py:511-741``).

Design notes:
- One background op thread per communicator: collectives are issued in
  program order on every rank (a requirement shared with every collective
  library), run asynchronously, and resolve ``Future``s.
- Leaves are concatenated per dtype into single ring buffers, so per-step
  cost is O(bytes) with one ring round-trip per dtype, not per leaf.
- A fresh listener per configure + per-quorum store prefixes make stale
  peers from an old quorum fail fast instead of cross-talking.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchft_tpu_torch import chaos, transport
from torchft_tpu_torch._native import StoreClient
from torchft_tpu_torch.communicator import (BF16, Communicator,
                                            CommunicatorError, Int8Wire,
                                            bf16_to_f32, dtype_name,
                                            f32_to_bf16, fold_into,
                                            host_dtype, shard_bounds,
                                            to_dtype)
from torchft_tpu_torch.retry import RetryPolicy, RetryStats, call_with_retry
from torchft_tpu_torch.serialization import load_pytree, save_pytree
from torchft_tpu_torch.tracing import maybe_span
from torchft_tpu_torch.utils import (advertise_host, tree_flatten,
                                     tree_unflatten)

logger: logging.Logger = logging.getLogger(__name__)


def _send_all(sock: socket.socket, data: bytes | memoryview) -> None:
    sock.sendall(data)
    # Ring-class byte accounting on the shared transport substrate:
    # RING never rides HTTP, so its QoS slice is counted here at the
    # one send site every ring/star byte passes through.
    transport.note_ring_bytes(len(data))


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return buf


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill a writable byte view from the socket (zero-copy receive)."""
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise CommunicatorError("peer closed connection")
        got += r


# Pipeline segment for receive+reduce overlap. Large enough that the numpy
# add amortizes its dispatch, small enough that the first add starts long
# before the full chunk has crossed the wire; a power of two so every
# segment boundary is element-aligned for any power-of-two itemsize.
_SEG_BYTES = 1 << 18  # 256 KB


class _StoreLookupError(RuntimeError):
    """Peer-address lookup failed during a ring/star rendezvous.
    Deliberately NOT retried by the outer dial loop: the StoreClient
    already applied its own retry policy (and chaos-injected store
    faults surface type-unchanged as ConnectionError after it gives
    up), so outer retries would compound the layers into
    max_attempts^2 worst-case stalls on the quorum thread."""


def _dial_transient(e: BaseException) -> bool:
    """Outer dial retries cover the socket dial + handshake only —
    OSError spans the whole dial-failure family (refused, reset, timed
    out, no-route-to-host, DNS via socket.gaierror), and
    CommunicatorError covers the handshake (short read / stale-acceptor
    ACK mismatch). Never the store lookup (see _StoreLookupError, a
    plain RuntimeError)."""
    return isinstance(e, (OSError, CommunicatorError))


class _HierTopo:
    """One configure epoch's resolved two-level topology
    (docs/design/hier_transport.md). ``hosts`` is the canonical host
    map — member-rank lists sorted within each host, hosts ordered by
    their min rank — identical on every rank (it is derived from the
    same store keys), so leader election (``hosts[i][0]``) and bundle
    geometry need no extra coordination. Leaders hold the cross-host
    ring (a :class:`_Ring`) plus one accepted socket per local member;
    members hold a single ``up_sock`` to their leader."""

    __slots__ = ("hosts", "rank", "my_host", "members", "leader",
                 "is_leader", "leader_ring", "member_socks", "up_sock",
                 "listener")

    def __init__(self, hosts: List[List[int]], rank: int,
                 leader_ring: Optional[_Ring] = None,
                 member_socks: Optional[Dict[int, socket.socket]] = None,
                 up_sock: Optional[socket.socket] = None,
                 listener: Optional[socket.socket] = None) -> None:
        self.hosts = hosts
        self.rank = rank
        self.my_host = next(i for i, ms in enumerate(hosts)
                            if rank in ms)
        self.members = hosts[self.my_host]
        self.leader = self.members[0]
        self.is_leader = rank == self.leader
        self.leader_ring = leader_ring
        self.member_socks = member_socks or {}
        self.up_sock = up_sock
        self.listener = listener

    def close(self) -> None:
        socks = list(self.member_socks.values())
        if self.up_sock is not None:
            socks.append(self.up_sock)
        if self.listener is not None:
            socks.append(self.listener)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self.leader_ring is not None:
            self.leader_ring.close()


def _as_bytes(arr: np.ndarray) -> memoryview:
    """Writable byte view of a contiguous array. Routed through a uint8
    view because numpy's buffer protocol rejects custom dtypes (ml_dtypes
    bfloat16 — exactly the wire dtype this transport exists to carry)."""
    return memoryview(arr.view(np.uint8)).cast("B")


class _Ring:
    """The per-epoch socket pair (next/prev neighbors on the ring).

    A persistent sender thread services all outbound transfers (one thread
    spawn per *configure*, not per exchange), so each ring step runs full
    duplex: the send streams to the next neighbor while this thread
    receives from the previous one.
    """

    def __init__(self, next_sock: socket.socket, prev_sock: socket.socket,
                 listener: socket.socket):
        self.next_sock = next_sock
        self.prev_sock = prev_sock
        self.listener = listener
        self._send_q: "queue.Queue[Optional[Tuple[Any, Future]]]" = \
            queue.Queue()
        self._sender = threading.Thread(target=self._send_loop, daemon=True,
                                        name="ring-sender")
        self._sender.start()

    def _send_loop(self) -> None:
        while True:
            item = self._send_q.get()
            if item is None:
                return
            buf, done = item
            try:
                _send_all(self.next_sock, buf)
                done.set_result(None)
            except Exception as e:  # noqa: BLE001
                done.set_exception(
                    CommunicatorError(f"ring send failed: {e}"))

    def send_async(self, buf) -> Future:
        """Queue a buffer for the sender thread; resolve when fully sent.
        The caller must not mutate ``buf`` until the future resolves."""
        done: Future = Future()
        self._send_q.put((buf, done))
        return done

    def exchange(self, send_buf, recv_nbytes: int) -> bytearray:
        """Full-duplex: send to next while receiving from prev."""
        fut = self.send_async(send_buf)
        out = _recv_exact(self.prev_sock, recv_nbytes)
        fut.result()
        return out

    def close(self) -> None:
        self._send_q.put(None)
        for s in (self.next_sock, self.prev_sock, self.listener):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class HostCommunicator(Communicator):
    """``retry_policy`` governs the transient-error retries of the ring
    (re)connect during :meth:`configure` and rides into the store client
    used for rendezvous; a fresh listener is already published per
    epoch, so retrying the dial is idempotent. The ring's data sockets
    are chaos-wrappable (:func:`torchft_tpu.chaos.wrap_socket`, endpoint
    ``ring``) so soak runs inject resets/short-writes into live
    collectives."""

    def __init__(self, timeout_sec: float = 60.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_stats: Optional[RetryStats] = None,
                 host_id: Optional[str] = None,
                 hier: Optional[bool] = None) -> None:
        self._timeout = timeout_sec
        self._retry_policy = (retry_policy if retry_policy is not None
                              else RetryPolicy())
        self._retry_stats = retry_stats
        # Topology-aware hierarchical transport
        # (docs/design/hier_transport.md): each rank advertises a host
        # id at rendezvous; when >= 2 hosts exist and any host holds
        # >= 2 co-located ranks, wire ops route over a two-level ring
        # (intra-host star to an elected leader + a cross-host leader
        # ring) instead of the flat ring. ``host_id`` overrides the
        # advertised id (benches/tests simulating hosts in-process;
        # default env TORCHFT_HOST_ID, else this machine's advertised
        # hostname). ``hier`` force-enables/disables (default env
        # TORCHFT_HIER, on); the flag rides the allreduce-config
        # fingerprint so mixed flat/hier launches die at rendezvous.
        self._host_id = host_id
        self._hier_opt = hier
        self._hier: Optional[_HierTopo] = None
        # Send-site byte counters of the two hierarchical legs: intra =
        # loopback star traffic (member->leader + leader->members),
        # leader = the cross-host leader-ring slice of _ring_bytes —
        # the bytes the hierarchy exists to shrink.
        self._hier_intra_bytes = 0.0
        self._hier_leader_bytes = 0.0

        self._rank = 0
        self._world = 1
        self._ring: Optional[_Ring] = None
        # Allreduce payload bytes this rank has sent over the ring
        # (exact + wire paths). Written on the single op-worker thread
        # only; read via ring_bytes_total() for Manager.metrics().
        self._ring_bytes = 0.0
        # The int8-rung slice of _ring_bytes (payload + segment
        # headers), so the ~4x saving of the int8+EF wire is observable
        # on its own (Manager surfaces it as
        # allreduce_int8_ring_bytes_total).
        self._ring_bytes_int8 = 0.0
        # Seconds the op worker spent in the allreduce rings' host fold
        # (widen, dequantize, add) and blocked on their sockets (receive,
        # drain of the outbound chunk), split so the ring's time can be
        # told apart (Manager: allreduce_ring_{fold,transfer}_ms_total).
        self._ring_fold_s = 0.0
        self._ring_transfer_s = 0.0
        self._epoch = 0
        self._lock = threading.Lock()
        self._ops: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="host-comm")
        self._worker.start()
        self._shutdown = False

    def set_retry_policy(self, policy, stats=None) -> None:
        """Adopt the owning Manager's policy + shared stats (forwarded by
        Manager at construction) so ring-dial retries follow the one
        configured policy and surface in ``Manager.metrics()``."""
        self._retry_policy = policy
        self._retry_stats = stats

    # ------------------------------------------------------------ configure

    def _hier_flag(self) -> bool:
        """Static hierarchical-transport opt-in: the constructor arg
        wins; default env ``TORCHFT_HIER`` (on). A True flag only ARMS
        the detection — the two-level ring is built when the advertised
        host map actually shows >= 2 hosts with co-located ranks, so
        single-host rigs (every local test/bench) stay flat."""
        if self._hier_opt is not None:
            return bool(self._hier_opt)
        return os.environ.get("TORCHFT_HIER", "1").strip().lower() \
            not in ("0", "false")

    def _effective_host_id(self) -> str:
        return (self._host_id
                or os.environ.get("TORCHFT_HOST_ID", "").strip()
                or advertise_host())

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        """Rebuild the ring(s) for a new (rank, world_size).

        ``store_addr`` is ``"host:port/prefix..."``; each rank publishes its
        fresh listener under ``{prefix}/{rank}`` and dials its successor.
        In-flight collectives from the previous epoch are aborted by closing
        their sockets (reference abort-then-rebuild,
        ``process_group.py:203-218``).

        Each rank also advertises its host id under ``{prefix}/host/...``;
        when the resulting map shows co-located ranks across >= 2 hosts
        (and :meth:`_hier_flag` is armed), a second, two-level transport
        is built for the wire ops (docs/design/hier_transport.md): an
        intra-host star to the host's min-rank leader plus a cross-host
        ring among leaders — rebuilt per epoch exactly like the flat
        ring, so leader death recovers through the same
        poison-and-re-rendezvous path as any ring reset."""
        with self._lock:
            old, self._ring = self._ring, None
            old_hier, self._hier = self._hier, None
            self._epoch += 1
            epoch = self._epoch
        if old is not None:
            old.close()
        if old_hier is not None:
            old_hier.close()
        # Fail anything still queued from the old epoch.
        self._drain_queue("aborted by reconfigure")

        self._rank = rank
        self._world = world_size
        if world_size == 1:
            return

        host_port, _, prefix = store_addr.partition("/")
        store = StoreClient(host_port, connect_timeout_ms=int(
            self._timeout * 1000), retry_policy=self._retry_policy,
            retry_stats=self._retry_stats)

        # Allreduce-config skew check (set by Manager before configure):
        # every rank must derive the identical bucket schedule from
        # (allreduce_bucket_bytes, allreduce_wire_dtype) or the ring wedges
        # on mismatched collective counts with no diagnostic. Publish this
        # rank's fingerprint and compare against rank 0's over the store
        # we're already connected to — a mismatch is a launch bug, so fail
        # loudly now instead of degenerating into timeout/abort loops.
        # The hier flag is appended here (not by the Manager, which is
        # topology-agnostic): a flat rank and a hier rank would run
        # DIFFERENT transports for the same op and wedge mid-collective.
        fp = getattr(self, "allreduce_config_fingerprint", None)
        if fp is not None:
            fp = f"{fp};hier={int(self._hier_flag())}"
            tmo = int(self._timeout * 1000)
            store.set(f"{prefix}/arcfg/{rank}", fp.encode())

            def skew(who: str, other: str) -> RuntimeError:
                return RuntimeError(
                    f"allreduce config skew: this group has [{fp}] but "
                    f"{who} announced [{other}]. All groups must be "
                    "launched with identical allreduce_bucket_bytes / "
                    "allreduce_wire_dtype or every bucketed ring "
                    "collective will wedge."
                )

            if rank == 0:
                # Rank 0 IS the anchor, so it must verify the others —
                # otherwise a skewed launch gives the clear error only on
                # ranks != 0 while rank 0 (the logs operators watch)
                # degenerates into a generic rendezvous timeout. Peers
                # publish before reading the anchor, so these keys arrive
                # no later than the listener addresses the ring build
                # waits on anyway.
                for r in range(1, world_size):
                    other = store.get(f"{prefix}/arcfg/{r}",
                                      timeout_ms=tmo).decode()
                    if other != fp:
                        raise skew(f"replica rank {r}", other)
            else:
                anchor = store.get(f"{prefix}/arcfg/0",
                                   timeout_ms=tmo).decode()
                if anchor != fp:
                    raise skew("replica rank 0", anchor)

        # Advertise this rank's host id BEFORE the flat ring forms: the
        # flat rendezvous is a barrier (every rank published its keys by
        # the time it completes), so the host map is fully readable by
        # the hier build that follows it.
        if self._hier_flag():
            store.set(f"{prefix}/host/{rank}",
                      self._effective_host_id().encode())

        next_sock, prev_sock, listener = self._ring_rendezvous(
            store, prefix, "", rank, world_size)

        topo: Optional[_HierTopo] = None
        if self._hier_flag():
            try:
                topo = self._build_hier(store, prefix, rank, world_size)
            except BaseException:
                next_sock.close()
                prev_sock.close()
                listener.close()
                raise

        with self._lock:
            if self._epoch != epoch:  # raced with another configure
                next_sock.close()
                prev_sock.close()
                listener.close()
                if topo is not None:
                    topo.close()
                return
            # Chaos wrapping AFTER the epoch handshake: rendezvous stays
            # clean (a fault there is just a failed configure), the data
            # plane — every ring collective byte — is injectable.
            self._ring = _Ring(
                chaos.wrap_socket(next_sock, "ring"),
                chaos.wrap_socket(prev_sock, "ring"),
                listener)
            self._hier = topo
        logger.info("host communicator configured: rank=%d world=%d "
                    "topology=%s (%s)", rank, world_size,
                    self.ring_topology(), prefix)

    def _ring_rendezvous(self, store: StoreClient, prefix: str, ns: str,
                         pos: int, ring_world: int
                         ) -> Tuple[socket.socket, socket.socket,
                                    socket.socket]:
        """One ring's store rendezvous among ``ring_world`` members
        ordered by ``pos`` under key namespace ``{prefix}{ns}``: publish
        a fresh listener at ``{prefix}{ns}/{pos}``, dial the successor
        (with address re-reads per attempt), accept the predecessor —
        the flat ring's battle-tested dial/accept protocol, factored out
        so the hierarchical leader ring builds through the IDENTICAL
        code path. Returns raw (not chaos-wrapped) ``(next, prev,
        listener)`` sockets."""
        hs_key = epoch_key(prefix + ns)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", 0))
        listener.listen(4)
        listener.settimeout(self._timeout)
        my_addr = f"{advertise_host()}:{listener.getsockname()[1]}"
        store.set(f"{prefix}{ns}/{pos}", my_addr.encode())

        next_pos = (pos + 1) % ring_world

        # Retried dial, re-reading the successor's address each attempt:
        # besides riding out a transient reset mid-handshake, this heals
        # the stale-address cases in recovery rendezvous — a peer's
        # earlier configure of the SAME prefix may have left a dead (or
        # not-yet-superseded live) listener's address under the key its
        # fresh attempt then overwrites. A refused dial re-reads instead
        # of redialing the corpse; the handshake ACK below catches the
        # nastier still-open-but-abandoned listener, whose accept queue
        # swallows the dial silently.
        def dial() -> socket.socket:
            try:
                next_addr = store.get(
                    f"{prefix}{ns}/{next_pos}",
                    timeout_ms=int(self._timeout * 1000)).decode()
            except Exception as e:  # KeyboardInterrupt must propagate
                raise _StoreLookupError(
                    f"successor address lookup failed: {e}") from e
            nhost, _, nport = next_addr.rpartition(":")
            s = socket.create_connection((nhost, int(nport)),
                                         timeout=self._timeout)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                transport.mark_socket(s, transport.QoS.RING)
                s.settimeout(self._timeout)
                # Identify ourselves so the acceptor can reject stale
                # dialers...
                _send_all(s, struct.pack("<qq", hs_key, pos))
                # ...and require its ACK so WE reject stale acceptors: a
                # connect into the accept backlog of an abandoned
                # listener from an earlier same-prefix attempt succeeds
                # silently and would wedge the ring's first collective;
                # only a peer actively accepting this epoch echoes the
                # key (its eventual listener close RSTs us instead,
                # failing this read and triggering a re-read-and-redial).
                ack = struct.unpack("<q", bytes(_recv_exact(s, 8)))[0]
                if ack != hs_key:
                    raise CommunicatorError(
                        "ring handshake ack mismatch (stale peer?)")
                return s
            except BaseException:
                s.close()
                raise

        # The accept loop runs CONCURRENTLY with the dial: each rank's
        # dial blocks on its successor's ACK, and that ACK is sent by the
        # successor's accept loop — serializing accept after dial would
        # deadlock the whole ring on its own circular wait. The loop is
        # resilient per candidate (a hello reset mid-handshake closes
        # that candidate and keeps accepting — it is exactly the
        # transient the dialer's retry redials through) and keeps
        # serving REDIALS until the rendezvous finalizes: a dialer whose
        # ACK was lost retries, and the newest validated candidate
        # supersedes the previous one (whose far end gave up on it).
        accept_box: dict = {}
        box_lock = threading.Lock()
        have_prev = threading.Event()
        accept_done = threading.Event()

        def accept_loop() -> None:
            while not accept_done.is_set():
                try:
                    cand, _ = listener.accept()
                except OSError:
                    continue  # listener timeout/close: re-check done
                old = None
                try:
                    cand.settimeout(self._timeout)
                    cand.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    transport.mark_socket(cand, transport.QoS.RING)
                    key, peer_pos = struct.unpack(
                        "<qq", bytes(_recv_exact(cand, 16)))
                    if key != hs_key or peer_pos != (
                            pos - 1) % ring_world:
                        cand.close()
                        continue
                    # Publish under the lock BEFORE ACKing: ACK-first
                    # would let a late redial be ACKed (dial "succeeds")
                    # and then closed when the done-check fires — a dead
                    # ring link minted at the exact window the ACK exists
                    # to close.
                    with box_lock:
                        if accept_done.is_set():
                            cand.close()
                            return
                        old = accept_box.pop("sock", None)
                        accept_box["sock"] = cand
                    # ACK: prove to the dialer it reached a live acceptor
                    # of THIS epoch, not an abandoned listener's backlog.
                    try:
                        _send_all(cand, struct.pack("<q", key))
                    except Exception:  # noqa: BLE001 — dialer gone
                        with box_lock:
                            mine = accept_box.get("sock") is cand
                            if mine:
                                accept_box.pop("sock")
                        # Only close what the rendezvous hasn't already
                        # claimed; if finalize raced the pop, the dead
                        # link surfaces on the first collective and the
                        # poison/recovery path repairs it.
                        if mine:
                            cand.close()
                        continue
                    have_prev.set()
                except Exception:  # noqa: BLE001 — per-candidate only
                    try:
                        cand.close()
                    except OSError:
                        pass
                finally:
                    if old is not None:
                        old.close()

        acceptor = threading.Thread(target=accept_loop, daemon=True,
                                    name="ring-accept")
        acceptor.start()
        next_sock = None
        try:
            next_sock = call_with_retry(
                dial, self._retry_policy, classify=_dial_transient,
                stats=self._retry_stats, op="ring.connect")
            have_prev.wait(timeout=self._timeout)
            with box_lock:
                accept_done.set()
                prev_sock = accept_box.pop("sock", None)
            if prev_sock is None:
                raise CommunicatorError(
                    "ring accept failed: predecessor never arrived")
        except BaseException:
            with box_lock:
                accept_done.set()
                stranded = accept_box.pop("sock", None)
            if stranded is not None:
                # Close the already-validated predecessor socket too:
                # leaving it half-open would make the peer's first ring
                # send wedge until its full timeout instead of failing
                # fast on the reset.
                stranded.close()
            if next_sock is not None:
                next_sock.close()
            listener.close()  # unblocks the acceptor thread too
            raise
        return next_sock, prev_sock, listener

    def _build_hier(self, store: StoreClient, prefix: str, rank: int,
                    world: int) -> Optional["_HierTopo"]:
        """Resolve the advertised host map and, when it shows real
        co-location across >= 2 hosts, build the two-level transport:
        members dial their host's min-rank leader (a star — gather +
        broadcast is its natural shape), leaders form a cross-host ring
        through :meth:`_ring_rendezvous` under the ``/hl`` namespace.
        Returns ``None`` (stay flat) when the map shows no co-location
        — and also for a single all-co-located host, where the flat
        ring is already loopback end to end and the hierarchy would
        only add hops."""
        tmo = int(self._timeout * 1000)
        # world sequential store reads on the quorum thread; every key
        # was published before the flat-ring barrier completed, so each
        # is one immediate RTT (~world x store-RTT per reconfigure —
        # linear like the rest of the rendezvous; batch here first if a
        # very-large-world profile ever shows configure store-bound).
        ids = [store.get(f"{prefix}/host/{r}", timeout_ms=tmo).decode()
               for r in range(world)]
        by_host: Dict[str, List[int]] = {}
        for r, h in enumerate(ids):
            by_host.setdefault(h, []).append(r)
        hosts = sorted((sorted(ms) for ms in by_host.values()),
                       key=lambda ms: ms[0])
        if len(hosts) < 2 or max(len(ms) for ms in hosts) < 2:
            return None
        my_host = next(i for i, ms in enumerate(hosts) if rank in ms)
        members = hosts[my_host]
        leader = members[0]
        hs = epoch_key(prefix + "/hh")
        if rank != leader:
            def dial() -> socket.socket:
                try:
                    addr = store.get(f"{prefix}/hh/{leader}",
                                     timeout_ms=tmo).decode()
                except Exception as e:
                    raise _StoreLookupError(
                        f"leader address lookup failed: {e}") from e
                lhost, _, lport = addr.rpartition(":")
                s = socket.create_connection((lhost, int(lport)),
                                             timeout=self._timeout)
                try:
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                 1)
                    transport.mark_socket(s, transport.QoS.RING)
                    s.settimeout(self._timeout)
                    _send_all(s, struct.pack("<qq", hs, rank))
                    ack = struct.unpack(
                        "<q", bytes(_recv_exact(s, 8)))[0]
                    if ack != hs:
                        raise CommunicatorError(
                            "hier star handshake ack mismatch")
                    return s
                except BaseException:
                    s.close()
                    raise

            up = call_with_retry(
                dial, self._retry_policy, classify=_dial_transient,
                stats=self._retry_stats, op="hier.star.connect")
            return _HierTopo(hosts, rank,
                             up_sock=chaos.wrap_socket(up, "ring"))

        # Leader: star listener published FIRST so members can dial (and
        # park in the accept backlog) while the leader ring forms.
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind(("0.0.0.0", 0))
        lst.listen(max(len(members), 1))
        lst.settimeout(min(self._timeout, 1.0))
        store.set(f"{prefix}/hh/{leader}",
                  f"{advertise_host()}:{lst.getsockname()[1]}".encode())
        leader_ring: Optional[_Ring] = None
        member_socks: Dict[int, socket.socket] = {}
        try:
            ln, lp, llst = self._ring_rendezvous(
                store, prefix, "/hl", my_host, len(hosts))
            leader_ring = _Ring(chaos.wrap_socket(ln, "ring"),
                                chaos.wrap_socket(lp, "ring"), llst)
            expected = set(members) - {rank}
            deadline = time.monotonic() + self._timeout
            while expected:
                if time.monotonic() > deadline:
                    raise CommunicatorError(
                        "hier star accept failed: members "
                        f"{sorted(expected)} never arrived")
                try:
                    cand, _ = lst.accept()
                except OSError:
                    continue  # listener timeout: re-check the deadline
                try:
                    cand.settimeout(self._timeout)
                    cand.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    transport.mark_socket(cand, transport.QoS.RING)
                    key, peer = struct.unpack(
                        "<qq", bytes(_recv_exact(cand, 16)))
                    if key != hs or peer not in expected:
                        cand.close()
                        continue
                    _send_all(cand, struct.pack("<q", hs))
                except Exception:  # noqa: BLE001 — per-candidate
                    cand.close()
                    continue
                member_socks[peer] = chaos.wrap_socket(cand, "ring")
                expected.discard(peer)
        except BaseException:
            for s in member_socks.values():
                s.close()
            if leader_ring is not None:
                leader_ring.close()
            lst.close()
            raise
        return _HierTopo(hosts, rank, leader_ring=leader_ring,
                         member_socks=member_socks, listener=lst)

    def _ring_span(self, kind: str) -> Any:
        """A ``ring`` span from the Manager-installed tracer
        (:meth:`Communicator.set_tracer`), or a no-op when none/disabled
        — raw HostCommunicators in tests carry no tracer."""
        return maybe_span(getattr(self, "tracer", None), "ring",
                          kind=kind, world=self._world,
                          rank=self._rank)

    def _drain_queue(self, reason: str) -> None:
        while True:
            try:
                item = self._ops.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[0].set_exception(CommunicatorError(reason))

    # ------------------------------------------------------------ op plumbing

    def _submit(self, kind: str, *args: Any) -> Future:
        fut: Future = Future()
        self._ops.put((fut, self._epoch, kind, args))
        return fut

    def _run(self) -> None:
        while True:
            item = self._ops.get()
            if item is None:
                return
            fut, epoch, kind, args = item
            try:
                with self._lock:
                    ring = self._ring
                    if epoch != self._epoch:
                        raise CommunicatorError("aborted by reconfigure")
                # One `ring` span per op on the comm worker
                # (docs/design/observability.md): send/recv of a whole
                # wire op, queue wait excluded (the Manager's
                # allreduce_ring_ms_total includes it — the two
                # together attribute "slow ring" to wire vs backlog).
                with self._ring_span(kind):
                    if kind == "allreduce":
                        fut.set_result(self._do_allreduce(ring, *args))
                    elif kind == "allreduce_wire":
                        fut.set_result(
                            self._do_allreduce_wire(ring, *args))
                    elif kind == "reduce_scatter_wire":
                        fut.set_result(
                            self._do_reduce_scatter_wire(ring, *args))
                    elif kind == "broadcast":
                        fut.set_result(self._do_broadcast(ring, *args))
                    elif kind == "allgather":
                        fut.set_result(self._do_allgather(ring, *args))
                    else:
                        raise CommunicatorError(f"unknown op {kind}")
            except Exception as e:  # noqa: BLE001
                fut.set_exception(
                    e if isinstance(e, CommunicatorError)
                    else CommunicatorError(str(e)))
            # Unbind this op before blocking on the next: the future's
            # done-callbacks close over the caller's gradient trees (the
            # Manager's pipeline), which would otherwise stay alive on the
            # device until the next op arrives.
            item = fut = args = None

    # ------------------------------------------------------------ collectives

    def allreduce(self, tree: Any, op: str = "sum") -> Future:
        if self._world == 1:
            return self._immediate(tree)
        return self._submit("allreduce", tree, op)

    @staticmethod
    def _local_wire(b: Any, d: np.dtype) -> np.ndarray:
        """World-1 resolution of one wire buffer: dequantize int8,
        cast anything else — sum-over-one is identity either way."""
        if isinstance(b, Int8Wire):
            return b.dequantize(d)
        return to_dtype(b, d, copy=False)

    def allreduce_wire(self, buffers: Sequence[Any],
                       orig_dtypes: Sequence[Any],
                       op: str = "sum") -> Future:
        origs = [host_dtype(d) for d in orig_dtypes]
        if self._world == 1:
            # World-1 weighted average of one contributor is the
            # contributor itself (w*x/w = x), so the unweighted local
            # resolution is correct in both modes.
            return self._immediate([
                self._local_wire(b, d) for b, d in zip(buffers, origs)])
        # The payload-kind tag (set_wire_tag) and the fold weight
        # (set_wire_weight) are captured HERE, on the caller thread, so
        # each queued op carries the values in force when it was issued.
        return self._submit("allreduce_wire", list(buffers), origs, op,
                            getattr(self, "wire_tag", ""),
                            int(getattr(self, "wire_weight", -1)))

    def reduce_scatter_wire(self, buffers: Sequence[Any],
                            orig_dtypes: Sequence[Any],
                            op: str = "sum") -> Future:
        origs = [host_dtype(d) for d in orig_dtypes]
        if self._world == 1:
            # World-1 stripe is the whole buffer.
            return self._immediate([
                self._local_wire(b, d) for b, d in zip(buffers, origs)])
        return self._submit("reduce_scatter_wire", list(buffers), origs,
                            op, getattr(self, "wire_tag", ""),
                            int(getattr(self, "wire_weight", -1)))

    def broadcast(self, tree: Any, root: int = 0) -> Future:
        if self._world == 1:
            return self._immediate(tree)
        return self._submit("broadcast", tree, root)

    def allgather(self, tree: Any) -> Future:
        if self._world == 1:
            return self._immediate([tree])
        return self._submit("allgather", tree)

    def _immediate(self, value: Any) -> Future:
        f: Future = Future()
        f.set_result(value)
        return f

    def _do_allreduce(self, ring: Optional[_Ring], tree: Any, op: str) -> Any:
        if ring is None:
            raise CommunicatorError("communicator not configured")
        leaves, treedef = tree_flatten(tree)
        arrs = [np.asarray(leaf) for leaf in leaves]
        # Group leaves by dtype into contiguous ring buffers.
        by_dtype: dict = {}
        for i, a in enumerate(arrs):
            by_dtype.setdefault(a.dtype.str, []).append(i)
        out: List[Optional[np.ndarray]] = [None] * len(arrs)
        for dtype_str, idxs in by_dtype.items():
            if (len(idxs) == 1 and arrs[idxs[0]].ndim == 1
                    and arrs[idxs[0]].flags.c_contiguous
                    and arrs[idxs[0]].flags.writeable):
                # A single already-contiguous 1-D leaf IS the ring
                # buffer: skip the redundant np.concatenate memcpy (the
                # shape every packed-chunk caller hits) and reduce in
                # place — allowed by the Communicator.allreduce
                # ownership contract (such leaves are consumed).
                flat = arrs[idxs[0]]
            else:
                flat = np.concatenate(
                    [arrs[i].reshape(-1) for i in idxs])
            reduced = self._ring_allreduce_buffer(ring, flat)
            if op == "mean":
                _mean_in_place(reduced, self._world)
            pos = 0
            for i in idxs:
                n = arrs[i].size
                out[i] = reduced[pos:pos + n].reshape(arrs[i].shape)
                pos += n
        return tree_unflatten(treedef, out)

    def _ring_allreduce_buffer(self, ring: _Ring,
                               flat: np.ndarray) -> np.ndarray:
        """Bandwidth-optimal ring allreduce: reduce-scatter + allgather.

        Each ring step is fully pipelined: the outbound chunk streams from
        the persistent sender thread while this thread receives the inbound
        chunk in ``_SEG_BYTES`` segments, folding each segment into the
        accumulator as soon as it lands — the reduce overlaps the wire
        (and, via kernel socket buffering, the wire keeps flowing during
        the add) instead of waiting for the whole chunk. The allgather
        phase needs no reduce, so segments are received zero-copy straight
        into the accumulator's memory.
        """
        n = self._world
        rank = self._rank
        acc, chunk_bytes = self._ring_reduce_scatter_phase(ring, flat)
        for step in range(n - 1):
            send_view = chunk_bytes(rank + 1 - step)
            self._ring_bytes += len(send_view)
            fut = ring.send_async(send_view)
            self._recv(ring, chunk_bytes(rank - step))
            self._sent(fut)
        return acc

    def _ring_reduce_scatter_phase(self, ring: _Ring, flat: np.ndarray):
        """The reduce-scatter half of the exact ring, factored out so the
        reduce-scatter collective can reuse it UNCHANGED — identical fold
        order is what makes the reduce-scatter path's stripes bitwise
        equal to the allreduce path's. After the phase, this rank's chunk
        ``(rank + 1) % world`` of ``acc`` holds its fully-reduced values.
        Returns ``(acc, chunk_bytes)`` where ``chunk_bytes(i)`` is the
        byte view of canonical chunk ``i % world``."""
        n = self._world
        rank = self._rank
        # Reduces in place: `flat` is either a fresh per-dtype concat or
        # a caller-owned packed chunk (consumed per the allreduce
        # ownership contract), so no defensive copy on the hot path.
        acc = flat if flat.flags.c_contiguous else np.ascontiguousarray(flat)
        acc_bytes = _as_bytes(acc)
        bounds = shard_bounds(acc.size, n)
        itemsize = acc.itemsize

        def chunk(i: int) -> np.ndarray:
            i %= n
            return acc[bounds[i]:bounds[i + 1]]

        def chunk_bytes(i: int) -> memoryview:
            i %= n
            return acc_bytes[bounds[i] * itemsize:bounds[i + 1] * itemsize]

        # Scratch for inbound reduce segments, reused across steps.
        scratch = bytearray(_SEG_BYTES)
        scratch_view = memoryview(scratch)

        for step in range(n - 1):
            # Chunks of the contiguous 1-D accumulator are contiguous
            # views: the sender streams directly from acc (the chunk being
            # sent is never the one being reduced this step).
            send_view = chunk_bytes(rank - step)
            self._ring_bytes += len(send_view)
            fut = ring.send_async(send_view)
            recv_c = chunk(rank - step - 1)
            nbytes = recv_c.size * itemsize
            off = 0
            while off < nbytes:
                k = min(_SEG_BYTES, nbytes - off)
                seg = scratch_view[:k]
                self._recv(ring, seg)
                lo = off // itemsize
                t0 = time.perf_counter()
                fold_into(recv_c[lo:lo + k // itemsize],
                          np.frombuffer(seg, dtype=acc.dtype))
                self._ring_fold_s += time.perf_counter() - t0
                off += k
            self._sent(fut)
        return acc, chunk_bytes

    def _ring_reduce_scatter_buffer(self, ring: _Ring,
                                    flat: np.ndarray) -> np.ndarray:
        """Exact reduce-scatter: the ring's reduce-scatter phase plus ONE
        ownership-shift hop, so rank ``r`` returns canonical stripe ``r``
        (the :func:`~torchft_tpu.communicator.shard_bounds` segment) —
        bitwise identical to that stripe of the full allreduce. The
        shift hop is the price of that identity: ending the phase on the
        canonical chunk directly would permute each chunk's fold order
        away from the allreduce's. Ring bytes: 1.0·payload per rank
        ((n-1)/n phase + 1/n shift) vs the allreduce's 2(n-1)/n — equal
        at world 2, →half as n grows; the real 1/n win here is fold
        compute and the optimizer stage that follows."""
        n, rank = self._world, self._rank
        acc, chunk_bytes = self._ring_reduce_scatter_phase(ring, flat)
        # After the phase rank r owns chunk (r+1); one hop moves each
        # owned chunk to its canonical rank: prev owns exactly chunk
        # `rank`, so receive it straight into place while streaming our
        # owned chunk to next.
        send_view = chunk_bytes(rank + 1)
        self._ring_bytes += len(send_view)
        fut = ring.send_async(send_view)
        _recv_exact_into(ring.prev_sock, chunk_bytes(rank))
        fut.result()
        bounds = shard_bounds(acc.size, n)
        return np.array(acc[bounds[rank]:bounds[rank + 1]])

    @staticmethod
    def _wire_desc_key(op: str, buffers: List[Any],
                       origs: List[np.dtype], tag: str) -> int:
        """Stable hash of one wire op's full format: op kind, payload
        tag, and every buffer's wire format/size/accumulator dtype —
        the ONE spelling shared by the flat ring's preamble and the
        hierarchical transport's record headers, so the two topologies
        detect exactly the same skew classes."""
        desc = [op, tag]
        for b, orig in zip(buffers, origs):
            # bf16 hashes as "bfloat16" (dtype_name), as the JAX
            # package's ml_dtypes arrays do, so mixed rings agree.
            if isinstance(b, Int8Wire):
                desc.append(f"i8:{b.size}:{b.seg_elems}:{dtype_name(orig)}")
            else:
                a = np.asarray(b)
                desc.append(f"{dtype_name(a.dtype)}:{a.size}:"
                            f"{dtype_name(orig)}")
        return epoch_key("|".join(desc))

    def _wire_preamble(self, ring: _Ring, op: str, buffers: List[Any],
                       origs: List[np.dtype], tag: str = "",
                       weight: int = -1) -> Optional[List[int]]:
        """Per-wire-op format handshake: each rank ring-allgathers a
        24-byte preamble (magic + a hash of the op kind and every
        buffer's wire format/size + this rank's fold weight) and checks
        every peer's format hash against its own.

        This is the skew DETECTOR the adaptive-policy layer relies on
        (docs/design/adaptive_policy.md): policies switch between steps
        without a ring re-rendezvous, so the configure-time fingerprint
        can no longer prove format agreement — and two ranks folding
        mismatched wire formats would not deadlock but silently sum
        garbage (mismatched byte counts parse as data). The preamble
        turns any residual skew — e.g. a policy publication read lost to
        chaos at the exact switch boundary — into a clean
        :class:`CommunicatorError`, which aborts the step via the commit
        vote and re-syncs at the next boundary.

        The weight slot carries the degraded-mode fold weight
        (docs/design/degraded_mode.md): ``-1`` = unweighted (the
        classic uniform fold; returns ``None``), ``>= 0`` = the samples
        this rank contributes this step. Weight VALUES legitimately
        differ across ranks — that is nonuniform capacity — but weight
        MODE may not: one rank folding weighted while a peer folds
        uniform would silently disagree on every collective's values,
        so mode mixing aborts on the FIRST hop exactly like a format
        mismatch (pairwise detection is transitive around a cycle; the
        configure-time ``degraded=`` fingerprint blocks mixed launches
        before a ring even forms). Unweighted ops stop after that one
        hop — the classic preamble cost; weighted ops keep forwarding
        for the remaining world-2 hops so every rank learns every
        rank's weight. Returns the weights in rank order when
        weighted. Cost: 24 bytes + one segment latency per op
        unweighted, 24*(world-1) + (world-1) weighted — excluded from
        the ring byte counters (protocol, not payload)."""
        n, rank = self._world, self._rank
        key = self._wire_desc_key(op, buffers, origs, tag)
        weight = int(weight)

        def skew(gkey: int) -> CommunicatorError:
            return CommunicatorError(
                "wire format skew: a peer announced a different "
                f"wire-op format (got {gkey:#x}, expected {key:#x})"
                " — policy/wire-dtype mismatch across groups; "
                "aborting the collective before folding garbage")

        weights = [0] * n
        weights[rank] = weight
        payload: Any = struct.pack("<qqq", _WIRE_MAGIC, key, weight)
        for step in range(n - 1):
            fut = ring.send_async(payload)
            got = bytes(_recv_exact(ring.prev_sock, 24))
            fut.result()
            magic, gkey, gw = struct.unpack("<qqq", got)
            if magic != _WIRE_MAGIC or gkey != key:
                raise skew(gkey)
            if (gw < 0) != (weight < 0):
                raise CommunicatorError(
                    "wire weight skew: this op mixes weighted and "
                    f"unweighted ranks (mine {weight}, a peer's {gw}) "
                    "— degraded mode (weighted folding) must be "
                    "enabled on EVERY group or none; aborting the "
                    "collective before folding garbage")
            if weight < 0:
                # Unweighted op: one pairwise hop proved format + mode
                # agreement (transitively, around the cycle) — the
                # classic preamble cost, no weight collection needed.
                return None
            weights[(rank - step - 1) % n] = gw
            payload = got  # forward the received record along the ring
        return weights if weight >= 0 else None

    def _do_allreduce_wire(self, ring: Optional[_Ring],
                           buffers: List[Any], origs: List[np.dtype],
                           op: str, tag: str = "",
                           weight: int = -1) -> List[np.ndarray]:
        topo = self._hier
        if topo is not None:
            return self._do_wire_hier(topo, "ar", buffers, origs, op,
                                      tag, weight)
        if ring is None:
            raise CommunicatorError("communicator not configured")
        weights = self._wire_preamble(ring, "ar", buffers, origs, tag,
                                      weight)
        if weights is not None:
            # Degraded-mode weighted fold: resolves to the weighted
            # AVERAGE (normalized by total weight inside the fold — the
            # Manager skips its 1/n), via the canonical-rank-order raw
            # allgather for every chunk kind.
            if op == "mean":
                raise CommunicatorError(
                    "op='mean' is not supported with weighted folding "
                    "(the weighted fold already normalizes)")
            return [
                self._ring_allreduce_int8(ring, buf, orig,
                                          weights=weights)
                if isinstance(buf, Int8Wire)
                else self._ring_allreduce_weighted(ring, buf, orig,
                                                   weights)
                for buf, orig in zip(buffers, origs)]
        out: List[np.ndarray] = []
        for buf, orig in zip(buffers, origs):
            if isinstance(buf, Int8Wire):
                reduced = self._ring_allreduce_int8(ring, buf, orig)
                if op == "mean":
                    reduced /= self._world
                out.append(reduced)
                continue
            a = np.ravel(np.asarray(buf))
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            if a.dtype == orig:
                if not a.flags.writeable:
                    # device_get can hand back a read-only view of the
                    # transfer buffer; the exact ring accumulates in
                    # place, so that one case pays a copy. (The wire
                    # path below only ever READS its buffer.)
                    a = np.array(a)
                # Uncompressed chunk: the standard in-place exact ring.
                reduced = self._ring_allreduce_buffer(ring, a)
            else:
                reduced = self._ring_allreduce_wire(ring, a, orig)
            if op == "mean":
                _mean_in_place(reduced, self._world)
            out.append(reduced)
        return out

    def _ring_allreduce_wire(self, ring: _Ring, wire_buf: np.ndarray,
                             orig: np.dtype) -> np.ndarray:
        """Wire-dtype ring allreduce: narrow bytes on the TCP ring,
        full-precision accumulation.

        Raw (pack-time-quantized) contributions — never partial sums —
        cross the wire, so each rank's contribution is quantized exactly
        once regardless of world size, and every rank folds them into
        its accumulator in canonical rank order, keeping results bitwise
        identical across ranks. The transport is a ring allgather of the
        raw wire buffers: (world-1) * wire bytes sent per rank, vs the
        exact ring's 2*(world-1)/world * orig bytes — exactly half at
        world 2 with a bf16 wire, cheaper through world*wire <= 2*orig.
        Past that crossover raw forwarding would cost MORE than the
        exact ring, so the buffer upcasts locally and takes the standard
        in-place ring instead (numerics unchanged — the one quantization
        already happened at pack; only the byte saving is forfeited).

        At world 2 the inbound contribution is upcast-folded per
        received _SEG_BYTES segment, overlapping the wire with the
        accumulate exactly like the exact ring's reduce-scatter (the
        segment path TORCHFT_CHAOS short-read faults exercise in the
        bench-smoke chaos tier).
        """
        n, rank = self._world, self._rank
        wdt = wire_buf.dtype
        if n * wdt.itemsize > 2 * orig.itemsize:
            t0 = time.perf_counter()
            acc = to_dtype(wire_buf, orig)
            self._ring_fold_s += time.perf_counter() - t0
            return self._ring_allreduce_buffer(ring, acc)
        size = wire_buf.size
        nbytes = size * wdt.itemsize
        send_view = _as_bytes(np.ascontiguousarray(wire_buf))
        if n == 2:
            # One hop: stream my raw wire buffer out while folding the
            # peer's into the f32 accumulator segment by segment. The
            # two-term f32 sum is order-insensitive, so both ranks get
            # bitwise-identical results — and bitwise-identical to the
            # upcast-before-ring path they replace.
            t0 = time.perf_counter()
            acc = to_dtype(wire_buf, orig)
            self._ring_fold_s += time.perf_counter() - t0
            self._ring_bytes += nbytes
            fut = ring.send_async(send_view)
            scratch = bytearray(min(_SEG_BYTES, max(nbytes, 1)))
            sv = memoryview(scratch)
            off = 0
            while off < nbytes:
                k = min(_SEG_BYTES, nbytes - off)
                seg = sv[:k]
                self._recv(ring, seg)
                lo = off // wdt.itemsize
                t0 = time.perf_counter()
                fold_into(acc[lo:lo + k // wdt.itemsize],
                          to_dtype(np.frombuffer(seg, dtype=wdt), orig))
                self._ring_fold_s += time.perf_counter() - t0
                off += k
            self._sent(fut)
            return acc
        # world 3+ (within the byte crossover): ring-allgather the raw
        # wire buffers (each step forwards the previously received one),
        # then fold once in canonical rank order 0..n-1 so every rank
        # reproduces the identical f32 sum bit for bit.
        bufs: List[Optional[np.ndarray]] = [None] * n
        bufs[rank] = wire_buf
        for step in range(n - 1):
            self._ring_bytes += nbytes
            fut = ring.send_async(send_view)
            recv = np.empty(size, wdt)
            self._recv(ring, _as_bytes(recv))
            self._sent(fut)
            bufs[(rank - step - 1) % n] = recv
            send_view = _as_bytes(recv)
        t0 = time.perf_counter()
        acc = np.zeros(size, orig)
        for b in bufs:
            fold_into(acc, to_dtype(b, orig))
        self._ring_fold_s += time.perf_counter() - t0
        return acc

    def _ring_allgather_raw(self, ring: _Ring,
                            wire_buf: np.ndarray) -> List[np.ndarray]:
        """Ring-allgather of every rank's RAW wire buffer (each step
        forwards the previously received one), returned in rank order —
        the shared transport of the degraded-mode weighted folds (same
        loop shape as the int8 rung's :meth:`_ring_allgather_int8`)."""
        n, rank = self._world, self._rank
        a = np.ravel(np.asarray(wire_buf))
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        size, wdt = a.size, a.dtype
        nbytes = size * wdt.itemsize
        bufs: List[Optional[np.ndarray]] = [None] * n
        bufs[rank] = a
        send_view = _as_bytes(a)
        for step in range(n - 1):
            self._ring_bytes += nbytes
            fut = ring.send_async(send_view)
            recv = np.empty(size, wdt)
            _recv_exact_into(ring.prev_sock, _as_bytes(recv))
            fut.result()
            bufs[(rank - step - 1) % n] = recv
            send_view = _as_bytes(recv)
        return bufs  # type: ignore[return-value]

    @staticmethod
    def _weighted_fold(bufs: Any, orig: np.dtype,
                       weights: List[int], lo: int,
                       hi: int) -> np.ndarray:
        """The ONE spelling of the weighted canonical-order fold
        (docs/design/degraded_mode.md): ``acc = sum_r(w_r * x_r)`` in
        rank order 0..n-1 — each product in the accumulator dtype —
        then normalized by the total weight (true-divide for floats,
        floor-divide for ints, the ``div_by_count`` dtype rule).
        Zero-weight contributions are EXCLUDED from the fold, not
        multiplied by zero: a healer's junk buffer with weight 0 (an
        inf/NaN element times 0.0 is NaN) must never poison the
        average. ``[lo, hi)`` restricts the fold to a stripe, which
        slice-commutes elementwise — the reduce-scatter stripe is
        bitwise the same slice of the allreduce result. ``bufs`` may
        be any iterable — the int8 paths feed a dequantize GENERATOR
        so only one full-size buffer is live at a time. A bf16
        accumulator folds in float32 and rounds to bf16 once at the end
        (the JAX package folds in bf16 and floor-divides it, since
        ml_dtypes' bf16 is not a numpy floating type: ROADMAP C)."""
        bf16 = orig == BF16
        acc_dt = np.dtype(np.float32) if bf16 else orig
        acc = np.zeros(hi - lo, acc_dt)
        scalar = acc_dt.type
        for w, b in zip(weights, bufs):
            if w:
                acc += to_dtype(np.ravel(b)[lo:hi], acc_dt) * scalar(w)
        total = sum(weights)
        if total:
            if np.issubdtype(acc_dt, np.floating):
                acc /= scalar(total)
            else:
                acc //= total
        return f32_to_bf16(acc) if bf16 else acc

    def _ring_allreduce_weighted(self, ring: _Ring,
                                 wire_buf: np.ndarray, orig: np.dtype,
                                 weights: List[int]) -> np.ndarray:
        """Weighted wire allreduce (degraded-mode groups): ring-allgather
        every rank's RAW wire contribution — never partial sums — and
        run the weighted canonical fold. Identical raw bytes folded in
        identical order make the result bitwise identical across ranks
        AND equal to the single-process numpy oracle. Raw forwarding
        costs (world-1)*wire bytes per rank — more than the exact
        ring's 2(n-1)/n past world 2 — accepted: weighting partial sums
        would smear each rank's weight across fold boundaries (and
        break the one-quantization contract for narrow wires), and
        degraded mode is a robustness regime, not a bandwidth one."""
        bufs = self._ring_allgather_raw(ring, wire_buf)
        return self._weighted_fold(bufs, orig, weights, 0,
                                   bufs[0].size)

    def _ring_reduce_scatter_weighted(self, ring: _Ring,
                                      wire_buf: np.ndarray,
                                      orig: np.dtype,
                                      weights: List[int]) -> np.ndarray:
        """Reduce-scatter sibling: identical raw allgather transport,
        weighted fold restricted to this rank's canonical stripe —
        concat of every rank's stripe is bitwise the
        :meth:`_ring_allreduce_weighted` result."""
        bufs = self._ring_allgather_raw(ring, wire_buf)
        bounds = shard_bounds(bufs[0].size, self._world)
        return self._weighted_fold(
            bufs, orig, weights, int(bounds[self._rank]),
            int(bounds[self._rank + 1]))

    def _ring_allreduce_int8(self, ring: _Ring, w: Int8Wire,
                             orig: np.dtype,
                             weights: Optional[List[int]] = None
                             ) -> np.ndarray:
        """int8 + error-feedback wire allreduce (the new rung of the
        wire ladder): ring-allgather every rank's RAW
        quantized contribution — ``(scales, zeros, q)`` per
        :meth:`Int8Wire.to_bytes`, never partial sums, so each
        contribution is quantized exactly once (on its owner, with the
        owner's error-feedback residual already folded in by the
        Manager) — then dequantize-and-fold in canonical rank order
        0..n-1 into a full-precision accumulator. Same
        bitwise-identity-across-ranks contract as the bf16 wire path:
        every rank folds identical raw bytes in identical order.

        Ring bytes: (world-1) * (size + 8*nseg) per rank — ~1/4 of the
        f32 exact ring at world 2, and cheaper than upcasting through
        world*1 <= 2*orig.itemsize*... in practice any realistic world
        (the 4x itemsize ratio pushes the raw-forwarding crossover to
        world 32 for f32), so there is no crossover fallback here.

        ``weights`` (degraded-mode groups) switches the fold to the
        weighted canonical fold over the dequantized contributions —
        normalized by the total weight, zero-weight ranks excluded
        (:meth:`_weighted_fold`'s contract). Dequantization is fed
        lazily, so the weighted fold keeps the unweighted path's
        one-full-buffer-at-a-time peak memory."""
        bufs = self._ring_allgather_int8(ring, w)
        if weights is not None:
            return self._weighted_fold(
                (wb.dequantize(orig) for wb in bufs), orig, weights,
                0, w.size)
        t0 = time.perf_counter()
        acc = np.zeros(w.size, orig)
        for wb in bufs:
            acc += wb.dequantize(orig)
        self._ring_fold_s += time.perf_counter() - t0
        return acc

    def _ring_allgather_int8(self, ring: _Ring,
                             w: Int8Wire) -> List[Int8Wire]:
        """The int8 rung's shared transport: ring-allgather of every
        rank's raw serialized :class:`Int8Wire` (each step forwards the
        previously received payload), returned decoded in rank order —
        the ONE loop both the allreduce and reduce-scatter folds ride,
        so byte accounting and error behavior cannot diverge between
        them."""
        n, rank = self._world, self._rank
        payload = w.to_bytes()
        nbytes = len(payload)
        raw: List[Optional[Any]] = [None] * n
        raw[rank] = w
        send_view: Any = memoryview(payload)
        for step in range(n - 1):
            self._ring_bytes += nbytes
            self._ring_bytes_int8 += nbytes
            fut = ring.send_async(send_view)
            recv = bytearray(nbytes)
            self._recv(ring, memoryview(recv))
            self._sent(fut)
            raw[(rank - step - 1) % n] = recv
            send_view = memoryview(recv)
        return [b if isinstance(b, Int8Wire)
                else Int8Wire.from_bytes(b, w.size, w.seg_elems)
                for b in raw]

    def _ring_reduce_scatter_int8(self, ring: _Ring, w: Int8Wire,
                                  orig: np.dtype,
                                  weights: Optional[List[int]] = None
                                  ) -> np.ndarray:
        """Reduce-scatter sibling: identical raw allgather transport
        (quantization segments span stripe boundaries, so stripes can't
        ride alone without re-quantizing — which would break the
        one-quantization-per-contribution contract), but the canonical
        fold runs only over this rank's stripe: concat of every rank's
        stripe is bitwise the :meth:`_ring_allreduce_int8` result
        (weighted folds included — the stripe restriction
        slice-commutes)."""
        n, rank = self._world, self._rank
        bufs = self._ring_allgather_int8(ring, w)
        bounds = shard_bounds(w.size, n)
        lo, hi = int(bounds[rank]), int(bounds[rank + 1])
        if weights is not None:
            # Lazy dequantize: one full buffer live at a time, like
            # the unweighted loop below.
            return self._weighted_fold(
                (wb.dequantize(orig) for wb in bufs), orig, weights,
                lo, hi)
        acc = np.zeros(hi - lo, orig)
        for wb in bufs:
            acc += wb.dequantize(orig)[lo:hi]
        return acc

    def _do_reduce_scatter_wire(self, ring: Optional[_Ring],
                                buffers: List[Any], origs: List[np.dtype],
                                op: str, tag: str = "",
                                weight: int = -1) -> List[np.ndarray]:
        topo = self._hier
        if topo is not None:
            return self._do_wire_hier(topo, "rs", buffers, origs, op,
                                      tag, weight)
        if ring is None:
            raise CommunicatorError("communicator not configured")
        weights = self._wire_preamble(ring, "rs", buffers, origs, tag,
                                      weight)
        if weights is not None:
            if op == "mean":
                raise CommunicatorError(
                    "op='mean' is not supported with weighted folding "
                    "(the weighted fold already normalizes)")
            return [
                self._ring_reduce_scatter_int8(ring, buf, orig,
                                               weights=weights)
                if isinstance(buf, Int8Wire)
                else self._ring_reduce_scatter_weighted(ring, buf, orig,
                                                        weights)
                for buf, orig in zip(buffers, origs)]
        out: List[np.ndarray] = []
        for buf, orig in zip(buffers, origs):
            if isinstance(buf, Int8Wire):
                shard = self._ring_reduce_scatter_int8(ring, buf, orig)
                if op == "mean":
                    shard /= self._world
                out.append(shard)
                continue
            a = np.ravel(np.asarray(buf))
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            if a.dtype == orig:
                if not a.flags.writeable:
                    a = np.array(a)  # exact phase reduces in place
                shard = self._ring_reduce_scatter_buffer(ring, a)
            else:
                shard = self._ring_reduce_scatter_wire(ring, a, orig)
            if op == "mean":
                _mean_in_place(shard, self._world)
            out.append(shard)
        return out

    def _ring_reduce_scatter_wire(self, ring: _Ring, wire_buf: np.ndarray,
                                  orig: np.dtype) -> np.ndarray:
        """Wire-dtype reduce-scatter: same numerics contract as
        :meth:`_ring_allreduce_wire` (raw contributions, one quantization
        per contribution, canonical-rank-order f32 fold) restricted to
        this rank's canonical stripe — so the stripe is BITWISE identical
        to the same slice of the allreduce_wire result.

        World 2 exchanges only the peer-needed raw segment (half the
        wire ring bytes of allreduce_wire). World 3+ within the byte
        crossover ring-allgathers the raw buffers exactly like
        allreduce_wire (same ring bytes — raw forwarding cannot be
        segmented without breaking the canonical fold order) but folds
        only the local stripe, cutting fold compute to ~1/world. Past
        the crossover the buffer upcasts and takes the exact
        reduce-scatter (half the exact allreduce's ring bytes)."""
        n, rank = self._world, self._rank
        wdt = wire_buf.dtype
        if n * wdt.itemsize > 2 * orig.itemsize:
            return self._ring_reduce_scatter_buffer(
                ring, to_dtype(wire_buf, orig))
        size = wire_buf.size
        bounds = shard_bounds(size, n)
        lo, hi = int(bounds[rank]), int(bounds[rank + 1])
        if n == 2:
            # Send the PEER's stripe of my raw contribution; receive my
            # stripe of theirs and fold it segment by segment into the
            # upcast of my own stripe (two-term f32 sums are
            # order-insensitive, so this is bitwise the allreduce_wire
            # fold restricted to the stripe).
            peer = 1 - rank
            plo, phi = int(bounds[peer]), int(bounds[peer + 1])
            send_view = _as_bytes(
                np.ascontiguousarray(wire_buf[plo:phi]))
            self._ring_bytes += len(send_view)
            fut = ring.send_async(send_view)
            acc = to_dtype(wire_buf[lo:hi], orig)
            nbytes = (hi - lo) * wdt.itemsize
            scratch = bytearray(min(_SEG_BYTES, max(nbytes, 1)))
            sv = memoryview(scratch)
            off = 0
            while off < nbytes:
                k = min(_SEG_BYTES, nbytes - off)
                seg = sv[:k]
                _recv_exact_into(ring.prev_sock, seg)
                s = off // wdt.itemsize
                fold_into(acc[s:s + k // wdt.itemsize],
                          to_dtype(np.frombuffer(seg, dtype=wdt), orig))
                off += k
            fut.result()
            return acc
        # world 3+ within the crossover: ring-allgather the raw wire
        # buffers (identical transport to _ring_allreduce_wire — each
        # step forwards the previously received buffer), then fold ONLY
        # this rank's stripe in canonical rank order.
        nbytes = size * wdt.itemsize
        send_view = _as_bytes(np.ascontiguousarray(wire_buf))
        bufs: List[Optional[np.ndarray]] = [None] * n
        bufs[rank] = wire_buf
        for step in range(n - 1):
            self._ring_bytes += nbytes
            fut = ring.send_async(send_view)
            recv = np.empty(size, wdt)
            _recv_exact_into(ring.prev_sock, _as_bytes(recv))
            fut.result()
            bufs[(rank - step - 1) % n] = recv
            send_view = _as_bytes(recv)
        acc = np.zeros(hi - lo, orig)
        for b in bufs:
            fold_into(acc, to_dtype(b[lo:hi], orig))
        return acc

    # --------------------------------------- hierarchical wire transport
    # (docs/design/hier_transport.md) Wire ops on a co-located topology
    # route here instead of the flat ring: every rank's RAW wire
    # contribution — never a partial sum — reaches every rank through
    # three legs (member->leader star gather, leader-ring allgather of
    # per-host bundles, leader->member broadcast), and the FOLD is then
    # a purely local computation replicating the flat transport's fold
    # order bit for bit. Raw forwarding is what preserves the
    # one-quantization-per-contribution contract AND makes the
    # cross-host leg's bytes scale with hosts: each leader sends
    # (hosts-1) bundles instead of each of n ranks sending (n-1)
    # buffers.

    def _hier_span(self, stage: str, **tags: Any) -> Any:
        """Per-leg span (``hier_intra``/``hier_leader``) from the
        Manager-installed tracer — the attribution that splits "slow
        hier op" into the loopback star vs the cross-host ring."""
        return maybe_span(getattr(self, "tracer", None), stage,
                          world=self._world, rank=self._rank, **tags)

    @staticmethod
    def _hier_serialize(buffers: List[Any]) -> List[Any]:
        """Raw wire bytes of this rank's contributions, one part per
        buffer: :meth:`Int8Wire.to_bytes` for the int8 rung, the
        buffer's own bytes for float wires — exactly what the flat
        transports put on the TCP ring, so byte counts and formats are
        identical across topologies."""
        parts: List[Any] = []
        for b in buffers:
            if isinstance(b, Int8Wire):
                parts.append(b.to_bytes())
            else:
                a = np.ravel(np.asarray(b))
                if not a.flags.c_contiguous:
                    a = np.ascontiguousarray(a)
                parts.append(memoryview(a.view(np.uint8)).cast("B"))
        return parts

    @staticmethod
    def _hier_decode(payload: Any, template: Any) -> Any:
        """Decode one received raw contribution using the local
        buffer's format (geometry is schedule-deterministic, and the
        record header's format hash was validated before any payload
        byte was trusted)."""
        if isinstance(template, Int8Wire):
            return Int8Wire.from_bytes(payload, template.size,
                                       template.seg_elems)
        dt = np.ravel(np.asarray(template)).dtype
        return np.frombuffer(payload, dt)

    def _hier_recv_record(self, sock: socket.socket, key: int,
                          weight: int, sizes: List[int],
                          expect_rank: int) -> Tuple[bytes, int, list]:
        """Receive + validate one rank's record (32-byte header +
        payloads). The header carries the same format hash as the flat
        ring's per-op preamble, so format/weight-mode skew aborts on
        the FIRST hop it crosses — before a single payload byte is
        parsed as data."""
        hdr = bytes(_recv_exact(sock, 32))
        magic, gkey, gw, grank = struct.unpack("<qqqq", hdr)
        if magic == _HIER_ABORT:
            raise CommunicatorError(
                "hier transport abort relayed by the leader (a peer "
                "announced a mismatched wire-op format)")
        if magic != _HIER_MAGIC or gkey != key:
            raise CommunicatorError(
                "wire format skew: a peer announced a different "
                f"wire-op format (got {gkey:#x}, expected {key:#x})"
                " — policy/wire-dtype mismatch across groups; "
                "aborting the collective before folding garbage")
        if (gw < 0) != (weight < 0):
            raise CommunicatorError(
                "wire weight skew: this op mixes weighted and "
                f"unweighted ranks (mine {weight}, a peer's {gw}) "
                "— degraded mode (weighted folding) must be "
                "enabled on EVERY group or none; aborting the "
                "collective before folding garbage")
        if grank != expect_rank:
            raise CommunicatorError(
                f"hier record rank mismatch (got {grank}, expected "
                f"{expect_rank}) — stale or crossed hier stream")
        payloads = [_recv_exact(sock, s) for s in sizes]
        return hdr, int(gw), payloads

    def _hier_abort_down(self, topo: "_HierTopo") -> None:
        """Best-effort poison header down the star so members fail
        fast on the leader's abort instead of blocking out their
        socket timeout. A member that already completed this op reads
        it at its NEXT op's header — a clean CommunicatorError either
        way, and the latched error's recovery rendezvous rebuilds
        every hier socket, so the stray header cannot leak across
        epochs."""
        abort = struct.pack("<qqqq", _HIER_ABORT, 0, -1, self._rank)
        for s in topo.member_socks.values():
            try:
                _send_all(s, abort)
            except Exception:  # noqa: BLE001 — member already gone
                pass

    def _hier_leader_exchange(self, topo: "_HierTopo", key: int,
                              weight: int, sizes: List[int],
                              hdrs: list, payloads: list, wts: list,
                              all_int8: bool, kind: str) -> None:
        """The cross-host leg: ring-allgather of per-host record
        bundles among the leaders (each step forwards the previously
        received bundle — the flat wire ring's forwarding loop, one
        level up). Per leader: (hosts-1) bundle sends of
        per_host * record bytes — the leg whose bytes scale with
        hosts, not groups."""
        ring = topo.leader_ring
        nh = len(topo.hosts)
        mh = topo.my_host
        with self._hier_span("hier_leader", kind=kind, hosts=nh):
            send_chunks: List[Any] = []
            for r in topo.members:
                send_chunks.append(hdrs[r])
                send_chunks.extend(payloads[r])
            for step in range(nh - 1):
                futs = [ring.send_async(ch) for ch in send_chunks]
                sent = sum(len(ch) for ch in send_chunks)
                src = (mh - step - 1) % nh
                recv_chunks: List[Any] = []
                for r in topo.hosts[src]:
                    h, gw, pl = self._hier_recv_record(
                        ring.prev_sock, key, weight, sizes, r)
                    hdrs[r], payloads[r], wts[r] = h, pl, gw
                    recv_chunks.append(h)
                    recv_chunks.extend(pl)
                for f in futs:
                    f.result()
                self._ring_bytes += sent
                self._hier_leader_bytes += sent
                if all_int8:
                    self._ring_bytes_int8 += sent
                send_chunks = recv_chunks  # forward along the ring

    def _do_wire_hier(self, topo: "_HierTopo", kind: str,
                      buffers: List[Any], origs: List[np.dtype],
                      op: str, tag: str, weight: int
                      ) -> List[np.ndarray]:
        n, rank = self._world, self._rank
        weight = int(weight)
        key = self._wire_desc_key(kind, buffers, origs, tag)
        parts = self._hier_serialize(buffers)
        sizes = [len(p) for p in parts]
        rec_bytes = 32 + sum(sizes)
        hdr = struct.pack("<qqqq", _HIER_MAGIC, key, weight, rank)
        payloads: List[Optional[list]] = [None] * n
        hdrs: List[Optional[bytes]] = [None] * n
        wts = [0] * n
        payloads[rank] = list(parts)
        hdrs[rank] = hdr
        wts[rank] = weight
        all_int8 = bool(buffers) and all(
            isinstance(b, Int8Wire) for b in buffers)
        try:
            if not topo.is_leader:
                with self._hier_span("hier_intra", kind=kind, leg="up"):
                    _send_all(topo.up_sock, hdr)
                    for p in parts:
                        _send_all(topo.up_sock, p)
                    self._hier_intra_bytes += rec_bytes
                with self._hier_span("hier_intra", kind=kind,
                                     leg="down"):
                    # The leader elides THIS member's own record from
                    # its down stream (we already have it).
                    for r in range(n):
                        if r == rank:
                            continue
                        h, gw, pl = self._hier_recv_record(
                            topo.up_sock, key, weight, sizes, r)
                        payloads[r] = pl
                        wts[r] = gw
            else:
                with self._hier_span("hier_intra", kind=kind,
                                     leg="gather"):
                    for r in topo.members:
                        if r == rank:
                            continue
                        h, gw, pl = self._hier_recv_record(
                            topo.member_socks[r], key, weight, sizes,
                            r)
                        hdrs[r], payloads[r], wts[r] = h, pl, gw
                if topo.leader_ring is not None:
                    self._hier_leader_exchange(topo, key, weight,
                                               sizes, hdrs, payloads,
                                               wts, all_int8, kind)
                with self._hier_span("hier_intra", kind=kind,
                                     leg="down"):
                    # ONE concatenated down bundle (records in rank
                    # order, with per-rank byte offsets), sent as at
                    # most two slices per member — the member's own
                    # record is elided (it already has it), and the
                    # single buffer replaces ~2n per-chunk sendalls
                    # per member with <= 2.
                    chunks: List[Any] = []
                    offs = [0] * (n + 1)
                    for r in range(n):
                        chunks.append(hdrs[r])
                        chunks.extend(payloads[r])
                        offs[r + 1] = offs[r] + rec_bytes
                    down = memoryview(b"".join(chunks))
                    for m in topo.members:
                        if m == rank:
                            continue
                        s = topo.member_socks[m]
                        _send_all(s, down[:offs[m]])
                        _send_all(s, down[offs[m + 1]:])
                        self._hier_intra_bytes += (n - 1) * rec_bytes
        except Exception as e:
            if topo.is_leader:
                self._hier_abort_down(topo)
            raise (e if isinstance(e, CommunicatorError)
                   else CommunicatorError(str(e)))
        ws = list(map(int, wts)) if weight >= 0 else None
        if ws is not None and op == "mean":
            raise CommunicatorError(
                "op='mean' is not supported with weighted folding "
                "(the weighted fold already normalizes)")
        out: List[np.ndarray] = []
        for k, (mine, orig) in enumerate(zip(buffers, origs)):
            contribs = [
                mine if r == rank else self._hier_decode(
                    payloads[r][k], mine)
                for r in range(n)]
            out.append(self._hier_fold(kind, contribs, orig, ws, op))
        return out

    def _hier_fold(self, kind: str, contribs: List[Any],
                   orig: np.dtype, weights: Optional[List[int]],
                   op: str) -> np.ndarray:
        """Local fold over all n raw contributions, replicating the
        flat transport's fold order BIT FOR BIT per mode — the
        hierarchical transport changes only how bytes travel, never
        what is folded in which order (the "fold order unchanged"
        invariant the A/B acceptance test freezes):

        * weighted: the shared :meth:`_weighted_fold` (canonical rank
          order, zero weights excluded, normalized in the fold);
        * int8: zeros-start canonical rank order over dequantized
          contributions (= ``_ring_allreduce_int8``);
        * in-crossover narrow wires: the flat raw-forwarding fold —
          own-first two-term at world 2, zeros-start linear at 3+;
        * exact (and past-crossover narrow wires, which the flat path
          upcasts into the exact ring): the exact ring's rotated
          per-stripe order via :func:`_fold_exact_ring_order`.
        """
        n, rank = self._world, self._rank
        is_int8 = isinstance(contribs[0], Int8Wire)
        size = (contribs[0].size if is_int8
                else np.ravel(np.asarray(contribs[0])).size)
        bounds = shard_bounds(size, n)
        lo, hi = ((int(bounds[rank]), int(bounds[rank + 1]))
                  if kind == "rs" else (0, size))
        if weights is not None:
            gen = ((wb.dequantize(orig) for wb in contribs) if is_int8
                   else contribs)
            return self._weighted_fold(gen, orig, weights, lo, hi)
        if is_int8:
            acc = np.zeros(hi - lo, orig)
            if kind == "rs":
                for wb in contribs:
                    acc += wb.dequantize(orig)[lo:hi]
            else:
                for wb in contribs:
                    acc += wb.dequantize(orig)
        else:
            arrs = [np.ravel(np.asarray(b)) for b in contribs]
            wdt = arrs[0].dtype
            if wdt != orig and n * wdt.itemsize <= 2 * orig.itemsize:
                if n == 2:
                    acc = to_dtype(arrs[0][lo:hi], orig)
                    fold_into(acc, to_dtype(arrs[1][lo:hi], orig))
                else:
                    acc = np.zeros(hi - lo, orig)
                    for a in arrs:
                        fold_into(acc, to_dtype(a[lo:hi], orig))
            else:
                if wdt != orig:
                    arrs = [to_dtype(a, orig) for a in arrs]
                acc = _fold_exact_ring_order(
                    arrs, orig, n,
                    stripe=rank if kind == "rs" else None)
        if op == "mean":
            _mean_in_place(acc, n)
        return acc

    def _do_broadcast(self, ring: Optional[_Ring], tree: Any,
                      root: int) -> Any:
        if ring is None:
            raise CommunicatorError("communicator not configured")
        n, rank = self._world, self._rank
        if rank == root:
            payload = save_pytree(tree)
            _send_all(ring.next_sock, struct.pack("<q", len(payload)))
            _send_all(ring.next_sock, payload)
            return tree
        size = struct.unpack("<q", bytes(_recv_exact(ring.prev_sock, 8)))[0]
        payload = _recv_exact(ring.prev_sock, size)  # bytearray, no copy
        if (rank + 1) % n != root:  # forward along the ring
            _send_all(ring.next_sock, struct.pack("<q", len(payload)))
            _send_all(ring.next_sock, payload)
        return load_pytree(payload, tree)

    def _do_allgather(self, ring: Optional[_Ring], tree: Any) -> List[Any]:
        if ring is None:
            raise CommunicatorError("communicator not configured")
        n, rank = self._world, self._rank
        results: List[Optional[Any]] = [None] * n
        results[rank] = tree
        payload = save_pytree(tree)
        for step in range(n - 1):
            header = struct.pack("<qq", (rank - step) % n, len(payload))
            f1 = ring.send_async(header)
            f2 = ring.send_async(payload)
            src, size = struct.unpack(
                "<qq", bytes(_recv_exact(ring.prev_sock, 16)))
            payload = _recv_exact(ring.prev_sock, size)  # bytearray, no copy
            f1.result()
            f2.result()
            results[src] = load_pytree(payload, tree)
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------- accessors

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def ring_bytes_total(self) -> float:
        return self._ring_bytes

    def int8_ring_bytes_total(self) -> float:
        return self._ring_bytes_int8

    def ring_time_ms_total(self) -> Dict[str, float]:
        return {"fold": self._ring_fold_s * 1e3,
                "transfer": self._ring_transfer_s * 1e3}

    def _recv(self, ring: _Ring, view: Any) -> None:
        """Receive into ``view`` from the ring's predecessor, timed as
        transfer."""
        t0 = time.perf_counter()
        _recv_exact_into(ring.prev_sock, view)
        self._ring_transfer_s += time.perf_counter() - t0

    def _sent(self, fut: Future) -> None:
        """Wait for an outbound send to drain, timed as transfer."""
        t0 = time.perf_counter()
        fut.result()
        self._ring_transfer_s += time.perf_counter() - t0

    def ring_topology(self) -> str:
        topo = self._hier
        if topo is None:
            return "flat"
        return (f"hier:{len(topo.hosts)}x"
                f"{max(len(ms) for ms in topo.hosts)}")

    def hier_intra_bytes_total(self) -> float:
        return self._hier_intra_bytes

    def hier_leader_bytes_total(self) -> float:
        """The cross-host leader-ring slice of :meth:`ring_bytes_total`
        — the bytes the hierarchy exists to shrink (scales with hosts,
        not groups)."""
        return self._hier_leader_bytes

    def hier_leader(self) -> float:
        topo = self._hier
        return 1.0 if topo is not None and topo.is_leader else 0.0

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        self._drain_queue("communicator shutdown")
        self._ops.put(None)
        with self._lock:
            ring, self._ring = self._ring, None
            topo, self._hier = self._hier, None
        if ring is not None:
            ring.close()
        if topo is not None:
            topo.close()
        self._worker.join(timeout=5)


# Wire-op preamble magic (see _wire_preamble): distinguishes a format
# hash from stray payload bytes when a skewed peer is mid-stream.
_WIRE_MAGIC = 0x7F7A_57F7
# Hierarchical record-header magic + the leader's abort poison header
# (see _hier_recv_record / _hier_abort_down) — distinct values so a
# flat preamble can never parse as a hier record or vice versa.
_HIER_MAGIC = 0x7F7A_57F8
_HIER_ABORT = 0x7F7A_57A0


def _fold_exact_ring_order(arrs: List[np.ndarray], orig: np.dtype,
                           world: int,
                           stripe: Optional[int] = None) -> np.ndarray:
    """Fold full-precision contributions in the exact ring's order:
    canonical stripe ``c`` (:func:`shard_bounds` geometry — the ring's
    own chunking) is the sequential left fold over ranks ``c, c+1, ...,
    c+world-1`` (mod world), which is bit-for-bit the value the flat
    ring's reduce-scatter phase produces for that chunk (each ring step
    computes ``local + received_partial``; two-term f32 adds commute
    bitwise, so the nesting matches — frozen by
    tests/test_transport.py's flat-vs-hier battery). ``stripe=r``
    returns only rank r's canonical stripe (the reduce-scatter
    contract); ``None`` assembles the full buffer."""
    size = arrs[0].size
    bounds = shard_bounds(size, world)

    def fold_chunk(c: int) -> np.ndarray:
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        acc = np.array(arrs[c % world][lo:hi], dtype=orig)
        for s in range(1, world):
            fold_into(acc, arrs[(c + s) % world][lo:hi])
        return acc

    if stripe is not None:
        return fold_chunk(stripe)
    out = np.empty(size, orig)
    for c in range(world):
        out[int(bounds[c]):int(bounds[c + 1])] = fold_chunk(c)
    return out


def _mean_in_place(a: np.ndarray, world: int) -> None:
    """``op="mean"``: divide a reduced buffer by the world in place —
    true division for floats (bf16: the float32 quotient rounded once),
    floor division for integers."""
    if a.dtype == BF16:
        a[...] = f32_to_bf16(bf16_to_f32(a) / np.float32(world))
    elif np.issubdtype(a.dtype, np.inexact):
        a /= world
    else:
        a //= world


def epoch_key(prefix: str) -> int:
    """Stable 63-bit hash of the store prefix, used in the ring handshake so
    dialers from a different quorum epoch are rejected at accept."""
    h = 1469598103934665603
    for b in prefix.encode():
        h = ((h ^ b) * 1099511628211) & 0x7FFFFFFFFFFFFFFF
    return h
