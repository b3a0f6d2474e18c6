"""Resizable cross-replica-group communicators.

The fault-tolerance-critical collective path. Plays the role of the
reference's reconfigurable ProcessGroups
(torchft/process_group.py): a :class:`Communicator` can be
``configure()``-d onto a new (rank, world_size) between steps via a
store-prefix rendezvous keyed by quorum id — stragglers from an old quorum
can never cross-talk with the new one (reference ``manager.py:374-376``).

TPU-native mapping (SURVEY.md §7): *intra*-group collectives are XLA's job
(``psum`` et al. over ICI inside the jitted step); communicators here carry
*cross*-group traffic (gradient averaging between slices) host-side over
TCP/DCN, which is what makes membership changes possible at all — XLA cannot
resize a compiled collective's world at runtime, so the resizable collective
must live outside the accelerator runtime. The reference reached the same
architecture for different reasons (NCCL aborts hang,
``process_group.py:259-275``); on TPU the host-mediated path is the design
default, with the on-device multi-slice mesh as the stable-membership
optimization (``backends/mesh.py``).

Variants mirror the reference inventory: :class:`DummyCommunicator`
(``ProcessGroupDummy``, :279-344), :class:`ErrorSwallowingCommunicator`
(:347-440), :class:`ManagedCommunicator` (:443-468), and
:class:`HostCommunicator` (the Gloo-role backend, in
``backends/host.py``).

All collectives operate on pytrees of host numpy arrays and return
:class:`concurrent.futures.Future` so the Manager can overlap them with
compute and drain them at commit (``manager.py:429-438``).
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger: logging.Logger = logging.getLogger(__name__)


# ------------------------------------------------------------ bfloat16
# numpy has no bfloat16 and the port does not import ml_dtypes, so a bf16
# array lives on the host as ``BF16``: a one-field structured dtype over
# the raw uint16 bits (the bytes the ring carries). Its identity differs
# from uint16, so a bf16 buffer is never taken for integers, and numpy
# refuses arithmetic on it, so a fold that forgot to convert raises
# instead of summing bit patterns. ``.astype`` is NOT refused (it reads
# the bits as integers): convert only through :func:`bf16_to_f32`,
# :func:`f32_to_bf16`, :func:`to_dtype` and :func:`fold_into`, which match
# ml_dtypes bit for bit. Wherever a dtype is spelled (the schedule
# fingerprint, the ring's per-op preamble) it is named ``bfloat16``
# (:func:`dtype_name`), as the JAX package names it.
BF16 = np.dtype([("bfloat16", "<u2")])
BF16_NAME = "bfloat16"


def dtype_name(d: Any) -> str:
    """numpy's name of a dtype (``float32``), ``bfloat16`` for bf16 in
    any spelling: :data:`BF16`, the string, ``torch.bfloat16``, or
    ml_dtypes' type where a process has it."""
    if isinstance(d, np.dtype) and d == BF16:
        return BF16_NAME
    s = str(d)
    if s.startswith("torch."):  # a torch.dtype, named without importing torch
        s = s[len("torch."):]
        return s if s == BF16_NAME else str(np.dtype(s))
    if s == BF16_NAME:
        return BF16_NAME
    return str(np.dtype(d))


def host_dtype(d: Any) -> np.dtype:
    """The host dtype of a dtype in any spelling: :data:`BF16` for
    bfloat16, numpy's own dtype otherwise."""
    name = dtype_name(d)
    return BF16 if name == BF16_NAME else np.dtype(name)


def bf16_to_f32(a: np.ndarray) -> np.ndarray:
    """bf16 bits (a :data:`BF16` or uint16 array) to float32: the bits
    shifted into the high half, exact."""
    bits = np.ascontiguousarray(a).view(np.uint16)
    # One ufunc pass, widening inside the loop (as fast as ml_dtypes).
    return np.left_shift(bits, np.uint32(16), dtype=np.uint32).view(
        np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 to bf16 (a :data:`BF16` array), as ml_dtypes converts:
    round to nearest, ties to even, on the 16 dropped bits; ±inf and
    subnormals kept (overflow rounds to inf); NaN becomes the quiet NaN
    ``0x7FC0`` with its sign."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    bits = x.view(np.uint32)
    # (bits + 0x7FFF + lsb) >> 16, in place in one scratch array. No
    # NaN-free input overflows: the largest, -max's 0xFF7FFFFF, plus
    # 0x8000 is 0xFF807FFF.
    r = np.right_shift(bits, np.uint32(16))
    np.bitwise_and(r, np.uint32(1), out=r)
    np.add(r, np.uint32(0x7FFF), out=r)
    np.add(r, bits, out=r)
    np.right_shift(r, np.uint32(16), out=r)
    out = r.astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        out[nan] = ((bits[nan] >> np.uint32(16)) & np.uint32(0x8000)
                    | np.uint32(0x7FC0)).astype(np.uint16)
    return out.view(BF16)


def to_dtype(buf: Any, dtype: np.dtype, copy: bool = True) -> np.ndarray:
    """A flat host buffer in ``dtype`` — the bf16-aware spelling of
    ``buf.astype(dtype, copy=copy)``: a wire buffer widened to its
    accumulator, or a float buffer rounded to a bf16 wire. A fresh copy
    unless ``copy`` is off and ``buf`` already is in ``dtype``."""
    a = np.ravel(np.asarray(buf))
    if a.dtype == BF16:
        if dtype == BF16:
            return a.copy() if copy else a
        return bf16_to_f32(a).astype(dtype, copy=False)
    if dtype == BF16:
        return f32_to_bf16(a.astype(np.float32, copy=False))
    return a.astype(dtype, copy=copy)


def fold_into(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst += src`` in ``dst``'s dtype. For bf16 it is ml_dtypes' sum:
    the float32 sum of the two, rounded to bf16 once."""
    if dst.dtype == BF16:
        dst[...] = f32_to_bf16(bf16_to_f32(dst) + bf16_to_f32(src))
    else:
        dst += src


def _upcast_buffers(buffers: Sequence[Any],
                    orig_dtypes: Sequence[Any]) -> List[np.ndarray]:
    """Flatten + upcast wire buffers to their accumulator dtypes (the
    default / fallback spelling of :meth:`Communicator.allreduce_wire`).
    :class:`Int8Wire` buffers dequantize — one affine reconstruction,
    exactly the contribution the ring fold would have used."""
    out = []
    for b, d in zip(buffers, orig_dtypes):
        if isinstance(b, Int8Wire):
            out.append(b.dequantize(host_dtype(d)))
        else:
            out.append(to_dtype(b, host_dtype(d), copy=False))
    return out


# Elements per int8 quantization segment: small enough that one affine
# (scale, zero) pair tracks the local value range (gradients are far
# from uniform across a packed chunk), large enough that the 8-byte
# per-segment header is noise (<0.02% of payload) — so the ring moves
# ~1/4 of the f32 bytes, the rung's reason to exist.
INT8_SEG_ELEMS = 65_536


class Int8Wire:
    """One chunk's int8 + per-segment-affine wire form (the new rung of
    the wire ladder): ``q[k]`` reconstructs as
    ``q[k] * scale[seg] + zero[seg]`` with ``seg = k // seg_elems``.

    Quantization happens exactly once per contribution, on the
    contributing rank (``quantize``, usually with the Manager's
    error-feedback residual already folded into ``values``); the ring
    moves raw ``(scales, zeros, q)`` — never partial sums — and every
    rank folds the dequantized contributions in canonical rank order
    into a full-precision accumulator, the same
    bitwise-identity-across-ranks contract as the bf16 wire path
    (``backends/host.py:_ring_allreduce_int8``).

    Constant segments (all values equal — e.g. a healer's zero
    contribution) encode as ``scale=0, zero=v`` and reconstruct
    EXACTLY: zeros stay exact in this format just as they do in any
    float wire dtype.
    """

    __slots__ = ("q", "scales", "zeros", "size", "seg_elems")

    def __init__(self, q: np.ndarray, scales: np.ndarray,
                 zeros: np.ndarray,
                 seg_elems: int = INT8_SEG_ELEMS) -> None:
        self.q = q
        self.scales = scales
        self.zeros = zeros
        self.size = int(q.size)
        self.seg_elems = int(seg_elems)

    @staticmethod
    def nseg(size: int, seg_elems: int = INT8_SEG_ELEMS) -> int:
        return max(1, -(-int(size) // int(seg_elems)))

    @staticmethod
    def pow2_scales(s0: np.ndarray) -> np.ndarray:
        """Smallest power of two >= each (assumed positive, finite) f32
        in ``s0``, computed by exponent-bit manipulation — NOT by
        ``2**ceil(log2(...))``, whose transcendental pieces round
        differently between libm and XLA. Integer bit ops are exactly
        reproducible everywhere, which is what lets the device-side
        quantizer (``manager.py:_device_quantize_pack``) produce
        bit-identical payloads to this host path. Subnormal inputs clamp
        up to the smallest normal (2^-126); near-max inputs clamp down
        to 2^127 (the resulting |q| overflow is absorbed by the ±127
        clip)."""
        bits = np.asarray(s0, np.float32).view(np.uint32)
        e = (bits >> np.uint32(23)) + (bits & np.uint32(0x7FFFFF) != 0)
        e = np.clip(e, 1, 254).astype(np.uint32)
        return (e << np.uint32(23)).view(np.float32)

    @staticmethod
    def quantize(values: np.ndarray,
                 seg_elems: int = INT8_SEG_ELEMS) -> "Int8Wire":
        """Per-segment affine quantization of a 1-D float buffer.
        Deterministic (pure vectorized f32 numpy, round-half-even via
        ``np.rint``) so identically-seeded groups quantize identically.

        The segment scale is rounded UP to a power of two
        (:meth:`pow2_scales`): ``q * scale`` is then exact in f32 (an
        8-bit integer times a power of two never rounds), so the
        reconstruction ``q*scale + zero`` has exactly ONE rounding —
        which makes dequantization immune to FMA contraction and lets
        the fused device-side quantizer (the D2H fetch optimization,
        ``manager.py:_device_quantize_pack``) match this host spelling
        bit for bit, error-feedback residuals included
        (tests/test_transport.py freezes the parity). Costs at most one
        bit of quantization resolution, which the EF residual loop
        absorbs.

        Non-finite segments (a loss-spike inf/NaN element) encode as
        exact zero rather than poisoning the whole segment's
        reconstruction with NaN — the contribution is junk either way,
        but this keeps the format (and the caller's error-feedback
        residual, see Manager._int8_quantize_bucket) finite so the rank
        recovers on the next clean step. Constant segments encode as
        ``scale=0, zero=v`` and reconstruct exactly."""
        seg_elems = int(seg_elems)
        v = np.ravel(np.asarray(values)).astype(np.float32, copy=False)
        n = v.size
        nseg = Int8Wire.nseg(n, seg_elems)
        if n == 0:
            return Int8Wire(np.zeros(0, np.int8),
                            np.zeros(nseg, np.float32),
                            np.zeros(nseg, np.float32), seg_elems)
        pad = nseg * seg_elems - n
        # Pad with the last element: it already belongs to the last
        # segment, so the padded min/max are the true segment min/max.
        vp = (np.concatenate([v, np.broadcast_to(v[-1], (pad,))])
              if pad else v)
        m = vp.reshape(nseg, seg_elems)
        lo = m.min(axis=1)
        hi = m.max(axis=1)
        zero = (hi + lo) / np.float32(2.0)
        s0 = (hi - lo) / np.float32(254.0)
        finite = np.isfinite(zero) & np.isfinite(s0)
        ok = finite & (s0 > 0)
        zeros = np.where(finite, zero, np.float32(0)).astype(np.float32)
        scales = np.where(
            ok, Int8Wire.pow2_scales(np.where(ok, s0, np.float32(1))),
            np.float32(0)).astype(np.float32)
        with np.errstate(all="ignore"):  # masked-out lanes divide by 0
            qf = np.clip(np.rint((m - zeros[:, None]) / scales[:, None]),
                         -127, 127)
        q = np.where(scales[:, None] > 0, qf,
                     np.float32(0)).astype(np.int8).reshape(-1)[:n]
        return Int8Wire(q, scales, zeros, seg_elems)

    def dequantize(self, dtype: Any = np.float32) -> np.ndarray:
        """Affine reconstruction into the accumulator dtype. The
        ``q*scale`` product is exact (power-of-two scales, see
        :meth:`quantize`), so the reconstruction rounds exactly once —
        the property the device-side residual fold relies on."""
        n, seg = self.size, self.seg_elems
        nseg = len(self.scales)
        pad = nseg * seg - n
        q = (np.concatenate([self.q, np.zeros(pad, np.int8)])
             if pad else self.q)
        out = (q.reshape(nseg, seg).astype(np.float32)
               * self.scales[:, None]
               + self.zeros[:, None]).reshape(-1)[:n]
        d = host_dtype(dtype)
        return (f32_to_bf16(out) if d == BF16
                else out.astype(d, copy=False))

    # -------------------------------------------------- ring wire format
    # Fixed-size payload derivable from (size, seg_elems) alone, so
    # every rank computes identical byte counts from the shared chunk
    # geometry — the property the ring's symmetric exchanges need.

    def wire_nbytes(self) -> int:
        return Int8Wire.payload_nbytes(self.size, self.seg_elems)

    @staticmethod
    def payload_nbytes(size: int,
                       seg_elems: int = INT8_SEG_ELEMS) -> int:
        return 8 * Int8Wire.nseg(size, seg_elems) + int(size)

    def to_bytes(self) -> bytes:
        return (self.scales.astype("<f4").tobytes()
                + self.zeros.astype("<f4").tobytes()
                + np.ascontiguousarray(self.q).tobytes())

    @staticmethod
    def from_bytes(payload: Any, size: int,
                   seg_elems: int = INT8_SEG_ELEMS) -> "Int8Wire":
        nseg = Int8Wire.nseg(size, seg_elems)
        mv = memoryview(payload)
        scales = np.frombuffer(mv[:4 * nseg], "<f4").astype(np.float32)
        zeros = np.frombuffer(mv[4 * nseg:8 * nseg],
                              "<f4").astype(np.float32)
        q = np.frombuffer(mv[8 * nseg:8 * nseg + size],
                          np.int8).copy()
        return Int8Wire(q, scales, zeros, seg_elems)

    @staticmethod
    def zeros_like(size: int,
                   seg_elems: int = INT8_SEG_ELEMS) -> "Int8Wire":
        """Exact-zero contribution from metadata only (healers/spares —
        the int8 spelling of ``np.zeros(c.total, c.wire)``)."""
        nseg = Int8Wire.nseg(size, seg_elems)
        return Int8Wire(np.zeros(size, np.int8),
                        np.zeros(nseg, np.float32),
                        np.zeros(nseg, np.float32), seg_elems)

    # ------------------------------------------------ delta publication
    # The serving tier's quantized-delta primitive
    # (docs/design/serving.md): encode ``new - base`` as one wire and
    # reconstruct ``base + dequantize(wire)``. Both sides MUST use
    # these two spellings — the power-of-two scales make ``q*scale``
    # exact and the f32 add rounds once, so the publisher's encode-time
    # reconstruction and a subscriber's decode-time reconstruction are
    # bit-identical, which is what lets the published manifest digest
    # double as the delta's end-to-end verification.

    @staticmethod
    def delta_encode(base: Any, new: Any,
                     seg_elems: int = INT8_SEG_ELEMS
                     ) -> Tuple["Int8Wire", np.ndarray]:
        """Quantize ``new - base`` (both flattened f32) and return
        ``(wire, reconstruction)`` where ``reconstruction`` is exactly
        what :meth:`delta_apply` on the receiving side produces from
        the same wire bytes."""
        b = np.ravel(np.asarray(base)).astype(np.float32, copy=False)
        n = np.ravel(np.asarray(new)).astype(np.float32, copy=False)
        wire = Int8Wire.quantize(n - b, seg_elems)
        return wire, Int8Wire.delta_apply(b, wire)

    @staticmethod
    def delta_apply(base: Any, wire: "Int8Wire") -> np.ndarray:
        """Reconstruct a delta-published buffer: ``base + wire`` in f32
        — the ONE reconstruction spelling (see :meth:`delta_encode`)."""
        b = np.ravel(np.asarray(base)).astype(np.float32, copy=False)
        return (b + wire.dequantize(np.float32)).astype(np.float32,
                                                        copy=False)

    def max_quant_step(self) -> float:
        """Upper bound on this wire's per-element quantization error
        (half the largest segment scale) — the publish-time "does int8
        resolve this delta?" gate: a diff whose dynamic range forces a
        step coarser than the caller's tolerance defeats int8 and the
        leaf falls back to exact f32."""
        return float(self.scales.max(initial=np.float32(0))) * 0.5


def shard_bounds(size: int, world: int) -> np.ndarray:
    """Canonical shard boundaries of a ``size``-element buffer across
    ``world`` ranks: rank ``r`` owns ``[bounds[r], bounds[r+1])``. The ONE
    spelling shared by the reduce-scatter transport, the sharded optimizer
    update, and the param allgather reassembly — every layer must derive
    byte-identical stripes from (size, world) alone, or the reassembled
    params tear at stripe seams. Deliberately the same ``np.linspace``
    geometry as the exact ring's chunking (``backends/host.py``), so the
    exact-mode reduce-scatter IS the ring's reduce-scatter phase."""
    return np.linspace(0, size, world + 1, dtype=np.int64)


def _slice_shards(buffers: Sequence[np.ndarray], rank: int,
                  world: int) -> List[np.ndarray]:
    """Rank-``rank``'s canonical stripe of each buffer (copies — callers
    own the shards outright; the full buffers may be backend scratch)."""
    out = []
    for arr in buffers:
        b = shard_bounds(arr.size, world)
        out.append(np.array(arr[b[rank]:b[rank + 1]]))
    return out


class CommunicatorError(RuntimeError):
    """A collective failed (peer death, timeout, reconfiguration abort)."""


class Communicator(ABC):
    """Abstract resizable communicator (reference ``ProcessGroup``,
    ``process_group.py:88-187``)."""

    @abstractmethod
    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        """(Re)configure onto a new world. ``store_addr`` is
        ``"host:port/prefix..."`` — a KV store plus key prefix unique to the
        quorum. Aborts any in-flight work from the previous configuration."""

    @abstractmethod
    def allreduce(self, tree: Any, op: str = "sum") -> Future:
        """Sum (or mean) a pytree of numpy arrays across the world.

        Ownership: leaves that are already contiguous 1-D buffers may be
        reduced **in place** (backends skip the defensive concat/copy on
        that hot-path shape) — callers must treat inputs as consumed and
        use only the resolved result."""

    def allreduce_wire(self, buffers: Sequence[Any],
                       orig_dtypes: Sequence[Any],
                       op: str = "sum") -> Future:
        """Wire-aware allreduce over a flat list of contiguous 1-D numpy
        buffers (the Manager's packed bucket chunks).

        ``buffers[k]`` holds this rank's contribution already cast to the
        narrow *wire* dtype (== the accumulator dtype when uncompressed);
        ``orig_dtypes[k]`` names the full-precision accumulator dtype the
        reduced result must come back in. Resolves to a list of 1-D numpy
        arrays in the accumulator dtypes. Buffers are consumed: backends
        may reduce them in place.

        The default upcasts locally and reuses :meth:`allreduce` — wire
        compression then only thins the device->host leg, the pre-wire-
        ring behavior. Byte-counted transports override it to keep the
        narrow dtype on the TCP ring end-to-end and fold received
        segments into a full-precision accumulator
        (:class:`~torchft_tpu.backends.host.HostCommunicator`). Wrappers
        MUST forward — a wrapper falling back to the default silently
        doubles the ring bytes."""
        return self.allreduce(_upcast_buffers(buffers, orig_dtypes), op=op)

    def reduce_scatter_wire(self, buffers: Sequence[Any],
                            orig_dtypes: Sequence[Any],
                            op: str = "sum") -> Future:
        """Reduce-scatter sibling of :meth:`allreduce_wire`: reduce the
        flat wire buffers across the world but resolve to only THIS
        rank's canonical stripe of each reduced buffer
        (:func:`shard_bounds` over the buffer's element count), in the
        accumulator dtype. The contract that makes ZeRO-style sharded
        updates sound: ``concat(shards over ranks)`` must be BITWISE
        identical to the corresponding :meth:`allreduce_wire` result —
        byte-counted backends implement it as the ring's own
        reduce-scatter phase plus an ownership-shift hop (exact mode:
        1.0·payload ring bytes per rank vs the allreduce's 2(n-1)/n) or
        the canonical-rank-order wire fold restricted to the local
        stripe (:class:`~torchft_tpu.backends.host.HostCommunicator`;
        half the wire bytes at world 2), cutting fold compute — and the
        optimizer stage that follows — to ~1/world.
        Buffers are consumed, like :meth:`allreduce_wire`. Wrappers MUST
        forward — falling back to the default silently restores
        full-allreduce ring traffic."""
        fut = self.allreduce_wire(buffers, orig_dtypes, op)
        rank, world = self.rank(), max(self.size(), 1)
        out: Future = Future()

        def relay(f: Future) -> None:
            e = f.exception()
            if e is not None:
                out.set_exception(e)
                return
            try:
                out.set_result(_slice_shards(f.result(), rank, world))
            except Exception as e2:  # noqa: BLE001
                out.set_exception(e2)

        fut.add_done_callback(relay)
        return out

    def ring_bytes_total(self) -> float:
        """Cumulative allreduce payload bytes this rank has *sent* over
        the collective transport, surfaced by the Manager as
        ``allreduce_ring_wire_bytes_total`` so wire-compression savings
        are observable per leg (D2H vs ring). Backends without a
        byte-counted transport report 0.0; wrappers MUST forward."""
        return 0.0

    def int8_ring_bytes_total(self) -> float:
        """The :class:`Int8Wire` slice of :meth:`ring_bytes_total`
        (payload + per-segment headers), surfaced by the Manager as
        ``allreduce_int8_ring_bytes_total`` so the int8 rung's ~4x ring
        saving is observable on its own. Wrappers MUST forward."""
        return 0.0

    def ring_time_ms_total(self) -> Dict[str, float]:
        """Cumulative ms the allreduce rings spent in their host fold
        (``fold``: widen, dequantize, add) and blocked on the transport
        (``transfer``), surfaced by the Manager as
        ``allreduce_ring_fold_ms_total`` and
        ``allreduce_ring_transfer_ms_total``. Backends without a host
        ring report zeros; wrappers MUST forward."""
        return {"fold": 0.0, "transfer": 0.0}

    def ring_topology(self) -> str:
        """Human-readable transport topology of the wire ops:
        ``"flat"`` (the classic single-level ring — the default for
        every backend without a hierarchical transport) or
        ``"hier:<hosts>x<per_host>"`` when the host backend detected
        co-located ranks and built the two-level ring
        (docs/design/hier_transport.md). Surfaced by the Manager in
        ``metrics_info()`` and stamped into bench rows. Wrappers MUST
        forward."""
        return "flat"

    def hier_intra_bytes_total(self) -> float:
        """Bytes this rank has sent over the INTRA-host (loopback) leg
        of the hierarchical transport — the traffic that stopped
        crossing the DCN ring. 0.0 on flat topologies/backends without
        one. Surfaced as ``hier_intra_bytes_total``; wrappers MUST
        forward."""
        return 0.0

    def hier_leader(self) -> float:
        """1.0 when this rank is its host's elected leader on the
        hierarchical transport's cross-host ring, else 0.0 (members and
        flat topologies). Surfaced as the ``hier_leader`` gauge;
        wrappers MUST forward."""
        return 0.0

    def hier_leader_bytes_total(self) -> float:
        """The cross-host leader-ring slice of :meth:`ring_bytes_total`
        — the bytes the hierarchy exists to shrink (0.0 on members and
        flat topologies; the hier bench A/B sums it across groups).
        Wrappers MUST forward."""
        return 0.0

    @abstractmethod
    def broadcast(self, tree: Any, root: int = 0) -> Future:
        """Broadcast root's pytree to all ranks."""

    @abstractmethod
    def allgather(self, tree: Any) -> Future:
        """Gather every rank's pytree; resolves to a list of ``world_size``
        pytrees."""

    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    def rank(self) -> int: ...

    @property
    def wants_device_arrays(self) -> bool:
        """True if collectives take device-resident ``jax.Array`` leaves
        directly (on-device backends); False means the caller must hand
        over host (numpy) leaves. Wrappers forward the wrapped value."""
        return False

    def set_allreduce_config_fingerprint(self, fp: str) -> None:
        """Install the Manager's allreduce-config fingerprint (bucket
        schedule + wire dtype). Backends that rendezvous over a KV store
        verify it against replica rank 0's during ``configure`` and raise
        on skew (mismatched configs would wedge every bucketed collective
        with no diagnostic). Wrappers MUST forward to their inner
        communicator — a fingerprint stranded on a wrapper silently
        disables the check."""
        self.allreduce_config_fingerprint = fp

    def set_wire_tag(self, tag: str) -> None:
        """Name the PAYLOAD KIND of subsequent wire ops (the Manager
        sets "step" for per-step grads, "diloco" for outer-round
        pseudo-gradients, synchronously before issuing each pipeline's
        ops). Byte-counted transports mix it into the per-op format
        preamble so two groups momentarily skewed across a DiLoCo mode
        transition abort cleanly instead of folding a pseudo-gradient
        into a per-step gradient of identical geometry. Wrappers MUST
        forward inward — a tag stranded on a wrapper silently disables
        the check (degrading to no-tag matching, never to a false
        abort)."""
        self.wire_tag = tag

    def set_wire_weight(self, weight: int) -> None:
        """Declare this rank's fold WEIGHT for subsequent wire ops — the
        samples this group actually contributes this step (degraded-mode
        groups, docs/design/degraded_mode.md). ``-1`` (the default when
        never set) means unweighted: the classic uniform fold.

        Byte-counted transports carry the weight in the per-op format
        preamble's ring allgather, so every rank learns every rank's
        weight and folds ``sum_r(w_r * x_r) / sum_r(w_r)`` in canonical
        rank order — identical bytes, identical order, bitwise identical
        across ranks. Weight-mode skew (one rank weighted, a peer not)
        is DETECTED by the preamble and aborts the op cleanly; the
        per-rank weight VALUES legitimately differ (that is the point of
        nonuniform capacity). Like the tag, the weight is captured per
        op on the caller thread. Wrappers MUST forward inward — a weight
        stranded on a wrapper silently degrades the fold to uniform."""
        self.wire_weight = int(weight)

    def set_retry_policy(self, policy: Any, stats: Any = None) -> None:
        """Install the owning Manager's transient-error retry policy and
        shared :class:`~torchft_tpu.retry.RetryStats`, so the backend's
        own transport retries (ring dial, rendezvous store client)
        follow the one configured policy and count into
        ``Manager.metrics()``. Default stores attributes; backends that
        retry override, and wrappers MUST forward inward."""
        self.retry_policy = policy
        self.retry_stats = stats

    def set_tracer(self, tracer: Any) -> None:
        """Install the owning Manager's span tracer
        (:class:`torchft_tpu.tracing.Tracer`): byte-counted transports
        record a ``ring`` span per wire op on the comm worker thread,
        giving the per-step timeline its ring track
        (docs/design/observability.md). Default stores the attribute;
        wrappers MUST forward inward — a tracer stranded on a wrapper
        silently blanks the ring track."""
        self.tracer = tracer

    def shutdown(self) -> None:  # noqa: B027
        pass


def _done_future(value: Any = None) -> Future:
    f: Future = Future()
    f.set_result(value)
    return f


class DummyCommunicator(Communicator):
    """Discards collectives, resolves immediately with the input.

    First-class library code, not a test double only: used to soak init-time
    collectives and as the world-size-1 stand-in, like the reference's
    ``ProcessGroupDummy`` (``process_group.py:278-344``, used in prod at
    ``ddp.py:50``). Instrumented with counters for tests
    (``process_group.py:309-315``)."""

    def __init__(self, rank: int = 0, world_size: int = 1) -> None:
        self._rank = rank
        self._world = world_size
        self.configure_count = 0
        self.allreduce_count = 0
        self.broadcast_count = 0
        self.allgather_count = 0

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self.configure_count += 1
        self._rank = rank
        self._world = world_size

    def allreduce(self, tree: Any, op: str = "sum") -> Future:
        self.allreduce_count += 1
        return _done_future(tree)

    def broadcast(self, tree: Any, root: int = 0) -> Future:
        self.broadcast_count += 1
        return _done_future(tree)

    def allgather(self, tree: Any) -> Future:
        self.allgather_count += 1
        return _done_future([tree] * self._world)

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank


class ErrorSwallowingCommunicator(Communicator):
    """Latches the first error; subsequent collectives return already-resolved
    futures with the input unchanged until the next ``configure()``.

    This keeps every rank's step structure identical even when collectives
    fail mid-step, deferring the consequence to the commit vote — the
    reference's ``ErrorSwallowingProcessGroupWrapper``
    (``process_group.py:347-440``).

    The fallback promise is STRUCTURE, not values: per the allreduce
    ownership contract, contiguous 1-D leaves may have been partially
    reduced in place by the backend before an in-flight failure, so the
    swallowed result's values are unspecified — the latched error is the
    signal that they must be discarded (the Manager's commit vote does
    exactly that)."""

    def __init__(self, comm: Communicator,
                 on_error: Optional[Callable[[Exception], None]] = None):
        self._comm = comm
        self._on_error = on_error
        self._error: Optional[Exception] = None

    def error(self) -> Optional[Exception]:
        return self._error

    def report_error(self, e: Exception) -> None:
        if self._error is None:
            logger.warning("communicator error latched: %s", e)
            self._error = e
            if self._on_error is not None:
                self._on_error(e)

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._error = None  # reconfiguration clears the latch (ref :397-400)
        self._comm.configure(store_addr, rank, world_size)

    def _wrap(self, fut: Future, fallback: Any) -> Future:
        return self._wrap_lazy(fut, lambda: fallback)

    def _wrap_lazy(self, fut: Future,
                   fallback_fn: Callable[[], Any]) -> Future:
        """Like :meth:`_wrap` but the fallback is built only on error —
        so a hot path needn't pre-pay a fallback allocation it will
        almost never use."""
        out: Future = Future()

        def relay(f: Future) -> None:
            e = f.exception()
            if e is None:
                out.set_result(f.result())
            else:
                self.report_error(e)
                out.set_result(fallback_fn())

        fut.add_done_callback(relay)
        return out

    def allreduce(self, tree: Any, op: str = "sum") -> Future:
        if self._error is not None:
            return _done_future(tree)
        try:
            return self._wrap(self._comm.allreduce(tree, op), tree)
        except Exception as e:
            self.report_error(e)
            return _done_future(tree)

    def allreduce_wire(self, buffers: Sequence[Any],
                       orig_dtypes: Sequence[Any],
                       op: str = "sum") -> Future:
        # Fallback built LAZILY at error time: the success path pays no
        # upcast allocation, and the fallback promises STRUCTURE and
        # dtypes only — buffers are consumed by the backend, so after an
        # in-flight failure they may hold partially-reduced values (the
        # error latch means callers discard them; the Manager aborts the
        # step at the commit vote).
        def fallback() -> Any:
            return _upcast_buffers(buffers, orig_dtypes)

        if self._error is not None:
            return _done_future(fallback())
        try:
            return self._wrap_lazy(
                self._comm.allreduce_wire(buffers, orig_dtypes, op),
                fallback)
        except Exception as e:
            self.report_error(e)
            return _done_future(fallback())

    def reduce_scatter_wire(self, buffers: Sequence[Any],
                            orig_dtypes: Sequence[Any],
                            op: str = "sum") -> Future:
        # Same lazy structure-only fallback discipline as allreduce_wire,
        # sliced to this rank's stripe (the shapes callers expect); the
        # latched error means the values are discarded at the vote.
        def fallback() -> Any:
            return _slice_shards(
                _upcast_buffers(buffers, orig_dtypes),
                self._comm.rank(), max(self._comm.size(), 1))

        if self._error is not None:
            return _done_future(fallback())
        try:
            return self._wrap_lazy(
                self._comm.reduce_scatter_wire(buffers, orig_dtypes, op),
                fallback)
        except Exception as e:
            self.report_error(e)
            return _done_future(fallback())

    def broadcast(self, tree: Any, root: int = 0) -> Future:
        if self._error is not None:
            return _done_future(tree)
        try:
            return self._wrap(self._comm.broadcast(tree, root), tree)
        except Exception as e:
            self.report_error(e)
            return _done_future(tree)

    def allgather(self, tree: Any) -> Future:
        fallback = [tree] * self.size()
        if self._error is not None:
            return _done_future(fallback)
        try:
            return self._wrap(self._comm.allgather(tree), fallback)
        except Exception as e:
            self.report_error(e)
            return _done_future(fallback)

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


class ManagedCommunicator(Communicator):
    """Binds a communicator to a Manager: errors are reported to the manager
    (feeding the commit vote) and ``size()`` reflects the current number of
    participating groups, so 1/n normalization tracks membership — the
    reference's ``ManagedProcessGroup`` (``process_group.py:443-468``)."""

    def __init__(self, manager: "Manager") -> None:  # noqa: F821
        self._manager = manager

    @property
    def _comm(self) -> Communicator:
        return self._manager._comm

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._comm.configure(store_addr, rank, world_size)

    def _guard(self, fut: Future, fallback: Any) -> Future:
        return self._guard_lazy(fut, lambda: fallback)

    def _guard_lazy(self, fut: Future,
                    fallback_fn: Callable[[], Any]) -> Future:
        out: Future = Future()

        def relay(f: Future) -> None:
            e = f.exception()
            if e is None:
                out.set_result(f.result())
            else:
                self._manager.report_error(e)
                out.set_result(fallback_fn())

        fut.add_done_callback(relay)
        return out

    def allreduce(self, tree: Any, op: str = "sum") -> Future:
        if self._manager.errored() is not None:
            return _done_future(tree)
        try:
            return self._guard(self._comm.allreduce(tree, op), tree)
        except Exception as e:
            self._manager.report_error(e)
            return _done_future(tree)

    def allreduce_wire(self, buffers: Sequence[Any],
                       orig_dtypes: Sequence[Any],
                       op: str = "sum") -> Future:
        # Lazy fallback: structure/dtypes only — see
        # ErrorSwallowingCommunicator.allreduce_wire (the buffers are
        # consumed by the backend; the error latch aborts the step).
        def fallback() -> Any:
            return _upcast_buffers(buffers, orig_dtypes)

        if self._manager.errored() is not None:
            return _done_future(fallback())
        try:
            return self._guard_lazy(
                self._comm.allreduce_wire(buffers, orig_dtypes, op),
                fallback)
        except Exception as e:
            self._manager.report_error(e)
            return _done_future(fallback())

    def reduce_scatter_wire(self, buffers: Sequence[Any],
                            orig_dtypes: Sequence[Any],
                            op: str = "sum") -> Future:
        # Lazy structure-only fallback sliced by the INNER comm's
        # (rank, world): this wrapper's size() is the participant count,
        # but stripe geometry belongs to the ring world.
        def fallback() -> Any:
            return _slice_shards(
                _upcast_buffers(buffers, orig_dtypes),
                self._comm.rank(), max(self._comm.size(), 1))

        if self._manager.errored() is not None:
            return _done_future(fallback())
        try:
            return self._guard_lazy(
                self._comm.reduce_scatter_wire(buffers, orig_dtypes, op),
                fallback)
        except Exception as e:
            self._manager.report_error(e)
            return _done_future(fallback())

    def broadcast(self, tree: Any, root: int = 0) -> Future:
        if self._manager.errored() is not None:
            return _done_future(tree)
        try:
            return self._guard(self._comm.broadcast(tree, root), tree)
        except Exception as e:
            self._manager.report_error(e)
            return _done_future(tree)

    def allgather(self, tree: Any) -> Future:
        fallback = [tree] * self.size()
        if self._manager.errored() is not None:
            return _done_future(fallback)
        try:
            return self._guard(self._comm.allgather(tree), fallback)
        except Exception as e:
            self._manager.report_error(e)
            return _done_future(fallback)

    def size(self) -> int:
        return self._manager.num_participants()

    def rank(self) -> int:
        return self._comm.rank()

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

    @property
    def wants_device_arrays(self) -> bool:
        return self._comm.wants_device_arrays
