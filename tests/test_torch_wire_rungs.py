"""The manager's wire rungs, bit for bit against the JAX package on the
same numpy-seeded inputs: the port's bfloat16 helpers against ml_dtypes,
the wire schedule's fingerprints, the int8 quantize-pack (torch) against
the JAX one and against ``Int8Wire.quantize`` over an error-feedback
trajectory, and the host ring's bf16 and int8 wire ops and its exact ring
on bf16 chunks, on rings of port ranks, of JAX ranks and of both."""

from __future__ import annotations

import socket
import threading
from unittest.mock import MagicMock

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu import communicator as jcomm
from torchft_tpu import manager as jmanager
from torchft_tpu.backends import host as jhost
from torchft_tpu_torch import communicator as tcomm
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import policy as tpolicy
from torchft_tpu_torch import utils as tutils
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.communicator import BF16
from torch_fakes import fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port

_F32 = np.finfo(np.float32)


def _f32_edges() -> np.ndarray:
    """float32 values where a bf16 conversion can go wrong: signed zeros
    and infinities, NaNs of both signs and several payloads, the largest
    finite values (which round to inf), subnormals, values exactly half
    way between two bf16 values (ties, both parities), one ulp either
    side of a tie, and every exponent's mantissa extremes."""
    bits = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
            0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF,
            0x7FFFFFFF, 0xFFFFFFFF, 0x7F80FFFF,
            0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF, 0x7F7F8000,
            0x00000001, 0x80000001, 0x00007FFF, 0x00008000, 0x00018000,
            0x007FFFFF, 0x807FFFFF, 0x00800000]
    ties = [(hi << 16) | 0x8000 for hi in range(0, 0x10000, 7)]
    near = [t + d for t in ties[::5] for d in (-1, 1)]
    mant = [(e << 23) | m for e in range(256) for m in (0, 0x7FFF, 0x7FFFFF)]
    out = np.array(bits + ties + near + mant, np.uint64) & 0xFFFFFFFF
    return out.astype(np.uint32).view(np.float32)


def test_f32_to_bf16_matches_ml_dtypes_bitwise():
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    for x in (_f32_edges(), rand, rng.standard_normal(10_000).astype(
            np.float32) * 1e-38):
        with np.errstate(invalid="ignore", over="ignore"):
            want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        got = tcomm.f32_to_bf16(x)
        assert got.dtype == BF16
        np.testing.assert_array_equal(got.view(np.uint16), want)


def test_bf16_to_f32_and_fold_match_ml_dtypes_bitwise():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**16, 100_000, dtype=np.uint64).astype(np.uint16)
    bits[:4] = [0x7F80, 0xFF80, 0x7FC0, 0x0001]
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(
        tcomm.bf16_to_f32(bits.view(BF16)).view(np.uint32),
        want.view(np.uint32))
    # fold_into: the float32 sum rounded to bf16, as ml_dtypes adds.
    a = (rng.standard_normal(50_000) * 3).astype(ml_dtypes.bfloat16)
    b = (rng.standard_normal(50_000) * 1e-2).astype(ml_dtypes.bfloat16)
    a[:3] = [np.inf, -np.inf, 1.0]
    b[:3] = [1.0, 2.0, -1.0]
    acc = a.view(np.uint16).copy().view(BF16)
    tcomm.fold_into(acc, b.view(np.uint16).view(BF16))
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(acc.view(np.uint16),
                                      (a + b).view(np.uint16))
    # The 1/n of a bf16 leaf, as the JAX package's host put computes it.
    for n in (2, 3, 7):
        np.testing.assert_array_equal(
            tutils.div_by_count(a.view(np.uint16).view(BF16), n).view(
                np.uint16),
            (a / n).astype(ml_dtypes.bfloat16).view(np.uint16))


def test_bf16_host_dtype_refuses_arithmetic():
    """A bf16 carrier is never summed as integers by accident."""
    a = np.zeros(4, BF16)
    with pytest.raises(TypeError):
        a += a
    for spelling in ("bfloat16", torch.bfloat16, BF16, ml_dtypes.bfloat16):
        assert tcomm.host_dtype(spelling) == BF16
        assert tcomm.dtype_name(spelling) == "bfloat16"
    assert tcomm.host_dtype(torch.float32) == np.float32
    assert tcomm.host_dtype("int32") == np.int32


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_wire_schedule_fingerprint_equal(wire):
    """Buckets sized in wire bytes; bf16 leaves keep their dtype."""
    metas = (((4096, 11), "float32"), ((3,), "float32"), ((), "int32"),
             ((1000, 1000), "float32"), ((7, 5), "int32"),
             ((0,), "float32"), ((300, 7), "bfloat16"), ((9,), "float64"),
             ((11,), "float16"), ((2, 2), "bfloat16"))
    for bucket_bytes in (64, 30_000, 4 << 20, 1 << 30):
        j = jmanager._derive_schedule(
            metas, bucket_bytes,
            ml_dtypes.bfloat16 if wire is not None else None)
        t = tmanager._derive_schedule(metas, bucket_bytes, wire)
        assert t.fingerprint == j.fingerprint
        assert t.buckets == j.buckets
    assert ("bfloat16:bfloat16" in t.fingerprint
            and ("float32:bfloat16" in t.fingerprint) == (wire is not None))


def test_device_quantize_pack_matches_jax_and_host_over_ef_steps():
    """Payload and residual bitwise equal across the torch quantize-pack,
    the JAX one and ``Int8Wire.quantize`` with the host residual, for
    five steps of one error-feedback trajectory, one of them carrying a
    NaN and an inf."""
    shapes = [(37, 11), (70_001,), (123,)]
    total = sum(int(np.prod(s)) for s in shapes)
    res_t = torch.zeros(total)
    res_j = jnp.zeros(total, jnp.float32)
    res_h = np.zeros(total, np.float32)
    for step in range(5):
        rng = np.random.default_rng(20 + step)
        leaves = [(rng.standard_normal(s) * (1 + 4 * step)).astype(
            np.float32) for s in shapes]
        if step == 2:
            leaves[1][5] = np.nan
            leaves[1][70_000] = np.inf
        payload_t, res_t = tmanager._device_quantize_pack(
            [torch.from_numpy(x) for x in leaves], res_t)
        payload_j, res_j = jmanager._device_quantize_pack(
            [jnp.asarray(x) for x in leaves], res_j)
        v = np.concatenate([x.ravel() for x in leaves]) + res_h
        w = tcomm.Int8Wire.quantize(v)
        res_h = v - w.dequantize(np.float32)
        res_h[~np.isfinite(res_h)] = 0.0
        assert payload_t.dtype == torch.uint8
        assert payload_t.numpy().tobytes() == np.asarray(payload_j).tobytes()
        assert payload_t.numpy().tobytes() == w.to_bytes()
        assert payload_t.numel() == tcomm.Int8Wire.payload_nbytes(total)
        np.testing.assert_array_equal(res_t.numpy().view(np.uint32),
                                      np.asarray(res_j).view(np.uint32))
        np.testing.assert_array_equal(res_t.numpy().view(np.uint32),
                                      res_h.view(np.uint32))
        assert np.isfinite(res_h).all() and res_h.any()


# ------------------------------------------------------------ host ring


def _wired(mod, ring, rank, world):
    class Wired(mod.HostCommunicator):
        def configure(self, store_addr, rank, world_size):
            pass

    c = Wired(timeout_sec=15)
    c._ring, c._rank, c._world = ring, rank, world
    return c


def _for_rank(mod, buf):
    """One rank's copy of a wire buffer in its package's format (bf16
    as ml_dtypes for JAX, BF16 for the port)."""
    if isinstance(buf, tuple):  # int8: the values to quantize
        return (jcomm if mod is jhost else tcomm).Int8Wire.quantize(buf[0])
    if buf.dtype == BF16:
        return (buf.view(np.uint16).view(ml_dtypes.bfloat16).copy()
                if mod is jhost else buf.copy())
    return buf.copy()


def _ring_op(mods, inputs, origs, op="allreduce_wire"):
    """One wire op per rank over a socketpair ring, rank r running
    package ``mods[r]``; returns each rank's outputs as bytes."""
    world = len(mods)
    pairs = [socket.socketpair() for _ in range(world)]
    comms = [_wired(m, m._Ring(pairs[r][0], pairs[(r - 1) % world][1],
                               socket.socket()), r, world)
             for r, m in enumerate(mods)]
    out = [None] * world

    def run(r):
        comms[r].set_wire_tag("step")
        comms[r].set_wire_weight(-1)
        bufs = [_for_rank(mods[r], b) for b in inputs[r]]
        res = getattr(comms[r], op)(bufs, origs, op="sum").result(timeout=30)
        out[r] = [np.asarray(a).tobytes() for a in res]

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    for c in comms:
        c.shutdown()
    assert all(o is not None for o in out), "a rank failed"
    return out


def _inputs(kind: str, world: int):
    rng = np.random.default_rng(world)
    sizes = (1, 1001, 70_000)
    vals = [[(rng.standard_normal(n) * 10 ** (r % 3)).astype(np.float32)
             for n in sizes] for r in range(world)]
    if kind == "int8":
        return [[(v,) for v in vs] for vs in vals], ["float32"] * 3
    bf = [[tcomm.f32_to_bf16(v) for v in vs] for vs in vals]
    if kind == "bf16_wire":
        return bf, ["float32"] * 3
    return bf, ["bfloat16"] * 3  # bf16 chunks on the exact ring


@pytest.mark.parametrize("kind", ["bf16_wire", "int8", "bf16_exact"])
@pytest.mark.parametrize("world", [2, 3])
def test_host_ring_wire_allreduce_bitwise_equal(kind, world):
    inputs, origs = _inputs(kind, world)
    port = _ring_op([thost] * world, inputs, origs)
    jax_side = _ring_op([jhost] * world, inputs, origs)
    mixed = _ring_op([jhost] + [thost] * (world - 1), inputs, origs)
    for r in range(world):
        assert port[r] == jax_side[r] == mixed[r], r
        assert port[r] == port[0]  # every rank holds the same sum


@pytest.mark.parametrize("kind", ["bf16_wire", "bf16_exact"])
def test_host_ring_bf16_past_the_byte_crossover_and_reduce_scatter(kind):
    """World 5 puts a bf16 wire past its raw-forwarding crossover (the
    ring upcasts and takes the exact ring); the reduce-scatter wire op
    folds like the allreduce."""
    inputs, origs = _inputs(kind, 5)
    mods = [jhost, thost, thost, jhost, thost]
    assert _ring_op(mods, inputs, origs) == _ring_op([jhost] * 5, inputs,
                                                     origs)
    inputs, origs = _inputs(kind, 3)
    mods = [thost, jhost, thost]
    assert (_ring_op(mods, inputs, origs, "reduce_scatter_wire")
            == _ring_op([jhost] * 3, inputs, origs, "reduce_scatter_wire"))


def test_weighted_fold_upcasts_bf16_wire():
    """The degraded-mode fold of bf16 wire buffers into float32."""
    rng = np.random.default_rng(3)
    vals = [rng.standard_normal(777).astype(np.float32) for _ in range(3)]
    port = thost.HostCommunicator._weighted_fold(
        [tcomm.f32_to_bf16(v) for v in vals], np.dtype(np.float32),
        [3, 0, 5], 10, 700)
    jax_side = jhost.HostCommunicator._weighted_fold(
        [v.astype(ml_dtypes.bfloat16) for v in vals], np.dtype(np.float32),
        [3, 0, 5], 10, 700)
    assert port.tobytes() == jax_side.tobytes()


# --------------------------------------------------- the manager's bytes


def _pair_metrics(**kw):
    """Two port Managers, one step over a socketpair ring; returns each
    one's metrics after the allreduce."""
    pairs = [socket.socketpair() for _ in range(2)]
    comms = [_wired(thost, thost._Ring(pairs[r][0], pairs[1 - r][1],
                                       socket.socket()), r, 2)
             for r in range(2)]
    out = [None, None]
    rng = np.random.default_rng(9)
    grads = {"w": rng.standard_normal((256, 1024)).astype(np.float32),
             "b": rng.standard_normal(4096).astype(np.float32)}

    def run(r):
        client = MagicMock()
        client.quorum.return_value = QuorumResult(
            quorum_id=1, recover_manager_address="m:1",
            store_address="s:1", max_step=1, max_rank=r, max_world_size=2,
            replica_rank=r, replica_world_size=2, heal=False)
        client.should_commit.return_value = True
        m = tmanager.Manager(comms[r], lambda s: None, dict, 1,
                             _manager_client=client,
                             checkpoint_bind_host="127.0.0.1", **kw)
        try:
            m.step()
            m.allreduce({k: torch.from_numpy(v * (r + 1))
                         for k, v in grads.items()}).result(timeout=30)
            assert m.should_commit()
            out[r] = m.metrics()
        finally:
            m.shutdown()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert out[0] is not None and out[1] is not None
    return out[0]


def test_rung_bytes_against_f32():
    """Ring and device->host bytes of each rung against the f32 rung's,
    the ratios the chip's wire phase holds (CPU tensors count as the
    device here)."""
    int8 = tpolicy.POLICIES["sync-int8"]
    f32 = _pair_metrics()
    rungs = {"bf16": (_pair_metrics(allreduce_wire_dtype=torch.bfloat16),
                      0.5, 0.5),
             "int8_device": (_pair_metrics(policy=int8), 0.25, 0.25),
             "int8_host": (_pair_metrics(policy=int8, device_quantize=False),
                           0.25, 1.0)}
    for name, (m, ring, d2h) in rungs.items():
        got_ring = (m["allreduce_ring_wire_bytes_total"]
                    / f32["allreduce_ring_wire_bytes_total"])
        got_d2h = (m["allreduce_d2h_wire_bytes_total"]
                   / f32["allreduce_d2h_wire_bytes_total"])
        assert abs(got_ring - ring) <= 0.01 * ring + 1e-3, (name, got_ring)
        assert abs(got_d2h - d2h) <= 0.01 * d2h + 1e-3, (name, got_d2h)
    assert rungs["int8_device"][0]["wire_quant_residual_bytes"] == 4 * (
        256 * 1024 + 4096)
    assert rungs["int8_host"][0]["wire_quant_residual_bytes"] == 4 * (
        256 * 1024 + 4096)


@pytest.mark.parametrize("rung", ["f32", "bf16", "int8_device", "int8_host"])
def test_ring_time_split_into_fold_and_transfer(rung):
    """The host ring counts its fold and its socket waits apart; both are
    spent inside the ring's own time."""
    int8 = tpolicy.POLICIES["sync-int8"]
    kw = {"f32": {}, "bf16": {"allreduce_wire_dtype": torch.bfloat16},
          "int8_device": {"policy": int8},
          "int8_host": {"policy": int8, "device_quantize": False}}[rung]
    m = _pair_metrics(**kw)
    fold = m["allreduce_ring_fold_ms_total"]
    transfer = m["allreduce_ring_transfer_ms_total"]
    assert fold > 0 and transfer > 0, m
    assert fold + transfer <= m["allreduce_ring_ms_total"], m
