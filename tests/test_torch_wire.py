"""Bytes and decisions the port must share with the JAX package, bit for
bit: serialized pytrees and their manifests, the int8 wire, the data
sampler, the allreduce bucket schedule, and the host TCP ring's f32
allreduce (each package's own ring, and a mixed ring of JAX and port
ranks)."""

from __future__ import annotations

import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu import communicator as jcomm
from torchft_tpu import data as jdata
from torchft_tpu import manager as jmanager
from torchft_tpu import serialization as jser
from torchft_tpu.backends import host as jhost
from torchft_tpu_torch import communicator as tcomm
from torchft_tpu_torch import data as tdata
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import serialization as tser
from torchft_tpu_torch.backends import host as thost

pytestmark = pytest.mark.port


def _trees(seed: int = 0):
    """The same state as a JAX-side numpy tree and a port-side tensor tree
    (bfloat16 leaves as ml_dtypes arrays / torch tensors)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    n = rng.integers(0, 100, (4,)).astype(np.int32)
    s = np.float32(rng.standard_normal())
    jtree = {"user": {"params": {"w": w, "b": b.astype(ml_dtypes.bfloat16),
                                 "layers": [w * 2, {"n": n}]},
                      "opt": {"step": s, "mu": (b, None)}},
             "torchft": {"step": 3, "batches_committed": 6}}
    ttree = {"user": {"params": {"w": torch.tensor(w),
                                 "b": torch.tensor(b).bfloat16(),
                                 "layers": [torch.tensor(w * 2),
                                            {"n": torch.tensor(n)}]},
                      "opt": {"step": torch.tensor(s),
                              "mu": (torch.tensor(b), None)}},
             "torchft": {"step": 3, "batches_committed": 6}}
    return jtree, ttree


@pytest.mark.parametrize("seed", [0, 1])
def test_save_pytree_bytes_and_manifest_equal(seed):
    jtree, ttree = _trees(seed)
    assert tser.save_pytree(ttree) == jser.save_pytree(jtree)
    assert (tser.manifest_from(tser.plan_pytree(ttree))
            == jser.manifest_from(jser.plan_pytree(jtree)))


def test_port_restores_jax_bytes():
    jtree, ttree = _trees(2)
    data = jser.save_pytree(jtree)
    back = tser.load_pytree(bytearray(data), ttree, tser.device_put_like)
    b = back["user"]["params"]["b"]
    assert b.dtype == torch.bfloat16
    assert torch.equal(b, ttree["user"]["params"]["b"])
    assert back["user"]["opt"]["step"].shape == ()
    assert back["user"]["opt"]["mu"][1] is None
    assert back["torchft"] == {"step": 3, "batches_committed": 6}
    assert tser.save_pytree(back) == data


@pytest.mark.parametrize("n", [1, 1000, 65_536 + 17])
def test_int8_wire_payloads_equal(n):
    v = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    assert (tcomm.Int8Wire.quantize(v).to_bytes()
            == jcomm.Int8Wire.quantize(v).to_bytes())


@pytest.mark.parametrize("groups,group,batch,shuffle", [
    (2, 0, 4, True), (2, 1, 4, True), (3, 2, 5, False), (1, 0, 8, True)])
def test_distributed_sampler_indices_equal(groups, group, batch, shuffle):
    kw = dict(dataset_size=103, replica_group=group,
              num_replica_groups=groups, batch_size=batch, shuffle=shuffle,
              seed=5)
    js, ts = jdata.DistributedSampler(**kw), tdata.DistributedSampler(**kw)
    for epoch in range(2):
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        for a, b in zip(js, ts, strict=True):
            np.testing.assert_array_equal(a, b)
    assert ts.state_dict() == js.state_dict()


def test_allreduce_schedule_fingerprint_equal():
    """The bucket/chunk geometry the ring agrees on, from leaf metadata."""
    metas = (((4096, 11), "float32"), ((3,), "float32"), ((), "int32"),
             ((1000, 1000), "float32"), ((7, 5), "int32"), ((0,), "float32"))
    for bucket_bytes in (64, 4 << 20, 1 << 30):
        j = jmanager._derive_schedule(metas, bucket_bytes, None)
        t = tmanager._derive_schedule(metas, bucket_bytes)
        assert t.fingerprint == j.fingerprint
        assert t.buckets == j.buckets


def _wired(mod, ring, rank, world):
    """A package's HostCommunicator on a pre-wired socketpair ring."""
    class Wired(mod.HostCommunicator):
        def configure(self, store_addr, rank, world_size):
            pass

    c = Wired(timeout_sec=15)
    c._ring, c._rank, c._world = ring, rank, world
    return c


def _ring_allreduce(mods, inputs):
    """One f32 allreduce_wire per rank over a socketpair ring, rank r
    running package ``mods[r]``; returns each rank's reduced buffers."""
    world = len(mods)
    pairs = [socket.socketpair() for _ in range(world)]
    comms = [_wired(m, m._Ring(pairs[r][0], pairs[(r - 1) % world][1],
                               socket.socket()), r, world)
             for r, m in enumerate(mods)]
    out = [None] * world

    def run(r):
        comms[r].set_wire_tag("step")
        comms[r].set_wire_weight(-1)
        bufs = [x.copy() for x in inputs[r]]
        out[r] = comms[r].allreduce_wire(
            bufs, ["float32"] * len(bufs), op="sum").result(timeout=30)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    for c in comms:
        c.shutdown()
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_host_ring_f32_allreduce_bitwise_equal(world):
    rng = np.random.default_rng(world)
    inputs = [[rng.standard_normal(n).astype(np.float32) * 10 ** r
               for n in (1, 1001, 70_000)] for r in range(world)]
    port = _ring_allreduce([thost] * world, inputs)
    jax_side = _ring_allreduce([jhost] * world, inputs)
    mixed = _ring_allreduce([jhost] + [thost] * (world - 1), inputs)
    for r in range(world):
        for a, b, c in zip(port[r], jax_side[r], mixed[r]):
            assert a.tobytes() == b.tobytes() == c.tobytes()
