"""The port's Manager (sync path) with a scripted control plane over a
real socketpair ring: the allreduce bitwise against the JAX Manager's on
the same inputs under every wire rung (f32, bf16 packed on the device or
cast on the host, int8 + error feedback quantized on the device or the
host, bf16 leaves), with participants, a healer contributing zeros, int
leaves, bucket boundaries and a capped stage-ahead window; the vote and
error latch, ring poisoning and the recovery rendezvous, the staged heal
applied at commit, a healer adopting the donor's wire rung, and the
constructor arguments still refused."""

from __future__ import annotations

import gc
import socket
import threading
import time
import weakref
from concurrent.futures import Future
from unittest.mock import MagicMock

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu import manager as jmanager
from torchft_tpu import policy as jpolicy
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu.backends import host as jhost
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import policy as tpolicy
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.communicator import CommunicatorError, Int8Wire
from torch_fakes import fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port


def _q(cls=QuorumResult, **kw):
    base = dict(quorum_id=1, recover_manager_address="manager:1",
                store_address="store:1", max_step=1, max_rank=0,
                max_world_size=2, replica_rank=0, replica_world_size=2,
                heal=False)
    base.update(kw)
    return cls(**base)


def _ring_comms(mod, world):
    pairs = [socket.socketpair() for _ in range(world)]

    class Wired(mod.HostCommunicator):
        def configure(self, store_addr, rank, world_size):
            pass

    comms = []
    for r in range(world):
        c = Wired(timeout_sec=15)
        c._ring = mod._Ring(pairs[r][0], pairs[(r - 1) % world][1],
                            socket.socket())
        c._rank, c._world = r, world
        comms.append(c)
    return comms


def _client(q, commit=True):
    client = MagicMock()
    client.quorum.return_value = q
    client.should_commit.return_value = commit
    return client


def _make(mod, comm, client, **kw):
    def noop(*_a):
        return {}

    return mod.Manager(comm=comm, load_state_dict=noop, state_dict=dict,
                       min_replica_size=1, _manager_client=client,
                       checkpoint_bind_host="127.0.0.1", **kw)


TREE = {
    "a": np.random.default_rng(0).standard_normal((257, 3)).astype(
        np.float32),
    "b": np.random.default_rng(1).standard_normal(1000).astype(np.float32),
    "empty": np.zeros((0, 5), np.float32),
    "i": np.arange(6, dtype=np.int32),
}

# rung -> (port Manager kwargs, JAX Manager kwargs, JAX leaves on the
# device); "bf16_leaves" casts the float leaves to bf16 with no wire dtype.
# "bf16_host" fetches the float32 chunk and casts it on the host (the
# ``hostcast`` staging record), which needs device leaves on the JAX side.
RUNGS = {
    "f32": ({}, {}, False),
    "bf16": ({"allreduce_wire_dtype": torch.bfloat16},
             {"allreduce_wire_dtype": ml_dtypes.bfloat16}, False),
    "bf16_host": ({"allreduce_wire_dtype": torch.bfloat16,
                   "device_quantize": False},
                  {"allreduce_wire_dtype": ml_dtypes.bfloat16,
                   "device_quantize": False}, True),
    "int8_device": ({"policy": tpolicy.POLICIES["sync-int8"],
                     "device_quantize": True},
                    {"policy": jpolicy.POLICIES["sync-int8"],
                     "device_quantize": True}, True),
    "int8_host": ({"policy": tpolicy.POLICIES["sync-int8"],
                   "device_quantize": False},
                  {"policy": jpolicy.POLICIES["sync-int8"],
                   "device_quantize": False}, False),
    "bf16_leaves": ({}, {}, False),
}
# The staging record each rung's float chunks take in the port.
RUNG_KIND = {"f32": "pack", "bf16": "pack", "bf16_host": "hostcast",
             "int8_device": "int8dev", "int8_host": "pack",
             "bf16_leaves": "pack"}


def _rank_tree(r, step, rung):
    """Rank r's gradients at ``step`` as numpy (bf16 leaves as ml_dtypes
    arrays)."""
    tree = {k: v * (r + 1) * (1 + step) if k != "b" else v * (r + 1) - step
            for k, v in TREE.items()}
    if rung == "bf16_leaves":
        tree = {k: v.astype(ml_dtypes.bfloat16) if v.dtype == np.float32
                else v for k, v in tree.items()}
    return tree


def _to_torch(v):
    if v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(v)


def _bytes(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return "bf16", v.view(torch.int16).numpy().tobytes()
        return v.numpy().dtype.str[1:], v.numpy().tobytes()
    v = np.asarray(v)
    return ("bf16" if v.dtype == ml_dtypes.bfloat16 else v.dtype.str[1:],
            v.tobytes())


def _allreduce(mod, world, healer=None, bucket_bytes=1024, rung="f32",
               steps=2, staging=None):
    """Every rank of one package runs ``steps`` x (step + allreduce +
    vote) on one Manager; rank ``healer`` sits out and contributes
    zeros. Returns each rank's reduced trees, as (dtype, bytes) leaves.
    For the port, ``staging`` (a list per rank) gets the Manager's
    staging events in order: ``("stage", bucket, kinds)`` and
    ``("wait", bucket)``."""
    comms = _ring_comms(thost if mod is tmanager else jhost, world)
    qcls = QuorumResult if mod is tmanager else JQuorumResult
    port_kw, jax_kw, jax_device = RUNGS[rung]
    results = [[] for _ in range(world)]
    errors = []

    def run(r):
        heal = r == healer
        q = _q(qcls, max_rank=None if heal else r,
               max_world_size=world - (healer is not None),
               replica_rank=r, replica_world_size=world, heal=False)
        # Both packages at their striped-heal default: the healset
        # advertisements land in the test's fake quorum store.
        extra = dict(port_kw) if mod is tmanager else dict(jax_kw)
        m = _make(mod, comms[r], _client(q),
                  allreduce_bucket_bytes=bucket_bytes, **extra)
        if staging is not None:
            stage, wait = m._stage_bucket, m._wait_bucket

            def staged(sched, b, leaves, int8):
                recs = stage(sched, b, leaves, int8)
                staging[r].append(("stage", b, [k for _, k, *_ in recs]))
                return recs

            def waited(recs, bucket):
                staging[r].append(("wait", bucket))
                return wait(recs, bucket)

            m._stage_bucket, m._wait_bucket = staged, waited
        try:
            for step in range(steps):
                m.step()
                tree = _rank_tree(r, step, rung)
                if mod is tmanager:
                    tree = {k: _to_torch(v) for k, v in tree.items()}
                elif jax_device:
                    tree = {k: jnp.asarray(v) for k, v in tree.items()}
                out = m.allreduce(tree).result(timeout=30)
                assert m.errored() is None, m.errored()
                assert m.should_commit()
                results[r].append({k: _bytes(v) for k, v in out.items()})
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            m.shutdown()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errors, errors
    return results


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("world,healer", [(2, None), (3, None), (3, 1)])
def test_allreduce_bitwise_equal_to_jax_manager(world, healer, rung):
    """Each wire rung, two steps (the int8 rung's error feedback folds
    step 1's residual into step 2), port ranks against JAX ranks."""
    staging = [[] for _ in range(world)]
    port = _allreduce(tmanager, world, healer, rung=rung, staging=staging)
    jax_side = _allreduce(jmanager, world, healer, rung=rung)
    for r in range(world):
        kinds = {k for e in staging[r] if e[0] == "stage" for k in e[2]}
        assert kinds <= {RUNG_KIND[rung], "pack"}, (r, kinds)
        assert (r == healer) == (RUNG_KIND[rung] not in kinds), (r, kinds)
    for r in range(world):
        for step in range(2):
            for k in TREE:
                assert port[r][step][k] == jax_side[r][step][k], (r, step, k)
    want = {"bf16_leaves": "bf16"}.get(rung, "f4")
    assert port[0][0]["a"][0] == want and port[0][0]["i"][0] == "i4"
    # Exact math at world 2: (x + 2x) / 2.
    if world == 2 and rung == "f32":
        assert port[0][0]["b"][1] == ((TREE["b"] * 3)
                                      / np.float32(2)).tobytes()


@pytest.mark.parametrize("rung", ["f32", "int8_device"])
@pytest.mark.parametrize("window", [None, "0", "1"])
def test_stage_ahead_window_bitwise_equal_to_jax_manager(
        monkeypatch, window, rung):
    """``TORCHFT_ALLREDUCE_STAGE_AHEAD`` caps how many buckets are packed
    ahead of the one being waited on (unset: all of them up front); the
    reduced trees stay bitwise the JAX Manager's under the same cap."""
    if window is None:
        monkeypatch.delenv("TORCHFT_ALLREDUCE_STAGE_AHEAD", raising=False)
    else:
        monkeypatch.setenv("TORCHFT_ALLREDUCE_STAGE_AHEAD", window)
    staging = [[], []]
    port = _allreduce(tmanager, 2, rung=rung, staging=staging)
    jax_side = _allreduce(jmanager, 2, rung=rung)
    assert port == jax_side
    for events in staging:
        n = sum(e[0] == "stage" for e in events) // 2  # buckets a step
        assert n >= 3
        staged = 0
        for e in events:
            if e[0] == "stage":
                staged = 1 if e[1] == 0 else staged + 1
                continue
            want = n if window is None else min(n, e[1] + 1 + int(window))
            assert staged == want, (window, events)


def test_stage_ahead_window_reads_env(monkeypatch):
    for raw, want in [("", None), ("0", 0), ("2", 2), ("-3", 0),
                      ("x", 0)]:
        monkeypatch.setenv("TORCHFT_ALLREDUCE_STAGE_AHEAD", raw)
        assert tmanager._stage_ahead_window() == want


def test_allreduce_releases_the_step_trees():
    """Once a step has committed, neither the gradients handed to the
    allreduce nor the averaged tree it returned stay alive: the ring's
    worker drops its last op, whose callbacks reach both trees, before it
    waits for the next (else two gradient trees sit on the device between
    steps)."""
    comms = _ring_comms(thost, 2)
    errors = []

    def run(r):
        m = _make(tmanager, comms[r], _client(_q(max_rank=r,
                                                 replica_rank=r)))
        try:
            m.step()
            tree = {k: torch.tensor(v * (r + 1)) for k, v in TREE.items()
                    if v.dtype == np.float32 and v.size}
            out = m.allreduce(tree).result(timeout=30)
            assert m.should_commit()
            refs = [weakref.ref(t) for t in (*tree.values(),
                                             *out.values())]
            del tree, out
            deadline = time.monotonic() + 5
            while (any(w() is not None for w in refs)
                   and time.monotonic() < deadline):
                gc.collect()
                time.sleep(0.01)
            assert all(w() is None for w in refs), "a step tree is alive"
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            m.shutdown()

    ts = [threading.Thread(target=run, args=(r,), daemon=True)
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors


def test_single_group_step_skips_the_ring():
    comm = MagicMock()
    comm.size.return_value = 1
    m = _make(tmanager, comm, _client(_q(max_world_size=1,
                                         replica_world_size=1)))
    try:
        m.step()
        tree = {"w": torch.ones(3)}
        assert m.allreduce(tree).result() is tree
        assert m.should_commit()
        comm.allreduce_wire.assert_not_called()
    finally:
        m.shutdown()


def test_comm_error_latches_poisons_and_recovers():
    comm = MagicMock()
    comm.size.return_value = 2
    comm.allreduce_wire.side_effect = CommunicatorError("ring reset")
    client = _client(_q(quorum_id=5, max_step=4), commit=False)
    m = _make(tmanager, comm, client)
    try:
        m.step()
        tree = {"w": torch.ones(4)}
        assert m.allreduce(tree).result() is tree  # swallowed
        assert isinstance(m.errored(), CommunicatorError)
        assert not m.should_commit()
        vote = client.should_commit.call_args.kwargs
        assert vote["should_commit"] is False
        # The next round has the same quorum id: a recovery rendezvous
        # under a prefix keyed by max_step.
        m.step()
        m.wait_quorum()
        prefixes = [c.args[0] for c in comm.configure.call_args_list]
        assert prefixes == ["store:1/torchft/5/0", "store:1/torchft/5.r4/0"]
        assert m.current_step() == 1  # the aborted step is retried
    finally:
        m.shutdown()


def test_heal_restores_at_commit_then_steps():
    donor_state = {"user": {"w": torch.arange(6, dtype=torch.float32)},
                   "torchft": {"step": 7, "batches_committed": 14}}
    donor = CheckpointServer(lambda: donor_state, bind_host="127.0.0.1")
    donor.allow_checkpoint(7)
    live = {"w": torch.zeros(6)}
    loaded = []

    def load(state):
        loaded.append(state)
        live["w"].copy_(state["w"])

    comm = MagicMock()
    comm.size.return_value = 2
    client = _client(_q(max_step=7, max_rank=None, max_world_size=1,
                        heal=True))
    m = tmanager.Manager(comm=comm, load_state_dict=load,
                         state_dict=lambda: live, min_replica_size=1,
                         _manager_client=client,
                         checkpoint_bind_host="127.0.0.1")
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmanager.Manager, "_resolve_checkpoint_addr",
                       lambda self, addr: donor.address())
            m.step()
            m.wait_quorum()
        assert m.is_healing() and not m.is_participating()
        assert not loaded  # staged, not applied, until the vote
        assert m.current_step() == 7
        assert m.should_commit()
        assert torch.equal(live["w"], donor_state["user"]["w"])
        assert m.metrics()["heal_count"] == 1
        client.quorum.return_value = _q(max_step=8, max_world_size=2)
        m.step()
        assert m.current_step() == 8
        assert m.batches_committed() == 14 + 1
    finally:
        m.shutdown()
        donor.shutdown()


def test_unported_arguments_are_refused():
    """What the port still refuses: the policy controller, DiLoCo
    policies, and an overlap depth beyond the one-step deferred commit
    (the JAX Manager refuses that too)."""
    comm = MagicMock()
    with pytest.raises(TypeError):
        _make(tmanager, comm, _client(_q()), policy_controller=object())
    with pytest.raises(ValueError, match="DiLoCo"):
        _make(tmanager, comm, _client(_q()),
              policy=tpolicy.POLICIES["diloco-16"])
    with pytest.raises(ValueError, match="overlap_steps"):
        _make(tmanager, comm, _client(_q()), overlap_steps=2)


def test_healer_adopts_donor_int8_rung_and_sends_int8_zeros():
    """A policy-aware healer on the f32 rung heals from a donor whose
    state carries the int8 rung: it adopts the rung with the state,
    flushes the residuals banked under the old one, and contributes
    Int8Wire zeros to the ring that same step."""
    int8 = tpolicy.POLICIES["sync-int8"]
    donor_state = {"user": {"w": torch.arange(6, dtype=torch.float32)},
                   "torchft": {"step": 7, "batches_committed": 14,
                               **int8.to_state()}}
    donor = CheckpointServer(lambda: donor_state, bind_host="127.0.0.1")
    donor.allow_checkpoint(7)
    live = {"w": torch.zeros(6)}
    comm = MagicMock()
    comm.size.return_value = 2
    sent = Future()
    sent.set_result([np.zeros(6, np.float32)])
    comm.allreduce_wire.return_value = sent
    client = _client(_q(max_step=7, max_rank=None, max_world_size=1,
                        heal=True))
    m = tmanager.Manager(comm=comm, load_state_dict=lambda s: None,
                         state_dict=lambda: live, min_replica_size=1,
                         policy=tpolicy.POLICIES["sync-f32"],
                         _manager_client=client,
                         checkpoint_bind_host="127.0.0.1")
    m._ef_residuals[("old", 0, 0)] = np.ones(6, np.float32)
    m._dev_residuals[("old", 0, 0)] = torch.ones(6)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmanager.Manager, "_resolve_checkpoint_addr",
                       lambda self, addr: donor.address())
            m.step()
            m.wait_quorum()
        assert m.policy() == int8
        assert not m._ef_residuals and not m._dev_residuals
        assert m.metrics()["wire_quant_residual_bytes"] == 0.0
        assert m.state_dict()["policy_wire"] == tpolicy.WIRE_INT8
        m.allreduce({"w": torch.ones(6)}).result(timeout=30)
        bufs, origs = comm.allreduce_wire.call_args.args
        assert origs == ["float32"]
        (w,) = bufs
        assert isinstance(w, Int8Wire)
        assert w.to_bytes() == Int8Wire.zeros_like(6).to_bytes()
        assert m.should_commit()
    finally:
        m.shutdown()
        donor.shutdown()
