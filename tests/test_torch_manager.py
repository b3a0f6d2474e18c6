"""The port's Manager (sync sub-slice) with a scripted control plane over a
real socketpair ring: the allreduce bitwise against the JAX Manager's on
the same inputs (participants, a healer contributing zeros, int leaves,
bucket boundaries), the vote and error latch, ring poisoning and the
recovery rendezvous, the staged heal applied at commit, and the
constructor arguments this sub-slice does not take."""

from __future__ import annotations

import socket
import threading
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torchft_tpu import manager as jmanager
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu.backends import host as jhost
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.communicator import CommunicatorError

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


def _allreduce(mod, world, healer=None, bucket_bytes=1024):
    """Every rank of one package runs step + allreduce + vote; rank
    ``healer`` sits the step out and contributes zeros."""
    comms = _ring_comms(thost if mod is tmanager else jhost, world)
    qcls = QuorumResult if mod is tmanager else JQuorumResult
    results = [None] * world
    errors = []

    def run(r):
        heal = r == healer
        q = _q(qcls, max_rank=None if heal else r,
               max_world_size=world - (healer is not None),
               replica_rank=r, replica_world_size=world, heal=False)
        # The JAX Manager's striped-heal advertisement would dial the
        # scripted store address; the port has no striped heal.
        extra = {} if mod is tmanager else {"heal_striped": False}
        m = _make(mod, comms[r], _client(q),
                  allreduce_bucket_bytes=bucket_bytes, **extra)
        try:
            m.step()
            if mod is tmanager:
                tree = {k: torch.tensor(v * (r + 1)) for k, v in TREE.items()}
            else:
                tree = {k: v * (r + 1) for k, v in TREE.items()}
            out = m.allreduce(tree).result(timeout=30)
            assert m.errored() is None, m.errored()
            assert m.should_commit()
            results[r] = {k: np.asarray(v) for k, v in out.items()}
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


@pytest.mark.parametrize("world,healer", [(2, None), (3, None), (3, 1)])
def test_allreduce_bitwise_equal_to_jax_manager(world, healer):
    port = _allreduce(tmanager, world, healer)
    jax_side = _allreduce(jmanager, world, healer)
    for r in range(world):
        for k in TREE:
            assert port[r][k].dtype == TREE[k].dtype
            assert port[r][k].tobytes() == jax_side[r][k].tobytes(), (r, k)
    # Exact math at world 2: (x + 2x) / 2.
    if world == 2:
        np.testing.assert_array_equal(port[0]["b"],
                                      (TREE["b"] * 3) / np.float32(2))


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
    comm = MagicMock()
    with pytest.raises(TypeError):
        _make(tmanager, comm, _client(_q()), shard_update=True)
    with pytest.raises(TypeError):
        _make(tmanager, comm, _client(_q()), policy=object())
    with pytest.raises(ValueError, match="overlap"):
        _make(tmanager, comm, _client(_q()), overlap_steps=1)


def test_bfloat16_gradients_are_refused():
    comm = MagicMock()
    comm.size.return_value = 2
    m = _make(tmanager, comm, _client(_q()))
    try:
        m.step()
        m.allreduce({"w": torch.ones(3, dtype=torch.bfloat16)})
        assert isinstance(m.errored(), TypeError)
    finally:
        m.shutdown()
