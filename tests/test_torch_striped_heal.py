"""The port's striped heal on the CPU, against the JAX package.

* The stripe partition (``_HealSession.stripes``) and the per-healer
  shuffle seed (``_stripe_seed``) equal the JAX package's on the same
  manifest and replica ids.
* A port healer stripes one transfer across two JAX
  ``CheckpointServer``s, and across port servers, to state bitwise equal
  to the donors'; every donor lands leaves.
* A donor that dies mid-stripe (chaos ``kill_after_bytes``) is evicted
  and only its remaining leaves move to the survivors; a donor that
  refuses its dial is dropped the same way (mirrors
  ``tests/test_shard.py`` and ``tests/test_chaos.py``).
* The Manager's quorum path: a healer with advertised donors stripes
  across them and reports ``heal_striped_donors``.
"""

from __future__ import annotations

import random
import urllib.parse
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torchft_tpu import checkpointing as jckpt
from torchft_tpu import manager as jmanager
from torchft_tpu import serialization as jser
from torchft_tpu_torch import chaos as tchaos
from torchft_tpu_torch import checkpointing as tckpt
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import serialization as tser
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.communicator import DummyCommunicator
from torch_fakes import fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port

# Twelve leaves of unequal sizes, numpy-seeded.
HEAL_STATE = {f"l{i:02d}": np.random.default_rng(50 + i)
              .normal(size=1024 * (1 + i % 5)).astype(np.float32)
              for i in range(12)}


def _target() -> dict:
    return {k: torch.zeros(v.shape, dtype=torch.float32)
            for k, v in HEAL_STATE.items()}


def _serve(cls, state, n):
    servers = [cls(lambda: state, bind_host="127.0.0.1") for _ in range(n)]
    for s in servers:
        s.allow_checkpoint(1)
    return servers


def _bitwise(out) -> None:
    for k, arr in HEAL_STATE.items():
        got = out[k]
        assert isinstance(got, torch.Tensor)
        assert got.numpy().tobytes() == arr.tobytes(), k


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_stripes_match_jax(n):
    """The same manifest, adopted by both packages' sessions, splits
    into the same contiguous byte-balanced stripes, before and after
    some leaves are committed."""
    mf = jckpt.build_manifest(jser.plan_pytree(HEAL_STATE), 1)
    assert tckpt.build_manifest(tser.plan_pytree(HEAL_STATE), 1) == mf
    tsess = tckpt._HealSession(HEAL_STATE, None)
    jsess = jckpt._HealSession(HEAL_STATE, None)
    tsess.adopt_manifest(mf)
    jsess.adopt_manifest(mf)
    assert tsess.stripes(n) == jsess.stripes(n)
    for i in (0, 3, 4):
        tsess.committed[i] = jsess.committed[i] = None
    assert tsess.stripes(n) == jsess.stripes(n)
    sizes = [int(e["nbytes"]) for e in mf["leaves"]]
    assert tser.balanced_ranges(sizes, n) == jser.balanced_ranges(sizes, n)


def test_stripe_seed_and_shuffle_match_jax():
    addrs = [f"http://127.0.0.1:{p}/checkpoint/1" for p in (11, 12, 13)]
    for rid in ("train_lm_1:0f3a", "g2", "healer-7"):
        seed = tmanager._stripe_seed(rid)
        assert seed == jmanager._stripe_seed(rid)
        a, b = list(addrs), list(addrs)
        random.Random(seed).shuffle(a)
        random.Random(jmanager._stripe_seed(rid)).shuffle(b)
        assert a == b


@pytest.mark.parametrize("donor_pkg", ["jax", "port"])
def test_port_healer_stripes_bitwise(donor_pkg):
    """A port healer fetches one transfer from every donor at once:
    JAX donors or port donors, state bitwise theirs."""
    cls = (jckpt.CheckpointServer if donor_pkg == "jax"
           else tckpt.CheckpointServer)
    n = 2 if donor_pkg == "jax" else 3
    servers = _serve(cls, HEAL_STATE, n)
    try:
        addrs = [s.address() for s in servers]
        stats: dict = {}
        out = tckpt.CheckpointServer.load_from_address(
            addrs[0], _target(), stats=stats, donor_addrs=addrs,
            stripe_seed=3)
        _bitwise(out)
        assert stats["donors_used"] == float(n), stats
        assert stats["attempts"] == 1.0
        assert stats["bytes_resumed"] == 0.0
        assert stats["stripe_donor_deaths"] == 0.0
        assert stats["bytes"] == sum(a.nbytes for a in HEAL_STATE.values())
    finally:
        for s in servers:
            s.shutdown()


def test_single_donor_set_is_the_plain_fetch():
    servers = _serve(tckpt.CheckpointServer, HEAL_STATE, 1)
    try:
        stats: dict = {}
        out = tckpt.CheckpointServer.load_from_address(
            servers[0].address(), _target(), stats=stats,
            donor_addrs=[servers[0].address()], stripe_seed=1)
        _bitwise(out)
        assert stats["donors_used"] == 1.0
    finally:
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("donor_pkg", ["jax", "port"])
def test_donor_killed_mid_stripe(donor_pkg):
    """A donor that dies after serving part of its stripe: its committed
    leaves stay committed, only its remaining stripe re-fetches from the
    survivors, no failover is spent, the state is bitwise."""
    cls = (jckpt.CheckpointServer if donor_pkg == "jax"
           else tckpt.CheckpointServer)
    servers = _serve(cls, HEAL_STATE, 3)
    try:
        addrs = [s.address() for s in servers]
        seed = 5
        # The healer's own shuffle: kill a donor that is not the
        # manifest's (the manifest donor dying is the failover path).
        shuffled = list(dict.fromkeys(addrs))
        random.Random(seed).shuffle(shuffled)
        netloc = urllib.parse.urlparse(shuffled[1]).netloc
        payload = sum(a.nbytes for a in HEAL_STATE.values())
        tchaos.install(tchaos.ChaosSchedule(seed=seed, endpoints={
            f"heal:{netloc}": tchaos.EndpointChaos(
                kill_after_bytes=payload // 8)}))
        try:
            stats: dict = {}
            out = tckpt.CheckpointServer.load_from_address(
                addrs[0], _target(), stats=stats, donor_addrs=addrs,
                stripe_seed=seed, stall_timeout_sec=10,
                retry_policy=tckpt.RetryPolicy(max_attempts=3))
        finally:
            tchaos.uninstall()
        _bitwise(out)
        assert stats["stripe_donor_deaths"] == 1.0, stats
        assert stats["donor_failovers"] == 0.0, stats
        assert 0 < stats["bytes_resumed"] < stats["payload_bytes"], stats
    finally:
        for s in servers:
            s.shutdown()


def test_refused_donor_reassigns_only_its_stripe():
    servers = _serve(tckpt.CheckpointServer, HEAL_STATE, 2)
    try:
        addrs = [s.address() for s in servers]
        dead = addrs[0].replace(
            f":{urllib.parse.urlparse(addrs[0]).port}", ":1")
        stats: dict = {}
        out = tckpt.CheckpointServer.load_from_address(
            addrs[0], _target(), stats=stats,
            donor_addrs=[addrs[0], dead, addrs[1]], stripe_seed=0,
            retry_policy=tckpt.RetryPolicy(max_attempts=3))
        _bitwise(out)
        assert stats["stripe_donor_deaths"] >= 1.0, stats
        assert 0 < stats["bytes_resumed"] < stats["payload_bytes"], stats
    finally:
        for s in servers:
            s.shutdown()


def test_manager_heal_stripes_across_advertised_donors():
    """The quorum path of a healer: the primary plus every donor that
    advertised this max_step, striped; ``heal_striped_donors`` says 3,
    the state is bitwise the donors'."""
    state = {"user": HEAL_STATE, "torchft": {"step": 4,
                                            "batches_committed": 8}}
    servers = _serve(tckpt.CheckpointServer, state, 3)
    for s in servers:
        s.allow_checkpoint(4)
    live = {k: torch.zeros(v.shape) for k, v in HEAL_STATE.items()}
    addrs = [s.address() for s in servers]
    client = MagicMock()
    client.quorum.return_value = QuorumResult(
        quorum_id=1, recover_manager_address="manager:1",
        store_address="s:1", max_step=4, max_rank=None, max_world_size=3,
        replica_rank=3, replica_world_size=4, heal=True)
    client.should_commit.return_value = True

    def load(s):
        for k, v in s.items():
            live[k].copy_(v)

    m = tmanager.Manager(comm=DummyCommunicator(), load_state_dict=load,
                         state_dict=lambda: live, min_replica_size=1,
                         _manager_client=client,
                         checkpoint_bind_host="127.0.0.1")
    store = m._store_client("s:1")
    for r, a in enumerate(addrs[1:], start=1):
        store.set(f"torchft/healset/{r}", f"4:{a}".encode())
    store.set("torchft/healset/0", b"3:http://stale:1/checkpoint/3")
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmanager, "_HEALSET_CATCH_UP_SEC", 0.1)
            mp.setattr(tmanager.Manager, "_resolve_checkpoint_addr",
                       lambda self, addr: addrs[0])
            m.step()
            m.wait_quorum()
            assert m.should_commit()
        for k, arr in HEAL_STATE.items():
            assert live[k].numpy().tobytes() == arr.tobytes()
        mx = m.metrics()
        assert mx["heal_striped_donors"] == 3.0
        assert mx["heal_count"] == 1.0
        assert m.current_step() == 4
        heal = [e for e in m.history() if e["event"] == "heal"]
        assert heal and heal[-1]["donors_used"] == 3.0
    finally:
        m.shutdown()
        for s in servers:
            s.shutdown()
