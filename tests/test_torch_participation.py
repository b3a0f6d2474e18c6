"""The port's participation modes against the JAX package's: warm spares
(``WorldSizeMode.FIXED_WITH_SPARES``) and the synchronous quorum
(``use_async_quorum=False``), on scripted quorums with both packages'
Managers, over socketpair rings: the benched spare and a clamped
participant; a three-group spare run (an SGD trajectory bitwise the JAX
Managers', then the tiny model through ``FTTrainer``); a spare promoted
without a heal after a participant dies; a healer that restores inside
``step()`` and takes part in that step, through the sync, reduce-scatter
and overlap loops (the overlap loop's recompute at the restored params);
and the atomic ``participant_slot`` snapshot."""

from __future__ import annotations

import socket
import threading
import time
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch
from test_torch_manager import _client, _q
from test_torch_overlap import _batch, _loss_fn, _model, _opt
from test_torch_shard import _donor_address

from torchft_tpu import manager as jmanager
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu.backends import host as jhost
from torchft_tpu.communicator import DummyCommunicator as JDummy
from torchft_tpu_torch import WorldSizeMode
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.communicator import DummyCommunicator
from torchft_tpu_torch.models.transformer import (Transformer,
                                                  chunked_causal_lm_loss,
                                                  tiny_config)
from torchft_tpu_torch.parallel.step import FTTrainer
from torch_fakes import fake_quorum_stores, few_threads  # noqa: F401

pytestmark = pytest.mark.port

PKG = {"port": (tmanager, QuorumResult, DummyCommunicator, thost),
       "jax": (jmanager, JQuorumResult, JDummy, jhost)}


def _mode(mod, spares: bool):
    return (mod.WorldSizeMode.FIXED_WITH_SPARES if spares
            else mod.WorldSizeMode.DYNAMIC)


def _manager(pkg, client, comm=None, spares=False, **kw):
    mod, _q_cls, dummy, _host = PKG[pkg]
    return mod.Manager(
        comm=comm if comm is not None else dummy(),
        load_state_dict=kw.pop("load_state_dict", MagicMock()),
        state_dict=kw.pop("state_dict", lambda: {"w": np.ones(2)}),
        min_replica_size=kw.pop("min_replica_size", 2), rank=0,
        world_size=1, replica_id=kw.pop("replica_id", "part"),
        world_size_mode=_mode(mod, spares), _manager_client=client,
        checkpoint_bind_host="127.0.0.1", **kw)


def _tensor(pkg, arr):
    return torch.tensor(arr) if pkg == "port" else arr


# ------------------------------------------------------------------ spares


@pytest.mark.parametrize("case,rank,want,participating", [
    ("benched", 2, 0.0, False),      # 0 / 2: a zero contribution
    ("participant", 1, 3.0, True),   # 6 / 2, not 6 / 3
])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_spares_clamp_the_world(pkg, case, rank, want, participating):
    """``TestSpares``' two cases through each package's Manager: three
    groups at max_step, the world clamped to ``min_replica_size`` = 2;
    the group at replica rank 2 is the spare."""
    q_cls = PKG[pkg][1]
    client = _client(_q(q_cls, max_rank=rank, max_world_size=3,
                        replica_rank=rank, replica_world_size=3))
    m = _manager(pkg, client, spares=True)
    try:
        m.step()
        out = m.allreduce({"g": _tensor(pkg, np.array([6.0]))}).result()
        assert np.asarray(out["g"]).tolist() == [want]
        assert m.is_participating() is participating
        assert m.num_participants() == 2
        assert m.should_commit()
        assert client.should_commit.call_args.kwargs["should_commit"]
    finally:
        m.shutdown()


def _rings(mod, world):
    pairs = [socket.socketpair() for _ in range(world)]
    return [mod._Ring(pairs[r][0], pairs[(r - 1) % world][1],
                      socket.socket()) for r in range(world)]


def _quorum_comms(mod, n_groups, layouts):
    """One communicator per group whose ``configure`` takes the
    socketpair ring of the quorum named in its store prefix:
    ``layouts`` maps a quorum id to the groups in it, in replica-rank
    order."""
    rings = {qid: _rings(mod, len(groups)) for qid, groups in
             layouts.items()}

    class Wired(mod.HostCommunicator):
        def configure(self, store_addr, rank, world_size):
            qid = int(store_addr.split("/torchft/")[1].split("/")[0]
                      .split(".")[0])
            self._ring = rings[qid][rank]
            self._rank, self._world = rank, world_size

    return [Wired(timeout_sec=15) for _ in range(n_groups)]


SGD_LR = np.float32(0.125)
P0 = np.random.default_rng(7).standard_normal(1003).astype(np.float32)


def _grad(pkg, p, group, step):
    """A linear stand-in for a model's gradient, the same IEEE ops on
    torch and numpy."""
    if pkg == "port":
        return p * float(group + 1) - float(step)
    return p * np.float32(group + 1) - np.float32(step)


def _spare_run(pkg, kill_after=None):
    """Three groups, ``min_replica_size=2``, spares on; quorum 1 is
    (g0, g1, g2), so g2 is the spare. With ``kill_after=k``, g0 dies
    after step k and quorum 2 is (g1, g2) from step k + 1: g2 must take
    part without a heal. Each group takes SGD steps on its averaged
    gradient; returns per group, per step, (params bytes, participating,
    num_participants, heal_count, committed)."""
    mod, q_cls, _dummy, host = PKG[pkg]
    steps = 4
    layouts = {1: [0, 1, 2], 2: [1, 2]}
    comms = _quorum_comms(host, 3, layouts)
    out = [[] for _ in range(3)]
    errors = []
    barrier = threading.Barrier(3)

    def quorums(g):
        res = []
        for s in range(1, steps + 1):
            qid = 2 if kill_after is not None and s > kill_after else 1
            members = layouts[qid]
            if g not in members:
                break
            r = members.index(g)
            res.append(_q(q_cls, quorum_id=qid, max_step=s, max_rank=r,
                          max_world_size=len(members), replica_rank=r,
                          replica_world_size=len(members)))
        return res

    def run(g):
        client = MagicMock()
        client.quorum.side_effect = quorums(g)
        client.should_commit.return_value = True
        m = _manager(pkg, client, comm=comms[g], spares=True,
                     replica_id=f"spare{g}")
        p = torch.tensor(P0) if pkg == "port" else P0.copy()
        try:
            for s in range(1, steps + 1):
                if kill_after is not None and s > kill_after and g == 0:
                    break  # dead: out of quorum 2
                m.step()
                avg = m.allreduce({"g": _grad(pkg, p, g, s)}).result(
                    timeout=30)
                committed = m.should_commit()
                if committed:
                    p = p - SGD_LR * avg["g"]
                out[g].append((np.asarray(p).tobytes(),
                               m.is_participating(), m.num_participants(),
                               m.metrics()["heal_count"], committed))
                if kill_after is not None and s == kill_after:
                    barrier.wait(timeout=30)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
            barrier.abort()
        finally:
            m.shutdown()

    ts = [threading.Thread(target=run, args=(g,)) for g in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errors, errors
    return out


def test_three_group_spare_run_bitwise_equal_to_jax():
    """``TestSparesIntegration``'s run on a socketpair ring with both
    packages' Managers: the world stays clamped to 2, exactly one group
    (the spare) contributes nothing, every group — the spare too —
    applies the same average, and the port's params equal the JAX
    run's bit for bit at every step."""
    port, jax_side = _spare_run("port"), _spare_run("jax")
    assert port == jax_side
    for s in range(4):
        rows = [port[g][s] for g in range(3)]
        assert len({r[0] for r in rows}) == 1, s  # bitwise across groups
        assert [r[1] for r in rows] == [True, True, False]
        assert {r[2] for r in rows} == {2}
        assert all(r[4] for r in rows)
    # The average is the two participants' alone: (g0 + g1) / 2.
    p = P0.copy()
    for s in range(1, 5):
        g0, g1 = _grad("jax", p, 0, s), _grad("jax", p, 1, s)
        p = p - SGD_LR * ((g0 + g1) / np.float32(2))
    assert port[2][-1][0] == p.tobytes()


def test_spare_promoted_without_heal_after_a_death():
    """g0 dies after step 2; quorum 2 is (g1, g2): the spare takes
    replica rank 1 and contributes from step 3 on with its heal count
    unchanged, the step commits, and both survivors stay bitwise equal
    to each other and to the JAX Managers' run."""
    port, jax_side = (_spare_run("port", kill_after=2),
                      _spare_run("jax", kill_after=2))
    assert port == jax_side
    assert len(port[0]) == 2 and len(port[1]) == len(port[2]) == 4
    for s in range(4):
        assert port[1][s][0] == port[2][s][0], s
    spare = [row[1] for row in port[2]]
    assert spare == [False, False, True, True]
    assert all(row[3] == 0 for row in port[2])  # promoted, not healed
    assert all(row[4] for row in port[2])
    assert {row[2] for row in port[1] + port[2]} == {2}


@pytest.mark.usefixtures("few_threads")
def test_spare_run_through_the_trainer_on_the_tiny_model():
    """The three-group spare run with ``FTTrainer`` and the tiny
    Transformer: the participating world stays 2, one group ends benched,
    and the spare's params and AdamW state stay bitwise the
    participants'."""
    comms = _quorum_comms(thost, 3, {1: [0, 1, 2]})
    cfg = tiny_config(max_seq_len=32)
    results = [None] * 3
    errors = []

    def run(g):
        q = _q(max_rank=g, max_world_size=3, replica_rank=g,
               replica_world_size=3)
        client = _client(q)
        gen = torch.Generator().manual_seed(42)
        model = Transformer(cfg, device="cpu", generator=gen)
        trainer = FTTrainer(
            model=model, loss_fn=lambda m, b: chunked_causal_lm_loss(
                m(b, return_hidden=True), m.lm_head_kernel(), b),
            optimizer=torch.optim.AdamW(model.parameters(), lr=1e-2),
            manager_factory=lambda load, save: tmanager.Manager(
                comm=comms[g], load_state_dict=load, state_dict=save,
                min_replica_size=2,
                world_size_mode=WorldSizeMode.FIXED_WITH_SPARES,
                replica_id=f"tiny{g}", _manager_client=client,
                checkpoint_bind_host="127.0.0.1"))
        seen = set()
        try:
            for s in range(3):
                tokens = torch.tensor(np.random.default_rng(10 * g + s)
                                      .integers(0, cfg.vocab_size, (2, 16)))
                _loss, committed = trainer.train_step(tokens)
                assert committed
                seen.add(trainer.manager.num_participants())
            state = trainer.state_dict()
            results[g] = (
                {n: t.detach().clone() for n, t in state["params"].items()},
                {n: {k: v.clone() for k, v in st.items()}
                 for n, st in state["opt_state"].items()},
                seen, trainer.manager.is_participating())
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            trainer.shutdown()

    ts = [threading.Thread(target=run, args=(g,)) for g in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    assert [r[2] for r in results] == [{2}] * 3
    assert [r[3] for r in results] == [True, True, False]
    for params, opt_state, _, _ in results[1:]:
        for n, t in params.items():
            assert torch.equal(t, results[0][0][n]), n
        for n, st in opt_state.items():
            for k, v in st.items():
                assert torch.equal(v, results[0][1][n][k]), (n, k)


# ------------------------------------------------------------- sync quorum


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sync_heal_participates_immediately(pkg):
    """``TestManagerHealing``'s sync case through each package: the
    healer restores inside ``step()`` and takes part at once, with the
    replica world as its participant count."""
    mod, q_cls = PKG[pkg][:2]
    client = _client(_q(q_cls, quorum_id=1, max_step=5, max_rank=None,
                        max_world_size=1, replica_rank=1,
                        replica_world_size=2, heal=True))
    loaded = MagicMock()
    m = _manager(pkg, client, use_async_quorum=False, load_state_dict=loaded,
                 min_replica_size=1)
    state = {"user": {"w": np.zeros(1)},
             "torchft": {"step": 5, "batches_committed": 10}}
    try:
        with patch.object(mod.CheckpointServer, "load_from_address",
                          return_value=state), \
                patch.object(mod, "ManagerClient"):
            m.step()
        loaded.assert_called_once()
        assert m.is_participating() and not m.is_healing()
        assert m.num_participants() == 2
        assert m.current_step() == 5
        assert m.participant_slot()[:2] == (1, 10)
    finally:
        m.shutdown()


def _heal_quorums(r, steps, heal_at):
    out = []
    for s in range(1, steps + 1):
        out.append(_q(max_rank=r, replica_rank=r, max_step=s,
                      heal=(s == heal_at and r == 1)))
    return out


def _trainer_pair(loop, heal_at, steps, loss_b):
    comms = _quorum_comms(thost, 2, {1: [0, 1]})
    trainers = []
    for r in range(2):
        c = MagicMock()
        c.quorum.side_effect = _heal_quorums(r, steps, heal_at)
        c.should_commit.return_value = True
        model = _model()
        trainers.append(FTTrainer(
            model=model, loss_fn=loss_b if r else _loss_fn,
            optimizer=_opt(model.parameters()),
            manager_factory=lambda load, save, r=r, c=c: tmanager.Manager(
                comm=comms[r], load_state_dict=load, state_dict=save,
                min_replica_size=1, replica_id=f"sq{r}",
                _manager_client=c, checkpoint_bind_host="127.0.0.1",
                allreduce_bucket_bytes=16, use_async_quorum=False,
                overlap_steps=1 if loop == "overlap" else 0,
                shard_update=loop == "shard")))
    return trainers


SCRAMBLE = -9000.0


@pytest.mark.parametrize("loop", ["sync", "shard"])
def test_sync_quorum_healer_contributes_in_its_heal_step(loop):
    """The sync and reduce-scatter loops draw and compute after
    ``step()``, where a sync healer has already restored: B, scrambled
    before the heal step, computes at the restored params, takes part
    (rank 1 of 2) in that very step and ends bitwise equal to A."""
    heal_at, steps = 2, 3
    calls = []

    def spy(model, batch):
        calls.append((tb.manager.current_step(),
                      tb.manager.is_participating(),
                      float(sum(p.detach().sum()
                                for p in model.parameters()))))
        return _loss_fn(model, batch)

    ta, tb = _trainer_pair(loop, heal_at, steps, spy)
    threads_err = []

    def run_a():
        try:
            for k in range(steps):
                ta.train_step(_batch(0, k))
        except Exception as e:  # noqa: BLE001
            threads_err.append(e)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmanager.Manager, "_resolve_checkpoint_addr",
                       lambda self, addr: _donor_address(ta, heal_at))
            t = threading.Thread(target=run_a)
            t.start()
            for k in range(steps):
                if k + 1 == heal_at:
                    with torch.no_grad():
                        for p in tb.params.values():
                            p.fill_(SCRAMBLE)
                tb.train_step(_batch(1, k))
            t.join(timeout=60)
        assert not threads_err, threads_err
        mb = tb.manager.metrics()
        assert mb["heal_count"] == 1 and mb["heal_bytes_total"] > 0
        for n, p in ta.params.items():
            assert torch.equal(p, tb.params[n]), n
    finally:
        ta.shutdown()
        tb.shutdown()
    step, participating, total = calls[heal_at - 1]
    assert step == heal_at and participating, calls
    assert abs(total) < 100, calls  # computed at the restored params


def test_sync_quorum_heal_recomputes_in_the_overlap_loop():
    """``test_overlap.py::test_sync_quorum_heal_recomputes_at_restored_
    params``: under the sync quorum the restore lands inside ``step()``
    and clears the healing flag there, after the overlap loop's
    speculative forward and backward — the heal generation read after
    ``step()`` must force the recompute, or the healer would contribute
    gradients of its scrambled params as a full participant."""
    heal_at, steps = 3, 5
    calls = []
    it = [0]

    def spy(model, batch):
        calls.append((it[0], float(sum(p.detach().sum()
                                       for p in model.parameters()))))
        return _loss_fn(model, batch)

    ta, tb = _trainer_pair("overlap", heal_at, steps, spy)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmanager.Manager, "_resolve_checkpoint_addr",
                       lambda self, addr: _donor_address(ta, heal_at))
            for k in range(steps):
                it[0] = k
                if k + 1 == heal_at:
                    with torch.no_grad():
                        for p in tb.params.values():
                            p.fill_(SCRAMBLE)
                ta.train_step(_batch(0, k))
                tb.train_step(_batch(1, k))
            assert ta.flush() is True and tb.flush() is True
        assert tb.manager.metrics()["heal_count"] == 1
        assert tb.heal_generation == 1
        for n, p in ta.params.items():
            assert torch.equal(p, tb.params[n]), n
    finally:
        ta.shutdown()
        tb.shutdown()
    heal_iter = [s for i, s in calls if i == heal_at - 1]
    # The speculative forward saw the scrambled params, the recompute
    # (the gradients contributed) the restored ones.
    assert len(heal_iter) == 2, calls
    assert abs(heal_iter[0]) > 1000 and abs(heal_iter[1]) < 100, calls


# ------------------------------------------------------ participant slot


def _slot_manager(client=None):
    if client is None:
        client = _client(_q(max_world_size=1, replica_world_size=1))
    return tmanager.Manager(
        comm=DummyCommunicator(), load_state_dict=MagicMock(),
        state_dict=lambda: {"w": np.ones(2)}, min_replica_size=1,
        replica_id="slot", degraded_mode=True, _manager_client=client,
        checkpoint_bind_host="127.0.0.1")


def test_participant_slot_is_atomic():
    """``test_degraded.py``'s regression: rank and fraction are one
    lock-consistent snapshot, never the new fraction with the old rank
    or the reverse."""
    m = _slot_manager()
    stop = threading.Event()

    def writer():
        flip = False
        while not stop.is_set():
            with m._metrics_lock:
                if flip:
                    m._participating_rank = 1
                    m._capacity_fraction = 0.5
                else:
                    m._participating_rank = 0
                    m._capacity_fraction = 1.0
            flip = not flip

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(3_000):
            rank, _bc, frac = m.participant_slot()
            assert (rank, frac) in ((0, 1.0), (1, 0.5)), (rank, frac)
    finally:
        stop.set()
        t.join(timeout=5)
        m.shutdown()


def test_participant_slot_joins_the_inflight_quorum():
    """A draw between ``step()`` and the quorum's answer reflects the
    new membership, never the previous round's rank."""
    client = MagicMock()

    def slow_quorum(**_kw):
        time.sleep(0.3)
        return _q(max_rank=1, replica_rank=1, max_world_size=2,
                  replica_world_size=2)

    client.quorum.side_effect = slow_quorum
    client.should_commit.return_value = True
    m = _slot_manager(client)
    try:
        m.step()
        rank, committed, frac = m.participant_slot()
        assert (rank, committed, frac) == (1, 0, 1.0)
    finally:
        m.shutdown()
