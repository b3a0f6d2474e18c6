"""The port's cross-step overlap engine (``Manager(overlap_steps=1)`` +
``DelayedOptimizer``) on the CPU: the deferred-commit state machine case by
case as the JAX package's ``TestDeferredStateMachine``; the overlap loop of
``FTTrainer`` at one group and at two over a socketpair ring, bitwise
against the one-step-shifted oracle computed with the port's sync ops;
through a mid-run heal over HTTP (the heal-generation recompute); a peer
dying mid-flight; overlap composed with ``shard_update``; ``train_lm``'s
``OVERLAP_STEPS``; and ``OptimizerWrapper``'s vote gate. Then the same
engine against the JAX package's on the same scripted control plane and
numpy data: the deferred protocol, the overlap loop with optax.adamw (one
group, two, a mid-run heal, a peer death) and the wrapper's vote gate."""

from __future__ import annotations

import json
import threading
from unittest.mock import MagicMock

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_manager import _client, _make, _q, _ring_comms
from test_torch_shard import _donor_address

from torchft_tpu import communicator as jcomm
from torchft_tpu import manager as jmanager
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu.backends import host as jhost
from torchft_tpu.optim import DelayedOptimizer as jDelayedOptimizer
from torchft_tpu.optim import OptimizerWrapper as jOptimizerWrapper
from torchft_tpu.parallel.step import FTTrainer as jFTTrainer
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import train_lm
from torchft_tpu_torch._native import Lighthouse, QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.communicator import DummyCommunicator
from torchft_tpu_torch.optim import DelayedOptimizer, OptimizerWrapper
from torchft_tpu_torch.parallel.step import FTTrainer
from torch_fakes import fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port


# ------------------------------------------------- deferred state machine


def _setup(commit=True, lr=1.0, comm=None):
    client = _client(_q(), commit=commit)
    m = _make(tmanager, comm or DummyCommunicator(), client,
              overlap_steps=1)
    params = {"g": torch.nn.Parameter(torch.tensor([2.0, 4.0]))}
    opt = DelayedOptimizer(m, torch.optim.SGD(params.values(), lr=lr))
    return m, opt, params, client


def test_settle_applies_at_next_boundary():
    m, opt, params, _ = _setup()
    try:
        opt.begin_step()
        opt.stage(params, m.allreduce({"g": torch.tensor([2.0, 4.0])}))
        assert opt.pending() and m.deferred_pending()
        assert m.deferred_step() == 1
        # Not applied yet: the update waits for the next boundary.
        assert params["g"].tolist() == [2.0, 4.0]
        assert opt.settle() is True
        # The dummy ring returns the input; n = 2 -> [1, 2]; sgd(1.0).
        assert params["g"].tolist() == [1.0, 2.0]
        assert not opt.pending() and not m.deferred_pending()
        opt.begin_step()
        assert m.current_step() == 2
    finally:
        m.shutdown()


def test_step_refuses_to_advance_over_unsettled_deferred():
    m, opt, params, _ = _setup()
    try:
        opt.begin_step()
        opt.stage(params, m.allreduce({"g": torch.zeros(2)}))
        with pytest.raises(RuntimeError, match="deferred"):
            m.step()
        with pytest.raises(RuntimeError, match="settle"):
            opt.stage(params, m.allreduce({"g": torch.zeros(2)}))
        opt.settle()
        m.step()
        assert m.current_step() == 2
    finally:
        m.shutdown()


def test_vote_abort_drops_stale_grads():
    m, opt, params, client = _setup(commit=False)
    try:
        opt.begin_step()
        opt.stage(params, m.allreduce({"g": torch.ones(2)}))
        assert opt.settle() is False
        assert params["g"].tolist() == [2.0, 4.0]  # dropped
        mx = m.metrics()
        assert mx["overlap_grads_dropped"] == 1 and mx["aborted_steps"] == 1
        client.should_commit.return_value = True
        opt.begin_step()
        assert m.current_step() == 1  # an abort does not advance
    finally:
        m.shutdown()


def test_latched_comm_error_drops_stale_grads():
    comm = DummyCommunicator()
    m, opt, params, _ = _setup(commit=False, comm=comm)
    try:
        opt.begin_step()
        comm.allreduce = MagicMock(side_effect=RuntimeError("boom"))
        opt.stage(params, m.allreduce({"g": torch.ones(2)}))
        assert m.errored() is not None  # latched while in flight
        assert opt.settle() is False
        assert params["g"].tolist() == [2.0, 4.0]
        assert m.metrics()["overlap_grads_dropped"] == 1
    finally:
        m.shutdown()


def test_flush_none_when_nothing_pending_and_shutdown_counts_a_drop():
    m, opt, params, _ = _setup()
    try:
        assert opt.flush() is None
        with pytest.raises(RuntimeError, match="no staged"):
            opt.settle()
        opt.begin_step()
        opt.stage(params, m.allreduce({"g": torch.ones(2)}))
    finally:
        m.shutdown()
    assert m.metrics()["overlap_grads_dropped"] == 1
    assert not m.deferred_pending()


def test_overlap_metrics_populate_and_inflight_drains():
    m, opt, params, _ = _setup()
    try:
        for _ in range(3):
            opt.flush()
            opt.begin_step()
            opt.stage(params, m.allreduce({"g": torch.ones(2)}))
        opt.flush()
        mx = m.metrics()
        assert mx["overlap_steps_deferred"] == 3
        assert mx["allreduce_hidden_ms_total"] >= 0.0
        assert mx["allreduce_drain_wait_ms_total"] >= 0.0
        assert mx["allreduce_inflight"] == 0
    finally:
        m.shutdown()


@pytest.mark.parametrize("depth,ok", [(0, True), (1, True), (2, False),
                                      (-1, False)])
def test_overlap_steps_validation(depth, ok):
    if not ok:
        with pytest.raises(ValueError, match="overlap_steps"):
            _make(tmanager, DummyCommunicator(), _client(_q()),
                  overlap_steps=depth)
        return
    m = _make(tmanager, DummyCommunicator(), _client(_q()),
              overlap_steps=depth)
    try:
        assert m.overlap_steps() == depth
        assert m.policy().overlap_steps == depth
    finally:
        m.shutdown()


def test_overlap_policy_is_accepted_and_sets_the_depth():
    from torchft_tpu_torch import policy as tpolicy

    m = _make(tmanager, DummyCommunicator(), _client(_q()),
              policy=tpolicy.POLICIES["overlap-f32"])
    try:
        assert m.overlap_steps() == 1
    finally:
        m.shutdown()


# ------------------------------------------------------ the overlap loop

K = 6


def _loss_fn(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def _batch(group, k):
    rng = np.random.default_rng(100 * group + k)
    return (torch.tensor(rng.standard_normal((8, 4)).astype(np.float32)),
            torch.tensor(rng.standard_normal((8, 2)).astype(np.float32)))


def _model():
    model = torch.nn.Linear(4, 2)
    with torch.no_grad():
        model.weight.copy_(torch.tensor(np.random.default_rng(1)
                                        .standard_normal((2, 4))
                                        .astype(np.float32)))
        model.bias.zero_()
    return model


def _opt(params):
    return torch.optim.AdamW(params, lr=0.05, weight_decay=1e-4, eps=1e-8,
                             foreach=False)


def _trainer(comm, client, overlap=1, shard=False, model=None,
             loss_fn=_loss_fn):
    model = model or _model()
    return FTTrainer(
        model=model, loss_fn=loss_fn, optimizer=_opt(model.parameters()),
        manager_factory=lambda load, save: tmanager.Manager(
            comm=comm, load_state_dict=load, state_dict=save,
            min_replica_size=1, _manager_client=client,
            checkpoint_bind_host="127.0.0.1", allreduce_bucket_bytes=16,
            overlap_steps=overlap, shard_update=shard))


def _grads_at(model, batch):
    model.zero_grad(set_to_none=True)
    _loss_fn(model, batch).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _shifted_oracle(groups, steps=K):
    """The delayed schedule, serially, with the port's sync ops: step k's
    gradients are taken at the params before step k-1's update, and the
    average of the groups' gradients applies one step later."""
    model = _model()
    opt = _opt(model.parameters())
    staged = None
    for k in range(steps):
        gs = [_grads_at(model, _batch(g, k)) for g in range(groups)]
        if staged is not None:
            for n, p in model.named_parameters():
                p.grad = staged[n]
            opt.step()
        staged = {n: (sum(g[n] for g in gs) / groups if groups > 1
                      else gs[0][n]) for n in gs[0]}
    for n, p in model.named_parameters():
        p.grad = staged[n]
    opt.step()
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_single_group_matches_shifted_oracle():
    comm = MagicMock()
    comm.size.return_value = 1
    tr = _trainer(comm, _client(_q(max_world_size=1, replica_world_size=1)))
    try:
        for k in range(K):
            tr.train_step(_batch(0, k))
        assert tr.flush() is True
        got = {n: p.detach().clone() for n, p in tr.params.items()}
    finally:
        tr.shutdown()
    want = _shifted_oracle(1)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    # The shifted schedule differs from the sync loop's.
    sync = _trainer(comm, _client(_q(max_world_size=1,
                                     replica_world_size=1)), overlap=0)
    try:
        for k in range(K):
            sync.train_step(_batch(0, k))
        assert not torch.equal(sync.params["weight"], got["weight"])
    finally:
        sync.shutdown()


def test_two_groups_ring_bitwise_vs_shifted_oracle():
    """Two groups on a socketpair ring, alternating on one thread: a
    settle drains an exchange both groups already started, so the loop
    never blocks inside an iteration."""
    comms = _ring_comms(thost, 2)
    trainers = [_trainer(comms[r], _client(_q(max_rank=r, replica_rank=r)))
                for r in range(2)]
    try:
        for k in range(K):
            for r in (0, 1):
                trainers[r].train_step(_batch(r, k))
        for t in trainers:
            assert t.flush() is True
        got = [{n: p.detach().clone() for n, p in t.params.items()}
               for t in trainers]
        mx = trainers[0].manager.metrics()
    finally:
        for t in trainers:
            t.shutdown()
    assert mx["overlap_steps_deferred"] == K
    assert mx["overlap_grads_dropped"] == 0
    want = _shifted_oracle(2)
    for n in want:
        assert torch.equal(got[0][n], got[1][n]), n
        assert torch.equal(got[0][n], want[n]), n


def test_bitwise_through_midrun_heal():
    """Group B is scrambled before step 3, whose quorum makes it a healer
    of A (a real HTTP fetch from A's live state). Its settle restores A's
    state and applies the received average, landing on A. The restore
    copies into B's params in place, so only the heal-generation counter
    tells the loop that its speculative gradients were taken at the
    scrambled params: B computes again at the restored ones, and both
    groups end bitwise equal."""
    heal_at = 3

    def quorums(r):
        out = []
        for s in range(1, K + 1):
            if s == heal_at:
                out.append(_q(max_rank=None if r else 0, max_world_size=1,
                              replica_rank=r, heal=r == 1, max_step=s))
            else:
                out.append(_q(max_rank=r, replica_rank=r, max_step=s))
        return out

    comms = _ring_comms(thost, 2)
    clients = []
    for r in range(2):
        c = MagicMock()
        c.quorum.side_effect = quorums(r)
        c.should_commit.return_value = True
        clients.append(c)
    calls = []

    def spy(model, batch):
        calls.append((it[0], float(sum(p.detach().sum()
                                       for p in model.parameters()))))
        return _loss_fn(model, batch)

    it = [0]
    ta = _trainer(comms[0], clients[0])
    tb = _trainer(comms[1], clients[1], loss_fn=spy)
    scramble = -9000.0
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmanager.Manager, "_resolve_checkpoint_addr",
                       lambda self, addr: _donor_address(ta, heal_at))
            for k in range(K):
                it[0] = k
                if k + 1 == heal_at:
                    with torch.no_grad():
                        for p in tb.params.values():
                            p.fill_(scramble)
                ta.train_step(_batch(0, k))
                tb.train_step(_batch(1, k))
            assert ta.flush() is True and tb.flush() is True
        mb = tb.manager.metrics()
        assert mb["heal_count"] == 1 and mb["heal_bytes_total"] > 0
        assert tb.heal_generation == 1
        for n, p in ta.params.items():
            assert torch.equal(p, tb.params[n]), n
    finally:
        ta.shutdown()
        tb.shutdown()
    # Iteration heal_at settles the healed step: its speculative forward
    # saw the scrambled params, the recompute the restored ones.
    settle_iter = [s for i, s in calls if i == heal_at]
    assert len(settle_iter) == 2, calls
    assert abs(settle_iter[0]) > 1000 and abs(settle_iter[1]) < 100, calls


def test_survivor_drops_stale_grads_when_peer_dies_mid_flight():
    """B dies while A's step 3 exchange is in flight: the error latches,
    the deferred vote aborts, and A keeps exactly its last settled
    params, poised to retry step 3."""
    comms = _ring_comms(thost, 2)
    client_a = _client(_q(max_rank=0, replica_rank=0))
    ta = _trainer(comms[0], client_a)
    tb = _trainer(comms[1], _client(_q(max_rank=1, replica_rank=1)))
    try:
        for k in range(2):
            ta.train_step(_batch(0, k))
            tb.train_step(_batch(1, k))
        ta.train_step(_batch(0, 2))
        settled = {n: p.detach().clone() for n, p in ta.params.items()}
        tb.manager.shutdown()
        client_a.should_commit.return_value = False
        assert ta.flush() is False
        assert ta.manager.errored() is not None
        for n, p in ta.params.items():
            assert torch.equal(p, settled[n]), n
        mx = ta.manager.metrics()
        assert mx["overlap_grads_dropped"] == 1 and mx["aborted_steps"] == 1
        assert ta.manager.current_step() == 3
    finally:
        ta.shutdown()


def test_overlap_composes_with_shard_update():
    """Overlap + the sharded update at world 2 lands bitwise on the
    overlap loop with the full update (the shifted oracle); each group's
    optimizer holds no full state."""
    comms = _ring_comms(thost, 2)
    trainers = [_trainer(comms[r], _client(_q(max_rank=r, replica_rank=r)),
                         shard=True) for r in range(2)]
    errors = []

    def run(r):
        try:
            for k in range(K):
                trainers[r].train_step(_batch(r, k))
            assert trainers[r].flush() is True
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    try:
        ts = [threading.Thread(target=run, args=(r,), daemon=True)
              for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive(), "a trainer hung"
        assert not errors, errors
        want = _shifted_oracle(2)
        for t in trainers:
            assert not t.optimizer.state
            mx = t.manager.metrics()
            assert mx["reduce_scatter_count"] == K
            assert mx["update_count"] == K
            for n, p in t.params.items():
                assert torch.equal(p, want[n]), n
    finally:
        for t in trainers:
            t.shutdown()


# ----------------------------------------------- train_lm, OptimizerWrapper


def test_train_lm_honours_overlap_steps(tmp_path, monkeypatch):
    """One tiny group under OVERLAP_STEPS=1: every step commits, the last
    is flushed before the final state hash, and the report carries the
    hidden and drain-wait walls per step."""
    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                    quorum_tick_ms=20)
    report = tmp_path / "report.json"
    env = {"REPLICA_GROUP_ID": "0", "NUM_REPLICA_GROUPS": "1",
           "TOTAL_STEPS": "3", "BATCH_SIZE": "2", "SEQ_LEN": "32",
           "MODEL": "tiny", "OVERLAP_STEPS": "1",
           "TORCHFT_LIGHTHOUSE": lh.address(), "DATA_DIR": str(tmp_path),
           "REPORT_FILE": str(report),
           "TORCHFT_CHECKPOINT_BIND": "127.0.0.1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        train_lm.main(["--device", "cpu"])
    finally:
        lh.shutdown()
    rep = json.loads(report.read_text())
    assert rep["overlap_steps"] == 1 and rep["step"] == 3
    assert rep["committed_steps"] == 3 and rep["aborted_steps"] == 0
    assert rep["overlap_grads_dropped"] == 0
    assert len(rep["hidden_ms"]) == len(rep["drain_wait_ms"]) == 3
    assert rep["state_hash"]


def test_optimizer_wrapper_applies_only_on_a_committed_vote():
    comm = MagicMock()
    comm.size.return_value = 1
    client = _client(_q(max_world_size=1, replica_world_size=1),
                     commit=False)
    m = _make(tmanager, comm, client)
    params = {"w": torch.nn.Parameter(torch.tensor([1.0, 2.0]))}
    opt = OptimizerWrapper(m, torch.optim.SGD(params.values(), lr=0.5),
                           params)
    try:
        opt.zero_grad()
        with pytest.raises(RuntimeError, match="grads"):
            opt.step()
        opt.grads = {"w": torch.tensor([2.0, 2.0])}
        assert opt.step() is False
        assert params["w"].tolist() == [1.0, 2.0]
        assert opt.grads is None
        client.should_commit.return_value = True
        opt.zero_grad()
        opt.grads = m.allreduce({"w": torch.tensor([2.0, 2.0])}).result()
        assert opt.step() is True
        assert params["w"].tolist() == [0.0, 1.0]
        sd = opt.state_dict()
        assert set(sd) == {"params", "opt_state"}
        opt.load_state_dict({"params": {"w": torch.tensor([5.0, 5.0])},
                             "opt_state": {"w": {}}})
        assert params["w"].tolist() == [5.0, 5.0]
    finally:
        m.shutdown()


# ------------------------------------------------ against the JAX package
#
# The same scripted control plane, the same numpy gradients and batches,
# through the JAX package's engine and the port's: the vote, drop and step
# sequence and the overlap counters must agree exactly, the params bitwise
# where both updates are exact (SGD at lr 0.5) and within
# test_adamw_step_matches_optax's tolerance under AdamW.

J_COUNTERS = ("overlap_steps_deferred", "overlap_grads_dropped",
              "aborted_steps", "committed_steps", "heal_count",
              "allreduce_inflight", "reduce_scatter_count",
              "update_count")


def _counters(m):
    mx = m.metrics()
    return {k: int(mx[k]) for k in J_COUNTERS}


def _np(tree):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


# step script -> (votes, step whose exchange raises, how the run ends)
DEFERRED_SCRIPTS = {
    "commits": ([True] * 4, None, "flush"),
    "abort_mid": ([True, False, True, True], None, "flush"),
    "abort_first": ([False, True, True], None, "flush"),
    "latched_error": ([True, False, True, True], 2, "flush"),
    "shutdown_drops_last": ([True, True, True], None, "shutdown"),
}


def _drive_deferred(mod, script):
    """Manager(overlap_steps=1) + DelayedOptimizer(SGD 0.5) of one
    package through a scripted vote sequence: settle, begin_step, stage,
    as the overlap loop does. Returns every observable of the protocol."""
    votes, error_step, end = DEFERRED_SCRIPTS[script]
    jax_side = mod is jmanager
    comm = (jcomm.DummyCommunicator() if jax_side
            else DummyCommunicator())
    client = _client(_q(JQuorumResult) if jax_side else _q())
    client.should_commit.side_effect = list(votes)
    m = _make(mod, comm, client, overlap_steps=1)
    p0 = np.asarray([2.0, 4.0], np.float32)
    if jax_side:
        opt = jDelayedOptimizer(m, optax.sgd(0.5))
        holder = _JHolder({"g": jnp.asarray(p0)}, None)
        holder.opt_state = opt.init(holder.params)
        target = holder
    else:
        params = {"g": torch.nn.Parameter(torch.tensor(p0))}
        opt = DelayedOptimizer(m, torch.optim.SGD(params.values(), lr=0.5))
        target = params
    rec = {"settled": [], "steps": [], "params": [], "errored": []}
    try:
        for i in range(len(votes)):
            if opt.pending():
                rec["settled"].append(opt.settle())
                rec["params"].append(_np(holder.params if jax_side
                                         else params)["g"].tobytes())
            opt.begin_step()
            rec["steps"].append(m.current_step())
            g = np.random.default_rng(i).standard_normal(2).astype(
                np.float32)
            saved = comm.allreduce
            if i + 1 == error_step:
                comm.allreduce = MagicMock(side_effect=RuntimeError("boom"))
            fut = m.allreduce({"g": g if jax_side else torch.tensor(g)})
            comm.allreduce = saved
            rec["errored"].append(m.errored() is not None)
            opt.stage(target, fut)
        if end == "flush":
            rec["settled"].append(opt.flush())
            rec["params"].append(_np(holder.params if jax_side
                                     else params)["g"].tobytes())
    finally:
        m.shutdown()
    # A step dropped at shutdown still finishes its put stage, which
    # clears the in-flight gauge: wait for it before reading the counters.
    fut.result(timeout=30)
    rec["counters"] = _counters(m)
    rec["deferred_pending"] = m.deferred_pending()
    return rec


@pytest.mark.parametrize("script", sorted(DEFERRED_SCRIPTS))
def test_deferred_protocol_matches_jax(script):
    """Every settle's vote, every step number, the latch, the params after
    every settle (bitwise) and the counters at the end are the JAX
    engine's."""
    want = _drive_deferred(jmanager, script)
    got = _drive_deferred(tmanager, script)
    assert got == want


J_LR = 1e-3  # see test_jax_tolerance_separates_the_two_schedules


def _j_params0():
    return {"weight": np.random.default_rng(1).standard_normal((2, 4))
            .astype(np.float32), "bias": np.zeros(2, np.float32)}


def _j_batch(group, k):
    x, y = _batch(group, k)
    return x.numpy(), y.numpy()


def _j_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["weight"].T + params["bias"] - y) ** 2)


def _t_loss(model, batch):
    x, y = batch
    return _loss_fn(model, (torch.from_numpy(x), torch.from_numpy(y)))


class _JHolder:
    def __init__(self, params, opt_state):
        self.params = params
        self.opt_state = opt_state


def _engine(mod, comm, client, overlap=1, shard=False):
    """One group's FTTrainer of either package: the linear model from
    ``_j_params0``, AdamW at J_LR with optax.adamw's hyperparameters."""
    jax_side = mod is jmanager

    def factory(load, save):
        return mod.Manager(
            comm=comm, load_state_dict=load, state_dict=save,
            min_replica_size=1, _manager_client=client,
            checkpoint_bind_host="127.0.0.1", allreduce_bucket_bytes=16,
            overlap_steps=overlap, shard_update=shard)

    if jax_side:
        return jFTTrainer(
            loss_fn=_j_loss,
            tx=optax.adamw(J_LR, b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=1e-4),
            params={k: jnp.asarray(v) for k, v in _j_params0().items()},
            manager_factory=factory)
    model = torch.nn.Linear(4, 2)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(_j_params0()[n]))
    return FTTrainer(
        model=model, loss_fn=_t_loss,
        optimizer=torch.optim.AdamW(model.parameters(), lr=J_LR,
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=1e-4, foreach=False),
        manager_factory=factory)


def _scramble(mod, tr, value):
    if mod is jmanager:
        tr.params = {k: v * 0 + value for k, v in tr.params.items()}
    else:
        with torch.no_grad():
            for p in tr.params.values():
                p.fill_(value)


def _loop_scenario(mod, scenario, overlap=1):
    """One of the overlap loop's scenarios on one package; returns each
    group's votes (every train_step's and the flush's), its counters, its
    step and its params."""
    jax_side = mod is jmanager
    qcls = JQuorumResult if jax_side else QuorumResult
    groups = 1 if scenario == "one_group" else 2
    if groups == 1:
        comm = MagicMock()
        comm.size.return_value = 1
        comms = [comm]
        clients = [_client(_q(qcls, max_world_size=1,
                              replica_world_size=1))]
    else:
        comms = _ring_comms(jhost if jax_side else thost, 2)
        clients = [_client(_q(qcls, max_rank=r, replica_rank=r))
                   for r in range(2)]
    heal_at = 3
    if scenario == "midrun_heal":
        for r, c in enumerate(clients):
            c.quorum.return_value = None
            c.quorum.side_effect = [
                _q(qcls, max_rank=None if r else 0, max_world_size=1,
                   replica_rank=r, heal=r == 1, max_step=s)
                if s == heal_at else
                _q(qcls, max_rank=r, replica_rank=r, max_step=s)
                for s in range(1, K + 1)]
    shard = scenario == "two_groups_shard"
    trainers = [_engine(mod, comms[r], clients[r], overlap=overlap,
                        shard=shard) for r in range(groups)]
    votes = [[] for _ in range(groups)]
    cls = jmanager.Manager if jax_side else tmanager.Manager
    try:
        if shard:
            # The stripe allgather blocks inside the settle: a thread each.
            errors = []

            def run(r):
                try:
                    for k in range(K):
                        votes[r].append(bool(
                            trainers[r].train_step(_j_batch(r, k))[1]))
                    votes[r].append(trainers[r].flush())
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)

            ts = [threading.Thread(target=run, args=(r,), daemon=True)
                  for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
                assert not t.is_alive(), "a trainer hung"
            assert not errors, errors
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cls, "_resolve_checkpoint_addr",
                       lambda self, addr: _donor_address(trainers[0],
                                                         heal_at))
            steps = {"peer_death": 2, "two_groups_shard": 0}.get(scenario,
                                                                 K)
            for k in range(steps):
                if scenario == "midrun_heal" and k + 1 == heal_at:
                    _scramble(mod, trainers[1], -9000.0)
                for r in range(groups):
                    votes[r].append(bool(
                        trainers[r].train_step(_j_batch(r, k))[1]))
            if scenario == "peer_death":
                # A stages step 3; B dies before contributing to it.
                votes[0].append(bool(trainers[0].train_step(
                    _j_batch(0, 2))[1]))
                trainers[1].manager.shutdown()
                clients[0].should_commit.return_value = False
                votes[0].append(trainers[0].flush())
                trainers = trainers[:1]
            elif not shard:
                for r in range(groups):
                    votes[r].append(trainers[r].flush())
        out = [{"votes": votes[r], "counters": _counters(t.manager),
                "step": t.manager.current_step(),
                "errored": t.manager.errored() is not None,
                "params": _np(t.params)} for r, t in enumerate(trainers)]
    finally:
        for t in trainers:
            t.shutdown()
    return out


LOOP_SCENARIOS = ["one_group", "two_groups", "midrun_heal", "peer_death",
                  "two_groups_shard"]


@pytest.mark.parametrize("scenario", LOOP_SCENARIOS)
def test_overlap_loop_matches_jax_trainer(scenario):
    """FTTrainer's overlap loop against the JAX FTTrainer's with
    optax.adamw: one group, two groups on a socketpair ring, a mid-run
    heal over HTTP (the healer's speculative gradients at its scrambled
    params must be recomputed, or its average is far off), a peer dying
    with the survivor's step in flight, and two groups under
    ``shard_update`` as well. The votes, the counters and
    the step agree exactly; the params within rtol 1e-6 / atol 1e-7."""
    want = _loop_scenario(jmanager, scenario)
    got = _loop_scenario(tmanager, scenario)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("votes", "counters", "step", "errored"):
            assert g[key] == w[key], (key, g[key], w[key])
        for n in w["params"]:
            np.testing.assert_allclose(g["params"][n], w["params"][n],
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    if scenario in ("two_groups", "midrun_heal", "two_groups_shard"):
        for n in got[0]["params"]:
            assert (got[0]["params"][n].tobytes()
                    == got[1]["params"][n].tobytes()), n


def test_jax_tolerance_separates_the_two_schedules():
    """The tolerance above can tell the loops apart: at J_LR the sync
    loop's params (gradients at the current params) fall outside it of
    the JAX overlap loop's (gradients one update behind)."""
    want = _loop_scenario(jmanager, "one_group")[0]["params"]
    sync = _loop_scenario(tmanager, "one_group", overlap=0)[0]["params"]
    assert any(not np.allclose(sync[n], want[n], rtol=1e-6, atol=1e-7)
               for n in want)


def _drive_wrapper(mod):
    """OptimizerWrapper over SGD 0.5 through the votes [False, True,
    True]: the returns, the params after each step (bytes) and the step
    numbers."""
    jax_side = mod is jmanager
    comm = MagicMock()
    comm.size.return_value = 1
    client = _client(_q(JQuorumResult, max_world_size=1,
                        replica_world_size=1) if jax_side
                     else _q(max_world_size=1, replica_world_size=1))
    client.should_commit.side_effect = [False, True, True]
    m = _make(mod, comm, client)
    p0 = np.asarray([1.0, 2.0], np.float32)
    if jax_side:
        opt = jOptimizerWrapper(m, optax.sgd(0.5), {"w": jnp.asarray(p0)})
    else:
        params = {"w": torch.nn.Parameter(torch.tensor(p0))}
        opt = OptimizerWrapper(m, torch.optim.SGD(params.values(), lr=0.5),
                               params)
    rec = []
    try:
        for i in range(3):
            opt.zero_grad()
            g = np.random.default_rng(i).standard_normal(2).astype(
                np.float32)
            opt.grads = m.allreduce(
                {"w": g if jax_side else torch.tensor(g)}).result()
            committed = opt.step()
            rec.append((committed, m.current_step(),
                        _np(opt.params)["w"].tobytes(), opt.grads is None))
    finally:
        m.shutdown()
    return rec, _counters(m)


def test_optimizer_wrapper_vote_gate_matches_jax():
    assert _drive_wrapper(tmanager) == _drive_wrapper(jmanager)
