"""The port's sharded update (``Manager(shard_update=True)``) on the CPU,
over real socketpair rings with a scripted control plane: ``ShardedGrads``
geometry and round trip against the JAX package's on the same numpy tree;
``Manager.reduce_scatter`` stripes bitwise against the JAX Manager's under
every wire rung, their concatenation bitwise the port's allreduce; a latched
error's zero stripes and aborted vote; and the sharded update end to end —
bitwise the port's sync path, stripe state at 1/world, a reset on a
membership change, a healer landing on its donor, the heal payload's bytes
against the JAX trainer's, and JAX's sharded update with optax AdamW."""

from __future__ import annotations

import socket
import threading
import time
from unittest.mock import MagicMock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_manager import (RUNGS, TREE, _allreduce, _bytes, _client,
                                _make, _q, _rank_tree, _ring_comms,
                                _to_torch)

from torchft_tpu import manager as jmanager
from torchft_tpu import optim as joptim
from torchft_tpu import serialization as jser
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu.backends import host as jhost
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import serialization as tser
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.optim import FTOptimizer, init_adam_state
from torchft_tpu_torch.parallel.step import FTTrainer
from torchft_tpu_torch.utils import tree_flatten
from torch_fakes import fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port


def _run(mod, world, body, healer=None, rung="f32", bucket_bytes=1024,
         echo_vote=False, **extra):
    """``world`` thread-ranks of one package on a socketpair ring, each
    running ``body(manager, rank)`` on a Manager with a scripted quorum;
    rank ``healer`` sits out and contributes zeros. Returns each rank's
    result."""
    comms = _ring_comms(thost if mod is tmanager else jhost, world)
    qcls = QuorumResult if mod is tmanager else JQuorumResult
    port_kw, jax_kw, _ = RUNGS[rung]
    out: list = [None] * world
    errors: list = []

    def run(r):
        q = _q(qcls, max_rank=None if r == healer else r,
               max_world_size=world - (healer is not None),
               replica_rank=r, replica_world_size=world)
        client = _client(q)
        if echo_vote:
            client.should_commit.side_effect = \
                lambda **kw: kw["should_commit"]
        kw = dict(port_kw) if mod is tmanager else dict(jax_kw)
        kw.update(extra)
        m = _make(mod, comms[r], client, allreduce_bucket_bytes=bucket_bytes,
                  **kw)
        try:
            out[r] = body(m, r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            m.shutdown()

    ts = [threading.Thread(target=run, args=(r,), daemon=True)
          for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive(), "a rank hung"
    assert not errors, errors
    return out


# --------------------------------------------------------- ShardedGrads

GEOM_TREE = {
    "a": np.random.default_rng(3).standard_normal((33, 7)).astype(np.float32),
    "b": np.random.default_rng(4).standard_normal(301).astype(np.float32),
    "c": np.random.default_rng(5).standard_normal((2, 3)).astype(np.float32),
    "i": np.arange(10, dtype=np.int32),
}


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_grads_geometry_and_round_trip_match_jax(world):
    """On the same numpy tree and the same schedule, every rank's stripes
    of the params and its geometry key are the JAX ShardedGrads' bytes
    for bytes; assembling every rank's stripes gives the tree back."""
    metas = tuple((v.shape, str(v.dtype)) for _, v in sorted(
        GEOM_TREE.items()))
    tsched = tmanager._derive_schedule(metas, 512)
    jsched = jmanager._derive_schedule(metas, 512, None)
    assert tsched.fingerprint == jsched.fingerprint
    tchunks = [c for cs in tsched.chunks for c in cs]
    jchunks = [c for cs in jsched.chunks for c in cs]
    tparams = {k: torch.tensor(v) for k, v in GEOM_TREE.items()}
    jparams = {k: jnp.asarray(v) for k, v in GEOM_TREE.items()}
    tleaves, ttreedef = tree_flatten(tparams)
    jleaves, jtreedef = jax.tree_util.tree_flatten(jparams)
    gathered = []
    for rank in range(world):
        tsg = tmanager.ShardedGrads(tchunks, [], rank, world, tleaves,
                                    ttreedef)
        jsg = jmanager.ShardedGrads(jchunks, [], rank, world, jleaves,
                                    jtreedef)
        tstripes = tsg.param_shards(tparams)
        jstripes = jsg.param_shards(jparams)
        assert [_bytes(s) for s in tstripes] == [_bytes(s) for s in jstripes]
        tsg.shards, jsg.shards = tstripes, jstripes
        assert tsg.geometry_key() == jsg.geometry_key()
        gathered.append([s.clone() for s in tstripes])
    target = {k: torch.zeros_like(v) for k, v in tparams.items()}
    tsg.assemble_params(gathered, target)
    jout = jsg.assemble_params([[np.asarray(s) for s in g]
                                for g in gathered], jparams)
    for k, v in GEOM_TREE.items():
        assert target[k].numpy().tobytes() == v.tobytes(), k
        assert np.asarray(jout[k]).tobytes() == v.tobytes(), k
    with pytest.raises(ValueError, match="geometry"):
        tsg.assemble_params([g[:1] + [g[1][:-1]] + g[2:] for g in gathered],
                            target)


# --------------------------------------------------- Manager.reduce_scatter


def _rs_body(mod, rung, steps=2):
    def body(m, r):
        out = []
        for step in range(steps):
            m.step()
            tree = _rank_tree(r, step, rung)
            if mod is tmanager:
                tree = {k: _to_torch(v) for k, v in tree.items()}
            elif RUNGS[rung][2]:
                tree = {k: jnp.asarray(v) for k, v in tree.items()}
            sg = m.reduce_scatter(tree).result(timeout=30)
            assert m.errored() is None, m.errored()
            assert m.should_commit()
            out.append((sg.geometry_key(), [_bytes(s) for s in sg.shards],
                        [list(c.idx) for c in sg.chunks]))
        assert m.metrics()["reduce_scatter_count"] == steps
        return out
    return body


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("world,healer", [(2, None), (3, None), (3, 1)])
def test_reduce_scatter_bitwise_equal_to_jax_manager(world, healer, rung):
    """Each rank's stripes, two steps of each wire rung (int8's error
    feedback folds step 1's residual into step 2), port ranks against JAX
    ranks; the port's stripes concatenated over the ranks are the port's
    allreduce, byte for byte."""
    port = _run(tmanager, world, _rs_body(tmanager, rung), healer, rung)
    jax_side = _run(jmanager, world, _rs_body(jmanager, rung), healer, rung)
    for r in range(world):
        for step in range(2):
            assert port[r][step][:2] == jax_side[r][step][:2], (r, step)
    full = _allreduce(tmanager, world, healer, rung=rung)
    keys = sorted(TREE)
    for step in range(2):
        for k, idx in enumerate(port[0][step][2]):
            want = b"".join(full[0][step][keys[i]][1] for i in idx)
            got = b"".join(port[r][step][1][k][1] for r in range(world))
            assert got == want, (step, k)


def test_latched_error_gives_zero_stripes_and_aborts():
    """The ring dies under the reduce-scatter: the error latches, the
    result is zero stripes with the real geometry, the vote aborts, and
    the params and the stripe state stay untouched."""
    grads = {k: v for k, v in TREE.items() if v.dtype == np.float32}

    def body(m, r):
        m.step()
        m.wait_quorum()
        m._comm._ring.close()
        params = {k: torch.nn.Parameter(torch.tensor(v) + 1)
                  for k, v in grads.items()}
        before = {k: p.detach().clone() for k, p in params.items()}
        opt = FTOptimizer(m, torch.optim.AdamW(
            params.values(), lr=1e-2, foreach=False))
        sg = m.reduce_scatter({k: torch.tensor(v)
                               for k, v in grads.items()}).result(timeout=30)
        assert m.errored() is not None
        assert isinstance(sg, tmanager.ShardedGrads)
        assert all(not s.any() for s in sg.shards)
        assert not opt.apply(params, sg)
        for k, p in params.items():
            assert torch.equal(p.detach(), before[k]), k
        assert opt._shard_state is None
        assert m.metrics()["aborted_steps"] == 1
        return [s.numel() for s in sg.shards], [c.total for c in sg.chunks]

    out = _run(tmanager, 2, body, echo_vote=True, shard_update=True)
    for r, (sizes, totals) in enumerate(out):
        assert sizes == [int(np.diff(tmanager.shard_bounds(t, 2))[r])
                         for t in totals]


# ------------------------------------------------- sharded update, E2E

P0 = {"w": np.random.default_rng(7).standard_normal((37, 5)).astype(
    np.float32),
    "b": np.random.default_rng(8).standard_normal(113).astype(np.float32)}


def _grads(world, steps):
    rng = np.random.default_rng(42)
    return [[{k: rng.standard_normal(v.shape).astype(np.float32) * (r + 1)
              for k, v in P0.items()} for r in range(world)]
            for _ in range(steps)]


def _adamw(params, lr=1e-2):
    # The same configuration on both paths, foreach pinned.
    return torch.optim.AdamW(params, lr=lr, weight_decay=1e-4, eps=1e-8,
                             foreach=False)


def _train(world, shard, steps=3, rung="f32", on_step=None, lr=1e-2):
    grads = _grads(world, steps)

    def body(m, r):
        params = {k: torch.nn.Parameter(torch.tensor(v))
                  for k, v in P0.items()}
        opt = _adamw(params.values(), lr)
        if not shard:
            init_adam_state(opt)
        ft = FTOptimizer(m, opt)
        for s in range(steps):
            if on_step is not None and not on_step(m, r, s):
                break
            m.step()
            g = {k: torch.tensor(v) for k, v in grads[s][r].items()}
            fut = m.reduce_scatter(g) if shard else m.allreduce(g)
            assert ft.apply(params, fut.result(timeout=30))
            assert m.errored() is None, m.errored()
        return {"params": {k: p.detach().numpy().copy()
                           for k, p in params.items()},
                "state_bytes": ft.shard_state_bytes(),
                "opt_state": len(opt.state), "metrics": m.metrics()}

    return _run(tmanager, world, body, rung=rung, bucket_bytes=512,
                shard_update=shard)


@pytest.mark.parametrize("rung", ["f32", "bf16"])
@pytest.mark.parametrize("world", [2, 3])
def test_sharded_update_bitwise_equal_to_sync_path(world, rung):
    sync = _train(world, False, rung=rung)
    shard = _train(world, True, rung=rung)
    for r in range(world):
        for k in P0:
            assert (shard[r]["params"][k].tobytes()
                    == sync[0]["params"][k].tobytes()), (r, k)
        assert shard[r]["opt_state"] == 0  # no full AdamW state
        mx = shard[r]["metrics"]
        assert mx["update_count"] == 3 and mx["update_ms_total"] > 0
        assert mx["shard_state_resets"] == 0
        assert mx["shard_state_bytes"] == shard[r]["state_bytes"]


def test_stripe_state_is_a_world_share_of_the_full_state():
    shard = _train(2, True, steps=2)
    full = sum(2 * v.nbytes for v in P0.values())  # exp_avg + exp_avg_sq
    for r in range(2):
        got = shard[r]["state_bytes"]
        assert 0.45 * full < got < 0.55 * full, (got, full)


def test_membership_change_resets_stripe_state_on_every_rank():
    """Two steps at world 3, then rank 2 leaves and ranks 0 and 1 take a
    step on a new ring of two: every stripe moved, so both reset their
    stripe state once, and their params stay bitwise equal."""
    pairs = [socket.socketpair() for _ in range(2)]

    def on_step(m, r, s):
        if s < 2:
            return True
        if r == 2:
            return False
        m._comm._ring = thost._Ring(pairs[r][0], pairs[(r - 1) % 2][1],
                                    socket.socket())
        m._comm._world = 2
        m._client.quorum.return_value = _q(
            quorum_id=2, max_rank=r, max_world_size=2, replica_rank=r,
            replica_world_size=2)
        return True

    out = _train(3, True, steps=3, on_step=on_step)
    for r in (0, 1):
        assert out[r]["metrics"]["shard_state_resets"] == 1, r
        assert out[r]["metrics"]["update_count"] == 3
    assert out[2]["metrics"]["update_count"] == 2
    for k in P0:
        assert out[0]["params"][k].tobytes() == out[1]["params"][k].tobytes()


def test_sharded_update_matches_jax_sharded_update_with_optax_adamw():
    """The same gradients through JAX's sharded update (optax.adamw) and
    the port's (torch.optim.AdamW), world 2, three steps, with train_lm's
    hyperparameters: within test_adamw_step_matches_optax's tolerance,
    which holds the same two optimizers at the same hyperparameters."""
    grads = _grads(2, 3)

    def jbody(m, r):
        class Holder:
            params = {k: jnp.asarray(v) for k, v in P0.items()}
            opt_state = None

        opt = joptim.FTOptimizer(m, optax.adamw(3e-4), jit=False)
        h = Holder()
        for s in range(3):
            m.step()
            g = {k: jnp.asarray(v) for k, v in grads[s][r].items()}
            assert opt.apply(h, m.reduce_scatter(g).result(timeout=30))
        return {k: np.asarray(v) for k, v in h.params.items()}

    port = _train(2, True, lr=3e-4)
    jax_side = _run(jmanager, 2, jbody, bucket_bytes=512, shard_update=True)
    for r in range(2):
        for k in P0:
            np.testing.assert_allclose(port[r]["params"][k], jax_side[r][k],
                                       rtol=1e-6, atol=1e-7)


def test_plain_tree_in_shard_mode_uses_stripe_state():
    """A single-group step hands apply() the plain tree; it takes the
    world-1 stripe and keeps the one stripe state."""
    client = _client(_q(max_world_size=1, replica_world_size=1))
    comm = MagicMock()
    comm.size.return_value = 1
    m = _make(tmanager, comm, client, shard_update=True)
    try:
        params = {k: torch.nn.Parameter(torch.tensor(v))
                  for k, v in P0.items()}
        ft = FTOptimizer(m, torch.optim.SGD(params.values(), lr=0.1))
        m.step()
        g = {k: torch.tensor(v) for k, v in P0.items()}
        assert ft.apply(params, m.reduce_scatter(g).result(timeout=30))
        ref = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in P0.items()}
        sync = torch.optim.SGD(ref.values(), lr=0.1)
        for k, p in ref.items():
            p.grad = g[k]
        sync.step()
        for k, p in ref.items():
            assert torch.equal(params[k].detach(), p.detach()), k
        assert ft._shard_state is not None
        comm.allgather.assert_not_called()
    finally:
        m.shutdown()


# ------------------------------------------------- the sharded trainer


def _loss_fn(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def _batch(group, step):
    rng = np.random.default_rng(100 * group + step)
    return (torch.tensor(rng.standard_normal((8, 6)).astype(np.float32)),
            torch.tensor(rng.standard_normal((8, 3)).astype(np.float32)))


def _trainer(comm, client, shard, overlap=0):
    model = torch.nn.Linear(6, 3)
    with torch.no_grad():
        rng = np.random.default_rng(0)
        model.weight.copy_(torch.tensor(
            rng.standard_normal((3, 6)).astype(np.float32)))
        model.bias.copy_(torch.tensor(rng.standard_normal(3).astype(
            np.float32)))
    return FTTrainer(
        model=model, loss_fn=_loss_fn, optimizer=_adamw(model.parameters()),
        manager_factory=lambda load, save: tmanager.Manager(
            comm=comm, load_state_dict=load, state_dict=save,
            min_replica_size=1, _manager_client=client,
            checkpoint_bind_host="127.0.0.1", allreduce_bucket_bytes=32,
            shard_update=shard, overlap_steps=overlap))


def _run_trainers(trainers, steps, before=None):
    errors = []

    def run(r):
        try:
            for k in range(steps):
                if before is not None:
                    before(r, k)
                _, committed = trainers[r].train_step(_batch(r, k))
                assert committed
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=run, args=(r,), daemon=True)
          for r in range(len(trainers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive(), "a trainer hung"
    assert not errors, errors


def test_trainer_shard_loop_bitwise_equal_to_sync_loop():
    out = {}
    for shard in (False, True):
        comms = _ring_comms(thost, 2)
        trainers = [_trainer(comms[r], _client(_q(
            max_rank=r, replica_rank=r)), shard) for r in range(2)]
        try:
            _run_trainers(trainers, 3)
            out[shard] = [{k: p.detach().clone()
                           for k, p in t.params.items()} for t in trainers]
            if shard:
                for t in trainers:
                    assert t.state_dict()["opt_state"] is None
                    assert not t.optimizer.state
                    assert t.manager.metrics()["reduce_scatter_count"] == 3
        finally:
            for t in trainers:
                t.shutdown()
    for r in range(2):
        for k, p in out[False][0].items():
            assert torch.equal(out[True][r][k], p), (r, k)


def test_shard_heal_payload_serializes_like_the_jax_trainers():
    """In shard mode the heal payload is ``{"params", "opt_state": None}``,
    as the JAX trainer's; the port's serializer writes the same bytes as
    the JAX package's for the same values."""
    comm = MagicMock()
    comm.size.return_value = 1
    t = _trainer(comm, _client(_q()), shard=True)
    try:
        sd = t.state_dict()
        want = {"params": {k: np.asarray(p.detach().numpy())
                           for k, p in sd["params"].items()},
                "opt_state": None}
        assert tser.save_pytree(sd) == jser.save_pytree(want)
    finally:
        t.shutdown()


def _donor_address(donor: FTTrainer, step: int) -> str:
    """The donor's checkpoint URL once it serves ``step``: the scripted
    quorum does not wait for the donor to open its heal window, as the
    lighthouse's round does."""
    server = donor.manager._ckpt_server
    deadline = time.monotonic() + 20
    while not server.address().endswith(f"/{step}"):
        assert time.monotonic() < deadline, "the donor never served"
        time.sleep(0.005)
    return server.address()


def test_healer_lands_bitwise_on_donor_in_shard_mode():
    """Rank 1's params are scrambled before step 2, whose quorum makes it
    a healer of rank 0 (real HTTP fetch): it restores the params, its
    stripe update runs on them, and both ranks end bitwise equal."""
    heal_at, steps = 2, 3

    def quorums(r):
        out = []
        for s in range(1, steps + 1):
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
    trainers = [_trainer(comms[r], clients[r], shard=True) for r in range(2)]

    def scramble(r, k):
        if r == 1 and k + 1 == heal_at:
            with torch.no_grad():
                for p in trainers[1].params.values():
                    p.fill_(-3.0)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmanager.Manager, "_resolve_checkpoint_addr",
                       lambda self, addr: _donor_address(trainers[0],
                                                         heal_at))
            _run_trainers(trainers, steps, before=scramble)
        mx = trainers[1].manager.metrics()
        assert mx["heal_count"] == 1 and mx["heal_bytes_total"] > 0
        for k, p in trainers[0].params.items():
            assert torch.equal(p, trainers[1].params[k]), k
    finally:
        for t in trainers:
            t.shutdown()
