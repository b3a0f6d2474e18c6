"""The port's degraded capacity and rebalance adoption against the JAX
package's Manager, on scripted quorums: the capacity lifecycle (refusal
classes, counters, events, flight dumps, the store advertisement); the
weighted fold over socketpair rings, bitwise the JAX Managers' at f32 and
int8 (participants, a healer and a spare at weight 0) and, for bf16, held
to a float64 oracle (the JAX package floor-divides that case, ROADMAP
C4); rebalance adoption (deferred by each refusal class, coordinated
through the quorum store, a follower catching up after a missed read, a
departed group's entry dropped, capacity times rebalance in one
snapshot, the digest's one-boundary lag); the sampler's fraction draws;
the composed-fraction fold; and the chaos ``slow`` band."""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import Future
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch
from test_torch_manager import RUNGS, _bytes, _client, _q, _ring_comms

from torchft_tpu import chaos as jchaos
from torchft_tpu import data as jdata
from torchft_tpu import manager as jmanager
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu.backends import host as jhost
from torchft_tpu.communicator import DummyCommunicator as JDummy
from torchft_tpu_torch import chaos as tchaos
from torchft_tpu_torch import data as tdata
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.communicator import DummyCommunicator, bf16_to_f32
from torch_fakes import FakeStore, fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port

PKG = {"port": (tmanager, QuorumResult, DummyCommunicator, thost),
       "jax": (jmanager, JQuorumResult, JDummy, jhost)}


def _manager(pkg, client=None, comm=None, **kw):
    mod, q_cls, dummy, _host = PKG[pkg]
    if client is None:
        client = _client(_q(q_cls, max_world_size=1, replica_world_size=1,
                            store_address=""))
    return mod.Manager(
        comm=comm if comm is not None else dummy(),
        load_state_dict=kw.pop("load_state_dict", MagicMock()),
        state_dict=kw.pop("state_dict", lambda: {"w": np.ones(2)}),
        min_replica_size=kw.pop("min_replica_size", 1), rank=0,
        world_size=1, replica_id=kw.pop("replica_id", "cap"),
        degraded_mode=kw.pop("degraded_mode", True),
        _manager_client=client, checkpoint_bind_host="127.0.0.1", **kw)


def _boundary(pkg, m, tree=None):
    """One step / allreduce / vote boundary; returns the vote."""
    m.step()
    g = np.ones(4, np.float32)
    m.allreduce(tree if tree is not None else
                {"g": torch.tensor(g) if pkg == "port" else g}).result()
    return m.should_commit()


def _events(m):
    return [e.get("event") for e in m.history()]


both = pytest.mark.parametrize("pkg", ["port", "jax"])


# ------------------------------------------------------- capacity lifecycle


@both
def test_degrade_needs_degraded_mode(pkg):
    m = _manager(pkg, degraded_mode=False)
    try:
        with pytest.raises(RuntimeError, match="degraded_mode"):
            m.request_degrade(0.5)
        with pytest.raises(RuntimeError, match="degraded_mode"):
            m.request_restore()
    finally:
        m.shutdown()


@both
def test_fraction_validation(pkg):
    m = _manager(pkg)
    try:
        for bad in (0.0, 1.5, -0.25):
            with pytest.raises(ValueError, match="fraction"):
                m.request_degrade(bad)
    finally:
        m.shutdown()


@both
def test_degrade_restore_counters_and_events(pkg):
    m = _manager(pkg)
    try:
        assert m.degraded_mode()
        assert m.request_degrade(0.5, samples=16)
        assert m.capacity_fraction() == 0.5
        mx = m.metrics()
        assert mx["degraded_capacity_fraction"] == 0.5
        assert mx["degrade_events_total"] == 1
        assert m._wire_weight() == 16
        assert m.request_restore()
        mx = m.metrics()
        assert (mx["degraded_capacity_fraction"],
                mx["restore_events_total"]) == (1.0, 1)
        assert {"degrade", "restore"} <= set(_events(m))
    finally:
        m.shutdown()


@both
def test_refused_mid_deferred_mid_heal_and_errored(pkg):
    m = _manager(pkg)
    try:
        f = Future()
        f.set_result({"g": np.zeros(2)})
        m.stage_deferred(f)
        assert not m.request_degrade(0.5)
        m.drain_deferred()
        with m._metrics_lock:
            m._healing = True
        assert not m.request_degrade(0.5)
        with m._metrics_lock:
            m._healing = False
        m.report_error(RuntimeError("boom"))
        assert not m.request_restore()
        assert m.capacity_fraction() == 1.0
        refused = [e for e in _events(m) if str(e).endswith("_refused")]
        assert refused == ["degrade_refused", "degrade_refused",
                           "restore_refused"]
    finally:
        m.shutdown()


def test_flight_dump_on_every_capacity_transition(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHFT_FLIGHT_DIR", str(tmp_path))
    m = _manager("port", replica_id="cap0")
    try:
        _boundary("port", m)
        assert m.request_degrade(0.5)
        assert m.request_restore()
        files = sorted(os.listdir(tmp_path))
        assert any("degrade" in f for f in files), files
        assert any("restore" in f for f in files), files
        body = json.loads((tmp_path / next(
            f for f in files if "degrade" in f)).read_text())
        assert body["torchft"]["extra"]["to"] == 0.5
        assert body["traceEvents"] is not None
    finally:
        m.shutdown()


@both
def test_capacity_advertised_on_quorum_store(pkg, fake_quorum_stores):
    q_cls = PKG[pkg][1]
    client = _client(_q(q_cls, store_address=f"{pkg}:0", max_world_size=2,
                        replica_world_size=2, replica_rank=1, max_rank=1))
    m = _manager(pkg, client)
    try:
        m.request_degrade(0.25)
        m.step()
        m.wait_quorum()
        store = fake_quorum_stores[f"{pkg}:0"]
        assert store.kv["torchft/capacity/1"] == \
            f"{m.current_step()}:0.25".encode()
    finally:
        m.shutdown()


@both
def test_wire_weight_zero_for_a_healer_and_a_spare(pkg):
    """A zero contribution carries zero weight: while healing, and when
    benched as a spare."""
    mod, q_cls = PKG[pkg][:2]
    m = _manager(pkg)
    try:
        m.request_degrade(0.5, samples=24)
        assert m._wire_weight() == 24
        with m._metrics_lock:
            m._healing = True
        assert m._wire_weight() == 0
    finally:
        m.shutdown()
    client = _client(_q(q_cls, max_rank=2, max_world_size=3, replica_rank=2,
                        replica_world_size=3))
    m = _manager(pkg, client, min_replica_size=2,
                 world_size_mode=mod.WorldSizeMode.FIXED_WITH_SPARES)
    try:
        m.step()
        m.wait_quorum()
        m.set_step_samples(8)
        assert not m.is_participating() and m._wire_weight() == 0
    finally:
        m.shutdown()


# -------------------------------------------------------- the weighted fold

TREE = {
    "a": np.random.default_rng(0).standard_normal((257, 3)).astype(
        np.float32),
    "b": np.random.default_rng(1).standard_normal(1000).astype(np.float32),
}


def _grads(r, step):
    return {k: v * np.float32(r + 1) - np.float32(step)
            for k, v in TREE.items()}


def _weighted_run(pkg, world, weights, rung="f32", healer=None,
                  spares=False, rebalance=False, degraded=True, steps=2):
    """Every rank of one package: ``steps`` x (step, report its samples,
    allreduce, vote), weighted fold armed. ``healer`` sits out (max_rank
    None); with ``spares`` the world is clamped to 2. Returns each rank's
    reduced trees as (dtype, bytes) leaves, and the wire weights."""
    mod, q_cls, _dummy, host = PKG[pkg]
    port_kw, jax_kw, jax_device = RUNGS[rung]
    comms = _ring_comms(host, world)
    results = [[] for _ in range(world)]
    wire = [[] for _ in range(world)]
    errors = []

    def run(r):
        heal = r == healer
        q = _q(q_cls, max_rank=None if heal else r,
               max_world_size=world - (healer is not None),
               replica_rank=r, replica_world_size=world)
        extra = dict(port_kw if pkg == "port" else jax_kw)
        if spares:
            extra["world_size_mode"] = mod.WorldSizeMode.FIXED_WITH_SPARES
        m = _manager(pkg, _client(q), comm=comms[r],
                     min_replica_size=2 if spares else 1,
                     allreduce_bucket_bytes=1024, degraded_mode=degraded,
                     rebalance=rebalance, replica_id=f"w{r}", **extra)
        try:
            for step in range(steps):
                m.step()
                m.set_step_samples(weights[r])
                tree = _grads(r, step)
                if pkg == "port":
                    tree = {k: torch.tensor(v) for k, v in tree.items()}
                elif jax_device:
                    import jax.numpy as jnp
                    tree = {k: jnp.asarray(v) for k, v in tree.items()}
                out = m.allreduce(tree).result(timeout=30)
                wire[r].append(m._wire_weight())
                assert m.errored() is None, m.errored()
                assert m.should_commit()
                results[r].append({k: _bytes(v) for k, v in out.items()})
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            m.shutdown()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errors, errors
    return results, wire


def weighted_oracle(xs, weights, dtype=np.float32):
    """Σ w_r x_r in rank order over the nonzero weights, divided by Σ w_r
    (the JAX package's ``tests/test_degraded.py`` oracle)."""
    dt = np.dtype(dtype)
    acc = np.zeros(np.ravel(xs[0]).size, dt)
    for w, x in zip(weights, xs):
        if w:
            acc += np.ravel(x).astype(dt) * dt.type(w)
    if sum(weights):
        acc /= dt.type(sum(weights))
    return acc


@pytest.mark.parametrize("rung", ["f32", "int8_device", "int8_host"])
@pytest.mark.parametrize("world,weights,healer,spares", [
    (2, [48, 16], None, False),   # the 3:1 skew
    (3, [5, 2, 1], None, False),
    (3, [5, 2, 1], 1, False),     # a healer: weight 0
    (3, [5, 2, 1], None, True),   # a spare: weight 0
])
def test_weighted_fold_bitwise_equal_to_jax_manager(world, weights, healer,
                                                    spares, rung):
    """``TestManagerWeightedPipeline`` on a socketpair ring with both
    packages' Managers: every rank resolves to the same bytes, the port's
    equal the JAX Managers', and the Manager does not divide again by the
    participant count (the f32 rung against the numpy oracle)."""
    port, pw = _weighted_run("port", world, weights, rung, healer, spares)
    jax_side, jw = _weighted_run("jax", world, weights, rung, healer,
                                 spares)
    assert port == jax_side
    assert pw == jw
    zero = {healer} if healer is not None else ({2} if spares else set())
    for r in range(world):
        assert pw[r] == [0 if r in zero else weights[r]] * 2, pw
        assert port[r] == port[0], r
    if rung == "f32":
        eff = [0 if r in zero else w for r, w in enumerate(weights)]
        for step in range(2):
            for k in TREE:
                want = weighted_oracle(
                    [_grads(r, step)[k] for r in range(world)], eff)
                assert port[0][step][k] == ("f4", want.tobytes()), (step, k)


def test_weighted_fold_bf16_against_a_float64_oracle():
    """The bf16 rung (the JAX package floor-divides its weighted case,
    ROADMAP C4, so it is no oracle here): each contribution is rounded to
    bf16 once and the fold runs in float32, so the result stays within
    float32 rounding of Σ w_r bf16(x_r) / Σ w_r computed in float64."""
    weights = [5, 2, 1]
    port, _ = _weighted_run("port", 3, weights, "bf16")
    from torchft_tpu_torch.communicator import f32_to_bf16
    for step in range(2):
        for k in TREE:
            xs = [bf16_to_f32(f32_to_bf16(_grads(r, step)[k]))
                  .astype(np.float64).ravel() for r in range(3)]
            want = sum(w * x for w, x in zip(weights, xs)) / sum(weights)
            got = np.frombuffer(port[0][step][k][1], np.float32)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < 1e-6, (step, k, err)
            assert port[1][step][k] == port[0][step][k]


def test_rebalance_alone_divides_by_the_weight_once():
    """With rebalance armed and degraded mode off the fold is weighted
    all the same, and the port divides by the total weight alone. The
    JAX Manager divides that weighted mean again by the participant
    count (ROADMAP C11); this pins the difference."""
    weights = [48, 16]
    port, _ = _weighted_run("port", 2, weights, rebalance=True,
                            degraded=False)
    jax_side, _ = _weighted_run("jax", 2, weights, rebalance=True,
                                degraded=False)
    for k in TREE:
        want = weighted_oracle([_grads(r, 0)[k] for r in range(2)], weights)
        assert port[0][0][k] == ("f4", want.tobytes()), k
        assert jax_side[0][0][k] == (
            "f4", (want / np.float32(2)).tobytes()), k


# ------------------------------------------------------- rebalance adoption


def _reb_manager(pkg, store="", rank=0, world=1, comm=None, **kw):
    q_cls = PKG[pkg][1]
    q = _q(q_cls, store_address=store, max_rank=rank, replica_rank=rank,
           max_world_size=world, replica_world_size=world)
    kw.setdefault("degraded_mode", False)
    kw.setdefault("rebalance", True)
    return _manager(pkg, _client(q), comm=comm, **kw)


def _set_table(m, table, store="", rank=0, world=1, pkg="port"):
    """The next rounds' hint carries ``table`` (None: no table field, as
    from a control plane that predates rebalance)."""
    q_cls = PKG[pkg][1]
    q = _q(q_cls, store_address=store, max_rank=rank, replica_rank=rank,
           max_world_size=world, replica_world_size=world)
    q.rebalance_table = table
    m._client.quorum.return_value = q


@both
def test_rebalance_off_by_default_is_inert(pkg):
    m = _reb_manager(pkg, replica_id="off", rebalance=False)
    _set_table(m, "off=0.5000", pkg=pkg)
    try:
        _boundary(pkg, m)
        assert not m.rebalance_enabled()
        assert m.rebalance_fraction() == 1.0
        mx = m.metrics()
        assert (mx["rebalance_fraction"],
                mx["rebalance_adoptions_total"]) == (1.0, 0)
    finally:
        m.shutdown()


@both
def test_device_array_comm_rejected_at_build(pkg):
    dummy = PKG[pkg][2]

    class DeviceComm(dummy):
        wants_device_arrays = True

    with pytest.raises(ValueError, match="host-path"):
        _manager(pkg, comm=DeviceComm(), rebalance=True, degraded_mode=False)


@both
def test_uncoordinated_adoption_and_restore(pkg):
    """A storeless run adopts from its own hint's table; an entry that
    leaves the table is the restore to 1.0; a missing table field (an
    older control plane) is inert, not a restore."""
    m = _reb_manager(pkg, replica_id="solo")
    try:
        _set_table(m, "solo=0.7500", pkg=pkg)
        _boundary(pkg, m)
        assert m.rebalance_fraction() == 0.75
        assert m.participant_slot()[2] == 0.75
        _set_table(m, None, pkg=pkg)
        _boundary(pkg, m)
        assert m.rebalance_fraction() == 0.75  # sticky, no restore
        _set_table(m, "", pkg=pkg)
        _boundary(pkg, m)
        assert m.rebalance_fraction() == 1.0
        mx = m.metrics()
        assert (mx["rebalance_fraction"],
                mx["rebalance_adoptions_total"]) == (1.0, 2)
        assert _events(m).count("rebalance_adopt") == 2
    finally:
        m.shutdown()


@both
@pytest.mark.parametrize("refusal", ["errored", "healing", "deferred"])
def test_adoption_deferred_by_each_refusal_class(pkg, refusal):
    m = _reb_manager(pkg, replica_id="defer")
    try:
        _set_table(m, "defer=0.6250", pkg=pkg)
        m.step()
        m.wait_quorum()
        f = None
        if refusal == "errored":
            m.report_error(RuntimeError("injected"))
        elif refusal == "healing":
            with m._metrics_lock:
                m._healing = True
        else:
            f = Future()
            m.stage_deferred(f)
        m._rebalance_post_vote()
        assert m.rebalance_fraction() == 1.0
        assert m.metrics()["rebalance_deferred_total"] == 1
        assert "rebalance_deferred" in _events(m)
        if f is not None:
            f.set_result({})
            m.drain_deferred()
        with m._metrics_lock:
            m._healing = False
        m._errored = None
        m._rebalance_post_vote()  # the next boundary re-reads the table
        assert m.rebalance_fraction() == 0.625
        assert m.metrics()["rebalance_adoptions_total"] == 1
    finally:
        m.shutdown()


@both
def test_out_of_ladder_entries_never_adopt(pkg):
    m = _reb_manager(pkg, replica_id="clamp")
    try:
        _set_table(m, "clamp=0.2500", pkg=pkg)  # below the floor
        _boundary(pkg, m)
        assert m.rebalance_fraction() == 1.0
        assert m.metrics()["rebalance_adoptions_total"] == 0
    finally:
        m.shutdown()


def _pair(pkg, decider_table, follower_table=""):
    dummy = PKG[pkg][2]
    ms = []
    for rank in range(2):
        m = _reb_manager(pkg, store=f"{pkg}-reb:0", rank=rank, world=2,
                         comm=dummy(world_size=2), replica_id=f"reb{rank}")
        _set_table(m, decider_table if rank == 0 else follower_table,
                   store=f"{pkg}-reb:0", rank=rank, world=2, pkg=pkg)
        ms.append(m)
    return ms


@both
def test_decider_publishes_follower_adopts(pkg, fake_quorum_stores):
    """Only the decider's hint carries the table; the follower lands its
    own entry through the quorum store."""
    ms = _pair(pkg, "reb1=0.8750")
    try:
        for m in ms:
            _boundary(pkg, m)
        store = fake_quorum_stores[f"{pkg}-reb:0"]
        assert store.kv[tmanager._REBALANCE_KEY] == b"1:reb1=0.8750"
        assert ms[1].rebalance_fraction() == 0.875
        assert ms[0].rebalance_fraction() == 1.0  # absent: uniform
    finally:
        for m in ms:
            m.shutdown()


@both
def test_follower_catches_up_after_a_missed_read(pkg, fake_quorum_stores):
    """The follower votes before the decider ever published (its read
    finds no key: nothing adopted, nothing published by it); at the next
    boundary it reads the decider's table and lands its entry."""
    ms = _pair(pkg, "reb1=0.7500")
    try:
        _boundary(pkg, ms[1])
        store = fake_quorum_stores[f"{pkg}-reb:0"]
        assert tmanager._REBALANCE_KEY not in store.kv
        assert ms[1].rebalance_fraction() == 1.0
        _boundary(pkg, ms[0])
        _boundary(pkg, ms[1])
        assert ms[1].rebalance_fraction() == 0.75
    finally:
        for m in ms:
            m.shutdown()


@both
def test_departed_groups_entry_drops(pkg, fake_quorum_stores):
    """A group restored to uniform — or gone, its digests forgotten —
    leaves the table; the follower reads the smaller table and returns to
    1.0."""
    ms = _pair(pkg, "gone=0.5000,reb1=0.6250")
    try:
        for m in ms:
            _boundary(pkg, m)
        assert ms[1].rebalance_fraction() == 0.625
        _set_table(ms[0], "gone=0.5000", store=f"{pkg}-reb:0", rank=0,
                   world=2, pkg=pkg)
        for m in ms:
            _boundary(pkg, m)
        assert ms[1].rebalance_fraction() == 1.0
        assert ms[1].metrics()["rebalance_adoptions_total"] == 2
    finally:
        for m in ms:
            m.shutdown()


class _BrokenStore(FakeStore):
    def get(self, key, timeout_ms=0):
        raise RuntimeError("store read lost")


@both
def test_failed_read_adopts_nothing(pkg):
    ms = _pair(pkg, "", follower_table="reb1=0.5000")
    try:
        for m in ms:
            m._healset_store = (f"{pkg}-reb:0", _BrokenStore())
        for m in ms:
            _boundary(pkg, m)
        assert ms[1].rebalance_fraction() == 1.0
        assert ms[1].metrics()["rebalance_adoptions_total"] == 0
    finally:
        for m in ms:
            m.shutdown()


@both
def test_capacity_times_rebalance_in_one_snapshot(pkg):
    m = _reb_manager(pkg, replica_id="compose", degraded_mode=True)
    try:
        _set_table(m, "compose=0.7500", pkg=pkg)
        _boundary(pkg, m)
        assert m.request_degrade(0.5, reason="test")
        rank, _committed, frac = m.participant_slot()
        assert rank == 0 and frac == pytest.approx(0.375)
        assert m._wire_weight() == round(0.375 * 10_000)
        m.set_step_samples(24)  # the sampler's exact draw wins
        assert m._wire_weight() == 24
    finally:
        m.shutdown()


class _Capture:
    def __init__(self):
        self.calls = []

    def set_status(self, *a, **k):
        pass

    def set_digest(self, **kw):
        self.calls.append(kw)

    def lighthouse_redials(self):
        return 0

    def shutdown(self):
        pass


@both
def test_digest_stamps_the_fraction_in_force(pkg):
    """The digest carries the fraction the measured step ran under: an
    adoption at boundary k is stamped from boundary k + 1 on, and the
    capacity fraction beside it."""
    m = _reb_manager(pkg, replica_id="digest", fleet_telemetry=True,
                     degraded_mode=True)
    cap = _Capture()
    m._manager_server = cap
    try:
        _set_table(m, "", pkg=pkg)
        _boundary(pkg, m)  # the first boundary has no wall
        _set_table(m, "digest=0.7500", pkg=pkg)
        _boundary(pkg, m)  # adoption lands after this boundary's wall
        m.request_degrade(0.5)
        _boundary(pkg, m)
        assert [c["rebalance_fraction"] for c in cap.calls] == [1.0, 0.75]
        assert [c["capacity_fraction"] for c in cap.calls] == [1.0, 0.5]
    finally:
        m.shutdown()


# --------------------------------------------------------- sampler fractions


class _FakeSlot:
    def __init__(self, rank=0, committed=0, frac=1.0, degraded=False):
        self.rank, self.committed, self.frac = rank, committed, frac
        self._degraded = degraded
        self.reported = []

    def participant_slot(self):
        return self.rank, self.committed, self.frac

    def set_step_samples(self, n):
        self.reported.append(n)

    def degraded_mode(self):
        return self._degraded


def _draws(mod, frac, degraded=False, slot=0, seed=3, batch=8):
    mgr = _FakeSlot(committed=slot, frac=frac, degraded=degraded)
    s = mod.ElasticSampler(64, mgr, batch_size=batch, seed=seed)
    return s.next_indices().tolist(), mgr.reported


@pytest.mark.parametrize("frac,degraded,want_len,reports", [
    (0.75, False, 6, True),    # shrunken: reports without degraded mode
    (1.0, False, 8, False),    # full fraction, degraded off: no report
    (1.0, True, 8, True),      # degraded mode: always reports
    (1.25, False, 10, True),   # a boost draws into the next slot
    (0.5, True, 4, True),
])
def test_sampler_fraction_draws_match_jax(frac, degraded, want_len, reports):
    got = _draws(tdata, frac, degraded)
    assert got == _draws(jdata, frac, degraded)
    assert len(got[0]) == want_len
    assert got[1] == ([want_len] if reports else [])


def test_boost_draws_the_next_slots_prefix_and_stops_at_the_epoch():
    s = tdata.ElasticSampler(64, _FakeSlot(), batch_size=8, seed=5)
    idx = s.indices_for_slot(0, 1.25)
    np.testing.assert_array_equal(idx[8:], s.indices_for_slot(1)[:2])
    assert len(s.indices_for_slot(7, 1.25)) == 8
    assert len(s.indices_for_slot(7, 0.5)) == 4


def test_reports_samples_truth_table_matches_jax():
    class NoReport:
        pass

    class NoProbe:
        set_step_samples = staticmethod(lambda n: None)

    cases = [(NoReport(), 0.5), (NoProbe(), 1.0),
             (_FakeSlot(degraded=False), 0.75),
             (_FakeSlot(degraded=False), 1.1667),
             (_FakeSlot(degraded=False), 1.0),
             (_FakeSlot(degraded=True), 1.0)]
    got = [tdata._reports_samples(m, f) for m, f in cases]
    assert got == [jdata._reports_samples(m, f) for m, f in cases]
    assert got == [False, True, True, True, False, True]


# ---------------------------------------------- composed-fraction fold


@pytest.mark.parametrize("world,fracs", [
    (2, [1.1667, 0.375]),
    (3, [1.1667, 0.5, 1.0]),
    (4, [1.1667, 1.1667, 0.5, 1.1667]),
])
def test_composed_fraction_fold_bitwise(world, fracs):
    """``TestComposedFractionFold``: the port's ring at draws-as-weights
    is bitwise the JAX ring and the numpy oracle on every rank."""
    weights = [int(round(48 * f)) for f in fracs]
    rng = np.random.default_rng(world)
    xs = [rng.normal(size=10_007).astype(np.float32) for _ in range(world)]
    outs = {}
    for name, host in (("port", thost), ("jax", jhost)):
        comms = _ring_comms(host, world)
        out = [None] * world

        def run(r, comms=comms, out=out):
            out[r] = comms[r]._do_allreduce_wire(
                comms[r]._ring, [xs[r].copy()], [np.dtype(np.float32)],
                "sum", "step", weights[r])[0]

        ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        for c in comms:
            c.shutdown()
        outs[name] = out
    want = weighted_oracle(xs, weights)
    for r in range(world):
        assert outs["port"][r].tobytes() == want.tobytes(), r
        assert outs["jax"][r].tobytes() == want.tobytes(), r


# --------------------------------------------------------- chaos slow band


@pytest.fixture
def no_chaos():
    yield
    tchaos.reset()
    jchaos.reset()


def test_slow_band_draws_match_jax(no_chaos):
    spec = "seed=9;slow:slow_rate=0.5,slow_factor=2.0"
    a, b = tchaos.parse_spec(spec), jchaos.parse_spec(spec)
    seq = [tchaos.slow_fault("slow:g0", a) for _ in range(40)]
    assert seq == [jchaos.slow_fault("slow:g0", b) for _ in range(40)]
    assert set(seq) == {1.0, 2.0}


def test_slow_band_stretches_the_natural_wall(no_chaos):
    """A participant under ``slow_rate=1`` sleeps ``(factor - 1)`` times
    the natural boundary wall — the measured wall less its own previous
    injection, so the stretch converges instead of compounding."""
    tchaos.install(tchaos.parse_spec(
        "seed=5;slow:slow_rate=1.0,slow_factor=3.0"))
    m = _manager("port", replica_id="slowmgr", degraded_mode=False)
    try:
        _boundary("port", m)
        time.sleep(0.05)
        t0 = time.monotonic()
        m._maybe_chaos_slow()
        slept = time.monotonic() - t0
        first = m._chaos_slow_injected
        assert first >= 0.05 and slept >= first * 0.9
        m._maybe_chaos_slow()
        assert m._chaos_slow_injected < first * 0.5
    finally:
        m.shutdown()


def test_slow_band_participants_only_and_no_draw(no_chaos):
    sched = tchaos.parse_spec("seed=6;slow:slow_rate=1.0,slow_factor=4.0")
    tchaos.install(sched)
    m = _manager("port", replica_id="benched", degraded_mode=False)
    try:
        _boundary("port", m)
        m._participating_rank = None  # benched spare
        draws = sched._counts.get("slow", 0)
        time.sleep(0.02)
        m._maybe_chaos_slow()
        assert m._chaos_slow_injected == 0.0
        assert sched._counts.get("slow", 0) == draws
    finally:
        m.shutdown()
