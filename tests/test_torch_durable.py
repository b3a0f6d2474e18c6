"""The port Manager's durability plane and churn surface on the CPU, held
to the JAX Manager on the same scripts (mirrors ``tests/test_cold_start.py``
``TestManagerDurable`` / ``TestManagerColdStart`` /
``TestColdStartConvergence`` and ``tests/test_churn.py``
``TestPreemptionDrain`` / ``TestJoinChurnAccounting`` / ``TestPrejoinHeal``
/ ``TestGracefulReclaimDrive``).

* ``save_durable`` stamps the JAX Manager's head (bytes equal with the
  head's time pinned) and refuses in each of its five classes.
* ``cold_start`` across packages both ways, and two groups — one of each
  package — cold-started from divergent, partly corrupt directories
  converging bitwise through the heal.
* The graceful preemption drain's state machine, run on both packages'
  Managers with the same assertions; ``prejoin_heal`` over real HTTP from
  either package's checkpoint server; join-coalescing accounting; and the
  graceful-vs-SIGKILL drive of two port groups over a socketpair ring.

Every Manager here has a scripted control plane, and the quorum store is
``tests/torch_fakes.py``'s: nothing dials or waits out a timeout.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time
from unittest import mock
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torchft_tpu import checkpoint_io as jcio
from torchft_tpu import checkpointing as jckpt
from torchft_tpu import communicator as jcomm
from torchft_tpu import manager as jmanager
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu_torch import checkpoint_io as cio
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.backends import host as thost
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.communicator import DummyCommunicator
from torch_fakes import FakeStore, fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port

PKGS = ("port", "jax")
MOD = {"port": tmanager, "jax": jmanager}
CIO = {"port": cio, "jax": jcio}


def _q(pkg: str, **kw):
    base = dict(quorum_id=1, recover_manager_address="manager:1234",
                store_address="s:1", max_step=1, max_rank=0,
                max_world_size=2, replica_rank=0, replica_world_size=2,
                heal=False)
    base.update(kw)
    return (QuorumResult if pkg == "port" else JQuorumResult)(**base)


def _client(pkg: str, commit=True, **kw):
    client = MagicMock()
    client.quorum.return_value = _q(pkg, **kw)
    client.should_commit.return_value = commit
    return client


def _manager(pkg: str, client, comm=None, **kw):
    if comm is None:
        comm = (DummyCommunicator() if pkg == "port"
                else jcomm.DummyCommunicator())
    if pkg == "port":
        kw.setdefault("checkpoint_bind_host", "127.0.0.1")
    return MOD[pkg].Manager(
        comm=comm, load_state_dict=kw.pop("load_state_dict", MagicMock()),
        state_dict=kw.pop("state_dict",
                          lambda: {"w": np.ones(4, np.float32)}),
        min_replica_size=kw.pop("min_replica_size", 1), rank=0,
        world_size=1, replica_id=kw.pop("replica_id", "testgroup"),
        _manager_client=client, **kw)


def _boundary(m, tree=None) -> bool:
    m.step()
    m.allreduce(tree if tree is not None
                else {"g": np.ones(4, np.float32)}).result()
    return m.should_commit()


def _events(m) -> list:
    return [e["event"] for e in m.history()]


class _Holder:
    """A mutable user-state cell wired into a scripted Manager."""

    def __init__(self, w):
        self.state = {"w": w}

    def load(self, s):
        self.state = s

    def dump(self):
        return self.state

    def w_bytes(self) -> bytes:
        w = self.state["w"]
        return (w.numpy() if isinstance(w, torch.Tensor)
                else np.asarray(w)).tobytes()


# ------------------------------------------------------- save_durable


def test_save_durable_stamps_the_jax_managers_head(tmp_path):
    """One committed boundary on the same script: both Managers' files
    hold the same head (step, commit marker, quorum id, replica id,
    participants) and, with the head's time pinned, the same bytes."""
    files = {}
    for pkg in PKGS:
        holder = _Holder(np.arange(16, dtype=np.float32))
        m = _manager(pkg, _client(pkg), load_state_dict=holder.load,
                     state_dict=holder.dump)
        ck = CIO[pkg].AsyncCheckpointer()
        try:
            m.step()
            assert m.should_commit()
            with mock.patch("time.time", return_value=99.5):
                fut = m.save_durable(ck, str(tmp_path / pkg))
                assert fut is not None
                path = fut.result(timeout=30)
            head = cio.read_meta(path)
            assert (head["step"], head["committed"], head["quorum_id"],
                    head["replica_id"], head["participants"]) == (
                1, True, 1, "testgroup", 2)
            assert cio.verify(path)["step"] == 1
            mx = m.metrics()
            assert mx["ckpt_save_count"] == 1 and mx["ckpt_save_fatal"] == 0
            assert "ckpt_save" in _events(m)
            files[pkg] = open(path, "rb").read()
        finally:
            ck.shutdown()
            m.shutdown()
    assert files["port"] == files["jax"]


REFUSALS = ("healing", "errored", "not committed", "deferred",
            "quarantined")


@pytest.mark.parametrize("why", REFUSALS)
@pytest.mark.parametrize("pkg", PKGS)
def test_save_durable_refuses_unsettled_state(tmp_path, pkg, why):
    """Each refusal class returns None, counts ``ckpt_save_skipped`` (and
    ``sdc_refusals_total`` under a verdict), logs ``ckpt_skip`` and
    writes nothing."""
    client = _client(pkg, commit=why != "not committed")
    m = _manager(pkg, client, overlap_steps=1 if why == "deferred" else 0)
    ck = CIO[pkg].AsyncCheckpointer()
    try:
        m.step()
        if why == "deferred":
            m.stage_deferred(m.allreduce({"g": np.ones(4, np.float32)}))
        else:
            m.allreduce({"g": np.ones(4, np.float32)}).result()
            assert m.should_commit() == (why != "not committed")
        if why == "healing":
            with m._metrics_lock:
                m._healing = True
        elif why == "errored":
            m.report_error(RuntimeError("boom"))
        elif why == "quarantined":
            with m._metrics_lock:
                m._sdc_quarantined = True
        assert m.save_durable(ck, str(tmp_path)) is None
        mx = m.metrics()
        assert mx["ckpt_save_skipped"] == 1
        assert mx["sdc_refusals_total"] == (why == "quarantined")
        assert "ckpt_skip" in _events(m)
        assert os.listdir(tmp_path) == []
        if why == "deferred":
            m.drain_deferred()
    finally:
        ck.shutdown()
        m.shutdown()


# --------------------------------------------------------- cold start


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_cold_start_restores_newest_verified_across_packages(
        tmp_path, writer, reader):
    w5 = np.arange(32, dtype=np.float32)
    CIO[writer].save(str(tmp_path / "ckpt_5"), {"w": w5},
                     {"step": 5, "batches_committed": 10},
                     meta={"quorum_id": 2, "replica_id": "old"})
    bad = str(tmp_path / "ckpt_9")
    CIO[writer].save(bad, {"w": np.zeros(32, np.float32)},
                     {"step": 9, "batches_committed": 18})
    with open(bad, "r+b") as f:  # one payload byte of the newest file
        f.seek(os.path.getsize(bad) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    holder = _Holder(torch.zeros(32) if reader == "port"
                     else np.zeros(32, np.float32))
    m = _manager(reader, MagicMock(), load_state_dict=holder.load,
                 state_dict=holder.dump)
    try:
        assert m.cold_start(str(tmp_path)) == str(tmp_path / "ckpt_5")
        assert (m.current_step(), m.batches_committed()) == (5, 10)
        assert holder.w_bytes() == w5.tobytes()
        if reader == "port":
            assert isinstance(holder.state["w"], torch.Tensor)
        mx = m.metrics()
        assert mx["ckpt_cold_starts"] == 1
        assert mx["ckpt_corrupt_quarantined"] == 1
        assert mx["ckpt_recover_fallbacks"] == 1
        ev = [e for e in m.history() if e["event"] == "cold_start"]
        assert ev and ev[-1]["recovered"] is True
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_cold_start_empty_dir_is_fresh_start(tmp_path, pkg):
    m = _manager(pkg, MagicMock())
    try:
        assert m.cold_start(str(tmp_path)) is None
        assert m.current_step() == 0
        assert m.metrics()["ckpt_cold_starts"] == 0
    finally:
        m.shutdown()


@pytest.mark.parametrize("newest", PKGS)
def test_divergent_cold_starts_of_both_packages_converge_bitwise(
        tmp_path, monkeypatch, newest):
    """A correlated failure leaves two directories at different steps, the
    stale one with a torn newest file. Group A (``newest``'s package)
    cold-starts at 10, group B (the other package) at 8 past the torn
    file; B heals from A's checkpoint server at the first quorum and both
    end bitwise equal at step 11."""
    stale = "jax" if newest == "port" else "port"
    rng = np.random.RandomState(11)
    wA = rng.rand(4096).astype(np.float32)
    wB = rng.rand(4096).astype(np.float32)
    CIO[stale].save(str(tmp_path / "a" / "ckpt_10"), {"w": wA},
                    {"step": 10, "batches_committed": 20},
                    meta={"quorum_id": 4, "replica_id": "gA"})
    CIO[newest].save(str(tmp_path / "b" / "ckpt_8"), {"w": wB},
                     {"step": 8, "batches_committed": 16},
                     meta={"quorum_id": 3, "replica_id": "gB"})
    (tmp_path / "b" / "ckpt_9").write_bytes(
        b"TFTCKPT2\x40\x00\x00\x00partial head junk")

    def zeros(pkg):
        return (torch.zeros(4096) if pkg == "port"
                else np.zeros(4096, np.float32))

    hA, hB = _Holder(zeros(newest)), _Holder(zeros(stale))
    cA = _client(newest, quorum_id=5, max_step=11, max_rank=0,
                 max_world_size=2, replica_rank=0, replica_world_size=2)
    cB = _client(stale, quorum_id=5, max_step=11, max_rank=None,
                 max_world_size=1, replica_rank=1, replica_world_size=2,
                 heal=True, recover_manager_address="managerA")
    mA = _manager(newest, cA, load_state_dict=hA.load, state_dict=hA.dump,
                  replica_id="gA")
    mB = _manager(stale, cB, load_state_dict=hB.load, state_dict=hB.dump,
                  replica_id="gB")

    def client_for(addr, **_kw):
        mc = MagicMock()
        mc.checkpoint_address.side_effect = (
            lambda *a, **k: mA._ckpt_server.address())
        return mc

    monkeypatch.setattr(MOD[stale], "ManagerClient", client_for)
    try:
        assert mA.cold_start(str(tmp_path / "a")) is not None
        assert mA.current_step() == 10
        assert mB.cold_start(str(tmp_path / "b")) == str(
            tmp_path / "b" / "ckpt_8")
        assert mB.current_step() == 8
        assert mB.metrics()["ckpt_corrupt_quarantined"] == 1
        assert hA.w_bytes() != hB.w_bytes()
        mA.step()  # to 11, opens the serve window
        mB.step()  # quorum: heal from A at max_step 11
        mB.allreduce({"g": np.ones(4, np.float32)}).result()
        assert mB.should_commit()
        mA.allreduce({"g": np.ones(4, np.float32)}).result()
        assert mA.should_commit()
    finally:
        mB.shutdown()
        mA.shutdown()
    assert mA.current_step() == mB.current_step() == 11
    assert hB.w_bytes() == hA.w_bytes() == wA.tobytes()
    assert mB.metrics()["heal_count"] == 1
    assert mB.metrics()["heal_bytes_total"] > 0


# ---------------------------------------------------- preemption drain


def _participant(pkg, **kw):
    return _client(pkg, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_happy_path_sequence(tmp_path, pkg):
    """Notice after a clean boundary: the next step() says farewell,
    takes the final save at the committed step, tombstones the healset
    advertisement and raises PreemptedExit, as does every later step()."""
    client = _participant(pkg, replica_rank=1, max_rank=1)
    store = FakeStore()
    m = _manager(pkg, client)
    m._healset_store = ("s:1", store)
    m.set_durable_target(CIO[pkg].AsyncCheckpointer(), str(tmp_path))
    assert _boundary(m)
    assert store.kv["torchft/healset/1"].startswith(b"1:")
    remaining = m.request_preemption(60.0, reason="reclaim-test")
    assert 0 < remaining <= 60.0
    assert m.preemption_pending() and not m.drained()
    with pytest.raises(MOD[pkg].PreemptedExit):
        m.step()
    assert m.drained() and not m.preemption_pending()
    assert client.farewell.called
    rec = cio.recover(str(tmp_path))
    assert cio.verify(rec)["committed"] is True
    _, mgr_state = cio.load(rec, target={"w": torch.ones(4)})
    assert mgr_state["step"] == 1
    assert store.kv["torchft/healset/1"] == b"-1:"
    mx = m.metrics()
    assert mx["preempt_notices_total"] == 1
    assert mx["graceful_exits_total"] == 1
    assert mx["preempt_deadline_expired_total"] == 0
    ev = _events(m)
    for name in ("preempt_notice", "preempt_drain", "farewell",
                 "ckpt_save", "graceful_exit"):
        assert name in ev
    # Farewell first, then the final save, then the exit.
    assert ev.index("farewell") < ev.index("ckpt_save") < \
        ev.index("graceful_exit")
    with pytest.raises(MOD[pkg].PreemptedExit):
        m.step()


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_without_durable_target_still_exits(pkg):
    m = _manager(pkg, _participant(pkg))
    assert _boundary(m)
    m.request_preemption(60.0)
    with pytest.raises(MOD[pkg].PreemptedExit):
        m.step()
    assert m.drained()
    assert m.metrics()["graceful_exits_total"] == 1


def _deferral_then_drain(m, pkg, why: str) -> None:
    assert _boundary(m)  # the deferring boundary retries normally
    assert not m.drained() and m.preemption_pending()
    assert m.metrics()["preempt_drain_deferrals_total"] == 1
    evs = [e for e in m.history() if e["event"] == "preempt_deferred"]
    assert evs and why in evs[0]["why"]
    with pytest.raises(MOD[pkg].PreemptedExit):
        m.step()  # a clean boundary behind us: the drain lands
    assert m.drained()


@pytest.mark.parametrize("pkg", PKGS)
def test_vote_abort_defers_drain_to_next_boundary(pkg):
    client = _participant(pkg)
    client.should_commit.side_effect = [False, True]
    m = _manager(pkg, client)
    try:
        assert not _boundary(m)
        m.request_preemption(60.0)
        _deferral_then_drain(m, pkg, "vote aborted")
    finally:
        if not m.drained():
            m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_errored_boundary_defers_drain(pkg):
    client = _participant(pkg)
    client.should_commit.side_effect = \
        lambda rank, step, should_commit, timeout_ms=None: should_commit
    m = _manager(pkg, client)
    try:
        m.step()
        m.report_error(RuntimeError("injected"))
        assert not m.should_commit()
        m.request_preemption(60.0)
        _deferral_then_drain(m, pkg, "errored")
    finally:
        if not m.drained():
            m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_notice_mid_heal_defers_cleanly(pkg):
    m = _manager(pkg, _participant(pkg))
    try:
        assert _boundary(m)
        with m._metrics_lock:
            m._healing = True
        m.request_preemption(60.0)
        _deferral_then_drain(m, pkg, "healing")
    finally:
        if not m.drained():
            m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_notice_mid_deferred_overlap_defers_cleanly(pkg):
    m = _manager(pkg, _participant(pkg), overlap_steps=1)
    try:
        m.step()
        m.stage_deferred(m.allreduce({"g": np.ones(4, np.float32)}))
        m.request_preemption(60.0)
        with pytest.raises(RuntimeError, match="deferred"):
            m.step()
        assert not m.drained() and m.deferred_pending()
        evs = [e for e in m.history() if e["event"] == "preempt_deferred"]
        assert evs and "deferred in flight" in evs[0]["why"]
        assert m.drain_deferred() is not None
        assert m.should_commit()
        with pytest.raises(MOD[pkg].PreemptedExit):
            m.step()
        assert m.drained()
    finally:
        if not m.drained():
            m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_expiry_degrades_to_hard_kill_with_flight_dump(
        tmp_path, monkeypatch, pkg):
    monkeypatch.setenv("TORCHFT_FLIGHT_DIR", str(tmp_path))
    client = _participant(pkg, commit=False)
    m = _manager(pkg, client)
    try:
        assert not _boundary(m)
        m.request_preemption(0.2)
        assert not _boundary(m)  # blocked inside the deadline: deferred
        assert m.preemption_pending()
        time.sleep(0.25)
        assert not _boundary(m)  # past the deadline: expired
        assert not m.drained() and not m.preemption_pending()
        mx = m.metrics()
        assert mx["preempt_deadline_expired_total"] == 1
        assert mx["graceful_exits_total"] == 0
        assert "preempt_deadline_expired" in _events(m)
        assert mx["flight_dumps_total"] >= 1
        assert any(f.endswith(".json") for f in os.listdir(tmp_path))
        client.should_commit.return_value = True
        assert _boundary(m)
        assert not m.drained()
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_save_durable_with_user_state_is_not_auto_remembered(tmp_path, pkg):
    m = _manager(pkg, _participant(pkg))
    writer = CIO[pkg].AsyncCheckpointer()
    try:
        assert _boundary(m)
        fut = m.save_durable(writer, str(tmp_path),
                             user_state={"rich": {"w": np.ones(2)}})
        fut.result(timeout=30)
        assert m._durable_target is None
        m.save_durable(writer, str(tmp_path)).result(timeout=30)
        assert m._durable_target is not None
    finally:
        writer.shutdown()
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_fresh_notice_rearms_after_expiry(pkg):
    client = _participant(pkg, commit=False)
    m = _manager(pkg, client)
    try:
        assert not _boundary(m)
        m.request_preemption(0.2)
        assert not _boundary(m)
        time.sleep(0.25)
        assert not _boundary(m)  # expired
        assert not m.preemption_pending()
        assert m.request_preemption(60.0, reason="re-reclaim") > 50.0
        assert m.preemption_pending()
        client.should_commit.return_value = True
        assert _boundary(m)  # deferred once more (last vote aborted)
        with pytest.raises(MOD[pkg].PreemptedExit):
            m.step()
        mx = m.metrics()
        assert mx["preempt_deadline_expired_total"] == 1
        assert mx["graceful_exits_total"] == 1
    finally:
        if not m.drained():
            m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_refused_final_save_degrades_instead_of_lying(pkg):
    m = _manager(pkg, _participant(pkg))
    try:
        m.set_durable_target(MagicMock(), "/nonexistent")
        assert _boundary(m)
        m.request_preemption(60.0)
        m.save_durable = MagicMock(return_value=None)
        m.step()  # save refused: degrade, no raise
        assert not m.drained()
        mx = m.metrics()
        assert mx["preempt_deadline_expired_total"] == 1
        assert mx["graceful_exits_total"] == 0
        assert any("refused" in str(e.get("why", "")) for e in m.history()
                   if e["event"] == "preempt_deadline_expired")
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_final_save_degrades(tmp_path, pkg):
    """A final save whose write fails (here: the target is a file) is an
    expired drain with the error in its event, never a graceful exit."""
    (tmp_path / "occupied").write_text("a file, not a dir")
    m = _manager(pkg, _participant(pkg))
    writer = CIO[pkg].AsyncCheckpointer()
    try:
        m.set_durable_target(writer, str(tmp_path / "occupied" / "d"))
        assert _boundary(m)
        m.request_preemption(60.0)
        m.step()
        assert not m.drained()
        assert m.metrics()["preempt_deadline_expired_total"] == 1
        assert any("failed" in str(e.get("why", "")) for e in m.history()
                   if e["event"] == "preempt_deadline_expired")
    finally:
        with pytest.raises(RuntimeError, match="previous async"):
            writer.shutdown()
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_repeated_notices_count_and_keep_earliest_deadline(pkg):
    m = _manager(pkg, _participant(pkg))
    try:
        m.request_preemption(120.0)
        assert m.request_preemption(60.0) <= 60.0
        assert m.request_preemption(300.0) <= 60.0
        assert m.metrics()["preempt_notices_total"] == 3
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_reclaim_sec_env_default(monkeypatch, pkg):
    monkeypatch.setenv("TORCHFT_RECLAIM_SEC", "42")
    m = _manager(pkg, _participant(pkg))
    try:
        assert m.request_preemption() == pytest.approx(42.0, abs=1.0)
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_sigterm_handler_requests_preemption(pkg):
    """The handler is lock-free: the notice is staged, and its counter
    lands at the next boundary's flush."""
    m = _manager(pkg, _participant(pkg))
    prev = None
    try:
        prev = m.install_preemption_handler(deadline_s=30.0)
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if m.preemption_pending():
                break
            time.sleep(0.01)
        assert m.preemption_pending()
        assert m.metrics()["preempt_notices_total"] == 0
        with pytest.raises(MOD[pkg].PreemptedExit):
            m.step()
        assert m.metrics()["preempt_notices_total"] == 1
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        m.shutdown()


def test_sigterm_while_blocked_on_a_future_lands_within_one_step():
    """The signal lands while the main thread waits on a Future (as it
    does on the ring's result or a CUDA sync): the handler runs once the
    wait returns, and the drain lands at the very next step()."""
    from concurrent.futures import Future

    m = _manager("port", _participant("port"))
    prev = m.install_preemption_handler(deadline_s=30.0)
    try:
        assert _boundary(m)
        fut: Future = Future()
        threading.Timer(0.2, fut.set_result, args=(1,)).start()
        threading.Timer(0.05, os.kill,
                        args=(os.getpid(), signal.SIGTERM)).start()
        assert fut.result(timeout=5) == 1
        with pytest.raises(tmanager.PreemptedExit):
            m.step()
        assert m.metrics()["graceful_exits_total"] == 1
    finally:
        signal.signal(signal.SIGTERM, prev)
        m.shutdown()


# ------------------------------------------------- join accounting


@pytest.mark.parametrize("pkg", PKGS)
def test_joins_coalesced_counts_multi_member_growth(pkg):
    client = MagicMock()
    client.quorum.side_effect = [
        _q(pkg, quorum_id=1, replica_world_size=2),
        _q(pkg, quorum_id=2, replica_world_size=5, max_world_size=5),
        _q(pkg, quorum_id=3, replica_world_size=3, max_world_size=3),
        _q(pkg, quorum_id=4, replica_world_size=4, max_world_size=4),
    ]
    client.should_commit.return_value = True
    m = _manager(pkg, client)
    try:
        for _ in range(4):
            assert _boundary(m)
        mx = m.metrics()
        assert mx["joins_coalesced_total"] == 2
        assert mx["reconfigure_count"] == 4
        assert mx["reconfigures_per_min"] == 4.0
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_own_first_join_is_not_coalescing(pkg):
    m = _manager(pkg, _client(pkg, quorum_id=9, replica_world_size=5,
                              max_world_size=5))
    try:
        assert _boundary(m)
        assert m.metrics()["joins_coalesced_total"] == 0
    finally:
        m.shutdown()


# ------------------------------------------------------ pre-join heal


def _fleet_state() -> dict:
    return {"user": {"w": np.arange(8, dtype=np.float32) * 3.0},
            "torchft": {"step": 7, "batches_committed": 21}}


def _server(pkg, state_fn):
    if pkg == "port":
        srv = CheckpointServer(state_fn, bind_host="127.0.0.1")
    else:
        srv = jckpt.CheckpointServer(state_fn, bind_host="127.0.0.1")
    srv.allow_checkpoint(7)
    return srv


@pytest.mark.parametrize("donor", PKGS)
def test_prejoin_adopts_fleet_state_over_real_http(donor):
    state = _fleet_state()
    srv = _server(donor, lambda: state)
    holder = {}
    m = _manager("port", MagicMock(), load_state_dict=lambda s: holder.update(
        p=s), state_dict=lambda: {"w": torch.zeros(8)})
    try:
        status = {"members": [{"replica_id": "d", "address": "mgr:1",
                               "step": 7}]}
        assert m.prejoin_heal(lambda: status, resolve=lambda a: srv.address())
        assert (m.current_step(), m.batches_committed()) == (7, 21)
        assert holder["p"]["w"].numpy().tobytes() == \
            state["user"]["w"].tobytes()
        mx = m.metrics()
        assert mx["prejoin_heals_total"] == 1 and mx["heal_bytes_total"] > 0
        assert "prejoin_heal" in _events(m)
    finally:
        m.shutdown()
        srv.shutdown()


def test_prejoin_stripes_across_max_step_members():
    state = _fleet_state()
    srvs = [_server(pkg, lambda: state) for pkg in PKGS]
    holder = {}
    m = _manager("port", MagicMock(), load_state_dict=lambda s: holder.update(
        p=s), state_dict=lambda: {"w": torch.zeros(8)})
    try:
        status = {"members": [
            {"replica_id": "d0", "address": "m0:1", "step": 7},
            {"replica_id": "d1", "address": "m1:1", "step": 7},
            {"replica_id": "lag", "address": "m2:1", "step": 5}]}
        addrs = {"m0:1": srvs[0].address(), "m1:1": srvs[1].address()}
        assert m.prejoin_heal(lambda: status, resolve=lambda a: addrs[a])
        assert m.current_step() == 7
        assert holder["p"]["w"].numpy().tobytes() == \
            state["user"]["w"].tobytes()
        assert [e["donors"] for e in m.history()
                if e["event"] == "prejoin_heal"] == [2]
    finally:
        m.shutdown()
        for s in srvs:
            s.shutdown()


def test_prejoin_noop_failure_and_refusal_after_join():
    m = _manager("port", _client("port"))
    try:
        assert m.prejoin_heal(lambda: {"members": []}) is False
        assert m.prejoin_heal(lambda: {"members": [
            {"replica_id": "d", "address": "m:1", "step": 0}]}) is False

        def gone(addr):
            raise ConnectionRefusedError("donor gone")

        assert m.prejoin_heal(lambda: {"members": [
            {"replica_id": "d", "address": "m:1", "step": 9}]},
            resolve=gone) is False
        assert m.current_step() == 0
        assert m.metrics()["prejoin_heals_total"] == 0
        assert _boundary(m)
        with pytest.raises(RuntimeError, match="BEFORE the first"):
            m.prejoin_heal(lambda: {"members": []})
    finally:
        m.shutdown()


# -------------------------------------- graceful vs SIGKILL, real ring


def _ring_pair() -> list:
    pairs = [socket.socketpair() for _ in range(2)]

    class Wired(thost.HostCommunicator):
        def configure(self, store_addr, rank, world_size):
            self._rank, self._world = rank, world_size

    comms = []
    for r in range(2):
        c = Wired(timeout_sec=15)
        c._ring = thost._Ring(pairs[r][0], pairs[(r - 1) % 2][1],
                              socket.socket())
        c._rank, c._world = r, 2
        comms.append(c)
    return comms


K_TOGETHER = 3
K_AFTER = 3


def _survivor_client(stale_rounds: int):
    """A's control plane: world 2 while B lives, then — after
    ``stale_rounds`` rounds that still name B (a SIGKILL's staleness
    window) — world 1 under a new quorum id."""
    seq = [_q("port", quorum_id=1, max_world_size=2, replica_world_size=2,
              max_step=s) for s in range(1, K_TOGETHER + 1)]
    seq += [_q("port", quorum_id=1, max_world_size=2, replica_world_size=2)
            for _ in range(stale_rounds)]
    seq += [_q("port", quorum_id=2, max_world_size=1, replica_world_size=1)
            for _ in range(K_AFTER + 2)]
    client = MagicMock()
    client.quorum.side_effect = seq
    client.should_commit.side_effect = \
        lambda rank, step, should_commit, timeout_ms=None: should_commit
    return client


def _leaver_client():
    client = MagicMock()
    client.quorum.side_effect = [
        _q("port", quorum_id=1, max_rank=1, max_world_size=2,
           replica_rank=1, replica_world_size=2, max_step=s)
        for s in range(1, K_TOGETHER + 1)]
    client.should_commit.side_effect = \
        lambda rank, step, should_commit, timeout_ms=None: should_commit
    return client


def _grads(rank: int, step: int) -> dict:
    rng = np.random.default_rng(100 * rank + step)
    return {"g": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}


def _run_leg(graceful: bool, tmp_path) -> dict:
    comm_a, comm_b = _ring_pair()
    store = FakeStore()
    m_a = _manager("port", _survivor_client(0 if graceful else 1),
                   comm=comm_a, replica_id="groupA")
    m_b = _manager("port", _leaver_client(), comm=comm_b,
                   replica_id="groupB")
    m_b._healset_store = ("s:1", store)
    m_b.set_durable_target(cio.AsyncCheckpointer(), str(tmp_path))
    committed_a: list = []
    b_outcome: dict = {}

    def run_b():
        try:
            for k in range(K_TOGETHER):
                m_b.step()
                m_b.allreduce(_grads(1, k)).result()
                if graceful and k == K_TOGETHER - 1:
                    # The notice lands mid-step: this boundary commits,
                    # the drain fires at the next step().
                    m_b.request_preemption(30.0, reason="reclaim")
                m_b.should_commit()
            if graceful:
                try:
                    m_b.step()
                    b_outcome["exit"] = "kept-running"
                except tmanager.PreemptedExit:
                    b_outcome["exit"] = "preempted"
            else:
                b_outcome["exit"] = "killed"
        except Exception as e:  # noqa: BLE001
            b_outcome["exit"] = f"error: {e!r}"

    tb = threading.Thread(target=run_b, name="groupB")
    tb.start()
    try:
        for k in range(K_TOGETHER):
            m_a.step()
            m_a.allreduce(_grads(0, k)).result()
            committed_a.append(m_a.should_commit())
        tb.join(timeout=30)
        assert not tb.is_alive()
        if not graceful:
            comm_b._ring.close()  # the dead process's sockets slam shut
        for k in range(K_AFTER + (0 if graceful else 1)):
            m_a.step()
            m_a.allreduce(_grads(0, 100 + k)).result()
            committed_a.append(m_a.should_commit())
        out = {"committed_a": committed_a, "mx_a": m_a.metrics(),
               "mx_b": m_b.metrics(), "poisoned": m_a._comm_poisoned,
               "events_a": m_a.history(), "b_outcome": b_outcome,
               "store": store}
    finally:
        m_a.shutdown()
        m_b.shutdown()
    return out


def test_graceful_leg_zero_aborts_zero_ring_resets(tmp_path):
    r = _run_leg(graceful=True, tmp_path=tmp_path)
    assert r["committed_a"] == [True] * (K_TOGETHER + K_AFTER)
    assert r["mx_a"]["aborted_steps"] == 0
    assert r["poisoned"] is False
    assert not [e for e in r["events_a"]
                if e["event"] == "reconfigure" and e.get("recovery")]
    assert r["mx_b"]["graceful_exits_total"] == 1
    assert r["store"].kv["torchft/healset/1"] == b"-1:"
    path = cio.recover(str(tmp_path))
    assert cio.read_meta(path)["step"] == K_TOGETHER
    assert r["b_outcome"]["exit"] == "preempted"


def test_sigkill_control_leg_costs_at_least_one_abort(tmp_path):
    r = _run_leg(graceful=False, tmp_path=tmp_path)
    assert r["mx_a"]["aborted_steps"] >= 1
    assert False in r["committed_a"]
    assert r["committed_a"][-1] is True
    assert r["mx_b"]["graceful_exits_total"] == 0


# ------------------------------------------------------- train_lm


def _train_lm_env(tmp_path, lighthouse: str, steps: int) -> dict:
    return {"REPLICA_GROUP_ID": "0", "NUM_REPLICA_GROUPS": "1",
            "TOTAL_STEPS": str(steps), "BATCH_SIZE": "2", "SEQ_LEN": "32",
            "MODEL": "tiny", "TORCHFT_LIGHTHOUSE": lighthouse,
            "DATA_DIR": str(tmp_path), "CHECKPOINT_DIR": str(tmp_path / "ck"),
            "CHECKPOINT_EVERY": "2",
            "REPORT_FILE": str(tmp_path / f"report_{steps}.json"),
            "TORCHFT_CHECKPOINT_BIND": "127.0.0.1"}


def test_train_lm_saves_on_cadence_and_resumes_bitwise(tmp_path,
                                                       monkeypatch):
    """One tiny group: saves at steps 2 and 4 land in its own directory,
    verified and committed; a second run resumes at step 4 with the state
    hash the first run ended with, and its loader where it stopped."""
    import json

    from torchft_tpu_torch import train_lm
    from torchft_tpu_torch._native import Lighthouse

    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                    quorum_tick_ms=20)
    prev = signal.getsignal(signal.SIGTERM)
    reps = {}
    try:
        for steps in (4, 5):
            for k, v in _train_lm_env(tmp_path, lh.address(), steps).items():
                monkeypatch.setenv(k, v)
            train_lm.main(["--device", "cpu"])
            # main's reclaim handler is gone once it returns.
            assert signal.getsignal(signal.SIGTERM) == prev
            reps[steps] = json.loads(
                (tmp_path / f"report_{steps}.json").read_text())
    finally:
        signal.signal(signal.SIGTERM, prev)
        lh.shutdown()
    first, second = reps[4], reps[5]
    assert [s["step"] for s in first["ckpt_saves"]] == [2, 4]
    assert all(s["ok"] for s in first["ckpt_saves"])
    assert first["saved"] == [False, True, False, True]
    assert first["ckpt"]["ckpt_save_count"] == 2
    assert "resumed_step" not in first
    d = tmp_path / "ck" / "0"
    assert sorted(os.listdir(d)) == ["ckpt_2", "ckpt_4"]
    head = cio.verify(str(d / "ckpt_4"))
    assert head["committed"] and head["step"] == 4
    assert second["resumed_step"] == 4
    assert second["resumed_from"] == str(d / "ckpt_4")
    assert second["resumed_hash"] == first["state_hash"]
    assert second["step"] == 5 and second["committed"] == [True]
    assert second["ckpt"]["ckpt_corrupt_quarantined"] == 0
    with open(d / "ckpt_4", "rb") as f:
        _, mf, _ = cio._open_verified(f)
    loader = {e["key"].rsplit("/", 1)[1]: e["value"] for e in mf["leaves"]
              if e["key"].startswith("user/loader/")}
    assert loader["batch_idx"] == 4  # the position after step 4's batch
    assert second["preempted"] is False and first["preempted"] is False


def test_train_lm_sigterm_drains_and_exits_zero(tmp_path):
    """SIGTERM mid-run: the group finishes its step, drains (farewell,
    final save of the cadence tree at the step it drained at) and exits 0
    with ``preempted`` and one graceful exit in its report."""
    import json
    import subprocess
    import sys

    from torchft_tpu_torch._native import Lighthouse

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                    quorum_tick_ms=20)
    env = dict(os.environ)
    env.update(_train_lm_env(tmp_path, lh.address(), 100_000))
    env["CHECKPOINT_EVERY"] = "1000"  # only the drain's save
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    report = tmp_path / "report_100000.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.train_lm", "--device",
         "cpu"], cwd=root, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            try:
                if json.loads(report.read_text())["step"] >= 2:
                    break
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.05)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        assert rc == 0, proc.stderr.read().decode()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        lh.shutdown()
    assert time.monotonic() - t0 < 60
    rep = json.loads(report.read_text())
    assert rep["preempted"] is True
    assert rep["preempt"]["graceful_exits_total"] == 1
    assert rep["preempt"]["preempt_notices_total"] == 1
    assert rep["preempt"]["preempt_deadline_expired_total"] == 0
    assert rep["state_hash"]
    path = cio.recover(str(tmp_path / "ck" / "0"))
    head = cio.verify(path)
    assert head["committed"] and head["step"] == rep["step"]
    assert path.endswith(f"ckpt_{rep['step']}")
    # The final save holds the loader where the drained step left it, not
    # past the batch drawn for the step that never ran.
    with open(path, "rb") as f:
        _, mf, _ = cio._open_verified(f)
    assert [e["value"] for e in mf["leaves"]
            if e["key"] == "user/loader/batch_idx"] == [rep["step"]]
