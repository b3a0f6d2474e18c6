"""The port's durable checkpoint format (``torchft_tpu_torch.checkpoint_io``)
against the JAX package's, on the CPU.

* Both directions: a file either package writes verifies and loads in
  the other, single files and shard sets, and with the head's ``time``
  (and a set's ``set_id``) pinned the two packages write the same bytes.
* The port mirrors of ``tests/test_checkpoint_io.py`` and of
  ``tests/test_cold_start.py``'s ``TestDurableFormat``,
  ``TestVerifiedLoad``, ``TestRecover``, ``TestDiskChaos`` and
  ``TestAsyncCheckpointerRobustness``: flips in the head, the preamble
  and the payload are caught before any tensor is placed; truncation;
  legacy files; a torn newest file; uncommitted files skipped; retention
  that never deletes the newest verified file; a stalled write abandoned
  within its timeout; ENOSPC fatal and EIO not.
* The snapshot ``save_async`` takes stays fixed after the tensors it
  copied are changed in place.
"""

from __future__ import annotations

import errno
import os
import time
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu import checkpoint_io as jcio
from torchft_tpu_torch import chaos as tchaos
from torchft_tpu_torch import checkpoint_io as cio
from torchft_tpu_torch.chaos import ChaosSchedule, EndpointChaos
from torchft_tpu_torch.checkpoint_io import (AsyncCheckpointer,
                                             CheckpointCorruptError,
                                             CheckpointUnverifiableError)
from torchft_tpu_torch.serialization import save_pytree

pytestmark = pytest.mark.port

MGR = {"step": 7, "batches_committed": 21}


def _arrays(val: float = 1.0) -> dict:
    """numpy-seeded leaves of the tree both packages save: f32, bf16, an
    int64 vector and an f32 scalar (AdamW's ``step``)."""
    rng = np.random.default_rng(int(val * 10))
    return {
        "w": (rng.standard_normal((8, 8)) * val).astype(np.float32),
        "h": rng.standard_normal(6).astype(ml_dtypes.bfloat16),
        "i": np.arange(5, dtype=np.int64) * int(val),
        "step": np.asarray(val, np.float32),
    }


def port_state(val: float = 1.0) -> dict:
    a = _arrays(val)
    return {
        "params": {"w": torch.from_numpy(a["w"]),
                   "h": torch.from_numpy(a["h"].view(np.int16).copy())
                   .view(torch.bfloat16)},
        "opt": [torch.from_numpy(a["i"]), torch.from_numpy(a["step"])],
        "n": 3,
    }


def jax_state(val: float = 1.0) -> dict:
    a = _arrays(val)
    return {"params": {"w": jnp.asarray(a["w"]), "h": jnp.asarray(a["h"])},
            "opt": [a["i"], jnp.asarray(a["step"])], "n": 3}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype == ml_dtypes.bfloat16 else arr


def _same_tree(a, b) -> None:
    la = jax.tree_util.tree_leaves(a, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    lb = jax.tree_util.tree_leaves(b, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, (int, float)):
            assert x == y
        else:
            assert _host(x).tobytes() == _host(y).tobytes()


def _flip_at(path, off) -> None:
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def _first_leaf_offset(path) -> int:
    with open(path, "rb") as f:
        _, mf, payload_start = cio._open_verified(f)
    return payload_start + int(mf["preamble_len"])


# ---------------------------------------------------- the two packages


@pytest.mark.parametrize("shards", [0, 1, 2, 3])
def test_files_are_byte_identical_with_time_pinned(tmp_path, shards):
    """The same tree, manager state and head through both writers: equal
    bytes, shard files and shard-set head included."""
    paths = {}
    for pkg, mod, state in (("port", cio, port_state(2.0)),
                            ("jax", jcio, jax_state(2.0))):
        d = tmp_path / pkg
        path = str(d / "ckpt_7")
        with mock.patch("time.time", return_value=1234.5), \
                mock.patch("uuid.uuid4") as uu:
            uu.return_value.hex = "0123abcd"
            if shards:
                mod.save_sharded(path, state, MGR, meta={"quorum_id": 3},
                                 shards=shards)
            else:
                mod.save(path, state, MGR, meta={"quorum_id": 3})
        paths[pkg] = d
    names = sorted(os.listdir(paths["port"]))
    assert names == sorted(os.listdir(paths["jax"]))
    assert len(names) == (1 + shards if shards else 1)
    for name in names:
        assert (paths["port"] / name).read_bytes() == \
            (paths["jax"] / name).read_bytes(), name


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_file_of_either_package_verifies_and_loads_in_the_other(
        tmp_path, writer, shards):
    path = str(tmp_path / "ckpt_7")
    mod, state = ((cio, port_state(3.0)) if writer == "port"
                  else (jcio, jax_state(3.0)))
    if shards:
        mod.save_sharded(path, state, MGR, shards=shards)
    else:
        mod.save(path, state, MGR)
    assert cio.verify(path)["step"] == 7
    assert jcio.verify(path)["step"] == 7
    user, mgr = cio.load(path, target=port_state())
    assert mgr == MGR
    assert user["params"]["h"].dtype == torch.bfloat16
    _same_tree(user, port_state(3.0))
    juser, jmgr = jcio.load(path, target=jax_state())
    assert jmgr == MGR
    assert isinstance(juser["params"]["w"], jax.Array)
    _same_tree(juser, jax_state(3.0))


def test_recover_agrees_across_packages(tmp_path):
    """A directory of both packages' files with a corrupt newest: both
    scans pick the same file, and quarantine the same one."""
    cio.save(str(tmp_path / "ckpt_2"), port_state(), {"step": 2,
                                                      "batches_committed": 2})
    jcio.save(str(tmp_path / "ckpt_4"), jax_state(), {"step": 4,
                                                      "batches_committed": 4})
    cio.save(str(tmp_path / "ckpt_6"), port_state(), {"step": 6,
                                                      "batches_committed": 6})
    _flip_at(str(tmp_path / "ckpt_6"), _first_leaf_offset(
        str(tmp_path / "ckpt_6")))
    stats = {}
    assert cio.recover(str(tmp_path), quarantine=False, stats=stats) == \
        jcio.recover(str(tmp_path), quarantine=False) == \
        str(tmp_path / "ckpt_4")
    assert stats == {"ckpt_corrupt_quarantined": 0.0,
                     "ckpt_recover_fallbacks": 1.0,
                     "ckpt_recover_legacy": 0.0}


# ----------------------------------------------- save / load (mirrors)


class TestSaveLoad:
    def test_round_trip_with_manager_state(self, tmp_path):
        path = str(tmp_path / "ckpt_7")
        cio.save(path, port_state(2.5), MGR)
        user, mgr = cio.load(path, target=port_state(), device_put=False)
        _same_tree(user, port_state(2.5))
        assert mgr == MGR

    def test_default_manager_state(self, tmp_path):
        path = str(tmp_path / "ckpt_0")
        cio.save(path, port_state())
        _, mgr = cio.load(path, target=port_state(), device_put=False)
        assert mgr == {"step": 0, "batches_committed": 0}

    def test_load_places_like_the_target(self, tmp_path):
        """``device_put`` gives tensors on each target leaf's device and
        dtype (a CPU ``step`` scalar stays a 0-d CPU tensor); without it,
        host arrays."""
        path = str(tmp_path / "ckpt_1")
        cio.save(path, port_state(3.0), MGR)
        user, _ = cio.load(path, target=port_state())
        step = user["opt"][1]
        assert isinstance(step, torch.Tensor) and step.dim() == 0
        assert user["params"]["w"].dtype == torch.float32
        raw, _ = cio.load(path, target=port_state(), device_put=False)
        assert isinstance(raw["params"]["w"], np.ndarray)

    def test_makes_parent_dirs(self, tmp_path):
        path = str(tmp_path / "a" / "b" / "ckpt_2")
        cio.save(path, port_state())
        assert os.path.exists(path)

    def test_structure_mismatch_fails_loudly(self, tmp_path):
        path = str(tmp_path / "ckpt_3")
        cio.save(path, port_state())
        with pytest.raises(ValueError):
            cio.load(path, target={"different": torch.ones(2)})

    def test_crash_mid_save_preserves_previous(self, tmp_path, monkeypatch):
        path = str(tmp_path / "ckpt_5")
        cio.save(path, port_state(1.0), {"step": 5, "batches_committed": 5})
        good = open(path, "rb").read()
        real_iter = cio._iter_leaf_views

        def dies_midway(leaves, batch_bytes):
            it = real_iter(leaves, batch_bytes)
            yield next(it)
            raise OSError("disk died mid-write")

        monkeypatch.setattr(cio, "_iter_leaf_views", dies_midway)
        with pytest.raises(OSError, match="disk died"):
            cio.save(path, port_state(9.0), {"step": 6,
                                             "batches_committed": 6})
        assert open(path, "rb").read() == good
        assert [n for n in os.listdir(tmp_path)
                if n.startswith(".ckpt_tmp_")] == []
        assert cio.load(path, target=port_state())[1]["step"] == 5

    def test_writer_streams_leaf_batches(self, tmp_path, monkeypatch):
        """The writer copies the leaves to the host in batches of at most
        ``DEFAULT_BATCH_BYTES`` (a leaf larger than one batch alone), so
        its host memory is O(batch), never the whole state."""
        monkeypatch.setattr(cio, "DEFAULT_BATCH_BYTES", 300)
        seen = []
        real_iter = cio._iter_leaf_views

        def spy(leaves, batch_bytes):
            seen.append(batch_bytes)
            yield from real_iter(leaves, batch_bytes)

        monkeypatch.setattr(cio, "_iter_leaf_views", spy)
        path = str(tmp_path / "ckpt_1")
        cio.save(path, port_state())
        assert seen == [300]
        _same_tree(cio.load(path, target=port_state())[0], port_state())


class TestLatest:
    def test_picks_highest_step(self, tmp_path):
        for step in (1, 12, 3):
            cio.save(str(tmp_path / f"ckpt_{step}"), port_state())
        (tmp_path / "ckpt_notastep").write_bytes(b"x")
        (tmp_path / "unrelated").write_bytes(b"x")
        assert cio.latest(str(tmp_path)) == str(tmp_path / "ckpt_12")

    def test_empty_and_missing_dir(self, tmp_path):
        assert cio.latest(str(tmp_path)) is None
        assert cio.latest(str(tmp_path / "nope")) is None

    def test_custom_prefix(self, tmp_path):
        cio.save(str(tmp_path / "model_4"), port_state())
        assert cio.latest(str(tmp_path), prefix="model_") == str(
            tmp_path / "model_4")
        assert cio.latest(str(tmp_path)) is None


# ---------------------------------------------- durable format (mirrors)


class TestDurableFormat:
    def test_head_records_provenance(self, tmp_path):
        path = str(tmp_path / "ckpt_7")
        cio.save(path, port_state(), MGR, meta={
            "quorum_id": 3, "replica_id": "g0", "committed": True})
        head = cio.read_meta(path)
        assert head["format"] == cio.FORMAT == jcio.FORMAT
        assert (head["step"], head["batches_committed"]) == (7, 21)
        assert (head["quorum_id"], head["replica_id"]) == (3, "g0")
        assert head["committed"] is True

    def test_legacy_is_unverifiable_but_loads(self, tmp_path):
        path = str(tmp_path / "ckpt_3")
        with open(path, "wb") as f:
            f.write(save_pytree({"user": port_state(),
                                 "torchft": {"step": 3,
                                             "batches_committed": 3}}))
        with pytest.raises(CheckpointUnverifiableError):
            cio.verify(path)
        assert cio.load(path, target=port_state())[1]["step"] == 3


class TestVerifiedLoad:
    def test_payload_flip_detected_before_device_put(self, tmp_path,
                                                     monkeypatch):
        path = str(tmp_path / "ckpt_1")
        cio.save(path, port_state(), MGR)
        _flip_at(path, _first_leaf_offset(path))
        calls = []
        real = cio.device_put_like
        monkeypatch.setattr(cio, "device_put_like",
                            lambda a, t: calls.append(1) or real(a, t))
        with pytest.raises(CheckpointCorruptError, match="digest"):
            cio.load(path, target=port_state())
        assert calls == []  # the flipped first leaf was never placed

    def test_head_flip_detected(self, tmp_path):
        path = str(tmp_path / "ckpt_1")
        cio.save(path, port_state(), MGR)
        _flip_at(path, len(cio._CKPT_MAGIC) + 4 + 5)
        with pytest.raises(CheckpointCorruptError):
            cio.verify(path)
        with pytest.raises(CheckpointCorruptError):
            cio.load(path, target=port_state())

    def test_preamble_flip_detected(self, tmp_path, monkeypatch):
        """The preamble carries py-leaf values inline: a flip there fails
        verify and load, before anything is placed."""
        path = str(tmp_path / "ckpt_1")
        cio.save(path, port_state(), MGR)
        _flip_at(path, _first_leaf_offset(path) - 3)
        monkeypatch.setattr(cio, "device_put_like", mock.Mock(
            side_effect=AssertionError("placed")))
        with pytest.raises(CheckpointCorruptError):
            cio.verify(path)
        with pytest.raises(CheckpointCorruptError):
            cio.load(path, target=port_state())

    def test_truncation_detected(self, tmp_path):
        path = str(tmp_path / "ckpt_1")
        cio.save(path, port_state(), MGR)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)
        with pytest.raises(CheckpointCorruptError):
            cio.verify(path)
        with pytest.raises(CheckpointCorruptError):
            cio.load(path, target=port_state())

    def test_stale_shard_generation_fails_the_set(self, tmp_path):
        """A shard from an older save of the same name carries another
        set_id: verify and load refuse the set, recover condemns it with
        its members."""
        path = str(tmp_path / "ckpt_3")

        def state(v):
            return {"a": torch.full((64,), v), "b": torch.full((64,), v)}

        mgr = {"step": 3, "batches_committed": 3}
        cio.save_sharded(path, state(1.0), mgr, shards=2)
        old = (tmp_path / "ckpt_3.shard1").read_bytes()
        cio.save_sharded(path, state(2.0), mgr, shards=2)
        assert cio.read_meta(path)["shards"][1]["leaves"] == [3, 4]
        (tmp_path / "ckpt_3.shard1").write_bytes(old)
        with pytest.raises(CheckpointCorruptError, match="set_id"):
            cio.verify(path)
        with pytest.raises(CheckpointCorruptError, match="set_id"):
            cio.load(path, target=state(0.0))
        stats = {}
        assert cio.recover(str(tmp_path), stats=stats) is None
        assert stats["ckpt_corrupt_quarantined"] == 3  # head + 2 shards


# ------------------------------------------------------ recover (mirrors)


class TestRecover:
    def test_falls_back_past_corrupt_and_quarantines(self, tmp_path):
        good = str(tmp_path / "ckpt_5")
        cio.save(good, port_state(5.0), {"step": 5, "batches_committed": 5})
        bad = str(tmp_path / "ckpt_8")
        cio.save(bad, port_state(8.0), {"step": 8, "batches_committed": 8})
        _flip_at(bad, _first_leaf_offset(bad))
        stats = {}
        assert cio.recover(str(tmp_path), stats=stats) == good
        assert stats["ckpt_corrupt_quarantined"] == 1
        assert stats["ckpt_recover_fallbacks"] == 1
        assert os.path.exists(bad + ".corrupt") and not os.path.exists(bad)
        assert cio.latest(str(tmp_path)) == good

    def test_torn_newest_file_is_quarantined(self, tmp_path):
        good = str(tmp_path / "ckpt_2")
        cio.save(good, port_state(), {"step": 2, "batches_committed": 2})
        (tmp_path / "ckpt_9").write_bytes(b"TFTCKPT2\x40\x00\x00\x00torn")
        stats = {}
        assert cio.recover(str(tmp_path), stats=stats) == good
        assert stats["ckpt_corrupt_quarantined"] == 1

    def test_zero_byte_newest_never_a_candidate(self, tmp_path):
        good = str(tmp_path / "ckpt_2")
        cio.save(good, port_state(), {"step": 2, "batches_committed": 2})
        (tmp_path / "ckpt_9").write_bytes(b"")
        assert cio.latest(str(tmp_path)) == good
        assert cio.recover(str(tmp_path)) == good

    def test_uncommitted_snapshot_skipped(self, tmp_path):
        cio.save(str(tmp_path / "ckpt_1"), port_state(1.0),
                 {"step": 1, "batches_committed": 1})
        cio.save(str(tmp_path / "ckpt_4"), port_state(4.0),
                 {"step": 4, "batches_committed": 4},
                 meta={"committed": False})
        stats = {}
        assert cio.recover(str(tmp_path), stats=stats) == str(
            tmp_path / "ckpt_1")
        assert stats["ckpt_recover_fallbacks"] == 1
        assert stats["ckpt_corrupt_quarantined"] == 0
        assert os.path.exists(tmp_path / "ckpt_4")  # not quarantined

    def test_legacy_skipped_without_quarantine(self, tmp_path):
        cio.save(str(tmp_path / "ckpt_1"), port_state(),
                 {"step": 1, "batches_committed": 1})
        legacy = tmp_path / "ckpt_6"
        legacy.write_bytes(save_pytree(
            {"user": port_state(),
             "torchft": {"step": 6, "batches_committed": 6}}))
        assert cio.recover(str(tmp_path)) == str(tmp_path / "ckpt_1")
        assert legacy.exists()

    def test_legacy_only_dir_falls_back_instead_of_fresh_start(
            self, tmp_path):
        for step in (3, 9):
            (tmp_path / f"ckpt_{step}").write_bytes(save_pytree(
                {"user": port_state(float(step)),
                 "torchft": {"step": step, "batches_committed": step}}))
        stats = {}
        got = cio.recover(str(tmp_path), stats=stats)
        assert got == str(tmp_path / "ckpt_9")
        assert stats["ckpt_recover_legacy"] == 1
        assert cio.load(got, target=port_state())[1]["step"] == 9
        assert cio.recover(str(tmp_path), allow_legacy=False) is None

    def test_torn_legacy_never_the_last_resort(self, tmp_path):
        good = save_pytree({"user": port_state(3.0),
                            "torchft": {"step": 3, "batches_committed": 3}})
        (tmp_path / "ckpt_3").write_bytes(good)
        (tmp_path / "ckpt_9").write_bytes(good[:len(good) // 2])
        got = cio.recover(str(tmp_path))
        assert got == str(tmp_path / "ckpt_3")

    def test_quarantine_false_counts_nothing_moved(self, tmp_path):
        good = str(tmp_path / "ckpt_1")
        cio.save(good, port_state(), {"step": 1, "batches_committed": 1})
        bad = str(tmp_path / "ckpt_2")
        cio.save(bad, port_state(), {"step": 2, "batches_committed": 2})
        _flip_at(bad, _first_leaf_offset(bad))
        stats = {}
        assert cio.recover(str(tmp_path), quarantine=False,
                           stats=stats) == good
        assert stats["ckpt_corrupt_quarantined"] == 0
        assert stats["ckpt_recover_fallbacks"] == 1
        assert os.path.exists(bad)

    def test_empty_dir(self, tmp_path):
        assert cio.recover(str(tmp_path)) is None
        assert cio.recover(str(tmp_path / "nope")) is None


# ------------------------------------------------------ disk chaos


class TestDiskChaos:
    def teardown_method(self):
        tchaos.uninstall()

    def test_torn_write_leaves_torn_artifact(self, tmp_path):
        good = str(tmp_path / "ckpt_1")
        cio.save(good, port_state(1.0), {"step": 1, "batches_committed": 1})
        tchaos.install(ChaosSchedule(seed=0, endpoints={
            "disk": EndpointChaos(torn_rate=1.0)}))
        torn = str(tmp_path / "ckpt_2")
        with pytest.raises(OSError, match="torn"):
            cio.save(torn, port_state(2.0), {"step": 2,
                                             "batches_committed": 2})
        tchaos.uninstall()
        assert os.path.getsize(torn) > 0
        with pytest.raises(CheckpointCorruptError):
            cio.verify(torn)
        stats = {}
        assert cio.recover(str(tmp_path), stats=stats) == good
        assert stats["ckpt_corrupt_quarantined"] == 1

    def test_flip_is_silent_until_verify(self, tmp_path):
        tchaos.install(ChaosSchedule(seed=0, endpoints={
            "disk": EndpointChaos(flip_rate=1.0)}))
        path = str(tmp_path / "ckpt_1")
        cio.save(path, port_state(), MGR)  # no raise
        tchaos.uninstall()
        with pytest.raises(CheckpointCorruptError):
            cio.verify(path)

    def test_enospc_raises_fatal_errno(self, tmp_path):
        tchaos.install(ChaosSchedule(seed=0, endpoints={
            "disk": EndpointChaos(enospc_rate=1.0)}))
        with pytest.raises(OSError) as ei:
            cio.save(str(tmp_path / "ckpt_1"), port_state(), MGR)
        assert ei.value.errno == errno.ENOSPC
        assert cio._io_fatal(ei.value) and not cio._io_transient(ei.value)


# ----------------------------------------------------- AsyncCheckpointer


class TestAsyncCheckpointer:
    def teardown_method(self):
        tchaos.uninstall()

    def test_matches_sync_save(self, tmp_path):
        ck = AsyncCheckpointer()
        try:
            fut = ck.save_async(str(tmp_path / "ckpt_7"), port_state(4.0),
                                MGR)
            assert fut.result(timeout=30) == str(tmp_path / "ckpt_7")
            user, mgr = cio.load(str(tmp_path / "ckpt_7"),
                                 target=port_state())
            _same_tree(user, port_state(4.0))
            assert mgr == MGR
            mx = ck.metrics()
            assert mx["ckpt_save_count"] == 1
            assert mx["ckpt_save_bytes_total"] == os.path.getsize(
                tmp_path / "ckpt_7")
        finally:
            ck.shutdown()

    def test_snapshot_stays_fixed_after_in_place_change(self, tmp_path):
        """save_async clones every tensor before it returns: the update
        that follows (in place, as the optimizer's) never reaches the
        file, however late the writer runs."""
        state = port_state(1.0)
        want = {k: v.clone() for k, v in state["params"].items()}
        gate = mock.MagicMock()
        real_save = cio.save

        def slow_save(*a, **k):
            time.sleep(0.2)  # the writer runs after the change below
            gate()
            return real_save(*a, **k)

        ck = AsyncCheckpointer()
        try:
            with mock.patch.object(cio, "save", slow_save):
                fut = ck.save_async(str(tmp_path / "ckpt_1"), state)
                with torch.no_grad():
                    for v in state["params"].values():
                        v.add_(1)
                fut.result(timeout=30)
            assert gate.called
            user, _ = cio.load(str(tmp_path / "ckpt_1"), target=port_state())
            for k, v in want.items():
                assert torch.equal(user["params"][k], v)
        finally:
            ck.shutdown()

    def test_serializes_overlapping_saves_and_prunes(self, tmp_path):
        ck = AsyncCheckpointer(keep=2)
        try:
            for step in range(5):
                ck.save_async(str(tmp_path / f"ckpt_{step}"),
                              {"w": torch.full((2,), float(step))},
                              {"step": step, "batches_committed": step})
            ck.wait()
            names = sorted(p.name for p in tmp_path.iterdir()
                           if p.name.startswith("ckpt_"))
            assert names == ["ckpt_3", "ckpt_4"]
        finally:
            ck.shutdown()

    def test_write_failure_surfaces_on_next_call(self, tmp_path):
        ck = AsyncCheckpointer()
        try:
            (tmp_path / "noexist").write_text("a file, not a dir")
            fut = ck.save_async(str(tmp_path / "noexist" / "sub" / "ckpt_1"),
                                {"w": torch.zeros(2)})
            with pytest.raises(Exception):
                fut.result(timeout=30)
            with pytest.raises(RuntimeError, match="previous async"):
                ck.save_async(str(tmp_path / "ckpt_2"), {"w": torch.zeros(2)})
            f2 = ck.save_async(str(tmp_path / "ckpt_3"), {"w": torch.zeros(2)})
            assert f2.result(timeout=30)
        finally:
            ck.shutdown()

    def test_stalled_write_shutdown_returns_within_timeout(self, tmp_path):
        """A wedged write (chaos blackhole) is abandoned by the no-progress
        watchdog: shutdown returns within the stall timeout and raises a
        CheckpointStallError."""
        tchaos.install(ChaosSchedule(seed=0, endpoints={
            "disk": EndpointChaos(blackhole_rate=1.0, blackhole_ms=3_000.0)}))
        ck = AsyncCheckpointer(stall_timeout_sec=0.3)
        ck.save_async(str(tmp_path / "ckpt_1"), {"w": torch.zeros(4)})
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="previous async"):
            ck.shutdown()
        assert time.monotonic() - t0 < 2.0
        assert ck.metrics()["ckpt_save_stalls"] == 1
        assert "no progress" in (ck.last_error() or "")

    def test_enospc_fatal_reported_and_reraised(self, tmp_path):
        tchaos.install(ChaosSchedule(seed=0, endpoints={
            "disk": EndpointChaos(enospc_rate=1.0)}))
        ck = AsyncCheckpointer()
        try:
            fut = ck.save_async(str(tmp_path / "ckpt_1"),
                                {"w": torch.zeros(4)})
            with pytest.raises(OSError):
                fut.result(timeout=30)
            mx = ck.metrics()
            assert mx["ckpt_save_errors"] == 1
            assert mx["ckpt_save_fatal"] == 1
            assert "space" in (ck.last_error() or "").lower()
            tchaos.uninstall()
            with pytest.raises(RuntimeError, match="previous async"):
                ck.save_async(str(tmp_path / "ckpt_2"), {"w": torch.zeros(4)})
        finally:
            ck.shutdown()

    def test_transient_eio_is_not_fatal(self, tmp_path):
        tchaos.install(ChaosSchedule(seed=0, endpoints={
            "disk": EndpointChaos(reset_rate=1.0, max_faults=1)}))
        ck = AsyncCheckpointer()
        try:
            fut = ck.save_async(str(tmp_path / "ckpt_1"),
                                {"w": torch.zeros(4)})
            with pytest.raises(OSError) as ei:
                fut.result(timeout=30)
            assert ei.value.errno == errno.EIO
            mx = ck.metrics()
            assert mx["ckpt_save_errors"] == 1
            assert mx["ckpt_save_fatal"] == 0
        finally:
            tchaos.uninstall()
            with pytest.raises(RuntimeError, match="previous async"):
                ck.shutdown()

    def test_prune_never_deletes_newest_verified(self, tmp_path):
        (tmp_path / "ckpt_8").write_bytes(b"TFTCKPT2garbage")
        (tmp_path / "ckpt_9").write_bytes(b"\x00" * 64)
        ck = AsyncCheckpointer(keep=2)
        try:
            for step in (1, 2, 3):
                ck.save_async(str(tmp_path / f"ckpt_{step}"),
                              {"w": torch.full((2,), float(step))},
                              {"step": step, "batches_committed": step})
            ck.wait()
        finally:
            ck.shutdown()
        assert cio.verify(str(tmp_path / "ckpt_3"))["step"] == 3
        assert not os.path.exists(tmp_path / "ckpt_1")
        assert not os.path.exists(tmp_path / "ckpt_2")
        assert cio.recover(str(tmp_path)) == str(tmp_path / "ckpt_3")

    def test_sharded_writer_round_trips(self, tmp_path):
        ck = AsyncCheckpointer(shards=3)
        try:
            ck.save_async(str(tmp_path / "ckpt_2"), port_state(2.0),
                          {"step": 2, "batches_committed": 4}).result(30)
        finally:
            ck.shutdown()
        head = cio.verify(str(tmp_path / "ckpt_2"))
        assert head["format"] == cio.SET_FORMAT and head["shard_count"] == 3
        _same_tree(cio.load(str(tmp_path / "ckpt_2"),
                            target=port_state())[0], port_state(2.0))
