"""The port's elastic data stream against the JAX package's: the
``ElasticSampler``'s index draws for the same seed, slots and fractions
(boosts past 1.0, shrinks, the epoch edge, unshuffled); the
``ElasticLoader``'s keying by (slot, fraction), its prefetch, its restart
and its placement on a device; the in-memory iterators; and
``train_lm`` with ``ELASTIC_DATA=1`` resuming from a durable file of the
``<group>-elastic`` lineage on the tiny model."""

from __future__ import annotations

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from torchft_tpu import data as jdata
from torchft_tpu_torch import checkpoint_io as cio
from torchft_tpu_torch import data as tdata
from torch_fakes import few_threads  # noqa: F401

pytestmark = pytest.mark.port


class _Slot:
    """A manager double: one atomic slot snapshot, the reported
    weights, a participant count."""

    def __init__(self, rank=0, committed=0, frac=1.0, degraded=False, n=1):
        self.rank, self.committed, self.frac = rank, committed, frac
        self._degraded = degraded
        self.n = n
        self.reported = []

    def participant_slot(self):
        return self.rank, self.committed, self.frac

    def set_step_samples(self, k):
        self.reported.append(k)

    def degraded_mode(self):
        return self._degraded

    def num_participants(self):
        return self.n

    def batches_committed(self):
        return self.committed


SLOTS = [0, 1, 6, 7, 8, 15, 16, 23, 40, 1001]
FRACS = [1.0, 0.5, 0.375, 0.75, 1.1667, 1.25, 1.5]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_index_draws_equal_jax(seed, shuffle):
    """Every (slot, fraction) pair, across epoch edges (8 slots an
    epoch), through ``indices_for_slot`` and ``next_indices`` with the
    rank offset: the port draws the JAX sampler's indices exactly."""
    for slot in SLOTS:
        for frac in FRACS:
            for rank in (0, 2):
                got = []
                for mod in (tdata, jdata):
                    mgr = _Slot(rank=rank, committed=slot, frac=frac)
                    s = mod.ElasticSampler(67, mgr, batch_size=8,
                                           shuffle=shuffle, seed=seed)
                    got.append((s.indices_for_slot(slot + rank, frac)
                                .tolist(), s.next_indices().tolist(),
                                mgr.reported, s.current_slot()))
                assert got[0] == got[1], (slot, frac, rank)
                assert got[0][0] == got[0][1]


def test_epoch_edge_and_rank_none():
    s = tdata.ElasticSampler(64, _Slot(rank=None, committed=7), batch_size=8)
    assert s.current_slot() == 7  # a benched group draws a throwaway
    assert len(s.indices_for_slot(7, 1.5)) == 8  # no wrap into epoch 1
    assert s.indices_for_slot(8).tolist() == \
        np.random.default_rng((0, 1)).permutation(64)[:8].tolist()
    with pytest.raises(ValueError, match="smaller than one batch"):
        tdata.ElasticSampler(4, _Slot(), batch_size=8)


class _DS:
    def __init__(self, n=64):
        self.n = n
        self.reads = []

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        self.reads.append(tuple(np.asarray(idx).tolist()))
        return {"x": np.asarray(idx, np.int64) * 10,
                "y": np.asarray(idx, np.float32)}


def test_loader_keys_by_slot_and_fraction_like_jax():
    """``test_elastic_loader_keys_cache_by_capacity`` through both
    loaders: a fraction change at the same slot is a new key and a
    shrunken draw, reported as the fold weight."""
    outs = []
    for mod in (tdata, jdata):
        m = _Slot(frac=1.0, degraded=True)
        ds = _DS()
        loader = mod.ElasticLoader(ds, mod.ElasticSampler(64, m,
                                                          batch_size=8),
                                   prefetch=0)
        full = loader()
        m.frac = 0.5
        half = loader()
        outs.append((np.asarray(full["x"]).tolist(),
                     np.asarray(half["x"]).tolist(), m.reported, ds.reads))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 8 and len(outs[0][1]) == 4
    assert outs[0][2] == [8, 4]


def test_loader_prefetches_the_predicted_slots_and_restarts():
    """Prefetch reads the slots a commit predicts (``slot + k * n``);
    the next draw after a commit is a hit, an abort (same slot) a hit
    from the kept batch; after shutdown the loader starts a fresh thread
    on its next call."""
    m = _Slot(committed=0, n=2)
    ds = _DS()
    loader = tdata.ElasticLoader(ds, tdata.ElasticSampler(64, m,
                                                          batch_size=4),
                                 prefetch=2)
    try:
        loader()
        assert loader.prefetch_misses == 1
        deadline = time.monotonic() + 5
        s = loader.sampler
        want = {tuple(s.indices_for_slot(k).tolist()) for k in (2, 4)}
        while not want <= set(ds.reads):
            assert time.monotonic() < deadline, ds.reads
            time.sleep(0.01)
        m.committed = 2  # a commit: the stream moved by n
        loader()
        loader()  # an abort redraws the same slot
        assert (loader.prefetch_hits, loader.prefetch_misses) == (2, 1)
        loader.shutdown()
        m.committed = 40
        got = loader()
        assert got["x"].tolist() == (s.indices_for_slot(40) * 10).tolist()
        assert loader._thread is not None and loader._thread.is_alive()
    finally:
        loader.shutdown()


def test_loader_places_batches_on_the_device():
    m = _Slot(committed=3)
    loader = tdata.ElasticLoader(_DS(), tdata.ElasticSampler(64, m,
                                                             batch_size=4),
                                 prefetch=0, device=torch.device("cpu"))
    b = loader()
    assert isinstance(b["x"], torch.Tensor) and b["x"].dtype == torch.int64
    assert b["y"].dtype == torch.float32 and b["x"].device.type == "cpu"
    want = loader.sampler.indices_for_slot(3)
    assert b["x"].tolist() == (want * 10).tolist()
    assert loader._cache[(3, 1.0)]["x"].__class__ is np.ndarray


def test_in_memory_iterators_equal_jax():
    arrays = {"x": np.arange(64 * 3, dtype=np.float32).reshape(64, 3),
              "y": np.arange(64, dtype=np.int32)}
    m = _Slot(rank=1, committed=5, frac=0.75)
    a = next(tdata.ElasticBatchIterator(arrays, tdata.ElasticSampler(
        64, m, batch_size=8, seed=2)))
    b = next(jdata.ElasticBatchIterator(arrays, jdata.ElasticSampler(
        64, m, batch_size=8, seed=2)))
    for k in arrays:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    draws = []
    for mod in (tdata, jdata):
        it = mod.BatchIterator(arrays, mod.DistributedSampler(
            64, replica_group=1, num_replica_groups=2, batch_size=8,
            seed=4))
        draws.append([np.asarray(next(it)["y"]).tolist()
                      for _ in range(9)])  # across an epoch edge
    assert draws[0] == draws[1]


def _env(tmp_path, lighthouse, steps, ck):
    return {"REPLICA_GROUP_ID": "0", "NUM_REPLICA_GROUPS": "1",
            "TOTAL_STEPS": str(steps), "BATCH_SIZE": "2", "SEQ_LEN": "32",
            "MODEL": "tiny", "TORCHFT_LIGHTHOUSE": lighthouse,
            "DATA_DIR": str(tmp_path), "CHECKPOINT_DIR": str(tmp_path / ck),
            "CHECKPOINT_EVERY": "2", "ELASTIC_DATA": "1",
            "REPORT_FILE": str(tmp_path / f"report_{ck}_{steps}.json"),
            "TORCHFT_CHECKPOINT_BIND": "127.0.0.1"}


@pytest.mark.usefixtures("few_threads")
def test_train_lm_elastic_resumes_from_batches_committed(tmp_path,
                                                         monkeypatch):
    """One tiny group with ``ELASTIC_DATA=1``: saves land in
    ``<dir>/0-elastic`` with no loader state; a run of 2 steps then a
    resumed run of one more ends with the state hash of 3 steps in one
    run, so the resumed draw is the stream's slot 2, restored with
    ``batches_committed`` (and the saved step's own contribution, which
    the JAX Manager's resume loses: ROADMAP C12)."""
    from torchft_tpu_torch import train_lm
    from torchft_tpu_torch._native import Lighthouse

    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                    quorum_tick_ms=20)
    prev = signal.getsignal(signal.SIGTERM)
    reps = {}
    try:
        for ck, steps in (("a", 2), ("a", 3), ("b", 3)):
            for k, v in _env(tmp_path, lh.address(), steps, ck).items():
                monkeypatch.setenv(k, v)
            train_lm.main(["--device", "cpu"])
            assert signal.getsignal(signal.SIGTERM) == prev
            reps[ck, steps] = json.loads(
                (tmp_path / f"report_{ck}_{steps}.json").read_text())
    finally:
        signal.signal(signal.SIGTERM, prev)
        lh.shutdown()
    first, resumed, whole = reps["a", 2], reps["a", 3], reps["b", 3]
    assert first["elastic"] and first["samples"] == [2, 2]
    assert first["participating"] == [True] * 2
    assert first["num_participants"] == [1] * 2
    assert first["capacity_fraction"] == first["rebalance_fraction"] \
        == [1.0] * 2
    d = tmp_path / "a" / "0-elastic"
    assert sorted(os.listdir(d)) == ["ckpt_2"]
    assert not (tmp_path / "a" / "0").exists()
    head = cio.verify(str(d / "ckpt_2"))
    assert head["committed"] and head["step"] == 2
    with open(d / "ckpt_2", "rb") as f:
        _, mf, _ = cio._open_verified(f)
    keys = [e["key"] for e in mf["leaves"]]
    assert not any(k.startswith("user/loader") for k in keys)
    assert "torchft/batches_committed" in keys
    assert resumed["resumed_step"] == 2
    assert resumed["resumed_hash"] == first["state_hash"]
    assert resumed["committed"] == [True] and resumed["samples"] == [2]
    assert resumed["state_hash"] == whole["state_hash"]
    assert resumed["losses"][0] == whole["losses"][2]
