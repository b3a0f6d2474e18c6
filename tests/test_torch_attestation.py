"""The port's state attestation plane on the CPU, against the JAX package.

* The digest words: the port's numpy reference and its kernel wrapper's
  plain version (``ops.attest``) bitwise equal to the JAX package's
  ``serialization.attest_fingerprint`` and ``manager._attest_device_words``
  on the same numpy-seeded leaves, per dtype, across leaves (order
  matters) and under one flipped bit.
* The one donor predicate, the quarantine ladder, the checkpoint server's
  503 gate and the chaos ``sdc`` band, each run on both packages'
  Managers (mirrors ``tests/test_attestation.py``).
* The 3-group soak: one bit flip, the verdict within one boundary, the
  quarantine, the re-heal from the attested majority over real checkpoint
  HTTP, the clear, and a bitwise-converged fleet — the port's Manager
  against the port's ``fleet.FleetAggregator`` and the JAX Manager
  against the JAX one, from the same chaos seed, with the same timeline
  and the same digests every round.
"""

from __future__ import annotations

import urllib.error
import urllib.request
from unittest.mock import MagicMock

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu import chaos as jchaos
from torchft_tpu import communicator as jcomm
from torchft_tpu import fleet as jfleet
from torchft_tpu import manager as jmanager
from torchft_tpu import serialization as jser
from torchft_tpu._native import QuorumResult as JQuorumResult
from torchft_tpu_torch import chaos as tchaos
from torchft_tpu_torch import fleet as tfleet
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import serialization as tser
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.communicator import DummyCommunicator
from torchft_tpu_torch.ops import attest
from torch_fakes import FakeStore, fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port

NOW = 1_000_000  # the aggregators' fixed clock base (ms)
PKGS = ("port", "jax")


# ---------------------------------------------------------- digest words


def _leaf(kind: str, seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind in ("float32", "float64", "float16"):
        return rng.standard_normal(n).astype(kind)
    if kind == "bfloat16":
        return rng.standard_normal(n).astype(ml_dtypes.bfloat16)
    if kind == "bool":
        return rng.integers(0, 2, n).astype(bool)
    info = np.iinfo(kind)
    return rng.integers(max(info.min, -2 ** 40), min(info.max, 2 ** 40),
                        n, endpoint=True).astype(kind)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_device(leaves) -> str:
    words = np.asarray(jmanager._attest_device_words(
        [jnp.asarray(a) for a in leaves]), dtype=np.uint32)
    return jser.attest_combine([int(w) for w in words])


def _port_words(leaves) -> str:
    return tser.attest_combine(attest.attest_words(leaves))


DTYPES = ["float32", "bfloat16", "float16", "int32", "uint8", "bool",
          "int8", "int16", "int64", "float64"]


@pytest.mark.parametrize("n", [1, 37, 1001])
@pytest.mark.parametrize("kind", DTYPES)
def test_leaf_digest_matches_jax(kind, n):
    """One leaf of each dtype at odd sizes: the port's numpy reference,
    and its wrapper's plain version on a tensor and on the numpy array,
    equal the JAX reference; and the JAX device words where JAX keeps
    the dtype (it narrows 64-bit dtypes without x64)."""
    a = _leaf(kind, DTYPES.index(kind) * 10 + n, n)
    want = jser.attest_fingerprint([a])
    assert tser.attest_fingerprint([a]) == want
    assert tser.attest_fingerprint([_torch(a)]) == want
    assert _port_words([_torch(a)]) == want
    assert _port_words([a]) == want
    if a.dtype.itemsize <= 4:
        assert _jax_device([a]) == want


def test_multi_leaf_fold_and_order_sensitivity():
    a = np.arange(16, dtype=np.float32)
    b = np.arange(9, dtype=np.int32)
    ab = _port_words([_torch(a), _torch(b)])
    assert ab == jser.attest_fingerprint([a, b]) == _jax_device([a, b])
    # Pytree order is part of the fingerprint.
    assert ab != _port_words([_torch(b), _torch(a)])


@pytest.mark.parametrize("byte,bit", [(0, 0), (17, 3), (255, 7)])
def test_single_bit_flip_changes_digest(byte, bit):
    a = np.arange(64, dtype=np.float32)
    clean = _port_words([_torch(a)])
    c = a.copy()
    c.view(np.uint8)[byte] ^= np.uint8(1 << bit)
    flipped = _port_words([_torch(c)])
    assert flipped != clean
    assert flipped == _jax_device([c])


def test_plain_version_chunks_and_wraps(monkeypatch):
    """The chunked spellings — the plain version's int64 and the port's
    numpy reference — carry positions across chunks and wrap every u32
    word many times, and equal the JAX numpy reference; the same leaf
    viewed as bf16, int64 and bool too."""
    a = np.full(1 << 21, 0xFF, np.uint8)
    a[::7] = np.arange(a[::7].size, dtype=np.uint8)
    monkeypatch.setattr(attest, "_PLAIN_CHUNK", 4099)
    monkeypatch.setattr(tser, "_ATTEST_CHUNK", 4097)
    assert tser.attest_leaf_words(a) == jser.attest_leaf_words(a)
    t = torch.from_numpy(a)
    for view in (t, t.view(torch.bfloat16), t.view(torch.int64)):
        assert attest.leaf_words_plain(view) == jser.attest_leaf_words(a)
    # The position-weighted sum wraps u32 tens of thousands of times.
    pos = np.arange(1, a.size + 1, dtype=np.uint64)
    assert int((pos * a).sum()) > 2 ** 44
    flags = torch.from_numpy(a[:4097] & 1).bool()
    assert attest.leaf_words_plain(flags) == \
        jser.attest_leaf_words(a[:4097] & 1)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    leaves = [_torch(_leaf("float32", 1, 33)), np.arange(5, dtype=np.int32),
              torch.tensor(3.0)]
    attest.reset_launches()
    assert _port_words(leaves) == jser.attest_fingerprint(
        [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
         for x in leaves])
    assert attest.LAUNCHES["attest_words"] == 0
    with pytest.raises(ValueError, match="device"):
        attest.attest_words([torch.zeros(4, device="meta")])


def test_ctypes_argtypes_match_c_prototype():
    import ctypes
    import os
    import re

    src = os.path.join(os.path.dirname(attest.__file__), os.pardir, "csrc",
                       "attest.cu")
    with open(src) as f:
        block = f.read().split('extern "C" {', 1)[1]
    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}
    protos = {name: ["ptr" if "*" in p else p.split()[0]
                     for p in (" ".join(x.split()) for x in params.split(","))]
              for name, params in re.findall(r"\bint (tft_\w+)\(([^)]*)\)",
                                             block)}
    assert {n: [kind[t] for t in ts]
            for n, ts in attest.argtypes().items()} == protos


# ------------------------------------------------------------- managers


def _q(pkg: str, **kw):
    base = dict(quorum_id=1, recover_manager_address="m:1",
                store_address="s:1", max_step=1, max_rank=0,
                max_world_size=3, replica_rank=0, replica_world_size=3,
                heal=False)
    base.update(kw)
    return (QuorumResult if pkg == "port" else JQuorumResult)(**base)


def _manager(pkg: str, client=None, replica_id="sdc0", state_dict=None):
    mod = tmanager if pkg == "port" else jmanager
    comm = (DummyCommunicator() if pkg == "port"
            else jcomm.DummyCommunicator())
    if client is None:
        client = MagicMock()
        client.quorum.return_value = _q(pkg)
        client.should_commit.return_value = True
    return mod.Manager(
        comm=comm, load_state_dict=MagicMock(),
        state_dict=state_dict or (lambda: {"w": np.arange(8, dtype=np.float32)}),
        min_replica_size=1, rank=0, world_size=1, replica_id=replica_id,
        _manager_client=client, checkpoint_bind_host="127.0.0.1")


def _addr_base(pkg: str):
    return tmanager._addr_base if pkg == "port" else jmanager._addr_base


def _quarantine(m, pkg, *bases):
    with m._metrics_lock:
        m._sdc_quarantined_bases = {_addr_base(pkg)(b) for b in bases}


@pytest.mark.parametrize("pkg", PKGS)
def test_donor_predicate_rules(pkg):
    m = _manager(pkg)
    try:
        ok = "http://live:1/checkpoint/3"
        assert m._donor_admissible(ok)
        assert not m._donor_admissible("")
        assert not m._donor_admissible("", step_s="-1")
        assert not m._donor_admissible(ok, step_s="-1")
        assert not m._donor_admissible(ok, step_s="")
        assert not m._donor_admissible(ok, step_s="2", max_step=3)
        assert m._donor_admissible(ok, step_s="3", max_step=3)
        _quarantine(m, pkg, "http://live:1/checkpoint/9")
        assert not m._donor_admissible(ok, step_s="3", max_step=3)
        assert not m._donor_admissible("http://live:1/ramckpt/img")
        assert m._donor_admissible("http://other:1/checkpoint/3",
                                   step_s="3", max_step=3)
    finally:
        m.shutdown()


def test_addr_base_and_stripe_seed_match_jax():
    for addr in ("http://h:1/checkpoint/7", "http://h:1/ramckpt/3",
                 "http://h:1/", "http://h:1"):
        assert tmanager._addr_base(addr) == jmanager._addr_base(addr)
    for rid in ("train_lm_0:5f1c", "g2", ""):
        assert tmanager._stripe_seed(rid) == jmanager._stripe_seed(rid)


@pytest.mark.parametrize("pkg", PKGS)
def test_healset_donors_filter_quarantined_and_tombstoned(pkg):
    m = _manager(pkg)
    store = FakeStore()
    store.set("torchft/healset/1", b"3:http://bad:1/checkpoint/3")
    store.set("torchft/healset/2", b"3:http://live:1/checkpoint/3")
    store.set("torchft/healset/3", b"-1:")
    m._healset_store = ("s:1", store)
    _quarantine(m, pkg, "http://bad:1")
    try:
        q = _q(pkg, max_step=3, replica_rank=0, max_world_size=4)
        assert m._healset_donors(q, "http://primary:1/checkpoint/3") == [
            "http://primary:1/checkpoint/3", "http://live:1/checkpoint/3"]
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_resolve_checkpoint_addr_raises_on_quarantined_donor(pkg,
                                                             monkeypatch):
    m = _manager(pkg)
    _quarantine(m, pkg, "http://bad:1")
    fake = MagicMock()
    fake.return_value.checkpoint_address.return_value = \
        "http://bad:1/checkpoint/7"
    monkeypatch.setattr(tmanager if pkg == "port" else jmanager,
                        "ManagerClient", fake)
    try:
        with pytest.raises(RuntimeError, match="quarantined"):
            m._resolve_checkpoint_addr("bad-manager:1")
    finally:
        m.shutdown()


def _verdict(pkg, sd, rids="", addrs=""):
    return _q(pkg, sdc_diverged=sd, sdc_quarantined=rids,
              sdc_quarantined_addrs=addrs)


@pytest.mark.parametrize("pkg", PKGS)
def test_latch_enters_the_full_ladder(pkg):
    store = FakeStore()
    store.set("torchft/healset/0", b"1:http://me:1/checkpoint/1")
    m = _manager(pkg)
    m._healset_store = ("s:1", store)
    m._last_round_facts = ("s:1", 0, 3)
    m._flight = MagicMock()
    try:
        m._consume_fleet_hint(_verdict(pkg, True, rids="sdc0",
                                       addrs="http://me:1/checkpoint/1"))
        assert m._sdc_quarantined
        assert not m.is_participating()
        assert store.kv["torchft/healset/0"] == b"-1:"  # withdrawn
        mx = m.metrics()
        assert mx["sdc_quarantined"] == 1.0
        assert mx["sdc_quarantines_total"] == 1.0
        assert m._flight.dump.call_args[0][0] == "sdc_divergence"
        assert "sdc_divergence" in [e["event"] for e in m.history()]
        assert "sdc0" in m._sdc_quarantined_peers
        assert "http://me:1" in m._sdc_quarantined_bases
        # The checkpoint server now refuses its state.
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(m._ckpt_server.address(), timeout=10)
        assert ei.value.code == 503
    finally:
        m.shutdown()


def test_checkpoint_serve_gate_503():
    srv = CheckpointServer(
        lambda: {"user": {"w": np.ones(4, np.float32)},
                 "torchft": {"step": 1}}, bind_host="127.0.0.1")
    try:
        srv.allow_checkpoint(1)
        addr = srv.address()
        assert urllib.request.urlopen(addr, timeout=10).status == 200
        srv.set_quarantined(True)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(addr, timeout=10)
        assert ei.value.code == 503
        srv.set_quarantined(False)
        assert urllib.request.urlopen(addr, timeout=10).status == 200
    finally:
        srv.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_absent_verdict_field_is_inert(pkg):
    m = _manager(pkg)
    try:
        class Bare:
            pass

        m._consume_sdc_verdict(Bare())
        assert not m._sdc_quarantined
        with m._metrics_lock:
            m._sdc_quarantined = True
        m._consume_sdc_verdict(Bare())
        assert m._sdc_quarantined  # no attestation field, no all-clear
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_clear_deferred_while_heal_in_flight(pkg):
    m = _manager(pkg)
    try:
        m._consume_fleet_hint(_verdict(pkg, True, rids="sdc0"))
        assert m._sdc_quarantined
        with m._metrics_lock:
            m._healing = True
        m._consume_fleet_hint(_verdict(pkg, False))
        assert m._sdc_quarantined  # a mid-heal all-clear waits
        with m._metrics_lock:
            m._healing = False
        m._consume_fleet_hint(_verdict(pkg, False))
        assert not m._sdc_quarantined
        assert m.is_participating()
        assert m.metrics()["sdc_quarantine_clears_total"] == 1.0
        assert "sdc_quarantine_clear" in [e["event"] for e in m.history()]
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_reheal_with_no_admissible_donor_stays_latched(pkg):
    store = FakeStore()
    store.set("torchft/healset/1", b"-1:")
    store.set("torchft/healset/2", b"1:http://bad:1/checkpoint/1")
    m = _manager(pkg)
    m._healset_store = ("s:1", store)
    with m._metrics_lock:
        m._sdc_quarantined = True
        m._sdc_quarantined_bases = {"http://bad:1"}
    try:
        m._sdc_reheal(_q(pkg, recover_manager_address=""))
        assert m._sdc_quarantined
        assert m._pending_state_dict is None
        assert m.metrics()["sdc_reheals_total"] == 1.0
        assert m.metrics()["heal_count"] == 0.0  # no fetch started
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_never_fires_on_a_healer_or_quarantined_group(pkg):
    ch = tchaos if pkg == "port" else jchaos
    sched = ch.ChaosSchedule(seed=1, endpoints={
        "sdc": ch.EndpointChaos(sdc_flip_rate=1.0)})
    ch.install(sched)
    m = _manager(pkg)
    try:
        with m._metrics_lock:
            m._healing = True
        m._maybe_chaos_sdc()
        assert m.metrics()["sdc_chaos_flips_total"] == 0.0
        with m._metrics_lock:
            m._healing = False
            m._sdc_quarantined = True
        m._maybe_chaos_sdc()
        assert m.metrics()["sdc_chaos_flips_total"] == 0.0
        assert "sdc" not in sched._counts  # guarded before the draw
        with m._metrics_lock:
            m._sdc_quarantined = False
        m._maybe_chaos_sdc()
        assert m.metrics()["sdc_chaos_flips_total"] == 1.0
    finally:
        ch.uninstall()
        m.shutdown()


@pytest.mark.parametrize("frac", [0.0, 0.37, 0.5, 0.999])
def test_flip_and_digest_match_jax(frac):
    """The same draw flips the same bit in both packages — through
    ``load_state_dict`` for a numpy state, in place for the port's
    tensors — and the digests before and after agree."""
    base = {"b": np.ones(7, np.float32), "w": np.arange(64, dtype=np.float32)}
    cells = {"port": {k: v.copy() for k, v in base.items()},
             "jax": {k: v.copy() for k, v in base.items()},
             "tensor": {k: torch.from_numpy(v.copy())
                        for k, v in base.items()}}
    ms = {}
    for name, cell in cells.items():
        pkg = "jax" if name == "jax" else "port"
        ms[name] = m = _manager(pkg, state_dict=lambda _c=cell: _c)
        m._user_load_state_dict = \
            lambda s, _c=cell: (_c.clear(), _c.update(s))
    try:
        clean = {n: m._compute_state_digest() for n, m in ms.items()}
        assert len(set(clean.values())) == 1
        for m in ms.values():
            m._apply_sdc_flip(frac)
        flipped = {n: m._compute_state_digest() for n, m in ms.items()}
        assert len(set(flipped.values())) == 1
        assert flipped["port"] != clean["port"]
        for k in base:
            want = cells["jax"][k].tobytes()
            assert cells["port"][k].tobytes() == want
            assert cells["tensor"][k].numpy().tobytes() == want
        assert ms["port"].metrics()["sdc_digests_total"] == 2.0
    finally:
        for m in ms.values():
            m.shutdown()


# ------------------------------------------------------------ the soak


class SdcSoakHarness:
    """Three Managers of one package against that package's fleet
    aggregator (the lighthouse's Python mirror): every round each group
    steps (its quorum resolved before the next group's, so a re-heal sees
    this round's advertisements), exchanges and votes, and its committed
    state's digest is ingested as the piggyback would carry it; the NEXT
    round's quorum responses echo the aggregate's verdicts. Real
    checkpoint HTTP donors, a shared fake quorum store."""

    RIDS = ("g0", "g1", "g2")

    def __init__(self, pkg: str, monkeypatch) -> None:
        self.pkg = pkg
        self.fleet = tfleet if pkg == "port" else jfleet
        self.store = FakeStore()
        self.agg = self.fleet.FleetAggregator()
        self.now = NOW
        self.cells, self.mgrs, self.clients = {}, {}, {}
        self.verdicts: dict = {}
        # No primary resolution over the network: every donor comes from
        # the advertisements.
        monkeypatch.setattr(
            (tmanager if pkg == "port" else jmanager).Manager,
            "_resolve_checkpoint_addr",
            lambda self, addr: (_ for _ in ()).throw(
                RuntimeError("no manager RPC in the soak")))
        for i, rid in enumerate(self.RIDS):
            # Two leaves of equal bytes: a striped re-heal takes one from
            # each donor.
            cell = {"w": np.arange(64, dtype=np.float32).copy(),
                    "b": np.ones(64, dtype=np.float32)}
            self.cells[rid] = cell
            client = MagicMock()
            client.quorum.return_value = self._qr(i, 1)
            client.should_commit.return_value = True
            self.clients[rid] = client
            m = _manager(pkg, client=client, replica_id=rid,
                         state_dict=lambda _c=cell: _c)
            m._user_load_state_dict = \
                lambda s, _c=cell: (_c.clear(), _c.update(s))
            m._healset_store = ("s:1", self.store)
            self.mgrs[rid] = m

    def _qr(self, rank, step, **kw):
        return _q(self.pkg, max_step=step, max_rank=2, replica_rank=rank,
                  **kw)

    def round(self, r):
        rids = ",".join(sorted(self.verdicts))
        addrs = ",".join(sorted(
            {rec.get("trace_addr", "") for rec in self.verdicts.values()
             if rec.get("trace_addr")}))
        for i, rid in enumerate(self.RIDS):
            self.clients[rid].quorum.return_value = self._qr(
                i, r, sdc_diverged=rid in self.verdicts,
                sdc_quarantined=rids, sdc_quarantined_addrs=addrs)
        for rid in self.RIDS:
            m = self.mgrs[rid]
            m.step()
            m._quorum_future.result()
        digests = {}
        for rid in self.RIDS:
            m = self.mgrs[rid]
            if m.is_participating():
                m.allreduce({"g": np.ones(4, np.float32)}).result()
            m.should_commit()  # a healer applies its restore here
            digests[rid] = m._compute_state_digest()
            self.agg.ingest(self.fleet.StepDigest(
                replica_id=rid, step=r, step_wall_ms=100.0,
                healing=bool(m._healing or not m.is_participating()),
                quorum_id=1, state_digest=digests[rid],
                trace_addr=m._ckpt_server.address()), now_ms=self.now)
        self.now += 1000
        self.agg.aggregate(now_ms=self.now)
        self.verdicts = self.agg.quarantined()
        return digests

    def converged(self) -> bool:
        ref = self.cells[self.RIDS[0]]
        return all(ref[k].tobytes() == self.cells[rid][k].tobytes()
                   for rid in self.RIDS[1:] for k in ref)

    def shutdown(self) -> None:
        for m in self.mgrs.values():
            m.shutdown()


def _soak(pkg, monkeypatch, rounds, seed=42, rate=1.0, flip=True):
    ch = tchaos if pkg == "port" else jchaos
    h = SdcSoakHarness(pkg, monkeypatch)
    ch.install(ch.ChaosSchedule(seed=seed, endpoints={
        "sdc:g2": ch.EndpointChaos(sdc_flip_rate=rate if flip else 0.0,
                                   max_faults=1)}))
    timeline = []
    try:
        for r in range(1, rounds + 1):
            digests = h.round(r)
            mx = h.mgrs["g2"].metrics()
            timeline.append(dict(
                round=r, flips=mx["sdc_chaos_flips_total"],
                verdicts=sorted(h.verdicts),
                latched=h.mgrs["g2"]._sdc_quarantined,
                reheals=mx["sdc_reheals_total"],
                clears=mx["sdc_quarantine_clears_total"],
                donors=mx["heal_striped_donors"], digests=digests))
    finally:
        ch.uninstall()
    return h, timeline


def test_soak_detect_quarantine_heal_converge_matches_jax(monkeypatch):
    port, tl = _soak("port", monkeypatch, 6)
    try:
        jax_side, jtl = _soak("jax", monkeypatch, 6)
        try:
            # Flips, verdicts, latch, re-heals, clears and every digest,
            # round by round. The JAX re-heal leaves heal_striped_donors
            # at the previous heal's value; the port's sets it.
            strip = [{k: v for k, v in t.items() if k != "donors"}
                     for t in tl]
            assert strip == [{k: v for k, v in t.items() if k != "donors"}
                             for t in jtl]
            assert jax_side.converged()
        finally:
            jax_side.shutdown()
        flip = next(t["round"] for t in tl if t["flips"])
        detect = next(t["round"] for t in tl if t["verdicts"])
        assert detect - flip <= 1
        assert tl[detect - 1]["verdicts"] == ["g2"]
        assert any(t["latched"] for t in tl)
        mx = port.mgrs["g2"].metrics()
        assert mx["sdc_quarantines_total"] == 1.0
        assert mx["heal_count"] == 1.0 and mx["heal_bytes_total"] > 0
        assert tl[-1]["reheals"] == 1.0 and tl[-1]["clears"] == 1.0
        assert max(t["donors"] for t in tl) == 2.0  # striped: g0 and g1
        assert not tl[-1]["latched"] and not tl[-1]["verdicts"]
        assert port.mgrs["g2"].is_participating()
        assert port.converged()
        assert len(set(tl[-1]["digests"].values())) == 1
        for rid in ("g0", "g1"):
            assert port.mgrs[rid].metrics()["sdc_quarantines_total"] == 0.0
    finally:
        port.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_soak_clean_fleet_never_quarantines(pkg, monkeypatch):
    h, tl = _soak(pkg, monkeypatch, 4, flip=False)
    try:
        assert h.agg.quarantined() == {}
        for rid in h.RIDS:
            assert h.mgrs[rid].metrics()["sdc_quarantines_total"] == 0.0
        assert h.agg._sdc_verdicts_total == 0
        assert all(len(set(t["digests"].values())) == 1 for t in tl)
    finally:
        h.shutdown()


def test_reheal_waits_a_round_for_the_reattested_verdict(monkeypatch):
    """Port only: a verdict still standing the round right after a
    re-heal may predate the re-attested digest (the lighthouse answers
    from a cached aggregate), so that round sits out of the fold instead
    of healing again; a verdict that still stands a round later re-heals.
    """
    m = _manager("port")
    calls = []
    monkeypatch.setattr(tmanager.Manager, "_sdc_reheal",
                        lambda self, q: calls.append(self._step))
    try:
        with m._metrics_lock:
            m._sdc_quarantined = True
        m._sdc_reheal_step = 3
        for step, want in ((4, []), (5, [5])):
            with m._metrics_lock:
                m._step = step
            m._client.quorum.return_value = _q(
                "port", max_step=step, sdc_diverged=True)
            m._async_quorum_inner()
            assert calls == want, step
            assert not m.is_participating()
    finally:
        m.shutdown()


def test_healset_scrape_waits_for_a_donor_publishing_this_round():
    """Port only: a donor's advertisement one step behind the heal's
    max_step is its previous round's, about to be replaced: the scrape
    reads it again (bounded) and takes the fresh one; a tombstone and a
    missing key are skipped at once."""
    import threading

    m = _manager("port")
    store = FakeStore()
    store.set("torchft/healset/1", b"4:http://d1:1/checkpoint/4")
    store.set("torchft/healset/2", b"-1:")
    m._healset_store = ("s:1", store)
    timer = threading.Timer(0.2, store.set, args=(
        "torchft/healset/1", b"5:http://d1:1/checkpoint/5"))
    timer.start()
    try:
        q = _q("port", max_step=5, replica_rank=0, max_world_size=4)
        assert m._healset_scrape(q) == ["http://d1:1/checkpoint/5"]
    finally:
        timer.cancel()
        m.shutdown()
