"""The port Manager's ``metrics()`` / ``metrics_info()`` schema against the
JAX package's frozen one (``tests/test_metrics_schema.py``): every key of
a plane the port carries is present and numeric, so a key dropped later
fails here by name; the keys of planes not ported yet are listed, and a
key leaves that list when its plane arrives."""

from __future__ import annotations

import numbers
from unittest.mock import MagicMock

import numpy as np
import pytest

from test_metrics_schema import DOCUMENTED_INFO_KEYS, DOCUMENTED_KEYS
from torchft_tpu_torch import checkpoint_io
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch._native import QuorumResult
from torchft_tpu_torch.communicator import DummyCommunicator
from torch_fakes import fake_quorum_stores  # noqa: F401

pytestmark = pytest.mark.port

# Planes of the JAX Manager the port does not carry yet (ROADMAP A1, A3).
NOT_PORTED = {
    "policy controller": {"policy_current", "policy_switch_refusals",
                          "policy_switch_deferrals", "failure_rate"},
    "publication": {"publish_count", "publish_skipped", "publish_ms_total",
                    "publish_last_generation"},
    "RAM tier": {"ram_ckpt_heals_total", "ram_replicate_skipped",
                 "ram_replicate_errors_total", "ram_replica_collapses_total"},
}
# The JAX package's XLA executable-cache tripwires: the port compiles no
# jitted program, so it has nothing to count there.
JAX_ONLY = {"allreduce_pack_cache_misses", "allreduce_d2h_async_fallbacks",
            "sdc_digest_cache_misses"}
NOT_PORTED_INFO = {"policy_last_reason"}  # the policy controller's

PORTED = DOCUMENTED_KEYS - JAX_ONLY - set().union(*NOT_PORTED.values())


def _manager():
    client = MagicMock()
    client.quorum.return_value = QuorumResult(
        quorum_id=1, recover_manager_address="m:1", store_address="s:1",
        max_step=1, max_rank=0, max_world_size=1, replica_rank=0,
        replica_world_size=1, heal=False)
    client.should_commit.return_value = True
    return tmanager.Manager(
        comm=DummyCommunicator(), load_state_dict=MagicMock(),
        state_dict=lambda: {"w": np.ones(4, np.float32)},
        min_replica_size=1, rank=0, world_size=1, replica_id="schema",
        _manager_client=client, checkpoint_bind_host="127.0.0.1")


def _numeric(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def test_every_key_of_a_ported_plane_is_present_and_numeric():
    m = _manager()
    try:
        for got in (m.metrics(), _after_one_boundary(m)):
            missing = PORTED - set(got)
            assert not missing, (
                f"the port's Manager.metrics() lost documented key(s) "
                f"{sorted(missing)}")
            bad = {k: got[k] for k in PORTED if not _numeric(got[k])}
            assert not bad, bad
    finally:
        m.shutdown()


def _after_one_boundary(m) -> dict:
    m.step()
    m.allreduce({"g": np.ones(4, np.float32)}).result()
    assert m.should_commit()
    return m.metrics()


def test_missing_keys_are_exactly_the_unported_planes():
    """A key the port now carries must leave NOT_PORTED / JAX_ONLY; a
    documented key outside them that the port lacks fails the test
    above."""
    m = _manager()
    try:
        got = set(m.metrics())
        assert DOCUMENTED_KEYS - got == (
            JAX_ONLY | set().union(*NOT_PORTED.values()))
        assert DOCUMENTED_INFO_KEYS - set(m.metrics_info()) == \
            NOT_PORTED_INFO
        assert all(isinstance(v, str) for v in m.metrics_info().values())
    finally:
        m.shutdown()


def test_attached_writer_merges_its_counters(tmp_path):
    m = _manager()
    writer = checkpoint_io.AsyncCheckpointer()
    try:
        _after_one_boundary(m)
        m.save_durable(writer, str(tmp_path)).result(timeout=30)
        mx = m.metrics()
        for key in writer.metrics():
            assert _numeric(mx[key]), key
        assert mx["ckpt_save_count"] == 1
        assert m.metrics_info()["ckpt_last_error"] == ""
    finally:
        writer.shutdown()
        m.shutdown()
