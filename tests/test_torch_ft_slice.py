"""The port's fault-tolerant training slice on the CPU, end to end: the
port's own native lighthouse, two replica groups of the port's transformer
over the host TCP ring, a group that leaves and rejoins and heals over
HTTP; plus the import boundary (the port never loads JAX or the JAX
package)."""

from __future__ import annotations

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from torchft_tpu_torch._native import Lighthouse
from torchft_tpu_torch.backends.host import HostCommunicator
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.transformer import (Transformer,
                                                  chunked_causal_lm_loss,
                                                  tiny_config)
from torchft_tpu_torch.parallel.step import FTTrainer
from torch_fakes import few_threads  # noqa: F401

pytestmark = pytest.mark.port

SEQ = 32


def _group(gid: int, seed: int, lighthouse: str,
           use_async_quorum: bool = True) -> FTTrainer:
    cfg = tiny_config(dtype=torch.float32, num_layers=1, embed_dim=64)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))

    def loss_fn(m, tokens):
        return chunked_causal_lm_loss(m(tokens, return_hidden=True),
                                      m.lm_head_kernel(), tokens,
                                      chunk_size=16)

    return FTTrainer(
        model=model, loss_fn=loss_fn,
        optimizer=torch.optim.AdamW(model.parameters(), lr=3e-4,
                                    weight_decay=1e-4, eps=1e-8),
        manager_factory=lambda load, save: Manager(
            comm=HostCommunicator(timeout_sec=30), load_state_dict=load,
            state_dict=save, min_replica_size=1, replica_id=f"g{gid}",
            lighthouse_addr=lighthouse, checkpoint_bind_host="127.0.0.1",
            timeout_ms=30_000, quorum_timeout_ms=30_000,
            use_async_quorum=use_async_quorum))


def _run(trainer: FTTrainer, gid: int, until: int, out: dict) -> None:
    try:
        m = trainer.manager
        while m.current_step() < until:
            # Batches from (group, step): the two groups see different data.
            rng = np.random.default_rng((gid, m.current_step()))
            tokens = torch.tensor(rng.integers(0, 256, (2, SEQ)))
            _, committed = trainer.train_step(tokens)
            out.setdefault("committed", []).append(committed)
    except BaseException as e:  # noqa: BLE001 — surfaced by the test
        out["error"] = e


def _threads(*jobs) -> None:
    ts = [threading.Thread(target=_run, args=job) for job in jobs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=90)
        assert not t.is_alive(), "a replica group hung"


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("fast_path", [True, False])
def test_two_groups_leave_rejoin_heal_bitwise(fast_path):
    """Bitwise replicas through leave, rejoin and heal, with the
    lighthouse's quorum fast path on (its default) and off."""
    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                    quorum_tick_ms=20, fast_path=fast_path)
    g0 = g1 = g1b = None
    try:
        g0 = _group(0, seed=0, lighthouse=lh.address())
        g1 = _group(1, seed=1, lighthouse=lh.address())
        r0, r1 = {}, {}
        _threads((g0, 0, 4, r0), (g1, 1, 4, r1))
        assert "error" not in r0 and "error" not in r1, (r0, r1)
        # Group 1 healed at step 1 (the non-primary of the first quorum),
        # so both hold the same state whatever their init seeds were.
        assert g1.manager.metrics()["heal_count"] == 1
        for name, p in g0.params.items():
            assert torch.equal(p, g1.params[name]), name
        g1.shutdown()
        g1 = None

        g1b = _group(1, seed=7, lighthouse=lh.address())
        r1b = {}
        _threads((g0, 0, 6, r0), (g1b, 1, 6, r1b))
        assert "error" not in r0 and "error" not in r1b, (r0, r1b)
        assert g1b.manager.metrics()["heal_count"] == 1
        assert r1b["committed"] == [True, True]
        assert g0.manager.current_step() == g1b.manager.current_step() == 6
        assert g0.manager.metrics()["committed_steps"] == 6
        for name, p in g0.params.items():
            assert torch.equal(p, g1b.params[name]), name
            s0, s1 = g0.optimizer.state[p], g1b.optimizer.state[
                g1b.params[name]]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(s0[key], s1[key]), (name, key)
    finally:
        for g in (g0, g1, g1b):
            if g is not None:
                g.shutdown()
        lh.shutdown()


@pytest.mark.usefixtures("few_threads")
def test_two_groups_sync_quorum_rejoin_heal_bitwise():
    """The sync quorum (``use_async_quorum=False``) against the real
    lighthouse with its fast path on: each asker blocks in ``step()``
    until the round answers, and a rejoining group restores there and
    takes part in its heal step. Both groups commit every step and end
    with bitwise equal params and AdamW state."""
    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                    quorum_tick_ms=20)
    g0 = g1 = None
    try:
        g0 = _group(0, seed=0, lighthouse=lh.address(),
                    use_async_quorum=False)
        g1 = _group(1, seed=1, lighthouse=lh.address(),
                    use_async_quorum=False)
        r0, r1 = {}, {}
        _threads((g0, 0, 3, r0), (g1, 1, 3, r1))
        assert "error" not in r0 and "error" not in r1, (r0, r1)
        g1.shutdown()
        g1 = _group(1, seed=7, lighthouse=lh.address(),
                    use_async_quorum=False)
        r1 = {}
        _threads((g0, 0, 5, r0), (g1, 1, 5, r1))
        assert "error" not in r0 and "error" not in r1, (r0, r1)
        assert g1.manager.metrics()["heal_count"] == 1
        assert r1["committed"] == [True, True] and all(r0["committed"])
        # Steps 1-4 each counted two participants, the heal steps (1 and
        # 4) included; under the async quorum a healer sits its heal step
        # out and the count would be 6.
        assert g0.manager.batches_committed() == 8
        assert g1.manager.batches_committed() == 8
        for name, p in g0.params.items():
            assert torch.equal(p, g1.params[name]), name
            s0, s1 = g0.optimizer.state[p], g1.optimizer.state[
                g1.params[name]]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(s0[key], s1[key]), (name, key)
    finally:
        for g in (g0, g1):
            if g is not None:
                g.shutdown()
        lh.shutdown()


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import no JAX; nor
    do the attestation wrapper's words (``csrc/attest.cu``'s plain route
    on the CPU) and the numpy fingerprint, run once; nor a durable save,
    recover and verified load through ``checkpoint_io``, a Manager's
    graceful drain (farewell, final save, ``PreemptedExit``), and the
    participation plane: a spare-mode, sync-quorum Manager with the
    weighted fold and rebalance armed, a degrade, an elastic draw and the
    chaos slow band; nor the DiLoCo trainers, plain and streaming, through
    their outer rounds."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torchft_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(torchft_tpu_torch.__path__,\n"
        "                               'torchft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'torchft_tpu_torch.parallel.ring_attention' in sys.modules\n"
        "assert 'torchft_tpu_torch.ops.attest' in sys.modules\n"
        "assert 'torchft_tpu_torch.local_sgd' in sys.modules\n"
        "import torch\n"
        "from torchft_tpu_torch import serialization\n"
        "from torchft_tpu_torch.ops import attest\n"
        "leaves = [torch.ones(3), torch.zeros(2, dtype=torch.bfloat16)]\n"
        "assert serialization.attest_combine(attest.attest_words(leaves))"
        " == serialization.attest_fingerprint(leaves)\n"
        "import tempfile\n"
        "from unittest.mock import MagicMock\n"
        "from torchft_tpu_torch import checkpoint_io, manager\n"
        "from torchft_tpu_torch._native import QuorumResult\n"
        "from torchft_tpu_torch.communicator import DummyCommunicator\n"
        "d = tempfile.mkdtemp()\n"
        "checkpoint_io.save(d + '/ckpt_1', {'w': leaves[1]})\n"
        "user, _ = checkpoint_io.load(checkpoint_io.recover(d),\n"
        "                             target={'w': leaves[1]})\n"
        "assert torch.equal(user['w'], leaves[1])\n"
        "c = MagicMock()\n"
        "c.quorum.return_value = QuorumResult(1, 'm', 's', 1, 0, 1, 0, 1,"
        " False)\n"
        "c.should_commit.return_value = True\n"
        "m = manager.Manager(comm=DummyCommunicator(),\n"
        "    load_state_dict=MagicMock(),\n"
        "    state_dict=lambda: {'w': leaves[0]},\n"
        "    min_replica_size=1, rank=0, world_size=1, _manager_client=c,\n"
        "    checkpoint_bind_host='127.0.0.1', heal_striped=False)\n"
        "w = checkpoint_io.AsyncCheckpointer()\n"
        "m.set_durable_target(w, d + '/drain')\n"
        "m.step(); m.allreduce({'g': leaves[0]}).result()\n"
        "assert m.should_commit()\n"
        "m.request_preemption(30.0)\n"
        "try:\n"
        "    m.step()\n"
        "    raise AssertionError('no drain')\n"
        "except manager.PreemptedExit:\n"
        "    pass\n"
        "assert c.farewell.called\n"
        "assert checkpoint_io.verify(d + '/drain/ckpt_1')['committed']\n"
        "import numpy as np\n"
        "from torchft_tpu_torch import WorldSizeMode, chaos, data\n"
        "m2 = manager.Manager(comm=DummyCommunicator(),\n"
        "    load_state_dict=MagicMock(),\n"
        "    state_dict=lambda: {'w': leaves[0]}, min_replica_size=1,\n"
        "    rank=0, world_size=1, _manager_client=c,\n"
        "    checkpoint_bind_host='127.0.0.1', heal_striped=False,\n"
        "    use_async_quorum=False, degraded_mode=True, rebalance=True,\n"
        "    world_size_mode=WorldSizeMode.FIXED_WITH_SPARES)\n"
        "chaos.install(chaos.parse_spec("
        "'seed=1;slow:slow_rate=1.0,slow_factor=1.5'))\n"
        "it = data.ElasticBatchIterator({'x': np.arange(64)},\n"
        "    data.ElasticSampler(64, m2, batch_size=8))\n"
        "for _ in range(2):\n"
        "    m2.step()\n"
        "    assert len(next(it)['x']) == (8 if m2.capacity_fraction() == 1"
        " else 4)\n"
        "    m2.allreduce({'g': leaves[0]}).result()\n"
        "    assert m2.should_commit() and m2.request_degrade(0.5)\n"
        "m2.shutdown(); chaos.reset()\n"
        "from torchft_tpu_torch import local_sgd\n"
        "for cls, kw in ((local_sgd.DiLoCoTrainer, {}),\n"
        "                (local_sgd.StreamingDiLoCoTrainer,"
        " {'fragments': 2})):\n"
        "    net = torch.nn.Linear(2, 2)\n"
        "    t = cls(net, lambda n, b: n(b).square().mean(),\n"
        "        torch.optim.AdamW(net.parameters()),\n"
        "        lambda load, save: manager.Manager(comm=DummyCommunicator(),\n"
        "            load_state_dict=load, state_dict=save,"
        " min_replica_size=1,\n"
        "            rank=0, world_size=1, _manager_client=c,\n"
        "            checkpoint_bind_host='127.0.0.1', heal_striped=False),\n"
        "        sync_every=2, **kw)\n"
        "    for _ in range(4):\n"
        "        t.train_step(torch.ones(1, 2))\n"
        "    assert t.manager.metrics()['committed_steps'] >= 1\n"
        "    t.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'torchft_tpu')]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line on a machine
    without a GPU, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "chip_smoke.py")
    cwd = root
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
