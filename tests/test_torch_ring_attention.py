"""The port's sequence-parallel path on the CPU against the JAX package:
``flash_attention_block`` (values, lse, and gradients through the lse
merge) against JAX's in Pallas interpret mode with blocks of 8; the port's
ring attention on gloo CPU groups of 2 and 4 processes against JAX's
``make_ring_attention`` on as many virtual CPU devices (causal and
non-causal, GQA, gradients); and one ``SPTrainer`` step of a tiny
Transformer against JAX's sp step with ``optax.adamw`` (loss, gradients,
post-update params). Inputs come from numpy seeds and are handed to both.

The process groups start once for the module (``sp_runs``): the workers
(``tests/torch_sp_worker.py``) run every case and return their pieces;
the tests compare. Tolerance: rtol/atol 2e-4 in float32 (blockwise vs
whole-row softmax, sums in another order)."""

from __future__ import annotations

import functools
import importlib
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torchft_tpu.models import transformer as jt
from torchft_tpu.parallel.mesh import make_mesh
from torchft_tpu.parallel.ring_attention import \
    make_ring_attention as jax_ring
from torchft_tpu_torch.models import transformer as tt
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.parallel.sharding import shard_sequence

jfa = importlib.import_module("torchft_tpu.ops.flash_attention")

pytestmark = pytest.mark.port

TOL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sp_worker.py")
WORLDS = (2, 4)
# The sp step's model (tiny_config overrides; the worker builds the same).
TINY = dict(dtype=jnp.float32, num_kv_heads=2, num_layers=1)


def _close(a, b, tol=TOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol,
                               atol=tol, err_msg=err_msg)


def _qkv(b, s, sk, h, h_kv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, h, d), (b, sk, h_kv, d), (b, sk, h_kv, d),
                  (b, s, h, d)))


def _ring_inputs(causal):
    """Global q, k, v, g of a ring case: GQA (8 heads over 2), S = 32."""
    return _qkv(1, 32, 32, 8, 2, 16, seed=10 + int(causal))


@functools.lru_cache(maxsize=None)
def _tiny():
    """A one-layer tiny GQA Transformer's flax params (numpy; the tree's
    shapes from ``eval_shape``, values from a numpy seed: norm scales near
    1, everything else N(0, 0.05^2)) and a [2, 32] batch."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 32)).astype(np.int32)
    shapes = jax.eval_shape(jt.Transformer(jt.tiny_config(**TINY)).init,
                            jax.random.key(0), jnp.asarray(tokens))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (float(path[-1].key == "scale")
                         + 0.05 * rng.standard_normal(x.shape)
                         ).astype(np.float32), shapes)
    return params, tokens


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _Runs:
    """The workers' results, keyed (world, rank); the first lookup waits
    for every worker."""

    def __init__(self, d, procs):
        self.d, self.procs, self.results = d, procs, None

    def __getitem__(self, key):
        if self.results is None:
            for k, proc in self.procs.items():
                out, _ = proc.communicate(timeout=120)
                assert proc.returncode == 0, f"sp worker {k}:\n{out}"
            self.results = {k: torch.load(self.d / f"out_{k[0]}_{k[1]}.pt")
                            for k in self.procs}
        return self.results[key]


@pytest.fixture(scope="module", autouse=True)
def sp_runs(tmp_path_factory):
    """Gloo CPU groups of 2 and 4 processes, started together when the
    module starts, so that they run while the JAX side compiles."""
    d = tmp_path_factory.mktemp("sp")
    for causal in (True, False):
        np.savez(d / f"ring_{int(causal)}.npz",
                 **dict(zip("qkvg", _ring_inputs(causal))))
    params, tokens = _tiny()
    torch.save({"params": tt.params_from_jax(params),
                "tokens": torch.tensor(tokens)}, d / "step.pt")
    # One thread each: six processes share the machine, at tiny sizes.
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT +
               os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for world in WORLDS:
        init = f"tcp://127.0.0.1:{_free_port()}"
        for rank in range(world):
            procs[world, rank] = subprocess.Popen(
                [sys.executable, WORKER, str(rank), str(world), init, str(d),
                 str(d / f"out_{world}_{rank}.pt")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield _Runs(d, procs)
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------- flash_attention_block

# (s, sk, shift): full, causal, blocked, and a partial shift at which every
# row still sees a key.
BLOCK_CASES = [(32, 32, 32), (32, 32, 0), (32, 32, -32), (32, 40, -4)]


@pytest.mark.parametrize("s,sk,shift", BLOCK_CASES)
def test_block_matches_jax(s, sk, shift):
    q, k, v, _ = _qkv(2, s, sk, 4, 2, 16, seed=1)
    jout, jlse = jfa.flash_attention_block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(shift), 8,
        8, interpret=True)
    out, lse = fa.flash_attention_block(torch.tensor(q), torch.tensor(k),
                                        torch.tensor(v), shift)
    assert out.shape == q.shape and lse.shape == (2 * 4, s)
    _close(out, jout)
    _close(lse, jlse)
    if shift <= -sk:
        assert torch.count_nonzero(out) == 0 and lse.max() <= -1e29


def test_block_merge_value_and_grads_match_jax():
    """Two blocks (one full, one diagonal-causal) merged through their lse,
    as the ring merges them: value and gradients, which flow through the
    lse cotangent (TestFlashAttentionBlock's merge test, both packages)."""
    q, k1, v1, _ = _qkv(1, 16, 16, 4, 2, 16, seed=4)
    _, k2, v2, _ = _qkv(1, 16, 16, 4, 2, 16, seed=9)
    b, s, h, _ = q.shape

    def merged(block, per, exp, maximum, q, k1, v1, k2, v2):
        o1, l1 = block(q, k1, v1, s)
        o2, l2 = block(q, k2, v2, 0)
        m = maximum(l1, l2)
        w1, w2 = per(exp(l1 - m)), per(exp(l2 - m))
        return ((w1 * o1 + w2 * o2) / (w1 + w2)) ** 2

    def jblock(q, k, v, shift):
        return jfa.flash_attention_block(q, k, v, jnp.int32(shift), 8, 8,
                                         interpret=True)

    def jloss(*xs):
        return jnp.sum(merged(
            jblock, lambda w: w.reshape(b, h, s).transpose(0, 2, 1)[..., None],
            jnp.exp, jnp.maximum, *xs))

    xs = (q, k1, v1, k2, v2)
    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(5))))(
        *map(jnp.asarray, xs))
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    val = merged(fa.flash_attention_block,
                 lambda w: w.reshape(b, h, s).transpose(1, 2)[..., None],
                 torch.exp, torch.maximum, *ts).sum()
    val.backward()
    _close(val.detach(), jval)
    for i, (t, want) in enumerate(zip(ts, jgrads)):
        _close(t.grad, want, err_msg=f"grad {i}")


def test_block_rows_without_keys_are_zero():
    """shift -4 with s = sk = 16: rows 0-3 see no key but share a tile
    with rows that do. The port gives them o = 0, lse ~ -1e30 and no
    gradient (the JAX kernel's answer there depends on its tiles, so
    parity is held on rows 4-15 only); everything is held to a dense
    masked softmax."""
    q, k, v, g = _qkv(1, 16, 16, 4, 2, 16, seed=5)
    jout, jlse = jfa.flash_attention_block(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(-4), 8, 8,
        interpret=True)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out, lse = fa.flash_attention_block(*ts, -4)
    (out * torch.tensor(g)).sum().backward()
    _close(out[:, 4:].detach(), np.asarray(jout)[:, 4:])
    _close(lse.reshape(1, 4, 16)[..., 4:].detach(),
           np.asarray(jlse).reshape(1, 4, 16)[..., 4:])
    assert torch.count_nonzero(out[:, :4]) == 0
    assert lse.reshape(4, 16)[:, :4].max() <= -1e29
    assert torch.count_nonzero(ts[0].grad[:, :4]) == 0

    rs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    kk, vv = (x.repeat_interleave(2, dim=2) for x in rs[1:])
    logits = torch.einsum("bqhd,bkhd->bhqk", rs[0], kk) * 16 ** -0.5
    mask = torch.ones(16, 16, dtype=torch.bool).tril(-4)
    p = torch.softmax(logits[:, :, 4:].masked_fill(~mask[4:], -1e30), -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    (ref * torch.tensor(g)[:, 4:]).sum().backward()
    _close(out[:, 4:].detach(), ref.detach(), 1e-5)
    for t, r in zip(ts, rs):
        _close(t.grad, r.grad, 1e-5)


# -------------------------------------------------------------- the ring


@functools.lru_cache(maxsize=None)
def _jax_ring(world):
    """JAX's ring on ``world`` virtual devices: ``{causal: (out, (dq, dk,
    dv))}`` of sum(out * g), both cases in one compiled program."""
    mesh = make_mesh({"sp": world}, devices=jax.devices()[:world])
    ring = jax_ring(mesh)

    def run(causal, q, k, v, g):
        def loss(q, k, v):
            out = ring(q, k, v, causal)
            return jnp.sum(out * g), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
        return out, grads

    with mesh:
        return jax.jit(lambda a, b: {True: run(True, *a),
                                     False: run(False, *b)})(
            _ring_inputs(True), _ring_inputs(False))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_matches_jax(sp_runs, world, causal):
    jout, jgrads = _jax_ring(world)[causal]
    pieces = [sp_runs[world, r][f"ring_{int(causal)}"] for r in range(world)]
    got = [torch.cat([p[i] for p in pieces], dim=1) for i in range(4)]
    _close(got[0], jout, err_msg="out")
    for name, t, want in zip(("dq", "dk", "dv"), got[1:], jgrads):
        _close(t, want, err_msg=name)


def test_one_rank_ring_is_plain_attention(sp_runs):
    assert sp_runs[2, 0]["one_rank_is_plain"]


def test_sp_train_step_matches_jax(sp_runs):
    params, tokens = _tiny()
    mesh = make_mesh({"sp": 2}, devices=jax.devices()[:2])
    model = jt.Transformer(jt.tiny_config(attention_fn=jax_ring(mesh),
                                          **TINY))
    tok = jax.device_put(jnp.asarray(tokens),
                         NamedSharding(mesh, P(None, "sp")))
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: jt.causal_lm_loss(model.apply(p, t), t)))(
                params, tok)
    tx = optax.adamw(3e-4)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    want_grads = tt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           grads))
    want_params = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, new))
    r0, r1 = sp_runs[2, 0]["step"], sp_runs[2, 1]["step"]
    assert float(r0["loss"]) == float(r1["loss"])
    _close(r0["loss"], loss)
    for name, want in want_grads.items():
        _close(r0["grads"][name], want, err_msg=name)
        _close(r0["params"][name], want_params[name], err_msg=name)
        assert torch.equal(r0["params"][name], r1["params"][name]), name


def test_shard_sequence_positions_and_targets():
    tokens = torch.arange(24).reshape(2, 12)
    shards = [shard_sequence(tokens, r, 3) for r in range(3)]
    assert torch.equal(torch.cat([s.tokens for s in shards], 1), tokens)
    assert torch.equal(shards[1].positions, torch.arange(4, 8).expand(2, 4))
    # Each shard's targets reach into the next shard; the last has one
    # fewer, and together they are the global next tokens.
    assert torch.equal(shards[0].targets[:, -1], tokens[:, 4])
    assert shards[2].targets.shape == (2, 3)
    assert torch.equal(torch.cat([s.targets for s in shards], 1),
                       tokens[:, 1:])
    with pytest.raises(ValueError, match="multiple"):
        shard_sequence(tokens, 0, 5)
