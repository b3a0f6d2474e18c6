"""The port's DiLoCo trainers (``torchft_tpu_torch/local_sgd.py``) against
the JAX package's ``local_sgd.py`` on the CPU.

Both packages' trainers run the same schedule from the same numpy-seeded
params and batches behind one scripted manager (commit / abort / heal per
round), whose allreduce averages each pseudo-gradient with a peer tree
drawn from a seed, in numpy float32 for both: after every inner step the
params, the anchor and the outer momentum agree within rtol 1e-6 (SGD
inner; the absolute part is 1e-6 of the leaf's largest magnitude, since
an inner step that nearly cancels an element leaves it a few ulps of its
operands off, not of itself) or rtol 1e-6 / atol 1e-7 (AdamW inner at
lr 1e-3, the tolerance of ``test_torch_overlap.py``'s optax comparison). JAX runs with ``jit=False``,
as its own tests do. Then the port's own pitfalls (in-place params, the
momentum buffer torch makes lazily), the JAX-to-port state carry, and
groups over the port's own Lighthouse, Manager and HostCommunicator on
threads: bitwise-equal anchors, a streaming death and heal, and what state
attestation makes of DiLoCo's per-group state, held to the JAX package.
"""

from __future__ import annotations

import copy
import functools
import json
import threading
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from torchft_tpu import local_sgd as jlocal
from torchft_tpu_torch import local_sgd as tlocal
from torchft_tpu_torch.models import transformer as tt
from torch_fakes import few_threads  # noqa: F401

pytestmark = pytest.mark.port

SGD_TOL = dict(rtol=1e-6, atol_of_max=1e-6)
ADAMW_TOL = dict(rtol=1e-6, atol=1e-7)
LR = 1e-3


# ------------------------------------------------------------- fixtures


def _init(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(2).astype(np.float32),
            "w": rng.standard_normal(4).astype(np.float32)}


def _batch(k: int) -> np.ndarray:
    return np.random.default_rng(100 + k).standard_normal(4).astype(
        np.float32)


class _Net(nn.Module):
    """``b`` and ``w``, registered in sorted order: the fragment split of
    ``named_parameters()`` is the JAX one of the sorted dict."""

    def __init__(self, init: dict) -> None:
        super().__init__()
        self.b = nn.Parameter(torch.tensor(init["b"]))
        self.w = nn.Parameter(torch.tensor(init["w"]))


def _t_loss(model, batch):
    x = torch.as_tensor(batch)
    return torch.mean((model.w - x) ** 2) + torch.mean((model.b - x[:2]) ** 2)


def _j_loss(params, batch):
    x = jnp.asarray(batch)
    return (jnp.mean((params["w"] - x) ** 2)
            + jnp.mean((params["b"] - x[:2]) ** 2))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().copy()
    return np.array(x, dtype=np.float32)


def _close(got, want, tol, what=""):
    tol = dict(tol)
    if "atol_of_max" in tol:
        tol["atol"] = tol.pop("atol_of_max") * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class ScriptedManager:
    """Either package's manager surface on a scripted vote sequence.

    ``script[r]`` is round r's outcome: ``"commit"``, ``"abort"`` or
    ``("heal", k)`` (commit after loading the state the trainer held when
    round k started). ``allreduce`` averages the tree with round r's peer
    tree (a seeded normal draw of the same shapes) in numpy float32, or
    echoes it with ``peer=False``. The step counter is commit-gated, like
    the real Manager's."""

    def __init__(self, script, jax_side: bool, peer: bool = True) -> None:
        self.script = list(script)
        self.jax_side = jax_side
        self.peer = peer
        self.load = self.save = None
        self._step = 0
        self._should_step = True
        self._healing = False
        self.rounds = 0
        self.snaps: dict = {}
        self.step_calls = 0
        self.allreduce_calls = 0

    def factory(self, load, save):
        self.load, self.save = load, save
        return self

    def _outcome(self):
        r = self.rounds - 1
        return self.script[r] if r < len(self.script) else "commit"

    def step(self):
        self.step_calls += 1
        if self._should_step:
            self._step += 1
        self._healing = False
        self.snaps[self.rounds] = copy.deepcopy(self.save())
        self.rounds += 1

    def wait_quorum(self):
        pass

    def current_step(self):
        return self._step

    def allreduce(self, tree):
        self.allreduce_calls += 1
        leaves = [_np(x) for x in _leaves(tree)]
        if self.peer:
            rng = np.random.default_rng(1000 + self.rounds)
            leaves = [((x + rng.standard_normal(x.shape).astype(np.float32)
                        * np.float32(0.1)) / np.float32(2)).astype(
                            np.float32) for x in leaves]
        it = iter(leaves)

        def rebuild(t):
            if isinstance(t, dict):
                return {k: rebuild(t[k]) for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                return [rebuild(v) for v in t]
            v = next(it)
            return jnp.asarray(v) if self.jax_side else torch.tensor(v)

        f: Future = Future()
        f.set_result(rebuild(tree))
        return f

    def should_commit(self):
        out = self._outcome()
        if isinstance(out, tuple) and out[0] == "heal":
            self.load(copy.deepcopy(self.snaps[out[1]]))
            self._healing = True
            out = "commit"
        self._should_step = out == "commit"
        return self._should_step

    def is_healing(self):
        return self._healing

    def shutdown(self):
        pass


def _trace(state):
    """The optax trace of an sgd state (a chain's first element)."""
    return state[0].trace


def _pair(kind, inner, script, sync_every=4, fragments=2, peer=True):
    """The same trainer in both packages behind their own scripted
    managers."""
    init = _init()
    jm = ScriptedManager(script, True, peer)
    tm = ScriptedManager(script, False, peer)
    jtx = (optax.sgd(0.1) if inner == "sgd" else
           optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4))
    net = _Net(init)
    topt = (torch.optim.SGD(net.parameters(), lr=0.1) if inner == "sgd" else
            torch.optim.AdamW(net.parameters(), lr=LR, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4, foreach=False))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    if kind == "plain":
        j = jlocal.DiLoCoTrainer(_j_loss, jtx, jparams, jm.factory,
                                 sync_every=sync_every, jit=False)
        t = tlocal.DiLoCoTrainer(net, _t_loss, topt, tm.factory,
                                 sync_every=sync_every)
    else:
        j = jlocal.StreamingDiLoCoTrainer(
            _j_loss, jtx, jparams, jm.factory, sync_every=sync_every,
            fragments=fragments, jit=False)
        t = tlocal.StreamingDiLoCoTrainer(
            net, _t_loss, topt, tm.factory, sync_every=sync_every,
            fragments=fragments)
    return j, t, jm, tm


def _outer_momentum(trainer, jax_side: bool) -> dict:
    """The outer momentum per leaf name."""
    if not jax_side:
        if trainer.outer_optimizer is not None:
            return {n: _np(trainer.outer_optimizer.state[a]
                           ["momentum_buffer"])
                    for n, a in trainer.anchor.items()}
        out = {}
        for opt, names in zip(trainer.outer_optimizers,
                              trainer._frag_names):
            for n in names:
                out[n] = _np(opt.state[trainer.anchor[n]]["momentum_buffer"])
        return out
    if getattr(trainer, "outer_state", None) is not None:
        return {k: _np(v) for k, v in _trace(trainer.outer_state).items()}
    names = sorted(trainer.params)
    out = {}
    for st, idx in zip(trainer.outer_states, trainer._frag_idx):
        for i, v in zip(idx, _trace(st)):
            out[names[i]] = _np(v)
    return out


def _assert_same(j, t, tol, what=""):
    for field in ("params", "anchor"):
        jt_ = getattr(j, field)
        tt_ = getattr(t, field)
        for n in sorted(jt_):
            _close(_np(tt_[n]), _np(jt_[n]), tol, f"{what} {field}.{n}")
    jm, tm = _outer_momentum(j, True), _outer_momentum(t, False)
    assert sorted(jm) == sorted(tm)
    for n in jm:
        _close(tm[n], jm[n], tol, f"{what} momentum.{n}")


def _drive(j, t, steps, tol):
    """Both trainers through ``steps`` inner steps on the same batches,
    held together after every one; returns the committed flags."""
    seen = []
    for k in range(steps):
        _, jc = j.train_step(_batch(k))
        _, tc = t.train_step(_batch(k))
        assert jc == tc, (k, jc, tc)
        seen.append(tc)
        _assert_same(j, t, tol, what=f"step {k + 1}")
    return seen


SCRIPTS = {
    "commit": ["commit"] * 8,
    "abort_then_commit": ["commit", "abort", "commit", "abort", "abort",
                          "commit"],
    "heal": ["commit", "commit", ("heal", 1), "commit", "commit"],
}
TOLS = {"sgd": SGD_TOL, "adamw": ADAMW_TOL}


# ------------------------------------------------- round by round vs JAX


# (sync_every, inner steps) of each drive. torch's and optax's AdamW round
# differently (bias correction, decoupled decay): about half an ulp of the
# leaf's scale per inner step, which the outer momentum carries into small
# elements; past ~10 steps that exceeds atol 1e-7 there, so the AdamW
# drives sync every 2 steps and stop at 8.
DRIVES = {"sgd": (4, 20), "adamw": (2, 8)}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("inner", ["sgd", "adamw"])
def test_diloco_matches_jax_round_by_round(inner, script):
    sync_every, steps = DRIVES[inner]
    j, t, jm, tm = _pair("plain", inner, SCRIPTS[script], sync_every)
    seen = _drive(j, t, steps, TOLS[inner])
    rounds = steps // sync_every
    assert [c for c in seen if c is not None] == [
        s != "abort" for s in SCRIPTS[script][:rounds]]
    assert tm.step_calls == jm.step_calls == rounds
    assert tm.current_step() == jm.current_step()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("inner", ["sgd", "adamw"])
def test_streaming_matches_jax_round_by_round(inner, script):
    sync_every, steps = DRIVES[inner]
    j, t, jm, tm = _pair("streaming", inner, SCRIPTS[script], sync_every)
    _drive(j, t, steps, TOLS[inner])
    assert j.flush() == t.flush()
    _assert_same(j, t, TOLS[inner], what="flush")
    assert t.local_steps == j.local_steps
    assert tm.allreduce_calls == jm.allreduce_calls == steps // t.interval


# --------------------------------------------- the JAX unit tests, mirrored


def test_outer_round_cadence():
    j, t, jm, tm = _pair("plain", "sgd", [], peer=False)
    seen = _drive(j, t, 7, SGD_TOL)
    assert seen == [None, None, None, True, None, None, None]
    assert tm.step_calls == 1
    # right after the round the params were reset to the anchor, then
    # three inner steps moved them off it
    assert not np.allclose(_np(t.params["w"]), _np(t.anchor["w"]))


def test_inner_steps_do_not_communicate():
    _, t, _, tm = _pair("plain", "sgd", [], sync_every=100)
    for k in range(50):
        t.train_step(_batch(k))
    assert tm.step_calls == 0 and tm.allreduce_calls == 0


def test_failed_round_keeps_local_progress():
    j, t, _, _ = _pair("plain", "sgd", ["abort"], sync_every=2)
    t.train_step(_batch(0))
    before = _np(t.params["w"])
    anchor = _np(t.anchor["w"])
    _, committed = t.train_step(_batch(1))
    assert committed is False
    np.testing.assert_array_equal(_np(t.anchor["w"]), anchor)
    assert not np.allclose(_np(t.params["w"]), anchor)
    assert not np.allclose(_np(t.params["w"]), before)


def test_outer_applies_averaged_delta():
    j, t, _, _ = _pair("plain", "sgd", [], sync_every=1, peer=False)
    target = np.full(4, 10.0, np.float32)
    assert j.train_step(target)[1] and t.train_step(target)[1]
    _assert_same(j, t, SGD_TOL)
    assert 0 < float(_np(t.anchor["w"]).mean())


def test_streaming_schedule_launch_collect_overlap():
    _, t, _, tm = _pair("streaming", "sgd", [], peer=False)
    seen = [t.train_step(_batch(k))[1] for k in range(8)]
    assert seen == [None, None, None, True, None, True, None, True]
    assert tm.step_calls == tm.allreduce_calls == 4
    assert t._pending is not None  # one round always in flight
    assert t.flush() is True
    assert t._pending is None


def test_streaming_fragments_rotate_with_round_counter():
    _, t, _, _ = _pair("streaming", "sgd", [])
    frags = []
    for k in range(8):
        t.train_step(_batch(k))
        if k % 2:
            frags.append(t._pending[0])
    assert frags == [1, 0, 1, 0]


def test_streaming_only_synced_fragment_anchor_moves():
    _, t, _, _ = _pair("streaming", "adamw", [])
    for k in range(2):
        t.train_step(_batch(k))
    frag = t._pending[0]
    before = {n: _np(a) for n, a in t.anchor.items()}
    for k in range(2, 4):
        t.train_step(_batch(k))
    for n, a in t.anchor.items():
        moved = not np.array_equal(_np(a), before[n])
        assert moved == (n in t._frag_names[frag]), n


def test_streaming_aborted_round_retries_same_fragment():
    j, t, _, tm = _pair("streaming", "sgd", ["abort", "abort", "commit"])
    for k in range(2):
        t.train_step(_batch(k))
    first = t._pending[0]
    anchor = {n: _np(a) for n, a in t.anchor.items()}
    t.train_step(_batch(2))
    _, committed = t.train_step(_batch(3))
    assert committed is False
    for n, a in t.anchor.items():
        np.testing.assert_array_equal(_np(a), anchor[n])
    assert t._pending[0] == first  # the step did not advance
    for k in range(4, 6):
        t.train_step(_batch(k))
    assert t.flush() is True


FRAGMENT_CASES = [
    ([(2,), (4,)], 2),
    ([(100,), (1,), (1,), (1,)], 3),
    ([(1,)], 3),
    ([(3, 5), (7,), (2, 2), (11, 3), (1,), (6,)], 4),
    ([(8, 8), (8,), (8, 8), (8,), (64,)], 2),
    ([(), (4,), (4, 4)], 2),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64])
@pytest.mark.parametrize("case", range(len(FRAGMENT_CASES)))
def test_fragment_leaves_split_like_jax(case, dtype):
    shapes, k = FRAGMENT_CASES[case]
    arrays = [np.zeros(s, dtype) for s in shapes]
    want = jlocal._fragment_leaves(arrays, k)
    assert tlocal._fragment_leaves(arrays, k) == want
    tdtype = {np.float32: torch.float32, np.float16: torch.float16,
              np.int64: torch.int64}[dtype]
    tensors = [torch.zeros(s, dtype=tdtype) for s in shapes]
    assert tlocal._fragment_leaves(tensors, k) == want


# ------------------------------------------------------ the port's pitfalls


def test_outer_optimizer_is_nesterov_sgd_with_zero_momentum():
    """``diloco_outer_optimizer`` materializes its momentum as zeros, and
    three steps on the same gradients land on optax.sgd(0.7, 0.9,
    nesterov) — params and trace."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
    a = torch.tensor(p0)
    opt = tlocal.diloco_outer_optimizer([a])
    assert torch.equal(opt.state[a]["momentum_buffer"], torch.zeros(6))
    tx = jlocal.diloco_outer_optimizer()
    jp = [jnp.asarray(p0)]
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(g)], st, jp)
        jp = optax.apply_updates(jp, upd)
        tlocal._outer_step(opt, [a], [torch.tensor(g)])
        _close(_np(a), _np(jp[0]), SGD_TOL)
        _close(_np(opt.state[a]["momentum_buffer"]), _np(_trace(st)[0]),
               SGD_TOL)


@pytest.mark.parametrize("kind", ["plain", "streaming"])
def test_anchor_is_not_aliased_by_params(kind):
    _, t, _, _ = _pair(kind, "sgd", [], sync_every=4, fragments=2)
    for k in range(6):
        t.train_step(_batch(k))
        for n, p in t.params.items():
            assert p.data_ptr() != t.anchor[n].data_ptr()
    anchor = {n: _np(a) for n, a in t.anchor.items()}
    t.train_step(_batch(6))  # an inner step only
    for n, a in t.anchor.items():
        np.testing.assert_array_equal(_np(a), anchor[n])
    assert any(not np.array_equal(_np(t.params[n]), anchor[n])
               for n in anchor)


def test_at_send_is_unchanged_by_later_inner_steps():
    _, t, _, _ = _pair("streaming", "sgd", [])
    for k in range(2):
        t.train_step(_batch(k))
    frag, _, at_send = t._pending
    sent = [_np(x) for x in at_send]
    names = t._frag_names[frag]
    t.train_step(_batch(2))
    for x, want, n in zip(at_send, sent, names):
        np.testing.assert_array_equal(_np(x), want)
        assert not np.array_equal(_np(t.params[n]), want)


def _fresh(kind, inner, manager):
    net = _Net(_init(seed=9))
    opt = (torch.optim.SGD(net.parameters(), lr=0.1) if inner == "sgd"
           else torch.optim.AdamW(net.parameters(), lr=LR, eps=1e-8,
                                  weight_decay=1e-4, foreach=False))
    if kind == "plain":
        return tlocal.DiLoCoTrainer(net, _t_loss, opt, manager.factory,
                                    sync_every=2)
    return tlocal.StreamingDiLoCoTrainer(net, _t_loss, opt, manager.factory,
                                         sync_every=2, fragments=2)


@pytest.mark.parametrize("kind", ["plain", "streaming"])
def test_heal_into_a_fresh_trainer_carries_the_outer_momentum(kind):
    """A donor trains three rounds; a freshly built trainer (another init)
    loads its state at a vote, and both apply the same averaged delta:
    params, anchor, inner state and outer momentum end bitwise equal."""
    dm = ScriptedManager([], False)
    donor = _fresh(kind, "adamw", dm)
    for k in range(6):
        donor.train_step(_batch(k))
    if kind == "streaming":
        donor.flush()
    state = copy.deepcopy(donor.state_dict())
    assert any(np.abs(v).sum() > 0
               for v in _outer_momentum(donor, False).values())
    hm = ScriptedManager([], False)
    healer = _fresh(kind, "adamw", hm)
    gen = healer.heal_generation
    healer.load_state_dict(state)
    healer.local_steps = donor.local_steps
    assert healer.heal_generation == gen + 1
    for n in state["params"]:
        assert torch.equal(healer.params[n], donor.params[n])
    assert _outer_momentum(healer, False).keys() == \
        _outer_momentum(donor, False).keys()
    for n, v in _outer_momentum(donor, False).items():
        np.testing.assert_array_equal(_outer_momentum(healer, False)[n], v)
    # the optimizers still step the live tensors after the restore
    hm.rounds = dm.rounds
    hm._step = dm._step
    for k in range(6, 10):
        donor.train_step(_batch(k))
        healer.train_step(_batch(k))
    if kind == "streaming":
        donor.flush()
        healer.flush()
    for n in donor.params:
        assert torch.equal(healer.params[n], donor.params[n]), n
        assert torch.equal(healer.anchor[n], donor.anchor[n]), n
    for n, v in _outer_momentum(donor, False).items():
        np.testing.assert_array_equal(_outer_momentum(healer, False)[n], v)
    for p_h, p_d in zip(healer.params.values(), donor.params.values()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(healer.inner_optimizer.state[p_h][key],
                               donor.inner_optimizer.state[p_d][key])


def test_streaming_state_dict_from_another_thread_is_a_copy():
    """A healer's fetch (another thread) gets clones of the params and the
    inner state, which the next inner steps leave alone; the training
    thread's own call (the digest) gets the live tensors."""
    _, t, _, _ = _pair("streaming", "adamw", [])
    t.train_step(_batch(0))
    live = t.state_dict()
    assert live["params"]["w"] is t.params["w"]
    box = {}
    th = threading.Thread(target=lambda: box.update(s=t.state_dict()))
    th.start()
    th.join()
    got = box["s"]
    w = _np(t.params["w"])
    np.testing.assert_array_equal(_np(got["params"]["w"]), w)
    assert got["anchor"]["w"] is t.anchor["w"]
    t.train_step(_batch(1))
    np.testing.assert_array_equal(_np(got["params"]["w"]), w)
    assert not np.array_equal(_np(t.params["w"]), w)


@pytest.mark.parametrize("kind", ["plain", "streaming"])
def test_set_sync_every_is_staged_to_the_round_boundary(kind):
    j, t, _, tm = _pair(kind, "sgd", [], sync_every=4, fragments=2)
    with pytest.raises(ValueError):
        t.set_sync_every(0)
    if kind == "streaming":
        with pytest.raises(ValueError):
            t.set_sync_every(3)  # not divisible by the fragments
    t.train_step(_batch(0))
    j.train_step(_batch(0))
    t.set_sync_every(8)
    j.set_sync_every(8)
    assert t.sync_every == 4  # staged, not applied
    flags = _drive(j, t, 20, SGD_TOL)
    # local step of each round that returned a vote
    rounds = [k + 2 for k, c in enumerate(flags) if c is not None]
    if kind == "plain":
        # the round at local step 4 runs under 4, then applies 8
        assert rounds == [4, 8, 16]
    else:
        # the launch at local step 2 applies it: interval 2 -> 4
        assert rounds == [4, 8, 12, 16, 20]
        assert t.interval == j.interval == 4
    assert t.sync_every == j.sync_every == 8


# --------------------------------------------------------- state carried


def _toy_convert(tree) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["plain", "streaming"])
def test_diloco_state_from_jax_carries_a_round(kind):
    """A JAX trainer runs three rounds; the port's trainer (another init)
    loads its state through ``diloco_state_from_jax``; one more round on
    both from there gives the JAX round's params, anchor and momentum."""
    j, _, jm, _ = _pair(kind, "adamw", [], sync_every=2)
    for k in range(6):
        j.train_step(_batch(k))
    if kind == "streaming":
        assert j.flush() is True  # no round in flight
    state = jax.device_get(j.state_dict())
    tm = ScriptedManager([], False)
    t = _fresh(kind, "adamw", tm)
    t.load_state_dict(tt.diloco_state_from_jax(
        state, _toy_convert, fragments=getattr(t, "_frag_names", None)))
    t.local_steps = j.local_steps
    tm.rounds, tm._step = jm.rounds, jm._step
    _assert_same(j, t, ADAMW_TOL, what="carried")
    for p_t, n in zip(t.params.values(), sorted(j.params)):
        assert float(t.inner_optimizer.state[p_t]["step"]) == 6.0
    _drive(j, t, 4, ADAMW_TOL)


@functools.lru_cache(maxsize=None)
def _tiny_jax_model():
    """The JAX tiny 1-layer Transformer, its init params, tokens and
    loss (built once per module)."""
    from torchft_tpu.models import transformer as jt

    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 256, (2, 16)).astype(np.int32) for _ in range(4)]
    jmodel = jt.Transformer(jt.tiny_config(dtype=jnp.float32, num_layers=1))
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(toks[0]))

    def jloss(p, tokens):
        h = jmodel.apply(p, jnp.asarray(tokens), return_hidden=True)
        return jt.chunked_causal_lm_loss(h, p["params"]["lm_head"]["kernel"],
                                         jnp.asarray(tokens), chunk_size=16)

    return params, toks, jloss


def _tiny_pair(jtx, steps=2):
    """A JAX DiLoCo trainer (sync_every 2) on the tiny 1-layer Transformer
    after ``steps`` inner steps, its manager and the tokens."""
    params, toks, jloss = _tiny_jax_model()
    # Echo: the peer draw follows leaf order, which differs between the
    # flax tree and the port's names.
    jm = ScriptedManager([], True, peer=False)
    # Jitted: op by op, the tiny Transformer's steps take seconds.
    j = jlocal.DiLoCoTrainer(jloss, jtx, params, jm.factory, sync_every=2)
    for k in range(steps):
        j.train_step(toks[k])
    return j, jm, toks


def _tiny_loss(m, tokens):
    x = torch.tensor(tokens)
    return tt.chunked_causal_lm_loss(m(x, return_hidden=True),
                                     m.lm_head_kernel(), x, chunk_size=16)


def _tiny_trainer(opt_fn, state):
    tmodel = tt.Transformer(tt.tiny_config(dtype=torch.float32,
                                           num_layers=1), device="cpu")
    tm = ScriptedManager([], False, peer=False)
    t = tlocal.DiLoCoTrainer(tmodel, _tiny_loss,
                             opt_fn(tmodel.parameters()), tm.factory,
                             sync_every=2)
    t.load_state_dict(tt.diloco_state_from_jax(state))
    return t, tm


def test_diloco_state_from_jax_maps_the_transformer_state_exactly():
    """A JAX DiLoCo state of the tiny Transformer with AdamW inside, every
    float leaf redrawn from a seed and the count set to 2: the port's
    trainer holds, after the carry, the flax params, anchor, Adam moments
    and count and the outer trace in its own layout, bitwise."""
    j, _, _ = _tiny_pair(optax.adamw(LR), steps=0)
    rng = np.random.default_rng(7)
    state = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)).astype(np.float32)
                   if np.asarray(x).dtype == np.float32
                   else np.asarray(x) + 2),
        jax.device_get(j.state_dict()))
    t, _ = _tiny_trainer(lambda ps: torch.optim.AdamW(ps, lr=LR), state)
    adam = state["inner_state"][0]
    want = {"params": tt.params_from_jax(state["params"]),
            "anchor": tt.params_from_jax(state["anchor"]),
            "exp_avg": tt.params_from_jax(adam.mu),
            "exp_avg_sq": tt.params_from_jax(adam.nu),
            "momentum": tt.params_from_jax(_trace(state["outer_state"]))}
    for n, p in t.params.items():
        st = t.inner_optimizer.state[p]
        assert torch.equal(p.detach(), want["params"][n]), n
        assert torch.equal(t.anchor[n], want["anchor"][n]), n
        assert torch.equal(st["exp_avg"], want["exp_avg"][n]), n
        assert torch.equal(st["exp_avg_sq"], want["exp_avg_sq"][n]), n
        assert float(st["step"]) == float(adam.count) == 2.0
        assert torch.equal(
            t.outer_optimizer.state[t.anchor[n]]["momentum_buffer"],
            want["momentum"][n]), n


def test_diloco_state_from_jax_on_the_tiny_transformer():
    """The slice as a whole on the tiny Transformer: a JAX DiLoCo state
    after one round (momentum SGD inside, so the inner trace is carried
    too) goes into the port's trainer, then both run one more round on
    the same tokens; the params, anchor and outer momentum agree within
    the model comparison's tolerance (rtol 1e-4, atol 1e-5)."""
    j, jm, toks = _tiny_pair(optax.sgd(0.05, momentum=0.9))
    t, tm = _tiny_trainer(
        lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
        jax.device_get(j.state_dict()))
    tm.rounds, tm._step = jm.rounds, jm._step
    for k in range(2, 4):
        j.train_step(toks[k])
        t.train_step(toks[k])
    for field in ("params", "anchor"):
        want = tt.params_from_jax(jax.device_get(getattr(j, field)))
        for n, a in getattr(t, field).items():
            np.testing.assert_allclose(_np(a), _np(want[n]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{field}.{n}")
    mom = tt.params_from_jax(jax.device_get(_trace(j.outer_state)))
    for n, a in t.anchor.items():
        np.testing.assert_allclose(
            _np(t.outer_optimizer.state[a]["momentum_buffer"]),
            _np(mom[n]), rtol=1e-4, atol=1e-5, err_msg=n)


# ------------------------------------------- groups over the real stack


def _port_group(kind, group, lh_addr, min_replicas, init, target,
                rid=None, sync_every=4):
    net = _Net(init)
    factory = functools.partial(
        _port_manager, rid or f"{kind}{group}", lh_addr, min_replicas)
    opt = torch.optim.SGD(net.parameters(), lr=0.05)
    if kind == "plain":
        t = tlocal.DiLoCoTrainer(net, _t_loss, opt, factory,
                                 sync_every=sync_every)
    else:
        t = tlocal.StreamingDiLoCoTrainer(net, _t_loss, opt, factory,
                                          sync_every=sync_every,
                                          fragments=2)
    t.target = np.full(4, target, np.float32)
    return t


def _port_manager(rid, lh_addr, min_replicas, load, save):
    from torchft_tpu_torch import HostCommunicator, Manager

    return Manager(comm=HostCommunicator(timeout_sec=15),
                   load_state_dict=load, state_dict=save,
                   min_replica_size=min_replicas, replica_id=rid,
                   lighthouse_addr=lh_addr, rank=0, world_size=1,
                   timeout_ms=15_000, quorum_timeout_ms=15_000,
                   checkpoint_bind_host="127.0.0.1")


def _run_until(t, rounds):
    while t.manager.current_step() < rounds:
        t.train_step(t.target)
    if isinstance(t, tlocal.StreamingDiLoCoTrainer):
        t.flush()
    return {n: _np(a) for n, a in t.anchor.items()}


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("kind", ["plain", "streaming"])
def test_two_groups_converge_to_bitwise_equal_anchors(kind):
    from torchft_tpu_torch._native import Lighthouse

    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=2,
                    join_timeout_ms=1000, quorum_tick_ms=20)
    ts = []
    try:
        ts = [_port_group(kind, g, lh.address(), 2, _init(), g + 1.0)
              for g in range(2)]
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(_run_until, t, 3 if kind == "plain" else 4)
                    for t in ts]
            res = [f.result(timeout=120) for f in futs]
    finally:
        for t in ts:
            t.shutdown()
        lh.shutdown()
    for n in res[0]:
        np.testing.assert_array_equal(res[0][n], res[1][n])
    assert float(np.abs(res[0]["w"] - _init()["w"]).max()) > 0


@pytest.mark.usefixtures("few_threads")
def test_streaming_death_and_heal_keeps_anchors_bitwise_equal():
    """A group dies after two fragment rounds and restarts fresh (another
    init): it must pick the quorum-agreed fragment, heal and land the
    survivor's anchors bitwise (JAX ``test_streaming_death_and_heal``)."""
    from torchft_tpu_torch._native import Lighthouse

    total = 6
    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=500,
                    quorum_tick_ms=20)

    restarted = threading.Event()

    def survivor():
        t = _port_group("streaming", 0, lh.address(), 1, _init(), 1.0,
                        rid="shl0")
        try:
            _run_until(t, 2)
            assert restarted.wait(timeout=60)
            return _run_until(t, total)
        finally:
            t.shutdown()

    def victim():
        t = _port_group("streaming", 1, lh.address(), 1, _init(), 2.0,
                        rid="shl1")
        try:
            while t.manager.current_step() < 2:
                t.train_step(t.target)
        finally:
            t.shutdown()  # dies
        t = _port_group("streaming", 1, lh.address(), 1, _init(seed=5), 2.0,
                        rid="shl1")
        # Its manager announces the rejoin on its first beat; the
        # survivor, held after its second round, goes on only now.
        restarted.set()
        try:
            out = _run_until(t, total)
            assert t.manager.metrics()["heal_count"] >= 1
            return out
        finally:
            t.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            fa, fb = pool.submit(survivor), pool.submit(victim)
            a, b = fa.result(timeout=180), fb.result(timeout=180)
    finally:
        lh.shutdown()
    for n in a:
        np.testing.assert_array_equal(a[n], b[n])


def _fleet_verdicts(addr: str) -> int:
    with urllib.request.urlopen(f"http://{addr}/fleet/status.json",
                                timeout=10) as resp:
        return int(json.load(resp)["fleet"]["sdc_verdicts_total"])


def _attest_run(jax_side: bool, groups: int) -> tuple:
    """``groups`` plain DiLoCo trainers of one package, each chasing its
    own target, 4 outer rounds of 2 inner steps with attestation and
    fleet telemetry on (the defaults): the lighthouse's verdict count,
    the groups' quarantines, and whether the groups' last digests
    differ."""
    if jax_side:
        from torchft_tpu import HostCommunicator, Manager
        from torchft_tpu._native import Lighthouse
    else:
        from torchft_tpu_torch import HostCommunicator, Manager
        from torchft_tpu_torch._native import Lighthouse

    # The JAX package's own lighthouse keeps its fast path's race
    # (ROADMAP C1), which can split a round there; its slow path is the
    # same vote and fleet code.
    lh = Lighthouse(bind="127.0.0.1:0", min_replicas=groups,
                    join_timeout_ms=1000, quorum_tick_ms=20,
                    fast_path=not jax_side)

    def factory(g, load, save):
        return Manager(comm=HostCommunicator(timeout_sec=15),
                       load_state_dict=load, state_dict=save,
                       min_replica_size=groups, replica_id=f"att{g}",
                       lighthouse_addr=lh.address(), rank=0, world_size=1,
                       timeout_ms=15_000, quorum_timeout_ms=15_000,
                       checkpoint_bind_host="127.0.0.1")

    def run(g):
        if jax_side:
            t = jlocal.DiLoCoTrainer(
                _j_loss, optax.adamw(LR),
                {k: jnp.asarray(v) for k, v in _init().items()},
                functools.partial(factory, g), sync_every=2, jit=False)
        else:
            net = _Net(_init())
            t = tlocal.DiLoCoTrainer(
                net, _t_loss, torch.optim.AdamW(net.parameters(), lr=LR),
                functools.partial(factory, g), sync_every=2)
        x = np.full(4, g + 1.0, np.float32)
        try:
            while t.manager.current_step() < 4:
                t.train_step(x)
            m = t.manager
            return (m.metrics()["sdc_quarantines_total"],
                    m._last_state_digest)
        finally:
            t.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=groups) as pool:
            res = [f.result(timeout=120) for f in
                   [pool.submit(run, g) for g in range(groups)]]
        verdicts = _fleet_verdicts(lh.address())
    finally:
        lh.shutdown()
    digests = [d for _, d in res]
    return (verdicts, sum(q for q, _ in res),
            all(digests) and len(set(digests)) == groups)


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("groups", [2, 3])
def test_attestation_under_diloco_matches_jax(groups):
    """Under DiLoCo each group's state holds its own inner AdamW moments
    and its own drifted params, so the groups' digests all differ at every
    boundary: no strict majority, no verdict, no quarantine. The JAX
    package gives that at two groups and at three, and so must the port:
    DiLoCo leaves state attestation blind (ROADMAP C)."""
    want = _attest_run(True, groups)
    got = _attest_run(False, groups)
    assert got == want == (0, 0, True)
