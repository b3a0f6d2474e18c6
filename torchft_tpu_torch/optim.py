"""Commit-gated optimizer wrappers (the JAX package's ``optim.py``).

The JAX package commits by swapping the ``(params, opt_state)`` pytrees, so
"don't commit" means keeping the old ones. Here the update is a
``torch.optim.Optimizer.step()`` that writes params and optimizer state in
place and cannot be undone, so the order is the reference's
``OptimizerWrapper`` one: the commit vote first, then the in-place step
only if the step committed.

    opt = FTOptimizer(manager, torch.optim.AdamW(params, ...))
    opt.begin_step()                              # quorum, async
    loss = loss_fn(model, batch); loss.backward() # overlaps the quorum
    avg = manager.allreduce(grads).result()
    committed = opt.apply(named_params, avg)

:class:`FTOptimizer` also runs the sharded update
(``Manager(shard_update=True)``): it steps a copy of this rank's stripe of
the params and of the stripe's optimizer state before the vote, and adopts
the copy only on commit. :class:`DelayedOptimizer` is the commit side of
the cross-step overlap engine (``Manager(overlap_steps=1)``), and
:class:`OptimizerWrapper` the reference's imperative surface.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch.manager import Manager, ShardedGrads
from torchft_tpu_torch.utils import tree_flatten


def init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Materialize Adam/AdamW state (``step``, ``exp_avg``,
    ``exp_avg_sq``) for every parameter now, as ``optax.adamw``'s ``init``
    does, instead of at the first ``step()``: a healer's state must have
    the donor's structure before either has stepped. The layout is what
    ``torch.optim.AdamW`` creates itself (a float32 ``step`` scalar on the
    CPU, moments like the parameter), so its ``step()`` adopts it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.tensor(0.0, dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def state_dict_of(params: Dict[str, torch.Tensor],
                  optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``{"params": {name: tensor}, "opt_state": {name: {"exp_avg",
    "exp_avg_sq", "step"}}}`` of live tensors, the heal payload's layout
    (the serializer flattens it in sorted-key order)."""
    return {"params": dict(params),
            "opt_state": {name: dict(optimizer.state[p])
                          for name, p in params.items()}}


def load_state_in_place(params: Dict[str, torch.Tensor],
                        optimizer: torch.optim.Optimizer,
                        state: Dict[str, Any]) -> None:
    """Copy a restored state into the live tensors in place, so the
    optimizer's parameter references stay valid; an ``opt_state`` of
    ``None`` (the sharded update's payload) restores the params only."""
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state["params"][name])
            if state.get("opt_state") is None:
                continue
            dst = optimizer.state[p]
            for key, val in state["opt_state"][name].items():
                if isinstance(dst.get(key), torch.Tensor):
                    dst[key].copy_(val)
                else:
                    dst[key] = val


def _clone_state(state: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def _state_bytes(states: List[Dict[str, Any]]) -> float:
    return float(sum(v.numel() * v.element_size() for st in states
                     for v in st.values() if isinstance(v, torch.Tensor)))


def _sync(tensors: List[torch.Tensor]) -> None:
    """Wait for the device work on ``tensors`` (stage timings only)."""
    for t in tensors:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class FTOptimizer:
    """Fault-tolerant wrapper: the update applies only on a committed step.

    Args:
        manager: the per-step FT manager.
        optimizer: a ``torch.optim`` optimizer over the trained params with
            one param group. Under ``Manager(shard_update=True)`` it must
            be elementwise (SGD, Adam, AdamW): its class and
            hyperparameters, ``foreach`` included, then step this rank's
            stripe, and its own state stays empty.
        shard_update: the manager's ``shard_update()``, when the caller
            has read it already.
    """

    def __init__(self, manager: Manager, optimizer: torch.optim.Optimizer,
                 shard_update: Optional[bool] = None) -> None:
        self.manager = manager
        self.optimizer = optimizer
        # The trainer passes the mode it read; None asks the manager.
        self._shard_mode = (manager.shard_update() if shard_update is None
                            else shard_update)
        # (geometry key, one state dict per chunk stripe): this rank's
        # stripe state, outside the healed state dict, whose structure
        # must match across ranks while stripe shapes differ per rank.
        self._shard_state: Optional[Tuple[tuple, list]] = None
        # Wall split (seconds) of the most recent stripe update.
        self.last_update_timings: dict = {}

    def begin_step(self) -> None:
        """Start the FT step (kicks the async quorum)."""
        self.manager.step()

    def apply(self, params: Dict[str, torch.Tensor], grads: Any) -> bool:
        """Commit vote, then the in-place update on a committed step.

        The vote comes first because a healing replica's vote restores the
        donor's state into ``params`` and the optimizer state (in place,
        through the manager's ``load_state_dict`` callback); the update
        then applies the received average to the restored state, landing
        bitwise on the donor's post-step state. Returns ``committed``; on
        False nothing is touched.

        A :class:`~torchft_tpu_torch.manager.ShardedGrads` (from
        :meth:`Manager.reduce_scatter`) takes the sharded update
        (:meth:`_apply_sharded`); so does a plain tree in shard mode (a
        single-group step), as a world-1 stripe, so that the stripe state
        stays the one optimizer state either way."""
        if isinstance(grads, ShardedGrads):
            return self._apply_sharded(params, grads)
        if self._shard_mode:
            return self._apply_sharded(params,
                                       self._local_full_shards(grads))
        committed = self.manager.should_commit()
        if committed:
            for name, p in params.items():
                p.grad = grads[name]
            self.optimizer.step()
            for p in params.values():
                p.grad = None
        return committed

    def _local_full_shards(self, grads: Any) -> ShardedGrads:
        """The world-1 :class:`ShardedGrads` of a plain averaged tree: the
        stripe of each chunk is the whole chunk."""
        leaves, treedef = tree_flatten(grads)
        sched = self.manager._get_schedule(treedef, leaves)
        chunks = [c for cs in sched.chunks for c in cs]
        with torch.no_grad():
            shards = [torch.cat([leaves[i].detach().reshape(-1)
                                 for i in c.idx]) for c in chunks]
        return ShardedGrads(chunks, shards, 0, 1, leaves, treedef)

    def _stripe_optimizer(self, stripes: List[torch.Tensor]
                          ) -> torch.optim.Optimizer:
        """A fresh optimizer of the user's class and hyperparameters over
        the stripe tensors."""
        if len(self.optimizer.param_groups) != 1:
            raise ValueError("the sharded update needs an optimizer with "
                             "one param group")
        group = {k: v for k, v in self.optimizer.param_groups[0].items()
                 if k != "params"}
        cls = type(self.optimizer)
        accepted = inspect.signature(cls.__init__).parameters
        opt = cls(stripes, **{k: v for k, v in group.items()
                              if k in accepted})
        # Keys the constructor sets itself (AdamW's
        # decoupled_weight_decay) are copied, not passed.
        opt.param_groups[0].update(group)
        return opt

    def _apply_sharded(self, params: Dict[str, torch.Tensor],
                       sg: ShardedGrads) -> bool:
        """The ZeRO-style commit: heal restore first, then the stripe
        update speculatively, the allgather of the updated stripes, and
        only then the vote, so that the vote covers the allgather and a
        healer's published stripe comes from its restored params.

        ``torch.optim`` updates in place and cannot be undone, so the
        update runs on copies: this rank's stripe of the params (1/world
        of the tree) and a clone of its stripe state. On commit the
        stripes are written into ``params`` and the cloned state becomes
        the stripe state; on abort both copies are dropped, and params and
        stripe state are untouched.

        The stripe state is keyed on the stripe geometry (world, rank,
        sizes): a membership change moves every rank's stripe, so every
        rank starts fresh state together, counted in
        ``shard_state_resets``; params stay bitwise lockstep."""
        m = self.manager
        # A staged heal lands in params before the stripe is read.
        m.prepare_commit()
        if not sg.chunks:
            return m.should_commit()
        t0 = time.perf_counter()
        stripes = sg.param_shards(params)
        key = sg.geometry_key()
        resets = 0
        state: Optional[list] = None
        if self._shard_state is not None and self._shard_state[0] == key:
            state = [_clone_state(st) for st in self._shard_state[1]]
        elif self._shard_state is not None:
            resets = 1
        opt = self._stripe_optimizer(stripes)
        for k, (p, g) in enumerate(zip(stripes, sg.shards)):
            p.grad = (g if isinstance(g, torch.Tensor)
                      else torch.from_numpy(g)).to(p.device)
            if state is not None:
                opt.state[p] = state[k]
        opt.step()
        new_state = [opt.state[p] for p in stripes]
        for p in stripes:
            p.grad = None
        _sync(stripes)
        t1 = time.perf_counter()
        gathered = (m.allgather_shards(sg.host_stripes(stripes)).result()
                    if sg.world > 1 else [stripes])
        t2 = time.perf_counter()
        committed = m.should_commit()
        # The vote is commit synchronisation, not update work: it stays
        # out of update_ms_total.
        tv = time.perf_counter()
        if committed:
            sg.assemble_params(gathered, params, own=stripes)
            self._shard_state = (key, new_state)
            _sync(stripes)
            t3 = time.perf_counter()
            self.last_update_timings = {
                "update": t1 - t0, "allgather": t2 - t1,
                "assemble": t3 - tv, "vote": tv - t2}
            m.record_update(((t2 - t0) + (t3 - tv)) * 1e3,
                            _state_bytes(new_state), resets)
        return committed

    def shard_state_bytes(self) -> float:
        """Bytes of this rank's stripe optimizer state (about 1/world of
        the full state); 0.0 before the first committed sharded step."""
        if self._shard_state is None:
            return 0.0
        return _state_bytes(self._shard_state[1])


class DelayedOptimizer:
    """The commit half of the cross-step overlap engine
    (``Manager(overlap_steps=1)``; JAX ``optim.py:260``).

    The loop (what :class:`~torchft_tpu_torch.parallel.step.FTTrainer`
    runs when its manager has ``overlap_steps() == 1``)::

        opt = DelayedOptimizer(manager, torch.optim.AdamW(...))
        for batch in data:
            grads = fwd_bwd(params, batch)    # enqueued on the device
            if opt.pending():
                opt.settle()                  # drain, vote, apply or drop
            opt.begin_step()                  # gated on that vote
            opt.stage(params, manager.allreduce(grads))
        opt.flush()                           # the final step applies

    Gradients are one step stale: step k's are evaluated at the params
    before step k-1's update applied. Step N's vote is cast at the N+1
    boundary, before ``step()`` advances the counter, so an abort still
    does not advance. A vote abort or a latched error drops the stale
    gradients (``overlap_grads_dropped``). A heal restore composes as in
    the sync path: the received average applies to the restored state.
    """

    def __init__(self, manager: Manager, optimizer: torch.optim.Optimizer,
                 shard_update: Optional[bool] = None) -> None:
        self._ft = FTOptimizer(manager, optimizer, shard_update)
        self.manager = manager
        self.optimizer = optimizer
        self._staged: Optional[Tuple[Dict[str, torch.Tensor],
                                     Optional[Callable[[], None]]]] = None
        # Wall split (seconds) of the most recent settle: "drain" blocked
        # on the in-flight exchange, "vote_apply" the vote and update.
        self.last_settle_timings: dict = {}

    def begin_step(self) -> None:
        """Start the next FT step; ``Manager.step`` raises while a
        deferred step is still staged."""
        self.manager.step()

    def stage(self, params: Dict[str, torch.Tensor], fut: Any,
              on_commit: Optional[Callable[[], None]] = None) -> None:
        """Stage the current step's in-flight averaged-gradient future
        for the next boundary. ``params`` follows :meth:`FTOptimizer.apply`;
        ``on_commit`` runs only when the settled step commits."""
        if self._staged is not None:
            raise RuntimeError("settle the pending step first")
        pol = getattr(self.manager, "policy", None)
        if callable(pol) and getattr(pol(), "overlap_steps", 1) == 0:
            raise RuntimeError(
                "manager policy has cross-step overlap disabled; "
                "staging a deferred step would violate the policy "
                "transition contract — switch to the sync loop at the "
                "commit boundary")
        self.manager.stage_deferred(fut)
        self._staged = (params, on_commit)

    def pending(self) -> bool:
        """True while a staged step awaits its settle."""
        return self._staged is not None

    def settle(self) -> bool:
        """Drain the staged step's exchange, cast its vote, and apply its
        update (or drop the stale gradients on abort). Returns
        ``committed``. Must run before the next :meth:`begin_step`."""
        if self._staged is None:
            raise RuntimeError("no staged step to settle")
        params, on_commit = self._staged
        self._staged = None
        t0 = time.perf_counter()
        avg = self.manager.drain_deferred()
        t1 = time.perf_counter()
        committed = self._ft.apply(params, avg)
        self.last_settle_timings = {"drain": t1 - t0,
                                    "vote_apply": time.perf_counter() - t1}
        if committed:
            if on_commit is not None:
                on_commit()
        else:
            self.manager.note_deferred_dropped()
        return committed

    def flush(self) -> Optional[bool]:
        """Settle the staged step if any (clean shutdown); the vote, or
        ``None`` when nothing was pending."""
        return self.settle() if self.pending() else None


class OptimizerWrapper:
    """The reference's imperative surface (``zero_grad`` / ``step`` /
    ``state_dict`` / ``load_state_dict``; JAX ``optim.py:396``) over
    named params: ``zero_grad()`` starts the FT step and ``step()`` applies
    :attr:`grads` (set it to the averaged gradients first) only if the
    vote passes."""

    def __init__(self, manager: Manager,
                 optimizer: torch.optim.Optimizer,
                 params: Dict[str, torch.Tensor]) -> None:
        self._ft = FTOptimizer(manager, optimizer)
        self.manager = manager
        self.optimizer = optimizer
        self.params = params
        self.grads: Optional[Any] = None

    def zero_grad(self) -> None:
        self.grads = None
        self._ft.begin_step()

    def step(self) -> bool:
        if self.grads is None:
            raise RuntimeError("set .grads before step()")
        committed = self._ft.apply(self.params, self.grads)
        self.grads = None
        return committed

    def state_dict(self) -> Dict[str, Any]:
        return state_dict_of(self.params, self.optimizer)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        load_state_in_place(self.params, self.optimizer, state)
