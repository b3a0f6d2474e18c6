"""The fault-tolerant training step (the JAX package's
``torchft_tpu/parallel/step.py:FTTrainer``: the sync loop, the
reduce-scatter loop of the sharded update and the cross-step overlap
loop), and the sequence-parallel step (:class:`SPTrainer`).

    trainer = FTTrainer(
        model=model, loss_fn=loss_fn,
        optimizer=torch.optim.AdamW(model.parameters(), 3e-4,
                                    weight_decay=1e-4, eps=1e-8),
        manager_factory=lambda load, save: Manager(
            comm=HostCommunicator(), load_state_dict=load, state_dict=save,
            min_replica_size=1, replica_id="group0"))
    for batch in data:
        loss, committed = trainer.train_step(batch)

Left out on purpose: the JAX trainer's speculative fused single-group
program (forward, backward and optimizer update dispatched before the
quorum confirms the step, and dropped if the vote fails). It relies on the
update being a new pytree the caller may discard; a torch optimizer step
writes params and state in place and cannot be discarded, so every step
here votes before it updates.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.transformer import chunked_nll_sum
from torchft_tpu_torch.optim import (DelayedOptimizer, FTOptimizer,
                                     init_adam_state, load_state_in_place,
                                     state_dict_of)
from torchft_tpu_torch.parallel.sharding import shard_sequence

logger = logging.getLogger(__name__)


class FTTrainer:
    """Owns a model and its optimizer and runs the per-step FT protocol.

    Args:
        model: the module whose parameters are trained.
        loss_fn: ``loss_fn(model, batch) -> scalar loss``.
        optimizer: a ``torch.optim`` Adam/AdamW over ``model``'s
            parameters; its state is materialized at construction so a
            healer and its donor share one structure. Under the sharded
            update its state is never materialized: the
            :class:`~torchft_tpu_torch.optim.FTOptimizer` keeps this
            rank's stripe state instead.
        manager_factory: ``factory(load_state_dict, state_dict)`` returning
            the :class:`Manager`; wires healing to the live state. Its
            ``overlap_steps() == 1`` selects the overlap loop, its
            ``shard_update()`` the reduce-scatter loop.
    """

    def __init__(self, model: nn.Module,
                 loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                 optimizer: torch.optim.Optimizer,
                 manager_factory: Callable[..., Manager]) -> None:
        self.model = model
        self.loss_fn = loss_fn
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.optimizer = optimizer
        # Bumped by every load_state_dict: a restore copies into the live
        # tensors in place, so the overlap loop detects a heal by this
        # count, not by the identity of the params.
        self.heal_generation = 0
        self.manager: Manager = manager_factory(self.load_state_dict,
                                                self.state_dict)
        self._overlap = self.manager.overlap_steps() == 1
        self._shard = self.manager.shard_update()
        if not self._shard:
            init_adam_state(optimizer)
        self._opt = (DelayedOptimizer if self._overlap else FTOptimizer)(
            self.manager, optimizer, self._shard)
        self.last_loss: Optional[torch.Tensor] = None
        # Main-thread wall partition of the most recent train_step.
        self.last_step_timings: dict = {}
        # Overlap loop: the most recent settled vote.
        self._last_committed = True

    def train_step(self, batch: Any) -> Tuple[torch.Tensor, bool]:
        """One fault-tolerant step; returns ``(loss, committed)``.

        The quorum round runs on the manager's thread while the forward
        and backward run here, joining at the allreduce. ``batch`` may be
        a zero-arg callable, drawn after ``manager.step()``.
        :attr:`last_step_timings` partitions the step's wall clock into
        ``compute`` (forward + backward, including waiting for the device),
        ``allreduce_wait`` (quorum, heal and the cross-group exchange),
        ``commit`` (vote + update) and ``other``. In shard mode the
        exchange is ``manager.reduce_scatter`` and the update a stripe
        update; under ``overlap_steps=1`` the step is
        :meth:`_train_step_overlap`."""
        if self._overlap:
            return self._train_step_overlap(batch)
        t0 = time.perf_counter()
        self.manager.step()
        if callable(batch):
            batch = batch()
        t1 = time.perf_counter()
        loss, grads = self._fwd_bwd(batch)
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        t2 = time.perf_counter()
        avg = self._exchange(grads).result()
        t3 = time.perf_counter()
        committed = self._opt.apply(self.params, avg)
        self.last_loss = loss
        t4 = time.perf_counter()
        self.last_step_timings = {
            "compute": t2 - t1, "allreduce_wait": t3 - t2,
            "commit": t4 - t3, "other": t1 - t0, "total": t4 - t0}
        return self.last_loss, committed

    def _fwd_bwd(self, batch: Any) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Forward and backward on the live params; the gradients are
        taken out of ``p.grad`` into a dict, so that they never meet the
        averaged gradients the optimizer assigns there."""
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        grads = {}
        for name, p in self.params.items():
            grads[name] = p.grad
            p.grad = None
        return loss.detach(), grads

    def _exchange(self, grads: Dict[str, Any]) -> Any:
        return (self.manager.reduce_scatter(grads) if self._shard
                else self.manager.allreduce(grads))

    def _train_step_overlap(self, batch: Any) -> Tuple[torch.Tensor, bool]:
        """One step of the cross-step overlap engine (JAX
        ``step.py:329``):

        1. forward and backward of this step at the current params,
           enqueued on the device;
        2. settle the previous step: drain its in-flight exchange (which
           ran under step 1's compute), cast its vote, and apply its
           update in place, or drop its gradients, or restore a heal and
           apply. The in-place update is enqueued on the same stream after
           this step's backward, so stream order has the backward read the
           params from before it;
        3. ``manager.step()``, gated on that vote as in the sync loop;
        4. start this step's exchange and stage it for the next boundary.

        So gradients are evaluated one update behind. Two cases compute
        again at the settled params instead of using step 1's gradients: a
        heal restored the params — during the settle, or inside ``step()``
        under the sync quorum (``use_async_quorum=False``), which also
        clears the healing flag there; the restore copies in place, so
        :attr:`heal_generation` tells — and a callable batch, which is
        drawn after ``step()``.

        Returns ``(loss, committed)``: this step's loss and the most
        recent settled vote (``True`` before anything settled). The last
        step stays in flight until the next call, :meth:`flush` or
        :meth:`shutdown`."""
        t0 = time.perf_counter()
        spec = None if callable(batch) else self._fwd_bwd(batch)
        gen = self.heal_generation
        t1 = time.perf_counter()
        drain = vote = 0.0
        if self._opt.pending():
            self._last_committed = self._opt.settle()
            st = self._opt.last_settle_timings
            drain, vote = st["drain"], st["vote_apply"]
        t2 = time.perf_counter()
        self._opt.begin_step()
        # Read after step(): a sync quorum restores inside it.
        healed = self.heal_generation != gen
        if callable(batch):
            batch = batch()
        if spec is None or healed:
            spec = self._fwd_bwd(batch)
        loss, grads = spec
        t3 = time.perf_counter()
        self._opt.stage(self.params, self._exchange(grads))
        self.last_loss = loss
        t4 = time.perf_counter()
        self.last_step_timings = {
            # The sync loop's keys: compute = both forward/backward
            # dispatches, allreduce_wait = blocked draining the previous
            # step's exchange, commit = its vote and update.
            "compute": (t1 - t0) + (t3 - t2), "allreduce_wait": drain,
            "commit": vote, "other": (t2 - t1 - drain - vote) + (t4 - t3),
            "total": t4 - t0}
        return loss, self._last_committed

    def flush(self) -> Optional[bool]:
        """Settle the deferred in-flight step, if any (overlap loop):
        drain its exchange, vote, apply or drop. Call before a clean
        shutdown so the final step is not dropped. Returns the vote, or
        ``None`` when nothing was pending (always in the sync loop)."""
        if self._overlap and self._opt.pending():
            self._last_committed = self._opt.settle()
            return self._last_committed
        return None

    # ------------------------------------------------- state (for healing)

    def state_dict(self) -> Dict[str, Any]:
        """``{"params": {name: tensor}, "opt_state": {name: {"exp_avg",
        "exp_avg_sq", "step"}}}`` — live tensors, flattened in sorted-key
        order by the serializer. In shard mode ``opt_state`` is ``None``,
        an empty subtree, as in the JAX trainer: the stripe state is per
        rank and stays out of the heal payload."""
        if self._shard:
            return {"params": dict(self.params), "opt_state": None}
        return state_dict_of(self.params, self.optimizer)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a restored state into the live tensors in place, so the
        optimizer's parameter references stay valid; bumps
        :attr:`heal_generation`."""
        self.heal_generation += 1
        load_state_in_place(self.params, self.optimizer, state)

    def shutdown(self) -> None:
        try:
            # Apply the final in-flight step before tearing down.
            self.flush()
        except Exception:  # noqa: BLE001 — teardown must proceed
            logger.warning("flush of the deferred step failed at "
                           "shutdown; its gradients are dropped",
                           exc_info=True)
        self.manager.shutdown()


class SPTrainer:
    """One sequence-parallel training step over an sp process group: each
    rank runs the model on its piece of the sequence (ring attention
    carries the keys across ranks), the gradients are summed over the
    group, and every rank applies the same AdamW update — the JAX
    package's sp train step (``__graft_entry__.py`` phase 2) without
    ``jit``.

        group = dist.new_group(...)   # gloo (see parallel/ring_attention.py)
        model = Transformer(llama2_7b_config(
            attention_fn=make_ring_attention(group), remat=True))
        trainer = SPTrainer(model, torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8), group)
        loss = trainer.train_step(tokens)   # the global [B, S] batch

    Each rank's loss is its NLL sum over the global count ``B * (S - 1)``,
    so the summed gradients are exactly those of the global mean
    (``causal_lm_loss``). The step stays outside the FT manager: sp inside
    a fault-tolerant replica group needs multi-rank groups.

    Args:
        model: a :class:`Transformer` whose ``attention_fn`` is a ring over
            ``group``; its parameters start equal on every rank.
        optimizer: ``torch.optim.AdamW`` (or Adam) over its parameters;
            its state is materialized now, as ``optax.adamw``'s init does.
        group: the sp group (default: the world).
        chunk_size: sequence chunk of the LM-head loss.
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 group: Optional[dist.ProcessGroup] = None,
                 chunk_size: int = 256) -> None:
        self.model = model
        self.optimizer = optimizer
        self.group = group if group is not None else dist.group.WORLD
        self.chunk_size = chunk_size
        init_adam_state(optimizer)
        # Host-clock wall partition of the most recent train_step.
        self.last_step_timings: dict = {}

    def _sync(self, t: torch.Tensor) -> None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def train_step(self, tokens: torch.Tensor) -> torch.Tensor:
        """Forward, backward, gradient sum and update on the global batch
        ``tokens`` [B, S] (S a multiple of the group size); returns the
        global mean loss. The summed gradients stay in each parameter's
        ``.grad`` until the next step. :attr:`last_step_timings` splits
        the wall into ``compute`` (forward + backward, ring hops
        included), ``allreduce`` (the gradient and loss sums) and
        ``update`` (AdamW)."""
        t0 = time.perf_counter()
        rank = dist.get_rank(self.group)
        world = dist.get_world_size(self.group)
        shard = shard_sequence(tokens, rank, world)
        self.optimizer.zero_grad(set_to_none=True)
        hidden = self.model(shard.tokens, return_hidden=True,
                            positions=shard.positions)
        b, s = tokens.shape
        loss = chunked_nll_sum(
            hidden[:, :shard.targets.shape[1]], self.model.lm_head_kernel(),
            shard.targets, self.chunk_size) / (b * (s - 1))
        loss.backward()
        loss = loss.detach()
        self._sync(loss)
        t1 = time.perf_counter()
        for p in self.model.parameters():
            dist.all_reduce(p.grad, group=self.group)
        dist.all_reduce(loss, group=self.group)
        self._sync(loss)
        t2 = time.perf_counter()
        self.optimizer.step()
        self._sync(loss)
        t3 = time.perf_counter()
        self.last_step_timings = {"compute": t1 - t0, "allreduce": t2 - t1,
                                  "update": t3 - t2, "total": t3 - t0}
        return loss
