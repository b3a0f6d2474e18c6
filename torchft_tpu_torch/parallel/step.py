"""The fault-tolerant training step (the sync path of the JAX package's
``torchft_tpu/parallel/step.py:FTTrainer.train_step``), and the
sequence-parallel step (:class:`SPTrainer`).

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

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.transformer import chunked_nll_sum
from torchft_tpu_torch.optim import FTOptimizer, init_adam_state
from torchft_tpu_torch.parallel.sharding import shard_sequence


class FTTrainer:
    """Owns a model and its optimizer and runs the per-step FT protocol.

    Args:
        model: the module whose parameters are trained.
        loss_fn: ``loss_fn(model, batch) -> scalar loss``.
        optimizer: a ``torch.optim`` Adam/AdamW over ``model``'s
            parameters; its state is materialized at construction so a
            healer and its donor share one structure.
        manager_factory: ``factory(load_state_dict, state_dict)`` returning
            the :class:`Manager`; wires healing to the live state.
    """

    def __init__(self, model: nn.Module,
                 loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                 optimizer: torch.optim.Optimizer,
                 manager_factory: Callable[..., Manager]) -> None:
        self.model = model
        self.loss_fn = loss_fn
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.optimizer = optimizer
        init_adam_state(optimizer)
        self.manager: Manager = manager_factory(self.load_state_dict,
                                                self.state_dict)
        self._opt = FTOptimizer(self.manager, optimizer)
        self.last_loss: Optional[torch.Tensor] = None
        # Main-thread wall partition of the most recent train_step.
        self.last_step_timings: dict = {}

    def train_step(self, batch: Any) -> Tuple[torch.Tensor, bool]:
        """One fault-tolerant step; returns ``(loss, committed)``.

        The quorum round runs on the manager's thread while the forward
        and backward run here, joining at the allreduce. ``batch`` may be
        a zero-arg callable, drawn after ``manager.step()``.
        :attr:`last_step_timings` partitions the step's wall clock into
        ``compute`` (forward + backward, including waiting for the device),
        ``allreduce_wait`` (quorum, heal and the cross-group exchange),
        ``commit`` (vote + update) and ``other``."""
        t0 = time.perf_counter()
        self.manager.step()
        if callable(batch):
            batch = batch()
        t1 = time.perf_counter()
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        grads = {}
        for name, p in self.params.items():
            grads[name] = p.grad
            p.grad = None
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        t2 = time.perf_counter()
        avg = self.manager.allreduce(grads).result()
        t3 = time.perf_counter()
        committed = self._opt.apply(self.params, avg)
        self.last_loss = loss.detach()
        t4 = time.perf_counter()
        self.last_step_timings = {
            "compute": t2 - t1, "allreduce_wait": t3 - t2,
            "commit": t4 - t3, "other": t1 - t0, "total": t4 - t0}
        return self.last_loss, committed

    # ------------------------------------------------- state (for healing)

    def state_dict(self) -> Dict[str, Any]:
        """``{"params": {name: tensor}, "opt_state": {name: {"exp_avg",
        "exp_avg_sq", "step"}}}`` — live tensors, flattened in sorted-key
        order by the serializer."""
        opt = {name: dict(self.optimizer.state[p])
               for name, p in self.params.items()}
        return {"params": dict(self.params), "opt_state": opt}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a restored state into the live tensors in place, so the
        optimizer's parameter references stay valid."""
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(state["params"][name])
                dst = self.optimizer.state[p]
                for key, val in state["opt_state"][name].items():
                    if isinstance(dst.get(key), torch.Tensor):
                        dst[key].copy_(val)
                    else:
                        dst[key] = val

    def shutdown(self) -> None:
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
