"""Commit-gated optimizer wrapper.

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
"""

from __future__ import annotations

from typing import Dict

import torch

from torchft_tpu_torch.manager import Manager


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


class FTOptimizer:
    """Fault-tolerant wrapper: the update applies only on a committed step.

    Args:
        manager: the per-step FT manager.
        optimizer: any ``torch.optim.Optimizer`` over the trained params.
    """

    def __init__(self, manager: Manager,
                 optimizer: torch.optim.Optimizer) -> None:
        self.manager = manager
        self.optimizer = optimizer

    def begin_step(self) -> None:
        """Start the FT step (kicks the async quorum)."""
        self.manager.step()

    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor]) -> bool:
        """Commit vote, then the in-place update on a committed step.

        The vote comes first because a healing replica's vote restores the
        donor's state into ``params`` and the optimizer state (in place,
        through the manager's ``load_state_dict`` callback); the update
        then applies the received average to the restored state, landing
        bitwise on the donor's post-step state. Returns ``committed``; on
        False nothing is touched."""
        committed = self.manager.should_commit()
        if committed:
            for name, p in params.items():
                p.grad = grads[name]
            self.optimizer.step()
            for p in params.values():
                p.grad = None
        return committed
