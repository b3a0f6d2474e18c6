"""DiLoCo-style fault-tolerant local SGD (the JAX package's
``torchft_tpu/local_sgd.py``).

Each replica group trains *locally* for ``sync_every`` inner steps, with no
cross-group traffic, then runs one **outer round**: the groups quorum,
average their parameter deltas since the last synchronized anchor (the
pseudo-gradient), and apply an outer optimizer (Nesterov momentum SGD, the
DiLoCo recipe) to the anchor. Cross-group traffic drops by a factor of
``sync_every`` against per-step data parallelism.

    trainer = DiLoCoTrainer(
        model=model, loss_fn=loss_fn,
        inner_optimizer=torch.optim.AdamW(model.parameters(), 3e-4,
                                          weight_decay=1e-4, eps=1e-8),
        manager_factory=lambda load, save: Manager(
            comm=HostCommunicator(), load_state_dict=load, state_dict=save,
            min_replica_size=1, replica_id="group0"),
        sync_every=16)
    for batch in data:
        loss, committed = trainer.train_step(batch)

Fault tolerance works at outer-round granularity: the quorum, the 1/n
averaging, the commit vote and the live heal all run once per round. A
killed group loses at most one round of its own progress; a healed group
restores ``(params, anchor, inner and outer optimizer state)`` from a peer,
then applies the same averaged outer update and lands bitwise on it.

The JAX trainer swaps immutable pytrees; here the params train in place,
so the trainer keeps its own anchor tensors and copies between them (an
alias would let the next inner step move the anchor), clones the params a
fragment round sends (``at_send``), restores a heal in place and
materializes every optimizer's state at construction, so a healer and its
donor carry one state structure. The JAX package's jitted bodies
(``inner_step``, ``outer_update``, ``delta`` and the fragment versions)
are ``torch._foreach_*`` ops and the two ``torch.optim`` optimizers.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import (init_adam_state, load_state_in_place,
                                     state_dict_of)

logger = logging.getLogger(__name__)

OuterFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Materialize the state of an SGD (``momentum_buffer`` as zeros, when
    it has momentum) or Adam/AdamW optimizer now, as optax's ``init``
    does, instead of at its first ``step()``. SGD's first step then folds
    the gradient into a zero buffer, ``0.9 * 0 + g``, which is the clone
    of ``g`` torch takes otherwise, and ``optax.trace``'s first step."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        init_adam_state(optimizer)
        return
    if not isinstance(optimizer, torch.optim.SGD):
        raise TypeError(
            f"DiLoCo trainers materialize SGD, Adam or AdamW state; got "
            f"{type(optimizer).__name__}")
    for group in optimizer.param_groups:
        if not group["momentum"]:
            continue
        for p in group["params"]:
            state = optimizer.state[p]
            if "momentum_buffer" not in state:
                state["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def diloco_outer_optimizer(anchor: List[torch.Tensor], lr: float = 0.7,
                           momentum: float = 0.9) -> torch.optim.SGD:
    """The DiLoCo outer optimizer over the anchor tensors: Nesterov
    momentum SGD (JAX: ``optax.sgd(lr, momentum, nesterov=True)``), its
    momentum buffers materialized as zeros. A trainer's
    ``outer_optimizer`` is a factory of this shape, e.g.
    ``functools.partial(diloco_outer_optimizer, lr=0.5)``."""
    opt = torch.optim.SGD(anchor, lr=lr, momentum=momentum, nesterov=True)
    init_optimizer_state(opt)
    return opt


def _state_of(optimizer: torch.optim.Optimizer,
              named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return state_dict_of(named, optimizer)["opt_state"]


def _sync(tensors: List[torch.Tensor]) -> None:
    """Wait for the current stream's work on ``tensors``: the Manager's
    pack reads them on its own threads and streams."""
    if tensors and tensors[0].is_cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()


def _outer_step(optimizer: torch.optim.Optimizer,
                anchor: List[torch.Tensor], avg: List[torch.Tensor]) -> None:
    """One outer step on ``anchor`` with the averaged delta as its
    gradient (the anchor minus params: a descent direction)."""
    for a, g in zip(anchor, avg):
        a.grad = g
    optimizer.step()
    for a in anchor:
        a.grad = None


class DiLoCoTrainer:
    """Owns a model's params, their anchor and the inner and outer
    optimizer state, and runs the two-level schedule.

    Args:
        model: the module whose parameters train; they are updated in
            place.
        loss_fn: ``loss_fn(model, batch) -> scalar loss``.
        inner_optimizer: the per-step local optimizer over ``model``'s
            parameters (SGD, Adam or AdamW); its state is materialized
            now.
        manager_factory: ``factory(load_state_dict, state_dict)``
            returning the :class:`Manager`, as in ``FTTrainer``.
        outer_optimizer: a factory ``f(anchor_tensors) -> optimizer`` of
            the outer optimizer; default :func:`diloco_outer_optimizer`.
        sync_every: inner steps per outer round.
    """

    def __init__(self, model: nn.Module,
                 loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                 inner_optimizer: torch.optim.Optimizer,
                 manager_factory: Callable[..., Manager],
                 outer_optimizer: Optional[OuterFactory] = None,
                 sync_every: int = 16) -> None:
        self._validate_sync_every(int(sync_every))
        self.sync_every = int(sync_every)
        self.model = model
        self.loss_fn = loss_fn
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self._names = list(self.params)
        self.inner_optimizer = inner_optimizer
        init_optimizer_state(inner_optimizer)
        # The last globally synchronized params: tensors of their own.
        with torch.no_grad():
            self.anchor: Dict[str, torch.Tensor] = {
                n: p.detach().clone() for n, p in self.params.items()}
        self._outer_factory = outer_optimizer or diloco_outer_optimizer
        self._init_outer()
        self.local_steps = 0
        self._state_lock = threading.Lock()
        self._train_thread: Optional[int] = None
        # Boundary-staged sync_every change (set_sync_every): applied at
        # the END of the next outer round, so the current inner cycle
        # completes under the cadence its peers are counting with.
        self._pending_sync_every: Optional[int] = None
        # Bumped by every load_state_dict: a restore copies in place.
        self.heal_generation = 0
        self.last_loss: Optional[torch.Tensor] = None
        # Wall split (seconds) of the most recent outer round.
        self.last_round_timings: dict = {}
        self.manager: Manager = manager_factory(self.load_state_dict,
                                                self.state_dict)

    def _init_outer(self) -> None:
        self.outer_optimizer: Optional[torch.optim.Optimizer] = \
            self._outer_factory(self._anchor_list())
        init_optimizer_state(self.outer_optimizer)

    def _param_list(self) -> List[torch.Tensor]:
        return [self.params[n].detach() for n in self._names]

    def _anchor_list(self) -> List[torch.Tensor]:
        return [self.anchor[n] for n in self._names]

    # ------------------------------------------------------------------ api

    def _inner_step(self, batch: Any) -> torch.Tensor:
        # Under the state lock: a streaming donor serves its state while
        # inner steps run (see StreamingDiLoCoTrainer.state_dict).
        with self._state_lock:
            self._train_thread = threading.get_ident()
            self.inner_optimizer.zero_grad(set_to_none=True)
            loss = self.loss_fn(self.model, batch)
            loss.backward()
            self.inner_optimizer.step()
            self.local_steps += 1
        self.last_loss = loss.detach()
        return self.last_loss

    def train_step(self, batch: Any) -> Tuple[torch.Tensor, Optional[bool]]:
        """One inner step; every ``sync_every``-th call also runs the outer
        round. Returns ``(loss, outer_committed)``, ``None`` when no outer
        round ran this call."""
        loss = self._inner_step(batch)
        committed: Optional[bool] = None
        if self.local_steps % self.sync_every == 0:
            committed = self.outer_round()
        return loss, committed

    def outer_round(self) -> bool:
        """Quorum, averaged pseudo-gradient, vote and outer update (the FT
        protocol at round granularity). :attr:`last_round_timings` splits
        its wall into ``step`` (``manager.step()``), ``delta`` (the
        pseudo-gradient), ``allreduce`` (quorum and the cross-group
        exchange), ``vote`` (including a heal restore), ``update`` (outer
        step and the copy into the params) and ``total``."""
        m = self.manager
        ts = time.perf_counter()
        m.step()
        t0 = time.perf_counter()
        params, anchor = self._param_list(), self._anchor_list()
        with torch.no_grad():
            # Pseudo-gradient: how far this group moved from the anchor.
            delta = torch._foreach_sub(anchor, params)
        _sync(delta)
        t1 = time.perf_counter()
        avg = m.allreduce(dict(zip(self._names, delta))).result()
        t2 = time.perf_counter()
        committed = m.should_commit()  # may heal this holder in place
        t3 = time.perf_counter()
        if committed:
            # Healers included: the restored anchor and outer state and
            # the same averaged delta give the post-round params
            # everywhere.
            with torch.no_grad():
                _outer_step(self.outer_optimizer, anchor,
                            [avg[n] for n in self._names])
                torch._foreach_copy_(params, anchor)
            _sync(anchor)
        else:
            logger.warning("outer round %d aborted; continuing locally",
                           m.current_step())
        t4 = time.perf_counter()
        self.last_round_timings = {"step": t0 - ts, "delta": t1 - t0,
                                   "allreduce": t2 - t1, "vote": t3 - t2,
                                   "update": t4 - t3, "total": t4 - ts}
        self._apply_pending_sync_every()
        return committed

    # ---------------------------------------------- adaptive cadence

    def set_sync_every(self, sync_every: int) -> None:
        """Boundary-safe cadence change: validated now (in
        :class:`StreamingDiLoCoTrainer` also against ``fragments``),
        staged, and applied at the END of the next outer round, so every
        group's round boundaries keep agreeing."""
        self._validate_sync_every(int(sync_every))
        self._pending_sync_every = int(sync_every)

    def _validate_sync_every(self, sync_every: int) -> None:
        if sync_every < 1:
            raise ValueError(
                f"sync_every must be >= 1, got {sync_every!r}")

    def _apply_pending_sync_every(self) -> None:
        if self._pending_sync_every is None:
            return
        old, self.sync_every = self.sync_every, self._pending_sync_every
        self._pending_sync_every = None
        if old != self.sync_every:
            logger.info("sync_every %d -> %d at round boundary (step %d)",
                        old, self.sync_every, self.manager.current_step())

    # ------------------------------------------------- state (for healing)

    def state_dict(self) -> Dict[str, Any]:
        """``params``, ``anchor``, ``inner_state`` and ``outer_state``,
        each keyed by parameter name: live tensors (the serializer
        flattens them in sorted-key order)."""
        return {"params": dict(self.params), "anchor": dict(self.anchor),
                "inner_state": _state_of(self.inner_optimizer, self.params),
                "outer_state": _state_of(self.outer_optimizer, self.anchor)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a restored state into the live tensors and both
        optimizers' state in place, so every optimizer's references stay
        valid; bumps :attr:`heal_generation`."""
        self.heal_generation += 1
        load_state_in_place(self.params, self.inner_optimizer,
                            {"params": state["params"],
                             "opt_state": state["inner_state"]})
        self._load_outer(state)

    def _load_outer(self, state: Dict[str, Any]) -> None:
        load_state_in_place(self.anchor, self.outer_optimizer,
                            {"params": state["anchor"],
                             "opt_state": state["outer_state"]})

    def shutdown(self) -> None:
        self.manager.shutdown()


def _fragment_leaves(leaves: list, fragments: int) -> list:
    """Split leaf indices into ``fragments`` contiguous groups balanced by
    byte size. Deterministic (every process computes the identical split)
    and non-empty whenever there are at least ``fragments`` leaves: a
    group closes when it reaches its fair share of the REMAINING bytes,
    or when the remaining leaves are exactly one-per-remaining-group.
    ``leaves`` may be arrays or tensors; the split is the JAX package's
    for the same shapes and itemsizes."""
    sizes = [int(np.prod(tuple(leaf.shape) or (1,))) * _itemsize(leaf)
             for leaf in leaves]
    groups: list = []
    cur: list = []
    cur_bytes = 0
    remaining = sum(sizes)
    for i, nbytes in enumerate(sizes):
        cur.append(i)
        cur_bytes += nbytes
        groups_after = fragments - len(groups) - 1
        leaves_left = len(sizes) - i - 1
        groups_left = fragments - len(groups)
        if groups_after > 0 and (
            cur_bytes >= remaining / groups_left
            or leaves_left <= groups_after
        ):
            groups.append(cur)
            remaining -= cur_bytes
            cur, cur_bytes = [], 0
    if cur:
        groups.append(cur)
    while len(groups) < fragments:  # more fragments than leaves
        groups.append([])
    return groups


def _itemsize(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


class StreamingDiLoCoTrainer(DiLoCoTrainer):
    """DiLoCo with the outer exchange overlapped and smoothed: the params
    split into ``fragments`` groups of tensors (in ``named_parameters()``
    order, balanced by bytes), and each outer exchange syncs ONE fragment
    while the next ``sync_every / fragments`` inner steps keep training.

    The fragment a round syncs is ``current_step() % fragments``, read
    after the quorum (a rejoiner's step is rewritten by it), so every group
    averages the same tensors. When a fragment's averaged delta arrives
    (collected at the next sync point), that fragment's outer optimizer
    advances its anchor, and the live params keep the local progress made
    while the transfer flew: ``params_f = anchor_f' + (params_f -
    at_send)``, where ``at_send`` is a clone of the fragment's params at
    launch. A healed group takes ``anchor_f'`` outright. An aborted round
    keeps the local progress and retries the same fragment. See the JAX
    package's class for when streaming pays.

    Args: as :class:`DiLoCoTrainer`, plus ``fragments``, which must divide
    ``sync_every``.
    """

    def __init__(self, model: nn.Module,
                 loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                 inner_optimizer: torch.optim.Optimizer,
                 manager_factory: Callable[..., Manager],
                 outer_optimizer: Optional[OuterFactory] = None,
                 sync_every: int = 16, fragments: int = 4) -> None:
        if sync_every % fragments:
            raise ValueError("sync_every must be divisible by fragments")
        self.fragments = fragments
        self.interval = sync_every // fragments
        names = [n for n, _ in model.named_parameters()]
        self._frag_idx = _fragment_leaves(
            [p for _, p in model.named_parameters()], fragments)
        self._frag_names = [[names[i] for i in idx]
                            for idx in self._frag_idx]
        # In-flight fragment round: (fragment id, allreduce future, clone
        # of the fragment's params at send). Exists before the manager is
        # wired to state_dict / load_state_dict.
        self._pending: Optional[Tuple[int, Any, List[torch.Tensor]]] = None
        super().__init__(model, loss_fn, inner_optimizer, manager_factory,
                         outer_optimizer=outer_optimizer,
                         sync_every=sync_every)

    def _init_outer(self) -> None:
        # One outer optimizer per fragment, over that fragment's anchor
        # tensors: a fragment update must not touch the momentum of
        # tensors that did not sync. No full-tree outer state is kept.
        self.outer_optimizer = None
        self.outer_optimizers: List[torch.optim.Optimizer] = []
        for names in self._frag_names:
            opt = self._outer_factory([self.anchor[n] for n in names]) \
                if names else None
            if opt is not None:
                init_optimizer_state(opt)
            self.outer_optimizers.append(opt)

    # ------------------------------------------------------------------ api

    def train_step(self, batch: Any) -> Tuple[torch.Tensor, Optional[bool]]:
        """One inner step; every ``sync_every / fragments``-th call
        collects the in-flight fragment (if any) and launches the next one.
        Returns ``(loss, committed)``, ``None`` when no fragment round
        completed this call."""
        loss = self._inner_step(batch)
        committed: Optional[bool] = None
        if self.local_steps % self.interval == 0:
            committed = self.collect_pending()
            self.launch_fragment()
            self._apply_pending_sync_every()
        return loss, committed

    def outer_round(self) -> bool:
        """Streaming equivalent of one outer exchange: collect the
        in-flight fragment round (if any), then launch the next one."""
        committed = self.collect_pending()
        self.launch_fragment()
        self._apply_pending_sync_every()
        return bool(committed)

    def _validate_sync_every(self, sync_every: int) -> None:
        super()._validate_sync_every(sync_every)
        if sync_every % self.fragments:
            raise ValueError(
                f"sync_every ({sync_every}) must be divisible by "
                f"fragments ({self.fragments})")

    def _apply_pending_sync_every(self) -> None:
        changed = self._pending_sync_every is not None
        super()._apply_pending_sync_every()
        if changed:
            self.interval = self.sync_every // self.fragments

    def _fragment(self, frag: int) -> Tuple[List[torch.Tensor],
                                            List[torch.Tensor]]:
        names = self._frag_names[frag]
        return ([self.params[n].detach() for n in names],
                [self.anchor[n] for n in names])

    def launch_fragment(self) -> int:
        """Start the next fragment's outer round: its pseudo-gradient goes
        to the cross-group allreduce while inner steps continue."""
        m = self.manager
        m.step()
        # The fragment id must be the QUORUM-AGREED round: a rejoiner's
        # step counter is rewritten to the survivors' max_step on the
        # quorum thread.
        m.wait_quorum()
        frag = m.current_step() % self.fragments
        params_f, anchor_f = self._fragment(frag)
        with torch.no_grad():
            pseudo = torch._foreach_sub(anchor_f, params_f)
            at_send = [p.clone() for p in params_f]
        _sync(pseudo)
        self._pending = (frag, m.allreduce(pseudo), at_send)
        return frag

    def collect_pending(self) -> Optional[bool]:
        """Resolve the in-flight fragment round: commit vote, advance the
        fragment's anchor, merge the correction into the live params."""
        if self._pending is None:
            return None
        m = self.manager
        frag, fut, at_send = self._pending
        self._pending = None
        avg_f = fut.result()
        committed = m.should_commit()  # may heal this holder in place
        if not committed:
            logger.warning("fragment round %d (frag %d) aborted; "
                           "continuing locally", m.current_step(), frag)
            return False
        params_f, anchor_f = self._fragment(frag)
        if not params_f:
            return True
        with torch.no_grad():
            _outer_step(self.outer_optimizers[frag], anchor_f, avg_f)
            if m.is_healing():
                # Restored state: take the synchronized values outright.
                torch._foreach_copy_(params_f, anchor_f)
            else:
                # Global correction + local progress made in flight.
                torch._foreach_sub_(params_f, at_send)
                torch._foreach_add_(params_f, anchor_f)
        _sync(params_f)
        return True

    def flush(self) -> Optional[bool]:
        """Drain the in-flight round (end of training, or before a durable
        checkpoint)."""
        return self.collect_pending()

    # ------------------------------------------------- state (for healing)

    def state_dict(self) -> Dict[str, Any]:
        """``params``, ``anchor``, ``inner_state``, ``outer_states`` (one
        per fragment, keyed by parameter name) and ``local_steps``.

        A fragment round's serve window stays open while the next inner
        steps run, which update the params and the inner state in place.
        So a call from another thread than the training one (a healer's
        fetch) waits out the inner step in progress and returns clones of
        those two, taken before the next step starts; the anchor and the
        outer state move only in :meth:`collect_pending`, after the window
        shut."""
        if threading.get_ident() == self._train_thread:
            params = dict(self.params)
            inner = _state_of(self.inner_optimizer, self.params)
        else:
            with self._state_lock, torch.no_grad():
                params = {n: p.detach().clone()
                          for n, p in self.params.items()}
                inner = {n: {k: v.clone() if isinstance(v, torch.Tensor)
                             else v for k, v in st.items()}
                         for n, st in _state_of(self.inner_optimizer,
                                                self.params).items()}
        return {"params": params, "anchor": dict(self.anchor),
                "inner_state": inner,
                "outer_states": [
                    _state_of(opt, {n: self.anchor[n] for n in names})
                    if opt is not None else {}
                    for opt, names in zip(self.outer_optimizers,
                                          self._frag_names)],
                "local_steps": self.local_steps}

    def _load_outer(self, state: Dict[str, Any]) -> None:
        # The fragments partition the anchor: each copies its own tensors.
        for opt, names, st in zip(self.outer_optimizers, self._frag_names,
                                  state["outer_states"]):
            if opt is not None:
                load_state_in_place({n: self.anchor[n] for n in names}, opt,
                                    {"params": state["anchor"],
                                     "opt_state": st})
        self.local_steps = int(state["local_steps"])
