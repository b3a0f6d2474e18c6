"""Fault-tolerance policies: the data half of the JAX package's
``torchft_tpu/policy.py``.

An :class:`FTPolicy` bundles the fault-tolerance knobs a Manager runs
with — cross-step overlap, the wire rung (exact f32, bf16, or int8 with
error feedback), DiLoCo and its ``sync_every``, and the durable-checkpoint
cadence — and rides the Manager's metadata state dict as plain ints, so a
healer adopts the job's policy with the rest of its state. :data:`LADDER`
ranks the policies from performance-first to robustness-first and
:data:`POLICIES` names them. The controller that walks the ladder
(``PolicyController``) and the ``AdaptiveTrainer`` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch

from torchft_tpu_torch.communicator import host_dtype

# Wire-rung codes, numeric so a policy serializes into the manager
# metadata state dict (which heals and durable checkpoints carry) as
# plain ints — no string leaves for the pytree wire format to trip on.
WIRE_F32 = 0    # exact: no wire compression
WIRE_BF16 = 1   # bf16 wire dtype end-to-end (the bf16 ladder rung)
WIRE_INT8 = 2   # int8 + error-feedback (the int8 rung)

_WIRE_NAMES = {WIRE_F32: "f32", WIRE_BF16: "bf16", WIRE_INT8: "int8"}


@dataclass(frozen=True)
class FTPolicy:
    """One hot-swappable bundle of fault-tolerance knobs.

    Every field maps onto a Manager/trainer knob that was introduced
    statically:

    - ``overlap_steps``: the cross-step deferred-commit engine
      (docs/design/overlap.md). Escalation disables it first — stale
      in-flight grads are pure loss when aborts are frequent.
    - ``wire``: the wire-compression rung (:data:`WIRE_F32` /
      :data:`WIRE_BF16` / :data:`WIRE_INT8`). Narrower wire = fewer ring
      bytes = fewer transport ops a fault can land on per collective.
    - ``diloco`` + ``sync_every``: DiLoCo mode — cross-group traffic
      only every ``sync_every`` inner steps (local_sgd.py), the deepest
      rung: 1/sync_every the failure exposure per batch.
    - ``ckpt_every``: durable-checkpoint cadence in committed steps,
      consulted by trainers via ``Manager.policy().ckpt_every``
      (the Manager never initiates saves itself). Shortening it is the
      cheapest escalation: bounded loss on the next correlated failure.
    """

    name: str
    overlap_steps: int = 0
    wire: int = WIRE_F32
    diloco: bool = False
    sync_every: int = 16
    ckpt_every: int = 64

    def __post_init__(self) -> None:
        if self.overlap_steps not in (0, 1):
            raise ValueError(
                f"overlap_steps must be 0 or 1, got {self.overlap_steps!r}")
        if self.wire not in _WIRE_NAMES:
            raise ValueError(f"unknown wire rung {self.wire!r} "
                             f"(valid: {sorted(_WIRE_NAMES)})")
        if self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got "
                             f"{self.sync_every!r}")
        if self.ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got "
                             f"{self.ckpt_every!r}")
        if self.diloco and self.overlap_steps:
            raise ValueError("diloco and overlap_steps are mutually "
                             "exclusive (DiLoCo already defers commits "
                             "to outer rounds)")

    def wire_name(self) -> str:
        return _WIRE_NAMES[self.wire]

    def wire_dtype(self) -> Optional[Any]:
        """The ``allreduce_wire_dtype`` this rung maps to for the
        schedule/pack layer: ``torch.bfloat16`` for the bf16 rung,
        ``None`` otherwise (the int8 rung's chunks keep their dtype in
        the schedule and quantize in the pack or on the host — see
        ``Manager._int8_quantize_bucket``)."""
        if self.wire == WIRE_BF16:
            return torch.bfloat16
        return None

    def to_state(self) -> Dict[str, int]:
        """Numeric encoding for the manager metadata state dict (rides
        heals and durable checkpoints, so a healer/cold-start adopts the
        job's current policy — name resolved back via the ladder or
        synthesized)."""
        return {
            "policy_overlap": int(self.overlap_steps),
            "policy_wire": int(self.wire),
            "policy_diloco": int(self.diloco),
            "policy_sync_every": int(self.sync_every),
            "policy_ckpt_every": int(self.ckpt_every),
        }

    @staticmethod
    def from_state(state: Dict[str, Any],
                   ladder: Tuple["FTPolicy", ...] = ()) -> "FTPolicy":
        """Inverse of :meth:`to_state`; matches a ladder entry by knobs
        when possible so the adopted policy keeps its canonical name."""
        p = FTPolicy(
            name="adopted",
            overlap_steps=int(state.get("policy_overlap", 0)),
            wire=int(state.get("policy_wire", WIRE_F32)),
            diloco=bool(int(state.get("policy_diloco", 0))),
            sync_every=int(state.get("policy_sync_every", 16)),
            ckpt_every=int(state.get("policy_ckpt_every", 64)),
        )
        for cand in ladder:
            if cand.knobs() == p.knobs():
                return cand
        return replace(p, name=f"adopted-{p.describe()}")

    def knobs(self) -> tuple:
        """The identity that matters for lockstep: everything but the
        display name."""
        return (self.overlap_steps, self.wire, self.diloco,
                self.sync_every, self.ckpt_every)

    def describe(self) -> str:
        mode = ("diloco" if self.diloco
                else "overlap" if self.overlap_steps else "sync")
        return f"{mode}-{self.wire_name()}"


def from_knobs(overlap_steps: int = 0, wire_dtype: Optional[Any] = None,
               name: Optional[str] = None) -> FTPolicy:
    """Synthesize a policy from the legacy Manager constructor knobs, so
    every Manager — policy-aware or not — reports a coherent
    ``policy_name`` and serves one to healers."""
    wire = WIRE_F32
    if wire_dtype is not None:
        wire = (WIRE_BF16 if host_dtype(wire_dtype).itemsize == 2
                else WIRE_F32)
    p = FTPolicy(name="fixed", overlap_steps=overlap_steps, wire=wire)
    return replace(p, name=name or f"fixed-{p.describe()}")


# The default escalation ladder, performance-first at rung 0 and one
# robustness trade per rung (the escalation order): shorten the
# durable-checkpoint cadence -> disable cross-step overlap (stale
# in-flight grads are pure loss when aborts are frequent) -> descend the
# wire ladder f32 -> bf16 -> int8+EF (fewer bytes = fewer transport ops
# per collective for faults to land on) -> drop to DiLoCo (cross-group
# traffic only every sync_every steps). Relaxation walks back one rung
# per quiet hysteresis window.
LADDER: Tuple[FTPolicy, ...] = (
    FTPolicy("overlap-bf16", overlap_steps=1, wire=WIRE_BF16,
             ckpt_every=64),
    FTPolicy("overlap-bf16-ckpt8", overlap_steps=1, wire=WIRE_BF16,
             ckpt_every=8),
    FTPolicy("sync-f32", wire=WIRE_F32, ckpt_every=8),
    FTPolicy("sync-bf16", wire=WIRE_BF16, ckpt_every=8),
    FTPolicy("sync-int8", wire=WIRE_INT8, ckpt_every=8),
    FTPolicy("diloco-8", diloco=True, sync_every=8, ckpt_every=8),
)

# Named fixed policies (the A/B baselines the adaptive soak must beat,
# plus the ladder rungs by name).
POLICIES: Dict[str, FTPolicy] = {p.name: p for p in LADDER}
POLICIES["overlap-f32"] = FTPolicy("overlap-f32", overlap_steps=1)
POLICIES["diloco-16"] = FTPolicy("diloco-16", diloco=True, sync_every=16,
                                 ckpt_every=8)
