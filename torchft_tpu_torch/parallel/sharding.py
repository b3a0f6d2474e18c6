"""Sequence sharding for sequence parallelism: the port of
``batch_spec(mesh, seq_axis="sp")`` (``torchft_tpu/parallel/sharding.py``)
for a batch that is cut by hand, one piece per rank of an sp group.

In the JAX package the batch stays one global array whose sequence axis is
sharded, so rotary positions and next-token targets are global by
construction. Here each rank holds only its tokens, so the shard carries
its global positions and its targets, including the one that lives on the
next rank (the first token of the next shard)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SequenceShard(NamedTuple):
    """This rank's piece of a global ``[B, S]`` batch."""

    tokens: torch.Tensor     # [B, S / n]
    positions: torch.Tensor  # [B, S / n], global rotary positions
    # [B, S / n] next tokens; one fewer on the last rank, whose last token
    # has no successor.
    targets: torch.Tensor


def shard_sequence(tokens: torch.Tensor, rank: int, world: int
                   ) -> SequenceShard:
    """Rank ``rank`` of ``world``'s contiguous piece of ``tokens``
    ``[B, S]``, tokens ``[rank * S/n, (rank + 1) * S/n)``; ``S`` must be
    a multiple of ``world``."""
    b, s = tokens.shape
    if s % world:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"sp group size {world}")
    s_loc = s // world
    lo, hi = rank * s_loc, (rank + 1) * s_loc
    positions = torch.arange(lo, hi, device=tokens.device).expand(b, s_loc)
    return SequenceShard(tokens[:, lo:hi], positions,
                         tokens[:, lo + 1:hi + 1])
