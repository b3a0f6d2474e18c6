"""Ring attention: sequence parallelism over a ``torch.distributed`` group,
the port of ``torchft_tpu/parallel/ring_attention.py``.

The sequence is cut into one contiguous piece per rank of the sp group
(:func:`~torchft_tpu_torch.parallel.sharding.shard_sequence`). Each rank
keeps its query block and passes the K/V blocks around the ring, one hop
per step, merging the per-block outputs online-softmax style through their
logsumexps: attention over S costs O(S/n) activations per rank and never
builds an [S, S] matrix. Each block runs the flash kernels' shift mode
(:func:`~torchft_tpu_torch.ops.flash_attention.flash_attention_block`).

    ring = make_ring_attention(group)
    cfg = llama2_7b_config(attention_fn=ring)

Where JAX differentiates ``shard_map`` by transposing ``ppermute``, the
K/V hop here is an autograd function whose backward sends the gradients
the other way.

Transport follows the group's backend, which the caller chose. Only gloo
is supported: it carries CPU tensors directly and CUDA tensors staged
through pinned host buffers (gloo's send/recv take no CUDA tensors). gloo
is what two sp ranks on one card need (NCCL refuses two ranks on one
device); an NCCL route for ranks on separate cards is not here.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torchft_tpu_torch.models.transformer import plain_attention
from torchft_tpu_torch.ops.flash_attention import (NEG_INF,
                                                   flash_attention_block)


def _hop(group: dist.ProcessGroup, tensors: Sequence[torch.Tensor],
         step: int) -> Tuple[torch.Tensor, ...]:
    """Send each tensor to group rank ``rank + step`` and receive its
    counterpart from ``rank - step`` (mod n)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    device = tensors[0].device
    staged = device.type == "cuda"
    if staged:
        send = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t) for t in tensors]
    else:
        send = [t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in send]
           + [dist.P2POp(dist.irecv, t, src, group) for t in recv])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        return tuple(t.to(device) for t in recv)
    return tuple(recv)


class _Rotate(torch.autograd.Function):
    """K/V to the next rank; gradients back to the previous one."""

    @staticmethod
    def forward(ctx, group: dist.ProcessGroup, k: torch.Tensor,
                v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ctx.group = group
        return _hop(group, (k, v), 1)

    @staticmethod
    def backward(ctx, gk: torch.Tensor, gv: torch.Tensor):
        return (None, *_hop(ctx.group, (gk, gv), -1))


def _ring_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               group: dist.ProcessGroup, causal: bool) -> torch.Tensor:
    """This rank's attention output; q/k/v ``[B, S_local, H(_kv), D]``.

    Step t holds the K/V block of rank (my - t) mod n: with ``causal`` a
    block from an earlier rank is fully visible (shift S_local), the
    resident block is causal (shift 0) and a later rank's block is blocked
    (shift -S_local; it returns lse ~ -1e30 and merges with weight 0).
    Under per-layer recomputation the backward replays these hops; both
    ranks replay the same sequence of sends and receives in the same
    order, so the replay cannot deadlock or pair the wrong messages."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, s_loc, h, d = q.shape

    def per_row(x: torch.Tensor) -> torch.Tensor:  # [b*h, s] -> [b, s, h, 1]
        return x.reshape(b, h, s_loc).transpose(1, 2)[..., None]

    m_run = torch.full((b * h, s_loc), NEG_INF, dtype=torch.float32,
                       device=q.device)
    r = torch.zeros_like(m_run)
    acc = torch.zeros(b, s_loc, h, d, dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    for t in range(n):
        src = (my - t) % n
        if not causal or src < my:
            shift = s_loc
        else:
            shift = 0 if src == my else -s_loc
        out_t, lse_t = flash_attention_block(q, k_t, v_t, shift)
        # t = 0 is the resident block, so m_run is finite before a blocked
        # block's ~-1e30 lse arrives and that block's weight is exactly 0.
        m_new = torch.maximum(m_run, lse_t)
        c = torch.exp(m_run - m_new)
        w = torch.exp(lse_t - m_new)
        r = r * c + w
        acc = acc * per_row(c) + per_row(w) * out_t.float()
        m_run = m_new
        # No hop after the last block (JAX keeps one only to stay out of a
        # collective inside lax.cond).
        if t < n - 1:
            k_t, v_t = _Rotate.apply(group, k_t, v_t)
    return (acc / per_row(r.clamp_min(1e-30))).to(q.dtype)


def make_ring_attention(group: Optional[dist.ProcessGroup] = None
                        ) -> Callable:
    """A ring-attention ``attention_fn(q, k, v, causal) -> out`` over the
    sp ``group`` (default: the world), for the transformer's
    ``attention_fn``: q/k/v are this rank's ``[B, S_local, H(_kv), D]``
    piece of a sequence cut as :func:`shard_sequence` cuts it. With one
    rank it is plain attention, as in JAX."""
    if group is None:
        group = dist.group.WORLD
    if dist.get_world_size(group) == 1:
        return plain_attention
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise NotImplementedError(
            f"ring attention: the sp group's backend is {backend!r}; only "
            "gloo is supported")

    def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
        return _ring_body(q, k, v, group, causal)

    # The blocks share kv heads by index, so the ring rotates the small
    # GQA K/V, never repeated heads.
    attention.supports_gqa = True
    return attention
