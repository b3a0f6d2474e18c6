"""Small shared utilities: host naming, the 1/n scale, and the pytree
helpers the port uses in place of ``jax.tree_util``.

A pytree here is what the port's state and gradients are made of: nested
``dict`` / ``list`` / ``tuple`` containers whose leaves are tensors, numpy
arrays or Python scalars. ``None`` is an empty subtree. Flattening visits
dict keys in SORTED order, exactly as ``jax.tree_util`` does, so a state
dict flattens to the same leaf order — and so serializes to the same bytes
and manifests — as the JAX package's pytree of the same structure.
"""

from __future__ import annotations

import socket
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from torchft_tpu_torch.communicator import BF16, bf16_to_f32, f32_to_bf16


def div_by_count(a: Any, n: int) -> Any:
    """Divide a reduced leaf by the participant count, dtype-aware:
    true-divide and cast back for floating dtypes (bfloat16 included:
    a host bf16 array divides in float32 and rounds once, as ml_dtypes
    does), floor-divide for integers. Works on tensors and numpy
    arrays."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return (a / n).to(a.dtype)
        return a // n
    if a.dtype == BF16:
        return f32_to_bf16(bf16_to_f32(a) / np.float32(n))
    if np.issubdtype(a.dtype, np.inexact):
        return (a / n).astype(a.dtype)
    return a // n


def advertise_host() -> str:
    """Hostname peers should dial; falls back to loopback when the hostname
    doesn't resolve (single-host test topologies)."""
    host = socket.gethostname()
    try:
        socket.getaddrinfo(host, None)
        return host
    except OSError:
        return "127.0.0.1"


# ---------------------------------------------------------------- pytrees

# A treedef is a nested tuple: ("leaf",), ("none",),
# ("dict", keys, children), ("list", children), ("tuple", children).
TreeDef = tuple


def _sorted_keys(d: dict) -> list:
    try:
        return sorted(d)
    except TypeError:  # unsortable (mixed-type) keys: insertion order
        return list(d)


def _flatten(tree: Any, path: tuple, out: list) -> TreeDef:
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = _sorted_keys(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], path + (k,), out) for k in keys))
    if isinstance(tree, list):
        return ("list", tuple(_flatten(x, path + (i,), out)
                              for i, x in enumerate(tree)))
    if isinstance(tree, tuple):
        return ("tuple", tuple(_flatten(x, path + (i,), out)
                               for i, x in enumerate(tree)))
    out.append((path, tree))
    return ("leaf",)


def tree_flatten_with_path(tree: Any) -> Tuple[List[Tuple[tuple, Any]],
                                               TreeDef]:
    """``([(path, leaf), ...], treedef)``; a path is the tuple of dict
    keys / sequence indices from the root."""
    out: list = []
    treedef = _flatten(tree, (), out)
    return out, treedef


def tree_flatten(tree: Any) -> Tuple[list, TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def _unflatten(treedef: TreeDef, leaves: Iterator[Any]) -> Any:
    kind = treedef[0]
    if kind == "leaf":
        return next(leaves)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, leaves)
                for k, c in zip(treedef[1], treedef[2])}
    children = [_unflatten(c, leaves) for c in treedef[1]]
    return children if kind == "list" else tuple(children)


def tree_unflatten(treedef: TreeDef, leaves: list) -> Any:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the treedef holds")
    return out


_END = object()


def key_str(path: tuple) -> str:
    """The ``/``-joined key path spelling of ``jax.tree_util`` paths."""
    return "/".join(str(p) for p in path)
