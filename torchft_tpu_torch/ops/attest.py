"""State attestation words: the committed state's fingerprint on the card.

The port of the JAX Manager's XLA-jitted ``_attest_device_words``
(``torchft_tpu/manager.py:5223-5307``): every array leaf of the committed
state, in pytree order, reduces to three u32 words over its raw bytes
(byte sum, position-weighted byte sum, byte count), folded into four u32
words; only those 16 bytes cross to the host. The words are bitwise
:func:`torchft_tpu_torch.serialization.attest_fingerprint`'s, which is
the JAX package's.

:func:`attest_words` launches ``csrc/attest.cu`` (one pass over the
leaves' bytes, then the fold; its count in :data:`LAUNCHES` goes up by
one a call) for the leaves that lie on a CUDA device; a leaf on the CPU
(the optimizer's step scalars) enters with its words computed on the
host. When no leaf lies on a CUDA device the plain PyTorch version
(:func:`words_plain`) computes every word. There is no fallback: a leaf
on another device, or a kernel library that does not build, raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch import serialization

# Launches since the last reset_launches(), bumped only where the wrapper
# launches the kernel.
LAUNCHES: Dict[str, int] = {"attest_words": 0}

_M32 = 0xFFFFFFFF
# Units (the widest lane a dtype bitcasts to, <= 4 bytes) of one chunk of
# the plain version: bounds its int64 temporaries on large leaves.
_PLAIN_CHUNK = 1 << 24

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def argtypes() -> Dict[str, list]:
    """The ctypes argument types of the library's C entry point."""
    vp = ctypes.c_void_p
    return {"tft_attest_words": [vp, ctypes.c_int, vp, vp, vp]}


def _lib() -> ctypes.CDLL:
    """The kernel's shared library, built with nvcc at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from torchft_tpu_torch._build_util import load_cuda

            lib = load_cuda("attest.cu")
            for name, types in argtypes().items():
                fn = getattr(lib, name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            lib.tft_attest_error_string.argtypes = [ctypes.c_int]
            lib.tft_attest_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


# --------------------------------------------------------------- plain


def _units(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A leaf's bytes as unsigned units of ``s`` bytes (1, 2 or 4), held
    in int64: 8-byte dtypes read as little-endian u32 pairs, ``bool`` as
    uint8 — the JAX function's bitcasts."""
    x = x.detach().contiguous().reshape(-1)
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    s = x.element_size()
    if s == 1:
        return x.view(torch.uint8).to(torch.int64), 1
    if s == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF, 2
    return x.view(torch.int32).to(torch.int64) & _M32, 4


def leaf_words_plain(x: torch.Tensor) -> Tuple[int, int, int]:
    """``(w0, w1, nbytes mod 2^32)`` of one tensor leaf, in torch on its
    device: the JAX function's per-unit spelling, its u32 arithmetic in
    int64 masked to 32 bits. Unit j of s bytes adds ``s j bytesum_j +
    intra_j`` to w1; each ``j bytesum_j`` is masked before the sum, since
    the products of a 131M-unit leaf would overflow int64 summed."""
    u, s = _units(x)
    m = u.numel()
    w0 = w1 = intra = 0
    for start in range(0, m, _PLAIN_CHUNK):
        c = u[start:start + _PLAIN_CHUNK]
        bs = torch.zeros_like(c)
        ins = torch.zeros_like(c)
        for k in range(s):
            b = (c >> (8 * k)) & 0xFF
            bs += b
            ins += (k + 1) * b
        j = torch.arange(start, start + c.numel(), dtype=torch.int64,
                         device=c.device)
        w0 += int(bs.sum())
        w1 += int(((j * bs) & _M32).sum())
        intra += int(ins.sum())
    return w0 & _M32, (s * w1 + intra) & _M32, (m * s) & _M32


def _host_words(leaf: Any) -> Tuple[int, int, int]:
    if isinstance(leaf, torch.Tensor):
        return leaf_words_plain(leaf)
    return serialization.attest_leaf_words(leaf)


def _fold(words: Sequence[Tuple[int, int, int]]) -> List[int]:
    acc = [serialization.ATTEST_FNV_BASIS] * 4
    for w in words:
        acc = serialization.attest_fold(acc, *w)
    return acc


def words_plain(leaves: Sequence[Any]) -> List[int]:
    """The four u32 words of ``leaves`` (tensors on any device, or numpy
    arrays), in PyTorch and Python integers: the kernel's plain
    version."""
    return _fold([_host_words(leaf) for leaf in leaves])


# -------------------------------------------------------------- kernel


def _card(leaves: Sequence[Any]) -> Optional[torch.device]:
    """The one CUDA device the tensor leaves lie on, None when none does;
    raises for several CUDA devices or another device type."""
    devices = {leaf.device for leaf in leaves
               if isinstance(leaf, torch.Tensor)
               and leaf.device.type != "cpu"}
    if not devices:
        return None
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"attest_words: leaves on "
                         f"{sorted(map(str, devices))}; the kernel takes "
                         "one CUDA device (and the CPU)")
    return next(iter(devices))


def attest_words(leaves: Sequence[Any]) -> List[int]:
    """The four u32 attestation words of ``leaves`` (pytree order), as
    Python ints: the kernel for the leaves on a CUDA device, the host for
    CPU tensors and numpy arrays; with no CUDA leaf, the plain version.
    Render with :func:`serialization.attest_combine`."""
    dev = _card(leaves)
    if dev is None:
        return words_plain(leaves)
    n = len(leaves)
    table = np.zeros((n, 2), np.int64)
    seeds = np.zeros((n, 2), np.uint32)
    keep = []  # the contiguous copies the kernel reads, alive to the end
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.device == dev:
            t = leaf.detach().contiguous()
            keep.append(t)
            table[i] = (t.data_ptr(), t.numel() * t.element_size())
        else:
            w0, w1, n32 = _host_words(leaf)
            table[i, 1] = n32
            seeds[i] = (w0, w1)
    ws = torch.from_numpy(np.concatenate(
        [seeds.reshape(-1), np.zeros(4, np.uint32)]).view(np.int32)
    ).to(dev)
    table_d = torch.from_numpy(table).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().tft_attest_words(table_d.data_ptr(), n, ws.data_ptr(),
                                 ws[2 * n:].data_ptr(), stream)
    if rc != 0:
        msg = _lib().tft_attest_error_string(rc).decode()
        raise RuntimeError(f"attest_words kernel: CUDA error {rc} ({msg})")
    LAUNCHES["attest_words"] += 1
    out = ws[2 * n:].cpu().numpy().view(np.uint32)
    del keep
    return [int(w) for w in out]
