"""Build-on-first-use for the port's native code.

Two kinds of native code live in the package and are compiled from the
sources in the checkout, into ``torchft_tpu_torch/_build/`` (never in the
source tree), at first use:

* the CUDA kernels under ``csrc/`` — one ``nvcc`` call per source into a
  shared library with a plain C interface, loaded with :mod:`ctypes`;
* the C++ control-plane core under ``_core/`` (see :mod:`._native`).

Every build runs under an exclusive ``fcntl`` lock on a file beside its
output, so concurrent processes (pytest-xdist workers, replica groups
started together) build once and the others wait and load the result.
Outputs are named by a hash of their inputs, so an edited source can never
be served by a stale library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Iterable, Iterator

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")


@contextlib.contextmanager
def build_lock(directory: str) -> Iterator[None]:
    """Exclusive inter-process lock on ``directory/lock``."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def digest(paths: Iterable[str], extra: str = "") -> str:
    """Short content hash of ``paths`` (in the given order) plus ``extra``."""
    h = hashlib.sha256(extra.encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_cuda(source: str) -> str:
    """Compile ``csrc/<source>`` (and the ``.cuh`` headers beside it) into
    a shared library; returns its path. Builds at most once per content.
    The compiler's output (``-Xptxas -v``: registers and spills of every
    kernel) is kept beside the library as ``<library>.log``."""
    src = os.path.join(CSRC_DIR, source)
    headers = sorted(os.path.join(CSRC_DIR, n) for n in os.listdir(CSRC_DIR)
                     if n.endswith(".cuh"))
    stem = os.path.splitext(source)[0]
    out_dir = os.path.join(BUILD_DIR, "kernels")
    out = os.path.join(
        out_dir, f"lib{stem}-{digest([src] + headers, ' '.join(NVCC_FLAGS))}"
        ".so")
    if os.path.exists(out):
        return out
    with build_lock(out_dir):
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
        with open(f"{out}.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def load_cuda(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build_cuda(source))
