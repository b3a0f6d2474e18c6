"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases kernels,sp # a subset of card,kernels,
                                              # ft,split,sp,wire,overlap,
                                              # shard,attest,durable,
                                              # capacity,diloco

Phases:

1. **card** — the card's name and power limit (nvidia-smi), then the
   builds: the flash-attention kernels and the attestation kernel (one
   nvcc each, from ``torchft_tpu_torch/csrc``) and the C++ control-plane
   core (from ``torchft_tpu_torch/_core``), all started together; the
   attestation kernel must not spill either; the build's
   ``-Xptxas -v`` registers and spills of every kernel are logged, and the
   run fails if any kernel spills or if its SASS (``cuobjdump -sass``)
   lacks HGMMA or UTMALDG.
2. **kernels** — each of the four flash-attention kernels against its
   plain PyTorch version on the same inputs, at the slice's shape and at
   GQA / non-causal / end-aligned / odd-length shapes and at the capacity
   phase's batch 8 x 2048 (static only), in the static mode and in the
   ring's shift mode (shift Sk = full, 0 = causal, -Sk =
   blocked, and a partial shift at which every row sees a key, with a
   nonzero lse cotangent); times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only, never called by the
   port) at the slice's shape, the shift mode at the ring's per-step shape
   (shift = Sk, its yardstick SDPA non-causal, which returns no lse), and
   the split pair (dq + dk/dv) beside SDPA's whole backward; the split
   kernels' times at the lengths where the main path launches them (the
   split phase's shape, static, and the sp short step's, shift = Sk), by
   events and by a CUDA graph's replay; then the fused-vs-split backward
   check of ``torchft_tpu_torch.ops.fused_bwd_check``; the fused backward
   20 times on the same inputs (static, shift 0 and shift Sk at the
   slice's shape) beside forward launches on a second stream, dq, dk and
   dv bitwise equal every time; and the attestation kernel
   (``ops.attest``) bitwise against its plain version and numpy's
   ``attest_fingerprint`` on leaves of f32, bf16, int64, bool and uint8
   at odd sizes, a misaligned view, a host scalar and a 131M-element f32
   leaf, then its time on a 2-layer 7B-width state (8.003 GB) beside its
   bound.
3. **ft** — the main path: a native lighthouse and two replica groups
   (``python -m torchft_tpu_torch.train_lm``) on this one card at Llama-2-7B
   widths cut to 1 layer, batch 1 x 2048 tokens. Two steps, SIGKILL of
   group 1, restart with another init seed, heal from group 0 over HTTP,
   two more steps; then equal state hashes, committed post-heal steps,
   finite losses, kernel launches in both groups and no parameter on the
   CPU.
4. **split** — the split-backward path: one training step of the same
   model at a short sequence (fewer than 4 q tiles), which takes the dq and
   dk/dv kernels instead of the fused one.
5. **sp** — the sequence-parallel path: two processes on this card form a
   gloo sp group (``chip_smoke.py --sp-worker``); each builds the same
   Llama-2-7B-width 1-layer model with ring attention and takes two
   ``SPTrainer`` steps on one 4096-token sequence (2048 per rank), then
   one step at 256 tokens (128 per rank, fewer than 4 q tiles: the split
   backward's shift mode). Checks: equal parameter hashes on both ranks
   after every step, the shift-mode kernels launched, step 1's loss and
   gradient norm against one process running the same model on the whole
   sequence with the static kernels, and the ring-attention layer's output
   and gradients against static ``flash_attention`` on the same
   4096-token inputs.
6. **wire** — the manager's wire rungs: a lighthouse and two replica
   groups on this card (``chip_smoke.py --wire-worker``); each builds the
   same Llama-2-7B-width 1-layer model with the flash kernels, computes
   its gradients of two steps on 1 x 2048 tokens from its own data seed
   and keeps them on the card, then reduces them with three ``Manager``
   allreduce + ``should_commit`` steps under each rung, a fresh Manager
   and ``HostCommunicator`` per rung: f32, bf16, int8 + error feedback
   quantized on the card, and int8 quantized on the host. Logs per rung
   and step the allreduce ms, the ring's time split into host fold and
   socket waits, ring and device->host bytes and the pack times (and
   each pack's device time over the whole tree against its bound);
   checks that the f32 rung's first step equals the plain mean of both
   groups' gradients exactly, that both groups reduce to bitwise-equal
   trees, that the card's int8 and the host's int8 agree bitwise at
   every step, each rung's error against f32 and its bytes against
   f32's, and that the gradients, results and the int8 residual stay on
   the card.
7. **overlap** — the ft phase's drill (same lighthouse, model, SIGKILL of
   group 1 after step 2, restart and heal) with ``OVERLAP_STEPS=1``: each
   step's exchange drains under the next step's forward and backward, so
   the kill lands while group 1's step-2 exchange is in flight. Checks:
   equal state hashes, the restarted group's steps all committed, group
   0's dropped deferred steps (``overlap_grads_dropped``) at least 1 and
   equal to its aborted steps, finite losses, kernel launches; logs each
   group's hidden and drain-wait ms per step.
8. **shard** — the sharded update: a lighthouse and two groups on this
   card (``chip_smoke.py --shard-worker``), each with the wire cell's
   model from one init seed. Each takes two ``FTTrainer`` steps with
   the sync update on fixed batches, then the same two from the same
   init params with a fresh ``Manager(shard_update=True)`` (AdamW with
   ``foreach`` pinned on both). The sharded run exchanges the gradients
   the sync run recorded at each step, after its own forward and
   backward, so the params check tests the update alone. Checks after
   every step: the sharded run's own gradients bitwise equal to the
   sync run's (the fused backward sums dq in a fixed order; 0 elements
   may differ), the sharded params bitwise equal to the sync path's on
   both groups, equal parameter hashes across the groups, the stripe
   state 1/2 of the sync AdamW state, and the device memory held
   between steps lower by the state saved; logs the put, stripe-update,
   allgather and assembly ms beside the sync run's put ms.
9. **attest** — the recovery plane the Manager runs by default (fleet
   telemetry, state attestation, striped heal): a lighthouse with three
   members per quorum and three ``train_lm`` groups at the ft cell's
   widths. Group 1 runs a chaos sdc band (``TORCHFT_CHAOS``) that flips
   one bit of its committed state; group 2 holds, is SIGKILLed and
   restarts with another init seed. Checks: the lighthouse's one verdict
   and one clear; on group 1 one flip, quarantine, re-heal (striped, 2
   donors) and clear, the verdict within one boundary of the flip;
   groups 0 and 2 never latch; the restarted group heals from 2 donors
   and commits every step; equal state hashes and last digests on all
   three; group 0's digest on the card equal to numpy's on a host copy
   of its state; a digest at every vote boundary but each process's
   first. Logs each group's digest ms per boundary and the striped
   heal's wall and MB/s.

10. **durable** — the durability plane: the ft cell's model in two
   ``train_lm`` groups with ``CHECKPOINT_DIR`` and ``CHECKPOINT_EVERY=2``
   (``AsyncCheckpointer(keep=3)``, a snapshot on the card, the write on
   the writer's thread); the phase first checks the disk has the 48 GB
   its files take. Run A (a lighthouse with ``min_replicas=1``, 4
   steps): group 1 gets SIGTERM once its report shows step 2 and must
   drain — farewell, final save, exit 0 — with a graceful exit counted
   and no deadline expired, its newest file verified, committed and
   stamped with the step it drained at; group 0 must commit every step
   across the departure (0 aborted) and finish step 4 alone. Run B: one
   byte in the middle of group 1's newest file's payload is flipped, and
   two fresh groups start on the same directories under a lighthouse
   with two members per quorum, to step 5: group 0 resumes at step 4 with
   the state hash it ended run A with (5.57 GB through the disk,
   bitwise); group 1 quarantines the flipped file, falls back to an
   older one and heals from group 0 at the first quorum; both commit
   every step and end with equal hashes, finite losses and the flash
   kernels launched; each group launched ``attest_words`` over the
   phase. Logs each save's dispatch ms and snapshot ms on the card, the
   writer's wall and MB/s, the step walls with and without a save, each
   cold start's recover + load wall and MB/s, SIGTERM to exit, and the
   peak card memory.

11. **capacity** — the participation plane: three ``chip_smoke.py
   --capacity-worker`` groups at the ft cell's widths, each an
   ``FTTrainer`` whose batch is an ``ElasticLoader`` (the draw follows
   the quorum); the groups start from one init seed at step 1, so no
   initial sync heals them. Run A (warm spares):
   ``WorldSizeMode.FIXED_WITH_SPARES`` with ``min_replica_size=2`` under
   a lighthouse with two members per quorum, batch 1 x 2048, steps 2-6;
   after step 2 the group at participant rank 0 holds, is SIGKILLed and
   restarts fresh with another seed; the survivors wait after step 4
   until it is up. Checks: two participants at every committed step;
   exactly one of three groups out of the fold at every step; the spare
   promoted at step 3 without a heal, and the step committed; the
   restarted group healed; the state digests equal at every step and
   at the end (the attestation digest, on the card). Run B: ``degraded_mode`` and
   ``rebalance``, three members per quorum, batch 8 x 2048, steps 2-6;
   group 1 degrades to 0.5 at the step-2 boundary and restores at the
   step-5 one; group 2 runs the chaos slow band (factor 2) at the step-3
   boundary.
   Checks: every draw is ``round(8 x capacity x rebalance)`` of the
   fractions in force and the fold weight is the draw (0 while healing);
   group 1 at 0.5 for steps 3-5, its degrade and restore counted once
   and its capacity advertised on the quorum store; each group's adopted
   rebalance fraction is its entry of the table published on the quorum
   store at that boundary; the step-3 reduced tree bitwise across the
   groups and within 1e-6 of the float64 weighted mean of the three
   saved contributions; equal digests and final hashes; logs every
   boundary's lighthouse table and digest walls, and whether the ladder
   shrank the slow group.

12. **diloco** — DiLoCo local SGD (``torchft_tpu_torch.local_sgd``): two
   ``chip_smoke.py --diloco-worker`` groups at the ft cell's widths, the
   ft cell's AdamW inside, Nesterov SGD (lr 0.7, momentum 0.9) outside,
   an outer round every 4 inner steps, both from one init seed at step
   1. Run P (``DiLoCoTrainer``, 3 rounds): group 1 holds once round 1
   commits, is SIGKILLed and restarts fresh, healing the whole state
   (params, anchor, AdamW moments, outer momentum: 9.29 GB) at its first
   round. Checks: ring bytes and the allreduce count move only at outer
   rounds, by one f32 pseudo-gradient; round 1's average equal to the
   plain mean of both groups' saved pseudo-gradients (0 elements may
   differ) and its anchor within 1e-6 of a plain Nesterov step; after
   every round equal anchor and outer-momentum sha256 across the groups
   and params equal to the anchor; the restarted group heals and commits
   rounds 2-3; no sdc verdict (every group's digest differs under
   DiLoCo, as in the JAX package). Run S (``StreamingDiLoCoTrainer``, 2
   fragments, 4 fragment rounds, then a flush), in the same two processes
   (group 0 and the restarted group 1) from init seed 0 at step 1:
   fragment ids 0, 1, 0, 1
   on both groups, each round moving only its fragment's anchor, equal
   anchors across the groups after every collect, and the merge rule
   ``anchor' + (p - at_send)`` on group 0. Logs the inner step wall, the
   outer round split (manager step, pseudo-gradient, ring, vote, update),
   the heal wall and bytes, ring bytes per round, peak card memory per
   group, and the device ms of the pseudo-gradient, the outer step and
   the copy over the whole tree beside their bounds.

Depth: every phase runs Llama-2-7B widths (vocabulary 32000, embedding
4096, 32 heads of 128, MLP 11008) cut to 1 layer (and the ft and overlap
drills and the durable phase's run A to 4 steps, the capacity phase's
runs to 5, the sp and shard phases to 2), so that the whole script
stays inside its time limit. Every worker runs in a session of its own
and dies with the script (``_popen``); a signal, or the script's own
deadline (``DEADLINE_S``), fails the run and stops the workers still
running.

Each phase's wall is logged. Launch counts are reset just before each
driven path and read just after it. The line before the last is a JSON
object with one entry per kernel: ``launches`` counts the ft phase (and
the split and sp phases for their kernels), ``launches_overlap``,
``launches_shard``, ``launches_attest``, ``launches_durable``,
``launches_capacity`` and ``launches_diloco`` those paths' own launches;
the last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line. float32 matmuls are pinned to full precision
(TF32 off) so the plain versions are exact references.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# The groups' logs of the ft phase are copied here.
OUT_DIR = (os.environ.get("SMOKE_LOG_DIR")
           or os.path.join(ROOT, "smoke_out"))

# H100 SXM published dense peaks (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of the kernel phase (bf16 inputs, f32 statistics): the kernels
# round p and ds to bf16 before their matmuls, the plain versions do not.
FWD_REL = 1e-2
LSE_ABS = 1e-3
BWD_REL = 2e-2

# Sp phase: agreement of step 1 with the one-process static-kernel run.
# The H100 reads 8.2e-6 (loss) and 2.5e-5 (gradient norm); the limits sit
# about 12x and 40x above, room for bf16 rounding order and no more.
SP_LOSS_REL = 1e-4
SP_GRAD_NORM_REL = 1e-3

# Launch-count key -> (entry name, CUDA kernel, TPU kernel); the shift mode
# is the TPU kernels' dynamic_shift mode (flash_attention_block, :777-811).
_TPU = "torchft_tpu/ops/flash_attention.py"
KERNELS = {
    "fwd": ("flash_fwd", "flash_fwd_wgmma", f"{_TPU}:136"),
    "bwd_dq": ("flash_bwd_dq", "flash_bwd_dq_wgmma", f"{_TPU}:344"),
    "bwd_dkdv": ("flash_bwd_dkdv", "flash_bwd_dkdv_wgmma", f"{_TPU}:380"),
    "bwd_fused": ("flash_bwd_fused", "flash_bwd_fused_wgmma", f"{_TPU}:420"),
    "fwd_shift": ("flash_fwd (shift)", "flash_fwd_wgmma", f"{_TPU}:136"),
    "bwd_dq_shift": ("flash_bwd_dq (shift)", "flash_bwd_dq_wgmma",
                     f"{_TPU}:344"),
    "bwd_dkdv_shift": ("flash_bwd_dkdv (shift)", "flash_bwd_dkdv_wgmma",
                       f"{_TPU}:380"),
    "bwd_fused_shift": ("flash_bwd_fused (shift)", "flash_bwd_fused_wgmma",
                        f"{_TPU}:420"),
    # Not a Pallas kernel: the XLA-jitted state digest of the JAX Manager.
    "attest_words": ("attest_words", "attest_leaf_sums",
                     "torchft_tpu/manager.py:5223"),
}
CSRC = os.path.join("torchft_tpu_torch", "csrc")
# Every CUDA kernel, all written on wgmma + TMA: their SASS must hold both,
# and their build no spill.
HOPPER_KERNELS = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                  "flash_bwd_dkdv_wgmma", "flash_bwd_fused_wgmma")
# The CUDA kernels not on wgmma (a byte reduction): their build must not
# spill.
PLAIN_KERNELS = ("attest_leaf_sums",)
# (name, B, S, Sk, H, Hkv, D, causal); the first is the slice's shape,
# "sp_split" the sp phase's short step (S_local = 128 per rank), "d32" the
# smallest head dim, "tile_edge" one full and one half 128-row tile.
CASES = [
    ("slice", 1, 2048, 2048, 32, 32, 128, True),
    ("sp_split", 1, 128, 128, 32, 32, 128, True),
    ("gqa", 2, 256, 256, 8, 2, 64, True),
    ("noncausal", 2, 512, 512, 8, 8, 128, False),
    ("end_aligned", 1, 384, 1024, 8, 4, 128, True),
    ("odd", 1, 999, 999, 8, 8, 64, True),
    ("d32", 2, 320, 320, 4, 2, 32, True),
    ("tile_edge", 1, 192, 192, 8, 8, 128, True),
    ("split", 1, 192, 192, 32, 32, 128, True),
    # The capacity phase's run B: batch 8 (4 while degraded) at the
    # slice's length, static mode only.
    ("capacity", 8, 2048, 2048, 32, 32, 128, True),
]
# Cases checked in the static mode alone.
STATIC_ONLY = ("capacity",)
# Split-kernel times at the lengths where the main path launches them:
# case -> shift mode; "split" is the split phase's shape (static),
# "sp_split" the sp short step's (shift = Sk).
SHORT_TIMES = {"split": False, "sp_split": True}
# Shift-mode cases beyond (Sk, 0, -Sk) on each case above: a partial shift
# at which every row still sees a key, -(BQ // 2) at Sk = S + BQ.
PARTIAL_SHIFT = ("partial", 1, 256, 320, 8, 2, 128, -32)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# Every worker starts through this stub: it asks the kernel to SIGKILL it
# when this script dies (PR_SET_PDEATHSIG), however the script dies, then
# becomes the worker's command. A worker runs in a session of its own (so
# that a kill reaches its whole process group), where a signal sent to
# this script's group would not reach it.
_DIE_WITH_PARENT = (
    "import ctypes, os, signal, sys; "
    "ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL); "
    "os.getppid() == int(sys.argv[1]) or os._exit(1); "
    "os.execv(sys.argv[2], sys.argv[2:])")


def _popen(argv: list, log_path: str, env: dict = None) -> subprocess.Popen:
    """Starts ``argv`` (``sys.executable`` first) in a session of its own,
    its output in ``log_path``; the worker dies with this script."""
    with open(log_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-c", _DIE_WITH_PARENT, str(os.getpid()),
             *argv], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT, start_new_session=True)


def _stop(procs: list) -> None:
    """SIGKILLs the process group of every worker still running."""
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2, graph: bool = False
            ) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events.
    With ``graph``, the calls are captured in one CUDA graph and the
    replay is timed: the host's launch cost, which a call of a few
    microseconds of device work would otherwise measure, drops out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run, calls = fn, iters
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run, calls = g.replay, iters * iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------ phase 1


def phase_card() -> str:
    line = card_line()
    log(line)
    from torchft_tpu_torch import _native
    from torchft_tpu_torch.ops import flash_attention as fa

    from torchft_tpu_torch._build_util import build_cuda

    from torchft_tpu_torch.ops import attest

    # One nvcc per CUDA source and the core's g++, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        builds = [ex.submit(f) for f in (fa._lib, attest._lib, _native.lib)]
        for b in builds:
            b.result()
    log(f"builds: kernels + control-plane core in "
        f"{time.perf_counter() - t0:.1f} s")
    check_build(build_cuda("flash_attention.cu"))
    check_spills(build_cuda("attest.cu"), PLAIN_KERNELS)
    return line


def kernel_source(kernel: str) -> str:
    """Path, in the repo, of the CUDA source that defines ``kernel``."""
    for name in sorted(os.listdir(os.path.join(ROOT, CSRC))):
        path = os.path.join(CSRC, name)
        with open(os.path.join(ROOT, path)) as f:
            if re.search(rf"\n{kernel}\(", f.read()):
                return path
    raise SmokeError(f"no source under {CSRC} defines {kernel}")


def _cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy bundled with Triton."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = ["/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton

        candidates.append(os.path.join(os.path.dirname(triton.__file__),
                                       "backends", "nvidia", "bin",
                                       "cuobjdump"))
    except ImportError:
        pass
    for path in candidates:
        if os.path.exists(path):
            return path
    raise SmokeError("cuobjdump not found (neither the CUDA toolkit's nor "
                     "Triton's): the SASS check cannot run")


def ptxas_report(text: str) -> dict:
    """Kernel name -> registers and spill bytes, from ``-Xptxas -v``."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.setdefault(name, {})["registers"] = int(m.group(1))
    return kernels


def check_hopper_kernels(kernels: dict, sass: str) -> None:
    """Fails unless every instantiation of each kernel of
    :data:`HOPPER_KERNELS` built with no spill and its SASS
    (``cuobjdump -sass``) holds HGMMA and UTMALDG."""
    for kernel in HOPPER_KERNELS:
        built = {n: i for n, i in kernels.items() if kernel in n}
        check(len(built) > 0, f"ptxas reported no {kernel}")
        for n, info in built.items():
            check(info.get("spill_stores", 0) == 0 and
                  info.get("spill_loads", 0) == 0, f"{n} spills: {info}")
        # "Function : <name>" heads each function's SASS.
        bodies = [b for b in sass.split("Function : ")[1:]
                  if kernel in b.split()[0]]
        check(len(bodies) == len(built),
              f"SASS holds {len(bodies)} of the {len(built)} {kernel}s")
        for body in bodies:
            for op in ("HGMMA", "UTMALDG"):
                check(op in body, f"{body.split()[0]}: no {op} in its SASS")
        log(f"sass: {kernel}: {len(bodies)} instantiations, each with "
            "HGMMA and UTMALDG")


def check_spills(library: str, expect: tuple) -> dict:
    """Logs registers and spills of every kernel of a library whose
    kernels are not on wgmma; fails if one spills or if a kernel of
    ``expect`` is missing."""
    with open(f"{library}.log") as f:
        kernels = ptxas_report(f.read())
    for name, info in kernels.items():
        log(f"ptxas: {name} {info}")
        check(info.get("spill_stores", 0) == 0 and
              info.get("spill_loads", 0) == 0, f"{name} spills: {info}")
    for kernel in expect:
        check(any(kernel in n for n in kernels),
              f"ptxas reported no {kernel}")
    return kernels


def check_build(library: str) -> dict:
    """Logs registers and spills of every kernel from the build's report,
    then checks them (:func:`check_hopper_kernels`)."""
    with open(f"{library}.log") as f:
        kernels = ptxas_report(f.read())
    for name, info in kernels.items():
        log(f"ptxas: {name} {info}")
    sass = subprocess.run([_cuobjdump(), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    check_hopper_kernels(kernels, sass)
    return kernels


# ------------------------------------------------------------ phase 2


def _visible_pairs(s: int, sk: int, causal: bool, shift=None) -> int:
    """Visible (query, key) entries: query i sees keys
    k <= (sk - s) + i + shift (shift 0 when only causal)."""
    if shift is None and not causal:
        return s * sk
    off = sk - s + (shift or 0)
    return sum(max(0, min(sk, off + i + 1)) for i in range(s))


def bounds(name: str, b: int, s: int, sk: int, h: int, h_kv: int, d: int,
           causal: bool, shift=None) -> tuple:
    """(bound_ms, bound_by) of one kernel call at these shapes: the larger
    of its tensor-core time (matmul flops on the visible entries at the
    bf16 peak) and its memory time (each input read once, each output
    written once, at the HBM rate)."""
    pairs = b * h * _visible_pairs(s, sk, causal, shift)
    name = name.removesuffix("_shift")
    mats = {"fwd": 2, "bwd_dq": 3, "bwd_dkdv": 4, "bwd_fused": 5}[name]
    flops = 2.0 * mats * pairs * d
    q_bytes = 2 * b * s * h * d
    kv_bytes = 2 * 2 * b * sk * h_kv * d
    row_bytes = 4 * b * h * s
    if name == "fwd":
        nbytes = q_bytes + kv_bytes + q_bytes + row_bytes
    else:
        nbytes = 2 * q_bytes + kv_bytes + 2 * row_bytes  # q, do, k, v, stats
        if name in ("bwd_dq", "bwd_fused"):
            nbytes += 2 * q_bytes  # dq, f32
        if name in ("bwd_dkdv", "bwd_fused"):
            nbytes += 2 * 2 * b * sk * h * d  # dk, dv per query head
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _shift_check(rows: dict, case: str, q, k, v, do, shift: int,
                 gen: torch.Generator) -> tuple:
    """The four kernels in shift mode against their plain versions, with
    a nonzero lse cotangent folded into delta (as flash_attention_block's
    backward folds it). Returns the kernel arguments for timing."""
    from torchft_tpu_torch.ops import flash_attention as fa

    h, h_kv, sk = q.shape[2], k.shape[2], k.shape[1]
    qh, kh, vh = fa.to_bh(q), fa.to_bh(k), fa.to_bh(v)
    o, lse = fa.flash_fwd(qh, kh, vh, h, h_kv, False, shift)
    o_p, lse_p = fa.fwd_plain(qh, kh, vh, h, h_kv, False, shift)
    doh, delta = fa.bwd_inputs(do, o)
    g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
    args = (qh, kh, vh, doh, lse, delta - g_lse, h, h_kv, False, shift)
    dq = fa.flash_bwd_dq(*args)
    dk_s, dv_s = fa.flash_bwd_dkdv(*args)
    dk_f, dv_f, dq_f = fa.flash_bwd_fused(*args)
    dq_p, dk_p, dv_p = fa.bwd_plain(*args)
    torch.cuda.synchronize()
    outs = {"fwd_shift": [(o, o_p)], "bwd_dq_shift": [(dq, dq_p)],
            "bwd_dkdv_shift": [(dk_s, dk_p), (dv_s, dv_p)],
            "bwd_fused_shift": [(dq_f, dq_p), (dk_f, dk_p), (dv_f, dv_p)]}
    errs = {n: max(rel_err(a, b) for a, b in pairs)
            for n, pairs in outs.items()}
    lse_err = abs_err(lse, lse_p)
    blocked = shift <= -sk
    log(f"kernels[{case}, shift={shift}]: " + " ".join(
        f"{n}_rel={e:.2e}" for n, e in errs.items())
        + f" lse_abs={lse_err:.2e}")
    if blocked:
        # No row sees a key: o = 0 exactly, lse ~ -1e30, and every
        # gradient 0 (rel_err against the plain zeros is then 0).
        check(torch.count_nonzero(o).item() == 0 and
              lse.max().item() <= -1e29,
              f"{case}: blocked shift {shift} left o != 0 or lse > -1e29")
    else:
        check(lse_err <= LSE_ABS,
              f"{case} shift {shift}: lse disagrees ({lse_err})")
    check(errs["fwd_shift"] <= FWD_REL,
          f"{case} shift {shift}: forward disagrees with its plain version")
    for n in ("bwd_dq_shift", "bwd_dkdv_shift", "bwd_fused_shift"):
        check(errs[n] <= BWD_REL, f"{case} shift {shift}: {n} disagrees "
              f"with its plain version ({errs[n]:.3e})")
    for n, pairs in outs.items():
        e = max(abs_err(a, b) for a, b in pairs)
        if n == "fwd_shift" and not blocked:
            e = max(e, lse_err)
        row = rows.setdefault(n, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], e)
    return args


def _short_times(case: str, args: tuple, shape: tuple, shift=None) -> None:
    """Logs the split kernels' times at a short shape: by events over
    back-to-back calls (``kernel_ms``, which counts the host's launch cost
    where that is the longer) and over a CUDA graph's replay
    (``graph_ms``, the device alone)."""
    from torchft_tpu_torch.ops import flash_attention as fa

    b, s, sk, h, h_kv, d, causal = shape
    for n, fn in (("bwd_dq", fa.flash_bwd_dq),
                  ("bwd_dkdv", fa.flash_bwd_dkdv)):
        ms = cuda_ms(lambda: fn(*args))
        graph_ms = cuda_ms(lambda: fn(*args), graph=True)
        bound_ms, bound_by = bounds(n, b, s, sk, h, h_kv, d, causal, shift)
        sfx = "_shift" if shift is not None else ""
        log(f"time[{n}{sfx} @ {case} S={s} Sk={sk}] kernel_ms={ms:.4f} "
            f"graph_ms={graph_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
            f"bound_share={bound_ms / graph_ms:.3f}")


# Repeats of the fused backward on the same inputs that must agree bitwise
# (ROADMAP C6): the ft shape (static causal) and the sp ring's steps on
# 2048 local tokens (shift 0 on the diagonal block, shift Sk on a past one).
DETERMINISM_REPEATS = 20
DETERMINISM_SHIFTS = (None, 0, 2048)


def _fused_determinism(q, k, v, do) -> dict:
    """The fused backward :data:`DETERMINISM_REPEATS` times on the same
    inputs, each beside forward launches on a second stream that vary how
    its blocks are dispatched; dq, dk and dv must be bitwise equal to the
    first run's. Returns the differing elements per shift mode."""
    from torchft_tpu_torch.ops import flash_attention as fa

    h, h_kv, sk = q.shape[2], k.shape[2], k.shape[1]
    qh, kh, vh = fa.to_bh(q), fa.to_bh(k), fa.to_bh(v)
    side = torch.cuda.Stream()
    out = {}
    for shift in DETERMINISM_SHIFTS:
        causal = shift is None
        o, lse = fa.flash_fwd(qh, kh, vh, h, h_kv, causal, shift)
        doh, delta = fa.bwd_inputs(do, o)
        args = (qh, kh, vh, doh, lse, delta, h, h_kv, causal, shift)
        first = fa.flash_bwd_fused(*args)
        differ = 0
        for r in range(DETERMINISM_REPEATS):
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(r % 3):
                    fa.flash_fwd(qh, kh, vh, h, h_kv, causal, shift)
            again = fa.flash_bwd_fused(*args)
            differ += sum(int((a != b).sum()) for a, b in zip(again, first))
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        label = "static" if causal else f"shift={shift}"
        log(f"determinism[bwd_fused {label}]: {DETERMINISM_REPEATS} repeats "
            f"beside a second stream, differing elements of dq/dk/dv "
            f"{differ}")
        check(differ == 0, f"fused backward ({label}) not bitwise equal "
              f"across repeats: {differ} elements differ")
        out[label] = differ
    return out


def _attest_state_leaves(gen: torch.Generator) -> list:
    """Leaves of the ft cell's committed state on the card, in its pytree
    order's shapes: the 2-layer 7B-width model's parameters and AdamW's
    two moments of each (3 x 666,914,816 f32 = 8.003 GB, the state every
    slice has timed the digest on), random."""
    from torchft_tpu_torch.models.transformer import (Transformer,
                                                      llama2_7b_config)

    model = Transformer(llama2_7b_config(num_layers=2), device="meta")
    shapes = [p.shape for _, p in sorted(model.named_parameters())]
    return [torch.randn(sh, generator=gen, device="cuda")
            for sh in shapes for _ in range(3)]


def _attest_check(rows: dict, gen: torch.Generator) -> None:
    """The attestation kernel against its plain version and numpy's
    ``attest_fingerprint`` of a host copy, bitwise: leaves of f32, bf16,
    int64, bool and uint8 at odd sizes, a leaf that starts off a 16-byte
    boundary, host scalars among them (the optimizer's step), and one
    f32 leaf of 131,072,000 elements (the embedding's, past the u32
    wraparound of every word); then its time on the ft cell's state
    (8.003 GB) against the bound."""
    from torchft_tpu_torch import serialization
    from torchft_tpu_torch.ops import attest

    raw = torch.randint(0, 256, (4099,), generator=gen, device="cuda",
                        dtype=torch.uint8)
    leaves = [
        torch.randn(1001, generator=gen, device="cuda"),
        torch.randn(37, 3, generator=gen, device="cuda").bfloat16(),
        torch.randint(-2 ** 40, 2 ** 40, (13,), generator=gen,
                      device="cuda"),
        torch.randint(0, 2, (17,), generator=gen, device="cuda").bool(),
        raw,
        raw[3:],  # a view 3 bytes past the allocation's alignment
        torch.tensor(7.0),  # a CPU scalar, like AdamW's step
        torch.randn(32000, 4096, generator=gen, device="cuda"),
        torch.randn(4096, generator=gen, device="cuda"),
    ]
    got = attest.attest_words(leaves)
    plain = attest.words_plain(leaves)
    host = serialization.attest_fingerprint([x.cpu() for x in leaves])
    log(f"attest: kernel {serialization.attest_combine(got)} plain "
        f"{serialization.attest_combine(plain)} numpy {host}")
    check(got == plain, "attest_words disagrees with its plain version")
    check(serialization.attest_combine(got) == host,
          "attest_words disagrees with numpy's attest_fingerprint")
    for i, leaf in enumerate(leaves):
        one = attest.attest_words([leaf])
        check(one == attest.words_plain([leaf]),
              f"attest_words disagrees with its plain version on leaf {i} "
              f"({leaf.dtype}, {tuple(leaf.shape)})")
    del leaves
    state = _attest_state_leaves(gen)
    nbytes = sum(x.numel() * x.element_size() for x in state)
    check(attest.attest_words(state) == attest.words_plain(state),
          "attest_words disagrees with its plain version on the state")
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    rows["attest_words"] = {
        "max_abs_err": 0.0, "ms": cuda_ms(lambda: attest.attest_words(state)),
        "plain_ms": cuda_ms(lambda: attest.words_plain(state), iters=1,
                            warmup=0),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": "bytes"}
    r = rows["attest_words"]
    log(f"time[attest_words] state {nbytes / 1e9:.3f} GB in {len(state)} "
        f"leaves: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.1f} "
        f"bound_ms={bound_ms:.4f} (bytes) "
        f"bound_share={bound_ms / r['ms']:.3f}")


def phase_kernels() -> dict:
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import fused_bwd_check

    gen = torch.Generator(device="cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    rows = {}
    name, b, s, sk, h, h_kv, d, shift = PARTIAL_SHIFT
    gen.manual_seed(100)
    _shift_check(rows, name, rnd(b, s, h, d), rnd(b, sk, h_kv, d),
                 rnd(b, sk, h_kv, d), rnd(b, s, h, d), shift, gen)
    for i, (case, b, s, sk, h, h_kv, d, causal) in enumerate(CASES):
        gen.manual_seed(i)
        q, k, v = rnd(b, s, h, d), rnd(b, sk, h_kv, d), rnd(b, sk, h_kv, d)
        do = rnd(b, s, h, d)
        shift_args = {} if case in STATIC_ONLY else {
            sh: _shift_check(rows, case, q, k, v, do, sh, gen)
            for sh in (sk, 0, -sk)}
        qh, kh, vh = fa.to_bh(q), fa.to_bh(k), fa.to_bh(v)
        o, lse = fa.flash_fwd(qh, kh, vh, h, h_kv, causal)
        o_p, lse_p = fa.fwd_plain(qh, kh, vh, h, h_kv, causal)
        doh, delta = fa.bwd_inputs(do, o)
        args = (qh, kh, vh, doh, lse, delta, h, h_kv, causal)
        dq = fa.flash_bwd_dq(*args)
        dk_s, dv_s = fa.flash_bwd_dkdv(*args)
        dk_f, dv_f, dq_f = fa.flash_bwd_fused(*args)
        dq_p, dk_p, dv_p = fa.bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {
            "fwd": rel_err(o, o_p),
            "bwd_dq": rel_err(dq, dq_p),
            "bwd_dkdv": max(rel_err(dk_s, dk_p), rel_err(dv_s, dv_p)),
            "bwd_fused": max(rel_err(dq_f, dq_p), rel_err(dk_f, dk_p),
                             rel_err(dv_f, dv_p)),
        }
        lse_err = abs_err(lse, lse_p)
        # Through the autograd entry point too (padding rule for odd S).
        out = fa.flash_attention(q, k, v, causal)
        ref, _ = fa.flash_attention_fwd_ref(q, k, v, causal)
        e2e = rel_err(out, ref)
        log(f"kernels[{case}] B={b} S={s} Sk={sk} H={h} Hkv={h_kv} D={d} "
            f"causal={causal}: " + " ".join(
                f"{n}_rel={e:.2e}" for n, e in errs.items())
            + f" lse_abs={lse_err:.2e} entry_rel={e2e:.2e}")
        check(errs["fwd"] <= FWD_REL and e2e <= FWD_REL,
              f"{case}: forward disagrees with its plain version")
        check(lse_err <= LSE_ABS, f"{case}: lse disagrees ({lse_err})")
        for n in ("bwd_dq", "bwd_dkdv", "bwd_fused"):
            check(errs[n] <= BWD_REL,
                  f"{case}: {n} disagrees with its plain version "
                  f"({errs[n]:.3e})")
        # Worst absolute error over the cases and over every output the
        # kernel writes, each against its plain version.
        abs_errs = {
            "fwd": max(abs_err(o, o_p), lse_err),
            "bwd_dq": abs_err(dq, dq_p),
            "bwd_dkdv": max(abs_err(dk_s, dk_p), abs_err(dv_s, dv_p)),
            "bwd_fused": max(abs_err(dq_f, dq_p), abs_err(dk_f, dk_p),
                             abs_err(dv_f, dv_p)),
        }
        for n, e in abs_errs.items():
            row = rows.setdefault(n, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], e)
        if case in SHORT_TIMES:
            shape = (b, s, sk, h, h_kv, d, causal)
            if SHORT_TIMES[case]:
                _short_times(case, shift_args[sk], shape, sk)
            else:
                _short_times(case, args, shape)
        if case != "slice":
            continue
        # Times at the slice's shape: kernel, plain version, library call.
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_q = qs.detach().requires_grad_()
        sdpa_k = ks.detach().requires_grad_()
        sdpa_v = vs.detach().requires_grad_()
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, is_causal=causal)
        sdpa_g = do.transpose(1, 2)

        def sdpa_bwd():
            torch.autograd.grad(sdpa_out, (sdpa_q, sdpa_k, sdpa_v), sdpa_g,
                                retain_graph=True)

        times = {
            "fwd": (lambda: fa.flash_fwd(qh, kh, vh, h, h_kv, causal),
                    lambda: fa.fwd_plain(qh, kh, vh, h, h_kv, causal),
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs, ks, vs, is_causal=causal)),
            "bwd_dq": (lambda: fa.flash_bwd_dq(*args),
                       lambda: fa.bwd_plain(*args), None),
            "bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*args),
                         lambda: fa.bwd_plain(*args), None),
            "bwd_fused": (lambda: fa.flash_bwd_fused(*args),
                          lambda: fa.bwd_plain(*args), sdpa_bwd),
        }
        # The shift mode at the ring's per-step shape (shift = Sk: a past
        # block, fully visible). Its yardstick is SDPA non-causal for out
        # alone: no public PyTorch call returns the lse.
        sh_args = shift_args[sk]
        sdpa_nc = torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, is_causal=False)

        def sdpa_nc_bwd():
            torch.autograd.grad(sdpa_nc, (sdpa_q, sdpa_k, sdpa_v), sdpa_g,
                                retain_graph=True)

        times.update({
            "fwd_shift": (
                lambda: fa.flash_fwd(qh, kh, vh, h, h_kv, False, sk),
                lambda: fa.fwd_plain(qh, kh, vh, h, h_kv, False, sk),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=False)),
            "bwd_dq_shift": (lambda: fa.flash_bwd_dq(*sh_args),
                             lambda: fa.bwd_plain(*sh_args), None),
            "bwd_dkdv_shift": (lambda: fa.flash_bwd_dkdv(*sh_args),
                               lambda: fa.bwd_plain(*sh_args), None),
            "bwd_fused_shift": (lambda: fa.flash_bwd_fused(*sh_args),
                                lambda: fa.bwd_plain(*sh_args),
                                sdpa_nc_bwd),
        })
        for n, (kern, plain, lib) in times.items():
            shift = sk if n.endswith("_shift") else None
            bound_ms, bound_by = bounds(n, b, s, sk, h, h_kv, d, causal,
                                        shift)
            rows[n].update(
                ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=3),
                library_ms=cuda_ms(lib) if lib is not None else None,
                bound_ms=bound_ms, bound_by=bound_by)
            log(f"time[{n}] kernel_ms={rows[n]['ms']:.4f} "
                f"plain_ms={rows[n]['plain_ms']:.3f} "
                f"library_ms={rows[n]['library_ms']} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) "
                f"bound_share={bound_ms / rows[n]['ms']:.3f}")
        # No PyTorch call returns dq alone or dk/dv alone; SDPA's backward
        # returns all three, so the split pair stands against it.
        for sfx in ("", "_shift"):
            pair = rows[f"bwd_dq{sfx}"]["ms"] + rows[f"bwd_dkdv{sfx}"]["ms"]
            sdpa = rows[f"bwd_fused{sfx}"]["library_ms"]
            log(f"time[split_pair{sfx}] dq+dkdv_ms={pair:.4f} "
                f"sdpa_bwd_ms={sdpa:.4f} ratio={pair / sdpa:.2f}")
        worst = fused_bwd_check.compare(q, k, v, do, causal)
        log(f"fused_bwd_check: fused vs split rel={worst:.3e}")
        check(worst <= fused_bwd_check.TOLERANCE,
              "fused backward disagrees with the split backward")
        _fused_determinism(q, k, v, do)
    _attest_check(rows, gen)
    return rows


# ------------------------------------------------------------ phase 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The slice: Llama-2-7B widths cut to 1 layer, batch 1 x 2048 tokens.
FT_ENV = {"MODEL": "llama2_7b", "NUM_LAYERS": "1", "BATCH_SIZE": "1",
          "SEQ_LEN": "2048"}
FT_ARGS: list = []


def _spawn(group: int, seed: int, lighthouse: str, workdir: str,
           steps: int, hold: int = 0, extra: dict = None,
           groups: int = 2) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(FT_ENV)
    env.update(extra or {})
    if hold:
        env["HOLD_AFTER_STEP"] = str(hold)
    env.update(
        REPLICA_GROUP_ID=str(group), NUM_REPLICA_GROUPS=str(groups),
        TORCHFT_LIGHTHOUSE=lighthouse, TOTAL_STEPS=str(steps),
        INIT_SEED=str(seed), DATA_DIR=workdir, TORCHFT_HEAL_STALL_SEC="120",
        REPORT_FILE=os.path.join(workdir, f"report_{group}_{seed}.json"),
        PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    return _popen(
        [sys.executable, "-m", "torchft_tpu_torch.train_lm", *FT_ARGS],
        os.path.join(workdir, f"group_{group}_{seed}.log"), env=env)


def _wait_report(proc: subprocess.Popen, workdir: str, group: int,
                 seed: int, others: list, done, what: str) -> None:
    """Until ``done(report)`` holds for ``group``'s report; fails if any
    of the processes exits first."""
    progress = os.path.join(workdir, f"report_{group}_{seed}.json")
    deadline = time.time() + 600
    while time.time() < deadline:
        if os.path.exists(progress):
            with open(progress) as f:
                try:
                    rep = json.load(f)
                except json.JSONDecodeError:
                    rep = {}
            if done(rep):
                return
        check(all(p.poll() is None for p in [proc, *others]),
              f"a replica group exited before group {group} reached {what}")
        time.sleep(0.05)
    raise SmokeError(f"group {group} never reached {what}")


def _held(rep: dict) -> bool:
    return bool(rep.get("held"))


def _read_report(workdir: str, group: int, seed: int) -> dict:
    with open(os.path.join(workdir, f"report_{group}_{seed}.json")) as f:
        return json.load(f)


def _wait(proc: subprocess.Popen, timeout: float, what: str) -> None:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raise SmokeError(f"{what} did not finish in {timeout:.0f} s")
    check(rc == 0, f"{what} exited with {rc}")


def _kill_and_heal(procs: list, tag: str, extra: dict) -> tuple:
    """Two ``train_lm`` groups under a lighthouse with its defaults (two
    members per quorum): group 1 holds after its second step and is
    SIGKILLed, a new group 1 with another init seed heals from group 0,
    and both run to step 4. Returns both groups' final reports."""
    from torchft_tpu_torch._native import Lighthouse

    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    # Two members per quorum: the survivor waits for the restarted group
    # instead of running ahead alone.
    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=2,
                    join_timeout_ms=2000, quorum_tick_ms=50)
    addr = lh.address()
    total = 4
    try:
        t0 = time.perf_counter()
        g0 = _spawn(0, 0, addr, workdir, total, extra=extra)
        # Group 1 holds after its second step: group 0 then waits in the
        # next quorum round (two members per quorum) until the kill. Under
        # overlap the held step's exchange is still in flight.
        g1 = _spawn(1, 1, addr, workdir, total, hold=2, extra=extra)
        procs += [g0, g1]
        _wait_report(g1, workdir, 1, 1, [g0], _held, "its held step")
        os.killpg(g1.pid, signal.SIGKILL)
        g1.wait()
        log(f"{tag}: SIGKILLed group 1 after step 2 "
            f"({time.perf_counter() - t0:.1f} s)")
        g1b = _spawn(1, 7, addr, workdir, total, extra=extra)
        procs.append(g1b)
        _wait(g0, 900, "group 0")
        _wait(g1b, 900, "restarted group 1")
        st = lh.status()
        log(f"{tag}: lighthouse fast_path_hits={st['fast_path_hits']} "
            f"slow_path_rounds={st['slow_path_rounds']}")
    finally:
        lh.shutdown()
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name),
                            os.path.join(OUT_DIR, f"{tag}_{name}"))
    r0 = _read_report(workdir, 0, 0)
    r1 = _read_report(workdir, 1, 7)
    shutil.rmtree(workdir, ignore_errors=True)
    for r in (r0, r1):
        log(f"{tag}: group {r['group']} steps={r['step']} "
            f"losses={[round(x, 4) for x in r['losses']]} "
            f"committed={r['committed']} step_s={r['step_s']} "
            f"allreduce_ms={r['allreduce_ms']} heal_ms={r['heal_ms']} "
            f"aborted_steps={r['aborted_steps']} "
            f"launches={r['launches']} hash={r['state_hash'][:16]}")
    check(r0["state_hash"] == r1["state_hash"],
          f"{tag}: groups ended with different parameter/optimizer state")
    check(r1["heal_count"] >= 1, f"{tag}: restarted group 1 never healed")
    check(all(r0["committed"][-2:]),
          f"{tag}: a post-heal step of group 0 aborted")
    for r in (r0, r1):
        check(all(x == x and abs(x) != float("inf") for x in r["losses"]),
              f"{tag}: group {r['group']}: non-finite loss")
        check(r["launches"]["fwd"] > 0 and r["launches"]["bwd_fused"] > 0,
              f"{tag}: group {r['group']}: flash kernels not launched")
        check(r["params_on_cpu"] == 0,
              f"{tag}: group {r['group']}: parameters left on the CPU")
    return r0, r1


def phase_ft(procs: list) -> dict:
    """The main path (see the module docstring). Returns per-group
    reports and the kernels' launch counts summed over the groups."""
    r0, r1 = _kill_and_heal(procs, "ft", {})
    check(all(r1["committed"]), "a post-heal step of group 1 aborted")
    launches = {n: r0["launches"][n] + r1["launches"][n] for n in KERNELS}
    return {"launches": launches, "reports": [r0, r1]}


def phase_overlap(procs: list) -> dict:
    """The ft phase's drill under ``OVERLAP_STEPS=1`` (see the module
    docstring)."""
    r0, r1 = _kill_and_heal(procs, "overlap", {"OVERLAP_STEPS": "1"})
    for r in (r0, r1):
        hidden = np.diff([0.0] + r["hidden_ms"]).round(1).tolist()
        drain = np.diff([0.0] + r["drain_wait_ms"]).round(1).tolist()
        log(f"overlap: group {r['group']} per step hidden_ms={hidden} "
            f"drain_wait_ms={drain} overlap_grads_dropped="
            f"{r['overlap_grads_dropped']} committed_steps="
            f"{r['committed_steps']}")
        check(r["overlap_steps"] == 1
              and len(r["hidden_ms"]) == len(r["step_s"])
              and len(r["drain_wait_ms"]) == len(r["step_s"]),
              f"overlap: group {r['group']} did not run the overlap loop")
    check(all(r1["committed"]) and r1["aborted_steps"] == 0,
          "overlap: a step of the restarted group 1 aborted")
    check(r0["overlap_grads_dropped"] >= 1
          and r0["overlap_grads_dropped"] == r0["aborted_steps"],
          "overlap: group 0 dropped %d deferred steps but lost %d to the "
          "kill" % (r0["overlap_grads_dropped"], r0["aborted_steps"]))
    launches = {n: r0["launches"][n] + r1["launches"][n] for n in KERNELS}
    return {"launches": launches, "reports": [r0, r1]}


# The attest cell: the ft cell's model in three groups on this card (a
# strict majority needs three voters), ATTEST_STEPS steps. Group 1 carries
# the chaos sdc band: one bit flip, drawn at a boundary where it is a
# participant. It heals at step 1 (a non-primary of the first quorum), and
# a flip drawn there would be overwritten by that heal, so the band's seed
# makes its first draw miss (step 1) and its second hit (step 3; no draw
# at step 2, while the heal flag holds). Group 2 holds after
# ATTEST_HOLD, is SIGKILLed and restarted with another init seed, and
# heals striped from groups 0 and 1.
ATTEST_GROUPS = 3
ATTEST_STEPS = 8
ATTEST_HOLD = 6
ATTEST_CHAOS = "seed=2;sdc:sdc_flip_rate=0.5,max_faults=1"
SDC_LADDER = ("sdc_chaos_flips_total", "sdc_quarantines_total",
              "sdc_reheals_total", "sdc_quarantine_clears_total")


def _fleet_status(lighthouse: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://{lighthouse}/fleet/status.json",
                                timeout=10) as resp:
        return json.load(resp)


def phase_attest(procs: list) -> dict:
    """The recovery plane with its defaults (fleet telemetry,
    attestation, striped heal) on the main path: see ATTEST_* above."""
    from torchft_tpu_torch._native import Lighthouse

    workdir = tempfile.mkdtemp(prefix="chip_smoke_attest_")
    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}",
                    min_replicas=ATTEST_GROUPS, join_timeout_ms=2000,
                    quorum_tick_ms=50)
    addr = lh.address()
    try:
        t0 = time.perf_counter()
        g0 = _spawn(0, 0, addr, workdir, ATTEST_STEPS, groups=ATTEST_GROUPS,
                    extra={"REPORT_HOST_DIGEST": "1"})
        g1 = _spawn(1, 1, addr, workdir, ATTEST_STEPS, groups=ATTEST_GROUPS,
                    extra={"TORCHFT_CHAOS": ATTEST_CHAOS})
        g2 = _spawn(2, 2, addr, workdir, ATTEST_STEPS, hold=ATTEST_HOLD,
                    groups=ATTEST_GROUPS)
        procs += [g0, g1, g2]
        _wait_report(g2, workdir, 2, 2, [g0, g1], _held, "its held step")
        before = _read_report(workdir, 2, 2)
        os.killpg(g2.pid, signal.SIGKILL)
        g2.wait()
        log(f"attest: SIGKILLed group 2 after step {ATTEST_HOLD} "
            f"({time.perf_counter() - t0:.1f} s)")
        g2b = _spawn(2, 9, addr, workdir, ATTEST_STEPS, groups=ATTEST_GROUPS)
        procs.append(g2b)
        for proc, what in ((g0, "group 0"), (g1, "group 1"),
                           (g2b, "restarted group 2")):
            _wait(proc, 900, f"attest {what}")
        fleet = _fleet_status(addr)["fleet"]
        st = lh.status()
        log(f"attest: lighthouse sdc_verdicts_total="
            f"{fleet['sdc_verdicts_total']} sdc_clears_total="
            f"{fleet['sdc_clears_total']} quarantined="
            f"{fleet['sdc_quarantined']} fast_path_hits="
            f"{st['fast_path_hits']} slow_path_rounds="
            f"{st['slow_path_rounds']}")
    finally:
        lh.shutdown()
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name),
                            os.path.join(OUT_DIR, f"attest_{name}"))
    reps = [_read_report(workdir, 0, 0), _read_report(workdir, 1, 1),
            _read_report(workdir, 2, 9)]
    shutil.rmtree(workdir, ignore_errors=True)
    for r in [*reps, before]:
        sdc = r["sdc"]
        per = sdc["sdc_digest_ms_total"] / max(sdc["sdc_digests_total"], 1)
        log(f"attest: group {r['group']} (seed {r['seed']}) steps="
            f"{r['step']} committed={r['committed']} step_s={r['step_s']} "
            f"heal_count={r['heal_count']} heal_ms={r['heal_ms']} "
            f"heal_MB={r['heal_bytes'] / 1e6:.1f} heal_striped_donors="
            f"{r['heal_striped_donors']} sdc={sdc} digest_ms_per_boundary="
            f"{per:.3f} events={r['sdc_events']} launches={r['launches']} "
            f"digest={r['state_digest']} hash={r.get('state_hash', '')[:16]}")
    r0, r1, r2 = reps
    check(fleet["sdc_verdicts_total"] == 1 and fleet["sdc_clears_total"] == 1,
          f"attest: lighthouse verdicts {fleet['sdc_verdicts_total']} / "
          f"clears {fleet['sdc_clears_total']}, expected 1 / 1")
    for k in SDC_LADDER:
        check(r1["sdc"][k] == 1, f"attest: group 1 {k} = {r1['sdc'][k]}")
    # The flip is logged with the step whose boundary it follows (N); the
    # first digest it changes is step N + 1's, and that vote's verdict
    # arrives with step N + 2's quorum, where the latch is logged.
    steps = {e["event"]: e["step"] for e in r1["sdc_events"]}
    check(steps["sdc_divergence"] - steps["sdc_chaos_flip"] <= 2,
          f"attest: group 1's verdict came more than one boundary after "
          f"its flip ({steps})")
    check(r1["heal_striped_donors"] == 2,
          f"attest: group 1's re-heal took {r1['heal_striped_donors']} "
          "donors, expected 2")
    for r in (r0, r2, before):
        check(all(r["sdc"][k] == 0 for k in SDC_LADDER),
              f"attest: group {r['group']} latched: {r['sdc']}")
    check(r2["heal_count"] >= 1 and r2["heal_striped_donors"] == 2,
          f"attest: restarted group 2 healed {r2['heal_count']} times from "
          f"{r2['heal_striped_donors']} donors, expected 2")
    check(all(r2["committed"]) and r2["aborted_steps"] == 0,
          "attest: a post-heal step of the restarted group 2 aborted")
    check(len({r["state_hash"] for r in reps}) == 1,
          "attest: groups ended with different state")
    check(len({r["state_digest"] for r in reps}) == 1
          and reps[0]["state_digest"],
          f"attest: last digests differ: {[r['state_digest'] for r in reps]}")
    fd = r0["final_digest"]
    check(fd["card"] == fd["host"], f"attest: group 0's card digest "
          f"{fd['card']} != numpy's on its host copy {fd['host']}")
    for r in reps:
        # Every vote boundary but a process's first pushes a digest.
        votes = r["committed_steps"] + r["aborted_steps"]
        check(r["sdc"]["sdc_digests_total"] == votes - 1,
              f"attest: group {r['group']} made "
              f"{r['sdc']['sdc_digests_total']} digests at {votes} vote "
              "boundaries")
        check(all(x == x and abs(x) != float("inf") for x in r["losses"]),
              f"attest: group {r['group']}: non-finite loss")
        check(r["params_on_cpu"] == 0,
              f"attest: group {r['group']}: parameters left on the CPU")
    launches = {n: sum(r["launches"][n] for r in reps) for n in KERNELS}
    check(launches["attest_words"] > 0 and launches["bwd_fused"] > 0,
          f"attest: kernels not launched ({launches})")
    log(f"attest: restarted group 2's striped heal {r2['heal_ms']} ms for "
        f"{r2['heal_bytes'] / 1e6:.1f} MB "
        f"({r2['heal_bytes'] / 1e3 / max(r2['heal_ms'], 1e-9):.1f} MB/s)")
    return {"launches": launches, "reports": reps}


# The durable cell: the ft cell's model, both groups with CHECKPOINT_DIR
# and CHECKPOINT_EVERY=2. Run A: group 1 gets SIGTERM once its report
# shows DURABLE_SIGTERM_AT, drains and exits 0; group 0 steps on alone
# to DURABLE_STEPS_A (a lighthouse with min_replicas=1). Run B: one byte
# of group 1's newest file flipped, two fresh groups on the same
# directories under a lighthouse with two members per quorum.
DURABLE_EVERY = 2
DURABLE_STEPS_A = 4
DURABLE_SIGTERM_AT = 2
DURABLE_STEPS_B = 5
# Run A writes two files per group, 5.57 GB each at the ft cell's
# widths; the check keeps room for eight.
DURABLE_DISK_BYTES = 48e9


def _flip_payload_byte(path: str) -> int:
    """Flip one byte in the middle of a durable file's array payload;
    returns its offset."""
    from torchft_tpu_torch import checkpoint_io

    with open(path, "rb") as f:
        head, mf, start = checkpoint_io._open_verified(f)
    first = start + int(mf["preamble_len"])
    off = first + (start + int(head["payload_len"]) - first) // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return off


def _save_rows(tag: str, r: dict) -> None:
    """Log each save of one report, and its steps' walls with and without
    a save."""
    for s in r["ckpt_saves"]:
        nbytes = r["ckpt"]["ckpt_save_bytes_total"] / max(
            r["ckpt"]["ckpt_save_count"], 1)
        log(f"durable: {tag} save at step {s['step']}: dispatch_ms="
            f"{s['dispatch_ms']} snapshot_card_ms="
            f"{s.get('snapshot_card_ms')} write_ms={s.get('write_ms')} "
            f"({nbytes / 1e3 / max(s.get('write_ms') or 0, 1e-9):.1f} MB/s"
            f" of {nbytes / 1e9:.3f} GB) durable_ms={s.get('durable_ms')}")
    walls = list(zip(r["step_s"], r["saved"]))
    log(f"durable: {tag} step_s with a save {[w for w, s in walls if s]} "
        f"without {[w for w, s in walls if not s]} "
        f"peak_card_GB={r['peak_card_bytes'] / 1e9:.3f}")


def phase_durable(procs: list) -> dict:
    """The durability plane on the main path: see DURABLE_* above and the
    module docstring."""
    from torchft_tpu_torch import checkpoint_io
    from torchft_tpu_torch._native import Lighthouse

    workdir = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    ckdir = os.path.join(workdir, "ckpt")
    lhs: list = []
    try:
        free = shutil.disk_usage(workdir).free
        log(f"durable: {free / 1e9:.1f} GB free under {workdir}")
        check(free >= DURABLE_DISK_BYTES,
              f"durable: {free / 1e9:.1f} GB free under {workdir}, the "
              f"phase needs {DURABLE_DISK_BYTES / 1e9:.0f} GB")
        extra = {"CHECKPOINT_DIR": ckdir,
                 "CHECKPOINT_EVERY": str(DURABLE_EVERY)}
        # Run A: the graceful reclaim.
        lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=1,
                        join_timeout_ms=2000, quorum_tick_ms=50)
        lhs.append(lh)
        t0 = time.perf_counter()
        g0 = _spawn(0, 0, lh.address(), workdir, DURABLE_STEPS_A,
                    extra=extra)
        g1 = _spawn(1, 1, lh.address(), workdir, DURABLE_STEPS_A,
                    extra=extra)
        procs += [g0, g1]
        _wait_report(g1, workdir, 1, 1, [g0],
                     lambda r: r.get("step", 0) >= DURABLE_SIGTERM_AT,
                     f"step {DURABLE_SIGTERM_AT}")
        t_sig = time.perf_counter()
        os.kill(g1.pid, signal.SIGTERM)
        _wait(g1, 600, "durable: group 1 after SIGTERM")
        drain_s = time.perf_counter() - t_sig
        _wait(g0, 900, "durable: group 0 (run A)")
        a0, a1 = _read_report(workdir, 0, 0), _read_report(workdir, 1, 1)
        # The drain's final save is the writer's time not in a cadence
        # save's record.
        final_ms = a1["ckpt"]["ckpt_save_ms_total"] - sum(
            s.get("write_ms") or 0.0 for s in a1["ckpt_saves"])
        log(f"durable: run A {time.perf_counter() - t0:.1f} s; group 1 "
            f"SIGTERM to exit {drain_s:.2f} s (drained at step "
            f"{a1['step']}, its final save's write {final_ms:.1f} ms)")
        for r in (a0, a1):
            log(f"durable: run A group {r['group']} steps={r['step']} "
                f"committed={r['committed']} step_s={r['step_s']} "
                f"aborted_steps={r['aborted_steps']} heal_ms={r['heal_ms']} "
                f"ckpt={r['ckpt']} preempt={r['preempt']} "
                f"preempted={r['preempted']} hash={r['state_hash'][:16]}")
            _save_rows(f"run A group {r['group']}", r)
        check(a1["preempted"] and a1["preempt"]["graceful_exits_total"] == 1
              and a1["preempt"]["preempt_deadline_expired_total"] == 0,
              f"durable: group 1 did not drain gracefully: {a1['preempt']}")
        newest = checkpoint_io.latest(os.path.join(ckdir, "1"))
        head = checkpoint_io.verify(newest)
        check(head["committed"] and head["step"] == a1["step"],
              f"durable: group 1's newest file {newest} is step "
              f"{head['step']} (committed={head['committed']}), it drained "
              f"at {a1['step']}")
        check(a0["step"] == DURABLE_STEPS_A and all(a0["committed"])
              and a0["aborted_steps"] == 0,
              f"durable: group 0 aborted a step across the departure "
              f"(committed={a0['committed']}, aborted={a0['aborted_steps']})")
        check(checkpoint_io.verify(checkpoint_io.latest(
            os.path.join(ckdir, "0")))["step"] == DURABLE_STEPS_A,
            "durable: group 0's newest file is not its last step")
        # Run B: a correlated failure, restarted cold from divergent,
        # partly corrupt directories.
        off = _flip_payload_byte(newest)
        log(f"durable: flipped byte {off} of {newest}")
        lh2 = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=2,
                         join_timeout_ms=2000, quorum_tick_ms=50)
        lhs.append(lh2)
        t1 = time.perf_counter()
        b0 = _spawn(0, 10, lh2.address(), workdir, DURABLE_STEPS_B,
                    extra=extra)
        b1 = _spawn(1, 11, lh2.address(), workdir, DURABLE_STEPS_B,
                    extra=extra)
        procs += [b0, b1]
        _wait(b0, 900, "durable: group 0 (run B)")
        _wait(b1, 900, "durable: group 1 (run B)")
        log(f"durable: run B {time.perf_counter() - t1:.1f} s")
        r0, r1 = _read_report(workdir, 0, 10), _read_report(workdir, 1, 11)
        for r in (r0, r1):
            res = r["resume"]
            ms = res["recover_ms"] + res["load_ms"]
            log(f"durable: run B group {r['group']} resumed_from="
                f"{os.path.basename(r['resumed_from'])} recover_ms="
                f"{res['recover_ms']} load_ms={res['load_ms']} ("
                f"{res['bytes'] / 1e3 / max(ms, 1e-9):.1f} MB/s of "
                f"{res['bytes'] / 1e9:.3f} GB) ckpt={r['ckpt']} "
                f"heal_count={r['heal_count']} heal_ms={r['heal_ms']} "
                f"committed={r['committed']} step_s={r['step_s']} "
                f"losses={[round(x, 4) for x in r['losses']]} "
                f"launches={r['launches']} hash={r['state_hash'][:16]} "
                f"peak_card_GB={r['peak_card_bytes'] / 1e9:.3f}")
        check(r0["resumed_step"] == DURABLE_STEPS_A
              and r0["resumed_hash"] == a0["state_hash"],
              "durable: group 0's cold start is not its run-A state "
              f"(step {r0['resumed_step']})")
        ck1 = r1["ckpt"]
        check(ck1["ckpt_corrupt_quarantined"] == 1
              and ck1["ckpt_recover_fallbacks"] >= 1
              and os.path.exists(newest + ".corrupt"),
              f"durable: group 1 did not quarantine the flipped file: {ck1}")
        check(r1["resumed_step"] < a1["step"] and r1["heal_count"] >= 1,
              f"durable: group 1 resumed at {r1['resumed_step']} and healed "
              f"{r1['heal_count']} times")
        for r in (r0, r1):
            check(r["step"] == DURABLE_STEPS_B and all(r["committed"])
                  and r["aborted_steps"] == 0,
                  f"durable: group {r['group']} aborted after the cold start")
            check(all(x == x and abs(x) != float("inf")
                      for x in r["losses"]),
                  f"durable: group {r['group']}: non-finite loss")
            check(r["params_on_cpu"] == 0,
                  f"durable: group {r['group']}: parameters on the CPU")
            check(r["launches"]["fwd"] > 0
                  and r["launches"]["bwd_fused"] > 0,
                  f"durable: group {r['group']}: flash kernels not launched")
        check(r0["state_hash"] == r1["state_hash"],
              "durable: groups ended run B with different state")
    finally:
        for lh in lhs:
            lh.shutdown()
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name),
                            os.path.join(OUT_DIR, f"durable_{name}"))
        shutil.rmtree(workdir, ignore_errors=True)
    reps = [a0, a1, r0, r1]
    launches = {n: sum(r["launches"][n] for r in reps) for n in KERNELS}
    for g in (0, 1):
        check(sum(r["launches"]["attest_words"] for r in reps
                  if r["group"] == g) > 0,
              f"durable: group {g} never launched attest_words")
    return {"launches": launches, "reports": reps}


# ------------------------------------------------------------ phase 4


def phase_split() -> dict:
    """One training step at a short sequence through the port's model, on
    this card: fewer than 4 q tiles, so the backward takes the split
    kernels."""
    from torchft_tpu_torch.models.transformer import (
        Transformer, chunked_causal_lm_loss, llama2_7b_config)
    from torchft_tpu_torch.ops import flash_attention as fa

    cfg = llama2_7b_config(num_layers=2, attention_fn=fa.flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer(cfg, generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 192), generator=gen,
                           device="cuda")
    fa.reset_launches()
    hidden = model(tokens, return_hidden=True)
    loss = chunked_causal_lm_loss(hidden, model.lm_head_kernel(), tokens)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    log(f"split: loss={loss.detach().item():.4f} launches={launches}")
    check(torch.isfinite(loss).item(), "split path: non-finite loss")
    check(launches["bwd_dq"] > 0 and launches["bwd_dkdv"] > 0,
          "split path: split backward kernels not launched")
    check(launches["bwd_fused"] == 0, "split path took the fused kernel")
    return launches


# ------------------------------------------------------------ phase 5


# The sp cell: Llama-2-7B widths cut to 1 layer, one sequence of 4096
# tokens (Llama-2's max_seq_len), 2048 per rank; SP_STEPS steps, then one
# at SP_SHORT_SEQ tokens (128 per rank, fewer than 4 q tiles) for the split
# backward.
SP_LAYERS = 1
SP_SEQ = 4096
SP_STEPS = 2
SP_SHORT_SEQ = 256


def _sp_model(attention_fn):
    """The sp cell's model, from the same seeded generator in every
    process that builds it."""
    from torchft_tpu_torch.models.transformer import (Transformer,
                                                      llama2_7b_config)

    cfg = llama2_7b_config(num_layers=SP_LAYERS, attention_fn=attention_fn,
                           remat=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return Transformer(cfg, device="cuda", generator=gen)


def _sp_tokens(vocab: int, step: int, seq: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1000 + step)
    return torch.randint(0, vocab, (1, seq), generator=gen).cuda()


def _sp_attention_inputs(cfg) -> list:
    """q, k, v and the output cotangent over the whole sequence, seeded:
    the ranks cut their pieces from these and the static reference reads
    them whole."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    return [torch.randn(1, SP_SEQ, cfg.num_heads, cfg.head_dim,
                        generator=gen, device="cuda", dtype=cfg.dtype)
            for _ in range(4)]


def _grad_norm(model) -> float:
    return float(torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(p.grad.float()) for p in
        model.parameters()])))


def _params_hash(model) -> str:
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _fwd_bwd(attn, q, k, v, g) -> tuple:
    """(out, dq, dk, dv) of one causal attention forward + backward."""
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    out = attn(qq, kk, vv, True)
    out.backward(g)
    return out.detach(), qq.grad, kk.grad, vv.grad


def _fwd_bwd_ms(attn, q, k, v, g, iters: int = 5) -> float:
    """Host-clock ms of one attention forward + backward (synchronized:
    the ring's hops run on the host)."""
    _fwd_bwd(attn, q, k, v, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        _fwd_bwd(attn, q, k, v, g)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def sp_worker(rank: int, init: str, report: str) -> int:
    """One rank of the sp phase (run as ``chip_smoke.py --sp-worker``)."""
    import torch.distributed as dist

    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.ring_attention import (
        _hop, make_ring_attention)
    from torchft_tpu_torch.parallel.step import SPTrainer

    dist.init_process_group("gloo", init_method=init, world_size=2,
                            rank=rank)
    ring = make_ring_attention()
    model = _sp_model(ring)
    cfg = model.cfg
    trainer = SPTrainer(model, torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8))
    out = {"rank": rank, "losses": [], "hashes": [], "timings": []}
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    for step in range(SP_STEPS):
        loss = trainer.train_step(_sp_tokens(cfg.vocab_size, step, SP_SEQ))
        out["losses"].append(float(loss))
        out["timings"].append(trainer.last_step_timings)
        if step == 0:
            out["grad_norm_1"] = _grad_norm(model)
        out["hashes"].append(_params_hash(model))
    out["launches"] = dict(fa.LAUNCHES)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    # The split backward's shift mode: fewer than 4 q tiles per rank.
    fa.reset_launches()
    trainer.train_step(_sp_tokens(cfg.vocab_size, SP_STEPS, SP_SHORT_SEQ))
    out["split_launches"] = dict(fa.LAUNCHES)
    # The ring-attention layer alone on this rank's piece of one seeded
    # sequence, against the static kernels on the whole of it.
    full = _sp_attention_inputs(cfg)
    piece = slice(rank * SP_SEQ // 2, (rank + 1) * SP_SEQ // 2)
    q, k, v, g = (x[:, piece].contiguous() for x in full)
    ring_res = _fwd_bwd(ring, q, k, v, g)
    ref = _fwd_bwd(fa.flash_attention, *full)
    out["attn_rel"] = {n: rel_err(a, b[:, piece]) for n, a, b in
                       zip(("out", "dq", "dk", "dv"), ring_res, ref)}
    del full, ref, ring_res
    out["ring_ms"] = _fwd_bwd_ms(ring, q, k, v, g)
    # One K/V hop of that layer (the forward makes one, the backward one).
    t0 = time.perf_counter()
    for _ in range(5):
        _hop(dist.group.WORLD, (k, v), 1)
    torch.cuda.synchronize()
    out["hop_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    with open(report, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def phase_sp(procs: list) -> dict:
    """The sequence-parallel path (see the module docstring). Returns the
    shift-mode launch counts summed over the ranks."""
    from torchft_tpu_torch.models.transformer import chunked_causal_lm_loss
    from torchft_tpu_torch.ops import flash_attention as fa

    workdir = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    init = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    ranks = []
    for rank in range(2):
        ranks.append(_popen(
            [sys.executable, os.path.abspath(__file__), "--sp-worker",
             str(rank), "--sp-init", init, "--sp-report",
             os.path.join(workdir, f"sp_{rank}.json")],
            os.path.join(workdir, f"sp_rank_{rank}.log")))
    procs += ranks
    try:
        for rank, proc in enumerate(ranks):
            _wait(proc, 600, f"sp rank {rank}")
    finally:
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name), OUT_DIR)
    reps = []
    for rank in range(2):
        with open(os.path.join(workdir, f"sp_{rank}.json")) as f:
            reps.append(json.load(f))
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"sp: both ranks done in {time.perf_counter() - t0:.1f} s")
    for r in reps:
        log(f"sp: rank {r['rank']} losses={r['losses']} "
            f"grad_norm_1={r['grad_norm_1']} peak_gb={r['peak_gb']} "
            f"ring_ms={r['ring_ms']:.3f} hop_ms={r['hop_ms']:.3f} "
            f"launches={r['launches']} "
            f"split_launches={r['split_launches']}")
        for i, t in enumerate(r["timings"]):
            log(f"sp: rank {r['rank']} step {i + 1} " + " ".join(
                f"{k}_s={v:.4f}" for k, v in t.items()))
        log(f"sp: rank {r['rank']} ring vs static flash_attention at "
            f"S={SP_SEQ}: " + " ".join(
                f"{n}_rel={e:.2e}" for n, e in r["attn_rel"].items()))

    # Step 1 against one process on the whole sequence, static kernels.
    model = _sp_model(fa.flash_attention)
    tokens = _sp_tokens(model.cfg.vocab_size, 0, SP_SEQ)
    loss = chunked_causal_lm_loss(model(tokens, return_hidden=True),
                                  model.lm_head_kernel(), tokens)
    loss.backward()
    ref_loss, ref_norm = float(loss.detach()), _grad_norm(model)
    cfg = model.cfg
    del model, loss
    r0, r1 = reps
    loss_rel = abs(r0["losses"][0] - ref_loss) / abs(ref_loss)
    norm_rel = abs(r0["grad_norm_1"] - ref_norm) / ref_norm
    log(f"sp: step 1 vs one process: loss {r0['losses'][0]:.6f} vs "
        f"{ref_loss:.6f} (rel {loss_rel:.2e}), grad norm "
        f"{r0['grad_norm_1']:.6f} vs {ref_norm:.6f} (rel {norm_rel:.2e})")
    # The ring-attention layer against the static kernels at the whole
    # sequence (same heads and widths).
    static_ms = _fwd_bwd_ms(fa.flash_attention, *_sp_attention_inputs(cfg))
    log(f"sp: attention fwd+bwd, ring over 2 ranks at S_local="
        f"{SP_SEQ // 2}: {r0['ring_ms']:.3f} / {r1['ring_ms']:.3f} ms; "
        f"static flash_attention at S={SP_SEQ}: {static_ms:.3f} ms")

    # Every reading is logged above; now the checks.
    for i, (h0, h1) in enumerate(zip(r0["hashes"], r1["hashes"])):
        check(h0 == h1, f"sp: ranks' parameters differ after step {i + 1}")
    check(len(r0["hashes"]) == SP_STEPS, "sp: steps missing")
    for r in reps:
        check(all(x == x and abs(x) != float("inf") for x in r["losses"]),
              f"sp rank {r['rank']}: non-finite loss")
        check(r["launches"]["fwd_shift"] > 0
              and r["launches"]["bwd_fused_shift"] > 0,
              f"sp rank {r['rank']}: shift-mode kernels not launched")
        check(r["split_launches"]["bwd_dq_shift"] > 0
              and r["split_launches"]["bwd_dkdv_shift"] > 0,
              f"sp rank {r['rank']}: split shift-mode kernels not launched")
        for n, e in r["attn_rel"].items():
            check(e <= (FWD_REL if n == "out" else BWD_REL),
                  f"sp rank {r['rank']}: ring attention's {n} disagrees "
                  f"with static flash_attention ({e:.3e})")
    check(loss_rel <= SP_LOSS_REL, "sp: step 1 loss disagrees with the "
          "one-process static-kernel run")
    check(norm_rel <= SP_GRAD_NORM_REL, "sp: step 1 gradient norm "
          "disagrees with the one-process static-kernel run")
    launches = {n: r0["launches"][n] + r1["launches"][n]
                for n in ("fwd_shift", "bwd_fused_shift")}
    for n in ("bwd_dq_shift", "bwd_dkdv_shift"):
        launches[n] = (r0["split_launches"][n] + r1["split_launches"][n])
    return {"launches": launches, "reports": reps, "static_ms": static_ms}


# ------------------------------------------------------------ phase 6


# The wire cell: Llama-2-7B widths cut to 1 layer; each group's gradients
# of WIRE_STEPS steps on 1 x WIRE_SEQ tokens, computed once and kept on the
# card, then reduced under each rung by a fresh Manager.
WIRE_LAYERS = 1
WIRE_SEQ = 2048
WIRE_STEPS = 2  # step 2 folds step 1's int8 residual
WIRE_RUNGS = ("f32", "bf16", "int8_device", "int8_host")
# Relative error of the whole reduced tree against the f32 rung's: bf16
# at twice its rounding bound (2^-8 per contribution; the H100 reads
# 3.2e-4); int8 + error feedback at 1.3x the H100's worst reading, 4.6e-2
# at steps 2-3 (3.2e-2 at step 1, before a residual folds in; PERF.md §2).
WIRE_REL = {"bf16": 4e-3, "int8_device": 6e-2, "int8_host": 6e-2}
# Ring bytes and device->host bytes against the f32 rung's, per step.
WIRE_RING_RATIO = {"bf16": (0.49, 0.51), "int8_device": (0.25, 0.26),
                   "int8_host": (0.25, 0.26)}
WIRE_D2H_RATIO = {"bf16": (0.49, 0.51), "int8_device": (0.25, 0.26),
                  "int8_host": (0.99, 1.01)}
# Bytes per gradient element each device pack must move at least: read
# f32 and write the wire dtype; the quantize-pack also reads and writes
# the f32 residual (its per-segment scales and zeros are 8 bytes a 65536).
WIRE_PACK_BYTES = {"pack_f32": 8, "pack_bf16": 6, "quantize_pack": 13}


def _wire_kwargs(rung: str) -> dict:
    from torchft_tpu_torch import policy

    int8 = policy.POLICIES["sync-int8"]
    return {"f32": {}, "bf16": {"allreduce_wire_dtype": torch.bfloat16},
            "int8_device": {"policy": int8, "device_quantize": True},
            "int8_host": {"policy": int8, "device_quantize": False}}[rung]


def _wire_grads(group: int) -> list:
    """WIRE_STEPS gradient trees of the wire cell's model, on the card."""
    from torchft_tpu_torch.models.transformer import (
        Transformer, chunked_causal_lm_loss, llama2_7b_config)
    from torchft_tpu_torch.ops import flash_attention as fa

    cfg = llama2_7b_config(num_layers=WIRE_LAYERS,
                           attention_fn=fa.flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer(cfg, device="cuda", generator=gen)
    grads = []
    for step in range(WIRE_STEPS):
        gen = torch.Generator().manual_seed(3000 + 100 * group + step)
        tokens = torch.randint(0, cfg.vocab_size, (1, WIRE_SEQ),
                               generator=gen).cuda()
        loss = chunked_causal_lm_loss(model(tokens, return_hidden=True),
                                      model.lm_head_kernel(), tokens)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        for p in model.parameters():
            p.grad = None
    torch.cuda.synchronize()
    return grads


def _tree_hash(tree: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(tree):
        t = tree[name].detach().contiguous()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(t.view(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _tree_rel(tree: dict, ref: dict) -> float:
    """||tree - ref|| / ||ref|| over every leaf at once."""
    num = sum(float(torch.linalg.vector_norm(tree[n].float() - ref[n]
                                             .float())) ** 2 for n in ref)
    den = sum(float(torch.linalg.vector_norm(ref[n].float())) ** 2
              for n in ref)
    return (num / den) ** 0.5


def _wire_pack_times(grads: dict) -> dict:
    """Device ms of each pack over the whole gradient tree, chunk by chunk
    as the allreduce packs it (the default bucket size), with its bound."""
    from torchft_tpu_torch import manager as tm
    from torchft_tpu_torch.communicator import BF16

    names = sorted(grads)
    leaves = [grads[n] for n in names]
    metas = tuple((tuple(x.shape), "float32") for x in leaves)
    sched = tm._derive_schedule(metas, 4 << 20)
    chunks = [[leaves[i] for i in c.idx] for cs in sched.chunks for c in cs]
    res = [torch.zeros(sum(x.numel() for x in ls), device="cuda")
           for ls in chunks]
    elems = sum(x.numel() for x in leaves)
    fns = {
        "pack_f32": lambda: [tm._pack_leaves(ls, np.dtype(np.float32))
                             for ls in chunks],
        "pack_bf16": lambda: [tm._pack_leaves(ls, BF16) for ls in chunks],
        "quantize_pack": lambda: [tm._device_quantize_pack(ls, r)
                                  for ls, r in zip(chunks, res)],
    }
    out = {}
    for name, fn in fns.items():
        bound = elems * WIRE_PACK_BYTES[name] / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": cuda_ms(fn, iters=3, warmup=1),
                     "bound_ms": bound, "chunks": len(chunks),
                     "elems": elems}
    return out


def _plain_mean_err(tree: dict, mine: dict, theirs_path: str) -> tuple:
    """``(elements that differ, largest difference)`` between ``tree`` and
    ``(mine + theirs) / 2``, the plain mean of both groups' gradients
    computed in torch on the card (the other group saved its gradients
    before its first allreduce, which this one has waited out). At world
    2 the f32 ring must give it exactly: a two-term sum does not depend
    on its order."""
    theirs = torch.load(theirs_path, map_location="cuda")
    check(sorted(theirs) == sorted(tree), "wire: the groups' gradient "
          "trees hold different leaves")
    bad, err = 0, 0.0
    for n, t in tree.items():
        want = (mine[n] + theirs[n]) / 2
        bad += int((t != want).sum())
        err = max(err, float((t - want).abs().max()))
    return bad, err


def wire_worker(group: int, lighthouse: str, report: str) -> int:
    """One replica group of the wire phase (run as ``chip_smoke.py
    --wire-worker``)."""
    if not torch.cuda.is_available():
        raise SmokeError("the wire worker needs a CUDA device")
    from torchft_tpu_torch.backends.host import HostCommunicator
    from torchft_tpu_torch.manager import Manager

    t0 = time.perf_counter()
    grads = _wire_grads(group)
    log(f"wire[{group}]: {WIRE_STEPS} gradient trees in "
        f"{time.perf_counter() - t0:.1f} s")
    # Step 1's gradients go to the phase's directory, where the other
    # group reads them for the plain mean the f32 rung must equal.
    workdir = os.path.dirname(report)
    mine = os.path.join(workdir, f"wire_grads_{group}.pt")
    torch.save(grads[0], mine + ".tmp")
    os.replace(mine + ".tmp", mine)
    out = {"group": group, "rungs": {},
           "grads_on_cuda": all(t.is_cuda for g in grads for t in g.values())}
    refs: list = []
    for rung in WIRE_RUNGS:
        m = Manager(comm=HostCommunicator(), load_state_dict=lambda s: None,
                    state_dict=dict, min_replica_size=2,
                    replica_id=f"wire_{group}_{rung}",
                    lighthouse_addr=lighthouse, rank=0, world_size=1,
                    **_wire_kwargs(rung))
        # Both groups start past step 1, where a non-primary would heal.
        m.load_state_dict({"step": 1, "batches_committed": 0})
        steps = []
        try:
            for s in range(WIRE_STEPS):
                m.step()
                torch.cuda.synchronize()
                before = m.metrics()
                t1 = time.perf_counter()
                tree = m.allreduce(grads[s]).result()
                wall_ms = (time.perf_counter() - t1) * 1e3
                committed = m.should_commit()
                mx = m.metrics()
                d = {k: mx[k] - before[k] for k in (
                    "allreduce_ms_total", "allreduce_fetch_dispatch_ms_total",
                    "allreduce_fetch_wait_ms_total",
                    "allreduce_ring_ms_total", "allreduce_put_ms_total",
                    "allreduce_ring_fold_ms_total",
                    "allreduce_ring_transfer_ms_total",
                    "allreduce_ring_wire_bytes_total",
                    "allreduce_d2h_wire_bytes_total")}
                row = {"wall_ms": wall_ms, "committed": committed,
                       "errored": repr(m.errored()),
                       "on_cuda": all(t.is_cuda for t in tree.values()),
                       "residual_bytes": mx["wire_quant_residual_bytes"],
                       "dev_residuals": len(m._dev_residuals),
                       "dev_residuals_cuda": all(
                           r.is_cuda for r in m._dev_residuals.values()),
                       "host_residuals": len(m._ef_residuals),
                       "hash": _tree_hash(tree), **d}
                if rung == "f32":
                    refs.append(tree)
                    if s == 0:
                        row["mean_diff"] = _plain_mean_err(
                            tree, grads[0], os.path.join(
                                workdir, f"wire_grads_{1 - group}.pt"))
                else:
                    row["rel_vs_f32"] = _tree_rel(tree, refs[s])
                del tree
                steps.append(row)
                log(f"wire[{group}] {rung} step {s + 1}: " + " ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items() if k != "hash")
                    + f" hash={row['hash'][:16]}")
        finally:
            m.shutdown()
        out["rungs"][rung] = steps
    out["pack_times"] = _wire_pack_times(grads[0])
    for name, t in out["pack_times"].items():
        log(f"wire[{group}] time[{name}] ms={t['ms']:.3f} "
            f"bound_ms={t['bound_ms']:.3f} chunks={t['chunks']}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    with open(report, "w") as f:
        json.dump(out, f)
    return 0


def phase_wire(procs: list) -> dict:
    """The manager's wire rungs (see the module docstring)."""
    from torchft_tpu_torch._native import Lighthouse

    workdir = tempfile.mkdtemp(prefix="chip_smoke_wire_")
    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=2,
                    join_timeout_ms=2000, quorum_tick_ms=50)
    t0 = time.perf_counter()
    workers = []
    try:
        for group in range(2):
            workers.append(_popen(
                [sys.executable, os.path.abspath(__file__), "--wire-worker",
                 str(group), "--wire-lighthouse", lh.address(),
                 "--wire-report", os.path.join(workdir, f"wire_{group}.json")],
                os.path.join(workdir, f"wire_group_{group}.log")))
        procs += workers
        for group, proc in enumerate(workers):
            _wait(proc, 900, f"wire group {group}")
        reps = []
        for group in range(2):
            with open(os.path.join(workdir, f"wire_{group}.json")) as f:
                reps.append(json.load(f))
    finally:
        lh.shutdown()
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name), OUT_DIR)
        # The saved gradient trees are 2.7 GB each.
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"wire: both groups done in {time.perf_counter() - t0:.1f} s")
    f32 = reps[0]["rungs"]["f32"]
    for rung in WIRE_RUNGS:
        for s, row in enumerate(reps[0]["rungs"][rung]):
            ring = row["allreduce_ring_wire_bytes_total"]
            d2h = row["allreduce_d2h_wire_bytes_total"]
            ring_f32 = f32[s]["allreduce_ring_wire_bytes_total"]
            d2h_f32 = f32[s]["allreduce_d2h_wire_bytes_total"]
            other = reps[1]["rungs"][rung][s]
            log(f"wire: {rung} step {s + 1} allreduce_ms="
                f"{row['allreduce_ms_total']:.1f} wall_ms={row['wall_ms']:.1f}"
                " fetch_dispatch_ms="
                f"{row['allreduce_fetch_dispatch_ms_total']:.1f}"
                f" fetch_wait_ms={row['allreduce_fetch_wait_ms_total']:.1f}"
                f" ring_bytes={ring:.0f} d2h_bytes={d2h:.0f} ring_ratio="
                f"{ring / ring_f32:.4f} d2h_ratio={d2h / d2h_f32:.4f}"
                f" ring_ms={row['allreduce_ring_ms_total']:.1f}"
                f" ring_fold_ms={row['allreduce_ring_fold_ms_total']:.1f}"
                f" ring_transfer_ms="
                f"{row['allreduce_ring_transfer_ms_total']:.1f}"
                f" put_ms={row['allreduce_put_ms_total']:.1f}"
                f" rel_vs_f32={row.get('rel_vs_f32', 0.0):.3e} "
                f"group1_allreduce_ms={other['allreduce_ms_total']:.1f}")
    for r in reps:
        log(f"wire: group {r['group']} peak_gb={r['peak_gb']:.1f} " + " ".join(
            f"{n}_ms={t['ms']:.3f}/bound {t['bound_ms']:.3f}"
            for n, t in r["pack_times"].items()))
    for r in reps:
        log(f"wire: group {r['group']} f32 step 1 against the plain mean "
            "of both groups' gradients: elements_differing=%d max_abs=%.3e"
            % tuple(r["rungs"]["f32"][0]["mean_diff"]))

    # Every reading is logged above; now the checks.
    for r in reps:
        check(r["grads_on_cuda"], f"wire group {r['group']}: gradients "
              "left the card")
        check(r["rungs"]["f32"][0]["mean_diff"][0] == 0,
              f"wire group {r['group']}: the f32 rung's step 1 differs from "
              "the plain mean of both groups' gradients")
        for rung in WIRE_RUNGS:
            rows = r["rungs"][rung]
            check(len(rows) == WIRE_STEPS, f"wire {rung}: steps missing")
            for s, row in enumerate(rows):
                where = f"wire group {r['group']} {rung} step {s + 1}"
                check(row["committed"] and row["errored"] == "None",
                      f"{where}: not committed ({row['errored']})")
                check(row["on_cuda"], f"{where}: reduced tree off the card")
                if rung == "int8_device":
                    check(row["dev_residuals"] > 0
                          and row["dev_residuals_cuda"]
                          and row["host_residuals"] == 0,
                          f"{where}: residual not held on the card")
                if rung == "int8_host":
                    check(row["host_residuals"] > 0
                          and row["dev_residuals"] == 0,
                          f"{where}: residual not held on the host")
    for rung in WIRE_RUNGS:
        for s in range(WIRE_STEPS):
            a, b = (r["rungs"][rung][s] for r in reps)
            check(a["hash"] == b["hash"], f"wire {rung} step {s + 1}: the "
                  "groups' reduced trees differ")
            if rung == "f32":
                continue
            lo, hi = WIRE_RING_RATIO[rung]
            ring = (a["allreduce_ring_wire_bytes_total"]
                    / f32[s]["allreduce_ring_wire_bytes_total"])
            check(lo <= ring <= hi, f"wire {rung} step {s + 1}: ring bytes "
                  f"{ring:.4f} of f32's, outside [{lo}, {hi}]")
            lo, hi = WIRE_D2H_RATIO[rung]
            d2h = (a["allreduce_d2h_wire_bytes_total"]
                   / f32[s]["allreduce_d2h_wire_bytes_total"])
            check(lo <= d2h <= hi, f"wire {rung} step {s + 1}: device->host "
                  f"bytes {d2h:.4f} of f32's, outside [{lo}, {hi}]")
            for r in reps:
                rel = r["rungs"][rung][s]["rel_vs_f32"]
                check(rel <= WIRE_REL[rung], f"wire {rung} step {s + 1}: "
                      f"relative error {rel:.3e} against f32 above "
                      f"{WIRE_REL[rung]}")
    for s in range(WIRE_STEPS):
        check(reps[0]["rungs"]["int8_device"][s]["hash"]
              == reps[0]["rungs"]["int8_host"][s]["hash"],
              f"wire step {s + 1}: int8 quantized on the card and on the "
              "host reduce to different trees")
    return {"reports": reps}


# ------------------------------------------------------------ phase 8


# The shard cell: the wire cell's model (Llama-2-7B widths, 1 layer) and
# batch (1 x 2048), AdamW at train_lm's hyperparameters with foreach pinned
# on both paths, SHARD_STEPS steps per path.
SHARD_STEPS = 2
# Stripe state against the full AdamW state: 1/2 at world 2, within the
# chunk rounding of one element per chunk and the step counters.
SHARD_STATE_RATIO = (0.49, 0.51)
# The device memory held between steps must fall by the full state less
# the stripe state, within this fraction of it.
SHARD_MEM_REL = 0.05


def _shard_tokens(vocab: int, group: int, step: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(5000 + 100 * group + step)
    return torch.randint(0, vocab, (1, WIRE_SEQ), generator=gen).cuda()


def _param_diff(got: dict, want: dict) -> tuple:
    """``(elements that differ, largest difference in float32 ulps)``."""
    bad, ulp = 0, 0
    for n, t in got.items():
        d = t != want[n]
        bad += int(d.sum())
        if d.any():
            a = t.detach().view(torch.int32).to(torch.int64)
            b = want[n].view(torch.int32).to(torch.int64)
            ulp = max(ulp, int((a - b).abs().max()))
    return bad, ulp


def shard_worker(group: int, lighthouse: str, report: str) -> int:
    """One replica group of the shard phase (run as ``chip_smoke.py
    --shard-worker``): SHARD_STEPS steps of ``FTTrainer`` with the sync
    update, then the same steps from the same init params with a fresh
    ``Manager(shard_update=True)``. The sharded run exchanges the
    gradients the sync run recorded at each step, after its own forward
    and backward, whose elements that differ from them are logged per
    parameter: the params check holds the sharded update to the sync
    update on the same gradients, as JAX's
    ``test_shard.py::test_bitwise_vs_sync_path`` feeds both fixed
    gradients, and the phase checks that the two runs' own gradients
    agree bitwise (the fused backward's fixed-order dq sum)."""
    if not torch.cuda.is_available():
        raise SmokeError("the shard worker needs a CUDA device")
    from torchft_tpu_torch.backends.host import HostCommunicator
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models.transformer import (
        Transformer, chunked_causal_lm_loss, llama2_7b_config)
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.step import FTTrainer

    cfg = llama2_7b_config(num_layers=WIRE_LAYERS,
                           attention_fn=fa.flash_attention, remat=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer(cfg, device="cuda", generator=gen)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    tokens = [_shard_tokens(cfg.vocab_size, group, s)
              for s in range(SHARD_STEPS)]
    param_bytes = sum(t.numel() * t.element_size() for t in init.values())

    def loss_fn(m, batch):
        return chunked_causal_lm_loss(m(batch, return_hidden=True),
                                      m.lm_head_kernel(), batch)

    def trainer_for(shard: bool) -> FTTrainer:
        tag = "shard" if shard else "sync"
        t = FTTrainer(
            model=model, loss_fn=loss_fn,
            optimizer=torch.optim.AdamW(model.parameters(), lr=3e-4,
                                        weight_decay=1e-4, eps=1e-8,
                                        foreach=True),
            manager_factory=lambda load, save: Manager(
                comm=HostCommunicator(), load_state_dict=load,
                state_dict=save, min_replica_size=2,
                replica_id=f"shard_{group}_{tag}",
                lighthouse_addr=lighthouse, rank=0, world_size=1,
                shard_update=shard))
        # Both groups start past step 1, where a non-primary would heal.
        t.manager.load_state_dict({"step": 1, "batches_committed": 0})
        return t

    out = {"group": group, "sync": [], "shard": []}
    snaps: list = []
    recorded: list = []
    for shard in (False, True):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        trainer = trainer_for(shard)
        own_fwd_bwd = trainer._fwd_bwd
        grad_diff: list = [{}]

        def fwd_bwd(batch, own=own_fwd_bwd, shard=shard):
            loss, grads = own(batch)
            if not shard:
                recorded.append({n: g.clone() for n, g in grads.items()})
                return loss, grads
            want = recorded[len(out["shard"])]
            diff = {n: int((g != want[n]).sum()) for n, g in grads.items()}
            grad_diff[0] = {n: c for n, c in diff.items() if c}
            return loss, want

        trainer._fwd_bwd = fwd_bwd
        fa.reset_launches()
        try:
            for s in range(SHARD_STEPS):
                before = trainer.manager.metrics()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, committed = trainer.train_step(tokens[s])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                mx = trainer.manager.metrics()
                held = param_bytes * (len(snaps) + len(recorded))
                row = {"step": s + 1, "wall_s": wall,
                       "loss": float(loss), "committed": committed,
                       "errored": repr(trainer.manager.errored()),
                       "steady_bytes": torch.cuda.memory_allocated() - held,
                       "timings": dict(trainer.last_step_timings)}
                for k in ("allreduce_ms_total", "allreduce_put_ms_total",
                          "allreduce_ring_ms_total", "update_ms_total",
                          "allreduce_fetch_ms_total"):
                    row[k] = mx[k] - before[k]
                params = {n: p.detach() for n, p in
                          trainer.params.items()}
                if shard:
                    row["grad_diff"] = grad_diff[0]
                    row["diff"] = _param_diff(params, snaps[s])
                    row["hash"] = _tree_hash(params)
                    row["shard_state_bytes"] = mx["shard_state_bytes"]
                    row["shard_state_resets"] = mx["shard_state_resets"]
                    row["update"] = dict(trainer._opt.last_update_timings)
                    row["foreach"] = trainer.optimizer.defaults["foreach"]
                else:
                    snaps.append({n: t.clone() for n, t in params.items()})
                    row["state_bytes"] = float(sum(
                        v.numel() * v.element_size()
                        for st in trainer.optimizer.state.values()
                        for v in st.values()))
                out["shard" if shard else "sync"].append(row)
                log(f"shard[{group}] {'shard' if shard else 'sync'} step "
                    f"{s + 1}: " + " ".join(
                        f"{k}={v:.4g}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in row.items()
                        if k not in ("hash", "timings")))
            out[f"launches_{'shard' if shard else 'sync'}"] = dict(
                fa.LAUNCHES)
            out[f"opt_state_{'shard' if shard else 'sync'}"] = len(
                trainer.optimizer.state)
        finally:
            trainer.shutdown()
        # The sync path's AdamW state goes before the sharded run.
        trainer.optimizer.state.clear()
        del trainer
        torch.cuda.empty_cache()
    out["param_bytes"] = param_bytes
    with open(report, "w") as f:
        json.dump(out, f)
    return 0


def phase_shard(procs: list) -> dict:
    """The sharded update (see the module docstring)."""
    from torchft_tpu_torch._native import Lighthouse

    workdir = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=2,
                    join_timeout_ms=2000, quorum_tick_ms=50)
    t0 = time.perf_counter()
    workers = []
    try:
        for group in range(2):
            workers.append(_popen(
                [sys.executable, os.path.abspath(__file__), "--shard-worker",
                 str(group), "--shard-lighthouse", lh.address(),
                 "--shard-report",
                 os.path.join(workdir, f"shard_{group}.json")],
                os.path.join(workdir, f"shard_group_{group}.log")))
        procs += workers
        for group, proc in enumerate(workers):
            _wait(proc, 900, f"shard group {group}")
        reps = []
        for group in range(2):
            with open(os.path.join(workdir, f"shard_{group}.json")) as f:
                reps.append(json.load(f))
    finally:
        lh.shutdown()
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name), OUT_DIR)
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"shard: both groups done in {time.perf_counter() - t0:.1f} s")
    for r in reps:
        for b in r["shard"]:
            log(f"shard: group {r['group']} step {b['step']}: the sharded "
                f"run's own gradients against the sync run's, differing "
                f"elements {sum(b['grad_diff'].values())}, per parameter "
                f"{b['grad_diff'] or 'none'}")
    for r in reps:
        for b in r["shard"]:
            # Two backward passes on the same params and batch are
            # bitwise equal (the fused backward's fixed-order dq sum).
            check(not b["grad_diff"],
                  f"shard group {r['group']} step {b['step']}: the sharded "
                  f"run's own gradients differ from the sync run's "
                  f"({b['grad_diff']})")
    for r in reps:
        for a, b in zip(r["sync"], r["shard"]):
            log(f"shard: group {r['group']} step {a['step']} "
                f"sync put_ms={a['allreduce_put_ms_total']:.1f} "
                f"allreduce_ms={a['allreduce_ms_total']:.1f} "
                f"wall_s={a['wall_s']:.3f} | shard put_ms="
                f"{b['allreduce_put_ms_total']:.1f} reduce_scatter_ms="
                f"{b['allreduce_ms_total']:.1f} update_ms="
                f"{b['update_ms_total']:.1f} (stripe update "
                f"{b['update']['update'] * 1e3:.1f} allgather "
                f"{b['update']['allgather'] * 1e3:.1f} assemble "
                f"{b['update']['assemble'] * 1e3:.1f}) wall_s="
                f"{b['wall_s']:.3f} | steady GB sync "
                f"{a['steady_bytes'] / 1e9:.3f} shard "
                f"{b['steady_bytes'] / 1e9:.3f} | differing elements "
                f"{b['diff'][0]} worst ulp {b['diff'][1]}")
    for r in reps:
        where = f"shard group {r['group']}"
        check(r["opt_state_shard"] == 0,
              f"{where}: the sharded run materialized full AdamW state")
        for name in ("launches_sync", "launches_shard"):
            check(r[name]["fwd"] > 0 and r[name]["bwd_fused"] > 0,
                  f"{where}: flash kernels not launched ({name})")
        for a, b in zip(r["sync"], r["shard"]):
            step = f"{where} step {b['step']}"
            for row in (a, b):
                check(row["committed"] and row["errored"] == "None",
                      f"{step}: not committed ({row['errored']})")
            check(b["diff"][0] == 0,
                  f"{step}: sharded params differ from the sync path's in "
                  f"{b['diff'][0]} elements, worst {b['diff'][1]} ulp "
                  f"(AdamW foreach={b['foreach']})")
            ratio = b["shard_state_bytes"] / a["state_bytes"]
            lo, hi = SHARD_STATE_RATIO
            check(lo <= ratio <= hi, f"{step}: stripe state {ratio:.4f} of "
                  f"the full AdamW state, outside [{lo}, {hi}]")
            want = a["state_bytes"] - b["shard_state_bytes"]
            drop = a["steady_bytes"] - b["steady_bytes"]
            check(abs(drop - want) <= SHARD_MEM_REL * want,
                  f"{step}: device memory between steps fell by "
                  f"{drop / 1e9:.3f} GB, expected {want / 1e9:.3f} GB")
    for s in range(SHARD_STEPS):
        check(reps[0]["shard"][s]["hash"] == reps[1]["shard"][s]["hash"],
              f"shard step {s + 1}: the groups' params differ")
    launches = {n: 0 for n in KERNELS}
    for r in reps:
        for n in ("fwd", "bwd_fused"):
            launches[n] += r["launches_shard"][n]
    return {"launches": launches, "reports": reps}


# ------------------------------------------------------------ capacity

# The capacity cell: the ft cell's model in three chip_smoke.py
# --capacity-worker groups, each an FTTrainer with an ElasticLoader.
# Both runs' groups start from one init seed at step 1 (the first step
# is step 2), so no initial weight sync heals them; run A's restarted
# group starts fresh and heals.
# Run A (warm spares): min_replica_size 2 under FIXED_WITH_SPARES and a
# lighthouse with two members per quorum, batch 1 x CAPACITY_SEQ, to step
# CAPACITY_STEPS_A; after step CAPACITY_HOLD_A the group at participant
# rank 0 holds, is SIGKILLed and restarts with another seed.
# Run B (degraded capacity, rebalance, elastic draws): degraded_mode and
# rebalance, three members per quorum, batch CAPACITY_BATCH x
# CAPACITY_SEQ, to step CAPACITY_STEPS_B; group 1 degrades to
# CAPACITY_FRACTION at the step-CAPACITY_DEGRADE_AT boundary and restores
# at the step-CAPACITY_RESTORE_AT one; group 2 runs the chaos slow band
# at one boundary, step CAPACITY_SLOW_FROM's (it doubles a step the whole
# ring waits for); at step CAPACITY_FOLD_STEP every group
# saves its float32 contribution and weight (and group 0 its reduced
# tree) for the float64 check of the weighted fold.
CAPACITY_LAYERS = 1
CAPACITY_SEQ = WIRE_SEQ
CAPACITY_STEPS_A = 6
CAPACITY_HOLD_A = 2
# Run A's survivors wait after this step until the restarted group is up,
# so that it joins and heals before they finish.
CAPACITY_GATE_A = 4
CAPACITY_STEPS_B = 6
# Init seeds: run A's groups, its restarted group, run B's groups.
CAPACITY_SEED_A, CAPACITY_SEED_RESTART, CAPACITY_SEED_B = 0, 7, 10
CAPACITY_BATCH = 8
CAPACITY_FRACTION = 0.5
CAPACITY_DEGRADE_AT = 2
CAPACITY_RESTORE_AT = 5
CAPACITY_SLOW_FROM = 3
CAPACITY_SLOW = "seed=3;slow:slow_rate=1.0,slow_factor=2.0,max_faults=1"
CAPACITY_FOLD_STEP = 3
# The reduced tree against sum(w g) / sum(w) in float64, max abs error
# over max abs reference: a float32 fold of three weighted terms.
CAPACITY_FOLD_REL = 1e-6
# Three contributions and one reduced tree of 2.67 GB each.
CAPACITY_DISK_BYTES = 12e9
# Windows of CAPACITY_SEQ tokens in the phase's token file, and the
# model's vocabulary.
CAPACITY_WINDOWS = 512
CAPACITY_VOCAB = 32_000


def _capacity_draws(batch: int, frac: float) -> int:
    """``ElasticSampler``'s draw size at ``frac`` (no epoch edge)."""
    if abs(frac - 1.0) <= 1e-9:
        return batch
    return max(1, int(round(batch * frac)))


def _write_json(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class _RecordingStore:
    """The Manager's quorum-store client, recording each value it reads
    under ``key`` (the table the rebalance adoption read)."""

    def __init__(self, inner: object, key: str) -> None:
        self.inner, self.key, self.reads = inner, key, []

    def get(self, key: str, *args, **kw):
        value = self.inner.get(key, *args, **kw)
        if key == self.key:
            self.reads.append(value.decode())
        return value

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


def capacity_worker(group: int, run: str, seed: int, lighthouse: str,
                    workdir: str, report: str, hold: int, gate: int,
                    preset: bool) -> int:
    """One replica group of the capacity phase (run as ``chip_smoke.py
    --capacity-worker``): an ``FTTrainer`` over the ft cell's model with
    this run's ``Manager`` arguments and an ``ElasticLoader`` passed as
    the batch, so each step's draw follows the quorum. Writes one row per
    step to ``report``: the draw (samples, slot, fractions, fold weight,
    participation), the vote, the wall, the heal count, the state digest
    pushed at the boundary and, in run B, the rebalance table read from
    the quorum store, the capacity advertisement and the lighthouse's
    view. With ``preset``, the group starts at step 1 (its first step
    is step 2, which no initial sync heals); with ``hold``, the group at
    participant rank 0 after that step waits to be killed; with ``gate``,
    the group waits after that step until the phase creates
    ``<workdir>/gate``. The final state hash is the attestation digest
    of the trainer's state, computed on the card."""
    if not torch.cuda.is_available():
        raise SmokeError("the capacity worker needs a CUDA device")
    from concurrent.futures import Future

    from torchft_tpu_torch import WorldSizeMode
    from torchft_tpu_torch import chaos, serialization
    from torchft_tpu_torch.backends.host import HostCommunicator
    from torchft_tpu_torch.data import (ElasticLoader, ElasticSampler,
                                        TokenFileDataset)
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models.transformer import (
        Transformer, chunked_causal_lm_loss, llama2_7b_config)
    from torchft_tpu_torch.ops import attest
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel.step import FTTrainer
    from torchft_tpu_torch.utils import tree_flatten

    a = run == "a"
    total = CAPACITY_STEPS_A if a else CAPACITY_STEPS_B
    batch = 1 if a else CAPACITY_BATCH
    cfg = llama2_7b_config(num_layers=CAPACITY_LAYERS,
                           attention_fn=fa.flash_attention, remat=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Transformer(cfg, device="cuda", generator=gen)
    mode = (dict(world_size_mode=WorldSizeMode.FIXED_WITH_SPARES) if a
            else dict(degraded_mode=True, rebalance=True))

    def loss_fn(m, b):
        tokens = b["tokens"]
        return chunked_causal_lm_loss(m(tokens, return_hidden=True),
                                      m.lm_head_kernel(), tokens)

    trainer = FTTrainer(
        model=model, loss_fn=loss_fn,
        optimizer=torch.optim.AdamW(model.parameters(), lr=3e-4,
                                    weight_decay=1e-4, eps=1e-8),
        manager_factory=lambda load, save: Manager(
            comm=HostCommunicator(), load_state_dict=load,
            state_dict=save, min_replica_size=2,
            replica_id=f"capacity_{run}_{group}",
            lighthouse_addr=lighthouse, rank=0, world_size=1, **mode))
    m = trainer.manager
    if preset:
        m.load_state_dict({"step": 1, "batches_committed": 0})
    dataset = TokenFileDataset(os.path.join(workdir, "tokens.npy"),
                               seq_len=CAPACITY_SEQ)
    loader = ElasticLoader(dataset, ElasticSampler(
        len(dataset), m, batch_size=batch, seed=0), prefetch=2,
        device="cuda")
    cur: dict = {}
    recorder: list = []

    def draw():
        b = loader()
        rank, committed, frac = m.participant_slot()
        if not a and not recorder and m._healset_store is not None:
            # The quorum round has run: its store client exists.
            addr, inner = m._healset_store
            recorder.append(_RecordingStore(inner, "torchft/rebalance"))
            m._healset_store = (addr, recorder[0])
        cur.update(samples=int(b["tokens"].shape[0]),
                   slot=committed + (rank or 0), frac=frac,
                   capacity=m.capacity_fraction(),
                   rebalance=m.rebalance_fraction(),
                   weight=m._wire_weight(),
                   participating=m.is_participating(),
                   participants=m.num_participants())
        return b

    own_exchange = trainer._exchange

    def exchange(grads):
        if a or m.current_step() != CAPACITY_FOLD_STEP:
            return own_exchange(grads)
        torch.save({"weight": cur["weight"],
                    "grads": {n: g.detach().float().cpu()
                              for n, g in grads.items()}},
                   os.path.join(workdir, f"contrib_{group}.pt"))
        res = own_exchange(grads).result()
        cur["fold_hash"] = _tree_hash(res)
        if group == 0:
            torch.save({n: t.detach().cpu() for n, t in res.items()},
                       os.path.join(workdir, "reduced.pt"))
        done: Future = Future()
        done.set_result(res)
        return done

    trainer._exchange = exchange
    out = {"group": group, "run": run, "seed": seed,
           "replica_id": m.replica_id(), "steps": []}
    fa.reset_launches()
    attest.reset_launches()
    _write_json(report, out)  # up: the phase may open the gate
    committed = False
    slow = False
    try:
        while m.current_step() < total:
            step = m.current_step()
            if not a and group == 1 and committed:
                if step >= CAPACITY_DEGRADE_AT and "degraded_at" not in out \
                        and m.request_degrade(CAPACITY_FRACTION):
                    out["degraded_at"] = step
                elif step >= CAPACITY_RESTORE_AT and "degraded_at" in out \
                        and "restored_at" not in out \
                        and m.request_restore():
                    out["restored_at"] = step
            if not a and group == 2 and not slow \
                    and step >= CAPACITY_SLOW_FROM - 1:
                chaos.install(chaos.parse_spec(CAPACITY_SLOW))
                slow = True
            cur.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, committed = trainer.train_step(draw)
            torch.cuda.synchronize()
            mx = m.metrics()
            row = {"step": m.current_step(), "loss": float(loss),
                   "committed": committed,
                   "wall_s": time.perf_counter() - t0, **cur,
                   "heal_count": mx["heal_count"],
                   "digest": m._last_state_digest,
                   "timings": dict(trainer.last_step_timings),
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            if not a:
                store = m._store_client((m._policy_round or ("",))[0])

                def read(key: str) -> str:
                    try:
                        return store.get(key, timeout_ms=2000).decode()
                    except Exception as e:  # noqa: BLE001 — logged, checked
                        return f"unread: {e!r}"

                row.update(rebalance_after=m.rebalance_fraction(),
                           adoptions=mx["rebalance_adoptions_total"],
                           deferred=mx["rebalance_deferred_total"],
                           table_read=(recorder[0].reads[-1]
                                       if recorder and recorder[0].reads
                                       else ""))
                if group == 1:
                    row["capacity_key"] = read(
                        f"torchft/capacity/{m._last_round_facts[1]}")
                if group == 0:
                    st = _fleet_status(lighthouse)
                    row["fleet_table"] = st["fleet"]["rebalance_table"]
                    row["fleet_walls"] = {
                        g["replica_id"]: [g["step"], g["step_wall_ms"],
                                          g["rebalance_fraction"],
                                          g["straggler_score"]]
                        for g in st["groups"]}
            out["steps"].append(row)
            log(f"capacity[{run}{group}] " + json.dumps(
                {k: v for k, v in row.items() if k != "fleet_walls"}))
            _write_json(report, out)
            if hold and m.current_step() == hold and committed \
                    and m.participant_rank() == 0:
                out["held"] = True
                _write_json(report, out)
                log(f"capacity[{run}{group}] holding after step {hold}")
                while True:
                    time.sleep(1)
            if gate and m.current_step() == gate and committed:
                while not os.path.exists(os.path.join(workdir, "gate")):
                    time.sleep(0.05)
        mx = m.metrics()
        out["launches"] = {**fa.LAUNCHES, **attest.LAUNCHES}
        leaves = [t for t in tree_flatten(trainer.state_dict())[0]
                  if isinstance(t, torch.Tensor) and t.numel()]
        out.update(
            state_hash=serialization.attest_combine(
                attest.attest_words(leaves)),
            metrics={k: mx[k] for k in (
                "heal_count", "committed_steps", "aborted_steps",
                "degrade_events_total", "restore_events_total",
                "rebalance_adoptions_total", "rebalance_deferred_total")},
            events=[{"event": e["event"], "step": e["step"]}
                    for e in m.history()],
            prefetch={"hits": loader.prefetch_hits,
                      "misses": loader.prefetch_misses},
            params_on_cpu=sum(p.device.type == "cpu"
                              for p in trainer.params.values()))
        _write_json(report, out)
    finally:
        chaos.reset()
        loader.shutdown()
        trainer.shutdown()
    return 0


def _spawn_capacity(group: int, run: str, seed: int, lighthouse: str,
                    workdir: str, hold: int = 0, gate: int = 0,
                    preset: bool = True) -> subprocess.Popen:
    return _popen(
        [sys.executable, os.path.abspath(__file__), "--capacity-worker",
         str(group), "--capacity-run", run, "--capacity-seed", str(seed),
         "--capacity-lighthouse", lighthouse, "--capacity-dir", workdir,
         "--capacity-hold", str(hold), "--capacity-gate", str(gate),
         *(["--capacity-preset"] if preset else [])],
        os.path.join(workdir, f"capacity_{run}_{group}_{seed}.log"))


def _capacity_report(workdir: str, run: str, group: int, seed: int
                     ) -> dict:
    path = os.path.join(workdir, f"capacity_{run}_{group}_{seed}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        try:
            return json.load(f)
        except json.JSONDecodeError:
            return {}


def _row(rep: dict, step: int) -> dict:
    """The last row of ``rep`` at ``step`` (an aborted step is retried
    under the same number)."""
    return [s for s in rep["steps"] if s["step"] == step][-1]


def _wait_capacity(proc: subprocess.Popen, workdir: str, run: str,
                   group: int, seed: int) -> None:
    """Until the worker has written its first report (it is up)."""
    deadline = time.time() + 600
    while not _capacity_report(workdir, run, group, seed):
        check(proc.poll() is None and time.time() < deadline,
              f"capacity {run}: worker {group} (seed {seed}) never came up")
        time.sleep(0.05)


def _capacity_finite(reps: list, tag: str) -> None:
    for r in reps:
        check(all(x == x and abs(x) != float("inf")
                  for x in (s["loss"] for s in r["steps"])),
              f"{tag}: group {r['group']}: non-finite loss")
        check(r["params_on_cpu"] == 0,
              f"{tag}: group {r['group']}: parameters left on the CPU")


def _capacity_digests_equal(reps: list, tag: str) -> None:
    """At every step, every group that pushed a digest pushed the same
    one: the state (params and AdamW state) fingerprinted on the card."""
    by_step: dict = {}
    for r in reps:
        for s in r["steps"]:
            if s["committed"] and s["digest"]:
                by_step.setdefault(s["step"], set()).add(s["digest"])
    for step, digests in sorted(by_step.items()):
        check(len(digests) == 1,
              f"{tag}: step {step}: groups' state digests differ "
              f"({sorted(digests)})")


def _capacity_run_a(procs: list, workdir: str) -> list:
    from torchft_tpu_torch._native import Lighthouse

    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=2,
                    join_timeout_ms=2000, quorum_tick_ms=50)
    addr = lh.address()
    try:
        t0 = time.perf_counter()
        ws = {g: _spawn_capacity(g, "a", CAPACITY_SEED_A, addr, workdir,
                                 hold=CAPACITY_HOLD_A, gate=CAPACITY_GATE_A)
              for g in range(3)}
        procs += list(ws.values())
        deadline = time.time() + 600
        held = None
        while held is None:
            check(time.time() < deadline, "capacity A: no group held")
            for g, p in ws.items():
                check(p.poll() is None,
                      f"capacity A: group {g} exited before the hold")
                if _capacity_report(workdir, "a", g,
                                    CAPACITY_SEED_A).get("held"):
                    held = g
            time.sleep(0.05)
        os.killpg(ws[held].pid, signal.SIGKILL)
        ws[held].wait()
        log(f"capacity A: SIGKILLed group {held} (participant rank 0) "
            f"after step {CAPACITY_HOLD_A} ({time.perf_counter() - t0:.1f}"
            " s)")
        restarted = _spawn_capacity(held, "a", CAPACITY_SEED_RESTART,
                                    addr, workdir, preset=False)
        procs.append(restarted)
        # The survivors wait after step CAPACITY_GATE_A until the
        # restarted group is up, so it joins and heals before they end.
        _wait_capacity(restarted, workdir, "a", held, CAPACITY_SEED_RESTART)
        open(os.path.join(workdir, "gate"), "w").close()
        for g, p in ws.items():
            if g != held:
                _wait(p, 900, f"capacity A group {g}")
        _wait(restarted, 900, f"capacity A restarted group {held}")
        log(f"capacity A: {time.perf_counter() - t0:.1f} s")
    finally:
        lh.shutdown()
    live = [_capacity_report(workdir, "a", g, CAPACITY_SEED_A)
            for g in range(3) if g != held]
    killed = _capacity_report(workdir, "a", held, CAPACITY_SEED_A)
    back = _capacity_report(workdir, "a", held, CAPACITY_SEED_RESTART)
    for r in (*live, killed, back):
        log(f"capacity A: group {r['group']} (seed {r['seed']}) walls "
            f"{[round(s['wall_s'], 2) for s in r['steps']]} participating "
            f"{[(s['step'], s['participating']) for s in r['steps']]} "
            f"heal_count {r['steps'][-1]['heal_count'] if r['steps'] else 0}"
            f" peak_GB {max(s['peak_bytes'] for s in r['steps']) / 1e9:.2f}"
            f" hash {r.get('state_hash', '')[:16]}")
    # Steps every live process took part in: (group, seed) -> row.
    rows: dict = {}
    for r in (*live, killed, back):
        for s in r["steps"]:
            rows.setdefault(s["step"], {})[(r["group"], r["seed"])] = s
    spare = [r["group"] for r in live
             if not _row(r, CAPACITY_HOLD_A)["participating"]]
    check(len(spare) == 1
          and _row(killed, CAPACITY_HOLD_A)["participating"],
          f"capacity A: the spare at step {CAPACITY_HOLD_A} is not one "
          f"live group ({spare})")
    for step, by in sorted(rows.items()):
        for who, s in by.items():
            check(not s["committed"] or s["participants"] == 2,
                  f"capacity A: step {step}: group {who} counted "
                  f"{s['participants']} participants")
        if len(by) == 3:
            out = [who for who, s in by.items() if not s["participating"]]
            check(len(out) == 1, f"capacity A: step {step}: {len(out)} "
                  "groups of three sat out, expected exactly one")
    promoted = next(r for r in live if r["group"] == spare[0])
    nxt = _row(promoted, CAPACITY_HOLD_A + 1)
    before = _row(promoted, CAPACITY_HOLD_A)
    check(nxt["participating"] and nxt["committed"]
          and nxt["heal_count"] == before["heal_count"],
          f"capacity A: the spare (group {spare[0]}) was not promoted "
          f"without a heal at step {nxt['step']}: {nxt}")
    check(back["metrics"]["heal_count"] >= 1,
          "capacity A: the restarted group never healed")
    reps = [*live, back]
    _capacity_digests_equal([*reps, killed], "capacity A")
    check(len({r["state_hash"] for r in reps}) == 1,
          "capacity A: groups ended with different state")
    _capacity_finite(reps, "capacity A")
    walls = {r["group"]: [round(s["wall_s"], 3) for s in r["steps"]]
             for r in live}
    log(f"capacity A: promotion at step {nxt['step']}: walls around it "
        f"{walls}")
    return reps


def _capacity_fold_check(workdir: str, reps: list) -> None:
    """The step-CAPACITY_FOLD_STEP reduced tree, bitwise across groups,
    against sum(w g) / sum(w) in float64 on the card."""
    hashes = {r["group"]: next(s["fold_hash"] for s in r["steps"]
                               if s["step"] == CAPACITY_FOLD_STEP)
              for r in reps}
    check(len(set(hashes.values())) == 1,
          f"capacity B: step {CAPACITY_FOLD_STEP}'s reduced trees differ "
          f"across groups ({hashes})")
    contribs = [torch.load(os.path.join(workdir, f"contrib_{g}.pt"),
                           mmap=True) for g in range(3)]
    reduced = torch.load(os.path.join(workdir, "reduced.pt"), mmap=True)
    weights = [c["weight"] for c in contribs]
    check(all(w > 0 for w in weights),
          f"capacity B: a zero fold weight at step {CAPACITY_FOLD_STEP}: "
          f"{weights}")
    err = ref_max = 0.0
    for n, got in reduced.items():
        acc = torch.zeros(got.shape, dtype=torch.float64, device="cuda")
        for w, c in zip(weights, contribs):
            acc += float(w) * c["grads"][n].to("cuda", torch.float64)
        acc /= float(sum(weights))
        err = max(err, float((got.to("cuda", torch.float64) - acc)
                             .abs().max()))
        ref_max = max(ref_max, float(acc.abs().max()))
        del acc
    rel = err / max(ref_max, 1e-30)
    log(f"capacity B: step {CAPACITY_FOLD_STEP} fold weights {weights}, "
        f"reduced tree against the float64 weighted mean: max abs "
        f"{err:.3e}, rel {rel:.3e} (limit {CAPACITY_FOLD_REL})")
    check(rel <= CAPACITY_FOLD_REL,
          f"capacity B: weighted fold off the float64 mean by {rel:.3e}")


def _capacity_run_b(procs: list, workdir: str) -> list:
    from torchft_tpu_torch import fleet
    from torchft_tpu_torch._native import Lighthouse

    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=3,
                    join_timeout_ms=2000, quorum_tick_ms=50)
    try:
        t0 = time.perf_counter()
        ws = [_spawn_capacity(g, "b", CAPACITY_SEED_B, lh.address(), workdir)
              for g in range(3)]
        procs += ws
        for g, p in enumerate(ws):
            _wait(p, 900, f"capacity B group {g}")
        log(f"capacity B: {time.perf_counter() - t0:.1f} s")
    finally:
        lh.shutdown()
    reps = [_capacity_report(workdir, "b", g, CAPACITY_SEED_B)
            for g in range(3)]
    for r in reps:
        log(f"capacity B: group {r['group']} walls "
            f"{[round(s['wall_s'], 2) for s in r['steps']]} samples "
            f"{[s['samples'] for s in r['steps']]} weights "
            f"{[s['weight'] for s in r['steps']]} capacity "
            f"{[s['capacity'] for s in r['steps']]} rebalance "
            f"{[s['rebalance_after'] for s in r['steps']]} peak_GB "
            f"{max(s['peak_bytes'] for s in r['steps']) / 1e9:.2f} "
            f"metrics {r['metrics']} prefetch {r['prefetch']}")
    for s in reps[0]["steps"]:
        log(f"capacity B: step {s['step']} lighthouse table "
            f"{s['fleet_table']!r} digest walls {s['fleet_walls']}")
    for r in reps:
        rid = r["replica_id"]
        for s in r["steps"]:
            where = f"capacity B: group {r['group']} step {s['step']}"
            want = _capacity_draws(CAPACITY_BATCH, s["frac"])
            check(s["samples"] == want, f"{where}: drew {s['samples']}, "
                  f"expected {want} at fraction {s['frac']}")
            check(abs(s["frac"] - s["capacity"] * s["rebalance"]) < 1e-12,
                  f"{where}: slot fraction {s['frac']} is not capacity x "
                  "rebalance")
            check(s["weight"] == (s["samples"] if s["participating"]
                                  else 0),
                  f"{where}: fold weight {s['weight']} for a draw of "
                  f"{s['samples']}")
            # The vote is not a barrier across groups: a follower may read
            # the decider's publication of the boundary before (the JAX
            # design's one-boundary adoption skew), never an older one.
            check(bool(s["table_read"]), f"{where}: no table read")
            seq, _, table = s["table_read"].partition(":")
            check(s["step"] - 1 <= int(seq) <= s["step"],
                  f"{where}: adopted from the table of boundary {seq}")
            target = min(fleet.REBALANCE_CEIL, max(
                fleet.REBALANCE_FLOOR,
                fleet.parse_rebalance_table(table).get(rid, 1.0)))
            i = r["steps"].index(s)
            deferred = s["deferred"] > (r["steps"][i - 1]["deferred"]
                                        if i else 0)
            check(deferred or abs(s["rebalance_after"] - target) < 1e-9,
                  f"{where}: adopted {s['rebalance_after']}, the published "
                  f"table {table!r} says {target}")
    g1 = reps[1]
    lo, hi = g1.get("degraded_at"), g1.get("restored_at")
    check(lo == CAPACITY_DEGRADE_AT and hi == CAPACITY_RESTORE_AT,
          f"capacity B: group 1 degraded at {lo}, restored at {hi}")
    for s in g1["steps"]:
        want = CAPACITY_FRACTION if lo < s["step"] <= hi else 1.0
        check(s["capacity"] == want, f"capacity B: group 1 step "
              f"{s['step']} drew at capacity {s['capacity']}, not {want}")
        if lo < s["step"] <= hi and s["rebalance"] == 1.0:
            check(s["samples"] == int(CAPACITY_BATCH * CAPACITY_FRACTION),
                  f"capacity B: group 1 step {s['step']} drew "
                  f"{s['samples']}")
        if lo < s["step"] <= hi:
            check(s["capacity_key"] == f"{s['step']}:{CAPACITY_FRACTION}",
                  f"capacity B: group 1's capacity advertisement at step "
                  f"{s['step']}: {s['capacity_key']!r}")
    check(g1["metrics"]["degrade_events_total"] == 1
          and g1["metrics"]["restore_events_total"] == 1,
          f"capacity B: group 1 counters {g1['metrics']}")
    _capacity_fold_check(workdir, reps)
    _capacity_digests_equal(reps, "capacity B")
    check(len({r["state_hash"] for r in reps}) == 1,
          "capacity B: groups ended with different state")
    _capacity_finite(reps, "capacity B")
    shrunk = any(s["rebalance_after"] < 1.0 for s in reps[2]["steps"])
    log(f"capacity B: the rebalance ladder "
        f"{'shrank' if shrunk else 'never shrank'} the slow group 2 "
        f"(tables read {sorted({s['table_read'].partition(':')[2] for r in reps for s in r['steps']})})")
    return reps


def phase_capacity(procs: list) -> dict:
    """The participation plane (see CAPACITY_* above and the module
    docstring)."""
    from torchft_tpu_torch.data import TokenFileDataset

    workdir = tempfile.mkdtemp(prefix="chip_smoke_capacity_")
    try:
        free = shutil.disk_usage(workdir).free
        log(f"capacity: {free / 1e9:.1f} GB free under {workdir}")
        check(free >= CAPACITY_DISK_BYTES,
              f"capacity: {free / 1e9:.1f} GB free under {workdir}, the "
              f"phase needs {CAPACITY_DISK_BYTES / 1e9:.0f} GB")
        TokenFileDataset.write(
            os.path.join(workdir, "tokens.npy"),
            np.random.default_rng(0).integers(
                0, CAPACITY_VOCAB, size=CAPACITY_WINDOWS * CAPACITY_SEQ)
            .astype(np.uint16))
        reps = _capacity_run_a(procs, workdir) \
            + _capacity_run_b(procs, workdir)
    finally:
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name), OUT_DIR)
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {n: sum(r["launches"].get(n, 0) for r in reps)
                for n in KERNELS}
    check(all(launches[n] > 0 for n in ("fwd", "bwd_fused",
                                         "attest_words")),
          f"capacity: kernels not launched ({launches})")
    return {"launches": launches, "reports": reps}


# ------------------------------------------------------------ diloco

# The diloco cell: the ft cell's model (Llama-2-7B widths at 1 layer, 1 x
# WIRE_SEQ tokens, bf16 activations) in two chip_smoke.py --diloco-worker
# groups, the inner optimizer the ft cell's AdamW, the outer one Nesterov
# SGD (lr 0.7, momentum 0.9), an outer round every DILOCO_SYNC_EVERY inner
# steps. Both groups start from one init seed at step 1, so no initial
# sync heals them. Run P (DiLoCoTrainer): DILOCO_ROUNDS_P outer rounds;
# group 1 holds after round DILOCO_KILL_AFTER commits, is SIGKILLed and
# restarts fresh (another seed, step 0), so it heals the whole DiLoCo
# state (params, anchor, AdamW moments, outer momentum) at its first
# round. Run S (StreamingDiLoCoTrainer, DILOCO_FRAGMENTS fragments):
# DILOCO_ROUNDS_S fragment rounds, then a flush.
DILOCO_SYNC_EVERY = 4
DILOCO_ROUNDS_P = 3
DILOCO_KILL_AFTER = 1
DILOCO_FRAGMENTS = 2
DILOCO_ROUNDS_S = 4
DILOCO_LR, DILOCO_MOMENTUM = 0.7, 0.9
# The round-1 anchor against its plain Nesterov recomputation, and the
# streaming merge against its plain recomputation: max abs over max abs.
DILOCO_REL = 1e-6
# Ring bytes of one f32 pseudo-gradient at world 2, against its bytes:
# each rank sends half the tree in the reduce-scatter and half in the
# allgather, plus the ring's own headers.
DILOCO_RING_RATIO = (1.0, 1.01)


def _diloco_tokens(vocab: int, group: int, step: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(7000 + 100 * group + step)
    return torch.randint(0, vocab, (1, WIRE_SEQ), generator=gen).cuda()


def _diloco_report(workdir: str, run: str, group: int, seed: int) -> str:
    return os.path.join(workdir, f"diloco_{run}_{group}_{seed}.json")


def _foreach_times(params: list, anchor: list, avg: list) -> dict:
    """Device ms of the trainer's torch ops over the whole tree, each with
    its bound (bytes: every input read once, every output written once):
    the pseudo-gradient (``_foreach_sub``: 2 reads, 1 write), the outer
    Nesterov step (``torch.optim.SGD``, foreach: params, gradients and
    momentum read, params and momentum written) and the copy of the
    anchor into the params (1 read, 1 write). The step runs on copies."""
    from torchft_tpu_torch.local_sgd import diloco_outer_optimizer

    nbytes = sum(t.numel() * t.element_size() for t in params)
    scratch = [a.clone() for a in anchor]
    grads = [g.clone() for g in avg]
    opt = diloco_outer_optimizer(scratch)

    def outer():
        for a, g in zip(scratch, grads):
            a.grad = g
        opt.step()

    dst = [p.clone() for p in params]
    out = {}
    for name, fn, moved in (
            ("delta", lambda: torch._foreach_sub(anchor, params), 3),
            ("outer_step", outer, 5),
            ("copy", lambda: torch._foreach_copy_(dst, anchor), 2)):
        out[name] = {"ms": cuda_ms(fn, iters=5, warmup=1),
                     "bound_ms": moved * nbytes / PEAK_BYTES_PER_S * 1e3}
    del scratch, grads, opt, dst
    torch.cuda.empty_cache()
    return out


def diloco_worker(group: int, runs: str, seed: int, lighthouse: str,
                  workdir: str, hold: int, preset: bool) -> int:
    """One replica group of the diloco phase (run as ``chip_smoke.py
    --diloco-worker``): run P with this process's init ``seed``, then, if
    ``runs`` is ``ps``, run S in the same process from init seed 0 at
    step 1 (one process start less per group)."""
    if not torch.cuda.is_available():
        raise SmokeError("the diloco worker needs a CUDA device")
    import gc

    for run in runs:
        _diloco_run(group, run, seed if run == "p" else 0, lighthouse,
                    workdir, hold if run == "p" else 0, preset or run == "s")
        # Run P's trainer, model and saved trees go before run S.
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _diloco_run(group: int, run: str, seed: int, lighthouse: str,
                workdir: str, hold: int, preset: bool) -> None:
    """One run of a diloco worker: a ``DiLoCoTrainer`` (run ``p``) or a
    ``StreamingDiLoCoTrainer`` (run ``s``) over the ft cell's model.
    Writes one row per inner step (wall, loss, the allreduce count and
    ring bytes after it) and one per outer round (the round's wall split,
    the anchor's and the outer momentum's sha256, whether params equal
    the anchor, heal counters, peak memory); run P's first round also
    saves this group's pseudo-gradient for the other group's plain-mean
    check and holds its own average to the plain mean and its anchor to
    a plain Nesterov step. Run S records each collect's fragment, which
    anchors moved and, on group 0 at the second collect, the merge rule.
    With ``hold``, the group waits to be killed once that step commits;
    with ``preset``, it starts at step 1."""
    from torchft_tpu_torch.backends.host import HostCommunicator
    from torchft_tpu_torch.local_sgd import (DiLoCoTrainer,
                                             StreamingDiLoCoTrainer)
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models.transformer import (
        Transformer, chunked_causal_lm_loss, llama2_7b_config)
    from torchft_tpu_torch.ops import attest
    from torchft_tpu_torch.ops import flash_attention as fa

    streaming = run == "s"
    cfg = llama2_7b_config(num_layers=WIRE_LAYERS,
                           attention_fn=fa.flash_attention, remat=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Transformer(cfg, device="cuda", generator=gen)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())

    def loss_fn(m, batch):
        return chunked_causal_lm_loss(m(batch, return_hidden=True),
                                      m.lm_head_kernel(), batch)

    kw = dict(fragments=DILOCO_FRAGMENTS) if streaming else {}
    trainer = (StreamingDiLoCoTrainer if streaming else DiLoCoTrainer)(
        model, loss_fn,
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4,
                          eps=1e-8, foreach=True),
        # One participant suffices, as in train_lm: a healer is not one
        # in its heal round. The lighthouse holds two members per quorum.
        lambda load, save: Manager(
            comm=HostCommunicator(), load_state_dict=load,
            state_dict=save, min_replica_size=1,
            replica_id=f"diloco_{run}_{group}", lighthouse_addr=lighthouse,
            rank=0, world_size=1),
        sync_every=DILOCO_SYNC_EVERY, **kw)
    m = trainer.manager
    if preset:
        m.load_state_dict({"step": 1, "batches_committed": 0})
    report = _diloco_report(workdir, run, group, seed)
    out = {"group": group, "run": run, "seed": seed, "steps": [],
           "rounds": [], "collects": [], "param_bytes": param_bytes}
    _write_json(report, out)
    names = list(trainer.params)

    # Run P's first round at world 2: save this group's pseudo-gradient
    # before the exchange, keep the average before the outer step (whose
    # Nesterov update adds the momentum into it in place).
    first = {}
    exchange = m.allreduce

    def allreduce(tree):
        if not streaming and preset and m.current_step() == 2 \
                and not first:
            first["delta"] = tree
            first["anchor"] = {n: trainer.anchor[n].clone() for n in names}
            torch.save(tree, os.path.join(workdir, f"delta_{group}.pt"))
        fut = exchange(tree)
        if "delta" in first and "avg" not in first:
            first["avg"] = {n: t.clone() for n, t in fut.result().items()}
        return fut

    m.allreduce = allreduce

    collect = trainer.collect_pending if streaming else None

    def collect_pending():
        pend = trainer._pending
        if pend is None:
            return collect()
        frag, _, at_send = pend
        mine = trainer._frag_names[frag]
        before = {n: t.clone() for n, t in trainer.anchor.items()}
        merge = group == 0 and len(out["collects"]) == 1
        if merge:
            p_before = [trainer.params[n].detach().clone() for n in mine]
            sent = [x.clone() for x in at_send]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = collect()
        torch.cuda.synchronize()
        row = {"frag": frag, "committed": res,
               "wall_s": time.perf_counter() - t0,
               "moved": [n for n in names
                         if not torch.equal(trainer.anchor[n], before[n])],
               "anchor_hash": _tree_hash(trainer.anchor)}
        del before
        if merge:
            got = [trainer.params[n].detach() for n in mine]
            want = [trainer.anchor[n] + (p - s)
                    for n, p, s in zip(mine, p_before, sent)]
            row["merge_diff"] = sum(int((g != w).sum())
                                    for g, w in zip(got, want))
            row["merge_rel"] = (
                max(float((g - w).abs().max()) for g, w in zip(got, want))
                / max(float(w.abs().max()) for w in want))
            del p_before, sent, want
        out["collects"].append(row)
        log(f"diloco[{run}{group}] collect " + json.dumps(
            {k: v for k, v in row.items() if k != "moved"}))
        return res

    if streaming:
        trainer.collect_pending = collect_pending

    fa.reset_launches()
    attest.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    total = 1 + (DILOCO_ROUNDS_S if streaming else DILOCO_ROUNDS_P)
    k = 0
    try:
        while (len(out["collects"]) < DILOCO_ROUNDS_S - 1 if streaming
               else m.current_step() < total):
            before = m.metrics()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, committed = trainer.train_step(
                _diloco_tokens(cfg.vocab_size, group, k))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k += 1
            mx = m.metrics()
            out["steps"].append({
                "local": trainer.local_steps, "step": m.current_step(),
                "loss": float(loss), "wall_s": wall,
                "committed": committed,
                "allreduces": mx["allreduce_count"]
                - before["allreduce_count"],
                "ring_bytes": mx["allreduce_ring_wire_bytes_total"]
                - before["allreduce_ring_wire_bytes_total"]})
            if not streaming and committed is not None:
                mom = {n: trainer.outer_optimizer.state[a]["momentum_buffer"]
                       for n, a in trainer.anchor.items()}
                row = {"step": m.current_step(), "committed": committed,
                       "local": trainer.local_steps,
                       "timings": dict(trainer.last_round_timings),
                       "anchor_hash": _tree_hash(trainer.anchor),
                       "momentum_hash": _tree_hash(mom),
                       "params_eq_anchor": all(
                           torch.equal(trainer.params[n], trainer.anchor[n])
                           for n in names),
                       "heal_count": mx["heal_count"],
                       "heal_ms_total": mx["heal_ms_total"],
                       "heal_bytes_total": mx["heal_bytes_total"],
                       "ring_bytes": out["steps"][-1]["ring_bytes"],
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "digest": m._last_state_digest}
                if "avg" in first and "plain_mean" not in out:
                    other = os.path.join(workdir, f"delta_{1 - group}.pt")
                    out["plain_mean"] = _plain_mean_err(
                        first["avg"], first["delta"], other)
                    avg, a0 = first["avg"], first["anchor"]
                    want = {n: a0[n] - DILOCO_LR * (
                        avg[n] + DILOCO_MOMENTUM * avg[n]) for n in names}
                    out["anchor_rel"] = (
                        max(float((trainer.anchor[n] - want[n]).abs().max())
                            for n in names)
                        / max(float(want[n].abs().max()) for n in names))
                    del want, a0
                    first.pop("anchor")
                out["rounds"].append(row)
                log(f"diloco[{run}{group}] round " + json.dumps(row))
            _write_json(report, out)
            if hold and m.current_step() == hold and committed:
                out["held"] = True
                _write_json(report, out)
                log(f"diloco[{run}{group}] holding after step {hold}")
                while True:
                    time.sleep(1)
        if streaming:
            # The flush collects the last in-flight round.
            trainer.flush()
        torch.cuda.synchronize()
        out["launches"] = {**fa.LAUNCHES, **attest.LAUNCHES}
        mx = m.metrics()
        out.update(
            peak_bytes=torch.cuda.max_memory_allocated(),
            frag_names=(trainer._frag_names if streaming else None),
            metrics={k: mx[k] for k in (
                "heal_count", "heal_ms_total", "heal_bytes_total",
                "committed_steps", "aborted_steps", "sdc_digests_total",
                "sdc_digest_ms_total", "sdc_quarantines_total",
                "allreduce_ms_total", "allreduce_ring_ms_total")},
            params_on_cpu=sum(p.device.type == "cpu"
                              for p in trainer.params.values()))
        if not streaming and group == 0:
            out["foreach"] = _foreach_times(
                trainer._param_list(), trainer._anchor_list(),
                [first["avg"][n] for n in names])
        _write_json(report, out)
    finally:
        trainer.shutdown()


def _spawn_diloco(group: int, runs: str, seed: int, lighthouse: str,
                  workdir: str, hold: int = 0,
                  preset: bool = True) -> subprocess.Popen:
    return _popen(
        [sys.executable, os.path.abspath(__file__), "--diloco-worker",
         str(group), "--diloco-runs", runs, "--diloco-seed", str(seed),
         "--diloco-lighthouse", lighthouse, "--diloco-dir", workdir,
         "--diloco-hold", str(hold),
         *(["--diloco-preset"] if preset else [])],
        os.path.join(workdir, f"diloco_{group}_{seed}.log"))


def _read_diloco(workdir: str, run: str, group: int, seed: int) -> dict:
    path = _diloco_report(workdir, run, group, seed)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        try:
            return json.load(f)
        except json.JSONDecodeError:
            return {}


def _diloco_runs(procs: list, workdir: str) -> tuple:
    """Runs P and S under one lighthouse (two members per quorum): group
    0 and the restarted group 1 go on to run S in the same processes."""
    from torchft_tpu_torch._native import Lighthouse

    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=2,
                    join_timeout_ms=2000, quorum_tick_ms=50)
    addr = lh.address()
    try:
        t0 = time.perf_counter()
        g0 = _spawn_diloco(0, "ps", 0, addr, workdir)
        g1 = _spawn_diloco(1, "p", 0, addr, workdir,
                           hold=1 + DILOCO_KILL_AFTER)
        procs += [g0, g1]
        deadline = time.time() + 600
        while not _read_diloco(workdir, "p", 1, 0).get("held"):
            check(g0.poll() is None and g1.poll() is None
                  and time.time() < deadline,
                  "diloco P: group 1 never held after round "
                  f"{DILOCO_KILL_AFTER}")
            time.sleep(0.05)
        os.killpg(g1.pid, signal.SIGKILL)
        g1.wait()
        log(f"diloco P: SIGKILLed group 1 after round {DILOCO_KILL_AFTER} "
            f"({time.perf_counter() - t0:.1f} s)")
        g1b = _spawn_diloco(1, "ps", 7, addr, workdir, preset=False)
        procs.append(g1b)
        while not (_read_diloco(workdir, "s", 0, 0)
                   and _read_diloco(workdir, "s", 1, 0)):
            check(g0.poll() is None and g1b.poll() is None
                  and time.time() < deadline,
                  "diloco P: a group ended or hung before run S")
            time.sleep(0.05)
        log(f"diloco P: both groups done in {time.perf_counter() - t0:.1f}"
            " s")
        t1 = time.perf_counter()
        _wait(g0, 600, "diloco group 0")
        _wait(g1b, 600, "diloco restarted group 1")
        fleet = _fleet_status(addr)["fleet"]
        log(f"diloco S: both groups done in {time.perf_counter() - t1:.1f}"
            f" s; lighthouse sdc_verdicts_total over both runs="
            f"{fleet['sdc_verdicts_total']}")
    finally:
        lh.shutdown()
    return ([_read_diloco(workdir, "p", 0, 0),
             _read_diloco(workdir, "p", 1, 0),
             _read_diloco(workdir, "p", 1, 7)],
            [_read_diloco(workdir, "s", g, 0) for g in range(2)], fleet)


def _diloco_check_p(reps: list, fleet: dict) -> None:
    g0, g1, g1b = reps
    for r in reps:
        tag = f"diloco P group {r['group']} (seed {r['seed']})"
        check(all(s["loss"] == s["loss"] and abs(s["loss"]) != float("inf")
                  for s in r["steps"]), f"{tag}: non-finite loss")
        for s in r["steps"]:
            # The cross-group exchange moves only at outer rounds, by one
            # f32 pseudo-gradient.
            if s["committed"] is None:
                check(s["allreduces"] == 0 and s["ring_bytes"] == 0,
                      f"{tag} local step {s['local']}: an inner step moved "
                      f"{s['ring_bytes']} ring bytes")
            else:
                ratio = s["ring_bytes"] / r["param_bytes"]
                lo, hi = DILOCO_RING_RATIO
                check(s["allreduces"] == 1 and lo <= ratio <= hi,
                      f"{tag} local step {s['local']}: {s['allreduces']} "
                      f"allreduces, ring bytes {ratio:.4f} of the "
                      "pseudo-gradient")
        for row in r["rounds"]:
            check(row["committed"],
                  f"{tag} step {row['step']}: the round aborted")
            check(row["params_eq_anchor"],
                  f"{tag} step {row['step']}: params differ from the anchor")
    for r in (g0, g1):
        tag = f"diloco P group {r['group']} round 1"
        bad, err = r["plain_mean"]
        check(bad == 0, f"{tag}: the averaged pseudo-gradient differs from "
              f"the plain mean in {bad} elements (max {err:.3g})")
        check(r["anchor_rel"] <= DILOCO_REL,
              f"{tag}: anchor {r['anchor_rel']:.3g} off the plain Nesterov "
              f"step (limit {DILOCO_REL})")
    by_step = {row["step"]: row for row in g0["rounds"]}
    check(sorted(by_step) == list(range(2, 2 + DILOCO_ROUNDS_P)),
          f"diloco P group 0 rounds at steps {sorted(by_step)}")
    for r in (g1, g1b):
        for row in r["rounds"]:
            want = by_step[row["step"]]
            for key in ("anchor_hash", "momentum_hash"):
                check(row[key] == want[key],
                      f"diloco P step {row['step']}: {key} of group 1 (seed "
                      f"{r['seed']}) differs from group 0's")
    check([row["step"] for row in g1["rounds"]]
          == list(range(2, 2 + DILOCO_KILL_AFTER)),
          f"diloco P: the killed group's rounds {g1['rounds']}")
    check(g1b["metrics"]["heal_count"] >= 1,
          "diloco P: the restarted group never healed")
    check([row["step"] for row in g1b["rounds"]]
          == list(range(2 + DILOCO_KILL_AFTER, 2 + DILOCO_ROUNDS_P)),
          "diloco P: the restarted group committed rounds at steps "
          f"{[row['step'] for row in g1b['rounds']]}")
    # DiLoCo's per-group state (inner moments, drifted params) makes every
    # group's digest differ: no majority, no verdict (the JAX package's
    # behaviour, held by tests/test_torch_local_sgd.py).
    check(fleet["sdc_verdicts_total"] == 0,
          f"diloco: {fleet['sdc_verdicts_total']} sdc verdicts")
    check(all(r["metrics"]["sdc_quarantines_total"] == 0
              for r in (g0, g1b)), "diloco P: a group was quarantined")


def _diloco_check_s(reps: list) -> None:
    frags = [[c["frag"] for c in r["collects"]] for r in reps]
    want = [i % DILOCO_FRAGMENTS for i in range(DILOCO_ROUNDS_S)]
    check(frags[0] == frags[1] == want,
          f"diloco S: fragment ids {frags}, expected {want} on both")
    for r in reps:
        tag = f"diloco S group {r['group']}"
        check(all(s["loss"] == s["loss"] and abs(s["loss"]) != float("inf")
                  for s in r["steps"]), f"{tag}: non-finite loss")
        for c in r["collects"]:
            names = r["frag_names"][c["frag"]]
            check(c["committed"], f"{tag}: fragment {c['frag']} aborted")
            check(set(c["moved"]) <= set(names) and c["moved"],
                  f"{tag}: fragment {c['frag']}'s round moved {c['moved']}")
    for i, (a, b) in enumerate(zip(*[r["collects"] for r in reps])):
        check(a["anchor_hash"] == b["anchor_hash"],
              f"diloco S collect {i + 1}: the groups' anchors differ")
    merge = reps[0]["collects"][1]
    check(merge["merge_rel"] <= DILOCO_REL,
          f"diloco S: merge rule off by {merge['merge_rel']:.3g} "
          f"({merge['merge_diff']} elements differ)")


def _diloco_log(p: list, s: list) -> None:
    card = card_line()
    for r in p + s:
        walls = sorted(x["wall_s"] for x in r["steps"]
                       if x["committed"] is None)
        log(f"diloco {r['run'].upper()} group {r['group']} seed {r['seed']}"
            f" [{card}]: inner step wall_s median "
            f"{walls[len(walls) // 2] if walls else float('nan'):.3f} "
            f"(n={len(walls)}), peak card GB "
            f"{r.get('peak_bytes', 0) / 1e9:.3f}, heal ms "
            f"{r.get('metrics', {}).get('heal_ms_total', 0):.0f} bytes "
            f"{r.get('metrics', {}).get('heal_bytes_total', 0) / 1e9:.3f} GB"
            f", digests {r.get('metrics', {}).get('sdc_digests_total')} "
            f"({r.get('metrics', {}).get('sdc_digest_ms_total', 0):.0f} ms)"
            f", allreduce ms {r.get('metrics', {}).get('allreduce_ms_total')}"
            f" of which host ring "
            f"{r.get('metrics', {}).get('allreduce_ring_ms_total')}")
        if "plain_mean" in r:
            log(f"diloco P group {r['group']} round 1: average against the "
                f"plain mean, elements differing {r['plain_mean'][0]} (max "
                f"{r['plain_mean'][1]:.3g}); anchor against the plain "
                f"Nesterov step {r['anchor_rel']:.3g} (max abs over max "
                "abs)")
        for row in r["rounds"]:
            t = row["timings"]
            log(f"diloco P group {r['group']} step {row['step']} [{card}]: "
                f"round ms total {t['total'] * 1e3:.1f} = step "
                f"{t['step'] * 1e3:.1f} + pseudo-gradient "
                f"{t['delta'] * 1e3:.1f} + ring {t['allreduce'] * 1e3:.1f}"
                f" + vote {t['vote'] * 1e3:.1f} + update "
                f"{t['update'] * 1e3:.1f}; ring GB "
                f"{row['ring_bytes'] / 1e9:.3f}; heal_count "
                f"{row['heal_count']}")
        for c in r["collects"]:
            log(f"diloco S group {r['group']} fragment {c['frag']} "
                f"[{card}]: collect wall_s {c['wall_s']:.3f}"
                + (f"; merge rule off by {c['merge_rel']:.3g}, "
                   f"{c['merge_diff']} elements differ"
                   if "merge_rel" in c else ""))
        for name, t in (r.get("foreach") or {}).items():
            log(f"diloco P {name} over the tree [{card}]: "
                f"{t['ms']:.3f} ms (bound {t['bound_ms']:.3f} ms)")


def phase_diloco(procs: list) -> dict:
    """DiLoCo local SGD (see DILOCO_* above and the module docstring)."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_diloco_")
    try:
        p, s, fleet = _diloco_runs(procs, workdir)
    finally:
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name), OUT_DIR)
        shutil.rmtree(workdir, ignore_errors=True)
    _diloco_log(p, s)
    _diloco_check_p(p, fleet)
    _diloco_check_s(s)
    launches = {n: sum(r["launches"].get(n, 0) for r in p + s
                       if "launches" in r) for n in KERNELS}
    check(all(launches[n] > 0 for n in ("fwd", "bwd_fused",
                                         "attest_words")),
          f"diloco: kernels not launched ({launches})")
    for r in p + s:
        if "launches" in r:
            check(r["params_on_cpu"] == 0,
                  f"diloco {r['run']} group {r['group']}: parameters on the "
                  "CPU")
    return {"launches": launches, "reports": p + s}


# ------------------------------------------------------------------ main


# The run's own deadline, inside the script's 1200 s limit: past it the
# run fails and stops its workers.
DEADLINE_S = 1150


def main(argv: list) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--phases",
        default="card,kernels,ft,split,sp,wire,overlap,shard,attest,"
        "durable,capacity,diloco")
    # A rank of the sp phase's group, or a group of the wire phase
    # (started by the phase itself).
    ap.add_argument("--sp-worker", type=int, default=None)
    ap.add_argument("--sp-init")
    ap.add_argument("--sp-report")
    ap.add_argument("--wire-worker", type=int, default=None)
    ap.add_argument("--wire-lighthouse")
    ap.add_argument("--wire-report")
    ap.add_argument("--shard-worker", type=int, default=None)
    ap.add_argument("--shard-lighthouse")
    ap.add_argument("--shard-report")
    ap.add_argument("--capacity-worker", type=int, default=None)
    ap.add_argument("--capacity-run")
    ap.add_argument("--capacity-seed", type=int)
    ap.add_argument("--capacity-lighthouse")
    ap.add_argument("--capacity-dir")
    ap.add_argument("--capacity-hold", type=int, default=0)
    ap.add_argument("--capacity-gate", type=int, default=0)
    ap.add_argument("--capacity-preset", action="store_true")
    ap.add_argument("--diloco-worker", type=int, default=None)
    ap.add_argument("--diloco-runs")
    ap.add_argument("--diloco-seed", type=int)
    ap.add_argument("--diloco-lighthouse")
    ap.add_argument("--diloco-dir")
    ap.add_argument("--diloco-hold", type=int, default=0)
    ap.add_argument("--diloco-preset", action="store_true")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    # Full-precision float32 matmuls: the plain versions are references.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sp_worker is not None:
        return sp_worker(args.sp_worker, args.sp_init, args.sp_report)
    if args.wire_worker is not None:
        return wire_worker(args.wire_worker, args.wire_lighthouse,
                           args.wire_report)
    if args.shard_worker is not None:
        return shard_worker(args.shard_worker, args.shard_lighthouse,
                            args.shard_report)
    if args.capacity_worker is not None:
        return capacity_worker(
            args.capacity_worker, args.capacity_run, args.capacity_seed,
            args.capacity_lighthouse, args.capacity_dir,
            os.path.join(args.capacity_dir,
                         f"capacity_{args.capacity_run}_"
                         f"{args.capacity_worker}_{args.capacity_seed}.json"),
            args.capacity_hold, args.capacity_gate, args.capacity_preset)
    if args.diloco_worker is not None:
        return diloco_worker(
            args.diloco_worker, args.diloco_runs, args.diloco_seed,
            args.diloco_lighthouse, args.diloco_dir, args.diloco_hold,
            args.diloco_preset)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs: list = []

    def stop(signum, frame):
        raise SmokeError(f"stopped by {signal.Signals(signum).name}")

    # A signal, or the script's own deadline, fails the run through the
    # finally below, which stops every worker still running.
    for signum in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP,
                   signal.SIGALRM):
        signal.signal(signum, stop)
    signal.alarm(DEADLINE_S)
    try:
        def timed(name: str, fn, *args):
            t1 = time.perf_counter()
            res = fn(*args)
            # This process's cached blocks (the kernels phase's plain
            # versions at batch 8 hold tens of GB) go back to the card
            # before the next phase's groups start.
            torch.cuda.empty_cache()
            log(f"{name}: phase wall_s={time.perf_counter() - t1:.1f}")
            return res

        card = timed("card", phase_card)
        rows = timed("kernels", phase_kernels) if "kernels" in phases else {}
        launches = {n: 0 for n in KERNELS}
        if "ft" in phases:
            launches.update(
                {n: c for n, c in timed("ft", phase_ft, procs)["launches"]
                 .items() if n in ("fwd", "bwd_fused", "attest_words")})
        if "split" in phases:
            split = timed("split", phase_split)
            launches["bwd_dq"] = split["bwd_dq"]
            launches["bwd_dkdv"] = split["bwd_dkdv"]
        if "sp" in phases:
            launches.update(timed("sp", phase_sp, procs)["launches"])
        if "wire" in phases:
            timed("wire", phase_wire, procs)
        # The overlap, shard, attest, durable, capacity and diloco paths
        # run the forward and the fused backward too: each path's own
        # counts go under its own key.
        added = {}
        for name, phase in (("overlap", phase_overlap),
                            ("shard", phase_shard),
                            ("attest", phase_attest),
                            ("durable", phase_durable),
                            ("capacity", phase_capacity),
                            ("diloco", phase_diloco)):
            if name in phases:
                added[name] = timed(name, phase, procs)["launches"]
    finally:
        signal.alarm(0)
        _stop(procs)
    entries = []
    for n, (fn, kernel, tpu) in KERNELS.items():
        row = rows.get(n, {})
        entries.append({
            "name": fn, "kernel": kernel, "route": "cuda",
            "source": kernel_source(kernel), "replaces": tpu,
            "launches": launches[n],
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms"),
            **{f"launches_{path}": counts.get(n, 0)
               for path, counts in added.items()}})
    log(f"wall_s={time.perf_counter() - t0:.1f}")
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
