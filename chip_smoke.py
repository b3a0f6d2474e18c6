"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases kernels # a subset: card,kernels,ft,split

Phases:

1. **card** — the card's name and power limit (nvidia-smi), then the
   builds: the flash-attention kernels (nvcc, from
   ``torchft_tpu_torch/csrc``) and the C++ control-plane core (from
   ``torchft_tpu_torch/_core``), both started together.
2. **kernels** — each of the four flash-attention kernels against its
   plain PyTorch version on the same inputs, at the slice's shape and at
   GQA / non-causal / end-aligned / odd-length shapes; times of kernel,
   plain version and ``scaled_dot_product_attention`` (a yardstick only,
   never called by the port) at the slice's shape; then the fused-vs-split
   backward check of ``torchft_tpu_torch.ops.fused_bwd_check``.
3. **ft** — the main path: a native lighthouse and two replica groups
   (``python -m torchft_tpu_torch.train_lm``) on this one card at Llama-2-7B
   widths cut to 2 layers, batch 1 x 2048 tokens. Three steps, SIGKILL of
   group 1, restart with another init seed, heal from group 0 over HTTP,
   two more steps; then equal state hashes, committed post-heal steps,
   finite losses, kernel launches in both groups and no parameter on the
   CPU.
4. **split** — the split-backward path: one training step of the same
   model at a short sequence (fewer than 4 q tiles), which takes the dq and
   dk/dv kernels instead of the fused one.

Launch counts are reset just before each driven path and read just after
it. The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line. float32 matmuls are pinned to full precision
(TF32 off) so the plain versions are exact references.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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

KERNELS = {
    "fwd": ("flash_fwd", "torchft_tpu/ops/flash_attention.py:136"),
    "bwd_dq": ("flash_bwd_dq", "torchft_tpu/ops/flash_attention.py:344"),
    "bwd_dkdv": ("flash_bwd_dkdv", "torchft_tpu/ops/flash_attention.py:380"),
    "bwd_fused": ("flash_bwd_fused",
                  "torchft_tpu/ops/flash_attention.py:420"),
}
# (name, B, S, Sk, H, Hkv, D, causal); the first is the slice's shape.
CASES = [
    ("slice", 1, 2048, 2048, 32, 32, 128, True),
    ("gqa", 2, 256, 256, 8, 2, 64, True),
    ("noncausal", 2, 512, 512, 8, 8, 128, False),
    ("end_aligned", 1, 384, 1024, 8, 4, 128, True),
    ("odd", 1, 999, 999, 8, 8, 64, True),
]


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        kern = ex.submit(fa._lib)
        core = ex.submit(_native.lib)
        kern.result()
        core.result()
    log(f"builds: kernels + control-plane core in "
        f"{time.perf_counter() - t0:.1f} s")
    return line


# ------------------------------------------------------------ phase 2


def _visible_pairs(s: int, sk: int, causal: bool) -> int:
    if not causal:
        return s * sk
    off = sk - s
    return s * (s + 1) // 2 + off * s


def bounds(name: str, b: int, s: int, sk: int, h: int, h_kv: int, d: int,
           causal: bool) -> tuple:
    """(bound_ms, bound_by) of one kernel call at these shapes: the larger
    of its tensor-core time (matmul flops on the visible entries at the
    bf16 peak) and its memory time (each input read once, each output
    written once, at the HBM rate)."""
    pairs = b * h * _visible_pairs(s, sk, causal)
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


def phase_kernels() -> dict:
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import fused_bwd_check

    gen = torch.Generator(device="cuda")
    rows = {}
    for case, b, s, sk, h, h_kv, d, causal in CASES:
        gen.manual_seed(len(rows))

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16)

        q, k, v = rnd(b, s, h, d), rnd(b, sk, h_kv, d), rnd(b, sk, h_kv, d)
        do = rnd(b, s, h, d)
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
        for n, (kern, plain, lib) in times.items():
            bound_ms, bound_by = bounds(n, b, s, sk, h, h_kv, d, causal)
            rows[n].update(
                ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=3),
                library_ms=cuda_ms(lib) if lib is not None else None,
                bound_ms=bound_ms, bound_by=bound_by)
            log(f"time[{n}] kernel_ms={rows[n]['ms']:.3f} "
                f"plain_ms={rows[n]['plain_ms']:.3f} "
                f"library_ms={rows[n]['library_ms']} "
                f"bound_ms={bound_ms:.3f} ({bound_by})")
        worst = fused_bwd_check.compare(q, k, v, do, causal)
        log(f"fused_bwd_check: fused vs split rel={worst:.3e}")
        check(worst <= fused_bwd_check.TOLERANCE,
              "fused backward disagrees with the split backward")
    return rows


# ------------------------------------------------------------ phase 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The slice: Llama-2-7B widths cut to 2 layers, batch 1 x 2048 tokens.
FT_ENV = {"MODEL": "llama2_7b", "NUM_LAYERS": "2", "BATCH_SIZE": "1",
          "SEQ_LEN": "2048"}
FT_ARGS: list = []


def _spawn(group: int, seed: int, lighthouse: str, workdir: str,
           steps: int, hold: int = 0) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(FT_ENV)
    if hold:
        env["HOLD_AFTER_STEP"] = str(hold)
    env.update(
        REPLICA_GROUP_ID=str(group), NUM_REPLICA_GROUPS="2",
        TORCHFT_LIGHTHOUSE=lighthouse, TOTAL_STEPS=str(steps),
        INIT_SEED=str(seed), DATA_DIR=workdir, TORCHFT_HEAL_STALL_SEC="120",
        REPORT_FILE=os.path.join(workdir, f"report_{group}_{seed}.json"),
        PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    log_path = os.path.join(workdir, f"group_{group}_{seed}.log")
    return subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.train_lm", *FT_ARGS],
        cwd=ROOT, env=env, stdout=open(log_path, "w"),
        stderr=subprocess.STDOUT, start_new_session=True)


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


def phase_ft(procs: list) -> dict:
    """The main path (see the module docstring). Returns per-group
    reports and the kernels' launch counts summed over the groups."""
    from torchft_tpu_torch._native import Lighthouse

    workdir = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    # Two members per quorum: the survivor waits for the restarted group
    # instead of running ahead alone. No fast path: its answers count a
    # peer that has not asked yet at its previous step (ROADMAP.md, C).
    lh = Lighthouse(bind=f"127.0.0.1:{_free_port()}", min_replicas=2,
                    join_timeout_ms=2000, quorum_tick_ms=50,
                    fast_path=False)
    addr = lh.address()
    total = 5
    try:
        t0 = time.perf_counter()
        g0 = _spawn(0, 0, addr, workdir, total)
        # Group 1 holds after its third step: group 0 then waits in the
        # next quorum round (two members per quorum) until the kill.
        g1 = _spawn(1, 1, addr, workdir, total, hold=3)
        procs += [g0, g1]
        progress = os.path.join(workdir, "report_1_1.json")
        deadline = time.time() + 600
        while time.time() < deadline:
            if os.path.exists(progress):
                with open(progress) as f:
                    try:
                        rep = json.load(f)
                    except json.JSONDecodeError:
                        rep = {}
                if rep.get("held"):
                    break
            check(g1.poll() is None and g0.poll() is None,
                  "a replica group exited before the kill")
            time.sleep(0.2)
        else:
            raise SmokeError("group 1 never reached step 3")
        os.killpg(g1.pid, signal.SIGKILL)
        g1.wait()
        log(f"ft: SIGKILLed group 1 after step 3 "
            f"({time.perf_counter() - t0:.1f} s)")
        g1b = _spawn(1, 7, addr, workdir, total)
        procs.append(g1b)
        _wait(g0, 900, "group 0")
        _wait(g1b, 900, "restarted group 1")
    finally:
        lh.shutdown()
        for name in os.listdir(workdir):
            if name.endswith(".log"):
                shutil.copy(os.path.join(workdir, name), OUT_DIR)
    r0 = _read_report(workdir, 0, 0)
    r1 = _read_report(workdir, 1, 7)
    shutil.rmtree(workdir, ignore_errors=True)
    for r in (r0, r1):
        log(f"ft: group {r['group']} steps={r['step']} "
            f"losses={[round(x, 4) for x in r['losses']]} "
            f"committed={r['committed']} step_s={r['step_s']} "
            f"allreduce_ms={r['allreduce_ms']} heal_ms={r['heal_ms']} "
            f"launches={r['launches']} hash={r['state_hash'][:16]}")
    check(r0["state_hash"] == r1["state_hash"],
          "groups ended with different parameter/optimizer state")
    check(r1["heal_count"] >= 1, "restarted group 1 never healed")
    check(all(r1["committed"]), "a post-heal step of group 1 aborted")
    check(all(r0["committed"][-2:]), "a post-heal step of group 0 aborted")
    for r in (r0, r1):
        check(all(x == x and abs(x) != float("inf") for x in r["losses"]),
              f"group {r['group']}: non-finite loss")
        check(r["launches"]["fwd"] > 0 and r["launches"]["bwd_fused"] > 0,
              f"group {r['group']}: flash kernels not launched")
        check(r["params_on_cpu"] == 0,
              f"group {r['group']}: parameters left on the CPU")
    launches = {n: r0["launches"][n] + r1["launches"][n] for n in KERNELS}
    return {"launches": launches, "reports": [r0, r1]}


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


# ------------------------------------------------------------------ main


def main(argv: list) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="card,kernels,ft,split")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Full-precision float32 matmuls: the plain versions are references.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs: list = []
    try:
        card = phase_card()
        rows = phase_kernels() if "kernels" in phases else {}
        launches = {n: 0 for n in KERNELS}
        if "ft" in phases:
            launches.update(
                {n: c for n, c in phase_ft(procs)["launches"].items()
                 if n in ("fwd", "bwd_fused")})
        if "split" in phases:
            split = phase_split()
            launches["bwd_dq"] = split["bwd_dq"]
            launches["bwd_dkdv"] = split["bwd_dkdv"]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    entries = []
    for n, (fn, tpu) in KERNELS.items():
        row = rows.get(n, {})
        entries.append({
            "name": fn, "route": "cuda",
            "source": "torchft_tpu_torch/csrc/flash_attention.cu",
            "replaces": tpu, "launches": launches[n],
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms")})
    log(f"wall_s={time.perf_counter() - t0:.1f}")
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
