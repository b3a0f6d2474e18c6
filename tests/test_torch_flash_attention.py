"""The port's flash attention on the CPU against the JAX package: the plain
forward and backward (what the wrappers run for CPU tensors) against JAX's
``_reference`` and against its Pallas kernels in interpret mode with
``jax.grad``; the padding rule; the fused/split choice; and that CPU
tensors never reach a kernel. Inputs are made from a numpy seed and handed
to both packages.

Tolerances: 1e-5 in float32 (same math, different summation order); 2e-2
in bfloat16 (the two frameworks round bf16 at different places)."""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("torchft_tpu.ops.flash_attention")

pytestmark = pytest.mark.port


def _inputs(b, s, sk, h, h_kv, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(dtype)
    k = rng.standard_normal((b, sk, h_kv, d)).astype(dtype)
    v = rng.standard_normal((b, sk, h_kv, d)).astype(dtype)
    g = rng.standard_normal((b, s, h, d)).astype(dtype)
    return q, k, v, g


def _close(a, b, tol):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel is ever launched."""
    fa.reset_launches()
    yield
    assert all(n == 0 for n in fa.LAUNCHES.values()), fa.LAUNCHES


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("h_kv", [4, 2, 1])
@pytest.mark.parametrize("s", [128, 256])
def test_forward_matches_jax_reference(s, h_kv, d, causal):
    q, k, v, _ = _inputs(2, s, s, 4, h_kv, d)
    rep = 4 // h_kv
    want = jfa._reference(jnp.asarray(q),
                          jnp.repeat(jnp.asarray(k), rep, axis=2),
                          jnp.repeat(jnp.asarray(v), rep, axis=2), causal)
    out, lse = fa.flash_attention_fwd_ref(torch.tensor(q), torch.tensor(k),
                                          torch.tensor(v), causal)
    _close(out, want, 1e-5)
    assert lse.shape == (2 * 4, s) and lse.dtype == torch.float32


# (b, s, sk, h, h_kv, d, causal): aligned MHA / GQA / MQA, end-aligned
# s_q < s_k, the odd length the padding rule pads, non-causal.
GRAD_CASES = [
    (2, 128, 128, 4, 2, 32, True),
    (2, 256, 256, 4, 1, 64, True),
    (2, 64, 128, 4, 4, 32, True),
    (2, 99, 99, 4, 2, 32, True),
    (2, 128, 128, 4, 4, 64, False),
]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_autograd_matches_pallas_interpret(case):
    b, s, sk, h, h_kv, d, causal = case
    q, k, v, g = _inputs(b, s, sk, h, h_kv, d, seed=1)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, interpret=True)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal)
    (out * torch.tensor(g)).sum().backward()
    _close(out.detach(), jout, 1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, 1e-5)


def test_bfloat16_forward_and_grads_match_jax():
    import ml_dtypes

    q, k, v, g = _inputs(2, 128, 128, 4, 2, 64, seed=2,
                         dtype=ml_dtypes.bfloat16)
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, True, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g.astype(np.float32))

    jout = jfa.flash_attention(qj, kj, vj, True, interpret=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(qj, kj, vj)

    def t(x):
        return torch.tensor(x.astype(np.float32)).bfloat16()

    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, True)
    (out.float() * torch.tensor(g.astype(np.float32))).sum().backward()
    assert out.dtype == torch.bfloat16
    _close(out.detach().float(), np.asarray(jout, np.float32), 2e-2)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        ref = np.asarray(want, np.float32)
        scale = np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * scale


def test_noncausal_unaligned_raises():
    q, k, v, _ = _inputs(1, 99, 99, 2, 2, 32)
    with pytest.raises(ValueError, match="non-causal"):
        fa.flash_attention(torch.tensor(q), torch.tensor(k),
                           torch.tensor(v), causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, interpret=True)


@pytest.mark.parametrize("s_q,s_k", [(99, 99), (999, 999), (100, 228),
                                     (6000, 6000), (128, 128)])
def test_padding_rule_matches_jax(s_q, s_k):
    assert fa._seq_pad(s_q, s_k) == jfa._seq_pad(s_q, s_k)


def test_fused_split_choice_and_kill_switch(monkeypatch):
    monkeypatch.delenv("TORCHFT_FLASH_FUSED_BWD", raising=False)
    assert not fa.use_fused_bwd(192)  # 3 q tiles: split
    assert fa.use_fused_bwd(256)      # 4 q tiles: fused
    assert fa.use_fused_bwd(2048)
    monkeypatch.setenv("TORCHFT_FLASH_FUSED_BWD", "0")
    assert not fa.use_fused_bwd(2048)


def test_fused_and_split_paths_agree(monkeypatch):
    """Both backward routes of the autograd entry point give the same
    gradients (on the CPU both are the plain version; on the card
    fused_bwd_check holds the two kernels to 1e-3)."""
    q, k, v, g = _inputs(1, 256, 256, 4, 2, 32, seed=3)
    grads = []
    for flag in ("1", "0"):
        monkeypatch.setenv("TORCHFT_FLASH_FUSED_BWD", flag)
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        (fa.flash_attention(*ts, True) * torch.tensor(g)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_run_plain_on_cpu():
    """Each wrapper, given CPU tensors, returns its plain version's
    output with the kernel's dtypes and layouts."""
    q, k, v, g = (torch.tensor(x) for x in _inputs(1, 64, 64, 4, 2, 32))
    qh, kh, vh = fa.to_bh(q), fa.to_bh(k), fa.to_bh(v)
    o, lse = fa.flash_fwd(qh, kh, vh, 4, 2, True)
    doh, delta = fa.bwd_inputs(g, o)
    args = (qh, kh, vh, doh, lse, delta, 4, 2, True)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkdv(*args)
    dk_f, dv_f, dq_f = fa.flash_bwd_fused(*args)
    assert dq.dtype == dq_f.dtype == torch.float32
    assert dq.shape == qh.shape and dk.shape == (4, 64, 32)
    for a, b in ((dq, dq_f), (dk, dk_f), (dv, dv_f)):
        assert torch.equal(a, b)
    ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_ref(q, k, v,
                                                        fa.from_bh(o, 1),
                                                        lse, g)
    torch.testing.assert_close(fa.from_bh(dq, 1), ref_dq)
    torch.testing.assert_close(fa.kv_from_bh(dk, 1, 2, torch.float32),
                               ref_dk)


def test_mixed_devices_and_unknown_devices_raise():
    x = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="device"):
        fa.flash_fwd(x, x.to("meta"), x, 1, 1, True)


def _c_prototypes() -> dict:
    """The ``extern "C"`` entry points of ``csrc/flash_attention.cu``:
    name -> kinds of their parameters ("ptr", "int", "float")."""
    import os
    import re

    src = os.path.join(os.path.dirname(fa.__file__), os.pardir, "csrc",
                       "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    block = text[text.index('extern "C" {'):]
    protos = {}
    for name, params in re.findall(r"\bint (tft_\w+)\(([^)]*)\)", block):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append("ptr" if "*" in p else p.split()[0])
        protos[name] = kinds
    return protos


def test_ctypes_argtypes_match_c_prototypes():
    """ctypes passes each argument as its argtypes say: a pointer typed as
    an int would be cut to 32 bits on the card only."""
    import ctypes

    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
            ctypes.c_float: "float"}
    protos = _c_prototypes()
    table = fa.argtypes()
    assert set(protos) == set(table)
    for name, types in table.items():
        assert [kind[t] for t in types] == protos[name], name


def test_misaligned_kernel_input_raises():
    """TMA needs 16-byte aligned bases; the wrappers check before any
    launch."""
    n, s, d = 1, 64, 32
    base = torch.empty(n * s * d + 1, dtype=torch.bfloat16)
    bad = base[1:].view(n, s, d)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    good = torch.empty(n, s, d, dtype=torch.bfloat16)
    fa._check_kernel_inputs((good,), (), d)
    with pytest.raises(ValueError, match="aligned"):
        fa._check_kernel_inputs((good, bad), (), d)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_PTXAS = """\
ptxas info    : Function properties for _Z15flash_fwd_wgmmaILi128EEv
    0 bytes stack frame, {fwd_spill} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _Z18flash_bwd_dq_wgmmaILi128EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _Z20flash_bwd_dkdv_wgmmaILi128EEv
    0 bytes stack frame, {kv_stores} bytes spill stores, {kv_loads} bytes spill loads
ptxas info    : Used {kv_regs} registers, used 1 barriers
ptxas info    : Function properties for _Z21flash_bwd_fused_wgmmaILi128EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
"""
_SASS = """\
\t\tFunction : _Z15flash_fwd_wgmmaILi128EEv
        /*0100*/  UTMALDG.3D [UR8], [UR4] ;
        /*0200*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24 ;
\t\tFunction : _Z18flash_bwd_dq_wgmmaILi128EEv
        /*0100*/  UTMALDG.3D [UR8], [UR4] ;
        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;
\t\tFunction : _Z20flash_bwd_dkdv_wgmmaILi128EEv
        /*0100*/  UTMALDG.3D [UR8], [UR4] ;
        /*0200*/  HGMMA.64x32x16.F32.BF16 R24, gdesc[UR12], R24 ;
\t\tFunction : _Z21flash_bwd_fused_wgmmaILi128EEv
        /*0100*/  {bwd_load} [UR8], [UR4] ;
        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;
"""


def test_ptxas_report_reads_registers_and_spills():
    cs = _chip_smoke()
    kernels = cs.ptxas_report(_PTXAS.format(fwd_spill=0, kv_stores=32,
                                            kv_loads=52, kv_regs=255))
    assert kernels["_Z20flash_bwd_dkdv_wgmmaILi128EEv"] == {
        "spill_stores": 32, "spill_loads": 52, "registers": 255}
    assert kernels["_Z15flash_fwd_wgmmaILi128EEv"]["registers"] == 168


@pytest.mark.parametrize("fault", [None, "spill", "no_tma", "missing",
                                   "split_spill"])
def test_wgmma_kernel_build_check(fault):
    """chip_smoke's build check: a spill in any kernel (the forward's, or
    the split dk/dv kernel's), a kernel whose SASS has no TMA load, or one
    missing from the SASS, fails the run."""
    cs = _chip_smoke()
    split_spill = fault == "split_spill"
    kernels = cs.ptxas_report(_PTXAS.format(
        fwd_spill=8 if fault == "spill" else 0,
        kv_stores=32 if split_spill else 0, kv_loads=52 if split_spill else 0,
        kv_regs=168))
    sass = _SASS.format(bwd_load="LDG.E" if fault == "no_tma"
                        else "UTMALDG.3D")
    if fault == "missing":
        sass = sass.replace("flash_bwd_fused_wgmma", "other_kernel")
    if fault is None:
        cs.check_hopper_kernels(kernels, sass)
    else:
        with pytest.raises(cs.SmokeError):
            cs.check_hopper_kernels(kernels, sass)


def test_every_cuda_kernel_is_checked_as_a_hopper_kernel():
    """Each CUDA kernel chip_smoke reports is one whose build it checks —
    spills and SASS for the wgmma kernels, spills for the plain ones (the
    attestation reduction) — and is a __global__ function of csrc/; no
    WMMA code is left there."""
    import os
    import re

    cs = _chip_smoke()
    csrc = os.path.join(os.path.dirname(fa.__file__), os.pardir, "csrc")
    text = ""
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name)) as f:
            text += f.read()
    defined = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        text))
    named = {kernel for _, kernel, _ in cs.KERNELS.values()}
    assert named == set(cs.HOPPER_KERNELS) | set(cs.PLAIN_KERNELS)
    assert not set(cs.HOPPER_KERNELS) & set(cs.PLAIN_KERNELS)
    assert named <= defined, named - defined
    assert "wmma::" not in text and "<mma.h>" not in text
