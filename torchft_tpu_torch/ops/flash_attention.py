"""Flash attention on Hopper: the transformer's hot op.

Blockwise online-softmax attention that never materializes the [S, S]
score matrix. The four kernels are CUDA C++ for ``sm_90a``
(``csrc/flash_attention.cu``, with the PTX helpers of ``csrc/hopper.cuh``),
the port of the four Pallas kernels in ``torchft_tpu/ops/flash_attention.py``.
All four are built on Hopper's wgmma, TMA and warp specialisation; the
dk/dv kernel is the fused kernel's body without its dq:

=====================  =============================================
wrapper                replaces (TPU kernel)
=====================  =============================================
:func:`flash_fwd`      ``_fwd_kernel`` (:136-207)
:func:`flash_bwd_dq`   ``_bwd_dq_kernel`` (:344-377)
:func:`flash_bwd_dkdv` ``_bwd_dkdv_kernel`` (:380-417)
:func:`flash_bwd_fused` ``_bwd_fused_kernel`` (:420-483)
=====================  =============================================

The wrappers take the kernels' "bh" layout: q/o/do ``[B*H, S, D]``, k/v
``[B*Hkv, Sk, D]``, lse and delta ``[B*H, S]`` f32. Each wrapper, given
CUDA tensors, checks them, launches its kernel on the current stream and
adds one to its count in :data:`LAUNCHES`; given CPU tensors it runs the
kernel's plain PyTorch version instead (that is how the CPU tests run the
module). There is no fallback: a CUDA tensor the kernel cannot take, or a
kernel library that does not build, raises.

Each wrapper also takes ``shift``, a host int: the TPU kernels'
``dynamic_shift`` mode, which ring attention runs. Given, it replaces the
causal flag with the mask ``k <= (Sk - S) + i + shift`` for query row i
(0 = causal, >= Sk = full, <= -Sk = blocked), and the launch is counted
under the ``*_shift`` key. A masked entry has p = 0 exactly, in the kernels
and the plain versions alike, so a row that sees no key gets o = 0,
lse = NEG_INF + log(1e-30) and zero gradients.

:func:`flash_attention` is the autograd entry point with the JAX function's
contract: ``[B, S, H, D]`` layout, GQA by index, end-aligned causal mask,
zero-padding of odd causal lengths, ``ValueError`` for non-causal unaligned
lengths, and the fused/split backward choice with the
``TORCHFT_FLASH_FUSED_BWD=0`` kill-switch. :func:`flash_attention_block`
is the ring's entry point (JAX :777-811): one pass with a shift mask,
returning ``(out, lse)``, differentiable through both.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30
# The TPU version's q tile: the fused/split choice counts q tiles of this
# size, whatever tiles the kernels use.
BLOCK_Q = 64
HEAD_DIMS = (32, 64, 128)

# Launches per kernel since the last reset_launches(); bumped only where a
# wrapper launches its kernel. Shift-mode launches count under "<name>_shift".
LAUNCHES: Dict[str, int] = {f"{n}{sfx}": 0 for sfx in ("", "_shift")
                            for n in ("fwd", "bwd_dq", "bwd_dkdv",
                                      "bwd_fused")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name: str, shift: Optional[int]) -> None:
    LAUNCHES[name if shift is None else f"{name}_shift"] += 1


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def argtypes() -> Dict[str, list]:
    """The ctypes argument types of the library's C entry points (its
    ``extern "C"`` block); each returns a CUDA error code as an int."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # BH H Hkv S Sk D causal shift scale stream
    dims = [i32] * 6 + [i32, i32, f32, vp]
    return {"tft_flash_fwd": [vp] * 5 + dims,
            "tft_flash_bwd_dq": [vp] * 7 + dims,
            "tft_flash_bwd_dkdv": [vp] * 8 + dims,
            "tft_flash_bwd_fused": [vp] * 10 + dims}


def _lib() -> ctypes.CDLL:
    """The kernels' shared library, built with nvcc at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from torchft_tpu_torch._build_util import load_cuda

            lib = load_cuda("flash_attention.cu")
            for name, types in argtypes().items():
                fn = getattr(lib, name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            lib.tft_error_string.argtypes = [ctypes.c_int]
            lib.tft_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version route);
    False when every tensor lies on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash attention: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    dev = next(iter(devices))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {dev}")
    return False


def _dims(qh: torch.Tensor, kh: torch.Tensor, h: int, h_kv: int
          ) -> Tuple[int, int, int, int]:
    bh, s, d = qh.shape
    if kh.dim() != 3 or kh.shape[2] != d:
        raise ValueError(f"k shape {tuple(kh.shape)} does not match q "
                         f"{tuple(qh.shape)}")
    if h % h_kv or bh % h or kh.shape[0] != bh // h * h_kv:
        raise ValueError(f"head counts h={h} h_kv={h_kv} do not fit q "
                         f"{tuple(qh.shape)} / k {tuple(kh.shape)}")
    return bh, s, kh.shape[1], d


def _check_kernel_inputs(bf16: Tuple[torch.Tensor, ...],
                         f32: Tuple[torch.Tensor, ...], d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    for t in bf16:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bfloat16 "
                            f"q/k/v/do, got {t.dtype}")
    for t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"flash attention kernel takes float32 "
                            f"lse/delta, got {t.dtype}")
    for t in bf16 + f32:
        if not t.is_contiguous():
            raise ValueError("flash attention kernel takes contiguous "
                             "tensors")
    for t in bf16:
        # TMA reads q/k/v/do from their base address, which must be
        # 16-byte aligned.
        if t.data_ptr() % 16:
            raise ValueError("flash attention kernel takes 16-byte aligned "
                             "q/k/v/do")


def _raise_if(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().tft_error_string(rc).decode()
        raise RuntimeError(f"flash attention {name} kernel: CUDA error "
                           f"{rc} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------- plain


def _kv_index(bh: int, h: int, h_kv: int, device: torch.device
              ) -> torch.Tensor:
    """K/V row of each query row: the GQA index map (kv_row)."""
    rows = torch.arange(bh, device=device)
    return (rows // h) * h_kv + (rows % h) // (h // h_kv)


def _visible(s: int, sk: int, causal: bool, shift: Optional[int],
             device: torch.device) -> Optional[torch.Tensor]:
    """The kernels' ``[S, Sk]`` mask: key k visible to query i when
    ``k <= (Sk - S) + i + shift`` (shift 0 when only ``causal``); None
    when every entry is visible."""
    if shift is None and not causal:
        return None
    return torch.ones(s, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - s + (shift or 0))


def _scores(qh: torch.Tensor, kx: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled, masked f32 logits ``[BH, S, Sk]``."""
    scale = qh.shape[2] ** -0.5
    logits = torch.matmul(qh.float(), kx.transpose(1, 2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits


def _probs(logits: torch.Tensor, lse: torch.Tensor,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """p = exp(logits - lse), and exactly 0 where masked (as the kernels
    select it)."""
    p = torch.exp(logits - lse[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def fwd_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              h: int, h_kv: int, causal: bool, shift: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, f32 math: ``(o, lse)`` with
    the kernel's lse = m + log(max(l, 1e-30))."""
    bh, s, sk, _ = _dims(qh, kh, h, h_kv)
    idx = _kv_index(bh, h, h_kv, qh.device)
    mask = _visible(s, sk, causal, shift, qh.device)
    logits = _scores(qh, kh.float()[idx], mask)
    m = logits.amax(dim=-1)
    e = _probs(logits, m, mask)
    l = e.sum(dim=-1).clamp_min(1e-30)
    p = e / l[..., None]
    return torch.matmul(p, vh.float()[idx]).to(qh.dtype), m + torch.log(l)


def bwd_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              h: int, h_kv: int, causal: bool, shift: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels, f32 math: ``(dq, dk, dv)``
    with dk/dv per QUERY head (``[B*H, Sk, D]``), from the same residuals
    the kernels read: p = exp(logits - lse), ds = p * (dp - delta)."""
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    idx = _kv_index(bh, h, h_kv, qh.device)
    kx, vx = kh.float()[idx], vh.float()[idx]
    mask = _visible(s, sk, causal, shift, qh.device)
    p = _probs(_scores(qh, kx, mask), lse, mask)
    do = doh.float()
    ds = p * (torch.matmul(do, vx.transpose(1, 2)) - delta[..., None])
    scale = d ** -0.5
    dq = torch.matmul(ds, kx) * scale
    dk = torch.matmul(ds.transpose(1, 2), qh.float()) * scale
    dv = torch.matmul(p.transpose(1, 2), do)
    return dq, dk, dv


# ------------------------------------------------------------ wrappers


def _mask_args(causal: bool, shift: Optional[int]) -> Tuple[int, int]:
    """The kernels' (causal, shift) ints: shift mode is the causal mask
    slid by ``shift``."""
    if shift is None:
        return int(causal), 0
    return 1, int(shift)


def flash_fwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              h: int, h_kv: int, causal: bool, shift: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: ``(o [B*H, S, D], lse [B*H, S] f32)``."""
    if _on_cpu(qh, kh, vh):
        return fwd_plain(qh, kh, vh, h, h_kv, causal, shift)
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh), (), d)
    o = torch.empty_like(qh)
    lse = torch.empty(bh, s, dtype=torch.float32, device=qh.device)
    rc = _lib().tft_flash_fwd(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, h, h_kv, s, sk, d, *_mask_args(causal, shift),
        d ** -0.5, _stream(qh))
    _raise_if(rc, "fwd")
    _count("fwd", shift)
    return o, lse


def flash_bwd_dq(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                 doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 h: int, h_kv: int, causal: bool,
                 shift: Optional[int] = None) -> torch.Tensor:
    """Split-backward dq kernel: ``dq [B*H, S, D]`` in f32."""
    if _on_cpu(qh, kh, vh, doh, lse, delta):
        return bwd_plain(qh, kh, vh, doh, lse, delta, h, h_kv, causal,
                         shift)[0]
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh, doh), (lse, delta), d)
    dq = torch.empty(bh, s, d, dtype=torch.float32, device=qh.device)
    rc = _lib().tft_flash_bwd_dq(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, h, h_kv, s, sk,
        d, *_mask_args(causal, shift), d ** -0.5, _stream(qh))
    _raise_if(rc, "bwd_dq")
    _count("bwd_dq", shift)
    return dq


def flash_bwd_dkdv(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                   doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   h: int, h_kv: int, causal: bool,
                   shift: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-backward dk/dv kernel: per-query-head ``dk, dv
    [B*H, Sk, D]`` in the input dtype."""
    if _on_cpu(qh, kh, vh, doh, lse, delta):
        _, dk, dv = bwd_plain(qh, kh, vh, doh, lse, delta, h, h_kv, causal,
                              shift)
        return dk.to(kh.dtype), dv.to(vh.dtype)
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh, doh), (lse, delta), d)
    dk = torch.empty(bh, sk, d, dtype=kh.dtype, device=qh.device)
    dv = torch.empty_like(dk)
    rc = _lib().tft_flash_bwd_dkdv(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        h, h_kv, s, sk, d, *_mask_args(causal, shift), d ** -0.5,
        _stream(qh))
    _raise_if(rc, "bwd_dkdv")
    _count("bwd_dkdv", shift)
    return dk, dv


def flash_bwd_fused(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    h: int, h_kv: int, causal: bool,
                    shift: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused-backward kernel: per-query-head ``dk, dv [B*H, Sk, D]`` in
    the input dtype and ``dq [B*H, S, D]`` in f32. The kernel sums dq
    across its k tiles in a fixed order, so the result is bitwise equal
    from run to run; its semaphores (one int per head and q tile of
    :data:`BLOCK_Q` rows) share dq's zeroed allocation."""
    if _on_cpu(qh, kh, vh, doh, lse, delta):
        dq, dk, dv = bwd_plain(qh, kh, vh, doh, lse, delta, h, h_kv, causal,
                               shift)
        return dk.to(kh.dtype), dv.to(vh.dtype), dq
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh, doh), (lse, delta), d)
    dk = torch.empty(bh, sk, d, dtype=kh.dtype, device=qh.device)
    dv = torch.empty_like(dk)
    n = bh * s * d
    buf = torch.zeros(n + bh * -(-s // BLOCK_Q), dtype=torch.float32,
                      device=qh.device)
    dq, sem = buf[:n].view(bh, s, d), buf[n:].view(torch.int32)
    rc = _lib().tft_flash_bwd_fused(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dq.data_ptr(), sem.data_ptr(), bh, h, h_kv, s, sk, d,
        *_mask_args(causal, shift),
        d ** -0.5, _stream(qh))
    _raise_if(rc, "bwd_fused")
    _count("bwd_fused", shift)
    return dk, dv, dq


# ------------------------------------------------------------- layouts


def to_bh(x: torch.Tensor) -> torch.Tensor:
    """``[B, S, H, D]`` -> contiguous ``[B*H, S, D]``."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def from_bh(x: torch.Tensor, b: int) -> torch.Tensor:
    """``[B*H, S, D]`` -> ``[B, S, H, D]`` (a view)."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def kv_from_bh(x: torch.Tensor, b: int, h_kv: int, dtype: torch.dtype
               ) -> torch.Tensor:
    """Per-query-head ``[B*H, Sk, D]`` -> ``[B, Sk, Hkv, D]``, summing in
    f32 over the query heads that share each kv head (GQA)."""
    bh, sk, d = x.shape
    rep = bh // (b * h_kv)
    x = x.reshape(b, h_kv, rep, sk, d).float().sum(dim=2)
    return x.transpose(1, 2).to(dtype)


def bwd_inputs(g: torch.Tensor, o: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(do, delta)`` in bh layout: delta = rowsum(dO * O), computed once
    outside the kernels (the TPU version's :513-514)."""
    doh = to_bh(g) if g.dim() == 4 else g.contiguous()
    delta = (doh.float() * o.float()).sum(dim=-1)
    return doh, delta


def use_fused_bwd(s: int) -> bool:
    """The fused/split choice of the TPU version (:580-582): fused when the
    q grid has at least 4 tiles of :data:`BLOCK_Q` rows, unless
    ``TORCHFT_FLASH_FUSED_BWD=0``. Nothing on this card needs the depth
    gate (the dq sum is atomic), but keeping the rule keeps the split
    kernels on a path that short sequences take."""
    fused_ok = os.environ.get("TORCHFT_FLASH_FUSED_BWD", "1") != "0"
    return fused_ok and -(-s // BLOCK_Q) >= 4


# ------------------------------------------------------------ autograd


def _heads(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int, int]:
    b, _, h, _ = q.shape
    h_kv = k.shape[2]
    if h % h_kv:
        raise ValueError(f"num_heads {h} not a multiple of kv heads {h_kv}")
    return b, h, h_kv


def _backward(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              b: int, h: int, h_kv: int, causal: bool,
              shift: Optional[int]) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv in the public layout through the fused or the split
    kernels (:func:`use_fused_bwd`), GQA heads summed."""
    args = (qh, kh, vh, doh, lse, delta, h, h_kv, causal, shift)
    if use_fused_bwd(qh.shape[1]):
        dkh, dvh, dqh = flash_bwd_fused(*args)
    else:
        dqh = flash_bwd_dq(*args)
        dkh, dvh = flash_bwd_dkdv(*args)
    dq = from_bh(dqh.to(qh.dtype), b)
    if h == h_kv:
        return dq, from_bh(dkh, b), from_bh(dvh, b)
    return (dq, kv_from_bh(dkh, b, h_kv, kh.dtype),
            kv_from_bh(dvh, b, h_kv, vh.dtype))


class _FlashCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
        b, h, h_kv = _heads(q, k)
        if causal and k.shape[1] < q.shape[1]:
            raise ValueError(
                "causal flash_attention requires s_k >= s_q (queries are "
                f"the last s_q positions); got s_q={q.shape[1]}, "
                f"s_k={k.shape[1]}")
        qh, kh, vh = to_bh(q), to_bh(k), to_bh(v)
        oh, lse = flash_fwd(qh, kh, vh, h, h_kv, causal)
        ctx.save_for_backward(qh, kh, vh, oh, lse)
        ctx.dims = (b, h, h_kv, causal)
        return from_bh(oh, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qh, kh, vh, oh, lse = ctx.saved_tensors
        b, h, h_kv, causal = ctx.dims
        doh, delta = bwd_inputs(g.to(oh.dtype), oh)
        return (*_backward(qh, kh, vh, doh, lse, delta, b, h, h_kv, causal,
                           None), None)


def _auto_block(seq: int, cap: int = 1024) -> int:
    """The JAX version's tile rule (:210-227), kept because its padding
    rule below is defined through it."""
    if seq <= 128:
        return seq
    b = cap
    while b >= 128:
        if seq % b == 0:
            return b
        b //= 2
    return seq if seq <= cap else 128


def _aligned_len(s: int) -> bool:
    b = _auto_block(s)
    return s % b == 0 and b % 8 == 0


def _seq_pad(s_q: int, s_k: int) -> int:
    """Smallest pad, applied to BOTH q and k (keeping the end-aligned
    causal offset), that aligns both lengths — the JAX version's rule."""
    for delta in range(0, 2049):
        if _aligned_len(s_q + delta) and _aligned_len(s_k + delta):
            return delta
    raise ValueError(
        f"flash_attention: no common pad aligns s_q={s_q} and s_k={s_k}; "
        "pad/mask the inputs externally")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention. q: ``[B, S, H, D]``; k/v: ``[B, S_k, H_kv, D]``
    with H_kv dividing H (GQA heads shared by index, never repeated).

    Lengths follow the JAX version's padding rule: odd causal lengths are
    zero-padded at the end (q and k/v by the same amount, so the
    end-aligned mask is unchanged and padded query rows are sliced off),
    and a non-causal unaligned input raises ``ValueError``."""
    s, sk = q.shape[1], k.shape[1]
    pad = _seq_pad(s, sk)
    if pad == 0:
        return _FlashCore.apply(q, k, v, causal)
    if not causal:
        raise ValueError(
            f"flash_attention: non-causal attention requires aligned "
            f"sequence lengths (got s_q={s}, s_k={sk}); pad the sequence "
            f"to a multiple of 8 (<=1024) or 128 and mask externally")
    padding = (0, 0, 0, 0, 0, pad)
    out = _FlashCore.apply(torch.nn.functional.pad(q, padding),
                           torch.nn.functional.pad(k, padding),
                           torch.nn.functional.pad(v, padding), causal)
    return out[:, :s]


# Consumers (models.transformer.Attention) read this to skip the GQA
# kv-head repeat — the kernels share kv heads by index.
flash_attention.supports_gqa = True


class _FlashBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, h_kv = _heads(q, k)
        qh, kh, vh = to_bh(q), to_bh(k), to_bh(v)
        oh, lse = flash_fwd(qh, kh, vh, h, h_kv, False, shift=shift)
        ctx.save_for_backward(qh, kh, vh, oh, lse)
        ctx.dims = (b, h, h_kv, shift)
        return from_bh(oh, b), lse

    @staticmethod
    def backward(ctx, g_out: torch.Tensor, g_lse: torch.Tensor):
        qh, kh, vh, oh, lse = ctx.saved_tensors
        b, h, h_kv, shift = ctx.dims
        doh, delta = bwd_inputs(g_out.to(oh.dtype), oh)
        # d lse / d logits is the softmax p, so the lse cotangent folds into
        # delta: ds = p * (dp - (delta - g_lse)) (JAX :515-519).
        delta = delta - g_lse.float()
        return (*_backward(qh, kh, vh, doh, lse, delta, b, h, h_kv, False,
                           shift), None)


def flash_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flash pass of q ``[B, S, H, D]`` against one K/V block
    ``[B, Sk, H_kv, D]`` under the shift mask (query i sees keys
    ``k <= (Sk - S) + i + shift``: 0 = diagonal-causal, >= Sk = full,
    <= -Sk = blocked). Returns ``(out [B, S, H, D]`` block-normalized,
    ``lse [B*H, S]`` f32), both differentiable, so blocks merge
    online-softmax style outside the kernels (ring attention). A blocked
    block gives out = 0 and lse ~ -1e30, which merges with weight 0."""
    return _FlashBlock.apply(q, k, v, int(shift))


# ------------------------------------------- plain versions, public layout


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in f32 math on ``[B, S, H, D]`` inputs:
    ``(out [B, S, H, D] in q's dtype, lse [B*H, S] f32)``."""
    oh, lse = fwd_plain(to_bh(q), to_bh(k), to_bh(v), q.shape[2],
                        k.shape[2], causal)
    return from_bh(oh, q.shape[0]), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain backward in f32 math: ``(dq, dk, dv)`` in the public layout
    and the inputs' dtypes, GQA heads summed, from the forward's
    residuals ``(o, lse)``."""
    b, h, h_kv = q.shape[0], q.shape[2], k.shape[2]
    doh, delta = bwd_inputs(do, to_bh(o))
    dq, dk, dv = bwd_plain(to_bh(q), to_bh(k), to_bh(v), doh, lse, delta,
                           h, h_kv, causal)
    return (from_bh(dq, b).to(q.dtype), kv_from_bh(dk, b, h_kv, k.dtype),
            kv_from_bh(dv, b, h_kv, v.dtype))
