"""Flash attention on Hopper: the transformer's hot op.

Blockwise online-softmax attention that never materializes the [S, S]
score matrix. The four kernels are CUDA C++ for ``sm_90a``
(``csrc/flash_attention.cu``), the port of the four Pallas kernels in
``torchft_tpu/ops/flash_attention.py``:

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

:func:`flash_attention` is the autograd entry point with the JAX function's
contract: ``[B, S, H, D]`` layout, GQA by index, end-aligned causal mask,
zero-padding of odd causal lengths, ``ValueError`` for non-causal unaligned
lengths, and the fused/split backward choice with the
``TORCHFT_FLASH_FUSED_BWD=0`` kill-switch.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30
# Kernel tiles (csrc/flash_attention.cu BQ/BK). The fused/split choice
# counts q tiles of this size.
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (32, 64, 128)

# Launches per kernel since the last reset_launches(); bumped only where a
# wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkdv": 0,
                            "bwd_fused": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The kernels' shared library, built with nvcc at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from torchft_tpu_torch._build_util import load_cuda

            lib = load_cuda("flash_attention.cu")
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            dims = [i32] * 6 + [i32, f32, vp]  # BH H Hkv S Sk D causal ...
            lib.tft_flash_fwd.argtypes = [vp] * 5 + dims
            lib.tft_flash_bwd_dq.argtypes = [vp] * 7 + dims
            lib.tft_flash_bwd_dkdv.argtypes = [vp] * 8 + dims
            lib.tft_flash_bwd_fused.argtypes = [vp] * 9 + dims
            for fn in (lib.tft_flash_fwd, lib.tft_flash_bwd_dq,
                       lib.tft_flash_bwd_dkdv, lib.tft_flash_bwd_fused):
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


def _scores(qh: torch.Tensor, kx: torch.Tensor, causal: bool
            ) -> torch.Tensor:
    """Scaled, masked f32 logits ``[BH, S, Sk]``."""
    s, sk, d = qh.shape[1], kx.shape[1], qh.shape[2]
    logits = torch.matmul(qh.float(), kx.transpose(1, 2)) * d ** -0.5
    if causal:
        mask = torch.ones(s, sk, dtype=torch.bool,
                          device=qh.device).tril(diagonal=sk - s)
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits


def fwd_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              h: int, h_kv: int, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, f32 math: ``(o, lse)``."""
    bh = _dims(qh, kh, h, h_kv)[0]
    idx = _kv_index(bh, h, h_kv, qh.device)
    logits = _scores(qh, kh.float()[idx], causal)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    return torch.matmul(p, vh.float()[idx]).to(qh.dtype), lse


def bwd_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              h: int, h_kv: int, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels, f32 math: ``(dq, dk, dv)``
    with dk/dv per QUERY head (``[B*H, Sk, D]``), from the same residuals
    the kernels read: p = exp(logits - lse), ds = p * (dp - delta)."""
    bh, _, _, d = _dims(qh, kh, h, h_kv)
    idx = _kv_index(bh, h, h_kv, qh.device)
    kx, vx = kh.float()[idx], vh.float()[idx]
    p = torch.exp(_scores(qh, kx, causal) - lse[..., None])
    do = doh.float()
    ds = p * (torch.matmul(do, vx.transpose(1, 2)) - delta[..., None])
    scale = d ** -0.5
    dq = torch.matmul(ds, kx) * scale
    dk = torch.matmul(ds.transpose(1, 2), qh.float()) * scale
    dv = torch.matmul(p.transpose(1, 2), do)
    return dq, dk, dv


# ------------------------------------------------------------ wrappers


def flash_fwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              h: int, h_kv: int, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: ``(o [B*H, S, D], lse [B*H, S] f32)``."""
    if _on_cpu(qh, kh, vh):
        return fwd_plain(qh, kh, vh, h, h_kv, causal)
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh), (), d)
    o = torch.empty_like(qh)
    lse = torch.empty(bh, s, dtype=torch.float32, device=qh.device)
    rc = _lib().tft_flash_fwd(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, h, h_kv, s, sk, d, int(causal), d ** -0.5,
        _stream(qh))
    _raise_if(rc, "fwd")
    LAUNCHES["fwd"] += 1
    return o, lse


def flash_bwd_dq(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                 doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 h: int, h_kv: int, causal: bool) -> torch.Tensor:
    """Split-backward dq kernel: ``dq [B*H, S, D]`` in f32."""
    if _on_cpu(qh, kh, vh, doh, lse, delta):
        return bwd_plain(qh, kh, vh, doh, lse, delta, h, h_kv, causal)[0]
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh, doh), (lse, delta), d)
    dq = torch.empty(bh, s, d, dtype=torch.float32, device=qh.device)
    rc = _lib().tft_flash_bwd_dq(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, h, h_kv, s, sk,
        d, int(causal), d ** -0.5, _stream(qh))
    _raise_if(rc, "bwd_dq")
    LAUNCHES["bwd_dq"] += 1
    return dq


def flash_bwd_dkdv(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                   doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   h: int, h_kv: int, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-backward dk/dv kernel: per-query-head ``dk, dv
    [B*H, Sk, D]`` in the input dtype."""
    if _on_cpu(qh, kh, vh, doh, lse, delta):
        _, dk, dv = bwd_plain(qh, kh, vh, doh, lse, delta, h, h_kv, causal)
        return dk.to(kh.dtype), dv.to(vh.dtype)
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh, doh), (lse, delta), d)
    dk = torch.empty(bh, sk, d, dtype=kh.dtype, device=qh.device)
    dv = torch.empty_like(dk)
    rc = _lib().tft_flash_bwd_dkdv(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        h, h_kv, s, sk, d, int(causal), d ** -0.5, _stream(qh))
    _raise_if(rc, "bwd_dkdv")
    LAUNCHES["bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_fused(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    doh: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    h: int, h_kv: int, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused-backward kernel: per-query-head ``dk, dv [B*H, Sk, D]`` in
    the input dtype and ``dq [B*H, S, D]`` in f32."""
    if _on_cpu(qh, kh, vh, doh, lse, delta):
        dq, dk, dv = bwd_plain(qh, kh, vh, doh, lse, delta, h, h_kv, causal)
        return dk.to(kh.dtype), dv.to(vh.dtype), dq
    bh, s, sk, d = _dims(qh, kh, h, h_kv)
    _check_kernel_inputs((qh, kh, vh, doh), (lse, delta), d)
    dk = torch.empty(bh, sk, d, dtype=kh.dtype, device=qh.device)
    dv = torch.empty_like(dk)
    dq = torch.zeros(bh, s, d, dtype=torch.float32, device=qh.device)
    rc = _lib().tft_flash_bwd_fused(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dq.data_ptr(), bh, h, h_kv, s, sk, d, int(causal), d ** -0.5,
        _stream(qh))
    _raise_if(rc, "bwd_fused")
    LAUNCHES["bwd_fused"] += 1
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


class _FlashCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
        b, _, h, _ = q.shape
        h_kv = k.shape[2]
        if h % h_kv:
            raise ValueError(f"num_heads {h} not a multiple of kv heads "
                             f"{h_kv}")
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
        args = (qh, kh, vh, doh, lse, delta, h, h_kv, causal)
        if use_fused_bwd(qh.shape[1]):
            dkh, dvh, dqh = flash_bwd_fused(*args)
        else:
            dqh = flash_bwd_dq(*args)
            dkh, dvh = flash_bwd_dkdv(*args)
        dq = from_bh(dqh.to(qh.dtype), b)
        if h == h_kv:
            dk, dv = from_bh(dkh, b), from_bh(dvh, b)
        else:
            dk = kv_from_bh(dkh, b, h_kv, kh.dtype)
            dv = kv_from_bh(dvh, b, h_kv, vh.dtype)
        return dq, dk, dv, None


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
