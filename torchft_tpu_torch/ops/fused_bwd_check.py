"""Hardware check of the fused flash-attention backward against the split.

The fused kernel sums dq across k-tile blocks with f32 atomics; the split
dq kernel sums it inside the one block that owns each q tile. Both
recompute p and ds by the same formula, so on a correct card dq agrees to
f32 reordering noise, and that is what this check proves: a race or a lost
tile in the atomic sum corrupts dq by whole tiles (relative error of order
1), which it turns into a failure. dk and dv agree bit for bit by
construction (the split dk/dv kernel is the fused kernel's body without
its dq); they are compared all the same.

Exit codes: 0 = match, 75 = no GPU (skip), 1 = MISMATCH (set
``TORCHFT_FLASH_FUSED_BWD=0`` operationally until fixed).

    python -m torchft_tpu_torch.ops.fused_bwd_check
"""

from __future__ import annotations

import sys

import torch

SKIP = 75
TOLERANCE = 1e-3


def compare(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, causal: bool = True) -> float:
    """Worst relative difference (max |a - b| / max |b|) between the
    fused and split backward kernels' dq, dk, dv on these inputs."""
    from torchft_tpu_torch.ops import flash_attention as fa

    h, h_kv = q.shape[2], k.shape[2]
    qh, kh, vh = fa.to_bh(q), fa.to_bh(k), fa.to_bh(v)
    o, lse = fa.flash_fwd(qh, kh, vh, h, h_kv, causal)
    doh, delta = fa.bwd_inputs(do, o)
    args = (qh, kh, vh, doh, lse, delta, h, h_kv, causal)
    dk_f, dv_f, dq_f = fa.flash_bwd_fused(*args)
    dq_s = fa.flash_bwd_dq(*args)
    dk_s, dv_s = fa.flash_bwd_dkdv(*args)
    worst = 0.0
    for name, a, b in (("dq", dq_f, dq_s), ("dk", dk_f, dk_s),
                       ("dv", dv_f, dv_s)):
        a, b = a.float(), b.float()
        diff = float((a - b).abs().max())
        rel = diff / (float(b.abs().max()) or 1.0)
        worst = max(worst, rel)
        print(f"fused_bwd_check: {name} max_abs_diff={diff:.3e} "
              f"rel={rel:.3e}")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_bwd_check: no GPU; skipping", file=sys.stderr)
        return SKIP
    b, s, h, d = 1, 4096, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    if compare(q, k, v, do) > TOLERANCE:
        print("fused_bwd_check: MISMATCH — set TORCHFT_FLASH_FUSED_BWD=0 "
              "and investigate", file=sys.stderr)
        return 1
    print("fused_bwd_check: OK (fused == split on hardware)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
