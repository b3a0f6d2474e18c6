// Flash attention for Hopper (sm_90a): forward, split backward (dq and
// dk/dv) and fused backward, written by hand with WMMA bf16 16x16x16
// fragments and f32 accumulation.
//
// Counterparts of the four Pallas kernels in
// torchft_tpu/ops/flash_attention.py. They compute what those compute and
// keep the same contract:
//   * layout: q/o/do are [B*H, S, D], k/v are [B*Hkv, Sk, D], row major;
//     lse and delta are [B*H, S] f32;
//   * GQA by index: query row bh reads K/V row (bh / H) * Hkv + (bh % H) / rep,
//     no repeated K/V;
//   * end-aligned causal mask: query i sits at key position (Sk - S) + i and
//     sees keys k <= that position;
//   * the ring's shift mask (dynamic_shift in the TPU kernels): with causal
//     set, an int shift slides that diagonal, query i seeing keys
//     k <= (Sk - S) + i + shift. shift = 0 is the causal mask, shift >= Sk
//     shows every key, shift <= -Sk blocks every key. Every mask is one
//     int the kernels read, the diagonal's offset: Sk - S + shift, or
//     UNMASKED without causal; so one kernel serves all three modes;
//   * a masked entry has p = 0 by a select, never by exp(NEG_INF - m): a
//     row that sees no key gets o = 0, lse = NEG_INF + log(1e-30) and zero
//     gradients whatever the tiles (the TPU kernels give such a row, where
//     it shares a tile with visible entries, a tile-dependent value);
//   * bf16 matmul inputs, f32 softmax statistics and accumulators;
//   * block-level mask bounds: tiles with no visible entry are skipped by
//     the loop bound, only tiles next to the diagonal (or at a ragged edge)
//     pay for the element mask.
//
// What differs from the TPU kernels is the grid. A TPU grid runs in order
// on one core and carries sums in VMEM from one grid step to the next;
// here blocks run in parallel in no order, so the TPU's sequential grid
// axis becomes a loop inside the block:
//   * forward and dq: one block per (bh, 64-row q tile), looping over k tiles;
//   * dk/dv and fused: one block per (bh, 64-row k tile), looping over q tiles.
// The fused kernel's dq is summed across k-tile blocks with f32 atomicAdd
// into a zeroed [B*H, S, D] f32 buffer the caller allocates (the TPU kernel
// used an aliased HBM read-modify-write along its sequential grid axis).
//
// Tiles come from the H100's shared memory, not the TPU's VMEM: 64 x 64
// tiles, four warps per block, each warp owning 16 rows. At D = 128 a block
// holds ~110-125 KB of shared memory, above the 48 KB default, so every
// launch raises cudaFuncAttributeMaxDynamicSharedMemorySize first.
//
// Kernels allocate nothing and do not synchronise. Each C entry point
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // k rows per tile
constexpr int NWARPS = 4;       // each warp owns 16 rows of a tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDP = BK + 8;     // row stride of bf16 [*, BK] tiles
constexpr int LDS = BK + 4;     // row stride of f32 [16, BK] score tiles
constexpr float NEG_INF = -1e30f;  // finite, like the TPU kernel's
// Diagonal offset of "no mask": q + UNMASKED >= k for every key k < 2^30,
// and q + UNMASKED + BQ stays below 2^31 for q < 2^30 - BQ.
constexpr int UNMASKED = 1 << 30;

template <int D> struct Geo {
  static constexpr int LDH = D + 8;   // row stride of bf16 [*, D] tiles
  static constexpr int LDO = D + 4;   // row stride of f32 [16, D] tiles
  static constexpr int TILE_H = 64 * LDH * 2;          // bytes, bf16 64 x D
  static constexpr int TILE_P = 64 * LDP * 2;          // bytes, bf16 64 x BK
  static constexpr int WARP_S = 16 * LDS * 4;          // bytes, f32 16 x BK
  static constexpr int WARP_O = 16 * LDO * 4;          // bytes, f32 16 x D
  // Per-warp scratch of the backward: S and dP side by side; later reused
  // for a 16 x D f32 tile (dq part, dk/dv conversion).
  static constexpr int WARP_SCR =
      (2 * WARP_S > WARP_O ? 2 * WARP_S : WARP_O);
  static constexpr int FWD_SMEM =
      3 * TILE_H + NWARPS * (WARP_S + 16 * LDP * 2 + WARP_O);
  static constexpr int BWD_SMEM =
      4 * TILE_H + 2 * TILE_P + NWARPS * WARP_SCR + 2 * 64 * 4;
};

// Copy rows [row0, row0 + 64) of a [len, D] bf16 matrix into a padded
// shared tile, zero-filling rows at or past len. 16 bytes per thread.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int len) {
  constexpr int VEC = D / 8;
  for (int i = threadIdx.x; i < 64 * VEC; i += NTHREADS) {
    int r = i / VEC, c = i % VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < len)
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    *reinterpret_cast<uint4*>(dst + r * Geo<D>::LDH + c * 8) = val;
  }
}

__device__ __forceinline__ int kv_row(int bh, int H, int Hkv) {
  return (bh / H) * Hkv + (bh % H) / (H / Hkv);
}

// S_w[16, BK] = A[16, D] . B[BK, D]^T for one warp (A rows at a, B rows at b,
// both bf16 with row stride LDH), stored f32 into out (row stride LDS).
template <int D>
__device__ __forceinline__ void warp_abt(const bf16* a, const bf16* b,
                                         float* out) {
  constexpr int LDH = Geo<D>::LDH;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, LDS, wmma::mem_row_major);
  }
}

// Visibility of tile entry (query row qr of tile qi, key column kc of
// tile kj): in range, and on or left of the diagonal k = q + offset.
struct Mask {
  int S, Sk, offset;
  __device__ __forceinline__ bool visible(int q, int k) const {
    return q < S && k < Sk && q + offset >= k;
  }
  // Every entry of the (qi, kj) tile visible: no element mask needed.
  __device__ __forceinline__ bool full(int q0, int k0) const {
    if (q0 + BQ > S || k0 + BK > Sk) return false;
    return q0 + offset >= k0 + BK - 1;
  }
  // Key tiles that the rows of the q tile at q0 see: [0, return). A tile
  // whose rows see no key (last < 0) runs none; C division truncates
  // toward zero, so -BK < last < 0 would otherwise give 1.
  __device__ __forceinline__ int key_tiles(int q0) const {
    const int last = q0 + BQ - 1 + offset;  // last key any row here sees
    const int lim = last < 0 ? 0 : last / BK + 1;
    const int nkb = (Sk + BK - 1) / BK;
    return lim < nkb ? lim : nkb;
  }
};

// ---------------------------------------------------------------- forward
// Replaces _fwd_kernel (torchft_tpu/ops/flash_attention.py:136-207), grid
// (q tiles, B*H). Bound on this card: at S = 2048, D = 128 it does
// 4 * S * S * D / 2 causal flops per head against 4 * S * D * 2 bytes, so
// it is bound by the tensor cores; this first version reaches only part of
// their rate (WMMA, no TMA, the O accumulator kept in shared memory so the
// online-softmax rescale can touch it row by row).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int S, int Sk,
                 int offset, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + G::TILE_H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * G::TILE_H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 3 * G::TILE_H +
                         warp * (G::WARP_S + 16 * LDP * 2 + G::WARP_O);
  float* sS = reinterpret_cast<float*>(wbase);
  bf16* sP = reinterpret_cast<bf16*>(wbase + G::WARP_S);
  float* sO = reinterpret_cast<float*>(wbase + G::WARP_S + 16 * LDP * 2);

  const int qi = blockIdx.x, bh = blockIdx.y;
  const int q0 = qi * BQ;
  const Mask mask{S, Sk, offset};
  const bf16* qb = q + (size_t)bh * S * D;
  const int kvr = kv_row(bh, H, Hkv);
  const bf16* kb = k + (size_t)kvr * Sk * D;
  const bf16* vb = v + (size_t)kvr * Sk * D;

  load_tile<D>(sQ, qb, q0, S);
  for (int i = lane; i < 16 * G::LDO; i += 32) sO[i] = 0.0f;

  // Lane pair (2r, 2r+1) owns row r of the warp's 16; each lane one half.
  const int row = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + row;
  float m = NEG_INF, l = 0.0f;

  const int nkb = mask.key_tiles(q0);
  for (int kj = 0; kj < nkb; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();
    load_tile<D>(sK, kb, k0, Sk);
    load_tile<D>(sV, vb, k0, Sk);
    __syncthreads();
    warp_abt<D>(sQ + warp * 16 * G::LDH, sK, sS);
    __syncwarp();

    const bool full = mask.full(q0, k0);
    float s[32];
    float tmax = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int col = half * 32 + c;
      float x = sS[row * LDS + col] * scale;
      if (!full && !mask.visible(qrow, k0 + col)) x = NEG_INF;
      s[c] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float tsum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool vis = full || mask.visible(qrow, k0 + half * 32 + c);
      float p = vis ? expf(s[c] - m_new) : 0.0f;
      tsum += p;
      sP[row * LDP + half * 32 + c] = __float2bfloat16(p);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * corr + tsum;
    m = m_new;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      sO[row * G::LDO + d] *= corr;
    __syncwarp();

#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + n * 16, G::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sV + kk * 16 * G::LDH + n * 16, G::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + n * 16, acc, G::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qrow < S) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.0f / lc;
    bf16* ob = o + ((size_t)bh * S + qrow) * D;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      ob[d] = __float2bfloat16(sO[row * G::LDO + d] * inv);
    if (half == 0) lse[(size_t)bh * S + qrow] = m + logf(lc);
  }
}

// ----------------------------------------------------- backward, shared
// Phase 1 of every backward kernel for one warp's 16 query rows of the
// (q tile at q0, k tile at k0) block: recompute p = exp(s * scale - lse)
// and ds = p * (dp - delta), as _recompute_p_ds does
// (torchft_tpu/ops/flash_attention.py:309-341), writing both as bf16 rows
// of the block's [64, BK] tiles (p only when sP is given).
template <int D>
__device__ __forceinline__ void recompute_p_ds(
    const bf16* sQw, const bf16* sdOw, const bf16* sK, const bf16* sV,
    const float* sLse, const float* sDelta, float* scr, bf16* sPw,
    bf16* sdSw, const Mask& mask, int q0w, int k0, bool full, float scale) {
  const int lane = threadIdx.x % 32;
  float* sS = scr;
  float* sdP = scr + 16 * LDS;
  warp_abt<D>(sQw, sK, sS);
  warp_abt<D>(sdOw, sV, sdP);
  __syncwarp();
  const int row = lane >> 1, half = lane & 1;
  const float lse_r = sLse[row], delta_r = sDelta[row];
#pragma unroll 8
  for (int c = 0; c < 32; ++c) {
    const int col = half * 32 + c;
    float p = 0.0f;
    if (full || mask.visible(q0w + row, k0 + col))
      p = expf(sS[row * LDS + col] * scale - lse_r);
    const float ds = p * (sdP[row * LDS + col] - delta_r);
    if (sPw != nullptr) sPw[row * LDP + col] = __float2bfloat16(p);
    sdSw[row * LDP + col] = __float2bfloat16(ds);
  }
}

// Write a warp's f32 [16, D] accumulator fragments, times mul, as rows
// [r0, r0 + 16) of a [len, D] output, through the warp's scratch.
template <int D, typename T>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* scr,
    T* out, int r0, int len, float mul) {
  using G = Geo<D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(scr + n * 16, acc[n], G::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, d = i % D;
    if (r0 + r < len) {
      const float x = scr[r * G::LDO + d] * mul;
      if constexpr (sizeof(T) == 2)
        out[(size_t)(r0 + r) * D + d] = __float2bfloat16(x);
      else
        out[(size_t)(r0 + r) * D + d] = x;
    }
  }
  __syncwarp();
}

// -------------------------------------------------------------- backward dq
// Replaces _bwd_dq_kernel (torchft_tpu/ops/flash_attention.py:344-377),
// grid (q tiles, B*H): dq = sum over k tiles of ds . k * scale, kept in
// register fragments across the k loop and written in f32 (the caller
// casts to the input dtype, as the TPU kernel's output block did). Bound
// by the tensor cores at the slice's shapes (3 matmuls per block,
// recompute included).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Hkv, int S, int Sk, int offset, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + G::TILE_H);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * G::TILE_H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * G::TILE_H);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * G::TILE_H + G::TILE_P);
  const int warp = threadIdx.x / 32;
  float* scr = reinterpret_cast<float*>(smem + 4 * G::TILE_H +
                                        2 * G::TILE_P + warp * G::WARP_SCR);
  float* sLse = reinterpret_cast<float*>(smem + 4 * G::TILE_H +
                                         2 * G::TILE_P +
                                         NWARPS * G::WARP_SCR);
  float* sDelta = sLse + 64;

  const int qi = blockIdx.x, bh = blockIdx.y;
  const int q0 = qi * BQ;
  const Mask mask{S, Sk, offset};
  const int kvr = kv_row(bh, H, Hkv);
  const bf16* kb = k + (size_t)kvr * Sk * D;
  const bf16* vb = v + (size_t)kvr * Sk * D;

  load_tile<D>(sQ, q + (size_t)bh * S * D, q0, S);
  load_tile<D>(sdO, dout + (size_t)bh * S * D, q0, S);
  for (int i = threadIdx.x; i < 64; i += NTHREADS) {
    const bool ok = q0 + i < S;
    sLse[i] = ok ? lse[(size_t)bh * S + q0 + i] : 0.0f;
    sDelta[i] = ok ? delta[(size_t)bh * S + q0 + i] : 0.0f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  const int nkb = mask.key_tiles(q0);
  bf16* sdSw = sdS + warp * 16 * LDP;
  for (int kj = 0; kj < nkb; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();
    load_tile<D>(sK, kb, k0, Sk);
    load_tile<D>(sV, vb, k0, Sk);
    __syncthreads();
    recompute_p_ds<D>(sQ + warp * 16 * G::LDH, sdO + warp * 16 * G::LDH, sK,
                      sV, sLse + warp * 16, sDelta + warp * 16, scr, nullptr,
                      sdSw, mask, q0 + warp * 16, k0, mask.full(q0, k0),
                      scale);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sdSw + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sK + kk * 16 * G::LDH + n * 16, G::LDH);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }
  store_rows<D>(acc, scr, dq + (size_t)bh * S * D, q0 + warp * 16, S,
                scale);
}

// --------------------------------------------- backward dk/dv, and fused
// Replaces _bwd_dkdv_kernel (FUSED = false, torchft_tpu/ops/
// flash_attention.py:380-417) and _bwd_fused_kernel (FUSED = true, :420-483),
// grid (k tiles, B*H). Per q tile: phase 1 recomputes p and ds for the
// 64 x 64 block (warps own query rows), phase 2 accumulates
// dv += p^T . do and dk += ds^T . q in register fragments (warps own key
// rows), and the fused kernel's phase 3 adds ds . k * scale into the f32 dq
// buffer with atomicAdd (warps own query rows again). dk/dv are written per
// QUERY head; the caller sums the heads that share a kv head, as
// kv_from_bh does. Bound by the tensor cores at the slice's shapes; the
// fused kernel saves the split path's second recompute (5 matmuls per
// block instead of 7) at the price of the dq atomics.
template <int D, bool FUSED>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, float* __restrict__ dq,
                    int H, int Hkv, int S, int Sk, int offset, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + G::TILE_H);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * G::TILE_H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * G::TILE_H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * G::TILE_H);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * G::TILE_H + G::TILE_P);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(smem + 4 * G::TILE_H +
                                        2 * G::TILE_P + warp * G::WARP_SCR);
  float* sLse = reinterpret_cast<float*>(smem + 4 * G::TILE_H +
                                         2 * G::TILE_P +
                                         NWARPS * G::WARP_SCR);
  float* sDelta = sLse + 64;

  const int kj = blockIdx.x, bh = blockIdx.y;
  const int k0 = kj * BK;
  const Mask mask{S, Sk, offset};
  const int kvr = kv_row(bh, H, Hkv);
  load_tile<D>(sK, k + (size_t)kvr * Sk * D, k0, Sk);
  load_tile<D>(sV, v + (size_t)kvr * Sk * D, k0, Sk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.0f);
    wmma::fill_fragment(dv_acc[n], 0.0f);
  }

  const int nqb = (S + BQ - 1) / BQ;
  // First q tile whose last row reaches this tile's first key; at or past
  // nqb when no row does (a blocking shift): dk/dv stay zero.
  const int need = k0 - mask.offset - (BQ - 1);
  const int qi_start = need > 0 ? (need + BQ - 1) / BQ : 0;
  const bf16* qb = q + (size_t)bh * S * D;
  const bf16* dob = dout + (size_t)bh * S * D;
  for (int qi = qi_start; qi < nqb; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();
    load_tile<D>(sQ, qb, q0, S);
    load_tile<D>(sdO, dob, q0, S);
    for (int i = threadIdx.x; i < 64; i += NTHREADS) {
      const bool ok = q0 + i < S;
      sLse[i] = ok ? lse[(size_t)bh * S + q0 + i] : 0.0f;
      sDelta[i] = ok ? delta[(size_t)bh * S + q0 + i] : 0.0f;
    }
    __syncthreads();
    recompute_p_ds<D>(sQ + warp * 16 * G::LDH, sdO + warp * 16 * G::LDH, sK,
                      sV, sLse + warp * 16, sDelta + warp * 16, scr,
                      sP + warp * 16 * LDP, sdS + warp * 16 * LDP, mask,
                      q0 + warp * 16, k0, mask.full(q0, k0), scale);
    __syncthreads();
    // Phase 2: this warp's 16 key rows; contraction over the 64 q rows.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + kk * 16 * LDP + warp * 16, LDP);
        wmma::load_matrix_sync(fb, sdO + kk * 16 * G::LDH + n * 16, G::LDH);
        wmma::mma_sync(dv_acc[n], fa, fb, dv_acc[n]);
        wmma::load_matrix_sync(fa, sdS + kk * 16 * LDP + warp * 16, LDP);
        wmma::load_matrix_sync(fb, sQ + kk * 16 * G::LDH + n * 16, G::LDH);
        wmma::mma_sync(dk_acc[n], fa, fb, dk_acc[n]);
      }
    }
    if constexpr (FUSED) {
      // Phase 3: this warp's 16 query rows, dq part = ds . k * scale.
      const bf16* sdSw = sdS + warp * 16 * LDP;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fa, sdSw + kk * 16, LDP);
          wmma::load_matrix_sync(fb, sK + kk * 16 * G::LDH + n * 16, G::LDH);
          wmma::mma_sync(c, fa, fb, c);
        }
        wmma::store_matrix_sync(scr + n * 16, c, G::LDO, wmma::mem_row_major);
      }
      __syncwarp();
      const int r0 = q0 + warp * 16;
      float* dqb = dq + (size_t)bh * S * D;
      for (int i = lane; i < 16 * D; i += 32) {
        const int r = i / D, d = i % D;
        if (r0 + r < S)
          atomicAdd(dqb + (size_t)(r0 + r) * D + d,
                    scr[r * G::LDO + d] * scale);
      }
    }
  }
  __syncthreads();
  store_rows<D>(dk_acc, scr, dk + (size_t)bh * Sk * D, k0 + warp * 16, Sk,
                scale);
  store_rows<D>(dv_acc, scr, dv + (size_t)bh * Sk * D, k0 + warp * 16, Sk,
                1.0f);
}

// The kernels' mask: the diagonal offset of the end-aligned causal mask
// slid by shift, or UNMASKED.
int mask_offset(int S, int Sk, int causal, int shift) {
  return causal ? Sk - S + shift : UNMASKED;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int H, int Hkv, int S, int Sk,
                       int causal, int shift, float scale, cudaStream_t st) {
  constexpr int smem = Geo<D>::FWD_SMEM;
  cudaError_t e = prepare(flash_fwd_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      H, Hkv, S, Sk, mask_offset(S, Sk, causal, shift), scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int H, int Hkv, int S, int Sk,
                      int causal, int shift, float scale, cudaStream_t st) {
  constexpr int smem = Geo<D>::BWD_SMEM;
  cudaError_t e = prepare(flash_bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, H, Hkv, S, Sk,
      mask_offset(S, Sk, causal, shift), scale);
  return cudaGetLastError();
}

template <int D, bool FUSED>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, void* dq, int BH, int H, int Hkv,
                      int S, int Sk, int causal, int shift, float scale,
                      cudaStream_t st) {
  constexpr int smem = Geo<D>::BWD_SMEM;
  cudaError_t e = prepare(flash_bwd_kv_kernel<D, FUSED>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sk + BK - 1) / BK, BH);
  flash_bwd_kv_kernel<D, FUSED><<<grid, NTHREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      (float*)dq, H, Hkv, S, Sk, mask_offset(S, Sk, causal, shift), scale);
  return cudaGetLastError();
}

}  // namespace

// Head dims the kernels are instantiated for.
#define TFT_DISPATCH_D(D, CALL)                       \
  switch (D) {                                        \
    case 32: { constexpr int DD = 32; return CALL; }  \
    case 64: { constexpr int DD = 64; return CALL; }  \
    case 128: { constexpr int DD = 128; return CALL; } \
    default: return (int)cudaErrorInvalidValue;       \
  }

extern "C" {

int tft_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int H, int Hkv, int S, int Sk, int D,
                  int causal, int shift, float scale, void* stream) {
  TFT_DISPATCH_D(D, (int)launch_fwd<DD>(q, k, v, o, lse, BH, H, Hkv, S, Sk,
                                        causal, shift, scale,
                                        (cudaStream_t)stream))
}

int tft_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int BH, int H, int Hkv, int S, int Sk, int D,
                     int causal, int shift, float scale, void* stream) {
  TFT_DISPATCH_D(D, (int)launch_dq<DD>(q, k, v, dout, lse, delta, dq, BH, H,
                                       Hkv, S, Sk, causal, shift, scale,
                                       (cudaStream_t)stream))
}

int tft_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int H, int Hkv, int S,
                       int Sk, int D, int causal, int shift, float scale,
                       void* stream) {
  TFT_DISPATCH_D(D, (int)(launch_kv<DD, false>(
                        q, k, v, dout, lse, delta, dk, dv, nullptr, BH, H,
                        Hkv, S, Sk, causal, shift, scale,
                        (cudaStream_t)stream)))
}

int tft_flash_bwd_fused(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, void* dq, int BH, int H, int Hkv,
                        int S, int Sk, int D, int causal, int shift,
                        float scale, void* stream) {
  TFT_DISPATCH_D(D, (int)(launch_kv<DD, true>(
                        q, k, v, dout, lse, delta, dk, dv, dq, BH, H, Hkv, S,
                        Sk, causal, shift, scale, (cudaStream_t)stream)))
}

const char* tft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
