// Flash attention for Hopper (sm_90a): forward, split backward (dq and
// dk/dv) and fused backward, written by hand, bf16 inputs and f32
// accumulation.
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
//   * forward and dq: one block per (bh, q tile), looping over k tiles;
//   * dk/dv and fused: one block per (bh, k tile), looping over q tiles.
// The fused kernel's dq is summed across k-tile blocks into a zeroed
// [B*H, S, D] f32 buffer the caller allocates, in a fixed order that a
// semaphore per (bh, q tile) enforces (the TPU kernel used an aliased HBM
// read-modify-write along its sequential grid axis): the sum, and so the
// gradients, are bitwise equal from run to run.
// The dk/dv kernel is the fused kernel without its dq (one body, two
// instantiations), so the two give bitwise equal dk and dv.
//
// Every kernel is written for Hopper (wgmma, TMA, warp specialisation;
// hopper.cuh): 128-row tiles, 384 threads a block, one producer warpgroup
// that keeps TMA loads in flight through a two-stage ring of shared-memory
// tiles guarded by mbarriers, and two consumer warpgroups that keep every
// accumulator in registers. Every launch raises
// cudaFuncAttributeMaxDynamicSharedMemorySize first.
//
// Kernels allocate nothing and do not synchronise. Each C entry point
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;  // finite, like the TPU kernel's
constexpr int HT = 128;            // rows of the kernels' tiles
// Diagonal offset of "no mask": q + UNMASKED >= k for every key k < 2^30,
// and q + UNMASKED + HT stays below 2^31 for q < 2^30 - HT.
constexpr int UNMASKED = 1 << 30;

__device__ __forceinline__ int kv_row(int bh, int H, int Hkv) {
  return (bh / H) * Hkv + (bh % H) / (H / Hkv);
}

// Visibility of tile entry (query row q, key k): in range, and on or left
// of the diagonal k = q + offset. TQ x TK is the tile.
struct Mask {
  int S, Sk, offset;
  // Every entry of the tile at (q0, k0) visible: no element mask needed.
  template <int TQ, int TK>
  __device__ __forceinline__ bool full(int q0, int k0) const {
    if (q0 + TQ > S || k0 + TK > Sk) return false;
    return q0 + offset >= k0 + TK - 1;
  }
  // Key tiles that the rows of the q tile at q0 see: [0, return). A tile
  // whose rows see no key (last < 0) runs none; C division truncates
  // toward zero, so -TK < last < 0 would otherwise give 1.
  template <int TQ, int TK>
  __device__ __forceinline__ int key_tiles(int q0) const {
    const int last = q0 + TQ - 1 + offset;  // last key any row here sees
    const int lim = last < 0 ? 0 : last / TK + 1;
    const int nkb = (Sk + TK - 1) / TK;
    return lim < nkb ? lim : nkb;
  }
  // First q tile of TQ rows whose last row reaches key k0; at or past the
  // last tile when no row does (a blocking shift).
  template <int TQ>
  __device__ __forceinline__ int first_q_tile(int k0) const {
    const int need = k0 - offset - (TQ - 1);
    return need > 0 ? (need + TQ - 1) / TQ : 0;
  }
};

// Geometry of the kernels' shared-memory tiles at head dim D: rows
// of D bf16 cut into D / AW swizzle atoms of AW columns (hopper.cuh).
template <int D> struct Tiles {
  static constexpr int AW = D < 64 ? D : 64;  // atom width, bf16 columns
  static constexpr int SW = AW * 2;           // swizzle width = atom row, bytes
  static constexpr int NA = D / AW;           // atoms per row
  static constexpr int KSTEPS = AW / 16;      // k16 steps per atom
  static constexpr int SBO = 8 * SW;          // bytes between 8-row groups
  // Bytes of a tile of `rows` rows.
  static constexpr int bytes(int rows) { return rows * D * 2; }
};

constexpr int HQ_BWD = 64;             // q rows per step of the dk/dv loop
constexpr int HQ_HALF = 32;            // q rows per half step of its consumers
constexpr int NCONSUMERS = 2;          // consumer warpgroups, 64 rows each
constexpr int HTHREADS = 128 * (1 + NCONSUMERS);
constexpr int CONSUMER_BAR = 1;        // named barrier of the consumers
// Named barriers of the fused backward's dq order (consumers + one warp).
constexpr int DQ_TURN_BAR = 2, DQ_DONE_BAR = 3;
constexpr int DQ_BAR_THREADS = 128 * NCONSUMERS + 32;
// Registers a thread after setmaxnreg: the launch gives each of the 384
// threads 168 (65,536 / 384, rounded down to 8); the producer warpgroup
// hands 168 - PRODUCER_REGS each to the consumers.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 168 + (168 - PRODUCER_REGS) / NCONSUMERS;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * NCONSUMERS <=
                  168 * HTHREADS,
              "register split exceeds the launch's pool");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// This thread's warpgroup, read from lane 0 (CUTLASS's
// canonical_warp_group_idx): the compiler then knows it is the same across
// the warp, and descriptors built from it live in uniform registers.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// K-major descriptor of rows [r0, r0 + 64) of a [rows, D] tile, at the
// first k16 step of the D contraction; kstep() is the offset of step kk.
template <int D>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int r0) {
  using T = Tiles<D>;
  return hopper::desc(tile + r0 * T::SW, 16, T::SBO, T::SW);
}

template <int D>
__device__ __forceinline__ uint64_t kstep(int rows, int kk) {
  using T = Tiles<D>;
  return ((kk / T::KSTEPS) * rows * T::SW + (kk % T::KSTEPS) * 32) >> 4;
}

// MN-major descriptor of a [rows, D] tile contracted over its rows, from
// atom `atom` of the columns, at the first k16 step; mnstep() is the
// offset of step kk.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile,
                                            int rows, int atom) {
  using T = Tiles<D>;
  return hopper::desc(tile + atom * rows * T::SW, rows * T::SW, T::SBO,
                      T::SW);
}

template <int D> __device__ __forceinline__ uint64_t mnstep(int kk) {
  return (kk * 16 * Tiles<D>::SW) >> 4;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A operand of a k16 step from a 64 x N accumulator (Wgmma layout):
// its 8-column chunks 2 kk and 2 kk + 1, as bf16.
__device__ __forceinline__ void acc_to_a(const float* acc, int kk,
                                         uint32_t* a) {
  a[0] = hopper::pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = hopper::pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = hopper::pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = hopper::pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// The producer's loop of the forward and dq kernels, on one thread: K/V
// tiles [0, nkt) of HT keys of K/V row kvr by TMA into the two-stage ring
// at `stages` (stage s: K, then V, `tile` bytes each), each stage refilled
// once the consumers have released it. Rolled, addresses made per step: the
// producer has 24 registers.
template <int D>
__device__ __forceinline__ void load_kv_ring(
    unsigned char* stages, int tile, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, uint64_t* full, uint64_t* empty, int nkt,
    int kvr) {
  using T = Tiles<D>;
#pragma unroll 1
  for (int t = 0; t < nkt; ++t) {
    const int s = hopper::opaque(t & 1);
    unsigned char* sK = stages + s * 2 * tile;
    unsigned char* sV = sK + tile;
    hopper::mbar_wait(&empty[s], ((t >> 1) & 1) ^ 1);
    hopper::mbar_expect_tx(&full[s], 2 * tile);
    for (int a = 0; a < T::NA; ++a) {
      hopper::tma_load_3d(sK + a * HT * T::SW, tm_k, &full[s], a * T::AW,
                          t * HT, kvr);
      hopper::tma_load_3d(sV + a * HT * T::SW, tm_v, &full[s], a * T::AW,
                          t * HT, kvr);
    }
  }
}

// Shared memory of the forward: Q tile, then two stages of K and V, then
// the barriers; plus slack to align the base to 1024 bytes.
template <int D> struct FwdSmem {
  static constexpr int Q = Tiles<D>::bytes(HT);
  static constexpr int KV = Tiles<D>::bytes(HT);
  static constexpr int BARS = Q + 4 * KV;
  static constexpr int TOTAL = BARS + 64 + 1024;
};

// ----------------------------------------------------- forward (wgmma)
// Replaces _fwd_kernel (torchft_tpu/ops/flash_attention.py:136-207), grid
// (q tiles of 128 rows, B*H), heaviest causal tile first. Bound by the
// tensor cores at the slice's shape (4 S^2 D / 2 causal flops a head
// against 8 S D bytes). Warpgroup 0 is the producer: one thread loads the
// Q tile once and K/V tiles of 128 keys through a two-stage ring by TMA;
// warpgroups 1 and 2 each own 64 query rows: S = Q K^T by wgmma from
// shared memory into registers, the online softmax on the accumulator
// layout (a row lives in one quad of lanes), P converted in registers and
// fed as wgmma's A operand for O += P V, O rescaled in registers.
template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ o, float* __restrict__ lse, int H,
                int Hkv, int S, int Sk, int offset, float scale_log2) {
  using T = Tiles<D>;
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  // Offset from the __shared__ array (not a round trip through an
  // integer) keeps every tile pointer a 32-bit shared address.
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bars;       // [2] K/V stage loaded
  uint64_t* empty = bars + 2;  // [2] K/V stage released
  uint64_t* qbar = bars + 4;

  const int nqt = (S + HT - 1) / HT;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * HT;
  const int bh = blockIdx.y;
  const Mask mask{S, Sk, offset};
  const int nkt = mask.key_tiles<HT, HT>(q0);
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * NCONSUMERS);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && nkt > 0) {
      const int kvr = kv_row(bh, H, Hkv);
      hopper::mbar_expect_tx(qbar, L::Q);
      for (int a = 0; a < T::NA; ++a)
        hopper::tma_load_3d(sQ + a * HT * T::SW, &tm_q, qbar, a * T::AW, q0,
                            bh);
      load_kv_ring<D>(smem + L::Q, L::KV, &tm_k, &tm_v, full, empty, nkt,
                      kvr);
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;                     // rows [64 c, 64 c + 64)
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qc0 = q0 + 64 * c;              // this consumer's first row
    const int rows[2] = {qc0 + 16 * w + lane / 4, qc0 + 16 * w + lane / 4 + 8};
    const int col = 2 * (lane % 4);           // first column in a chunk
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    if (nkt > 0) hopper::mbar_wait(qbar, 0);
    for (int t = 0; t < nkt; ++t) {
      const int s = t & 1, k0 = t * HT;
      const unsigned char* sK = smem + L::Q + s * 2 * L::KV;
      const unsigned char* sV = sK + L::KV;
      hopper::mbar_wait(&full[s], (t >> 1) & 1);

      float sacc[HT / 2];
      const uint64_t q_desc = kmajor<D>(sQ, 64 * c);
      const uint64_t k_desc = kmajor<D>(sK, 0);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<HT>::ss<0, 0>(sacc, q_desc + kstep<D>(HT, kk),
                                    k_desc + kstep<D>(HT, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<HT / 2>(sacc);

      // Online softmax in the log2 domain; masked entries -> NEG_INF for
      // the max and p = 0 by a select. Column 8 j + e' (e' = e & 1) of row
      // i is visible iff 8 j + e' <= lim[i]: on or left of the diagonal,
      // below Sk, in a row below S.
      const bool all = mask.full<64, HT>(qc0, k0);
      const int cx = hopper::opaque(col);
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lim[i] = rows[i] < S ? min(rows[i] + offset, Sk - 1) - k0 - cx : -1;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * j + e] * scale_log2;
          if (!all && 8 * j + (e & 1) > lim[e >> 1]) x = NEG_INF;
          sacc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        corr[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool vis = all || 8 * j + (e & 1) <= lim[e >> 1];
          const float p = vis ? exp2f(sacc[4 * j + e] - m[e >> 1]) : 0.0f;
          sacc[4 * j + e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= corr[e >> 1];

      uint32_t pa[HT / 4];
#pragma unroll
      for (int kk = 0; kk < HT / 16; ++kk) acc_to_a(sacc, kk, pa + 4 * kk);
      const uint64_t v_desc = mnmajor<D>(sV, HT, 0);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HT / 16; ++kk)
        hopper::Wgmma<D>::template rs<1>(oacc, pa + 4 * kk,
                                         v_desc + mnstep<D>(kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(oacc);
      hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lc = fmaxf(quad_sum(l[i]), 1e-30f);
      if (rows[i] >= S) continue;
      const float inv = 1.0f / lc;
      bf16* orow = o + ((size_t)bh * S + rows[i]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col) = hopper::pack_bf16(
            oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
      // A row that saw no key keeps m = NEG_INF: lse = NEG_INF + log(1e-30)
      // as the first kernels wrote it.
      if (lane % 4 == 0)
        lse[(size_t)bh * S + rows[i]] =
            (m[i] == NEG_INF ? NEG_INF : m[i] * LN2) + logf(lc);
    }
  }
}

// Shared memory of the dq kernel: the Q and dO tiles, then two stages of
// K and V tiles, then the barriers; plus slack for 1024-byte alignment.
template <int D> struct DqSmem {
  static constexpr int TILE = Tiles<D>::bytes(HT);
  static constexpr int STAGE0 = 2 * TILE;  // stage s: K, V
  static constexpr int BARS = STAGE0 + 4 * TILE;
  static constexpr int TOTAL = BARS + 64 + 1024;
};

// ------------------------------------------------------------ backward dq
// Replaces _bwd_dq_kernel (torchft_tpu/ops/flash_attention.py:344-377),
// grid (q tiles of 128 rows, B*H), heaviest causal tile first: dq = sum
// over k tiles of ds . k * scale, written once in f32 (the caller casts to
// the input dtype, as the TPU kernel's output block did); one block owns
// its q tile, so no atomics. Bound by the tensor cores at the slice's
// shapes (3 matmuls per visible entry, recompute included). Warpgroup 0
// is the producer: one thread loads the Q and dO tiles once and K/V tiles
// of 128 keys through a two-stage ring by TMA. Warpgroups 1 and 2 each own
// 64 query rows and keep their lse, delta and dQ in registers over the
// whole k loop; per k tile, S = Q K^T and dP = dO V^T by wgmma from
// shared memory into registers, p = exp(s scale - lse) and ds = p (dp -
// delta) on the accumulator layout (the fused kernel's formula, so that
// the two round alike), ds packed to bf16 in registers as wgmma's A
// operand for dQ += dS K (K read MN-major, as the forward reads V).
template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int H, int Hkv, int S, int Sk, int offset, float scale) {
  using T = Tiles<D>;
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  // Offset from the __shared__ array (not a round trip through an
  // integer) keeps every tile pointer a 32-bit shared address.
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + L::TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bars;       // [2] K/V stage loaded
  uint64_t* empty = bars + 2;  // [2] K/V stage released
  uint64_t* qbar = bars + 4;   // Q and dO loaded

  const int nqt = (S + HT - 1) / HT;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * HT;
  const int bh = blockIdx.y;
  const Mask mask{S, Sk, offset};
  const int nkt = mask.key_tiles<HT, HT>(q0);
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * NCONSUMERS);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && nkt > 0) {
      const int kvr = kv_row(bh, H, Hkv);
      hopper::mbar_expect_tx(qbar, 2 * L::TILE);
      for (int a = 0; a < T::NA; ++a) {
        hopper::tma_load_3d(sQ + a * HT * T::SW, &tm_q, qbar, a * T::AW, q0,
                            bh);
        hopper::tma_load_3d(sdO + a * HT * T::SW, &tm_do, qbar, a * T::AW,
                            q0, bh);
      }
      load_kv_ring<D>(smem + L::STAGE0, L::TILE, &tm_k, &tm_v, full, empty,
                      nkt, kvr);
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;                     // rows [64 c, 64 c + 64)
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qc0 = q0 + 64 * c;              // this consumer's first row
    const int rows[2] = {qc0 + 16 * w + lane / 4, qc0 + 16 * w + lane / 4 + 8};
    const int col = 2 * (lane % 4);           // first column in a chunk
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = rows[i] < S;
      lse_r[i] = ok ? lse[(size_t)bh * S + rows[i]] : 0.0f;
      delta_r[i] = ok ? delta[(size_t)bh * S + rows[i]] : 0.0f;
    }
    float qacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) qacc[i] = 0.0f;

    if (nkt > 0) hopper::mbar_wait(qbar, 0);
    const uint64_t q_desc = kmajor<D>(sQ, 64 * c);
    const uint64_t do_desc = kmajor<D>(sdO, 64 * c);
    for (int t = 0; t < nkt; ++t) {
      const int s = t & 1;
      const unsigned char* sK = smem + L::STAGE0 + s * 2 * L::TILE;
      const unsigned char* sV = sK + L::TILE;
      hopper::mbar_wait(&full[s], (t >> 1) & 1);
      const int k0 = t * HT;
      float sacc[HT / 2], pacc[HT / 2];
      const uint64_t k_desc = kmajor<D>(sK, 0);
      const uint64_t v_desc = kmajor<D>(sV, 0);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<HT>::ss<0, 0>(sacc, q_desc + kstep<D>(HT, kk),
                                    k_desc + kstep<D>(HT, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<HT>::ss<0, 0>(pacc, do_desc + kstep<D>(HT, kk),
                                    v_desc + kstep<D>(HT, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<HT / 2>(sacc);
      hopper::fence_regs<HT / 2>(pacc);

      // Column 8 j + e' (e' = e & 1) of row i is visible iff 8 j + e' <=
      // lim[i], as in the forward; ds overwrites dp in place.
      const bool all = mask.full<64, HT>(qc0, k0);
      const int cx = hopper::opaque(col);
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lim[i] = rows[i] < S ? min(rows[i] + offset, Sk - 1) - k0 - cx : -1;
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool vis = all || 8 * j + (e & 1) <= lim[e >> 1];
          const float p =
              vis ? expf(sacc[4 * j + e] * scale - lse_r[e >> 1]) : 0.0f;
          pacc[4 * j + e] = p * (pacc[4 * j + e] - delta_r[e >> 1]);
        }
      uint32_t da[HT / 4];
#pragma unroll
      for (int kk = 0; kk < HT / 16; ++kk) acc_to_a(pacc, kk, da + 4 * kk);

      const uint64_t k_mn = mnmajor<D>(sK, HT, 0);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HT / 16; ++kk)
        hopper::Wgmma<D>::template rs<1>(qacc, da + 4 * kk,
                                         k_mn + mnstep<D>(kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(qacc);
      // K and V of this stage are read.
      hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= S) continue;
      float* dqrow = dq + ((size_t)bh * S + rows[i]) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dqrow + 8 * j) = make_float2(
            qacc[4 * j + 2 * i] * scale, qacc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// Shared memory of the dk/dv loop: K and V tiles of 128 keys, with dq two
// dS^T tiles [128 keys, 64 q], two stages of Q and dO tiles of 64 rows and
// their lse / delta, then the barriers; plus slack for 1024-byte alignment.
template <int D, bool WITH_DQ> struct BwdSmem {
  static constexpr int KV = Tiles<D>::bytes(HT);
  static constexpr int DS = WITH_DQ ? HT * HQ_BWD * 2 : 0;
  static constexpr int QD = Tiles<D>::bytes(HQ_BWD);
  static constexpr int STAGE0 = 2 * KV + 2 * DS;  // stage s: Q, dO
  static constexpr int STATS = STAGE0 + 4 * QD;   // [2][lse 64, delta 64]
  static constexpr int BARS = STATS + 2 * 2 * HQ_BWD * 4;
  static constexpr int TOTAL = BARS + 64 + 1024;
};

// ------------------------------------------- dk/dv and fused backward
// The body of two kernels, grid (k tiles of 128 keys, B*H): with WITH_DQ
// the fused backward, without it the split dk/dv kernel. Bound by the
// tensor cores at the slice's shape (5 matmuls per visible entry with dq,
// 4 without). K and V stay in shared memory after one TMA load each;
// warpgroup 0 is the producer: one thread streams Q and dO tiles of 64
// rows by TMA through a two-stage ring, one warp loads their lse / delta.
// Warpgroups 1 and 2 each own 64 keys and take a q tile in two halves of
// 32 rows: S^T = K Q^T and dP^T = V dO^T by wgmma into registers, P^T and
// dS^T in registers, dV += P^T dO and dK += dS^T Q with A from registers
// (dK, dV stay in registers over the whole q loop). With WITH_DQ, dS^T
// also goes to shared memory once, and dQ = dS K is one wgmma product over
// all 128 keys and 64 q rows, each consumer taking one 64-column atom of D
// (consumer 0 alone below D = 128), added to the f32 dq buffer by vector
// atomics.
//
// The order of those adds is fixed (FA3's deterministic mode): k tiles add
// to the dq rows of a q tile from the last k tile down. dq_sem holds one
// zeroed int per (bh, q tile of 64 rows), the number of k tiles that have
// added there; the k tiles that visit the q tile at q0 are [0, J) with
// J = mask.key_tiles<HQ_BWD, HT>(q0) (a k tile's loop starts at
// first_q_tile, which grows with k0, so the visitors form a prefix), so k
// tile kt adds once the count reaches J - 1 - kt, then bumps it. A pair the
// mask skips neither waits nor is waited for. The consumers hold every
// register they have, so an idle warp of the producer warpgroup keeps the
// order: per q tile it waits for the turn (ld.acquire), lets the consumers
// add (DQ_TURN_BAR), waits until they have issued their adds
// (DQ_DONE_BAR) and bumps the count (red.release, cumulative over the
// adds the barrier ordered before it). Block x of row y takes k tile
// gridDim.x - 1 - x: a block waits only for blocks of lower blockIdx.x in
// its blockIdx.y, which the hardware dispatches before it and which keep
// their SM until they finish, so the wait cannot deadlock; keep the grid
// (k tiles, B*H). Under the causal mask the last k tile starts at the
// highest q tile, so each waits for k tiles that reached its q tile
// iterations earlier.
template <int D, bool WITH_DQ>
__device__ __forceinline__ void bwd_kv_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dq, int* __restrict__ dq_sem,
    int H, int Hkv, int S, int Sk, int offset, float scale) {
  using T = Tiles<D>;
  using L = BwdSmem<D, WITH_DQ>;
  extern __shared__ unsigned char smem_raw[];
  // Offset from the __shared__ array (not a round trip through an
  // integer) keeps every tile pointer a 32-bit shared address.
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::KV;
  unsigned char* sdS = smem + 2 * L::KV;  // [2][128 keys][64 q], swizzled
  float* stats = reinterpret_cast<float*>(smem + L::STATS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = bars;       // [2] Q/dO/lse/delta stage loaded
  uint64_t* empty = bars + 2;  // [2] stage released
  uint64_t* kvbar = bars + 4;

  const int kt = WITH_DQ ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int k0 = kt * HT, bh = blockIdx.y;
  const Mask mask{S, Sk, offset};
  const int nqb = (S + HQ_BWD - 1) / HQ_BWD;
  const int qi0 = mask.first_q_tile<HQ_BWD>(k0);
  const int nit = qi0 < nqb ? nqb - qi0 : 0;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // TMA thread + the stats warp
      hopper::mbar_init(&empty[s], 128 * NCONSUMERS);
    }
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0 && nit > 0) {
      const int kvr = kv_row(bh, H, Hkv);
      hopper::mbar_expect_tx(kvbar, 2 * L::KV);
      for (int a = 0; a < T::NA; ++a) {
        hopper::tma_load_3d(sK + a * HT * T::SW, tm_k, kvbar, a * T::AW, k0,
                            kvr);
        hopper::tma_load_3d(sV + a * HT * T::SW, tm_v, kvbar, a * T::AW, k0,
                            kvr);
      }
      // One thread, 24 registers: a rolled loop, addresses made per step.
#pragma unroll 1
      for (int it = 0; it < nit; ++it) {
        const int s = hopper::opaque(it & 1), q0 = (qi0 + it) * HQ_BWD;
        unsigned char* sQ = smem + L::STAGE0 + s * 2 * L::QD;
        unsigned char* sdO = sQ + L::QD;
        hopper::mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * L::QD);
        for (int a = 0; a < T::NA; ++a) {
          hopper::tma_load_3d(sQ + a * HQ_BWD * T::SW, tm_q, &full[s],
                              a * T::AW, q0, bh);
          hopper::tma_load_3d(sdO + a * HQ_BWD * T::SW, tm_do, &full[s],
                              a * T::AW, q0, bh);
        }
      }
    } else if (WITH_DQ && warp == 2) {
      // The dq order (see above). A wait far beyond any k tile's work
      // (2^26 reads, seconds) traps: a broken order fails the launch
      // instead of hanging the card.
#pragma unroll 1
      for (int it = 0; it < nit; ++it) {
        const int q0 = (qi0 + it) * HQ_BWD;
        int* sem = dq_sem + bh * nqb + q0 / HQ_BWD;
        if (lane == 0) {
          const int turn = mask.key_tiles<HQ_BWD, HT>(q0) - 1 - kt;
          for (int n = 0; hopper::ld_acquire(sem) != turn; ++n)
            if (n == 1 << 26) __trap();
        }
        __syncwarp();
        hopper::named_arrive(DQ_TURN_BAR, DQ_BAR_THREADS);
        hopper::named_barrier(DQ_DONE_BAR, DQ_BAR_THREADS);
        if (lane == 0) hopper::red_release(sem, 1);
      }
    } else if (warp == 1) {
      // lse / delta rows are S floats apart: no TMA alignment, plain loads.
#pragma unroll 1
      for (int it = 0; it < nit; ++it) {
        const int s = hopper::opaque(it & 1), q0 = (qi0 + it) * HQ_BWD;
        float* st = stats + s * 2 * HQ_BWD;
        hopper::mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
        for (int r = lane; r < HQ_BWD; r += 32) {
          const bool ok = q0 + r < S;
          st[r] = ok ? lse[(size_t)bh * S + q0 + r] : 0.0f;
          st[HQ_BWD + r] = ok ? delta[(size_t)bh * S + q0 + r] : 0.0f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    // This thread's lane indices are rederived inside the q loop from an
    // opaque copy of threadIdx.x rather than held in registers across it.
    const int c = wg - 1;                     // keys [k0 + 64 c, + 64)
    float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.0f;

    if (nit > 0) hopper::mbar_wait(kvbar, 0);
    for (int it = 0; it < nit; ++it) {
      const int s = it & 1, q0 = (qi0 + it) * HQ_BWD;
      const unsigned char* sQ = smem + L::STAGE0 + s * 2 * L::QD;
      const unsigned char* sdO = sQ + L::QD;
      const float* sLse = stats + s * 2 * HQ_BWD;
      const float* sDelta = sLse + HQ_BWD;
      unsigned char* dsT = sdS + (it & 1) * L::DS;
      hopper::mbar_wait(&full[s], (it >> 1) & 1);

      // The 64 q rows in two halves of HQ_HALF: per half, S^T = K Q^T,
      // P^T = exp(S^T scale - lse) in place, dP^T = V dO^T, dS^T = P^T
      // (dP^T - delta) in place, then dV += P^T dO and dK += dS^T Q over
      // the half's two k16 steps. One half at a time keeps dK, dV and
      // 64 x 32 tiles at most in registers.
      const int tid = hopper::opaque((int)threadIdx.x);
      const int lane = tid % 32, w = (tid / 32) % 4;
      const int krow = 64 * c + 16 * w + lane / 4;  // first key row, in tile
      const int keys[2] = {k0 + krow, k0 + krow + 8};
      const int cx = 2 * (lane % 4);                 // first column in a chunk
      const bool all = mask.full<HQ_BWD, 64>(q0, k0 + 64 * c);
      const int hi = S - q0 - cx;
      int lo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lo[i] = keys[i] < Sk ? keys[i] - offset - q0 - cx : HQ_BWD;
      const uint64_t k_desc = kmajor<D>(sK, 64 * c);
      const uint64_t v_desc = kmajor<D>(sV, 64 * c);
      const uint64_t do_mn = mnmajor<D>(sdO, HQ_BWD, 0);
      const uint64_t q_mn = mnmajor<D>(sQ, HQ_BWD, 0);
      // Rows krow and krow + 8 of dS^T both have r % 8 = lane / 4.
      unsigned char* ds_row = dsT + krow * 128 + 2 * cx;
      const int swz = lane / 4;
#pragma unroll
      for (int h = 0; h < HQ_BWD / HQ_HALF; ++h) {
        float sacc[HQ_HALF / 2], pacc[HQ_HALF / 2];
        const uint64_t q_desc = kmajor<D>(sQ, h * HQ_HALF);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::Wgmma<HQ_HALF>::ss<0, 0>(sacc, k_desc + kstep<D>(HT, kk),
                                           q_desc + kstep<D>(HQ_BWD, kk),
                                           kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<HQ_HALF / 2>(sacc);
        // Rows of S^T are keys, columns q rows: column q0 + cx + qc of
        // key row i is visible iff lo[i] <= qc < hi. p and ds follow the
        // dq kernel's formula (expf on the natural-log lse), so that the
        // fused and the split dq round alike.
#pragma unroll
        for (int j = 0; j < HQ_HALF / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = h * HQ_HALF + 8 * j + (e & 1);
            const bool vis = all || (qc >= lo[e >> 1] && qc < hi);
            sacc[4 * j + e] =
                vis ? expf(sacc[4 * j + e] * scale - sLse[cx + qc]) : 0.0f;
          }

        const uint64_t do_desc = kmajor<D>(sdO, h * HQ_HALF);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::Wgmma<HQ_HALF>::ss<0, 0>(pacc, v_desc + kstep<D>(HT, kk),
                                           do_desc + kstep<D>(HQ_BWD, kk),
                                           kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<HQ_HALF / 2>(pacc);
#pragma unroll
        for (int j = 0; j < HQ_HALF / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = h * HQ_HALF + 8 * j + (e & 1);
            pacc[4 * j + e] =
                sacc[4 * j + e] * (pacc[4 * j + e] - sDelta[cx + qc]);
          }
        uint32_t pa[HQ_HALF / 4], da[HQ_HALF / 4];
#pragma unroll
        for (int kk = 0; kk < HQ_HALF / 16; ++kk) {
          acc_to_a(sacc, kk, pa + 4 * kk);
          acc_to_a(pacc, kk, da + 4 * kk);
        }
        // dS^T to shared memory, [128 keys][64 q] with the 128-byte
        // swizzle (16-byte chunk jj of row r at chunk jj ^ (r % 8)): dQ's
        // A operand, MN-major. This thread's columns of 8-column chunk j
        // lie in chunk jj = h * HQ_HALF / 8 + j, and its (row i, columns
        // col, col + 1) pair is register da[4 (j / 2) + 2 (j % 2) + i]
        // (acc_to_a's order).
        if constexpr (WITH_DQ) {
#pragma unroll
          for (int j = 0; j < HQ_HALF / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              *reinterpret_cast<uint32_t*>(
                  ds_row + i * 8 * 128 +
                  (((h * HQ_HALF / 8 + j) ^ swz) << 4)) =
                  da[4 * (j / 2) + 2 * (j % 2) + i];
        }

        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HQ_HALF / 16; ++kk) {
          const int step = h * HQ_HALF / 16 + kk;
          hopper::Wgmma<D>::template rs<1>(dvacc, pa + 4 * kk,
                                           do_mn + mnstep<D>(step), 1);
          hopper::Wgmma<D>::template rs<1>(dkacc, da + 4 * kk,
                                           q_mn + mnstep<D>(step), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<D / 2>(dvacc);
        hopper::fence_regs<D / 2>(dkacc);
      }
      if constexpr (WITH_DQ) hopper::fence_async_smem();
      // Q, dO, lse and delta of this stage are read.
      hopper::mbar_arrive(&empty[s]);
      if constexpr (WITH_DQ) {
        // Both consumers' rows of dS^T are written.
        hopper::named_barrier(CONSUMER_BAR, 128 * NCONSUMERS);
        // dQ: consumer c takes atom c of D's columns; below D = 128 there is
        // one atom and consumer 0 takes it.
        const bool does_dq = c < T::NA;
        float qacc[T::AW / 2];
        if (does_dq) {
          // dS^T rows are 128 bytes (64 q), whatever D.
          const uint64_t ds_desc = hopper::desc(dsT, HT * 128, 1024, 128);
          const uint64_t k_mn = mnmajor<D>(sK, HT, c);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HT / 16; ++kk)
            hopper::Wgmma<T::AW>::template ss<1, 1>(
                qacc, ds_desc + ((kk * 16 * 128) >> 4), k_mn + mnstep<D>(kk),
                kk > 0);
          hopper::wgmma_commit();
        }
        hopper::wgmma_wait<0>();
        // This k tile's turn at the q tile (the order warp).
        hopper::named_barrier(DQ_TURN_BAR, DQ_BAR_THREADS);
        if (does_dq) {
          hopper::fence_regs<T::AW / 2>(qacc);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = q0 + 16 * w + lane / 4 + 8 * i;
            if (q >= S) continue;
            float* dqrow = dq + ((size_t)bh * S + q) * D + c * T::AW + cx;
#pragma unroll
            for (int j = 0; j < T::AW / 8; ++j)
              atomicAdd(reinterpret_cast<float2*>(dqrow + 8 * j),
                        make_float2(qacc[4 * j + 2 * i] * scale,
                                    qacc[4 * j + 2 * i + 1] * scale));
          }
        }
        // This k tile's adds are issued: the order warp's release, which
        // the barrier orders after them (CUTLASS's arrive_inc), passes the
        // turn on.
        hopper::named_arrive(DQ_DONE_BAR, DQ_BAR_THREADS);
      }
    }

    const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
    const int col = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + 64 * c + 16 * w + lane / 4 + 8 * i;
      if (key >= Sk) continue;
      const size_t off = ((size_t)bh * Sk + key) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = hopper::pack_bf16(
            dkacc[4 * j + 2 * i] * scale, dkacc[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = hopper::pack_bf16(
            dvacc[4 * j + 2 * i], dvacc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------ fused backward (wgmma)
// Replaces _bwd_fused_kernel (torchft_tpu/ops/flash_attention.py:420-483).
template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_bwd_fused_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ dq,
                      int* __restrict__ dq_sem, int H, int Hkv, int S, int Sk,
                      int offset, float scale) {
  bwd_kv_body<D, true>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, dq,
                       dq_sem, H, Hkv, S, Sk, offset, scale);
}

// ----------------------------------------------------- backward dk/dv
// Replaces _bwd_dkdv_kernel (torchft_tpu/ops/flash_attention.py:380-417):
// the fused kernel's body without dq. dk/dv are written per QUERY head;
// the caller sums the heads that share a kv head, as kv_from_bh does.
template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Hkv, int S, int Sk,
                     int offset, float scale) {
  bwd_kv_body<D, false>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv,
                        nullptr, nullptr, H, Hkv, S, Sk, offset, scale);
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

// TMA maps of the [n, len, D] bf16 tensors a wgmma kernel reads, with
// boxes of `rows` rows; false if one cannot be encoded.
template <int D>
bool maps(CUtensorMap* m, const void* const* ptrs, const int* ns,
          const int* lens, const int* rows, int count) {
  for (int i = 0; i < count; ++i)
    if (!hopper::map_rows(&m[i], ptrs[i], ns[i], lens[i], D, rows[i],
                          Tiles<D>::AW))
      return false;
  return true;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int H, int Hkv, int S, int Sk,
                       int causal, int shift, float scale, cudaStream_t st) {
  constexpr int smem = FwdSmem<D>::TOTAL;
  cudaError_t e = prepare(flash_fwd_wgmma<D>, smem);
  if (e != cudaSuccess) return e;
  const int BHkv = BH / H * Hkv;
  CUtensorMap m[3];
  const void* ptrs[3] = {q, k, v};
  const int ns[3] = {BH, BHkv, BHkv}, lens[3] = {S, Sk, Sk};
  const int rows[3] = {HT, HT, HT};
  if (!maps<D>(m, ptrs, ns, lens, rows, 3)) return cudaErrorInvalidValue;
  dim3 grid((S + HT - 1) / HT, BH);
  flash_fwd_wgmma<D><<<grid, HTHREADS, smem, st>>>(
      m[0], m[1], m[2], (bf16*)o, (float*)lse, H, Hkv, S, Sk,
      mask_offset(S, Sk, causal, shift), scale * LOG2E);
  return cudaGetLastError();
}

// TMA maps of q, k, v and do for a backward kernel: boxes of `qrows` rows
// for q and do, of HT for k and v.
template <int D>
bool bwd_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
              const void* dout, int BH, int H, int Hkv, int S, int Sk,
              int qrows) {
  const int BHkv = BH / H * Hkv;
  const void* ptrs[4] = {q, k, v, dout};
  const int ns[4] = {BH, BHkv, BHkv, BH}, lens[4] = {S, Sk, Sk, S};
  const int rows[4] = {qrows, HT, HT, qrows};
  return maps<D>(m, ptrs, ns, lens, rows, 4);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int H, int Hkv, int S, int Sk,
                      int causal, int shift, float scale, cudaStream_t st) {
  constexpr int smem = DqSmem<D>::TOTAL;
  cudaError_t e = prepare(flash_bwd_dq_wgmma<D>, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];
  if (!bwd_maps<D>(m, q, k, v, dout, BH, H, Hkv, S, Sk, HT))
    return cudaErrorInvalidValue;
  dim3 grid((S + HT - 1) / HT, BH);
  flash_bwd_dq_wgmma<D><<<grid, HTHREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
      (float*)dq, H, Hkv, S, Sk, mask_offset(S, Sk, causal, shift), scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int BH, int H, int Hkv, int S,
                      int Sk, int causal, int shift, float scale,
                      cudaStream_t st) {
  constexpr int smem = BwdSmem<D, false>::TOTAL;
  cudaError_t e = prepare(flash_bwd_dkdv_wgmma<D>, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];
  if (!bwd_maps<D>(m, q, k, v, dout, BH, H, Hkv, S, Sk, HQ_BWD))
    return cudaErrorInvalidValue;
  dim3 grid((Sk + HT - 1) / HT, BH);
  flash_bwd_dkdv_wgmma<D><<<grid, HTHREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, H, Hkv, S, Sk, mask_offset(S, Sk, causal, shift),
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fused(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, void* dq, void* dq_sem, int BH,
                         int H, int Hkv, int S, int Sk, int causal, int shift,
                         float scale, cudaStream_t st) {
  constexpr int smem = BwdSmem<D, true>::TOTAL;
  cudaError_t e = prepare(flash_bwd_fused_wgmma<D>, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap m[4];
  if (!bwd_maps<D>(m, q, k, v, dout, BH, H, Hkv, S, Sk, HQ_BWD))
    return cudaErrorInvalidValue;
  dim3 grid((Sk + HT - 1) / HT, BH);
  flash_bwd_fused_wgmma<D><<<grid, HTHREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
      (bf16*)dk, (bf16*)dv, (float*)dq, (int*)dq_sem, H, Hkv, S, Sk,
      mask_offset(S, Sk, causal, shift), scale);
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
  TFT_DISPATCH_D(D, (int)launch_kv<DD>(q, k, v, dout, lse, delta, dk, dv,
                                       BH, H, Hkv, S, Sk, causal, shift,
                                       scale, (cudaStream_t)stream))
}

// dq_sem: BH * ceil(S / 64) zeroed ints, the fixed order's semaphores.
int tft_flash_bwd_fused(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, void* dq, void* dq_sem, int BH,
                        int H, int Hkv, int S, int Sk, int D, int causal,
                        int shift, float scale, void* stream) {
  TFT_DISPATCH_D(D, (int)launch_fused<DD>(q, k, v, dout, lse, delta, dk,
                                          dv, dq, dq_sem, BH, H, Hkv, S, Sk,
                                          causal, shift, scale,
                                          (cudaStream_t)stream))
}

const char* tft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
