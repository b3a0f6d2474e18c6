// State attestation words for Hopper (sm_90a): the committed state's four
// u32 words in one pass over its bytes, written by hand.
//
// Counterpart of the XLA-jitted _attest_device_words
// (torchft_tpu/manager.py:5223-5307), itself frozen to the numpy
// reference serialization.attest_fingerprint. For every leaf, in pytree
// order, over its raw bytes b_i (i from 0):
//   w0 = sum b_i,  w1 = sum (i + 1) b_i,  n32 = nbytes,   all mod 2^32,
// then the FNV-style fold of (w0, w1, n32) into four accumulator words.
//
// Bound by memory: every byte of the state is read once (8.003 GB at the
// ft cell, 2.39 ms at 3.35 TB/s) for a few integer operations a byte. The
// design keeps it one read: blocks stride over each leaf in 16-byte
// vector loads, take a vector's byte sum and its in-vector weighted sum
// with two dp4a per 32-bit word, and reduce in registers, then per block
// (warp shuffles, shared memory), then across blocks with u32 atomicAdd.
// Integer addition mod 2^32 is associative and commutative, so the words
// are bitwise the same whatever the order of those adds. A second,
// single-thread kernel folds the leaves' words in pytree order.
//
// A leaf whose bytes live on the host (a CPU scalar of the optimizer
// state) enters with its words already computed: the caller seeds its
// row of `sums` and gives it a null pointer. Kernels allocate nothing and
// do not synchronise; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t FNV_PRIME = 0x01000193u;
constexpr uint32_t FNV_BASIS = 0x811C9DC5u;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads an SM

// Adds the bytes at [offset, offset + 16) of a leaf, held in x, to the
// running (w0, w1): w0 += sum b_k, w1 += sum (offset + k + 1) b_k.
__device__ __forceinline__ void add_vec(uint4 x, uint32_t offset,
                                        uint32_t& w0, uint32_t& w1) {
  const uint32_t ones = 0x01010101u, ramp = 0x03020100u;
  const uint32_t s0 = __dp4a(x.x, ones, 0u), s1 = __dp4a(x.y, ones, 0u);
  const uint32_t s2 = __dp4a(x.z, ones, 0u), s3 = __dp4a(x.w, ones, 0u);
  // sum k b_k over the vector: word m holds bytes 4m .. 4m + 3.
  uint32_t ws = __dp4a(x.x, ramp, 0u);
  ws = __dp4a(x.y, ramp, ws);
  ws = __dp4a(x.z, ramp, ws);
  ws = __dp4a(x.w, ramp, ws);
  ws += 4u * (s1 + 2u * s2 + 3u * s3);
  const uint32_t bs = s0 + s1 + s2 + s3;
  w0 += bs;
  w1 += (offset + 1u) * bs + ws;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid-stride over every leaf: table[2 l] is leaf l's device address
// (0 for a host leaf), table[2 l + 1] its byte count; sums[2 l] and
// sums[2 l + 1] collect its w0 and w1.
__global__ void __launch_bounds__(THREADS)
attest_leaf_sums(const int64_t* __restrict__ table, int nleaves,
                 uint32_t* __restrict__ sums) {
  __shared__ uint32_t part[2][THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int l = 0; l < nleaves; ++l) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(table[2 * l]);
    const uint64_t n = (uint64_t)table[2 * l + 1];
    if (p == nullptr) continue;
    // Bytes before the first 16-byte boundary, the vectors, the tail.
    uint64_t head = (16u - ((uintptr_t)p & 15u)) & 15u;
    if (head > n) head = n;
    const uint64_t nv = (n - head) / 16;
    const uint64_t body_end = head + 16 * nv;
    const uint64_t first = (uint64_t)blockIdx.x * THREADS;
    // Uniform over the block: nothing of this leaf is ours.
    if (first >= nv && blockIdx.x != 0) continue;
    uint32_t w0 = 0, w1 = 0;
    const uint4* v = reinterpret_cast<const uint4*>(p + head);
    const uint64_t stride = (uint64_t)gridDim.x * THREADS;
#pragma unroll 4
    for (uint64_t i = first + threadIdx.x; i < nv; i += stride)
      add_vec(__ldcs(v + i), (uint32_t)(head + 16 * i), w0, w1);
    if (blockIdx.x == 0 && warp == 0) {
      // The edges, a byte a lane: head bytes on lanes 0-15, tail bytes
      // on lanes 16-31 (fewer than 16 of each).
      const uint64_t at = lane < 16 ? (uint64_t)lane : body_end + lane - 16;
      if (lane < 16 ? at < head : at < n) {
        const uint32_t b = p[at];
        w0 += b;
        w1 += ((uint32_t)at + 1u) * b;
      }
    }
    w0 = warp_sum(w0);
    w1 = warp_sum(w1);
    if (lane == 0) {
      part[0][warp] = w0;
      part[1][warp] = w1;
    }
    __syncthreads();
    if (warp == 0) {
      w0 = lane < THREADS / 32 ? part[0][lane] : 0u;
      w1 = lane < THREADS / 32 ? part[1][lane] : 0u;
      w0 = warp_sum(w0);
      w1 = warp_sum(w1);
      if (lane == 0) {
        atomicAdd(&sums[2 * l], w0);
        atomicAdd(&sums[2 * l + 1], w1);
      }
    }
    __syncthreads();  // part is reused by the next leaf
  }
}

// The fold across leaves, in order, on one thread: out = the four words.
__global__ void attest_fold(const int64_t* __restrict__ table, int nleaves,
                            const uint32_t* __restrict__ sums,
                            uint32_t* __restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  uint32_t a0 = FNV_BASIS, a1 = FNV_BASIS, a2 = FNV_BASIS, a3 = FNV_BASIS;
  for (int l = 0; l < nleaves; ++l) {
    const uint32_t w0 = sums[2 * l], w1 = sums[2 * l + 1];
    const uint32_t n32 = (uint32_t)(uint64_t)table[2 * l + 1];
    const uint32_t rot = (w1 << 1) | (w1 >> 31);
    a0 = a0 * FNV_PRIME + w0;
    a1 = a1 * FNV_PRIME + w1;
    a2 = a2 * FNV_PRIME + n32;
    a3 = (a3 ^ w0 ^ rot) * FNV_PRIME;
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
  out[3] = a3;
}

}  // namespace

extern "C" {

// table: [nleaves][2] int64 (device address or 0, byte count) on the
// card; sums: [nleaves][2] u32, zero for card leaves and the host-computed
// words of host leaves; out: 4 u32.
int tft_attest_words(const void* table, int nleaves, void* sums, void* out,
                     void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (nleaves > 0)
    attest_leaf_sums<<<sms * BLOCKS_PER_SM, THREADS, 0, st>>>(
        (const int64_t*)table, nleaves, (uint32_t*)sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attest_fold<<<1, 32, 0, st>>>((const int64_t*)table, nleaves,
                                (const uint32_t*)sums, (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* tft_attest_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
