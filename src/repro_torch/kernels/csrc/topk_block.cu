// Row-batched block-local top-k magnitude mask for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_select.py::topk_mask_pallas
//   (one Pallas grid cell per 8192-element slice, body _topk_mask_kernel).
//
// What it computes, per row r of x (C, N) f32 and per slice b of 8192
// elements of that row (the tail slice zero-padded, as the reference pads):
//   mag = |x|, hi = max(mag), lo = 0
//   32 times: mid = 0.5 * (lo + hi)
//             count(mag >= mid) >= k ? lo = mid : hi = mid
//   out = mag >= lo                           (bool)
// with k = max(int(8192 * frac), 1) from the slice size, not from N.  The
// reference's f32 runs with subnormals flushed to zero (XLA on the CPU, and
// the TPU), so a subnormal magnitude, and a subnormal mid, count as 0 here.
// A NaN makes hi NaN (as jnp.max does), every mid NaN and no count reach k:
// lo stays 0.  So does k > 8192.
//
// What bounds it on this card: bytes.  The least traffic is one read of x
// (4 B) and one write of the mask (1 B) per element: at the main path's
// shape (8 x 267,009) 10.7 MB, ~3.2 us at 3.35 TB/s.  The bisection done as
// written is 32 block-wide counts in a row; in the earlier kernel of this
// file that chain took 0.88 of its time (PERF.md).
//
// Design: one CTA of 256 threads per (row, slice), two CTAs per SM (the
// grid of the main shape, 8 x 33 slices, is one wave).  A bisection step
// asks only whether count(mag >= mid) >= k, which holds exactly when
// v_k >= mid, v_k the k-th largest magnitude of the zero-padded slice.  So
// the kernel finds v_k exactly and replays the 32 steps on scalars:
//   * Each thread loads its 4-byte words of the slice's mask frame (9 words
//     of 4 elements: a slice whose mask does not start 4-byte aligned spans
//     2049) into registers as |x| bit patterns, with 16-byte loads where x is
//     aligned as the mask is, and reduces their maximum with redux.sync (a
//     NaN pattern lies above +inf, so a NaN max stays NaN).
//   * A radix select over the 31-bit patterns in shared memory: pass 0
//     counts every element into a 256-bin histogram of bits 23..30; passes 1
//     to 3 (bits 15..22, 7..14, 0..6) count the elements that match the bits
//     fixed so far.  Every element is counted without a branch (one that
//     does not match, or lies outside the slice, into a spare bin), so each
//     count is one warp-aggregated shared atomic; the histograms are zeroed
//     up front.  After each pass warp 0 picks the bin that holds v_k and
//     hands it on through shared memory.
//   * As soon as at most 32 elements share the fixed bits (after pass 1 for
//     data of one scale), they are gathered into shared memory instead and
//     warp 0 ranks them, which ends the select one or two passes early.
//   * Warp 0 replays the 32 steps from (hi, v_k) in registers, each mid
//     rounded on its own (__fadd_rn, __fmul_rn, never contracted), and every
//     thread writes its words of the mask as 4-byte stores, single bytes at
//     the slice's edges.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_cluster.cuh"   // ROW_CLUSTER_STAMP (profile_codec --stamps), pack4

namespace {

constexpr int kBlock = 8192;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;                // per SM: up to 128 registers
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kBlock / 4 / kThreads + 1;   // one spare for word 2048
constexpr int kBins = 256;
constexpr int kRow = kBins + 4;              // bin 256 takes the non-matching
constexpr int kPasses = 4;
constexpr int kIters = 32;
constexpr uint32_t kGather = 32;             // candidates one warp takes
constexpr uint32_t kOutside = 0x80000000u;   // a slot outside the slice
constexpr uint32_t kMinNormal = 0x00800000u;
constexpr uint32_t kInf = 0x7F800000u;

// |v| as its bit pattern, a subnormal as 0: the patterns' order is the
// magnitudes' order, with NaN above +inf
__device__ __forceinline__ uint32_t mag_bits(float v) {
  const uint32_t b = __float_as_uint(v) & 0x7FFFFFFFu;
  return b < kMinNormal ? 0u : b;
}

// What the select has fixed: the top bits of v_k's pattern, v_k's rank
// among the elements that share them, and how many elements share them.
struct Fixed {
  uint32_t prefix, krem, cnt;
};

// The CTA's shared memory.
struct alignas(16) Smem {
  unsigned int hist[kPasses][kRow];
  uint32_t warp_max[kWarps];
  uint32_t list[kGather];
  unsigned int listed;
  Fixed fixed;
  float lo;
};

// Warp 0 reads a pass's histogram h and fixes the bin that holds the
// krem-th largest of the elements the pass counted (its digit at `shift`);
// every thread gets the result through shared memory.
__device__ __forceinline__ Fixed pick(const unsigned int* h, int shift,
                                      Fixed f, Smem& sm) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint4 a = reinterpret_cast<const uint4*>(h)[2 * lane];
    const uint4 b = reinterpret_cast<const uint4*>(h)[2 * lane + 1];
    const unsigned int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const unsigned int own = ((v[0] + v[1]) + (v[2] + v[3])) +
                             ((v[4] + v[5]) + (v[6] + v[7]));
    unsigned int suffix = own;         // the counts of this lane's bins on
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int up = __shfl_down_sync(0xFFFFFFFFu, suffix, off);
      suffix += lane + off < 32 ? up : 0u;
    }
    // the bins' ranges (acc, acc + v[j]] tile (suffix - own, suffix]
    unsigned int acc = suffix - own;
    uint32_t bin = 0u, krem = 0u, cnt = 0u;
    bool hit = false;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      const bool in = acc < f.krem && f.krem <= acc + v[j];
      bin = in ? 8u * lane + j : bin;
      krem = in ? f.krem - acc : krem;
      cnt = in ? v[j] : cnt;
      hit |= in;
      acc += v[j];
    }
    if (hit) sm.fixed = {f.prefix | (bin << shift), krem, cnt};
  }
  __syncthreads();
  return sm.fixed;
}

// Warp 0: the krem-th largest of list[0 .. cnt), cnt <= 32: lane l counts
// the entries above its own and at it, and the lane whose range of ranks
// holds krem has v_k.
__device__ __forceinline__ uint32_t warp_select(const Smem& sm, const Fixed& f,
                                                int lane) {
  const bool live = lane < static_cast<int>(f.cnt);
  const uint32_t v = live ? sm.list[lane] : 0u;
  uint32_t gt[4] = {0u, 0u, 0u, 0u}, ge[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t u = __shfl_sync(0xFFFFFFFFu, v, j);
    const bool in = j < static_cast<int>(f.cnt);
    gt[j & 3] += in && u > v;
    ge[j & 3] += in && u >= v;
  }
  const uint32_t g = (gt[0] + gt[1]) + (gt[2] + gt[3]);
  const uint32_t e = (ge[0] + ge[1]) + (ge[2] + ge[3]);
  const int src = __ffs(__ballot_sync(0xFFFFFFFFu,
                                      live && g < f.krem && f.krem <= e)) - 1;
  return __shfl_sync(0xFFFFFFFFu, v, src);
}

// The reference's 32 bisection steps from hi, count(mag >= mid) >= k read
// as v_k >= mid, each mid rounded on its own (__fadd_rn, __fmul_rn) and
// flushed to 0 where it is subnormal.
__device__ __forceinline__ float replay(uint32_t hi, uint32_t vk_bits) {
  const float vk = __uint_as_float(vk_bits);
  float lo = 0.0f, h = __uint_as_float(hi);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    float mid = __fmul_rn(0.5f, __fadd_rn(lo, h));
    mid = mid < __uint_as_float(kMinNormal) ? 0.0f : mid;
    const bool take = vk >= mid;
    lo = take ? mid : lo;
    h = take ? h : mid;
  }
  return lo;
}

// grid (slices per row, rows); x: (rows, n) f32, out: (rows, n) bool.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
topk_block(const float* __restrict__ x, uint8_t* __restrict__ out, long long n,
           int k) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  ROW_CLUSTER_STAMP(0);
  for (int i = tid; i < kPasses * kRow; i += kThreads) (&sm.hist[0][0])[i] = 0u;
  if (tid == 0) sm.listed = 0u;

  const long long j0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int len = static_cast<int>(min(static_cast<long long>(kBlock), n - j0));
  const float* xs = x + static_cast<long long>(blockIdx.y) * n + j0;
  uint8_t* os = out + static_cast<long long>(blockIdx.y) * n + j0;
  // word w of the mask frame holds slice elements 4w - m .. 4w - m + 3
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(os) & 3);
  const bool vec =
      static_cast<int>((reinterpret_cast<uintptr_t>(xs) >> 2) & 3) == m;

  uint32_t bits[kWords][4];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int jw = 4 * (tid + kThreads * i) - m;
    if (vec && jw >= 0 && jw + 4 <= len) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xs + jw));
      bits[i][0] = mag_bits(v.x);
      bits[i][1] = mag_bits(v.y);
      bits[i][2] = mag_bits(v.z);
      bits[i][3] = mag_bits(v.w);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jw + c;
        bits[i][c] = (j < 0 || j >= kBlock) ? kOutside
                     : j < len              ? mag_bits(__ldg(xs + j))
                                            : 0u;   // the zero padding
      }
    }
  }
  ROW_CLUSTER_STAMP(1);
  __syncthreads();                     // the histograms are zeroed

  // pass 0: bits 23..30, every element (kOutside lands in bin 256); no
  // branch, so the compiler issues one aggregated shared atomic per element
  uint32_t mx = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      atomicAdd(&sm.hist[0][bits[i][c] >> 23], 1u);
      mx = max(mx, bits[i][c] & 0x7FFFFFFFu);
    }
  }
  mx = __reduce_max_sync(0xFFFFFFFFu, mx);
  if (lane == 0) sm.warp_max[warp] = mx;
  __syncthreads();
  ROW_CLUSTER_STAMP(2);
  uint32_t hi = sm.warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) hi = max(hi, sm.warp_max[w]);

  float lo = 0.0f;
  if (hi <= kInf && k <= kBlock) {      // else lo stays 0, as in the reference
    Fixed f = pick(sm.hist[0], 23, {0u, static_cast<uint32_t>(k), 0u}, sm);
    ROW_CLUSTER_STAMP(3);
    int above = 23;                     // bits above..30 of v_k are fixed
    // passes 1..3 (bits 15..22, 7..14, 0..6) until few elements are left
#pragma unroll
    for (int p = 1; p < kPasses; ++p) {
      if (f.cnt <= kGather) break;
      const int shift = p < 3 ? above - 8 : 0;
      // an element matches the fixed bits iff its bits shift..30 lie in
      // [base, base + width): it counts into its digit's bin, else bin 256
      const uint32_t width = p < 3 ? 256u : 128u;
      const uint32_t base = (f.prefix >> above) << (above - shift);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t d = (bits[i][c] >> shift) - base;
          atomicAdd(&sm.hist[p][d < width ? d : kBins], 1u);
        }
      }
      __syncthreads();
      ROW_CLUSTER_STAMP(2 + 2 * p);
      f = pick(sm.hist[p], shift, f, sm);
      ROW_CLUSTER_STAMP(3 + 2 * p);
      above = shift;
    }
    if (above > 0) {                    // gather the f.cnt <= 32 candidates
      const uint32_t fixed = f.prefix >> above;
      bool any = false;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) any |= (bits[i][c] >> above) == fixed;
      }
      if (__any_sync(0xFFFFFFFFu, any)) {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if ((bits[i][c] >> above) == fixed) {
              sm.list[atomicAdd(&sm.listed, 1u)] = bits[i][c];
            }
          }
        }
      }
      __syncthreads();
      ROW_CLUSTER_STAMP(10);
    }
    if (warp == 0) {
      const uint32_t vk = above > 0 ? warp_select(sm, f, lane) : f.prefix;
      ROW_CLUSTER_STAMP(11);
      lo = replay(hi, vk);
      if (lane == 0) sm.lo = lo;
    }
    __syncthreads();
    lo = sm.lo;
  }
  ROW_CLUSTER_STAMP(12);

#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int jw = 4 * (tid + kThreads * i) - m;
    uint32_t keep[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) keep[c] = __uint_as_float(bits[i][c]) >= lo;
    if (jw >= 0 && jw + 4 <= len) {
      *reinterpret_cast<uint32_t*>(os + jw) =
          row_cluster::pack4(keep[0], keep[1], keep[2], keep[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jw + c;
        if (j >= 0 && j < len) os[j] = static_cast<uint8_t>(keep[c]);
      }
    }
  }
  ROW_CLUSTER_STAMP(13);
}

}  // namespace

extern "C" {

// x: (rows, n) f32 contiguous; out: (rows, n) bool.  k >= 1 is the per-slice
// count (from the slice size; over 8192 every entry but a NaN is kept).
// Returns the CUDA error code of the launch.
int topk_mask_block_rows(const float* x, bool* out, int rows, long long n,
                         int k, cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slices = (n + kBlock - 1) / kBlock;
  if (slices > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(slices), rows);
  topk_block<<<grid, kThreads, 0, stream>>>(
      x, reinterpret_cast<uint8_t*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
