// Row-batched exact global top-k magnitude mask for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_select.py::topk_mask_pallas_global
//   (two Pallas passes with a 31-step integer bisection in XLA between them,
//   called once per user row from core/approaches.py:224-227).
//
// What it computes, per row r of x (C, N) f32:
//   bits = float_as_uint(x) & 0x7FFFFFFF     (|x| as an ordered int)
//   t    = the k-th largest bits of the row    (k = max(int(N*frac), 1))
//   out  = bits >= t                           (ties kept, bool)
// which is exactly jax.lax.top_k's threshold: bitwise the reference's mask.
//
// What bounds it on this card: bytes.  The work is a handful of integer ops
// per element; the least traffic is one read of x (4 B) and one write of the
// mask (1 B) per element.  At the main path's shape (8 x 267,009) that is
// 10.7 MB, ~3.2 us at 3.35 TB/s.  A radix select needs several passes over
// the row with a row-wide decision between them, and the decisions, not
// the bytes, are what cost: as separate launches (4 histogram passes, 4
// one-block digit picks, a mask pass, a zeroed global histogram) the
// select took 10 launches and 32 us of device time a call on an H100.
//
// Design: one launch, one thread-block cluster of row_cluster::kCluster = 8
// CTAs per row (a (8, rows) grid, so rows beyond one wave run in later
// waves with no grid-wide sync).
//   * Each CTA copies its slice of the row (about N / 8 elements) into
//     shared memory once, with bulk copies (row_cluster.cuh); the first
//     pass counts each piece as it lands.  A slice that does not fit in
//     the shared memory the lane histogram leaves (N > ~0.36 M on an H100)
//     is read from device memory in every pass instead.
//   * 4 digit passes over the 31-bit patterns, 8 bits each (bits 24..30,
//     16..23, 8..15, 0..7): every CTA counts its elements that still match
//     the prefix fixed so far into a 256-bin histogram.  The first digit
//     holds the exponent, so a few bins take most of a row: the histogram
//     has one column per lane (bin * 32 + lane), so the 32 increments of a
//     warp never hit one address or one bank, and the columns are summed
//     afterwards.  (Warp-aggregated increments with __match_any_sync, and
//     plain atomics into one column, were slower; see PERF.md.)
//   * Each CTA pushes its histogram into every CTA of the cluster through
//     distributed shared memory; after one cluster barrier every CTA sums
//     the cluster's histograms from its own shared memory and makes the
//     same pick: a suffix scan over the bins fixes the digit that holds the
//     remaining k-th element and subtracts the counts above it from k.
//     Every CTA computes the pick itself, in the same integer arithmetic, so
//     no second barrier broadcasts it; the pushed histograms are
//     double-buffered by pass.  8-bit digits keep a push at 256 words.
//   * When the picked bin is taken whole, no element lies between the k-th
//     largest pattern and the prefix, so the passes stop early with the
//     same mask.  After the last pass each CTA writes its slice of the mask
//     from shared memory as 4-byte words.
// Nothing is allocated beyond the mask and nothing is zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using row_cluster::kCluster;
using row_cluster::Slice;

constexpr int kThreads = 1024;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr int kGroups = kThreads / kBins;       // threads per bin
constexpr int kLaneHistBytes = kBins * 32 * 4;  // one column per lane
static_assert(kCluster % kGroups == 0, "each group pushes to whole ranks");

constexpr int kStampEnd = 2 + 4 * kPasses;      // after the mask store

__device__ __forceinline__ uint32_t mag_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

template <bool kInSmem>
__global__ void __launch_bounds__(kThreads)
topk_mask_cluster(const float* __restrict__ x, long long n, int k,
                  uint8_t* __restrict__ out) {
  // every CTA's histogram of a pass, pushed by each CTA of the cluster;
  // double-buffered by pass
  __shared__ unsigned int hall[2][kCluster][kBins];
  __shared__ unsigned int part[kGroups][kBins];
  __shared__ unsigned int warp_total[kBins / 32];
  __shared__ uint32_t pick[3];
  __shared__ uint64_t bars[row_cluster::kChunks];
  extern __shared__ uint4 dyn[];
  unsigned int* lh = reinterpret_cast<unsigned int*>(dyn);
  float* xs = reinterpret_cast<float*>(dyn) + kBins * 32;

  ROW_CLUSTER_STAMP(0);
  row_cluster::cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long rbase = static_cast<long long>(blockIdx.y) * n;
  const float* xr = x + rbase;
  const Slice s = row_cluster::slice_of(xr, n, rank);
  const float* xg = xr + s.lo;                   // the slice in device memory
  if constexpr (kInSmem) row_cluster::load_slice(xr, s, xs, bars);
  ROW_CLUSTER_STAMP(1);

  uint32_t prefix = 0u;
  unsigned int krem = static_cast<unsigned int>(k);
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 24 - 8 * p;
    // an element counts if its bits above this digit equal the prefix's;
    // the sign bit is masked here and out of the first digit
    const uint32_t above = p ? (0x7FFFFFFFu << (shift + 8)) & 0x7FFFFFFFu : 0u;
    const uint32_t digit = p ? kBins - 1 : (kBins >> 1) - 1;
    for (int i = tid; i < kBins * 32 / 4; i += kThreads) {
      reinterpret_cast<uint4*>(lh)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    auto add = [&](uint32_t b) {
      atomicAdd(&lh[(((b >> shift) & digit) << 5) | lane], 1u);
    };
    auto count = [&](float v) {
      const uint32_t b = __float_as_uint(v);
      if ((b & above) == prefix) add(b);
    };
    if constexpr (kInSmem) {
      // one branch per word: after the first passes few elements match
      auto count4 = [&](float4 v) {
        const uint32_t b0 = __float_as_uint(v.x), b1 = __float_as_uint(v.y),
                       b2 = __float_as_uint(v.z), b3 = __float_as_uint(v.w);
        const bool m0 = (b0 & above) == prefix, m1 = (b1 & above) == prefix,
                   m2 = (b2 & above) == prefix, m3 = (b3 & above) == prefix;
        if (m0 | m1 | m2 | m3) {
          if (m0) add(b0);
          if (m1) add(b1);
          if (m2) add(b2);
          if (m3) add(b3);
        }
      };
      if (p == 0) {
        row_cluster::for_each<true>(xs, s, bars, count4, count);
      } else {
        row_cluster::for_each<false>(xs, s, bars, count4, count);
      }
    } else {
      for (int j = tid; j < s.len; j += kThreads) count(__ldg(xg + j));
    }
    ROW_CLUSTER_STAMP(2 + 4 * p);               // swept
    __syncthreads();
    // sum the bins' 32 columns: thread t takes bin t % 256 and the columns
    // (8g + c + bin) % 32, c < 8, of group g = t / 256 (no bank conflicts)
    const int bin = tid & (kBins - 1), g = tid / kBins;
    {
      unsigned int c = 0u;
#pragma unroll
      for (int i = 0; i < 32 / kGroups; ++i) {
        c += lh[bin * 32 + ((32 / kGroups * g + i + bin) & 31)];
      }
      part[g][bin] = c;
    }
    __syncthreads();
    ROW_CLUSTER_STAMP(3 + 4 * p);               // columns summed
    {
      unsigned int c = 0u;
      for (int i = 0; i < kGroups; ++i) c += part[i][bin];
      if (p == 0) row_cluster::cluster_wait();   // every CTA has started
#pragma unroll
      for (int i = 0; i < kCluster / kGroups; ++i) {
        row_cluster::push(&hall[p & 1][rank][bin], g + kGroups * i, c);
      }
    }
    cluster.sync();             // every CTA's histogram of pass p is here
    ROW_CLUSTER_STAMP(4 + 4 * p);               // pushed, barrier passed
    if (tid < kBins) {
      unsigned int own = 0u;
      for (int r = 0; r < kCluster; ++r) own += hall[p & 1][r][tid];
      // inclusive suffix sum over the bins: within the warp, then the
      // totals of the warps above
      unsigned int v = own;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned int up = __shfl_down_sync(0xFFFFFFFFu, v, off);
        if (lane + off < 32) v += up;
      }
      if (lane == 0) warp_total[warp] = v;
      asm volatile("bar.sync 1, %0;\n" :: "n"(kBins) : "memory");
      for (int w = warp + 1; w < kBins / 32; ++w) v += warp_total[w];
      const unsigned int gt = v - own;
      // exactly one bin holds the krem-th largest of the matching elements
      if (gt < krem && krem <= v) {
        pick[0] = prefix | (static_cast<uint32_t>(tid) << shift);
        pick[1] = krem - gt;
        pick[2] = own;
      }
    }
    __syncthreads();
    ROW_CLUSTER_STAMP(5 + 4 * p);               // picked
    prefix = pick[0];
    krem = pick[1];
    // the whole bin is taken: its lowest pattern is the k-th largest, and
    // nothing outside the bin lies between it and the bin's lowest possible
    // pattern (the prefix), so bits >= prefix is the same mask
    if (krem == pick[2]) break;
  }
  const uint32_t t = prefix;
  auto keep = [t](float v) -> uint32_t { return mag_bits(v) >= t; };
  if constexpr (kInSmem) {
    row_cluster::store_bytes(
        out + rbase, s,
        [&](int j) {
          const float4 v = row_cluster::quad(xs, s.mis + j);
          return row_cluster::pack4(keep(v.x), keep(v.y), keep(v.z),
                                    keep(v.w));
        },
        [&](int j) -> uint8_t { return keep(xs[s.mis + j]); });
  } else {
    row_cluster::store_bytes(
        out + rbase, s,
        [&](int j) {
          return row_cluster::pack4(keep(__ldg(xg + j)), keep(__ldg(xg + j + 1)),
                                    keep(__ldg(xg + j + 2)),
                                    keep(__ldg(xg + j + 3)));
        },
        [&](int j) -> uint8_t { return keep(__ldg(xg + j)); });
  }
  ROW_CLUSTER_STAMP(kStampEnd);
}

row_cluster::SmemLimit smem_limits[2];   // of topk_mask_cluster<in smem>

}  // namespace

extern "C" {

// x: (rows, n) f32 -> out: (rows, n) bool, in one launch of kCluster CTAs
// per row.  Returns the CUDA error code of the launch (0 on success).
int topk_mask_rows(const float* x, bool* out, int rows, long long n, int k,
                   cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || k < 1 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // both kernels' limits are raised: the lane histogram and ~20 KB of
  // static shared memory are over the 48 KB a kernel gets without asking
  int avail[2] = {0, 0};
  cudaError_t err = row_cluster::smem_limit(topk_mask_cluster<false>,
                                            smem_limits[0], &avail[0]);
  if (err == cudaSuccess) {
    err = row_cluster::smem_limit(topk_mask_cluster<true>, smem_limits[1],
                                  &avail[1]);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* o = reinterpret_cast<uint8_t*>(out);
  const long long bytes = kLaneHistBytes + 4 * row_cluster::slice_words(n);
  if (bytes <= avail[1]) {
    return static_cast<int>(row_cluster::launch(
        topk_mask_cluster<true>, rows, kThreads, static_cast<int>(bytes),
        stream, x, n, k, o));
  }
  return static_cast<int>(row_cluster::launch(
      topk_mask_cluster<false>, rows, kThreads, kLaneHistBytes, stream, x, n,
      k, o));
}

}  // extern "C"
