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
// with k = max(int(8192 * frac), 1) from the slice size, not from N.  mid is
// rounded once per operation (__fadd_rn, __fmul_rn, never contracted) and
// the count is an exact int, so the mask is bitwise the reference's.  A
// slice with max |x| == 0 keeps lo = 0 and every entry.
//
// What bounds it on this card: bytes.  The least traffic is one read of x
// (4 B) and one write of the mask (1 B) per element: at the main path's
// shape (8 x 267,009) 10.7 MB, ~3.2 us at 3.35 TB/s.  The 32 rounds of the
// bisection are ~32 compares per thread and one block reduction each.
//
// Design: one CTA of 256 threads per (row, slice).  Each thread keeps its 32
// magnitudes in registers (coalesced scalar loads; rows of odd length are
// not 16-byte aligned), so x is read once.  A round's count is a per-thread
// sum, a warp-shuffle sum and a sum over the 8 warps' partials in shared
// memory, double-buffered so each round needs one __syncthreads; every
// thread then updates the same lo / hi.  The mask is written with coalesced
// byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 8192;
constexpr int kThreads = 256;
constexpr int kPer = kBlock / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 32;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  return v;
}

// grid (slices per row, rows); x: (rows, n) f32, out: (rows, n) bool.
__global__ void __launch_bounds__(kThreads)
topk_block(const float* __restrict__ x, bool* __restrict__ out, long long n,
           int k) {
  __shared__ int part[2][kWarps];
  __shared__ float pmax[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const long long start = static_cast<long long>(blockIdx.x) * kBlock
                          + threadIdx.x;

  float mag[kPer];
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long j = start + static_cast<long long>(i) * kThreads;
    mag[i] = j < n ? fabsf(x[base + j]) : 0.0f;
    m = fmaxf(m, mag[i]);
  }
  m = warp_max(m);
  if (lane == 0) pmax[warp] = m;
  __syncthreads();
  float hi = pmax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) hi = fmaxf(hi, pmax[w]);
  float lo = 0.0f;

  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) c += mag[i] >= mid ? 1 : 0;
    c = warp_sum(c);
    int* buf = part[it & 1];
    if (lane == 0) buf[warp] = c;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += buf[w];
    if (total >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long j = start + static_cast<long long>(i) * kThreads;
    if (j < n) out[base + j] = mag[i] >= lo;
  }
}

}  // namespace

extern "C" {

// x: (rows, n) f32 contiguous; out: (rows, n) bool.  k >= 1 is the per-slice
// count (from the slice size).  Returns the CUDA error code of the launch.
int topk_mask_block_rows(const float* x, bool* out, int rows, long long n,
                         int k, cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slices = (n + kBlock - 1) / kBlock;
  if (slices > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(slices), rows);
  topk_block<<<grid, kThreads, 0, stream>>>(x, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
