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
// 10.7 MB, ~3.2 us at 3.35 TB/s, so launch latency dominates.
//
// Design: a radix select instead of the TPU's 31-launch bisection.
//   * 4 digit passes over the 31-bit patterns (digits at bits 24..30, 16..23,
//     8..15, 0..7).  Each pass is one launch over a (blocks, C) grid: a block
//     builds a 256-bin shared-memory histogram of the elements that still
//     match the prefix fixed so far, then adds its non-zero bins into the
//     row's global histogram with atomics.
//   * after each pass a tiny pick kernel (one 256-thread block per row) takes
//     a suffix scan over the bins, fixes the digit that holds the remaining
//     k-th element, and subtracts the counts above it from k.
//   * one final pass writes bits >= t.
// After 4 passes the prefix is the exact k-th largest pattern.  Every read of
// x is a coalesced scalar load: rows of odd length are not 16-byte aligned.
// Speed work (fusing the passes, vector loads, a CUDA graph) is for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kPasses = 4;

__device__ __forceinline__ uint32_t mag_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

// state[2*r] = prefix (the high digits fixed so far), state[2*r+1] = k left.
__global__ void hist_pass(const float* __restrict__ x, long long n,
                          int shift, const int* __restrict__ state,
                          unsigned int* __restrict__ hist) {
  __shared__ unsigned int sh[kBins];
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) sh[i] = 0u;
  __syncthreads();

  const int hi_shift = shift + 8;           // bits above this digit
  const uint32_t prefix = (hi_shift >= 31) ? 0u
      : (static_cast<uint32_t>(state[2 * row]) >> hi_shift);
  const float* xr = x + static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
           + threadIdx.x; i < n; i += stride) {
    const uint32_t b = mag_bits(xr[i]);
    if (hi_shift >= 31 || (b >> hi_shift) == prefix) {
      atomicAdd(&sh[(b >> shift) & (kBins - 1)], 1u);
    }
  }
  __syncthreads();
  unsigned int* hr = hist + static_cast<long long>(row) * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    if (sh[i]) atomicAdd(&hr[i], sh[i]);
  }
}

// One block of kBins threads per row.  Thread d owns bin d.
__global__ void pick_digit(const unsigned int* __restrict__ hist, int shift,
                           int first, int k, int* __restrict__ state) {
  __shared__ unsigned int suffix[kBins];
  const int row = blockIdx.x;
  const int d = threadIdx.x;
  const unsigned int* hr = hist + static_cast<long long>(row) * kBins;
  const unsigned int own = hr[d];
  // inclusive suffix sum: suffix[d] = sum_{j >= d} hist[j]
  suffix[d] = own;
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {
    unsigned int add = (d + off < kBins) ? suffix[d + off] : 0u;
    __syncthreads();
    suffix[d] += add;
    __syncthreads();
  }
  const unsigned int krem = first ? static_cast<unsigned int>(k)
                                  : static_cast<unsigned int>(state[2 * row + 1]);
  const uint32_t prefix = first ? 0u : static_cast<uint32_t>(state[2 * row]);
  const unsigned int ge = suffix[d];
  const unsigned int gt = ge - own;
  // exactly one bin holds the krem-th largest of the matching elements
  __syncthreads();
  if (gt < krem && krem <= ge) {
    state[2 * row] = static_cast<int>(prefix | (static_cast<uint32_t>(d) << shift));
    state[2 * row + 1] = static_cast<int>(krem - gt);
  }
}

__global__ void mask_ge(const float* __restrict__ x, long long n,
                        const int* __restrict__ state,
                        bool* __restrict__ out) {
  const int row = blockIdx.y;
  const uint32_t t = static_cast<uint32_t>(state[2 * row]);
  const long long base = static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
           + threadIdx.x; i < n; i += stride) {
    out[base + i] = mag_bits(x[base + i]) >= t;
  }
}

}  // namespace

extern "C" {

// x: (rows, n) f32; out: (rows, n) bool; hist: (kPasses, rows, kBins) u32,
// zeroed by the caller; state: (rows, 2) i32 scratch.  Returns the CUDA
// error code of the launches (0 on success).
int topk_mask_rows(const float* x, bool* out, unsigned int* hist, int* state,
                   int rows, long long n, int k, int blocks_per_row,
                   cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || k < 1 || k > n || blocks_per_row < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks_per_row, rows);
  const int shifts[kPasses] = {24, 16, 8, 0};
  for (int p = 0; p < kPasses; ++p) {
    unsigned int* hp = hist + static_cast<long long>(p) * rows * kBins;
    hist_pass<<<grid, kThreads, 0, stream>>>(x, n, shifts[p], state, hp);
    pick_digit<<<rows, kBins, 0, stream>>>(hp, shifts[p], p == 0, k, state);
  }
  mask_ge<<<grid, kThreads, 0, stream>>>(x, n, state, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
