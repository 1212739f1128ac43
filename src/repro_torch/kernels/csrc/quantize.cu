// Per-row absmax int8 row codec for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantize.py::quantize_rows_pallas
//   (_row_block_absmax_kernel, _quantize_kernel, _quantize_sr_kernel) and
//   ::dequantize_rows_pallas (_dequantize_kernel).
//
// What it computes, per row r of x (R, N) f32 (bitwise the eager oracle):
//   scale[r] = max|x[r]| / 127                 (IEEE division)
//   inv      = scale > 0 ? 1 / scale : 0       (IEEE division)
//   y        = x * inv
//   q        = clip(rint(y), -127, 127)        (half-to-even, like jnp.round)
//   or, stochastic: y = clip(y), f = floor(y), u = hash_u01(r, col, seed),
//                   q = clip(f + (u < y - f))
//   dequantize: out = float(q) * scale[r]
// Every float operation is spelled with an _rn intrinsic and the file is
// built with -fmad=false, so nvcc contracts nothing into an FMA.
//
// What bounds it on this card: bytes.  Quantize must read x once (4 B/elt)
// and write q (1 B/elt); dequantize reads q and writes 4 B/elt.  At the main
// path's shape (8 x 267,009) each moves 10.7 MB, ~3.2 us at 3.35 TB/s.
//
// Design: two launches for quantize.  Pass 1 reduces |x| per (block, row)
// with warp shuffles and folds the block maximum into absmax[r] with
// atomicMax on the uint bits: non-negative floats order like their bit
// patterns, so the result is exact and independent of block order.  Pass 2
// recomputes scale and inv from absmax[r] in every thread (two divisions,
// cheaper than a third launch), block 0 of each row stores scale[r], and all
// threads quantize a grid-stride slice of the row.  The reference's TPU
// blocking (8192-element tiles, zero padding) is not needed: the kernels
// mask the ragged edge by index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_absmax(const float* __restrict__ x, long long n,
                           unsigned int* __restrict__ absmax_bits) {
  const int row = blockIdx.y;
  const float* xr = x + static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned int m = 0u;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
           + threadIdx.x; i < n; i += stride) {
    m = max(m, __float_as_uint(xr[i]) & 0x7FFFFFFFu);
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_down_sync(0xFFFFFFFFu, m, off));
  }
  __shared__ unsigned int warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = (lane < kThreads / 32) ? warp_max[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      m = max(m, __shfl_down_sync(0xFFFFFFFFu, m, off));
    }
    if (lane == 0) atomicMax(&absmax_bits[row], m);
  }
}

__device__ __forceinline__ float hash_u01(uint32_t row, uint32_t col,
                                          uint32_t seed) {
  uint32_t h = col * 0x9E3779B1u + row * 0x85EBCA77u + seed * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return __fmul_rn(__uint2float_rn(h), 2.3283064365386963e-10f);  // 2^-32
}

template <bool kStochastic>
__global__ void quantize(const float* __restrict__ x, long long n,
                         const unsigned int* __restrict__ absmax_bits,
                         uint32_t seed, signed char* __restrict__ q,
                         float* __restrict__ scale_out) {
  const int row = blockIdx.y;
  const float scale = __fdiv_rn(__uint_as_float(absmax_bits[row]), 127.0f);
  const float inv = scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[row] = scale;
  const long long base = static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
           + threadIdx.x; i < n; i += stride) {
    float y = __fmul_rn(x[base + i], inv);
    float v;
    if (kStochastic) {
      y = fminf(fmaxf(y, -127.0f), 127.0f);
      const float f = floorf(y);
      const float u = hash_u01(static_cast<uint32_t>(row),
                               static_cast<uint32_t>(i), seed);
      v = (u < __fsub_rn(y, f)) ? __fadd_rn(f, 1.0f) : f;
    } else {
      v = rintf(y);
    }
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    q[base + i] = static_cast<signed char>(__float2int_rn(v));
  }
}

__global__ void dequantize(const signed char* __restrict__ q, long long n,
                           const float* __restrict__ scale,
                           float* __restrict__ out) {
  const int row = blockIdx.y;
  const float s = scale[row];
  const long long base = static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
           + threadIdx.x; i < n; i += stride) {
    out[base + i] = __fmul_rn(static_cast<float>(q[base + i]), s);
  }
}

}  // namespace

extern "C" {

// x: (rows, n) f32 -> q: (rows, n) int8, scale: (rows,) f32.  absmax_bits:
// (rows,) u32 scratch zeroed by the caller.  Returns the launches' CUDA
// error code (0 on success).
int quantize_rows(const float* x, signed char* q, float* scale,
                  unsigned int* absmax_bits, int rows, long long n,
                  int stochastic, unsigned int seed, int blocks_per_row,
                  cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || blocks_per_row < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks_per_row, rows);
  row_absmax<<<grid, kThreads, 0, stream>>>(x, n, absmax_bits);
  if (stochastic) {
    quantize<true><<<grid, kThreads, 0, stream>>>(x, n, absmax_bits, seed, q,
                                                  scale);
  } else {
    quantize<false><<<grid, kThreads, 0, stream>>>(x, n, absmax_bits, seed, q,
                                                   scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (rows, n) int8, scale: (rows,) f32 -> out: (rows, n) f32.
int dequantize_rows(const signed char* q, const float* scale, float* out,
                    int rows, long long n, int blocks_per_row,
                    cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || blocks_per_row < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks_per_row, rows);
  dequantize<<<grid, kThreads, 0, stream>>>(q, n, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
