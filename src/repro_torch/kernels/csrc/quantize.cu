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
// with the reference's f32 semantics on the edges (XLA on the CPU and the
// TPU flushes subnormals to zero; XLA converts NaN to the integer 0): a
// subnormal entry, scale or y counts as 0, and a NaN y (a NaN entry, or an
// inf one times inv = 0) codes as 0.  Each is an explicit select: the file
// is not built with -ftz=true.
// Every float operation is spelled with an _rn intrinsic and the file is
// built with -fmad=false, so nvcc contracts nothing into an FMA.
//
// What bounds it on this card: bytes.  Quantize must read x once (4 B/elt)
// and write q (1 B/elt); dequantize reads q and writes 4 B/elt.  At the main
// path's shape (8 x 267,009) each moves 10.7 MB, ~3.2 us at 3.35 TB/s.
// Quantize needs the row's absmax before its first code, a row-wide
// reduction between two sweeps: as a zeroed buffer and two launches (an
// absmax with atomics, then a quantize pass that read x again) it took
// 9.6-10.7 us of device time a call on an H100.
//
// Design of quantize: one launch, one thread-block cluster of
// row_cluster::kCluster = 8 CTAs per row.  Each CTA
// copies its slice of the row (about N / 8 elements) into shared memory
// once, with bulk copies (row_cluster.cuh), and reduces |x| over each piece
// as it lands.  Each CTA pushes its maximum into every CTA of the cluster
// through distributed shared memory; after one cluster barrier each CTA
// takes the max of the maxima from its own shared memory, exact and
// order-free because non-negative floats order like their bit patterns.
// Every CTA then computes scale and inv itself (two divisions), the CTA of
// rank 0 stores scale[r], and every CTA codes its slice from shared memory
// into 4-byte words of codes.  The stochastic-rounding hash keys on the row
// and the GLOBAL column; it takes most of the coding time (nine integer
// operations an element, on the SM's half-rate integer pipe), so the CTA
// computes the hashes of as many elements as the rest of its shared memory
// holds while its copies land, and the rest as it codes.  (Hashing between
// the arrive and the wait of the cluster barrier instead put the hashing of
// the slowest CTA on the critical path: slower, see PERF.md.)  The seed
// is read through a device pointer when one is given, so a captured CUDA
// graph reads each replay's seed, or else taken by value.
// A slice over the CTA's shared memory is read from device memory twice
// instead.
//
// Dequantize: one grid-stride launch over a (blocks, rows) grid.  It takes
// 5-6 us of device time a call at the main shape on an H100, within twice
// its bound, so it was left as it is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using row_cluster::kCluster;
using row_cluster::Slice;

constexpr int kThreads = 256;
constexpr int kClusterThreads = 1024;

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

__device__ __forceinline__ uint32_t mag_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

// 1.5 * 2^23: the sum of it and a float of magnitude <= 2^22 is rounded
// to an integer (in the rounding mode of the addition) that sits in the low
// mantissa bits, and the low byte of the sum's bit pattern is that integer
// as an int8.  So rint, floor and the conversion to int8 take additions on
// the FP32 pipe, where rintf, floorf and the float-to-int conversion would
// take the slower conversion unit.
constexpr float kRound = 12582912.0f;
constexpr float kMinNormal = 1.17549435e-38f;   // 2^-126

// v, or a zero of its sign where v is subnormal (NaN and inf pass)
__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < kMinNormal ? copysignf(0.0f, v) : v;
}

// The code of x[r, col] in the low byte: clip(rint(y)), or with stochastic
// rounding clip(floor(y) + (u < y - floor(y))) for u = hash_u01(r, col,
// seed), with y = x * inv.  Clipping y before rounding gives the same codes
// as clipping after, as the reference does.  y is 0 where x is subnormal
// (or 0 or NaN) and where x * inv is subnormal or NaN (an inf x times inv
// = 0): two compares of magnitudes, both false for NaN, and one select.
// The sign of such a zero does not reach the code.
template <bool kStochastic>
__device__ __forceinline__ uint32_t code(float xv, float inv, float u) {
  const float p = __fmul_rn(xv, inv);
  const bool keep = fabsf(xv) >= kMinNormal && fabsf(p) >= kMinNormal;
  const float y = fminf(fmaxf(keep ? p : 0.0f, -127.0f), 127.0f);
  if (kStochastic) {
    const float t = __fadd_rd(y, kRound);                 // floor(y) + kRound
    const float d = __fsub_rn(y, __fsub_rn(t, kRound));   // y - floor(y)
    return __float_as_uint(u < d ? __fadd_rn(t, 1.0f) : t);
  }
  return __float_as_uint(__fadd_rn(y, kRound));
}

template <bool kInSmem, bool kStochastic>
__global__ void __launch_bounds__(kClusterThreads)
quantize_cluster(const float* __restrict__ x, long long n,
                 const uint32_t* __restrict__ seed_ptr, uint32_t seed,
                 int u_cap, uint8_t* __restrict__ q,
                 float* __restrict__ scale_out) {
  __shared__ unsigned int warp_max[kClusterThreads / 32];
  __shared__ unsigned int cta_max[kCluster];   // pushed by each CTA
  __shared__ uint64_t bars[row_cluster::kChunks];
  extern __shared__ float4 dyn_f4[];
  float* xs = reinterpret_cast<float*>(dyn_f4);

  ROW_CLUSTER_STAMP(0);
  row_cluster::cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t row = blockIdx.y;
  const long long rbase = static_cast<long long>(row) * n;
  const float* xr = x + rbase;
  const Slice s = row_cluster::slice_of(xr, n, rank);
  const float* xg = xr + s.lo;                   // the slice in device memory
  const uint32_t sd = kStochastic ? (seed_ptr ? *seed_ptr : seed) : 0u;
  const uint32_t col0 = static_cast<uint32_t>(s.lo);   // the global column
  auto hash = [&](int j) {
    return hash_u01(row, col0 + static_cast<uint32_t>(j), sd);
  };
  // stochastic rounding: the hashes of the slice's first u_cap - mis
  // elements, us[mis + j], computed while the copies land
  float* us = xs + row_cluster::slice_words(n);

  unsigned int m = 0u;
  auto absmax = [&m](float v) { m = max(m, mag_bits(v)); };
  if constexpr (kInSmem) {
    row_cluster::load_slice(xr, s, xs, bars);
    if constexpr (kStochastic) {
      const int end = min(u_cap, s.mis + s.len);
      for (int i = s.mis + tid; i < end; i += kClusterThreads) {
        us[i] = hash(i - s.mis);
      }
    }
    row_cluster::for_each<true>(xs, s, bars, [&](float4 v) {
      absmax(v.x);
      absmax(v.y);
      absmax(v.z);
      absmax(v.w);
    }, absmax);
  } else {
    for (int j = tid; j < s.len; j += kClusterThreads) absmax(__ldg(xg + j));
  }
  ROW_CLUSTER_STAMP(1);                         // loaded and reduced
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = __reduce_max_sync(0xFFFFFFFFu, warp_max[lane]);
    row_cluster::cluster_wait();                 // every CTA has started
    if (lane < kCluster) row_cluster::push(&cta_max[rank], lane, m);
  } else {
    row_cluster::cluster_wait();
  }
  cluster.sync();               // every CTA's maximum is here
  ROW_CLUSTER_STAMP(2);                         // pushed, barrier passed
  m = 0u;
  for (int r = 0; r < kCluster; ++r) m = max(m, cta_max[r]);
  const float scale = flush_subnormal(__fdiv_rn(__uint_as_float(m), 127.0f));
  const float inv = scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
  if (rank == 0 && tid == 0) scale_out[row] = scale;
  ROW_CLUSTER_STAMP(3);                         // scale and inv
  auto u4 = [&](int j) {               // the hashes of elements j .. j + 3
    const int i = s.mis + j;
    if (kInSmem && i + 3 < u_cap) return row_cluster::quad(us, i);
    return make_float4(hash(j), hash(j + 1), hash(j + 2), hash(j + 3));
  };
  row_cluster::store_bytes(
      q + rbase, s,
      [&](int j) {
        const float4 v = kInSmem ? row_cluster::quad(xs, s.mis + j)
                                 : make_float4(__ldg(xg + j), __ldg(xg + j + 1),
                                               __ldg(xg + j + 2),
                                               __ldg(xg + j + 3));
        const float4 u = kStochastic ? u4(j) : v;
        return row_cluster::pack4(
            code<kStochastic>(v.x, inv, u.x), code<kStochastic>(v.y, inv, u.y),
            code<kStochastic>(v.z, inv, u.z), code<kStochastic>(v.w, inv, u.w));
      },
      [&](int j) -> uint8_t {
        const float v = kInSmem ? xs[s.mis + j] : __ldg(xg + j);
        float u = 0.0f;
        if (kStochastic) {
          u = (kInSmem && s.mis + j < u_cap) ? us[s.mis + j] : hash(j);
        }
        return static_cast<uint8_t>(code<kStochastic>(v, inv, u));
      });
  ROW_CLUSTER_STAMP(4);                         // coded and stored
}

__global__ void dequantize(const signed char* __restrict__ q, long long n,
                           const float* __restrict__ scale,
                           float* __restrict__ out) {
  const int row = blockIdx.y;
  // a subnormal scale is 0; for |q| >= 1 nothing else underflows
  const float s = flush_subnormal(scale[row]);
  const long long base = static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
           + threadIdx.x; i < n; i += stride) {
    out[base + i] = __fmul_rn(static_cast<float>(q[base + i]), s);
  }
}

// of quantize_cluster<true, stochastic>
row_cluster::SmemLimit in_smem_limit[2];

template <bool kInSmem, bool kStochastic>
cudaError_t launch_quantize(const float* x, uint8_t* q, float* scale,
                            int rows, long long n, const uint32_t* seed_ptr,
                            uint32_t seed, int u_cap, int smem,
                            cudaStream_t stream) {
  return row_cluster::launch(quantize_cluster<kInSmem, kStochastic>, rows,
                             kClusterThreads, smem, stream, x, n, seed_ptr,
                             seed, u_cap, q, scale);
}

// One launch of quantize_cluster<?, kStochastic>: the slice in shared
// memory where it fits in `avail` bytes, and with stochastic rounding the
// hashes of as many elements as the rest holds.
template <bool kStochastic>
cudaError_t quantize(const float* x, uint8_t* q, float* scale, int rows,
                     long long n, const uint32_t* seed_ptr, uint32_t seed,
                     cudaStream_t stream) {
  int avail = 0;
  const cudaError_t err = row_cluster::smem_limit(
      quantize_cluster<true, kStochastic>, in_smem_limit[kStochastic],
      &avail);
  if (err != cudaSuccess) return err;
  const long long words = row_cluster::slice_words(n);
  if (4 * words > avail) {
    return launch_quantize<false, kStochastic>(x, q, scale, rows, n,
                                               seed_ptr, seed, 0, 0, stream);
  }
  const long long spare = kStochastic ? (avail / 4 - words) / 4 * 4 : 0;
  const int u_cap = static_cast<int>(spare < words ? spare : words);
  return launch_quantize<true, kStochastic>(
      x, q, scale, rows, n, seed_ptr, seed, u_cap,
      static_cast<int>(4 * (words + u_cap)), stream);
}

}  // namespace

extern "C" {

// x: (rows, n) f32 -> q: (rows, n) int8, scale: (rows,) f32, in one launch
// of kCluster CTAs per row.  The stochastic-rounding seed is *seed_ptr (a
// device pointer) when seed_ptr is not null, else seed.  Returns the
// launch's CUDA error code (0 on success).
int quantize_rows(const float* x, signed char* q, float* scale, int rows,
                  long long n, int stochastic, const unsigned int* seed_ptr,
                  unsigned int seed, cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint8_t* qb = reinterpret_cast<uint8_t*>(q);
  return static_cast<int>(
      stochastic
          ? quantize<true>(x, qb, scale, rows, n, seed_ptr, seed, stream)
          : quantize<false>(x, qb, scale, rows, n, seed_ptr, seed, stream));
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
