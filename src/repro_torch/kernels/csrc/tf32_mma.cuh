// Split-TF32 tensor-core products for the f32 kernels (sm_80 and later; the
// port builds them for sm_90a): flash_attention_tf32.cu, ssd_scan_tf32.cu.
//
// A TF32 tensor-core product keeps 10 explicit mantissa bits of each
// operand.  Split-TF32 carries an f32 operand as two TF32 values,
//   a = a_hi + a_lo,  a_hi = tf32(a),  a_lo = tf32(a - a_hi),
// both rounded to nearest explicitly (the tensor core itself would drop the
// low 13 bits, a bias that grows with the length of the sum), and takes
//   a . b ~ a_lo . b_hi + a_hi . b_lo + a_hi . b_hi
// in f32 accumulators (the a_lo . b_lo term, ~2^-22 relative, is dropped):
// three TF32 products for one near-f32 product.  a - a_hi is exact in f32.
//
// The products are mma.sync m16n8k8 (row-major A, column-major B) with the
// fragments loaded by hand from shared memory, so an operand may be laid
// out either way: unlike wgmma, whose TF32 form reads only K-major operands
// from shared memory, nothing needs a transpose.  Fragment layout per lane
// (gid = lane / 4, tig = lane % 4):
//   A (16 x 8):  a0 (gid, tig)  a1 (gid + 8, tig)  a2 (gid, tig + 4)
//                a3 (gid + 8, tig + 4)
//   B (8 x 8):   b0 (k tig, n gid)  b1 (k tig + 4, n gid)
//   C (16 x 8):  c0 (gid, 2 tig)  c1 (gid, 2 tig + 1)  c2 (gid + 8, 2 tig)
//                c3 (gid + 8, 2 tig + 1)
// An operand that the warps of a CTA share is split once per CTA into
// (hi, lo) pairs in shared memory (split_tile), so that a B fragment is
// two 8-byte loads; one that a warp owns alone is split in registers as its
// fragment is loaded, over every n-tile it multiplies.
// A product whose A operand is a C fragment (p . v in flash) renames its K
// index: k = tig stands for column 2 tig of the
// C tile and k = tig + 4 for column 2 tig + 1, so the A fragment is
// (c0, c2, c1, c3) with no shuffle, and the B rows are read in that order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// v rounded to nearest with 11 significant bits, a TF32 value (Veltkamp's
// split with 2^13 + 1, three operations on the FP32 pipe, where
// cvt.rna.tf32.f32 takes the conversion unit, an eighth of its width).  Each operation is rounded on its own
// (no contraction into an FMA, which would keep the discarded bits).
// |v| must stay below ~2^114 (v * 8193 finite).
__device__ __forceinline__ float round_tf32(float v) {
  const float c = __fmul_rn(v, 8193.0f);
  return __fsub_rn(c, __fsub_rn(c, v));
}

// v = hi + lo, each a TF32 value.
__device__ __forceinline__ float2 split(float v) {
  const float hi = round_tf32(v);
  return make_float2(hi, round_tf32(__fsub_rn(v, hi)));
}

// 2^x on the special-function unit (2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (16 x 8 f32) += a (16 x 8) . b (8 x 8), TF32 operands.  Not volatile:
// the compiler may interleave products into different accumulators, which
// hides each product's latency behind the next.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An f32 A fragment as split-TF32 halves.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    const float v[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = split(v[i]);
      hi[i] = __float_as_uint(p.x);
      lo[i] = __float_as_uint(p.y);
    }
  }
};

// d[n] += a . b[n] for the NT n-tiles in split TF32, b[n] = the (hi, lo)
// pairs of b0 and b1 of n-tile n: the products are issued term by term
// across the n-tiles (lo.hi for every n, then hi.lo, then hi.hi), so
// consecutive products go to different accumulators and the small terms
// reach each accumulator before the large one.
template <int NT>
__device__ __forceinline__ void mma3(float (*d)[4], const FragA& a,
                                     const float2 (*b)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint32_t bh[2] = {__float_as_uint(b[n][0].x),
                            __float_as_uint(b[n][1].x)};
    mma(d[n], a.lo, bh);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint32_t bl[2] = {__float_as_uint(b[n][0].y),
                            __float_as_uint(b[n][1].y)};
    mma(d[n], a.hi, bl);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint32_t bh[2] = {__float_as_uint(b[n][0].x),
                            __float_as_uint(b[n][1].x)};
    mma(d[n], a.hi, bh);
  }
}

// Rows x cols f32 (rows ``ld_src`` floats apart; cols a multiple of 4) to
// split pairs dst[r * ld_dst + c] = split(src[r * ld_src + c]), by every
// thread of the CTA, four columns at a time.
__device__ __forceinline__ void split_tile(float2* dst, int ld_dst,
                                           const float* src, int ld_src,
                                           int rows, int cols) {
  const int vecs = cols / 4;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += blockDim.x) {
    const int r = idx / vecs;
    const int c = 4 * (idx % vecs);
    const float4 v = *reinterpret_cast<const float4*>(src + r * ld_src + c);
    const float2 s0 = split(v.x), s1 = split(v.y), s2 = split(v.z),
                 s3 = split(v.w);
    float4* out = reinterpret_cast<float4*>(dst + r * ld_dst + c);
    out[0] = make_float4(s0.x, s0.y, s1.x, s1.y);
    out[1] = make_float4(s2.x, s2.y, s3.x, s3.y);
  }
}

// 16 bytes from global to shared memory without registers; src_bytes 0
// writes zeros (rows past the end of a tensor; src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(src_bytes)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32
