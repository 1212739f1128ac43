// Online-softmax (flash) attention for Hopper (sm_90a), on CUDA cores, f32.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (_flash_kernel) for f32 inputs, which need f32 products that bf16 or TF32
//   tensor cores cannot give; bf16 inputs go to flash_attention_wgmma.cu.
//
// What it computes (the TPU kernel's arithmetic, in f32):
//   q (B, S, H, hd), k/v (B, T, K, hd), H % K == 0, query head h reads kv
//   head h / (H / K); s = (q . k) * scale; masked scores are the finite
//   -2e38 (causal: key <= query; window w > 0: key > query - w; keys past
//   T); running max m, alpha = exp(m_prev - m_new), l and acc all f32; p is
//   zeroed explicitly where masked, so a row whose keys are all masked so
//   far stays 0; out = acc / max(l, 1e-30) in q's type.
//
// What bounds it on this card: operations.  At the full-width tinyllama
// shape in f32 (B 4, S = T = 2048, H 32 over K 4, hd 64, causal) the two
// products take ~6.9e10 FLOP over the causal half: 1.0 ms at the f32 rate
// of the CUDA cores, against 0.05 ms for the ~151 MB of q, k, v and out.
//
// Design: the TPU grid (b, h, q-block, kv-block) ran its last axis in order
// on one core with m/l/acc in VMEM scratch.  Here one CTA owns one
// (b, h, 64-query tile) and walks the kv tiles itself, so the carry lives in
// registers.  Blocks read (B, S, H, hd) in place with strides (no
// head-major copy), and kv tiles that the causal or window mask hides
// entirely are never loaded.  128 threads form 16 row groups x 8 column
// groups: each thread owns a 4 x 8 block of the 64 x 64 score tile (columns
// strided by 8, so the float4 reads of K rows fall in distinct banks) and a
// 4 x hd/8 block of the output.  Row max and row sum reduce over the 8
// threads of a row group with shuffles; p goes through shared memory for
// the p.v product.  Tiles are staged as f32 in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // query rows per CTA = keys per kv tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr float kMaskValue = -2.0e38f;

// Rows [r0, r0 + kTile) of one head of a (batch, L, heads, HD) tensor ->
// dst[row * ld + d]; rows at or past L are zero.  ``src`` points at
// (b, 0, head, 0) and ``row_stride`` is heads * HD.
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          long long row_stride, int r0, int L,
                                          float* __restrict__ dst, int ld) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    float v = 0.0f;
    if (r0 + r < L) v = src[static_cast<long long>(r0 + r) * row_stride + d];
    dst[r * ld + d] = v;
  }
}

__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int HD>
constexpr int smem_floats() {
  return 3 * kTile * (HD + 4) + kTile * (kTile + 4);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int S,
          int T_len,
          int H, int K, float scale, int causal, int window) {
  constexpr int LD = HD + 4;       // padded rows: float4-aligned, no conflicts
  constexpr int LDP = kTile + 4;
  constexpr int OC = HD / 8;       // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(K) * HD;
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const float* kb = k + (static_cast<long long>(b) * T_len * K + kvh) * HD;
  const float* vb = v + (static_cast<long long>(b) * T_len * K + kvh) * HD;

  const int rg = threadIdx.x / 8;  // rows rg*4 .. rg*4+3
  const int cg = threadIdx.x % 8;  // score columns cg + 8j; output columns
                                   // 32*c4 + 4*cg + e

  load_tile<HD>(qb, q_stride, q0, S, qs, LD);

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }

  // kv tiles that any query of this tile can see
  const int q_last = min(q0 + kTile, S) - 1;
  const int kv_end = causal ? min(T_len, q_last + 1) : T_len;
  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = (kv_first / kTile) * kTile;

  for (int k0 = t_begin; k0 < kv_end; k0 += kTile) {
    __syncthreads();               // the last tile's ks/vs/ps reads are done
    load_tile<HD>(kb, kv_stride, k0, T_len, ks, LD);
    load_tile<HD>(vb, kv_stride, k0, T_len, vs, LD);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(rg * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(cg + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      unsigned live = 0u;
      float row_max = kMaskValue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + cg + 8 * j;
        const bool ok = kj < T_len && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        live |= static_cast<unsigned>(ok) << j;
        s[i][j] = ok ? s[i][j] * scale : kMaskValue;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(row_max));
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ((live >> j) & 1u) ? expf(s[i][j] - m_new) : 0.0f;
        row_sum += p;
        ps[(rg * 4 + i) * LDP + cg + 8 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group8_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(rg * 4 + i) * LDP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c4 = 0; c4 < HD / 32; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[(j + jj) * LD + 32 * c4 + 4 * cg]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = lane(pv[i], jj);
            acc[i][4 * c4 + 0] += p * vv.x;
            acc[i][4 * c4 + 1] += p * vv.y;
            acc[i][4 * c4 + 2] += p * vv.z;
            acc[i][4 * c4 + 3] += p * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + (static_cast<long long>(b) * S + qi) * q_stride +
                  static_cast<long long>(h) * HD;
#pragma unroll
    for (int c4 = 0; c4 < HD / 32; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[32 * c4 + 4 * cg + e] = acc[i][4 * c4 + e] / denom;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int H, int K, float scale, int causal,
           int window, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_fwd<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_len, H, K,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, S, H, hd), k/v: (B, T, K, hd), out: (B, S, H, hd), all contiguous
// f32.  hd in {32, 64, 128}, H % K == 0.  Returns the launch's CUDA error
// code (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int T_len, int H, int K,
                        int hd, float scale, int causal, int window,
                        cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, out, B, S, T_len, H, K, scale, causal,
                        window, stream);
    case 64:
      return launch<64>(q, k, v, out, B, S, T_len, H, K, scale, causal,
                        window, stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, T_len, H, K, scale, causal,
                         window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
