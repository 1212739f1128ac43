// Online-softmax (flash) attention for f32 on Hopper (sm_90a) tensor cores:
// both products in split TF32 (csrc/tf32_mma.cuh) on mma.sync.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (_flash_kernel) for f32 inputs; bf16 inputs go to
//   flash_attention_wgmma.cu.
//
// What it computes (the TPU kernel's arithmetic, in f32):
//   q (B, S, H, hd), k/v (B, T, K, hd), H % K == 0, query head h reads kv
//   head h / (H / K); s = (q . k) * scale; masked scores are the finite
//   -2e38 (causal: key <= query; window w > 0: key > query - w; keys past
//   T); running max m, alpha = exp(m_prev - m_new), l and acc all f32; p is
//   zeroed explicitly where masked, so a row whose keys are all masked so
//   far stays 0; out = acc / max(l, 1e-30) in f32.  q . k and p . v are
//   split-TF32 products: each operand is hi + lo, both rounded to TF32,
//   and three TF32 products (lo.hi, hi.lo, hi.hi) accumulate in f32, which
//   carries each product to ~2^-21 relative; the exponentials are
//   ex2.approx (2 ulp) of scores kept in units of log2 e.
//
// What bounds it on this card: operations.  At the full-width tinyllama
// shape in f32 (B 4, S = T = 2048, H 32 over K 4, hd 64, causal) the two
// products take ~6.9e10 FLOP over the causal half, three TF32 products
// each: 0.42 ms at the dense TF32 rate (495 TFLOP/s; 1.03 ms at the f32
// rate of the CUDA cores), against 0.05 ms for the ~151 MB of q, k, v and
// out.  mma.sync reaches ~320 TFLOP/s of TF32 on an H100
// (repro_torch.profile_mma), so ~0.65 ms is this design's floor.
//
// Design.  One CTA of eight warps per (b, h, 128-query tile), two CTAs to
// an SM (the launch bound caps the registers at 128), issued longest tile
// first (the tile is the slowest part of blockIdx.x); each warp owns 16
// query rows.  q, k and v are read in place from (B, L, heads, hd); keys
// and rows past the end read as zero.  The q tile is loaded once with
// cp.async, in rows padded to hd + 4 floats, and each warp splits its q
// fragments in registers as it loads them.  k / v tiles of 32 keys (16 at
// hd 128) go through two stages of (hi, lo) pairs in shared memory, rows
// padded so that every fragment load below hits distinct banks: while the
// warps multiply by one stage, each thread holds its share of the next
// tile in registers (loaded a tile ahead) and, after its products, splits
// it into the other stage; one barrier per tile.  Per kv tile and warp:
// S (16 x 32) = q k^T on mma.sync m16n8k8 (k^T's fragments are k's rows),
// the online softmax on the accumulators in units of log2 e (ex2.approx;
// a row's four owner lanes reduce with two xor-shuffles; l stays a
// per-lane partial until the end), then O (16 x hd) += p v with p taken
// straight from the S accumulators as the A operand (keys renamed as in
// tf32_mma.cuh, v's rows read in that order) and split in registers.  Kv
// tiles that the mask hides entirely are never loaded; a warp skips a tile
// that its own rows cannot see, and only tiles that straddle the diagonal,
// a window edge or T compute a mask.  The output is stored from registers,
// rows past S dropped.  Measured alternatives (PERF.md), all slower on an
// H100: k and v split once in device memory (the pairs double what every
// CTA reads from L2), a raw cp.async stage split by the CTA between two
// barriers, q held as split pairs in shared memory or in registers, the
// three products of a split in three accumulator sets, one CTA to an SM,
// 64-query CTAs, 16- and 64-key tiles.

#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr int kRows = 128;               // query rows per CTA
constexpr int kKeysPerTile = 32;         // keys per kv tile (hd <= 64)
constexpr int kMinBlocks = 2;            // CTAs per SM (launch bound)
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kMaskValue = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  // keys per kv tile (half as many at hd 128)
  static constexpr int kKeys = HD == 128 ? kKeysPerTile / 2 : kKeysPerTile;
  static constexpr int kLdQ = HD + 4;      // q raw rows (floats)
  static constexpr int kLdK = HD + 4;      // k pair rows
  static constexpr int kLdV = HD + 2;      // v pair rows
  static constexpr int kRaw = kKeys * HD;
  static constexpr int kPairs = kKeys * (kLdK + kLdV);   // one k, v stage
  static constexpr int kSmem = kRows * kLdQ * 4 + 2 * kPairs * 8;
  // float4s of a k (or v) tile each thread loads and splits
  static constexpr int kVecs = (kRaw / 4 + kThreads - 1) / kThreads;
};

// ``rows`` rows from r0 of one head of a (batch, L, heads, HD) tensor into
// dst[row * ld + col] (cp.async, not waited for); rows at or past L are
// zero.  ``src`` points at (b, 0, head, 0), ``row_stride`` is heads * HD.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long row_stride, int r0,
                                          int rows, int L) {
  constexpr int kVec = HD / 4;
  for (int idx = threadIdx.x; idx < rows * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = idx % kVec;
    const bool ok = r0 + r < L;
    const float* g = ok ? src + (r0 + r) * row_stride + 4 * c : src;
    cp_async16(dst + r * ld + 4 * c, g, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_tf32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int B,
           int S, int T_len, int H, int K, float scale_log2, int causal,
           int window) {
  using G = Tile<HD>;
  constexpr int KEYS = G::kKeys;
  constexpr int LDQ = G::kLdQ;
  constexpr int LDK = G::kLdK;
  constexpr int LDV = G::kLdV;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float2* kv_pairs = reinterpret_cast<float2*>(qs + kRows * LDQ);  // 2 stages

  // longest query tile first: the tile is the slowest part of blockIdx.x
  const int nq = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / (B * H)) * kRows;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / K);
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(K) * HD;
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const float* kb = k + (static_cast<long long>(b) * T_len * K + kvh) * HD;
  const float* vb = v + (static_cast<long long>(b) * T_len * K + kvh) * HD;

  // kv tiles that any query of this tile can see
  const int q_last = min(q0 + kRows, S) - 1;
  const int kv_end = causal ? min(T_len, q_last + 1) : T_len;
  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_first / KEYS;
  const int n_tiles = (kv_end + KEYS - 1) / KEYS - t_begin;

  // Each thread loads kVecs float4 of the next k and v tiles into
  // registers while the current tile is in use, then splits them into the
  // other stage of pairs: one barrier per tile.
  float4 kreg[G::kVecs], vreg[G::kVecs];
  auto fetch = [&](int it) {
    const int k0 = (t_begin + it) * KEYS;
#pragma unroll
    for (int u = 0; u < G::kVecs; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int r = idx / (HD / 4);
      const int c = 4 * (idx % (HD / 4));
      const bool ok = idx < G::kRaw / 4 && k0 + r < T_len;
      const long long off = (k0 + r) * kv_stride + c;
      kreg[u] = ok ? *reinterpret_cast<const float4*>(kb + off)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vreg[u] = ok ? *reinterpret_cast<const float4*>(vb + off)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto stash = [&](int it) {
    float2* kst = kv_pairs + (it % 2) * G::kPairs;
    float2* vst = kst + KEYS * LDK;
#pragma unroll
    for (int u = 0; u < G::kVecs; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx >= G::kRaw / 4) break;
      const int r = idx / (HD / 4);
      const int c = 4 * (idx % (HD / 4));
      const float4 kv4 = kreg[u], vv4 = vreg[u];
      const float2 k0s = split(kv4.x), k1s = split(kv4.y),
                   k2s = split(kv4.z), k3s = split(kv4.w);
      const float2 v0s = split(vv4.x), v1s = split(vv4.y),
                   v2s = split(vv4.z), v3s = split(vv4.w);
      float4* kd = reinterpret_cast<float4*>(kst + r * LDK + c);
      kd[0] = make_float4(k0s.x, k0s.y, k1s.x, k1s.y);
      kd[1] = make_float4(k2s.x, k2s.y, k3s.x, k3s.y);
      float4* vd = reinterpret_cast<float4*>(vst + r * LDV + c);
      vd[0] = make_float4(v0s.x, v0s.y, v1s.x, v1s.y);
      vd[1] = make_float4(v2s.x, v2s.y, v3s.x, v3s.y);
    }
  };
  load_rows<HD>(qs, LDQ, qb, q_stride, q0, kRows, S);
  cp_async_commit();
  if (n_tiles > 0) {
    fetch(0);
    stash(0);
  }
  if (n_tiles > 1) fetch(1);
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wr0 = q0 + 16 * warp;              // this warp's first row
  const int rA = wr0 + gid;                    // rows rA and rA + 8
  // A = q rows rA, rA + 8
  const float* qa = qs + (16 * warp + gid) * LDQ + tig;

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.0f, 0.0f};                   // per-lane partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t_begin + it) * KEYS;
    // a tile this warp's rows cannot see at all is skipped
    const bool hidden = (causal && k0 > wr0 + 15) ||
                        (window > 0 && k0 + KEYS - 1 <= wr0 - window) ||
                        wr0 >= S;
    const float2* ks = kv_pairs + (it % 2) * G::kPairs;
    const float2* vs = ks + KEYS * LDK;
    if (!hidden) {
      // ---- S = q k^T (16 x KEYS per warp) ----
      float s[KEYS / 8][4];
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        FragA a;
        a.set(qa[8 * kk], qa[8 * LDQ + 8 * kk], qa[8 * kk + 4],
              qa[8 * LDQ + 8 * kk + 4]);
        const float2* kr = ks + gid * LDK + 8 * kk + tig;
        float2 bf[KEYS / 8][2];
#pragma unroll
        for (int n = 0; n < KEYS / 8; ++n) {
          bf[n][0] = kr[8 * n * LDK];
          bf[n][1] = kr[8 * n * LDK + 4];
        }
        mma3<KEYS / 8>(s, a, bf);
      }

      // ---- online softmax on the accumulators, in units of log2 e ----
      // s[n][e]: row rA + 8 (e / 2), key k0 + 8n + 2 tig + (e % 2)
      const bool need_mask = k0 + KEYS > T_len ||
                             (causal && k0 + KEYS - 1 > wr0) ||
                             (window > 0 && k0 <= wr0 + 15 - window);
      uint32_t live = 0xffffffffu;
      float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * tig + (e % 2);
          const int qi = rA + 8 * (e / 2);
          bool ok = true;
          if (need_mask)
            ok = key < T_len && (!causal || key <= qi) &&
                 (window <= 0 || key > qi - window);
          s[n][e] = ok ? s[n][e] * scale_log2 : kMaskValue;
          if (!ok) live &= ~(1u << (4 * n + e));
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
      float rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ((live >> (4 * n + e)) & 1u)
                              ? exp2_approx(s[n][e] - m[e / 2])
                              : 0.0f;
          s[n][e] = p;
          rsum[e / 2] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rsum[r];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];

      // ---- O += p v: p's accumulators as the A operand, k renamed ----
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        FragA a;
        a.set(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float2* vr = vs + (8 * j + 2 * tig) * LDV + gid;
        float2 bf[HD / 8][2];
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          bf[n][0] = vr[8 * n];
          bf[n][1] = vr[LDV + 8 * n];
        }
        mma3<HD / 8>(o, a, bf);
      }
    }
    if (it + 1 < n_tiles) {
      stash(it + 1);              // the other stage: read last in it - 1
      if (it + 2 < n_tiles) fetch(it + 2);
    }
    __syncthreads();
  }

  // out = o / max(l, 1e-30), rows past S dropped
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = rA + 8 * r;
    if (qi >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<long long>(b) * S + qi) * q_stride +
                  static_cast<long long>(h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * tig) =
          make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int H, int K, float scale, int causal,
           int window, cudaStream_t stream) {
  using G = Tile<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tf32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      static_cast<long long>((S + kRows - 1) / kRows) * H * B;
  flash_tf32<HD><<<static_cast<unsigned>(grid), kThreads, G::kSmem,
                   stream>>>(static_cast<const float*>(q),
                             static_cast<const float*>(k),
                             static_cast<const float*>(v),
                             static_cast<float*>(out), B, S, T_len, H, K,
                             scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, S, H, hd), k/v: (B, T, K, hd), out: (B, S, H, hd), all contiguous
// f32 with 16-byte aligned bases.  hd in {32, 64, 128}, H % K == 0.
// Returns the launch's CUDA error code (0 on success).
int flash_attention_tf32_fwd(const void* q, const void* k, const void* v,
                             void* out, int B, int S, int T_len, int H,
                             int K, int hd, float scale, int causal,
                             int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      static_cast<long long>((S + kRows - 1) / kRows) * H * B > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, out, B, S, T_len, H, K, scale,
                        causal, window, stream);
    case 64:
      return launch<64>(q, k, v, out, B, S, T_len, H, K, scale,
                        causal, window, stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, T_len, H, K, scale,
                         causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
