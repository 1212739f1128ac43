// Online-softmax (flash) attention for bf16 on Hopper tensor cores (sm_90a):
// wgmma fed by TMA through a two-stage mbarrier ring.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (_flash_kernel) for bf16 inputs; f32 inputs go to
//   flash_attention_tf32.cu.
//
// What it computes (the TPU kernel's arithmetic, one rounding apart):
//   q (B, S, H, hd), k/v (B, T, K, hd) in bf16, H % K == 0, query head h
//   reads kv head h / (H / K); s = (q . k) * scale in f32; masked scores are
//   the finite -2e38 (causal: key <= query; window w > 0: key > query - w;
//   keys at or past T); running max m, alpha, l and the accumulator in f32;
//   p is zeroed explicitly where masked; out = acc / max(l, 1e-30) in bf16.
//   The one difference: p is rounded to bf16 before the p.v product (the
//   tensor cores take bf16 operands), as the model's plain attention does.
//   Exponentials are exp2(s * scale * log2(e) - m), one FMA and one
//   ex2.approx (2 ulp, subnormal results flushed to 0), with m kept in those
//   units.
//
// What bounds it on this card: operations.  At the full-width tinyllama
// shape (B 4, S = T = 2048, H 32 over K 4, hd 64, causal) the two products
// take ~6.9e10 FLOP over the causal half: 0.07 ms at the bf16 tensor-core
// rate, against ~0.02 ms for the ~75 MB of q, k, v and out.  Next in line
// is the exp2 unit: one exp2 per score, 16 per clock per SM, costs about
// as many cycles as the tensor-core work at hd 64.
//
// Design.  One CTA per (b, h, 128-query tile), issued longest tile first
// (the tile is the slowest part of blockIdx.x) so the short causal tiles
// fill the tail wave.  Three warpgroups: two consumers own 64 query rows
// each; one thread of the third (the producer) issues TMA.  q, k, v are
// read in place as (B, L, heads, hd): each is a 4-D tensor map {hd, heads,
// L, B} whose box {min(hd, 64), 1, 128, 1} is 128 rows of one head, laid
// down with the 128-byte swizzle (64-byte at hd 32); hd 128 takes two boxes
// per tile.  Keys and rows past the end are zero-filled by TMA.  The q tile
// is loaded once; k and v tiles of 128 keys go through two-stage rings,
// each stage with a full (TMA bytes) and an empty (256 consumer arrivals)
// mbarrier, so a k tile is refilled as soon as its S product is done.
// S = q.k^T is wgmma m64n128k16 with both operands K-major in shared
// memory; the softmax runs on the accumulator in registers (a row's four
// owner threads reduce with two xor-shuffles; l stays a per-thread partial
// until the end); p is packed pairwise to bf16x2, which is already the
// A-fragment layout, and O += p.v is wgmma m64n{hd}k16 with A from
// registers and v as the MN-major (transposed) B operand.  Within a
// warpgroup, S(j) and O += p(j-1).v(j-1) are issued together and the
// softmax of S(j) runs while the p.v product is still on the tensor cores.
// Kv tiles that the mask hides entirely are never loaded; only tiles that
// straddle the diagonal, a window edge or T compute a mask.  The output is
// stored from registers, rows past S dropped.  setmaxnreg moves registers
// from the producer warpgroup to the consumers.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 128;          // query rows per CTA = keys per kv tile
constexpr int kConsumers = 2;       // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;
constexpr float kMaskValue = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of one 128-row tile of hd bf16 columns, as TMA
// writes it: kChunks boxes of 128 rows x kBoxCols columns, each row
// kRowBytes (the swizzle span), 8 rows = one swizzle atom.
template <int HD>
struct Tile {
  static constexpr int kBoxCols = HD < 64 ? HD : 64;
  static constexpr int kChunks = HD / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kChunkBytes = kRows * kRowBytes;
  static constexpr int kBytes = kChunks * kChunkBytes;
  static constexpr int kAtomBytes = 8 * kRowBytes;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // q, k[2], v[2], then 9 mbarriers; +1024 to align the base
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 128 + 1024;
};

// S = q . k^T for one warpgroup: 64 x 128, K = hd in steps of 16 (issued,
// not waited for).
template <int HD>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_addr,
                                         uint32_t k_addr) {
  using G = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 16 / G::kBoxCols) * G::kChunkBytes +
                         (kk * 16 % G::kBoxCols) * 2;
    wgmma_ss_n128<0, 0>(
        s, make_desc(q_addr + off, 16, G::kAtomBytes, G::kLayout),
        make_desc(k_addr + off, 16, G::kAtomBytes, G::kLayout), kk > 0);
  }
}

// O += p . v: p as bf16 A fragments (k-step kk = keys 16kk .. 16kk + 15),
// v the K (keys) x N (hd) tile with hd contiguous: MN-major (issued, not
// waited for).
template <int HD>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4],
                                         uint32_t v_addr) {
  using G = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t db = make_desc(v_addr + kk * 16 * G::kRowBytes,
                                  G::kChunkBytes, G::kAtomBytes, G::kLayout);
    if constexpr (HD == 32) {
      wgmma_rs_n32(o, pa[kk], db);
    } else if constexpr (HD == 64) {
      wgmma_rs_n64(o, pa[kk], db);
    } else {
      wgmma_rs_n128(o, pa[kk], db);
    }
  }
}

// The online softmax of one 64 x 128 score tile on the accumulator layout:
// s[4j + e] is row r0 + 8 (e / 2), key k0 + 8j + cpair + (e % 2).  Masks
// the tile if ``need_mask``, moves m to the new row max (in units of
// scale * log2 e), leaves p = exp2(s * scale * log2 e - m) in s (0 where
// masked), and returns each row's rescale factor and this thread's partial
// row sum.
__device__ __forceinline__ void online_softmax(
    float* s, float* m, float* alpha, float* rsum, bool need_mask, int k0,
    int r0, int cpair, int T_len, int causal, int window, float scale_log2) {
  uint64_t live = ~0ull;
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + 8 * (i / 4) + cpair + (i % 2);
      const int qi = r0 + 8 * ((i / 2) % 2);
      const bool ok = key < T_len && (!causal || key <= qi) &&
                      (window <= 0 || key > qi - window);
      if (!ok) {
        s[i] = kMaskValue;
        live &= ~(1ull << i);
      }
    }
  }
  // the scale is positive, so the max of the raw scores scales exactly
  float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
    rsum[r] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float p = fast_exp2(fmaf(s[i], scale_log2, -mx[(i / 2) % 2]));
    if (need_mask && !((live >> i) & 1ull)) p = 0.0f;
    s[i] = p;
    rsum[(i / 2) % 2] += p;
  }
}

__device__ __forceinline__ void pack_p(const float* s, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            __nv_bfloat16* __restrict__ out, int B, int S, int T_len, int H,
            int K, float scale_log2, int causal, int window) {
  using G = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + G::kBytes;                 // kStages tiles
  uint8_t* v_s = k_s + kStages * G::kBytes;       // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * G::kBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // longest query tile first: the tile is the slowest part of blockIdx.x
  const int nq = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / (B * H)) * kRows;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / K);

  // kv tiles that any query of this tile can see
  const int q_last = min(q0 + kRows, S) - 1;
  const int kv_end = causal ? min(T_len, q_last + 1) : T_len;
  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_first / kRows;
  const int n_tiles = (kv_end + kRows - 1) / kRows - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 128 * kConsumers);
      mbar_init(&v_empty[s], 128 * kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, G::kBytes);
      for (int c = 0; c < G::kChunks; ++c)
        tma_load(q_s + c * G::kChunkBytes, &tm_q, q_full, c * G::kBoxCols, h,
                 q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int parity = ((it / kStages) + 1) & 1;
        const int k0 = (t_begin + it) * kRows;
        if (it >= kStages) mbar_wait(&k_empty[st], parity);
        mbar_expect_tx(&k_full[st], G::kBytes);
        for (int c = 0; c < G::kChunks; ++c)
          tma_load(k_s + st * G::kBytes + c * G::kChunkBytes, &tm_k,
                   &k_full[st], c * G::kBoxCols, kvh, k0, b);
        if (it >= kStages) mbar_wait(&v_empty[st], parity);
        mbar_expect_tx(&v_full[st], G::kBytes);
        for (int c = 0; c < G::kChunks; ++c)
          tma_load(v_s + st * G::kBytes + c * G::kChunkBytes, &tm_v,
                   &v_full[st], c * G::kBoxCols, kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int row_first = q0 + 64 * wg;         // this warpgroup's rows
    const int r0 = row_first + 16 * warp + lane / 4;   // and r0 + 8
    const int cpair = 2 * (lane % 4);           // column pair in an 8-group
    const uint32_t q_addr = smem_addr(q_s) + 64 * wg * G::kRowBytes;
    const uint32_t k_addr = smem_addr(k_s);
    const uint32_t v_addr = smem_addr(v_s);
    // only tiles on the diagonal, a window edge or T compute a mask
    auto need_mask = [&](int k0) {
      return k0 + kRows > T_len || (causal && k0 + kRows - 1 > row_first) ||
             (window > 0 && k0 <= row_first + 63 - window);
    };

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float m[2] = {kMaskValue, kMaskValue};
    float l[2] = {0.0f, 0.0f};          // per-thread partial row sums
    float alpha[2], rsum[2];
    float s[64];
    uint32_t pa[8][4];

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      // tile 0: S, softmax, p
      const int k0 = t_begin * kRows;
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.0f;
      mbar_wait(&k_full[0], 0);
      wgmma_fence();
      issue_qk<HD>(s, q_addr, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(s);
      mbar_arrive(&k_empty[0]);
      online_softmax(s, m, alpha, rsum, need_mask(k0), k0, r0, cpair, T_len,
                     causal, window, scale_log2);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = rsum[r];
      pack_p(s, pa);
    }
    // tile it: S(it) and O += p(it - 1) . v(it - 1) run on the tensor cores
    // while this warpgroup computes the softmax of S(it)
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int prev = (it - 1) % kStages;
      const int k0 = (t_begin + it) * kRows;
      mbar_wait(&k_full[st], (it / kStages) & 1);
      fence_regs<HD / 2>(o);
      fence_regs<32>(&pa[0][0]);
      wgmma_fence();
      issue_qk<HD>(s, q_addr, k_addr + st * G::kBytes);
      wgmma_commit();
      mbar_wait(&v_full[prev], ((it - 1) / kStages) & 1);
      issue_pv<HD>(o, pa, v_addr + prev * G::kBytes);
      wgmma_commit();
      wgmma_wait<1>();                  // S(it) is done, the p.v may run on
      fence_regs<64>(s);
      mbar_arrive(&k_empty[st]);
      online_softmax(s, m, alpha, rsum, need_mask(k0), k0, r0, cpair, T_len,
                     causal, window, scale_log2);
      wgmma_wait<0>();
      fence_regs<HD / 2>(o);
      fence_regs<32>(&pa[0][0]);
      mbar_arrive(&v_empty[prev]);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rsum[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      pack_p(s, pa);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % kStages;
      mbar_wait(&v_full[last], ((n_tiles - 1) / kStages) & 1);
      fence_regs<HD / 2>(o);
      fence_regs<32>(&pa[0][0]);
      wgmma_fence();
      issue_pv<HD>(o, pa, v_addr + last * G::kBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(o);
      fence_regs<32>(&pa[0][0]);
    }

    // out = o / max(l, 1e-30), rows past S dropped
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      if (qi >= S) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(b) * S + qi) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cpair) = v2;
      }
    }
  }
}

// A (B, L, heads, hd) bf16 tensor as the 4-D map {hd, heads, L, B} with box
// {min(hd, 64), 1, 128, 1}.  Returns 0 or an error code.
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int heads, int L, int B) {
  using G = Tile<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(HD) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * L};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kBoxCols), 1,
                             static_cast<cuuint32_t>(kRows), 1};
  return encode_bf16_4d(map, ptr, dims, strides, box);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int H, int K, float scale, int causal,
           int window, cudaStream_t stream) {
  using G = Tile<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = make_map<HD>(&tm_q, q, H, S, B);
  if (rc == 0) rc = make_map<HD>(&tm_k, k, K, T_len, B);
  if (rc == 0) rc = make_map<HD>(&tm_v, v, K, T_len, B);
  if (rc != 0) return rc;
  const long long grid =
      static_cast<long long>((S + kRows - 1) / kRows) * H * B;
  flash_wgmma<HD><<<static_cast<unsigned>(grid), kThreads, G::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), B, S, T_len, H, K,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, S, H, hd), k/v: (B, T, K, hd), out: (B, S, H, hd), all contiguous
// bf16 with 16-byte aligned bases.  hd in {32, 64, 128}, H % K == 0.
// Returns 0, a CUDA error code, or 10000 + a CUresult of the map encoding.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                              void* out, int B, int S, int T_len, int H,
                              int K, int hd, float scale, int causal,
                              int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      static_cast<long long>((S + kRows - 1) / kRows) * H * B > 0x7FFFFFFFLL) {
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
