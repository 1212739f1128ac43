// Mamba-2 SSD chunked scan for bf16 on Hopper tensor cores (sm_90a):
// the chunked dual form, chunk-parallel, on wgmma fed by TMA.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (_ssd_kernel)
//   for bf16 inputs; f32 inputs go to ssd_scan_tf32.cu.
//
// What it computes: x (B, S, H, P), Bm / Cm (B, S, G, N) in bf16, dt
// (B, S, H) and A (H,) in f32; head h reads B and C of group h / (H / G).
// Per (b, h) and chunk c of `chunk` steps, with cum the inclusive cumsum
// of dt * A[h] over the chunk (f32, kept in units of log2 e):
//   1. chunk state   S_c = (B o w)^T x,  w_j = dt_j exp(cum_last - cum_j),
//                    and the chunk's decay exp(cum_last);
//   2. state passing S_before[c] = exp(cum_last[c-1]) S_before[c-1]
//                                  + S_c[c-1],  S_before[0] = 0;
//   3. chunk scan    y_i = exp(cum_i) C_i S_before[c]
//                        + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j,
// y stored in bf16.  This is the split of mamba_ssm's ssd_combined.py
// (chunk state, state passing, chunk scan): three launches, one call.
//
// Rounding points (the tensor cores take bf16 operands; everything else,
// cum, the exponentials, every accumulator and the state carry, is f32):
//   (a) x o w, the operand of the chunk-state product (phase 1);
//   (b) S_before, the operand of C . S_before (phase 2 stores it in bf16);
//   (c) y.
// G' = (C B^T) o L o dt, the operand of G' . x, goes to the tensor cores
// as two bf16 operands, hi = bf16(G') and lo = bf16(G' - hi), so it enters
// the product to ~2^-17 relative.  Rounded once to bf16, G' was the
// largest error term where |y| is largest (the step's own term G'_ii x_i):
// at full width the max |diff| from the f32 recurrence came to 1.25x the
// plain path's in one draw of the inputs; the second operand costs one
// more G' . x product of depth 64 per kv tile and leaves y's own rounding
// as the largest error.  The model's plain path (ssd_chunked) rounds x dt,
// B o decay, C o e^cum, S_before, (C B^T) o L, the chunk states and the
// partial outputs (tests/test_torch_ssd_wgmma.py and the card tests hold
// the route to within 1.25x of that path's distance from the recurrence).
//
// What bounds it on this card: operations, with bytes close behind.  At
// the full-width mamba2-780m shape (B 4, S 2048, H 48, P 64, G 1, N 128,
// chunk 256) the lower-triangle work is ~3.2e10 FLOP, 0.033 ms at the bf16
// tensor-core rate, against 0.032 ms for the ~106 MB of x, dt, B, C and y.
// The f32 chunk states (25 MB written, read back) and the bf16 S_before
// (12.6 MB) add ~0.015 ms of traffic that the one-CTA-per-(b, h) f32
// kernel does not have; the price of running every chunk at once.
//
// Design.  Every bf16 tile is a TMA box of 64 rows x 64 columns (128-byte
// swizzle), read in place from (B, L, heads, d) through a 4-D tensor map;
// columns past N or P read as zero, so N < 64 and P = 32 pad to one box
// and every product is m64n64 or m64n128.
//   Phase 1, one CTA (2 warpgroups) per (b, h, chunk): B and x of the chunk
//   arrive by TMA while the CTA loads dt and scans it (a warp scan, then
//   the warps' totals); w scales the x tile in shared memory, rewritten in
//   place as bf16 (a row of a swizzled tile stays in its own 128 bytes, so
//   the rewrite needs no address arithmetic, and x is the smaller of the
//   two operands; a register A fragment of B^T would need ldmatrix.trans
//   through the swizzle); then S_c = B^T (x o w) on wgmma with both
//   operands MN-major from shared memory, warpgroup g owning the 64-row
//   slices g, g + 2, ... of N.  S_c goes to f32 scratch.  (Rewriting and
//   multiplying each 64-row tile as it arrives, one mbarrier per tile,
//   measured slower on an H100: PERF.md.)
//   Phase 2, per (b, h) and 1024 elements of the N x P state: the f32
//   carry over the chunks, elementwise, the loads of four chunks issued
//   ahead of the carry, S_before stored in bf16.
//   Phase 3, one CTA per (b, h, chunk, 128-row block), two warpgroups of
//   64 rows.  C's 128 rows and S_before are loaded once; B and x arrive in
//   64-row kv tiles through a two-stage ring (one stage where two do not
//   fit in shared memory) with full (TMA bytes) and empty (256 arrivals)
//   mbarriers.  No producer warp (a ninth warp would cap the registers at
//   96 with two CTAs on an SM): thread 0 issues the first loads, and the
//   first thread of the warpgroup that uses every kv tile refills a stage
//   once both warpgroups have released it.  Each warpgroup, per kv tile
//   j <= i: G = C B_j^T (wgmma, both K-major, exactly flash's q k^T),
//   then on the accumulator in registers the decay exp2(cum_i - cum_j),
//   masked to -inf where j > i before the exponential, times dt_j; G'
//   split into hi + lo bf16 A fragments (flash's p, twice) and acc += hi
//   x_j + lo x_j (x raw from TMA, MN-major).  G(j) and the p.x of tile
//   j - 1 are issued together and G'(j) is formed while the p.x runs, as
//   flash overlaps its softmax; acc = C S_before (C K-major, S_before
//   MN-major), rows scaled by exp(cum_i), is issued with G(0).  Kv tiles
//   right of the diagonal are never loaded; a warpgroup that does not use
//   a tile still waits for it before it releases it, so releases stay in
//   tile order.  y is stored from registers.  Blocks of one chunk are
//   adjacent in launch order (longer block first) and heads of one
//   (b, chunk) next to each other, so x and B tiles that several CTAs read
//   come from L2.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;                  // rows of a tile, kv tile rows
constexpr int kBoxCols = 64;               // bf16 columns of a box (128 B)
constexpr int kRowBytes = kBoxCols * 2;
constexpr int kBoxBytes = kTile * kRowBytes;   // one 64 x 64 box, 8 KB
constexpr int kAtomBytes = 8 * kRowBytes;      // 8 rows: one swizzle atom
constexpr uint64_t kLayout = 1;                // 128-byte swizzle
constexpr int kScanThreads = 256;              // phase 1 CTA
constexpr int kScanRows = 128;                 // phase 3 rows per CTA
constexpr int kConsumers = 2;                  // phase 3 warpgroups
constexpr int kChunkThreads = 128 * kConsumers;
constexpr int kMaxWarps = 256 / 32;            // warps a chunk's scan spans
constexpr int kPassThreads = 256;              // phase 2, 4 elements each
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int boxes(int cols) {
  return (cols + kBoxCols - 1) / kBoxCols;
}

// dts[j] = dt[b, c0 + j, h] (f32 with a stride of H: plain loads, TMA's
// 16-byte box rule rules it out) and cum2[j] = log2(e) * (inclusive cumsum
// of dts[k] * a over k <= j), one step per thread: a scan within each warp,
// then the totals of the warps before it.  Every thread of the CTA calls
// it (chunk <= blockDim.x).
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             long long row0, int H, float a,
                                             int chunk, float* dts,
                                             float* cum2, float* part) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  float v = 0.0f;
  if (tid < chunk) {
    const float d = dt[(row0 + tid) * H];
    dts[tid] = d;
    v = d * a;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31 && warp * 32 < chunk) part[warp] = v;
  __syncthreads();
  if (tid < chunk) {
    for (int w = 0; w < warp; ++w) v += part[w];
    cum2[tid] = v * kLog2e;
  }
  __syncthreads();
}

// (a, b) as bf16x2 hi = bf16(a, b) and lo = bf16(a - hi_a, b - hi_b).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - hf.x, b - hf.y);
}

// ---- phase 1: chunk states -------------------------------------------

template <int P>
__global__ void __launch_bounds__(kScanThreads, 2)
ssd_chunk_state(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ states, float* __restrict__ decay,
                int S, int H, int G, int N, int chunk) {
  constexpr int PB = boxes(P);
  constexpr int PN = PB * kBoxCols;
  const int NB = boxes(N);
  const int nc = S / chunk;
  const int h = blockIdx.x % H;
  const int c = (blockIdx.x / H) % nc;
  const int b = blockIdx.x / (H * nc);
  const int g = h / (H / G);
  const int bh = b * H + h;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int span = chunk * kRowBytes;       // one 64-column box, all rows
  uint8_t* bs = smem;                       // NB boxes of B
  uint8_t* xs = bs + NB * span;             // PB boxes of x
  float* dts = reinterpret_cast<float*>(xs + PB * span);
  float* cum2 = dts + chunk;
  float* w = cum2 + chunk;
  float* part = w + chunk;                  // kMaxWarps warp totals
  uint64_t* bar = reinterpret_cast<uint64_t*>(part + kMaxWarps);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, (NB + PB) * span);
    for (int rt = 0; rt < chunk / kTile; ++rt) {
      const int row = c * chunk + rt * kTile;
      for (int nb = 0; nb < NB; ++nb)
        tma_load(bs + nb * span + rt * kBoxBytes, &tm_b, bar, nb * kBoxCols,
                 g, row, b);
      for (int pb = 0; pb < PB; ++pb)
        tma_load(xs + pb * span + rt * kBoxBytes, &tm_x, bar, pb * kBoxCols,
                 h, row, b);
    }
  }
  chunk_cumsum(dt + h, static_cast<long long>(b) * S + c * chunk, H, A[h],
               chunk, dts, cum2, part);     // its __syncthreads publish bar
  const float last = cum2[chunk - 1];
  for (int j = tid; j < chunk; j += kScanThreads)
    w[j] = dts[j] * exp2f(last - cum2[j]);
  if (tid == 0) decay[static_cast<long long>(bh) * nc + c] = exp2f(last);
  __syncthreads();

  // x o w in place as bf16 (rounding point (a)): one 128-byte row of a
  // swizzled box per warp and step (a row stays within its own 128 bytes),
  // the row's w read once
  mbar_wait(bar, 0);
  const int lane = tid % 32;
  for (int r = tid / 32; r < PB * chunk; r += kScanThreads / 32) {
    uint32_t* word = reinterpret_cast<uint32_t*>(xs + r * kRowBytes) + lane;
    const float wj = w[r < chunk ? r : r - chunk];     // PB <= 2 boxes
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(word));
    *word = pack_bf16x2(f.x * wj, f.y * wj);
  }
  fence_proxy_async();
  __syncthreads();

  // S_c = B^T (x o w): M = N (64-row slices), N = P, K = chunk
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int r0 = 16 * warp + lane / 4;
  const int cpair = 2 * (lane % 4);
  const uint32_t b_addr = smem_addr(bs);
  const uint32_t x_addr = smem_addr(xs);
  float* out = states + (static_cast<long long>(bh) * nc + c) * N * P;
  for (int m = wg; m < NB; m += kScanThreads / 128) {
    float acc[PN / 2];
#pragma unroll
    for (int i = 0; i < PN / 2; ++i) acc[i] = 0.0f;
    wgmma_fence();
    for (int kk = 0; kk < chunk / 16; ++kk) {
      const uint64_t da = make_desc(b_addr + m * span + kk * 16 * kRowBytes,
                                    span, kAtomBytes, kLayout);
      const uint64_t db = make_desc(x_addr + kk * 16 * kRowBytes, span,
                                    kAtomBytes, kLayout);
      if constexpr (PN == 64) {
        wgmma_ss_n64<1, 1>(acc, da, db, kk > 0);
      } else {
        wgmma_ss_n128<1, 1>(acc, da, db, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<PN / 2>(acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = m * kTile + r0 + 8 * r;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < PN / 8; ++q) {
        const int p = 8 * q + cpair;
        if (p < P)
          *reinterpret_cast<float2*>(&out[static_cast<long long>(n) * P + p]) =
              make_float2(acc[4 * q + 2 * r], acc[4 * q + 2 * r + 1]);
      }
    }
  }
}

// ---- phase 2: state passing ------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ states,
               const float* __restrict__ decay,
               __nv_bfloat16* __restrict__ before, int nc, int NP) {
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= NP) return;
  const long long bh = blockIdx.y;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // the loads of kAhead chunks are issued before the carry needs them
  constexpr int kAhead = 4;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 sc[kAhead];
    float d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        sc[k] = *reinterpret_cast<const float4*>(
            &states[(bh * nc + c0 + k) * NP + e]);
        d[k] = decay[bh * nc + c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        // rounding point (b): the operand of C . S_before
        uint2 packed;
        packed.x = pack_bf16x2(s.x, s.y);
        packed.y = pack_bf16x2(s.z, s.w);
        *reinterpret_cast<uint2*>(&before[(bh * nc + c0 + k) * NP + e]) =
            packed;
        s = make_float4(s.x * d[k] + sc[k].x, s.y * d[k] + sc[k].y,
                        s.z * d[k] + sc[k].z, s.w * d[k] + sc[k].w);
      }
    }
  }
}

// ---- phase 3: chunk scan ---------------------------------------------

template <int P>
__global__ void __launch_bounds__(kChunkThreads, P <= 64 ? 2 : 1)
ssd_chunk_scan(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_b,
               const __grid_constant__ CUtensorMap tm_c,
               const __grid_constant__ CUtensorMap tm_s,
               const float* __restrict__ dt, const float* __restrict__ A,
               __nv_bfloat16* __restrict__ y, int S, int H, int G, int N,
               int chunk, int stages) {
  constexpr int PB = boxes(P);
  constexpr int PN = PB * kBoxCols;
  const int NB = boxes(N);
  const int nc = S / chunk;
  const int nblk = (chunk + kScanRows - 1) / kScanRows;
  // blocks of one chunk adjacent, the longer (later) block first; heads of
  // one (b, chunk) next to each other
  const int blk = nblk - 1 - static_cast<int>(blockIdx.x % nblk);
  const int bhc = blockIdx.x / nblk;
  const int h = bhc % H;
  const int c = (bhc / H) % nc;
  const int b = bhc / (H * nc);
  const int g = h / (H / G);
  const int bh = b * H + h;
  const int n_tiles = min(2 * blk + 2, chunk / kTile);   // kv tiles to load

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = (NB + PB) * kBoxBytes;
  uint8_t* cs = smem;                                  // 2 x NB boxes of C
  uint8_t* sb = cs + kConsumers * NB * kBoxBytes;      // PB x (N rows) boxes
  uint8_t* ring = sb + PB * N * kRowBytes;             // stages x (B, x)
  float* dts = reinterpret_cast<float*>(ring + stages * stage_bytes);
  float* cum2 = dts + chunk;
  float* part = cum2 + chunk;
  uint64_t* bars = reinterpret_cast<uint64_t*>(part + kMaxWarps);
  uint64_t* cs_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  auto load_kv = [&](int it) {
    const int st = it % stages;
    uint8_t* dst = ring + st * stage_bytes;
    const int row = c * chunk + it * kTile;
    mbar_expect_tx(&full[st], stage_bytes);
    for (int nb = 0; nb < NB; ++nb)
      tma_load(dst + nb * kBoxBytes, &tm_b, &full[st], nb * kBoxCols, g, row,
               b);
    for (int pb = 0; pb < PB; ++pb)
      tma_load(dst + (NB + pb) * kBoxBytes, &tm_x, &full[st], pb * kBoxCols,
               h, row, b);
  };
  if (tid == 0) {
    mbar_init(cs_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    fence_mbar_init();
    const int tiles = min(kConsumers, chunk / kTile - 2 * blk);
    mbar_expect_tx(cs_full, tiles * NB * kBoxBytes +
                                (c > 0 ? PB * N * kRowBytes : 0));
    for (int t = 0; t < tiles; ++t)
      for (int nb = 0; nb < NB; ++nb)
        tma_load(cs + (t * NB + nb) * kBoxBytes, &tm_c, cs_full,
                 nb * kBoxCols, g, c * chunk + (2 * blk + t) * kTile, b);
    if (c > 0)
      for (int pb = 0; pb < PB; ++pb)
        tma_load(sb + pb * N * kRowBytes, &tm_s, cs_full, pb * kBoxCols, 0, c,
                 bh);
    for (int it = 0; it < min(stages, n_tiles); ++it) load_kv(it);
  }
  chunk_cumsum(dt + h, static_cast<long long>(b) * S + c * chunk, H, A[h],
               chunk, dts, cum2, part);     // its __syncthreads publish bars

  const int wg = tid / 128;
  const int ti = 2 * blk + wg;                 // this warpgroup's row tile
  const bool active = ti * kTile < chunk;
  // the warpgroup that uses every kv tile refills the ring: its first
  // thread waits for a stage's release and loads the next tile into it
  const bool refills = tid % 128 == 0 && ti == n_tiles - 1;
  const int lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int r0 = ti * kTile + 16 * warp + lane / 4;   // rows r0, r0 + 8
  const int cpair = 2 * (lane % 4);
  const uint32_t c_addr = smem_addr(cs) + wg * NB * kBoxBytes;
  const uint32_t s_addr = smem_addr(sb);
  const uint32_t ring_addr = smem_addr(ring);
  auto c_desc = [&](int kk) {
    return make_desc(c_addr + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16,
                     kAtomBytes, kLayout);
  };

  float acc[PN / 2];
#pragma unroll
  for (int i = 0; i < PN / 2; ++i) acc[i] = 0.0f;
  float gs[kTile / 2];
  uint32_t pa[2][kTile / 16][4];     // G' = hi + lo

  // acc = C S_before (issued, not waited for)
  auto issue_inter = [&]() {
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t db = make_desc(s_addr + kk * 16 * kRowBytes,
                                    N * kRowBytes, kAtomBytes, kLayout);
      if constexpr (PN == 64) {
        wgmma_ss_n64<0, 1>(acc, c_desc(kk), db, kk > 0);
      } else {
        wgmma_ss_n128<0, 1>(acc, c_desc(kk), db, kk > 0);
      }
    }
  };
  // gs = C B_j^T, both K-major (issued, not waited for)
  auto issue_g = [&](int st) {
    const uint32_t b_addr = ring_addr + st * stage_bytes;
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_n64<0, 0>(
          gs, c_desc(kk),
          make_desc(b_addr + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16,
                    kAtomBytes, kLayout),
          kk > 0);
  };
  // acc += hi x_j + lo x_j, x MN-major (issued, not waited for)
  auto issue_px = [&](int st) {
    const uint32_t x_addr = ring_addr + st * stage_bytes + NB * kBoxBytes;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint64_t db = make_desc(x_addr + kk * 16 * kRowBytes,
                                      kBoxBytes, kAtomBytes, kLayout);
        if constexpr (PN == 64) {
          wgmma_rs_n64(acc, pa[half][kk], db);
        } else {
          wgmma_rs_n128(acc, pa[half][kk], db);
        }
      }
  };
  // G' = G o exp(cum_i - cum_j) o dt_j in place, j > i masked to -inf
  // before the exponential (only the diagonal tile has such j)
  auto decay_tile = [&](int it) {
    const float ci[2] = {cum2[r0], cum2[r0 + 8]};
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int j = it * kTile + 8 * (i / 4) + cpair + (i % 2);
      float d = ci[(i / 2) % 2] - cum2[j];
      if (it == ti && j > r0 + 8 * ((i / 2) % 2))
        d = __int_as_float(0xff800000);   // -inf
      gs[i] = gs[i] * (fast_exp2(d) * dts[j]);
    }
  };
  // G' as the A fragments of two bf16 operands, hi = bf16(G') and
  // lo = bf16(G' - hi): hi + lo carries G' to ~2^-17 relative
  auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_bf16x2(gs[8 * kk + 2 * q], gs[8 * kk + 2 * q + 1],
                     pa[0][kk][q], pa[1][kk][q]);
  };
  // this warpgroup is done with kv tile t: release its stage and, in the
  // refilling warpgroup, load tile t + stages into it once both have
  auto release = [&](int t) {
    mbar_arrive(&empty[t % stages]);
    if (refills && t + stages < n_tiles) {
      mbar_wait(&empty[t % stages], (t / stages) & 1);
      load_kv(t + stages);
    }
  };

  if (active) {
    // Tile it: G(it) and the p.x of tile it - 1 run on the tensor cores
    // together, and G'(it) is formed while the p.x is still running (with
    // one stage, the p.x of each tile runs at the end of its iteration).
    const bool overlap = stages > 1;
    mbar_wait(cs_full, 0);
    for (int it = 0; it <= ti; ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      fence_regs<PN / 2>(acc);
      fence_regs<kTile / 2>(&pa[0][0][0]);
      wgmma_fence();
      const bool inter = it == 0 && c > 0;
      if (inter) {
        issue_inter();
        wgmma_commit();
      }
      issue_g(st);
      wgmma_commit();
      const bool px = overlap && it > 0;
      if (px) {
        issue_px((it - 1) % stages);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs<kTile / 2>(gs);
      if (inter) {
        // acc = C S_before, row i scaled by exp(cum_i)
        fence_regs<PN / 2>(acc);
        const float e0 = exp2f(cum2[r0]);
        const float e1 = exp2f(cum2[r0 + 8]);
#pragma unroll
        for (int i = 0; i < PN / 2; ++i) acc[i] *= (i / 2) % 2 ? e1 : e0;
      }
      decay_tile(it);
      if (px) {
        wgmma_wait<0>();
        fence_regs<PN / 2>(acc);
        fence_regs<kTile / 2>(&pa[0][0][0]);
        release(it - 1);
      }
      split();
      if (!overlap) {
        fence_regs<PN / 2>(acc);
        fence_regs<kTile / 2>(&pa[0][0][0]);
        wgmma_fence();
        issue_px(st);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<PN / 2>(acc);
        fence_regs<kTile / 2>(&pa[0][0][0]);
        release(it);
      }
    }
    if (overlap) {
      fence_regs<PN / 2>(acc);
      fence_regs<kTile / 2>(&pa[0][0][0]);
      wgmma_fence();
      issue_px(ti % stages);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<PN / 2>(acc);
      fence_regs<kTile / 2>(&pa[0][0][0]);
      release(ti);
    }
  }
  // kv tiles this warpgroup does not use: it waits for each before it
  // releases it, so that releases stay in tile order
  for (int it = active ? ti + 1 : 0; it < n_tiles; ++it) {
    mbar_wait(&full[it % stages], (it / stages) & 1);
    mbar_arrive(&empty[it % stages]);
  }

  if (!active) return;
  // y from registers (rounding point (c)); columns past P dropped
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long s = static_cast<long long>(b) * S +
                        static_cast<long long>(c) * chunk + r0 + 8 * r;
    __nv_bfloat16* yrow = y + (s * H + h) * P;
#pragma unroll
    for (int q = 0; q < PN / 8; ++q) {
      const int p = 8 * q + cpair;
      if (p < P)
        *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __floats2bfloat162_rn(
            acc[4 * q + 2 * r], acc[4 * q + 2 * r + 1]);
    }
  }
}

// ---- host side -------------------------------------------------------

struct Smem {
  int state;       // phase 1
  int scan;        // phase 3
  int stages;      // phase 3 ring stages
};

Smem smem_bytes(int P, int N, int chunk) {
  const int PB = boxes(P), NB = boxes(N);
  Smem s;
  s.state = (NB + PB) * chunk * kRowBytes + 3 * chunk * 4 + kMaxWarps * 4 +
            8 + 1024;
  const int fixed = kConsumers * NB * kBoxBytes + PB * N * kRowBytes +
                    2 * chunk * 4 + kMaxWarps * 4 + 1024;
  s.stages = 2;
  s.scan = fixed + 2 * (NB + PB) * kBoxBytes + 8 * 5;
  if (s.scan > kMaxSmem) {
    s.stages = 1;
    s.scan = fixed + (NB + PB) * kBoxBytes + 8 * 3;
  }
  return s;
}

// A (B, L, heads, d) bf16 tensor as the 4-D map {d, heads, L, B} with box
// {64, 1, 64, 1}: one 64-row, 64-column tile (columns past d read 0).
int make_map(CUtensorMap* map, const void* ptr, int d, int heads, int L,
             int B) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * L};
  const cuuint32_t box[4] = {kBoxCols, 1, kTile, 1};
  return encode_bf16_4d(map, ptr, dims, strides, box);
}

template <int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* states, float* decay,
           void* before, int B, int S, int H, int G, int N, int chunk,
           int phases, cudaStream_t stream) {
  const Smem sm = smem_bytes(P, N, chunk);
  if (sm.state > kMaxSmem || sm.scan > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / chunk;
  CUtensorMap tm_x, tm_b, tm_c, tm_s;
  int rc = make_map(&tm_x, x, P, H, S, B);
  if (rc == 0) rc = make_map(&tm_b, Bm, N, G, S, B);
  if (rc == 0) rc = make_map(&tm_c, Cm, N, G, S, B);
  // S_before (B*H, nc, N, P) as {P, N, nc, B*H}, box {64, N, 1, 1}
  if (rc == 0) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(P),
                                static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(nc),
                                static_cast<cuuint64_t>(B) * H};
    const cuuint64_t row = static_cast<cuuint64_t>(P) * 2;
    const cuuint64_t strides[3] = {row, row * N, row * N * nc};
    const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(N), 1, 1};
    rc = encode_bf16_4d(&tm_s, before, dims, strides, box);
  }
  if (rc != 0) return rc;
  cudaError_t err;
  if (phases & 1) {
    err = cudaFuncSetAttribute(ssd_chunk_state<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sm.state);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_state<P><<<B * H * nc, kScanThreads, sm.state, stream>>>(
        tm_x, tm_b, dt, A, states, decay, S, H, G, N, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 2) {
    const int NP = N * P;
    const dim3 grid((NP / 4 + kPassThreads - 1) / kPassThreads, B * H);
    ssd_state_pass<<<grid, kPassThreads, 0, stream>>>(
        states, decay, static_cast<__nv_bfloat16*>(before), nc, NP);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 4) {
    err = cudaFuncSetAttribute(ssd_chunk_scan<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sm.scan);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nblk = (chunk + kScanRows - 1) / kScanRows;
    ssd_chunk_scan<P><<<B * H * nc * nblk, kChunkThreads, sm.scan, stream>>>(
        tm_x, tm_b, tm_c, tm_s, dt, A, static_cast<__nv_bfloat16*>(y), S, H,
        G, N, chunk, sm.stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// x: (B, S, H, P), Bm/Cm: (B, S, G, N), y: (B, S, H, P), all contiguous
// bf16 with 16-byte aligned bases; dt: (B, S, H) f32, A: (H,) f32.
// Scratch from the caller: states (B*H, S/chunk, N, P) f32, decay
// (B*H, S/chunk) f32, before (B*H, S/chunk, N, P) bf16.  chunk a multiple
// of 64 up to 256, P in {32, 64, 128}, N a multiple of 16 up to 256,
// H % G == 0, S % chunk == 0.  ``phases`` is a mask of the launches to
// run: 1 chunk states, 2 state passing, 4 chunk scan (7 = the whole scan).
// Returns 0, a CUDA error code, or 10000 + a CUresult of a map encoding.
int ssd_scan_wgmma_fwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, void* y, float* states,
                       float* decay, void* before, int B, int S, int H, int P,
                       int G, int N, int chunk, int phases,
                       cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || chunk <= 0 ||
      H % G != 0 || chunk % kTile != 0 || chunk > 256 || N % 16 != 0 ||
      N > 256 || S % chunk != 0 ||
      static_cast<long long>(B) * H * (S / chunk) * 2 > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (P) {
    case 32:
      return launch<32>(x, dt, A, Bm, Cm, y, states, decay, before, B, S, H,
                        G, N, chunk, phases, stream);
    case 64:
      return launch<64>(x, dt, A, Bm, Cm, y, states, decay, before, B, S, H,
                        G, N, chunk, phases, stream);
    case 128:
      return launch<128>(x, dt, A, Bm, Cm, y, states, decay, before, B, S, H,
                         G, N, chunk, phases, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
