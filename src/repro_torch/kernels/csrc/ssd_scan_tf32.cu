// Mamba-2 SSD chunked scan for f32 on Hopper (sm_90a) tensor cores: the
// chunked dual form, chunk-parallel, every product in split TF32
// (csrc/tf32_mma.cuh) on mma.sync fed by cp.async.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (_ssd_kernel)
//   for f32 inputs; bf16 inputs go to ssd_scan_wgmma.cu.
//
// What it computes: x (B, S, H, P), Bm / Cm (B, S, G, N), dt (B, S, H) and
// A (H,), all f32; head h reads B and C of group h / (H / G).  Per (b, h)
// and chunk c of `chunk` steps, with cum the inclusive cumsum of dt * A[h]
// over the chunk (f32, kept in units of log2 e):
//   0. chunk scores  G = C B^T over the chunk, once per (b, chunk, group):
//                    every head of the group reads it;
//   1. chunk state   S_c = (B o w)^T x,  w_j = dt_j exp(cum_last - cum_j),
//                    and the chunk's decay exp(cum_last);
//   2. state passing S_before[c] = exp(cum_last[c-1]) S_before[c-1]
//                                  + S_c[c-1],  S_before[0] = 0;
//   3. chunk scan    y_i = exp(cum_i) C_i S_before[c]
//                        + sum_{j<=i} G_ij exp(cum_i - cum_j) dt_j x_j.
// Four launches behind one call.  Every product (C B^T over N, (B o w)^T x
// and G' x over the chunk, C S_before over N) is split TF32: each operand
// hi + lo, both rounded to TF32, and three TF32 products accumulated in
// f32 (~2^-21 relative per product).  cum, the exponentials (ex2.approx,
// 2 ulp), w, G' and the state carry are f32 on the CUDA cores; the scores,
// the chunk states and S_before stay f32 in device memory.
//
// What bounds it on this card: operations.  At the full-width mamba2-780m
// shape (B 4, S 2048, H 48, P 64, G 1, N 128, chunk 256) the lower-triangle
// work is ~3.2e10 FLOP as the bf16 route counts it (C B^T per head), three
// TF32 products each: 0.196 ms at the dense TF32 rate (495 TFLOP/s; 0.48 ms
// at the f32 rate of the CUDA cores), against 0.063 ms for the ~211 MB of
// x, dt, B, C and y.  Computing C B^T once per group instead of per head
// takes 43 % of that work away at G 1 (1.8e10 FLOP left); mma.sync reaches
// ~320 TFLOP/s of TF32 on an H100 (repro_torch.profile_mma), so ~0.17 ms
// is this design's floor.  The chunk states and S_before (50 MB each,
// written and read back) add ~0.06 ms of traffic: the price of running
// every chunk at once.
//
// Design.  Tiles are copied raw with cp.async; rows past the chunk and
// columns past N read as zero, so any chunk (padded to 16 rows) and any N
// that is a multiple of 4 run the same code.  An operand that all warps of
// a CTA read (x, S_before) is split once per CTA and tile into (hi, lo)
// pairs in shared memory (split_tile); one that a warp owns (C, B o w, G')
// is split in registers as its fragment is loaded, over eight n-tiles.
// Rows are padded so that every fragment load hits distinct banks.  The
// host picks the chunk-scan CTA rows and the chunk-state key-tile rows
// (ssd_scan.py::tf32_plan, from the sums that ssd_scan_tf32_smem reports);
// this file checks them against the device's shared memory.
//   Phase 0, one CTA of four warps per (b, chunk, group, 64 x 64 block at
//   or left of the diagonal): G = C B^T into f32 scratch.
//   Phase 1, one CTA of eight warps per (b, h, chunk, 128 state rows): the
//   chunk streams through in key tiles; each warp owns 16 state rows, its
//   A fragments B^T scaled by w as they are loaded.  S_c goes to f32
//   scratch.
//   Phase 2, per (b, h) and 1024 elements of the N x P state: the f32
//   carry over the chunks, elementwise, S_before written over S_c in place
//   (each element's chunk states are read before they are overwritten).
//   Phase 3, one CTA per (b, h, chunk, block of up to 128 rows), a warp per
//   16 rows, through a two-stage ring of 16-row tiles: first S_before in
//   tiles of its N rows (acc = C S_before, then rows scaled by
//   exp(cum_i)), then the key tiles at or left of the block's rows
//   (acc += G' x, G' = G exp(cum_i - cum_j) dt_j for j <= i, 0 elsewhere,
//   no exponential of a positive difference, formed from the scores as
//   they are loaded).  A
//   warp skips the key n-tiles right of its rows.  y is stored from
//   registers.  Blocks of one chunk are adjacent in launch order, the later
//   (longer) block first.

#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr int kScoreTile = 64;              // phase 0: 64 x 64 blocks
constexpr int kScoreThreads = 128;          // phase 0: 4 warps
constexpr int kStateThreads = 256;          // phase 1: 8 warps
constexpr int kStateRows = 16 * kStateThreads / 32;   // 128 state rows
constexpr int kLdB1 = kStateRows + 8;       // phase 1 raw B rows (floats)
constexpr int kPassThreads = 256;           // phase 2, 4 elements each
constexpr int kMaxRows = 128;               // phase 3 rows per CTA
constexpr int kScanKeys = 16;               // phase 3 key-tile rows
constexpr int kSpan = 64;                   // dt / cum arrays: chunk to 64
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Side of the (chunk x chunk) score block in device memory: 64-row blocks.
__host__ __device__ constexpr int score_side(int chunk) {
  return round_up(chunk, kScoreTile);
}

// Floats of the dt / cum arrays (and their segment totals) for a chunk:
// every key tile of 16 or 32 rows ends within round_up(chunk, 64).
__host__ __device__ constexpr int array_floats(int chunk) {
  return 2 * round_up(chunk, kSpan) + round_up(chunk, kSpan) / 32;
}

// phase 0: raw C and B rows of 64-row blocks, rows of N (rounded up to 8)
// + 4 floats
__host__ __device__ constexpr int score_smem(int N) {
  return 4 * 2 * kScoreTile * (round_up(N, 8) + 4);
}

// phase 1: a ring of raw B (128 columns) and x tiles, x split into pairs
__host__ __device__ constexpr int state_smem(int P, int chunk, int keys) {
  return 4 * kStages * keys * (kLdB1 + P) + 8 * keys * (P + 4) +
         4 * array_floats(chunk);
}

// phase 3: raw C rows (N rounded up to the key tile, + 4 floats), a ring of
// (score rows of kScanKeys + 4 floats, raw x or S_before rows), the x or
// S_before tile split into pairs (rows of P + 4)
__host__ __device__ constexpr int scan_smem(int P, int N, int chunk,
                                            int rows) {
  return 4 * (rows * (round_up(N, kScanKeys) + 4) +
              kStages * (rows * (kScanKeys + 4) + kScanKeys * P)) +
         8 * kScanKeys * (P + 4) + 4 * array_floats(chunk);
}

// dts[j] = dt[b, c0 + j, h] (0 past the chunk) and cum2[j] = log2(e) *
// (inclusive cumsum of dts[k] * a over k <= j), for j < round_up(chunk,
// 64): each warp scans 32-step segments, then every step adds the totals of
// the segments before it.  Every thread of the CTA calls it.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             int H, float a, int chunk,
                                             float* dts, float* cum2,
                                             float* part) {
  const int len = round_up(chunk, kSpan);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  for (int j = tid; j < len; j += blockDim.x)
    dts[j] = j < chunk ? dt[static_cast<long long>(j) * H] : 0.0f;
  __syncthreads();
  for (int seg = tid / 32; seg < len / 32; seg += blockDim.x / 32) {
    const int j = seg * 32 + lane;
    float v = dts[j] * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    cum2[j] = v;
    if (lane == 31) part[seg] = v;
  }
  __syncthreads();
  for (int j = tid; j < len; j += blockDim.x) {
    float add = 0.0f;
    for (int s = 0; s < j / 32; ++s) add += part[s];
    cum2[j] = (cum2[j] + add) * kLog2e;
  }
  __syncthreads();
}

// Rows [r0, r0 + n_rows) of a block whose first row is ``src`` (rows
// ``stride`` floats apart, ``width`` floats read of each, a multiple of 4)
// into dst[r * ld + col] for col < cols (a multiple of 4 >= width) with
// cp.async; rows at or past ``valid`` and columns past ``width`` are zero.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long stride, int r0,
                                          int n_rows, int valid, int width,
                                          int cols) {
  const int vecs = cols / 4;
  for (int idx = threadIdx.x; idx < n_rows * vecs; idx += blockDim.x) {
    const int r = idx / vecs;
    const int col = 4 * (idx % vecs);
    const bool ok = r0 + r < valid && col < width;
    const float* g = ok ? src + (r0 + r) * stride + col : src;
    cp_async16(dst + r * ld + col, g, ok ? 16 : 0);
  }
}

// ---- phase 0: chunk scores -------------------------------------------

__global__ void __launch_bounds__(kScoreThreads)
ssd_scores_tf32(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ scores, int S, int G, int N, int chunk) {
  const int L = score_side(chunk);
  const int nb = L / kScoreTile;
  const int nc = S / chunk;
  int idx = blockIdx.x;
  const int kb = idx % nb;
  idx /= nb;
  const int rb = idx % nb;
  idx /= nb;
  const int g = idx % G;
  idx /= G;
  const int c = idx % nc;
  const int b = idx / nc;
  if (kb > rb) return;                         // right of the diagonal
  const int N8 = round_up(N, 8);
  const int LD = N8 + 4;
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * chunk;
  const long long stride = static_cast<long long>(G) * N;

  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);     // 64 x LD
  float* bs = cs + kScoreTile * LD;                // 64 x LD
  load_rows(cs, LD, Cm + (row0 * G + g) * N, stride, rb * kScoreTile,
            kScoreTile, chunk, N, N8);
  load_rows(bs, LD, Bm + (row0 * G + g) * N, stride, kb * kScoreTile,
            kScoreTile, chunk, N, N8);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  float acc[kScoreTile / 8][4];
#pragma unroll
  for (int n = 0; n < kScoreTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const float* ca = cs + (16 * warp + gid) * LD + tig;
  const float* br = bs + gid * LD + tig;
  for (int kk = 0; kk < N8 / 8; ++kk) {
    FragA a;
    a.set(ca[8 * kk], ca[8 * LD + 8 * kk], ca[8 * kk + 4],
          ca[8 * LD + 8 * kk + 4]);
    // B = B^T: B's rows 8 n + gid, columns 8 kk + tig (+ 4)
    float2 bf[kScoreTile / 8][2];
#pragma unroll
    for (int n = 0; n < kScoreTile / 8; ++n) {
      bf[n][0] = split(br[8 * n * LD + 8 * kk]);
      bf[n][1] = split(br[8 * n * LD + 8 * kk + 4]);
    }
    mma3<kScoreTile / 8>(acc, a, bf);
  }
  float* out = scores + ((static_cast<long long>(b) * nc + c) * G + g) * L * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = rb * kScoreTile + 16 * warp + gid + 8 * r;
#pragma unroll
    for (int n = 0; n < kScoreTile / 8; ++n)
      *reinterpret_cast<float2*>(out + i * L + kb * kScoreTile + 8 * n +
                                 2 * tig) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---- phase 1: chunk states -------------------------------------------

template <int P>
__global__ void __launch_bounds__(kStateThreads)
ssd_state_tf32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               float* __restrict__ states, float* __restrict__ decay, int S,
               int H, int G, int N, int chunk, int keys) {
  constexpr int LDX = P + 4;                   // split x rows (pairs)
  const int nc = S / chunk;
  const int nmb = (N + kStateRows - 1) / kStateRows;
  int idx = blockIdx.x;
  const int mb = idx % nmb;
  idx /= nmb;
  const int h = idx % H;
  idx /= H;
  const int c = idx % nc;
  const int b = idx / nc;
  const int g = h / (H / G);
  const long long bh = static_cast<long long>(b) * H + h;
  const int n0 = mb * kStateRows;
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * chunk;

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // kStages x (B, x) raw
  const int stage = keys * (kLdB1 + P);
  float2* xsp = reinterpret_cast<float2*>(ring + kStages * stage);
  float* w = reinterpret_cast<float*>(xsp + keys * LDX);   // dts, then w
  float* cum2 = w + round_up(chunk, kSpan);
  float* part = cum2 + round_up(chunk, kSpan);

  const float* Bsrc = Bm + (row0 * G + g) * N + n0;
  const float* xsrc = x + (row0 * H + h) * P;
  const int n_tiles = (round_up(chunk, 16) + keys - 1) / keys;
  auto load = [&](int t) {
    float* st = ring + (t % kStages) * stage;
    load_rows(st, kLdB1, Bsrc, static_cast<long long>(G) * N, t * keys, keys,
              chunk, min(kStateRows, N - n0), kStateRows);
    load_rows(st + keys * kLdB1, P, xsrc, static_cast<long long>(H) * P,
              t * keys, keys, chunk, P, P);
  };
  load(0);
  cp_async_commit();
  if (n_tiles > 1) load(1);
  cp_async_commit();

  chunk_cumsum(dt + row0 * H + h, H, A[h], chunk, w, cum2, part);
  const float last = cum2[chunk - 1];
  for (int j = threadIdx.x; j < round_up(chunk, kSpan);
       j += kStateThreads)
    w[j] = w[j] * exp2_approx(last - cum2[j]);
  if (mb == 0 && threadIdx.x == 0) decay[bh * nc + c] = exp2_approx(last);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const bool active = n0 + 16 * warp < N;
  float acc[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();
    __syncthreads();            // tile t landed, w ready, x pairs free
    const float* bt = ring + (t % kStages) * stage;
    split_tile(xsp, LDX, bt + keys * kLdB1, P, keys, P);
    __syncthreads();            // x pairs ready
    if (active) {
      for (int kk = 0; kk < keys / 8; ++kk) {
        // A = (B o w)^T: state rows 16 warp + gid (+ 8), steps 8 kk + tig
        // (+ 4)
        const float* ba = bt + (8 * kk + tig) * kLdB1 + 16 * warp + gid;
        const float w0 = w[t * keys + 8 * kk + tig];
        const float w1 = w[t * keys + 8 * kk + tig + 4];
        FragA a;
        a.set(ba[0] * w0, ba[8] * w0, ba[4 * kLdB1] * w1,
              ba[4 * kLdB1 + 8] * w1);
        const float2* xr = xsp + (8 * kk + tig) * LDX + gid;
        float2 bf[P / 8][2];
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          bf[n][0] = xr[8 * n];
          bf[n][1] = xr[4 * LDX + 8 * n];
        }
        mma3<P / 8>(acc, a, bf);
      }
    }
    __syncthreads();            // stage t % 2 may be reused
    if (t + kStages < n_tiles) load(t + kStages);
    cp_async_commit();
  }

  if (!active) return;
  float* out = states + (bh * nc + c) * N * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + 16 * warp + gid + 8 * r;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < P / 8; ++q)
      *reinterpret_cast<float2*>(&out[static_cast<long long>(n) * P + 8 * q +
                                      2 * tig]) =
          make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
  }
}

// ---- phase 2: state passing, in place ---------------------------------

__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_f32(float* __restrict__ states,
                   const float* __restrict__ decay, int nc, int NP) {
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
        *reinterpret_cast<float4*>(&states[(bh * nc + c0 + k) * NP + e]) = s;
        s = make_float4(s.x * d[k] + sc[k].x, s.y * d[k] + sc[k].y,
                        s.z * d[k] + sc[k].z, s.w * d[k] + sc[k].w);
      }
    }
  }
}

// ---- phase 3: chunk scan ---------------------------------------------

template <int P>
__global__ void __launch_bounds__(2 * kMaxRows)
ssd_scan_chunk_tf32(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const float* __restrict__ Cm,
                    const float* __restrict__ scores,
                    const float* __restrict__ before, float* __restrict__ y,
                    int S, int H, int G, int N, int chunk, int rows) {
  constexpr int keys = kScanKeys;
  constexpr int LDX = P + 4;                   // split x / S_before (pairs)
  constexpr int LDG = keys + 4;                // score rows (floats)
  const int NK = round_up(N, keys);            // S_before rows, in tiles
  const int LDC = NK + 4;                      // raw C rows (floats)
  const int L = score_side(chunk);
  const int nc = S / chunk;
  const int c16 = round_up(chunk, 16);
  const int nblk = (c16 + rows - 1) / rows;
  // blocks of one chunk adjacent, the later (longer) block first
  const int blk = nblk - 1 - static_cast<int>(blockIdx.x % nblk);
  const int bhc = blockIdx.x / nblk;
  const int h = bhc % H;
  const int c = (bhc / H) % nc;
  const int b = bhc / (H * nc);
  const int g = h / (H / G);
  const long long bh = static_cast<long long>(b) * H + h;
  const int rb0 = blk * rows;
  const int row_end = min(min(rb0 + rows, c16), chunk);   // rows stored
  const int n_in = c > 0 ? NK / keys : 0;                 // S_before tiles
  const int n_kt = (row_end + keys - 1) / keys;           // key tiles
  const int n_all = n_in + n_kt;
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * chunk;

  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);            // rows x LDC
  float* ring = cs + rows * LDC;      // kStages x (scores, x / S_before)
  const int stage = rows * LDG + keys * P;                // floats
  float2* xsp = reinterpret_cast<float2*>(ring + kStages * stage);
  float* dts = reinterpret_cast<float*>(xsp + keys * LDX);
  float* cum2 = dts + round_up(chunk, kSpan);
  float* part = cum2 + round_up(chunk, kSpan);

  const float* sc_src = scores +
                        ((static_cast<long long>(b) * nc + c) * G + g) * L * L +
                        static_cast<long long>(rb0) * L;
  const float* sb_src = before + (bh * nc + c) * N * P;
  const float* xsrc = x + (row0 * H + h) * P;
  // tile u: S_before rows [u keys, ...) for u < n_in, else key tile
  // u - n_in: the block's score rows over its keys and x's rows
  auto load = [&](int u) {
    float* st = ring + (u % kStages) * stage;
    if (u < n_in) {
      load_rows(st + rows * LDG, P, sb_src, P, u * keys, keys, N, P, P);
    } else {
      const int t = u - n_in;
      load_rows(st, LDG, sc_src + t * keys, L, 0, rows, L - rb0, keys, keys);
      load_rows(st + rows * LDG, P, xsrc, static_cast<long long>(H) * P,
                t * keys, keys, chunk, P, P);
    }
  };
  if (n_in > 0)
    load_rows(cs, LDC, Cm + (row0 * G + g) * N, static_cast<long long>(G) * N,
              rb0, rows, chunk, N, NK);
  load(0);
  cp_async_commit();
  if (n_all > 1) load(1);
  cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], chunk, dts, cum2, part);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wr0 = rb0 + 16 * warp;             // this warp's first row
  const bool active = wr0 < row_end;
  float acc[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int u = 0; u < n_all; ++u) {
    cp_async_wait<1>();
    __syncthreads();            // tile u landed, the last pairs used
    const float* st = ring + (u % kStages) * stage;
    split_tile(xsp, LDX, st + rows * LDG, P, keys, P);
    __syncthreads();            // pairs ready
    if (active) {
      // the tile's 8-row steps whose rows this warp needs: all of an
      // S_before tile; the keys at or left of its rows of a key tile
      const int kbase = (u - n_in) * keys;
      const int steps = u < n_in ? keys / 8
                                 : min(keys / 8, (wr0 + 15 - kbase) / 8 + 1);
      const float ci[2] = {cum2[wr0 + gid], cum2[wr0 + gid + 8]};
      for (int jn = 0; jn < steps; ++jn) {
        FragA a;
        if (u < n_in) {
          // A = C rows 16 warp + gid (+ 8), columns u keys + 8 jn + tig (+ 4)
          const float* ca = cs + (16 * warp + gid) * LDC + u * keys + 8 * jn +
                            tig;
          a.set(ca[0], ca[8 * LDC], ca[4], ca[8 * LDC + 4]);
        } else {
          // A = G' = G exp(cum_i - cum_j) dt_j, j <= i
          const float* ga = st + (16 * warp + gid) * LDG + 8 * jn + tig;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = wr0 + gid + 8 * (e % 2);
            const int j = kbase + 8 * jn + tig + 4 * (e / 2);
            const float gij = ga[8 * LDG * (e % 2) + 4 * (e / 2)];
            v[e] = j <= i
                       ? gij * (exp2_approx(ci[e % 2] - cum2[j]) * dts[j])
                       : 0.0f;
          }
          a.set(v[0], v[1], v[2], v[3]);
        }
        const float2* xr = xsp + (8 * jn + tig) * LDX + gid;
        float2 bf[P / 8][2];
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          bf[n][0] = xr[8 * n];
          bf[n][1] = xr[4 * LDX + 8 * n];
        }
        mma3<P / 8>(acc, a, bf);
      }
      if (u == n_in - 1) {
        // C S_before done: rows scaled by exp(cum_i)
        const float e0 = exp2_approx(ci[0]);
        const float e1 = exp2_approx(ci[1]);
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          acc[n][0] *= e0;
          acc[n][1] *= e0;
          acc[n][2] *= e1;
          acc[n][3] *= e1;
        }
      }
    }
    __syncthreads();            // stage u % 2 may be reused
    if (u + kStages < n_all) load(u + kStages);
    cp_async_commit();
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wr0 + gid + 8 * r;
    if (i >= chunk) continue;
    float* yrow = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int q = 0; q < P / 8; ++q)
      *reinterpret_cast<float2*>(yrow + 8 * q + 2 * tig) =
          make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
  }
}

// ---- host side -------------------------------------------------------

struct Plan {
  int rows;                   // phase 3 rows per CTA
  int keys1;                  // phase 1 key-tile rows
};

// The dynamic shared memory a block may take on the current device.
cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

bool plan_ok(const Plan& p, int P, int N, int chunk, int limit) {
  return p.rows >= 16 && p.rows <= kMaxRows && p.rows % 16 == 0 &&
         (p.keys1 == 16 || p.keys1 == 32) && score_smem(N) <= limit &&
         state_smem(P, chunk, p.keys1) <= limit &&
         scan_smem(P, N, chunk, p.rows) <= limit;
}

template <int P>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* states, float* decay,
           float* scores, int B, int S, int H, int G, int N, int chunk,
           const Plan& plan, int phases, cudaStream_t stream) {
  const int nc = S / chunk;
  cudaError_t err;
  if (phases & 8) {
    const int smem = score_smem(N);
    err = cudaFuncSetAttribute(ssd_scores_tf32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nb = score_side(chunk) / kScoreTile;
    const long long grid = static_cast<long long>(B) * nc * G * nb * nb;
    ssd_scores_tf32<<<static_cast<unsigned>(grid), kScoreThreads, smem,
                      stream>>>(Bm, Cm, scores, S, G, N, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 1) {
    const int smem = state_smem(P, chunk, plan.keys1);
    err = cudaFuncSetAttribute(ssd_state_tf32<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = static_cast<long long>(B) * H * nc *
                           ((N + kStateRows - 1) / kStateRows);
    ssd_state_tf32<P><<<static_cast<unsigned>(grid), kStateThreads, smem,
                         stream>>>(x, dt, A, Bm, states, decay, S, H, G, N,
                                   chunk, plan.keys1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 2) {
    const int NP = N * P;
    const dim3 grid((NP / 4 + kPassThreads - 1) / kPassThreads, B * H);
    ssd_state_pass_f32<<<grid, kPassThreads, 0, stream>>>(states, decay, nc,
                                                         NP);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 4) {
    const int smem = scan_smem(P, N, chunk, plan.rows);
    err = cudaFuncSetAttribute(ssd_scan_chunk_tf32<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = static_cast<long long>(B) * H * nc *
                           ((round_up(chunk, 16) + plan.rows - 1) / plan.rows);
    ssd_scan_chunk_tf32<P><<<static_cast<unsigned>(grid), 2 * plan.rows,
                             smem, stream>>>(
        x, dt, A, Cm, scores, states, y, S, H, G, N, chunk, plan.rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// x: (B, S, H, P), Bm/Cm: (B, S, G, N), y: (B, S, H, P), dt: (B, S, H),
// A: (H,), all contiguous f32 with 16-byte aligned bases.  Scratch from the
// caller, f32: states (B*H, S/chunk, N, P) (the chunk states, then the
// states before each chunk in place), decay (B*H, S/chunk) and scores
// (B, S/chunk, G, L, L), L = chunk rounded up to 64.  P in {16, 32, 64,
// 128}, N % 4 == 0, H % G == 0, S % chunk == 0; the plan (phase 3 rows per
// CTA, a multiple of 16 up to 128; phase 1 key-tile rows, 16 or 32) must
// fit in the current device's shared memory.  ``phases`` is a mask of the
// launches to run: 8 chunk scores, 1 chunk states, 2 state passing, 4
// chunk scan (15 = the whole scan).  Returns 0 or a CUDA error code.
int ssd_scan_tf32_fwd(const float* x, const float* dt, const float* A,
                      const float* Bm, const float* Cm, float* y,
                      float* states, float* decay, float* scores, int B,
                      int S, int H, int P, int G, int N, int chunk, int rows,
                      int keys1, int phases, cudaStream_t stream) {
  const Plan plan{rows, keys1};
  const int nb = score_side(chunk) / kScoreTile;
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || chunk <= 0 ||
      H % G != 0 || N % 4 != 0 || S % chunk != 0 ||
      !plan_ok(plan, P, N, chunk, limit) ||
      static_cast<long long>(B) * (S / chunk) *
              (static_cast<long long>(H) *
                   (round_up(chunk, 16) / 16 +
                    (N + kStateRows - 1) / kStateRows) +
               static_cast<long long>(G) * nb * nb) >
          0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (P) {
    case 16:
      return launch<16>(x, dt, A, Bm, Cm, y, states, decay, scores, B, S, H,
                        G, N, chunk, plan, phases, stream);
    case 32:
      return launch<32>(x, dt, A, Bm, Cm, y, states, decay, scores, B, S, H,
                        G, N, chunk, plan, phases, stream);
    case 64:
      return launch<64>(x, dt, A, Bm, Cm, y, states, decay, scores, B, S, H,
                        G, N, chunk, plan, phases, stream);
    case 128:
      return launch<128>(x, dt, A, Bm, Cm, y, states, decay, scores, B, S, H,
                         G, N, chunk, plan, phases, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shared-memory bytes of the chunk-scores, chunk-state and chunk-scan
// launches for a plan into out[0..2], and the current device's limit for a
// block into out[3] (what ssd_scan.py::tf32_plan is held to).  Returns 0 or
// a CUDA error code.
int ssd_scan_tf32_smem(int P, int N, int chunk, int rows, int keys1,
                       int* out) {
  out[0] = score_smem(N);
  out[1] = state_smem(P, chunk, keys1);
  out[2] = scan_smem(P, N, chunk, rows);
  return static_cast<int>(smem_limit(&out[3]));
}

}  // extern "C"
