// Mamba-2 SSD chunked scan for f32 on Hopper (sm_90a), on CUDA cores.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (_ssd_kernel)
//   for f32 inputs; bf16 inputs go to ssd_scan_wgmma.cu (tensor cores).
//
// What it computes, per (b, h) and chunk of `chunk` steps, in f32 (the TPU
// kernel's chunked dual form):
//   dA = dt * A[h], cum = inclusive cumsum of dA over the chunk,
//   xdt = x * dt,  L[i, j] = exp(cum_i - cum_j) for i >= j, else 0,
//   y   = (C B^T o L) xdt + exp(cum) o (C S_prev),
//   S   = exp(cum_last) S_prev + (B o exp(cum_last - cum))^T xdt,
// with the (N, P) state S carried from chunk to chunk (zero at the start)
// and B, C of group h / (H / G).
//
// What bounds it on this card: operations and bytes alike.  At the
// full-width mamba2-780m shape (B 4, S 2048, H 48, P 64, G 1, N 128, chunk
// 256) the lower-triangle work is ~3.2e10 FLOP against ~210 MB of x, dt, B,
// C and y in f32: 0.5 ms at the f32 rate of the CUDA cores this kernel uses.
//
// Design: the TPU kernel ran one grid cell per (b*h, chunk), the chunk axis
// in order, with the state in VMEM scratch and B/C repeated to every head
// beforehand.  Here one CTA owns one (b, h) and loops over the chunks,
// keeping the f32 state in shared memory (N x P = 128 x 64, 32 KB); B and C
// are read in place from (B, S, G, N) at group h / (H / G) and x, dt from
// (B, S, H, .) with strides, so nothing is repeated or re-laid out.  At
// chunk 256 the (chunk x chunk) score tile alone would be 256 KB of f32,
// more than a block's 227 KB, so the intra-chunk product runs in 64 x 64
// tiles: for each 64-row tile of C, the tiles of B at or left of the
// diagonal (the others are all zero under L), with L formed on the fly for
// i >= j only (no exp of a positive difference).  256 threads form 16 row
// groups x 16 column groups; each owns 4 rows x 4 strided columns of a
// score tile and 4 rows x P/16 strided columns of y or of the state.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // rows / columns of a chunk tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows [r0, r0 + kTile) of a chunk (n_rows valid) of a width-W slice whose
// rows lie `row_stride` elements apart -> dst[r * ld + c] as f32, times
// w[r] when w is given; rows past n_rows are zero.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          long long row_stride, int r0,
                                          int n_rows, int W,
                                          const float* __restrict__ w,
                                          float* __restrict__ dst, int ld) {
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    const int r = idx / W;
    const int c = idx % W;
    float v = 0.0f;
    if (r0 + r < n_rows) {
      v = to_f32(src[static_cast<long long>(r0 + r) * row_stride + c]);
      if (w != nullptr) v *= w[r0 + r];
    }
    dst[r * ld + c] = v;
  }
}

inline int smem_bytes(int P, int N, int chunk) {
  const int ldn = N + 4;
  const long long floats = static_cast<long long>(N) * P + 2LL * kTile * ldn +
                           static_cast<long long>(kTile) * P +
                           kTile * (kTile + 4) + 3LL * chunk;
  const long long bytes = floats * static_cast<long long>(sizeof(float));
  return bytes > kMaxSmem ? -1 : static_cast<int>(bytes);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y, int S, int H,
                    int G, int N, int chunk) {
  constexpr int PC = P / 16;      // y / state columns per thread
  constexpr int LDG = kTile + 4;
  const int LDN = N + 4;          // padded rows: float4-aligned, no conflicts
  extern __shared__ float4 smem4[];
  float* state = reinterpret_cast<float*>(smem4);   // N x P
  float* cs = state + N * P;                         // kTile x LDN
  float* bs = cs + kTile * LDN;                      // kTile x LDN
  float* xs = bs + kTile * LDN;                      // kTile x P
  float* gs = xs + kTile * P;                        // kTile x LDG
  float* cum = gs + kTile * LDG;                     // chunk
  float* dts = cum + chunk;                          // chunk
  float* wend = dts + chunk;                         // chunk: dt*exp(cum_last - cum)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const long long xrow = static_cast<long long>(H) * P;
  const long long bcrow = static_cast<long long>(G) * N;
  const T* xb = x + (static_cast<long long>(b) * S * H + h) * P;
  T* yb = y + (static_cast<long long>(b) * S * H + h) * P;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;
  const T* Bb = Bm + (static_cast<long long>(b) * S * G + g) * N;
  const T* Cb = Cm + (static_cast<long long>(b) * S * G + g) * N;

  const int tid = threadIdx.x;
  const int rg = tid / 16;        // rows rg*4 .. rg*4+3 of a tile
  const int cg = tid % 16;        // columns cg + 16*e
  const int warp = tid / 32;
  const int ln = tid % 32;

  for (int i = tid; i < N * P; i += kThreads) state[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const long long xoff = static_cast<long long>(c0) * xrow;
    const long long bcoff = static_cast<long long>(c0) * bcrow;
    // ---- dt and the inclusive cumsum of dt * a over the chunk ----
    __syncthreads();               // the last chunk's readers are done
    for (int i = tid; i < chunk; i += kThreads)
      dts[i] = dtb[static_cast<long long>(c0 + i) * H];
    __syncthreads();
    if (warp == 0) {
      float carry = 0.0f;
      for (int base = 0; base < chunk; base += 32) {
        const int i = base + ln;
        float v = i < chunk ? dts[i] * a : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (ln >= off) v += u;
        }
        v += carry;
        if (i < chunk) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[chunk - 1];
    for (int i = tid; i < chunk; i += kThreads)
      wend[i] = dts[i] * expf(cum_last - cum[i]);

    // ---- y, one 64-row tile of the chunk at a time ----
    for (int i0 = 0; i0 < chunk; i0 += kTile) {
      __syncthreads();             // cs / bs / xs / gs readers are done
      load_rows<T>(Cb + bcoff, bcrow, i0, chunk, N, nullptr, cs, LDN);
      __syncthreads();

      // inter-chunk: exp(cum_i) * (C_i . S_prev)
      float acc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < PC; ++e) acc[r][e] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(&cs[(rg * 4 + r) * LDN + n]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
          for (int e = 0; e < PC; ++e) {
            const float sv = state[(n + nn) * P + cg + 16 * e];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][e] += lane(cv[r], nn) * sv;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + rg * 4 + r;
        const float w = i < chunk ? expf(cum[i]) : 0.0f;
#pragma unroll
        for (int e = 0; e < PC; ++e) acc[r][e] *= w;
      }

      // intra-chunk: tiles j0 <= i0 of (C B^T o L) xdt
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();           // bs / xs / gs readers are done
        load_rows<T>(Bb + bcoff, bcrow, j0, chunk, N, nullptr, bs, LDN);
        load_rows<T>(xb + xoff, xrow, j0, chunk, P, dts, xs, P);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = 0.0f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&cs[(rg * 4 + r) * LDN + n]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[c] = *reinterpret_cast<const float4*>(&bs[(cg + 16 * c) * LDN + n]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sc[r][c] += cv[r].x * bv[c].x + cv[r].y * bv[c].y +
                          cv[r].z * bv[c].z + cv[r].w * bv[c].w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + rg * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + cg + 16 * c;
            const bool ok = j <= i && i < chunk;
            gs[(rg * 4 + r) * LDG + cg + 16 * c] =
                ok ? sc[r][c] * expf(cum[i] - cum[j]) : 0.0f;
          }
        }
        __syncthreads();
#pragma unroll 2
        for (int jj = 0; jj < kTile; jj += 4) {
          float4 gv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            gv[r] = *reinterpret_cast<const float4*>(&gs[(rg * 4 + r) * LDG + jj]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int e = 0; e < PC; ++e) {
              const float xv = xs[(jj + q) * P + cg + 16 * e];
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r][e] += lane(gv[r], q) * xv;
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + rg * 4 + r;
        if (i >= chunk) continue;
        T* yrow = yb + xoff + static_cast<long long>(i) * xrow;
#pragma unroll
        for (int e = 0; e < PC; ++e) store(&yrow[cg + 16 * e], acc[r][e]);
      }
    }

    // ---- state: S = exp(cum_last) S + B^T (xdt o exp(cum_last - cum)) ----
    const float total = expf(cum_last);
    for (int n0 = 0; n0 < N; n0 += kTile) {
      float su[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < PC; ++e) su[r][e] = 0.0f;
      const int n = n0 + rg * 4;   // this thread's 4 state rows
      for (int j0 = 0; j0 < chunk; j0 += kTile) {
        __syncthreads();           // bs / xs readers are done
        load_rows<T>(Bb + bcoff, bcrow, j0, chunk, N, nullptr, bs, LDN);
        load_rows<T>(xb + xoff, xrow, j0, chunk, P, wend, xs, P);
        __syncthreads();
        if (n < N) {
          for (int j = 0; j < kTile; ++j) {
            const float4 bv =
                *reinterpret_cast<const float4*>(&bs[j * LDN + n]);
#pragma unroll
            for (int e = 0; e < PC; ++e) {
              const float xv = xs[j * P + cg + 16 * e];
#pragma unroll
              for (int r = 0; r < 4; ++r) su[r][e] += lane(bv, r) * xv;
            }
          }
        }
      }
      if (n < N) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < PC; ++e) {
            float* sp = &state[(n + r) * P + cg + 16 * e];
            *sp = total * *sp + su[r][e];
          }
      }
    }
  }
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int H, int G, int N,
           int chunk, cudaStream_t stream) {
  const int smem = smem_bytes(P, N, chunk);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  ssd_scan_fwd_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H, G, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_p(int P, const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, void* y, int B, int S, int H,
               int G, int N, int chunk, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, B, S, H, G, N, chunk, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, B, S, H, G, N, chunk, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, B, S, H, G, N, chunk, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, y, B, S, H, G, N, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs, or -1 past the 227 KB a block may use.
int ssd_scan_smem_bytes(int P, int N, int chunk) {
  return smem_bytes(P, N, chunk);
}

// x: (B, S, H, P), dt: (B, S, H), A: (H,), Bm/Cm: (B, S, G, N),
// y: (B, S, H, P); all contiguous f32.  P in {16, 32, 64, 128}, N % 4 == 0,
// H % G == 0, S % chunk == 0.  Returns the launch's CUDA error code (0 on
// success).
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, void* y, int B, int S, int H,
                 int P, int G, int N, int chunk, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || chunk <= 0 ||
      H % G != 0 || N % 4 != 0 || S % chunk != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_p<float>(P, x, dt, A, Bm, Cm, y, B, S, H, G, N, chunk,
                           stream);
}

}  // extern "C"
