// One thread-block cluster per row: the pieces the row kernels share
// (topk_select.cu, quantize.cu).
//
// A row of n f32 is cut into one contiguous slice per CTA of the cluster.
// A CTA copies its slice from device memory into shared memory once: one
// thread issues 1-D bulk copies (cp.async.bulk, the TMA engine) of the
// slice's whole 16-byte words in kChunks pieces, each completing on its own
// mbarrier, so the first sweep over the slice starts on the first piece
// while the others land; a few threads load the edges (a row of odd length
// starts only 4-byte aligned) with scalar loads.  The slice then lies in
// shared memory as sm[mis .. mis + len), its words read four elements at a
// time.  A CTA writes its part of a byte-wide output row as 4-byte words,
// with single bytes at the head and the tail.
//
// The cluster's CTAs exchange per-CTA results by PUSHING them into every
// CTA's shared memory (remote stores through distributed shared memory)
// before a cluster barrier, whose release/acquire makes them visible; each
// CTA then reads only its own shared memory.  No CTA touches another's
// shared memory after the last barrier, so a CTA may exit as soon as it is
// done.  Every kernel arrives on the cluster barrier as it starts and waits
// before its first remote store, so no CTA writes into one that has not
// started.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace row_cluster {

namespace cg = cooperative_groups;

// Clock stamps for profiling (python -m repro_torch.profile_codec --stamps
// builds the kernels with -DROW_CLUSTER_STAMPS): thread 0 of the first CTA
// of the first row records clock64() at each ROW_CLUSTER_STAMP(i), and
// row_cluster_stamps() copies the stamps to the host.  Without the flag
// the macro is empty.
constexpr int kStamps = 32;
#ifdef ROW_CLUSTER_STAMPS
__device__ long long stamps[kStamps];
#define ROW_CLUSTER_STAMP(i)                                              \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)             \
  row_cluster::stamps[i] = clock64()
#else
#define ROW_CLUSTER_STAMP(i)
#endif

// CTAs per row: 8, the portable cluster size.  16 (non-portable) timed
// slower at the main path's shape on an H100 (PERF.md): a GPC does not
// always have 16 free SMs.
constexpr int kCluster = 8;

struct Slice {
  long long lo;           // the row index of the slice's first element
  int len;                // elements (0 for an empty slice)
  int mis;                // lo's distance in elements past a 16-byte address
};

// The slice of CTA `rank`: ceil(n / kCluster) elements, the last ones
// shorter or empty.
__device__ __forceinline__ Slice slice_of(const float* row, long long n,
                                          int rank) {
  const long long len = (n + kCluster - 1) / kCluster;
  const long long lo = min(n, rank * len);
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3);
  return {lo, static_cast<int>(min(n, lo + len) - lo), mis};
}

// Shared-memory words a slice of ceil(n / kCluster) elements takes, with
// room for the 16-byte alignment.
__host__ __device__ inline long long slice_words(long long n) {
  return ((n + kCluster - 1) / kCluster + 3 + 3) / 4 * 4;
}

// Element j of a slice lies at sm[mis + j].  Its 16-byte words that hold
// only elements of the slice are words [w0, w1) of sm; the at most 3
// elements before w0 (the head) and the at most 3 after w1 (the tail) are
// the edges.
struct Words {
  int w0, w1, head_end, tail_start, end;   // head_end .. in sm indices
};
__device__ __forceinline__ Words words_of(const Slice& s) {
  const int end = s.mis + s.len;
  const int w0 = (s.mis + 3) >> 2, w1 = end >> 2;
  const int head_end = min(end, 4 * w0);
  return {w0, max(w0, w1), head_end, max(head_end, 4 * w1), end};
}

constexpr int kChunks = 4;

// Words [c0, c1) of chunk c of the slice's whole words.
__device__ __forceinline__ int2 chunk_of(const Words& w, int c) {
  const int n = w.w1 - w.w0;
  return make_int2(w.w0 + n * c / kChunks, w.w0 + n * (c + 1) / kChunks);
}

// Starts copying row[s.lo .. s.lo + s.len) into sm (16-byte aligned) as
// sm[s.mis + j] = row[s.lo + j]: chunk c of the whole words completes on
// bars[c]; threads 0..5 load the edges themselves.  Every thread of the CTA
// calls it.
__device__ __forceinline__ void load_slice(const float* __restrict__ row,
                                           const Slice& s, float* sm,
                                           uint64_t* bars) {
  const Words w = words_of(s);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int c = 0; c < kChunks; ++c) hopper::mbar_init(&bars[c], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < kChunks; ++c) {
      const int2 r = chunk_of(w, c);
      const uint32_t bytes = static_cast<uint32_t>(16 * (r.y - r.x));
      if (bytes == 0) {
        hopper::mbar_arrive(&bars[c]);
        continue;
      }
      hopper::mbar_expect_tx(&bars[c], bytes);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_addr(sm + 4 * r.x)),
          "l"(row + s.lo + (4 * r.x - s.mis)), "r"(bytes),
          "r"(hopper::smem_addr(&bars[c]))
          : "memory");
    }
  }
  const int e = (tid < 3) ? s.mis + tid : w.tail_start + (tid - 3);
  if (tid < 6 && e < ((tid < 3) ? w.head_end : w.end)) {
    sm[e] = __ldg(row + s.lo + (e - s.mis));
  }
}

// Calls f(v) for every whole 16-byte word v of the slice in shared memory
// and edge(x) for each of the at most 6 elements at its edges, in the thread
// that loaded it.  kLanding: the copies may still be in flight, so each
// chunk's words are taken as its copy completes.
template <bool kLanding, typename F, typename E>
__device__ __forceinline__ void for_each(const float* sm, const Slice& s,
                                         uint64_t* bars, F f, E edge) {
  const Words w = words_of(s);
  const float4* sm4 = reinterpret_cast<const float4*>(sm);
  if constexpr (kLanding) {
    for (int c = 0; c < kChunks; ++c) {
      const int2 r = chunk_of(w, c);
      hopper::mbar_wait(&bars[c], 0);
      for (int i = r.x + threadIdx.x; i < r.y; i += blockDim.x) f(sm4[i]);
    }
  } else {
#pragma unroll 4
    for (int i = w.w0 + threadIdx.x; i < w.w1; i += blockDim.x) f(sm4[i]);
  }
  const int tid = threadIdx.x;
  const int e = (tid < 3) ? s.mis + tid : w.tail_start + (tid - 3);
  if (tid < 6 && e < ((tid < 3) ? w.head_end : w.end)) edge(sm[e]);
}

// Writes out[s.lo .. s.lo + s.len) (one byte per element) as 4-byte words
// where the output is aligned, word(j) packing the bytes of slice elements
// j .. j + 3, and byte(j) at the head and the tail.
template <typename W, typename B>
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ out,
                                            const Slice& s, W word, B byte) {
  uint8_t* o = out + s.lo;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(o) & 3);
  const int va = min(s.len, (4 - mis) & 3);        // 4-byte aligned
  const int vb = va + ((s.len - va) & ~3);
  const int tid = threadIdx.x;
  for (int j = va + 4 * tid; j < vb; j += 4 * blockDim.x) {
    *reinterpret_cast<uint32_t*>(o + j) = word(j);
  }
  const int e = (tid < 3) ? tid : vb + (tid - 3);
  if (tid < 6 && e < ((tid < 3) ? va : s.len)) o[e] = byte(e);
}

// a[i .. i + 3] from shared memory: one 16-byte read where a + i is
// 16-byte aligned (a is), else four.
__device__ __forceinline__ float4 quad(const float* a, int i) {
  if ((i & 3) == 0) return reinterpret_cast<const float4*>(a)[i >> 2];
  return make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
}

// The low bytes of a, b, c, d as one word, a lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The halves of a cluster barrier: arrive as the kernel starts, wait before
// the first store into another CTA's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stores v into *p of the CTA of rank `rank` in this cluster.
template <typename T>
__device__ __forceinline__ void push(T* p, int rank, T v) {
  *cg::this_cluster().map_shared_rank(p, rank) = v;
}

// The dynamic shared memory one CTA of a kernel may take on each device:
// the device's opt-in limit less the kernel's static shared memory.  Zero
// until the kernel's limit has been raised to it on that device.
constexpr int kMaxDevices = 64;
struct SmemLimit {
  int bytes[kMaxDevices];
};

// Sets *bytes to the dynamic shared memory a CTA of `kernel` may take on
// the current device, raising the kernel's limit to it on the first call
// there.
template <typename... KArgs>
cudaError_t smem_limit(void (*kernel)(KArgs...), SmemLimit& limit,
                       int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (limit.bytes[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int avail = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, avail);
    if (err != cudaSuccess) return err;
    limit.bytes[dev] = avail;
  }
  *bytes = limit.bytes[dev];
  return cudaSuccess;
}

// Launches kernel over a (kCluster, rows) grid in clusters of
// (kCluster, 1, 1) with `smem` bytes of dynamic shared memory (over 48 KB
// only after smem_limit has raised the kernel's limit).
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int rows, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace row_cluster

#ifdef ROW_CLUSTER_STAMPS
// Copies the stamps of the last launch to host[kStamps] and clears them.
extern "C" int row_cluster_stamps(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, row_cluster::stamps,
                                         sizeof(row_cluster::stamps));
  const long long zeros[row_cluster::kStamps] = {};
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(row_cluster::stamps, zeros, sizeof(zeros));
  }
  return static_cast<int>(err);
}
#endif
