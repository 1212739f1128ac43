"""Peak rate of mma.sync on the GPU: the ceiling of the split-TF32 kernels.

    PYTHONPATH=src python -m repro_torch.profile_mma

Builds a small CUDA program with nvcc (into ``build/repro_torch_kernels``)
whose warps each issue a long run of ``mma.sync`` products into 8
independent accumulators, operands held in registers, and times it with
CUDA events for 128 to 1024 threads per CTA and 1 or 2 CTAs per SM.  Three
modes: m16n8k8 TF32 (what ``csrc/flash_attention_tf32.cu`` and
``csrc/ssd_scan_tf32.cu`` issue), the same with 16 Veltkamp splits
(``tf32_mma.cuh::split``) per 8 products on the FP32 pipe, and m16n8k16
bf16.  Prints one JSON line per run: TFLOP/s of the products, the card's
name (or the launch error where a CTA size asks for more registers than
an SM has).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels import build

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float round_tf32(float v) {
  const float c = __fmul_rn(v, 8193.0f);
  return __fsub_rn(c, __fsub_rn(c, v));
}

// MODE 0: TF32 products; 1: TF32 products and 16 splits per 8; 2: bf16.
template <int MODE>
__global__ void run(float* out, int iters, float seed) {
  float acc[8][4] = {};
  uint32_t a[4], b[8][2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(seed * (threadIdx.x + i));
  for (int n = 0; n < 8; ++n) {
    b[n][0] = __float_as_uint(seed + n);
    b[n][1] = __float_as_uint(seed - n);
  }
  float f[16];
  for (int i = 0; i < 16; ++i) f[i] = seed * i + threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (MODE == 2) mma_bf16(acc[n], a, b[n]);
      else mma_tf32(acc[n], a, b[n]);
    }
    if (MODE == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float h = round_tf32(f[i]);
        f[i] = round_tf32(f[i] - h) + h * 1.0001f;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) b[n][0] ^= __float_as_uint(f[n]);
    }
  }
  float s = 0.0f;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += acc[n][e];
  for (int i = 0; i < 16; ++i) s += MODE == 1 ? f[i] : 0.0f;
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, static_cast<size_t>(sms) * 2 * 1024 * 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  const char* names[3] = {"tf32 m16n8k8", "tf32 m16n8k8 + 16 splits per 8",
                          "bf16 m16n8k16"};
  for (int mode = 0; mode < 3; ++mode)
    for (int threads : {128, 256, 512, 1024})
      for (int per_sm : {1, 2}) {
        const int grid = sms * per_sm;
        auto launch = [&]() {
          if (mode == 0) run<0><<<grid, threads>>>(out, iters, 1.0f);
          else if (mode == 1) run<1><<<grid, threads>>>(out, iters, 1.0f);
          else run<2><<<grid, threads>>>(out, iters, 1.0f);
        };
        launch();
        cudaEventRecord(e0);
        launch();
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) {   // too many registers for the CTA size
          printf("{\"mode\": \"%s\", \"threads\": %d, \"ctas_per_sm\": "
                 "%d, \"launch_error\": \"%s\"}\n",
                 names[mode], threads, per_sm, cudaGetErrorString(err));
          continue;
        }
        float ms = 0.0f;
        cudaEventElapsedTime(&ms, e0, e1);
        const double flop = double(grid) * threads / 32 * iters * 8 *
                            (mode == 2 ? 4096.0 : 2048.0);
        printf("{\"mode\": \"%s\", \"threads\": %d, \"ctas_per_sm\": %d, "
               "\"ms\": %.4f, \"tflops\": %.1f}\n",
               names[mode], threads, per_sm, ms, flop / ms / 1e9);
      }
  return 0;
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_mma needs a CUDA device")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "profile_mma.cu"
    exe = build.BUILD_DIR / "profile_mma"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(exe), str(src)],
                   check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    device = torch.cuda.get_device_name(0)
    for line in out.splitlines():
        print(json.dumps({**json.loads(line), "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
