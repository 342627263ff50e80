#!/usr/bin/env python3
"""Probe the tensor cores' mma.sync on one NVIDIA GPU.

    python3 tools/mma_probe.py

Two readings the hand-written kernels' designs rest on (kernels/csrc/
mma.cuh):

  * the issue rate of mma.sync m16n8k8 TF32 and m16n8k16 bf16: every warp
    of 4 blocks an SM runs 8 independent accumulators through a long loop,
    so the tensor pipes, not latency, set the time; printed as mma a second
    per SM sub-partition and as TFLOP/s;
  * how a TF32 operand whose 13 low bits are not clear is read: 8 times
    1 + 3 2^-12 through one m16n8k8 gives 8 when the low bits are dropped,
    8 (1 + 2^-10) when rounded, and 8.0059 when kept.

The CUDA source below is compiled with nvcc (sm_90a) into build/probe/ at
run time. Prints one JSON line with the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "mma.cuh"

template <int BF16>
__global__ void rate_kernel(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint4 ab = make_uint4(a[0], a[1], a[2], a[3]);
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16) tc::mma_bf16(c[j], ab, b0, b1);
      else tc::mma_tf32(c[j], a, b0, b1);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1.2345f) out[0] = s;     // keeps the products live
}

__global__ void operand_kernel(float v, float* out) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t a = __float_as_uint(v);
  const uint32_t av[4] = {a, a, a, a};
  const uint32_t one = __float_as_uint(1.f);
  tc::mma_tf32(c, av, one, one);
  if (threadIdx.x == 0) out[0] = c[0];
}

extern "C" float rate_ms(int bf16, int blocks, int warps, int iters) {
  float* out;
  cudaMalloc(&out, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {          // the first is a warm-up
    cudaEventRecord(e0);
    if (bf16) rate_kernel<1><<<blocks, 32 * warps>>>(out, iters);
    else rate_kernel<0><<<blocks, 32 * warps>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return ms;
}

extern "C" float operand(float v) {
  float* d;
  float h = 0.f;
  cudaMalloc(&d, 4);
  operand_kernel<<<1, 32>>>(v, d);
  cudaMemcpy(&h, d, 4, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return h;
}
"""


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, n) for n in ("probe.cu",
                                                       "probe.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(build.CSRC), "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.rate_ms.restype = ctypes.c_float
    lib.rate_ms.argtypes = [ctypes.c_int] * 4
    lib.operand.restype = ctypes.c_float
    lib.operand.argtypes = [ctypes.c_float]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, warps, iters = 4 * sms, 8, 20000
    rec = {}
    for bf16, name, k in ((0, "tf32 m16n8k8", 8), (1, "bf16 m16n8k16", 16)):
        ms = lib.rate_ms(bf16, blocks, warps, iters)
        n = blocks * warps * iters * 8
        rec[name] = {"ms": ms,
                     "mma_per_s_per_subpartition": n / (4 * sms) / (ms * 1e-3),
                     "tflops": n * 2 * 16 * 8 * k / (ms * 1e-3) / 1e12}
    v = 1 + 3 * 2 ** -12
    rec["tf32 operand 1 + 3 2^-12, times 8"] = {
        "got": lib.operand(v), "low_bits_dropped": 8.0,
        "rounded": 8 * (1 + 2 ** -10), "kept": 8 * v}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "sms": sms, "probe": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
