// Grouped (per-expert) matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/grouped_matmul.py:
//   grouped_matmul_kernel <- grouped_matmul (body _kernel), with the row
//   mask of its wrapper (src/repro/kernels/ops.py:134-136) folded in.
//
// What it computes. out[g] = x[g] @ w[g] for x [G, C, K] and w [G, K, N]
// (contiguous, one dtype: f32 or bf16), accumulated in f32 and written in
// x's dtype; rows at or past valid_rows[g] (clamped to [0, C]; NULL means
// all C rows) come out as exactly 0.
//
// What bounds it on this card. At olmoe-1b-7b's expert shapes (G = 64
// experts, C = 40 capacity rows for a 256-token prompt, K x N = 2048 x 2048
// gate-up or 1024 x 2048 down) every weight is read once and used by C
// rows: 2 C flops per 4 bytes, 20 flops a byte in f32. The gate-up call
// moves 1.07 GB of weights (0.32 ms at 3.35 TB/s) and does 21.5 GFLOP
// (0.32 ms at 67 TFLOP/s f32, H100 SXM data sheet): bytes and operations
// bound it alike.
//
// What the design does about it.
//   * The TPU's sequential K grid axis, which carries an f32 accumulator
//     in VMEM, becomes a loop over 16-deep K slices inside one CTA per
//     (64-column tile, 64-row tile, expert); each thread keeps a 4 x 4 f32
//     block of the output in registers. With C <= 64 there is one row tile
//     per expert, so each weight is read from device memory exactly once.
//   * Ragged shapes (C = 40 or 8 is no multiple of anything the TPU's
//     divisor blocks like) are masked at the edges, not shrunk to divisors.
//   * A tile whose first row is at or past valid_rows[g] reads nothing and
//     writes zeros; an expert with no valid row reads none of its weights.
//     Inside a partly valid tile, rows past valid_rows[g] load as 0, warps
//     whose 8 rows are all invalid skip the arithmetic, and those rows are
//     stored as 0.
//   * x is staged k-major (padded to 68 floats a row against bank
//     conflicts) and w row-major in shared memory, so each thread reads
//     one float4 of each per k.
// This is the simple first kernel: SIMT f32 FMAs, no tensor cores (wgmma),
// no TMA, no double buffering.
//
// Interface: plain C, loaded with ctypes. The entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BKS = 16;    // tile rows, columns, K slice
constexpr int TM = 4, TN = 4;                // outputs per thread
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int XPAD = BM + 4;                 // k-major x row, padded

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ valid_rows, T* __restrict__ out,
                      int C, int K, int N) {
  __shared__ __align__(16) float xs[BKS][XPAD];
  __shared__ __align__(16) float ws[BKS][BN];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, g = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  int limit = C;
  if (valid_rows != nullptr) limit = max(0, min(C, valid_rows[g]));
  const int rows = min(BM, limit - m0);      // valid rows of this tile
  T* o = out + (size_t)g * C * N;

  if (rows <= 0) {                           // skipped: zeros, no reads
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = m0 + i / BN, c = n0 + i % BN;
      if (r < C && c < N) o[(size_t)r * N + c] = from_f32<T>(0.f);
    }
    return;
  }

  const T* xg = x + (size_t)g * C * K;
  const T* wg = w + (size_t)g * K * N;
  const bool busy = (ty * TM) / 8 * 8 < rows;  // warp-uniform: 8 rows a warp
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKS) {      // the TPU's K grid axis
#pragma unroll
    for (int r = 0; r < BM * BKS / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int row = i / BKS, kk = i % BKS;
      float val = 0.f;
      if (row < rows && k0 + kk < K)
        val = to_f32(xg[(size_t)(m0 + row) * K + k0 + kk]);
      xs[kk][row] = val;
    }
#pragma unroll
    for (int r = 0; r < BKS * BN / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int kk = i / BN, c = i % BN;
      float val = 0.f;
      if (k0 + kk < K && n0 + c < N)
        val = to_f32(wg[(size_t)(k0 + kk) * N + n0 + c]);
      ws[kk][c] = val;
    }
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < BKS; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = ty * TM + i, r = m0 + rl;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < N)
        o[(size_t)r * N + c] = from_f32<T>(rl < rows ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* valid, void* out, int G,
           int C, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, G);
  grouped_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), valid,
      static_cast<T*>(out), C, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. valid_rows may be NULL (all rows
// valid). Returns a cudaError_t (0 = launched).
int grouped_matmul_forward(const void* x, const void* w,
                           const void* valid_rows, void* out, int G, int C,
                           int K, int N, int dtype, void* stream) {
  if (G <= 0 || C <= 0 || K <= 0 || N <= 0 || G > 65535 ||
      (C + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int* valid = static_cast<const int*>(valid_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, valid, out, G, C, K, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, valid, out, G, C, K, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
