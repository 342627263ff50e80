// Grouped (per-expert) matmul for Hopper (sm_90a), on the tensor cores.
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
// moves 1.07 GB of weights (0.32 ms at 3.35 TB/s) and does 21.5 GFLOP,
// which three TF32 passes on the tensor cores run in 0.13 ms (495 TFLOP/s,
// H100 SXM data sheet): the bytes bound it. The kernel has to stream the
// weights at the card's memory rate while the products keep up.
//
// What the design does about it.
//   * Grid: one CTA per (128-column N tile, 64-row tile, expert). With
//     C <= 64 an expert has one row tile, so each weight is read from
//     device memory exactly once (1024 CTAs at the gate-up shape). The
//     row tile is four m16 tiles; C = 40 runs three, the last masked. The
//     count of m16 tiles that run is a template parameter (one switch per
//     CTA), so the inner loops carry no per-tile branch.
//   * The weights stream through a ring of STAGES = 3 K-slices (f32 32 x
//     128, bf16 64 x 128: 16 KB each) by 16-byte cp.async.cg, the next two
//     slices in flight while this one computes; x's slice rides in the
//     same ring. Two CTAs of 8 warps fit on an SM (94 KB / 78 KB of shared
//     memory).
//   * Products on mma.sync (mma.cuh): f32 as m16n8k8 TF32 in three passes
//     (lo.hi + hi.lo + hi.hi), bf16 as m16n8k16 in one. Each of the eight
//     warps owns 16 columns (two n8 tiles) across every m16 tile, so one
//     split W fragment feeds up to four m tiles x 3 passes; f32 x is split
//     into hi / lo once a slice, into shared memory in fragment order. The
//     splits are tc::split_int: hi rounded by integer arithmetic, lo left
//     for the tensor cores to truncate, four instructions where cvt.rna
//     takes more.
//   * Each K-slice sums into fresh registers that are then added to the
//     accumulator in f32: the tensor cores' own accumulation is not
//     rounded to nearest, and over K = 2048 (768 chained mma) it drifted
//     by up to 6e-5; a slice chains 12.
//   * W rows are padded to 136 elements, x rows to 36 f32 / 72 bf16, so
//     every fragment load of a warp hits 32 distinct banks (bf16 W
//     fragments come through ldmatrix.trans).
//   * An m16 tile wholly at or past valid_rows[g] issues no mma; rows past
//     it inside a tile load as 0 and are stored as 0. A CTA with no valid
//     row reads nothing and writes zeros, so an empty expert reads none of
//     its weights.
//   * Ragged K and N are masked at the edges: a 16-byte chunk past the
//     edge is zero-filled. When K or N is no multiple of 16 bytes (or a
//     base is unaligned) the same ring is filled by plain loads.
//
// Interface: plain C, loaded with ctypes. The entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 64, MT = BM / 16;         // rows a CTA, m16 tiles
constexpr int BN = 128;                      // columns a CTA
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int WN = BN / WARPS, NT = WN / 8;  // columns a warp, its n8 tiles
constexpr int STAGES = 3;
constexpr int LDW = BN + 8;                  // W slice row, padded

template <typename T>
__host__ __device__ constexpr int bk() { return tc::is_f32<T>() ? 32 : 64; }
template <typename T>
__host__ __device__ constexpr int ldx() {
  return tc::is_f32<T>() ? bk<T>() + 4 : bk<T>() + 8;
}
// one ring stage: a W slice [BK][LDW] and an x slice [BM][LDX]
template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return bk<T>() * LDW + BM * ldx<T>();
}
// f32: x's slice split into hi / lo in fragment order, [MT][BK / 8][2][32]
template <typename T>
__host__ __device__ constexpr int xfrag_u4() {
  return tc::is_f32<T>() ? MT * (bk<T>() / 8) * 2 * 32 : 0;
}
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)xfrag_u4<T>() * 16 +
         (size_t)STAGES * stage_elems<T>() * sizeof(T);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One CTA's tile once it has valid rows, NM (1..4) m16 tiles of them.
template <typename T, int NM>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ xg,
                                          const T* __restrict__ wg,
                                          T* __restrict__ o, int C, int K,
                                          int N, int m0, int n0, int rows,
                                          bool aligned) {
  constexpr int BK = bk<T>(), LDX = ldx<T>(), KK = BK / 8;
  constexpr int E = 16 / sizeof(T);          // elements a 16-byte chunk
  extern __shared__ __align__(16) uint4 smem[];
  uint4* xf = smem;                          // f32 only
  T* ring = reinterpret_cast<T*>(smem + xfrag_u4<T>());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;

  // K-slice `ks` into ring stage `s`: W rows k0.., columns n0..; x rows
  // 0..rows-1 of this tile; zeros past every edge
  auto load = [&](int s, int ks) {
    T* ws = ring + s * stage_elems<T>();
    T* xs = ws + BK * LDW;
    const int k0 = ks * BK;
    for (int i = tid; i < BK * (BN / E); i += THREADS) {
      const int kk = i / (BN / E), c = (i % (BN / E)) * E;
      const int k = k0 + kk, n = n0 + c;
      T* d = ws + kk * LDW + c;
      if (aligned) {
        tc::cp_async16(d, k < K && n < N ? wg + (size_t)k * N + n : nullptr,
                       wg);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          d[e] = k < K && n + e < N ? wg[(size_t)k * N + n + e] : T(0.f);
      }
    }
    for (int i = tid; i < BM * (BK / E); i += THREADS) {
      const int r = i / (BK / E), c = (i % (BK / E)) * E, k = k0 + c;
      T* d = xs + r * LDX + c;
      if (aligned) {
        tc::cp_async16(d, r < rows && k < K ? xg + (size_t)r * K + k : nullptr,
                       xg);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          d[e] = r < rows && k + e < K ? xg[(size_t)r * K + k + e] : T(0.f);
      }
    }
  };

  // each K-slice sums into `part`, which is then added to `acc`: the
  // tensor cores' accumulation over a slice's 12 (f32) or 4 (bf16) mma is
  // short, and the sum over slices is an f32 add
  float acc[NM][NT][4], part[NM][NT][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  const int nks = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nks) load(s, s);
    tc::cp_commit();
  }
  for (int ks = 0; ks < nks; ++ks) {
    tc::cp_wait<STAGES - 2>();               // slice ks has landed
    __syncthreads();                         // ... for every thread, and
    // every warp is done with slice ks - 1, whose stage is refilled here
    if (ks + STAGES - 1 < nks)
      load((ks + STAGES - 1) % STAGES, ks + STAGES - 1);
    tc::cp_commit();
    const T* ws = ring + (ks % STAGES) * stage_elems<T>();
    const T* xs = ws + BK * LDW;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        part[m][j][0] = part[m][j][1] = part[m][j][2] = part[m][j][3] = 0.f;

    if constexpr (tc::is_f32<T>()) {
      // x's slice split once into hi / lo A fragments
      for (int i = tid; i < NM * KK * 32; i += THREADS) {
        const int l = i & 31, kk = (i >> 5) % KK, m = (i >> 5) / KK;
        const float* xr = xs + (m * 16 + (l >> 2)) * LDX + kk * 8 + (l & 3);
        const float v[4] = {xr[0], xr[8 * LDX], xr[4], xr[8 * LDX + 4]};
        uint32_t h[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split_int(v[e], h[e], lo[e]);
        xf[((m * KK + kk) * 2) * 32 + l] = make_uint4(h[0], h[1], h[2], h[3]);
        xf[((m * KK + kk) * 2 + 1) * 32 + l] =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const float* wr = ws + (kk * 8 + t) * LDW + warp * WN + gr;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          tc::split_int(wr[8 * j], bh[j][0], bl[j][0]);
          tc::split_int(wr[4 * LDW + 8 * j], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const uint4 h4 = xf[((m * KK + kk) * 2) * 32 + lane];
          const uint4 l4 = xf[((m * KK + kk) * 2 + 1) * 32 + lane];
          const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w};
          const uint32_t al[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int j = 0; j < NT; ++j)
            tc::mma3(part[m][j], ah, al, bh[j][0], bh[j][1], bl[j][0],
                     bl[j][1]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t b[NT / 2][4];
        const T* wr =
            ws + (kk * 16 + (lane & 15)) * LDW + warp * WN + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) tc::ldsm_x4_trans(b[j], wr + 16 * j);
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const T* xr = xs + (m * 16 + gr) * LDX + kk * 16 + 2 * t;
          const uint4 a = make_uint4(
              *reinterpret_cast<const uint32_t*>(xr),
              *reinterpret_cast<const uint32_t*>(xr + 8 * LDX),
              *reinterpret_cast<const uint32_t*>(xr + 8),
              *reinterpret_cast<const uint32_t*>(xr + 8 * LDX + 8));
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            tc::mma_bf16(part[m][2 * j], a, b[j][0], b[j][1]);
            tc::mma_bf16(part[m][2 * j + 1], a, b[j][2], b[j][3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
  }
  tc::cp_wait<0>();

  // rows past `rows` (and whole m tiles that never ran) are stored as 0
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = m * 16 + gr + 8 * h, r = m0 + rl;
      if (r >= C) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + warp * WN + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < N)
            o[(size_t)r * N + c + e] = from_f32<T>(
                m < NM && rl < rows ? acc[m < NM ? m : 0][j][2 * h + e]
                                    : 0.f);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ valid_rows, T* __restrict__ out,
                      int C, int K, int N, bool aligned) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, g = blockIdx.z;
  int limit = C;
  if (valid_rows != nullptr) limit = max(0, min(C, valid_rows[g]));
  const int rows = min(BM, limit - m0);      // valid rows of this tile
  T* o = out + (size_t)g * C * N;
  if (rows <= 0) {                           // skipped: zeros, no reads
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = m0 + i / BN, c = n0 + i % BN;
      if (r < C && c < N) o[(size_t)r * N + c] = from_f32<T>(0.f);
    }
    return;
  }
  const T* xg = x + (size_t)g * C * K + (size_t)m0 * K;
  const T* wg = w + (size_t)g * K * N;
  // the m16 tiles that run are a compile-time count, so the inner loops
  // carry no per-tile branch
  switch ((rows + 15) / 16) {
    case 1: gemm_tile<T, 1>(xg, wg, o, C, K, N, m0, n0, rows, aligned); break;
    case 2: gemm_tile<T, 2>(xg, wg, o, C, K, N, m0, n0, rows, aligned); break;
    case 3: gemm_tile<T, 3>(xg, wg, o, C, K, N, m0, n0, rows, aligned); break;
    default: gemm_tile<T, 4>(xg, wg, o, C, K, N, m0, n0, rows, aligned);
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* valid, void* out, int G,
           int C, int K, int N, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool aligned = K % E == 0 && N % E == 0 &&
                       ((uintptr_t)x | (uintptr_t)w) % 16 == 0;
  constexpr size_t smem = smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      grouped_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, G);
  grouped_matmul_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), valid,
      static_cast<T*>(out), C, K, N, aligned);
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
