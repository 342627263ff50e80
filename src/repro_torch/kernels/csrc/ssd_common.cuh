// The pieces of the Mamba2 SSD scan for Hopper (sm_90a) that the forward
// (ssd_scan.cu) and the backward (ssd_scan_bwd.cu) share: the chunk-state
// kernel and the pass over chunks (each run forwards by the forward and
// reversed by the backward), the in-chunk cumulative sum of the decays,
// the tile loads and the three-pass TF32 product with its B operand split
// by tc::split_int. ssd_scan.cu's header has the design; mma.cuh the
// fragment layouts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int T = 64;                // positions of a tile
constexpr int NB = 128;              // state rows a state-kernel CTA
constexpr int NP8 = 8;               // n8 tiles of P at most (P <= 64)
constexpr int STATE_THREADS = 256, CHUNK_THREADS = 256, PASS_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a block may take

struct Args {
  const float* x;   // [B, S, H, P]
  const float* a;   // [B, S, H]
  const float* b;   // [B, S, H, N]
  const float* c;   // [B, S, H, N]
  float* y;         // [B, S, H, P]
  float* st;        // [B H, nc - 1, N, P]: chunk states, then entering states
  float* gam;       // [B H, nc - 1]: exp(lc_last) of each chunk
  int S, H, P, N, Q, nc;
};

__host__ __device__ inline int round4(int q) { return (q + 3) / 4 * 4; }

// B tile [T][min(N, NB) + 8], x tile as hi and lo planes [T][P + 8] each,
// exp(lc_last - lc) [T], lc [Q]
size_t state_smem(int N, int P, int Q) {
  const int nw = N < NB ? N : NB;
  return 4 * ((size_t)T * (nw + 8) + 2 * (size_t)T * (P + 8) + T +
              round4(Q));
}

// c += a . b in three TF32 passes, b given as f32 and split here
__device__ __forceinline__ void mma3f(float (&c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0,
                                      float b1) {
  uint32_t h0, l0, h1, l1;
  tc::split_int(b0, h0, l0);
  tc::split_int(b1, h1, l1);
  tc::mma3(c, ah, al, h0, h1, l0, l1);
}

// lc = inclusive cumsum of the chunk's decays, by warp 0: the decays are
// loaded all at once (independent loads, in flight together), then each
// lane sums a run of the chunk and the runs' totals are scanned across the
// warp.
__device__ __forceinline__ void chunk_lc(const float* a, int64_t row0, int H,
                                         int c0, int Q, float* lc) {
  const int lane = threadIdx.x & 31;
#pragma unroll 8
  for (int k = lane; k < Q; k += 32) lc[k] = a[row0 + (int64_t)(c0 + k) * H];
  __syncwarp();
  const int per = (Q + 31) / 32, lo = lane * per;
  float run = 0.f;
  for (int k = 0; k < per && lo + k < Q; ++k) {
    run += lc[lo + k];
    lc[lo + k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const float off = incl - run;
  for (int k = 0; k < per && lo + k < Q; ++k) lc[lo + k] += off;
}

// T rows of `cols` floats from src (row stride `stride` floats) into a
// [T][ld] tile by 16-byte cp.async; rows at or past `rows` are zero. src,
// cols and stride are multiples of 4 floats. (r, u) walks the tile's
// 16-byte chunks by nthreads without a division per chunk.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t stride, int rows, int cols,
                                          int nthreads) {
  const int ch = cols / 4, dr = nthreads / ch, du = nthreads % ch;
  int r = threadIdx.x / ch, u = threadIdx.x % ch;
  for (; r < T; r += dr, u += du) {
    if (u >= ch) {
      u -= ch;
      ++r;
      if (r >= T) break;
    }
    tc::cp_async16(dst + r * ld + 4 * u,
                   r < rows ? src + r * stride + 4 * u : nullptr, src);
  }
}

// Split the [T][P] tile held in `lo` (rows of ld floats) in place into its
// TF32 hi (into `hi`) and lo parts, as bits, once for every warp that reads
// it as the B operand.
__device__ __forceinline__ void split_tile(float* hi, float* lo, int ld,
                                           int P, int nthreads) {
  const int ch = P / 4, dr = nthreads / ch, du = nthreads % ch;
  int r = threadIdx.x / ch, u = threadIdx.x % ch;
  for (; r < T; r += dr, u += du) {
    if (u >= ch) {
      u -= ch;
      ++r;
      if (r >= T) break;
    }
    const int o = r * ld + 4 * u;
    const float4 v = *reinterpret_cast<const float4*>(lo + o);
    uint4 h, l;
    tc::split_int(v.x, h.x, l.x);
    tc::split_int(v.y, h.y, l.y);
    tc::split_int(v.z, h.z, l.z);
    tc::split_int(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// REV: the backward's reversed states (ssd_scan_bwd.cu): chunk c + 1's
// s = (B .* exp(lc))^T x with g.b = C and g.x = dy, and its gamma.
template <int NPT, bool REV>   // NPT: n8 tiles of P, 8 or 0 for P / 8
__global__ void __launch_bounds__(STATE_THREADS)
ssd_scan_state_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, P = g.P, Q = g.Q, H = g.H, nc1 = g.nc - 1;
  const int nb = (N + NB - 1) / NB;
  const int blk = blockIdx.x % nb, rc = blockIdx.x / nb;
  const int c = rc % nc1, r = rc / nc1;
  const int n0 = blk * NB, nw = min(NB, N - n0);   // state rows here
  const int LDB = min(N, NB) + 8, LDX = P + 8;
  float* bt = smem;                  // [T][LDB]  B tile, positions x n
  float* xh = bt + T * LDB;          // [T][LDX]  x tile, TF32 hi bits
  float* xl = xh + T * LDX;          // [T][LDX]  ... and lo bits
  float* wj = xl + T * LDX;          // [T]       exp(lc_last - lc_j)
  float* lc = wj + T;                // [Q]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int bi = r / H, h = r % H, c0 = (REV ? c + 1 : c) * Q;
  const int64_t row0 = (int64_t)bi * g.S * H + h;
  auto load = [&](int j0) {          // B and x rows j0.. of the chunk
    const int jn = min(T, Q - j0);
    const int64_t pos = row0 + (int64_t)(c0 + j0) * H;
    load_rows(bt, LDB, g.b + pos * N + n0, (int64_t)H * N, jn, nw,
              STATE_THREADS);
    load_rows(xl, LDX, g.x + pos * P, (int64_t)H * P, jn, P, STATE_THREADS);
    tc::cp_commit();
  };
  load(0);                           // in flight while lc is summed
  if (warp == 0) chunk_lc(g.a, row0, H, c0, Q, lc);
  __syncthreads();
  const float l_last = lc[Q - 1];

  const int np8 = NPT ? NPT : P / 8, m = warp * 16;  // m16 tile of n
  float acc[NP8][4];
#pragma unroll
  for (int n = 0; n < NP8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += T) {
    const int jn = min(T, Q - j0);
    if (j0 > 0) load(j0);
    if (tid < T)
      wj[tid] = tid < jn ? expf(REV ? lc[j0 + tid] : l_last - lc[j0 + tid])
                         : 0.f;
    tc::cp_wait<0>();
    __syncthreads();
    split_tile(xh, xl, LDX, P, STATE_THREADS);
    __syncthreads();
    if (m < nw) {
      // s[n, p] += sum_j (B_jn w_j) x_jp: A = (B .* w)^T, B operand = x
      for (int kk = 0; kk < (jn + 7) / 8; ++kk) {
        const int j = kk * 8 + t;
        const float w0 = wj[j], w1 = wj[j + 4];
        const float* br = bt + j * LDB + m + gr;
        const bool lo_ok = m + gr < nw, hi_ok = m + gr + 8 < nw;
        const float v[4] = {lo_ok ? br[0] * w0 : 0.f,
                            hi_ok ? br[8] * w0 : 0.f,
                            lo_ok ? br[4 * LDB] * w1 : 0.f,
                            hi_ok ? br[4 * LDB + 8] * w1 : 0.f};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split_int(v[e], ah[e], al[e]);
        const int o = j * LDX + gr;
#pragma unroll
        for (int n = 0; n < NP8; ++n)
          if (n < np8)
            tc::mma3(acc[n], ah, al, bits(xh[o + 8 * n]),
                     bits(xh[o + 4 * LDX + 8 * n]), bits(xl[o + 8 * n]),
                     bits(xl[o + 4 * LDX + 8 * n]));
      }
    }
    __syncthreads();
  }

  if (m < nw) {
    float* out = g.st + (((int64_t)r * nc1 + c) * N + n0) * P;
#pragma unroll
    for (int n = 0; n < NP8; ++n) {
      if (n >= np8) continue;
      const int p = 8 * n + 2 * t;
      if (m + gr < nw)
        *reinterpret_cast<float2*>(out + (int64_t)(m + gr) * P + p) =
            make_float2(acc[n][0], acc[n][1]);
      if (m + gr + 8 < nw)
        *reinterpret_cast<float2*>(out + (int64_t)(m + gr + 8) * P + p) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
  if (tid == 0 && blk == 0) g.gam[(int64_t)r * nc1 + c] = expf(l_last);
}

// t = gamma_c t + s_c over the chunks of one row, in order; s_c is
// overwritten with t, the state entering chunk c + 1. Four chunks' loads
// are issued before their chain. REV walks the slots from the last down
// (the backward's reversed states: slot c ends up holding G_c).
template <bool REV>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_scan_pass_kernel(float* st, const float* gam, int nc1, int NP) {
  const int r = blockIdx.x, e = blockIdx.y * PASS_THREADS + threadIdx.x;
  if (e >= NP) return;
  float* s = st + (int64_t)r * nc1 * NP + e;
  const float* gm = gam + (int64_t)r * nc1;
  float t = 0.f;
  auto slot = [&](int k) { return REV ? nc1 - 1 - k : k; };
  for (int c = 0; c < nc1; c += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = c + u < nc1 ? s[(int64_t)slot(c + u) * NP] : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c + u < nc1) {
        t = gm[slot(c + u)] * t + v[u];
        s[(int64_t)slot(c + u) * NP] = t;
      }
    }
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
