// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan_kernel <- ssd_scan_bhsp (body _kernel)
//
// What it computes. For every (batch b, head h) row of x [B, S, H, P]
// (dt-scaled inputs), a [B, S, H] (log decay), B and C [B, S, H, N], all
// f32 and contiguous, the sequence is cut into chunks of Q positions
// (S % Q == 0) and, walking the chunks in order with a state St [N, P]
// that starts at 0:
//
//   lc    = cumsum(a) over the chunk             (inclusive, within chunk)
//   y     = ((C B^T) .* exp(min(lc_i - lc_j, 0)) .* [j <= i]) x   (intra)
//         + (C .* exp(lc)) St                     (inter, the old state)
//   St    = exp(lc_last) St + (B .* exp(lc_last - lc))^T x
//
// and y [B, S, H, P] is written in f32. The clamp sits before the mask, as
// in the TPU kernel and the model's ssd_chunked.
//
// What bounds it on this card. At mamba2-780m's forward on [2, 4096]
// tokens (B H = 96 rows, S 4096, P 64, N 128, Q 256, 16 chunks) the
// inputs and the output move 605 MB (0.181 ms at 3.35 TB/s) and the
// visible work is 21.0 MFLOP per (row, chunk): the causal scores, the
// scores times x, the inter-chunk term and the state update, 32.3 GFLOP
// in all (0.482 ms at 67 TFLOP/s f32, H100 SXM data sheet). The
// operations bound it.
//
// What the design does about it.
//   * The TPU walks the chunks as its sequential grid axis and carries the
//     state in VMEM scratch. Here one CTA owns one (b, h) row and a tile of
//     32 columns of P (one per lane) and loops over the chunks in order;
//     its state tile [N, 32] stays in shared memory for the whole row.
//     Columns of P are independent, so the grid is (B H, P / 32): 192
//     CTAs at the shape above, two resident per SM (109 KB of shared
//     memory and 256 threads each). The scores and decays are recomputed
//     in each P tile.
//   * One chunk does not fit in shared memory (at Q 256 and N 128 one
//     chunk of B is 128 KB and the score block 256 KB), so the chunk is
//     walked in 64-row tiles of C against 64-column tiles of B with j <= i
//     only: tiles wholly above the diagonal are never read or computed.
//     C and B tiles are staged n-major (rows padded to 68 floats against
//     bank conflicts) so a thread reads one float4 of each per n for its
//     4 x 4 block of scores.
//   * The inter-chunk term reads the state from before the chunk; the
//     update waits behind a barrier until every warp has read it, and then
//     rides on the last row tile's walk over all the B and x tiles of the
//     chunk, so B and x are not read a second time for it. Each thread
//     owns fixed entries of the state, so the update needs no atomics.
//   * lc is an inclusive warp scan of the chunk's decays, kept in shared
//     memory.
// This is the simple first kernel: SIMT f32 FMAs, no tensor cores (wgmma),
// no TMA, no double buffering. With one group every head reads the same B
// and C (the wrapper repeats them, as the JAX one does); reading them once
// per group is left for later.
//
// Interface: plain C, loaded with ctypes. The entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;              // rows of a C tile, columns of a B tile
constexpr int TP = T + 4;          // n-major tile row, padded
constexpr int PT = 32;             // columns of P per CTA: one per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = T / WARPS;     // rows of y per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a block may take

struct Args {
  const float* x;   // [B, S, H, P]
  const float* a;   // [B, S, H]
  const float* b;   // [B, S, H, N]
  const float* c;   // [B, S, H, N]
  float* y;         // [B, S, H, P]
  int S, H, P, N, Q;
};

size_t smem_floats(int N, int Q) {
  return 2 * (size_t)N * TP + T * PT + T * T + (size_t)N * PT + T +
         ((size_t)Q + 3) / 4 * 4;
}

__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, Q = g.Q, P = g.P, H = g.H;
  float* ct = smem;              // [N][TP]  C tile, n-major
  float* bt = ct + N * TP;       // [N][TP]  B tile, n-major
  float* xs = bt + N * TP;       // [T][PT]  x tile
  float* ms = xs + T * PT;       // [T][T]   masked, decayed scores
  float* st = ms + T * T;        // [N][PT]  carried state
  float* wj = st + N * PT;       // [T]      exp(lc_last - lc_j)
  float* lc = wj + T;            // [Q]      cumulative log decay

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;          // 4 x 4 score block
  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.y * PT, p = p0 + lane;
  // index of sequence position s of this (b, h) row in the [B, S, H] grid
  const int64_t row0 = (int64_t)bi * g.S * H + h;

  for (int e = tid; e < N * PT; e += THREADS) st[e] = 0.f;
  const int nt = (Q + T - 1) / T;

  for (int c0 = 0; c0 < g.S; c0 += Q) {
    // lc: each lane of warp 0 sums a run of the chunk, then the runs'
    // totals are scanned across the warp
    if (warp == 0) {
      const int per = (Q + 31) / 32, lo = lane * per;
      float run = 0.f;
      for (int k = 0; k < per && lo + k < Q; ++k) {
        run += g.a[row0 + (int64_t)(c0 + lo + k) * H];
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
    __syncthreads();
    const float l_last = lc[Q - 1];

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T;
      for (int e = tid; e < T * N; e += THREADS) {
        const int ii = e / N, n = e - ii * N, i = i0 + ii;
        ct[n * TP + ii] =
            i < Q ? g.c[(row0 + (int64_t)(c0 + i) * H) * N + n] : 0.f;
      }
      __syncthreads();

      // inter-chunk term: (C_i exp(lc_i)) . St, the state entering the chunk
      float y[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) y[r] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 lo4 =
            *reinterpret_cast<const float4*>(&ct[n * TP + warp * RPW]);
        const float4 hi4 =
            *reinterpret_cast<const float4*>(&ct[n * TP + warp * RPW + 4]);
        const float s = st[n * PT + lane];
        const float cv[RPW] = {lo4.x, lo4.y, lo4.z, lo4.w,
                               hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int r = 0; r < RPW; ++r) y[r] = fmaf(cv[r], s, y[r]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int i = i0 + warp * RPW + r;
        y[r] = i < Q ? y[r] * expf(lc[i]) : 0.f;
      }

      // the last row tile walks every B / x tile of the chunk: the state
      // update rides on it, once every warp has read the old state
      const bool last = it == nt - 1;
      if (last) {
        __syncthreads();
        const float gamma = expf(l_last);
        for (int n = warp; n < N; n += WARPS) st[n * PT + lane] *= gamma;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        for (int e = tid; e < T * N; e += THREADS) {
          const int jj = e / N, n = e - jj * N, j = j0 + jj;
          bt[n * TP + jj] =
              j < Q ? g.b[(row0 + (int64_t)(c0 + j) * H) * N + n] : 0.f;
        }
        for (int e = tid; e < T * PT; e += THREADS) {
          const int jj = e / PT, pp = e - jj * PT, j = j0 + jj;
          xs[e] = (j < Q && p0 + pp < P)
                      ? g.x[(row0 + (int64_t)(c0 + j) * H) * P + p0 + pp]
                      : 0.f;
        }
        if (last && tid < T) {
          const int j = j0 + tid;
          wj[tid] = j < Q ? expf(l_last - lc[j]) : 0.f;
        }
        __syncthreads();

        // scores C_i . B_j for this thread's 4 x 4 block, decayed, masked
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(&ct[n * TP + ty * 4]);
          const float4 b4 =
              *reinterpret_cast<const float4*>(&bt[n * TP + tx * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          float m[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx * 4 + q;
            m[q] = 0.f;
            if (i < Q && j < Q) {
              const float decay = expf(fminf(lc[i] - lc[j], 0.f));
              m[q] = j <= i ? acc[r][q] * decay : 0.f;
            }
          }
          *reinterpret_cast<float4*>(&ms[(ty * 4 + r) * T + tx * 4]) =
              make_float4(m[0], m[1], m[2], m[3]);
        }
        __syncthreads();

        // y_i += sum_j m_ij x_j
        for (int jj = 0; jj < T; jj += 4) {
          const float x0 = xs[jj * PT + lane], x1 = xs[(jj + 1) * PT + lane];
          const float x2 = xs[(jj + 2) * PT + lane];
          const float x3 = xs[(jj + 3) * PT + lane];
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float4 m4 = *reinterpret_cast<const float4*>(
                &ms[(warp * RPW + r) * T + jj]);
            y[r] = fmaf(m4.x, x0, y[r]);
            y[r] = fmaf(m4.y, x1, y[r]);
            y[r] = fmaf(m4.z, x2, y[r]);
            y[r] = fmaf(m4.w, x3, y[r]);
          }
        }
        // St[n, p] += sum_j B_jn w_j x_jp over this tile
        if (last) {
          for (int n = warp; n < N; n += WARPS) {
            float s = st[n * PT + lane];
            for (int jj = 0; jj < T; jj += 4) {
              const float4 b4 =
                  *reinterpret_cast<const float4*>(&bt[n * TP + jj]);
              const float4 w4 = *reinterpret_cast<const float4*>(&wj[jj]);
              s = fmaf(b4.x * w4.x, xs[jj * PT + lane], s);
              s = fmaf(b4.y * w4.y, xs[(jj + 1) * PT + lane], s);
              s = fmaf(b4.z * w4.z, xs[(jj + 2) * PT + lane], s);
              s = fmaf(b4.w * w4.w, xs[(jj + 3) * PT + lane], s);
            }
            st[n * PT + lane] = s;
          }
        }
        __syncthreads();
      }

      if (p < P) {
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int i = i0 + warp * RPW + r;
          if (i < Q) g.y[(row0 + (int64_t)(c0 + i) * H) * P + p] = y[r];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// The wrapper refuses shapes whose shared memory (smem_floats) passes
// 227 KB before it launches. Returns a cudaError_t (0 = launched).
int ssd_scan_forward(const void* x, const void* a, const void* b,
                     const void* c, void* y, int B, int S, int H, int P,
                     int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      S % Q != 0 || (int64_t)B * H > 0x7fffffff || (P + PT - 1) / PT > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, Q) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Args g{static_cast<const float*>(x), static_cast<const float*>(a),
         static_cast<const float*>(b), static_cast<const float*>(c),
         static_cast<float*>(y), S, H, P, N, Q};
  const dim3 grid(B * H, (P + PT - 1) / PT);
  ssd_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      g);
  return (int)cudaGetLastError();
}

}  // extern "C"
