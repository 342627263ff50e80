// The decay gradient of the Mamba2 SSD scan's backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel of src/repro/kernels/ssd_scan.py
// (ssd_scan_bhsp) has no backward, and the JAX package trains through its
// plain ssd_chunked instead. The port's backward (kernels/ssd_scan.py,
// ssd_scan_backward) takes the gradients of x, B and C from launches of the
// forward kernel (ssd_scan.cu) on reversed and rearranged inputs; this
// kernel gives the gradient of the log decays a [B, S, H].
//
// What it computes. With L = cumsum(a) over S, a_t enters every pair
// (i >= t > j) of y_i = sum_{j<=i} (C_i.B_j) e^(L_i - L_j) x_j, so da_t is
// the sum of W_ij = (C_i.B_j) e^(L_i - L_j) (dy_i.x_j) over the pairs that
// cross t. (Summing dy_u.y_u - x_u.dx_u from t on gives the same in exact
// arithmetic, but as a difference of large sums computed along different
// paths: in f32 it loses the decays' gradient.) For t in chunk c (positions
// c0 .. c0 + Q - 1, lc the inclusive cumsum of a inside the chunk, Gamma its
// total) the crossing pairs fall in four parts:
//   * both in the chunk: the exclusive prefix sum over s < t of
//     (sum_{i > s} W_is - sum_{j < s} W_sj), the chunk's W summed by
//     columns below the diagonal and by rows left of it (each W_ij enters
//     both with the same value, so the pairs that do not cross cancel to
//     rounding, as in autograd of the plain version);
//   * i in the chunk, j before it: the suffix sum over i >= t of
//     u_i = e^lc_i C_i^T H_c dy_i, H_c [N, P] the forward's state entering
//     the chunk;
//   * i after the chunk, j in it: the prefix sum over j < t of
//     v_j = e^(Gamma - lc_j) B_j^T G_c x_j, G_c = e^a(c0 + Q) R the reversed
//     dx scan's state at the chunk's end (sum_{i after} e^(L_i - L_end) C_i
//     dy_i^T);
//   * i after, j before: kappa_c = e^Gamma <H_c, G_c>.
//
// Inputs: x, dy [B, S, H, P]; B, C [B, S, H, N]; a [B, S, H]; fst and rst
// [B H, S / Q - 1, N, P], the forward's states entering chunks 1.. and the
// reversed dx scan's (both are its launches' chunk-states scratch; NULL
// when S == Q); all f32, contiguous. Output da [B, S, H] f32. Q <= 256.
//
// What bounds it on this card. At mamba2-780m's training shape ([2, 4096],
// 48 heads of 64, N 128, Q 256) it reads x, dy, B, C and the two state
// stacks once (~390 MB, 0.12 ms at 3.35 TB/s) and does the chunks' W (Q^2 /
// 2 (N + P) FMAs a chunk) and the u / v forms (2 Q N P): ~58 GFLOP, 0.87
// ms at the 67 TFLOP/s f32 peak outside the tensor cores. Bound by
// operations.
//
// What the design does about it. One CTA of 256 threads per (row, chunk).
// W in 64 x 64 tiles of the lower triangle: C and dy rows of an i-tile and
// B and x rows of a j-tile in shared memory (rows padded to an odd stride,
// so a half warp's column reads hit distinct banks), each thread a 4 x 4
// block of both products (SIMT f32), W staged in shared memory and summed
// by 64 threads down its columns and 64 along its rows in a fixed order.
// Then H_c and G_c in shared memory and a warp a position for u and v
// (lanes over N, a shuffle tree), a block reduction for kappa, and warp
// scans over runs of positions for the prefix and suffix sums. Every sum
// runs in a fixed order: the result does not change from run to run.
//
// Interface: plain C, loaded with ctypes. The entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TQ = 64;                 // tile of positions
constexpr int QMAX = 256;              // the longest chunk
constexpr unsigned FULL = 0xffffffffu;

// Shared memory in floats: five [QMAX] vectors, then the larger of the W
// phase's tiles (C, B [TQ][N + 1], dy, x [TQ][P + 1], W [TQ][TQ + 1]) and
// H, G [N][P + 1].
__host__ __device__ inline size_t smem_floats(int N, int P) {
  const size_t tiles = (size_t)2 * TQ * (N + 1) + (size_t)2 * TQ * (P + 1) +
                       (size_t)TQ * (TQ + 1);
  const size_t states = (size_t)2 * N * (P + 1);
  return (size_t)5 * QMAX + (tiles > states ? tiles : states);
}

// One warp scans v[0 .. n) in place: prefix (or, with reverse, suffix)
// sums, inclusive or exclusive. Each lane walks a run of ceil(n / 32)
// positions.
__device__ void warp_scan(float* v, int n, bool reverse, bool exclusive) {
  const int lane = threadIdx.x & 31, per = (n + 31) / 32;
  const int k0 = min(n, lane * per), k1 = min(n, k0 + per);
  auto at = [&](int k) -> float& { return v[reverse ? n - 1 - k : k]; };
  float run = 0.f;
  for (int k = k0; k < k1; ++k) run += at(k);
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  float acc = incl - run;
  for (int k = k0; k < k1; ++k) {
    const float x = at(k);
    if (exclusive) {
      at(k) = acc;
      acc += x;
    } else {
      acc += x;
      at(k) = acc;
    }
  }
}

// rows r0 .. r0 + TQ - 1 (chunk-local, < Q) of a [.., cols] matrix whose
// chunk-local row k starts at base + k * rs, into dst [TQ][cols + 1]
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          size_t rs, int r0, int Q,
                                          int cols) {
  for (int e = threadIdx.x; e < TQ * cols; e += THREADS) {
    const int k = e / cols, d = e % cols;
    dst[k * (cols + 1) + d] =
        r0 + k < Q ? base[(size_t)(r0 + k) * rs + d] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_scan_dlog_kernel(const float* x, const float* bm, const float* cm,
                     const float* dy, const float* a, const float* fst,
                     const float* rst, float* da, int S, int H, int P, int N,
                     int Q) {
  extern __shared__ float sm[];
  float* lc = sm;                      // [QMAX] cumsum of a in the chunk
  float* rs = lc + QMAX;               // row sums, then the intra term
  float* cs = rs + QMAX;               // column sums
  float* us = cs + QMAX;               // u, then its suffix sums
  float* vs = us + QMAX;               // v, then its prefix sums
  float* big = vs + QMAX;
  __shared__ float part[WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid / 16, tx = tid % 16;
  const int nc = S / Q, row = blockIdx.x / nc, c = blockIdx.x % nc;
  const int bi = row / H, h = row % H, c0 = c * Q;
  const size_t pos0 = ((size_t)bi * S + c0) * H + h;   // (b, c0, h)
  const float* xb = x + pos0 * P;      // chunk-local position k at + k H P
  const float* db = dy + pos0 * P;
  const float* bb = bm + pos0 * N;
  const float* cb = cm + pos0 * N;
  const size_t sP = (size_t)H * P, sN = (size_t)H * N;

  for (int k = tid; k < QMAX; k += THREADS) {
    lc[k] = k < Q ? a[pos0 + (size_t)k * H] : 0.f;
    rs[k] = cs[k] = us[k] = vs[k] = 0.f;
  }
  __syncthreads();
  if (warp == 0) warp_scan(lc, Q, false, false);
  __syncthreads();

  // the chunk's W by 64 x 64 tiles of its lower triangle
  float* ct = big;                     // [TQ][N + 1] C rows of the i-tile
  float* bt = ct + TQ * (N + 1);       // [TQ][N + 1] B rows of the j-tile
  float* yt = bt + TQ * (N + 1);       // [TQ][P + 1] dy rows of the i-tile
  float* xt = yt + TQ * (P + 1);       // [TQ][P + 1] x rows of the j-tile
  float* wt = xt + TQ * (P + 1);       // [TQ][TQ + 1]
  const int nt = (Q + TQ - 1) / TQ;
  for (int it = 0; it < nt; ++it) {
    __syncthreads();
    load_tile(ct, cb, sN, it * TQ, Q, N);
    load_tile(yt, db, sP, it * TQ, Q, P);
    for (int jt = 0; jt <= it; ++jt) {
      __syncthreads();                 // the last tile's readers are done
      load_tile(bt, bb, sN, jt * TQ, Q, N);
      load_tile(xt, xb, sP, jt * TQ, Q, P);
      __syncthreads();
      float s1[4][4], s2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s1[i][j] = s2[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float p[4], q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ct[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = bt[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s1[i][j] = fmaf(p[i], q[j], s1[i][j]);
      }
      for (int d = 0; d < P; ++d) {
        float p[4], q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = yt[(ty + 16 * i) * (P + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = xt[(tx + 16 * j) * (P + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s2[i][j] = fmaf(p[i], q[j], s2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ri = ty + 16 * i, cj = tx + 16 * j;
          const int gi = it * TQ + ri, gj = jt * TQ + cj;
          wt[ri * (TQ + 1) + cj] =
              gi > gj && gi < Q
                  ? s1[i][j] * s2[i][j] * expf(fminf(lc[gi] - lc[gj], 0.f))
                  : 0.f;
        }
      __syncthreads();
      if (tid < TQ) {                  // column sums below the diagonal
        float acc = 0.f;
        for (int k = 0; k < TQ; ++k) acc += wt[k * (TQ + 1) + tid];
        if (jt * TQ + tid < Q) cs[jt * TQ + tid] += acc;
      } else if (tid < 2 * TQ) {       // row sums left of it
        const int k = tid - TQ;
        float acc = 0.f;
        for (int j = 0; j < TQ; ++j) acc += wt[k * (TQ + 1) + j];
        if (it * TQ + k < Q) rs[it * TQ + k] += acc;
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < Q; k += THREADS) rs[k] = cs[k] - rs[k];
  __syncthreads();
  if (warp == 0) warp_scan(rs, Q, false, true);   // the intra term

  // the states: H_c entering the chunk, G_c at its end from the right
  float* hs = big;                     // [N][P + 1]
  float* gs = hs + N * (P + 1);
  const size_t np = (size_t)N * P;
  const bool has_h = c > 0, has_g = c < nc - 1;
  const float* hsrc = has_h ? fst + ((size_t)row * (nc - 1) + c - 1) * np
                            : nullptr;
  const float* gsrc = has_g ? rst + ((size_t)row * (nc - 1) + nc - 2 - c) * np
                            : nullptr;
  const float ga = has_g ? expf(a[pos0 + (size_t)Q * H]) : 0.f;
  __syncthreads();
  for (size_t e = tid; e < np; e += THREADS) {
    const int n = e / P, p = e % P;
    hs[n * (P + 1) + p] = has_h ? hsrc[e] : 0.f;
    gs[n * (P + 1) + p] = has_g ? ga * gsrc[e] : 0.f;
  }
  __syncthreads();
  const float gam = lc[Q - 1];
  // u_i = e^lc_i C_i^T H dy_i and v_j = e^(Gamma - lc_j) B_j^T G x_j
  for (int k = warp; k < Q; k += WARPS) {
    float u = 0.f, v = 0.f;
    const float* yk = db + (size_t)k * sP;
    const float* xk = xb + (size_t)k * sP;
    for (int n = lane; n < N; n += 32) {
      float th = 0.f, tg = 0.f;
      for (int p = 0; p < P; ++p) {
        th = fmaf(hs[n * (P + 1) + p], yk[p], th);
        tg = fmaf(gs[n * (P + 1) + p], xk[p], tg);
      }
      u = fmaf(cb[(size_t)k * sN + n], th, u);
      v = fmaf(bb[(size_t)k * sN + n], tg, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      u += __shfl_xor_sync(FULL, u, o);
      v += __shfl_xor_sync(FULL, v, o);
    }
    if (lane == 0) {
      us[k] = u * expf(lc[k]);
      vs[k] = v * expf(gam - lc[k]);
    }
  }
  // kappa = e^Gamma <H, G>
  float kap = 0.f;
  for (size_t e = tid; e < np; e += THREADS) {
    const int n = e / P, p = e % P;
    kap = fmaf(hs[n * (P + 1) + p], gs[n * (P + 1) + p], kap);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kap += __shfl_xor_sync(FULL, kap, o);
  if (lane == 0) part[warp] = kap;
  __syncthreads();
  if (warp == 0) warp_scan(us, Q, true, false);    // suffix sums of u
  if (warp == 1) warp_scan(vs, Q, false, true);    // exclusive prefix of v
  __syncthreads();
  kap = 0.f;
  for (int w = 0; w < WARPS; ++w) kap += part[w];
  kap *= expf(gam);
  for (int k = tid; k < Q; k += THREADS)
    da[pos0 + (size_t)k * H] = rs[k] + us[k] + vs[k] + kap;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).
int ssd_scan_dlog(const void* x, const void* b, const void* c,
                  const void* dy, const void* a, const void* fst,
                  const void* rst, void* da, int B, int S, int H, int P,
                  int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > QMAX || S % Q != 0 || (long long)B * H * (S / Q) > 0x7fffffff ||
      (S > Q && (fst == nullptr || rst == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, P) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_dlog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_scan_dlog_kernel<<<(unsigned)((long long)B * H * (S / Q)), THREADS,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(dy),
      static_cast<const float*>(a), static_cast<const float*>(fst),
      static_cast<const float*>(rst), static_cast<float*>(da), S, H, P, N,
      Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
