// Backward pass of the Mamba2 SSD chunked scan for Hopper (sm_90a), one
// fused chunk-parallel pass on the tensor cores.
//
// Replaces no TPU kernel: the Pallas kernel of src/repro/kernels/ssd_scan.py
// (ssd_scan_bhsp) has no backward, and the JAX package trains through its
// plain ssd_chunked instead. The port routes by device, so training on the
// card reaches ssd_scan.cu's forward; this is the backward of that function,
// behind a torch.autograd.Function in kernels/ops.py.
//
// What it computes. For every (batch, head) row, with x, dy [S, P], B, C
// [S, N], a [S] (f32, contiguous in [B, S, H, *]), the sequence in chunks
// of Q positions, lc the inclusive cumsum of a inside a chunk, Gamma its
// total, L_ij = e^(lc_i - lc_j) [i >= j] inside a chunk (the forward's
// clamp kept), H_c [N, P] the forward's state entering chunk c and G_c the
// gradient of the state leaving it, sum over later positions i of
// e^(L_i - L_end(c)) C_i dy_i^T:
//   M1 = (C B^T) .* L,  M2 = (dy x^T) .* L                (per chunk)
//   dx = M1^T dy + e^(Gamma - lc_j) B_j G_c               (rows j)
//   dB = M2^T C  + e^(Gamma - lc_j) G_c x_j
//   dC = M2 B    + e^(lc_i) H_c dy_i                      (rows i)
// and da. a_t enters every pair (i >= t > j) of y_i = sum_{j <= i} (C_i.B_j)
// e^(L_i - L_j) x_j, so da_t is the sum of W_ij = (C_i.B_j) e^(L_i - L_j)
// (dy_i.x_j) over the pairs that cross t. (Summing dy_u.y_u - x_u.dx_u from
// t on gives the same in exact arithmetic, but as a difference of large
// sums computed along different paths: in f32 it loses the decays'
// gradient.) For t in chunk c the crossing pairs fall in four parts:
//   * both in the chunk: the exclusive prefix sum over s < t of
//     (sum_{i > s} W_is - sum_{j < s} W_sj), the chunk's W = (C B^T) .*
//     (dy x^T) .* L strictly below the diagonal, summed by columns and by
//     rows (each W_ij enters both with the same value, so the pairs that
//     do not cross cancel to rounding, as in autograd of the plain
//     version);
//   * i in the chunk, j before it: the suffix sum over i >= t of
//     u_i = C_i . (e^lc_i H_c dy_i), C_i against its dC inter term;
//   * i after the chunk, j in it: the prefix sum over j < t of
//     v_j = B_j . (e^(Gamma - lc_j) G_c x_j), B_j against its dB inter term;
//   * i after, j before: kappa_c = e^Gamma <H_c, G_c>.
//
// Three launches, no atomics, every sum in a fixed order (deterministic):
//   1. ssd_scan_state_kernel<REV> (ssd_common.cuh), one CTA per (row,
//      chunk 1.., 128 state rows): R_c = (C .* e^lc)^T dy and e^Gamma_c.
//   2. ssd_scan_pass_kernel<REV>: walks the chunks from the last down,
//      G_c = e^Gamma_{c+1} G_{c+1} + R_{c+1}. Nothing is flipped in memory.
//   3. ssd_scan_bwd_chunk_kernel, one CTA (8 warps) per (row, chunk):
//      sweep A over 64-position j tiles (B_j, x_j resident, the i >= j tiles
//      of C and dy streamed): M1^T and M2^T with keys j as rows (S^T = B
//      C^T and x dy^T, masked and decayed in registers), W's column sums
//      (rows j, whole) and row sums (columns i, by row group), dx and dB
//      started from their inter terms and v; sweep B over i tiles (dy_i, C_i
//      resident, the j <= i tiles of x and B streamed): M2 again, with rows
//      i, and dC started from its inter term and u; then the scans and da.
// A warp owns 16 rows of the resident tile and one half of the streamed
// tile's n8 tiles (the forward's chunk-kernel split: on the diagonal the
// visible ones fall to both halves alike); the halves' sums meet through
// shared memory. Every product runs on mma.sync m16n8k8 TF32 in three
// passes (lo.hi + hi.lo + hi.hi), f32 accuracy, split by tc::split_int;
// each accumulator is handed on as the A operand of the next product (the k
// permutation of mma.cuh), so nothing is transposed in memory. Tiles arrive
// by 16-byte cp.async, the streamed ones into two buffers, in rows padded
// so each fragment load of a warp hits 32 distinct banks. The forward's
// chunk kernel is never launched.
//
// What bounds it on this card. At mamba2-780m's training shape ([2, 4096],
// 48 heads of 64, N 128, Q 256: 1536 chunks) the products over each chunk's
// lower triangle and the inter terms are ~50 MFLOP a chunk, 77 GFLOP (0.47
// ms in three TF32 passes at 495 TFLOP/s, H100 SXM data sheet); x, a, B, C,
// dy and the forward states in, dx, da, dB, dC out, ~1.1 GB (0.33 ms at
// 3.35 TB/s). Operations and bytes bound it alike. This design computes
// dy x^T twice (once in each sweep, ~12% more products) to keep dC's
// accumulator apart from dx's and dB's.
//
// Shapes: P % 8 == 0, P <= 64; N % 8 == 0, N <= 128; any Q that divides S
// up to 256; the chunk kernel's shared memory (bwd_smem): 197 KB at N 128,
// P 64, Q 256, one CTA an SM; 131 KB at N 64. N 128 / P 64 and N 64 / P 64
// (mamba2-780m, zamba2-7b) run instantiations with their tile counts fixed.
//
// Interface: plain C, loaded with ctypes. The entry returns
// cudaGetLastError() after each launch; the Python wrapper raises on non-0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int NN8 = 16;              // n8 tiles of N at most (N <= 128)
constexpr int QMAX = 256;            // the longest chunk
constexpr int WARPS = CHUNK_THREADS / 32;

struct BwdArgs {
  const float* x;     // [B, S, H, P]
  const float* a;     // [B, S, H]
  const float* b;     // [B, S, H, N]
  const float* c;     // [B, S, H, N]
  const float* dy;    // [B, S, H, P]
  const float* fst;   // [B H, nc - 1, N, P]: H_c of chunks 1..
  const float* rst;   // [B H, nc - 1, N, P]: G_c of chunks 0 .. nc - 2
  float* dx;          // [B, S, H, P]
  float* da;          // [B, S, H]
  float* db;          // [B, S, H, N]
  float* dc;          // [B, S, H, N]
  int S, H, P, N, Q, nc;
};

// The chunk kernel's shared memory: the state region (G [N][P + 8], then
// H^T [P][N + 8]), the resident tiles [T][N + 4] and [T][P + 4], two
// buffers of the streamed pair, ten Q-long vectors and the kappa partials.
size_t bwd_smem(int N, int P, int Q) {
  const size_t st = (size_t)N * (P + 8) > (size_t)P * (N + 8)
                        ? (size_t)N * (P + 8) : (size_t)P * (N + 8);
  const size_t pair = (size_t)T * (N + 4) + (size_t)T * (P + 4);
  return 4 * (st + 3 * pair + 11 * (size_t)round4(Q) + WARPS);
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

// The A fragment of rows r and r + 8 of a [.][ld] tile at columns k + t and
// k + t + 4 (`p` at row r, column t), scaled by s0 / s1 and split.
__device__ __forceinline__ void a_frag(const float* p, int ld, int k,
                                       float s0, float s1, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float v[4] = {p[k] * s0, p[8 * ld + k] * s1, p[k + 4] * s0,
                      p[8 * ld + k + 4] * s1};
#pragma unroll
  for (int e = 0; e < 4; ++e) tc::split_int(v[e], ah[e], al[e]);
}

// An accumulator handed on as an A operand (mma.cuh: column t is its
// column 2t, column t + 4 its column 2t + 1).
__device__ __forceinline__ void acc_frag(const float (&s)[4],
                                         uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  tc::split_int(s[0], ah[0], al[0]);
  tc::split_int(s[2], ah[1], al[1]);
  tc::split_int(s[1], ah[2], al[2]);
  tc::split_int(s[3], ah[3], al[3]);
}

// s[q] = A . Bt^T over K columns for this warp's streamed n8 tiles (rows
// 8 (2 q + hf) + gr of `bt`, row stride ldb) that are live; A is rows r and
// r + 8 of `at` (at points at row r, column t; row stride lda).
__device__ __forceinline__ void tile_scores(float (&s)[4][4], const float* at,
                                            int lda, const float* bt, int ldb,
                                            int K, int hf, unsigned live) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q][0] = s[q][1] = s[q][2] = s[q][3] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    a_frag(at, lda, k, 1.f, 1.f, ah, al);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!((live >> q) & 1u)) continue;
      const float* br = bt + (8 * (2 * q + hf) + gr) * ldb + k + t;
      mma3f(s[q], ah, al, br[0], br[4]);
    }
  }
}

// acc[n] += W . X for n < nn (NT n8 tiles at most): W the warp's masked
// scores s (k = the streamed tile's rows 8 (2 q + hf) ..), X that tile's
// [T][ldx] rows.
template <int NT>
__device__ __forceinline__ void tile_product(float (&acc)[NT][4],
                                             const float (&s)[4][4],
                                             const float* x, int ldx, int nn,
                                             int hf, unsigned live) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!((live >> q) & 1u)) continue;
    uint32_t ah[4], al[4];
    acc_frag(s[q], ah, al);
    const float* xr = x + (8 * (2 * q + hf) + 2 * t) * ldx + gr;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nn) mma3f(acc[n], ah, al, xr[8 * n], xr[ldx + 8 * n]);
  }
}

// The two halves of a row group hold partial sums of the same rows: half 1
// hands its accumulators (nn n8 tiles) to half 0 through `red` (free
// shared memory, 4 x 4 nn 32 floats) and half 0 adds them. Every thread
// calls it (one __syncthreads).
template <int NT>
__device__ __forceinline__ void fold_halves(float (&acc)[NT][4], float* red,
                                            int rg, int hf, int nn) {
  red += rg * 4 * nn * 32 + (threadIdx.x & 31);
  if (hf == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (hf == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += red[(4 * n + e) * 32];
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Write rows r0 and r0 + 8 (tile-local, from row `base` of the chunk) of
// an accumulator of nn n8 tiles into out [B, S, H, W].
template <int NT>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[NT][4],
                                           int64_t row0, int H, int W,
                                           int base, int r0, int rows,
                                           int nn) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + 8 * h2;
    if (r >= rows) continue;
    float* o = out + (row0 + (int64_t)(base + r) * H) * W + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nn)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
  }
}

template <int NNT, int NPT>   // n8 tiles of N and P, or 0: N / 8, P / 8
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
ssd_scan_bwd_chunk_kernel(BwdArgs g) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, P = g.P, Q = g.Q, H = g.H, nc = g.nc;
  const int nn = NNT ? NNT : N / 8, np = NPT ? NPT : P / 8;
  const int nt = (Q + T - 1) / T, q4 = round4(Q);
  const int c = blockIdx.x % nc, r = blockIdx.x / nc;
  const int LDN = N + 4, LDP = P + 4, LDG = P + 8, LDH = N + 8;
  const int pair = T * (LDN + LDP);
  float* st = smem;                    // G [N][LDG], then H^T [P][LDH]
  float* res = st + max(N * LDG, P * LDH);   // resident [T][LDN], [T][LDP]
  float* strm = res + pair;            // two buffers of the streamed pair
  float* lc = strm + 2 * pair;         // [q4]
  float* rp = lc + q4;                 // [4][q4] W's row sums, by row group
  float* cp = rp + 4 * q4;             // [2][q4] W's column sums, by half
  float* up = cp + 2 * q4;             // [2][q4] u, by half
  float* vp = up + 2 * q4;             // [2][q4] v, by half
  float* kp = vp + 2 * q4;             // [WARPS] kappa

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3, rg = warp & 3, hf = warp >> 2;
  const int bi = r / H, h = r % H, c0 = c * Q;
  const int64_t row0 = (int64_t)bi * g.S * H + h;
  const int64_t np_ = (int64_t)N * P;
  const bool has_g = c < nc - 1, has_h = c > 0;
  const int rr = rg * 16 + gr;         // this lane's resident rows rr, rr + 8

  for (int k = tid; k < 10 * q4; k += CHUNK_THREADS) rp[k] = 0.f;
  if (has_g) {
    const float* src = g.rst + ((int64_t)r * (nc - 1) + c) * np_;
    const int ch = P / 4;
    for (int i = tid; i < N * ch; i += CHUNK_THREADS) {
      const int n = i / ch, u = (i % ch) * 4;
      tc::cp_async16(st + n * LDG + u, src + (int64_t)n * P + u, src);
    }
  }
  tc::cp_commit();
  if (warp == 0) chunk_lc(g.a, row0, H, c0, Q, lc);
  tc::cp_wait<0>();
  __syncthreads();
  const float gam = lc[Q - 1];
  {  // kappa = e^Gamma <H, G>, this thread's share
    float kap = 0.f;
    if (has_g && has_h) {
      const float* hs = g.fst + ((int64_t)r * (nc - 1) + c - 1) * np_;
      for (int e = tid; e < N * P; e += CHUNK_THREADS)
        kap = fmaf(hs[e], st[(e / P) * LDG + e % P], kap);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) kap += __shfl_xor_sync(FULL, kap, o);
    if (lane == 0) kp[warp] = kap;
  }

  // stream the N-wide and P-wide tiles of positions p0.. of the chunk into
  // buffer buf
  auto stream = [&](const float* nsrc, const float* psrc, int p0, int buf) {
    const int pn = min(T, Q - p0);
    const int64_t pos = row0 + (int64_t)(c0 + p0) * H;
    float* d = strm + buf * pair;
    load_rows(d, LDN, nsrc + pos * N, (int64_t)H * N, pn, N, CHUNK_THREADS);
    load_rows(d + T * LDN, LDP, psrc + pos * P, (int64_t)H * P, pn, P,
              CHUNK_THREADS);
  };

  // ---- sweep A: rows j of dx and dB, W's sums -----------------------------
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * T, jn = min(T, Q - j0);
    const int64_t pj = row0 + (int64_t)(c0 + j0) * H;
    float* bres = res;                 // B_j [T][LDN]
    float* xres = res + T * LDN;       // x_j [T][LDP]
    load_rows(bres, LDN, g.b + pj * N, (int64_t)H * N, jn, N, CHUNK_THREADS);
    load_rows(xres, LDP, g.x + pj * P, (int64_t)H * P, jn, P, CHUNK_THREADS);
    stream(g.c, g.dy, j0, 0);
    tc::cp_commit();

    const bool busy = rg * 16 < jn;
    const float* br = bres + rr * LDN + t;
    const float* xr = xres + rr * LDP + t;
    float dxa[NP8][4], dba[NN8][4], colw[2] = {0.f, 0.f};
    zero(dxa);
    zero(dba);

    for (int it = jt; it < nt; ++it) {
      const int buf = (it - jt) & 1;
      if (it + 1 < nt) stream(g.c, g.dy, (it + 1) * T, buf ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
      __syncthreads();
      if (it == jt && has_g && busy) {
        // inter terms: dx = e^(Gamma - lc_j) B_j G, dB = e^(..) x_j G^T,
        // this half's n8 tiles of P and N; then v_j = B_j . dB
        const float e0 = rr < jn ? expf(gam - lc[j0 + rr]) : 0.f;
        const float e1 = rr + 8 < jn ? expf(gam - lc[j0 + rr + 8]) : 0.f;
#pragma unroll 2
        for (int k = 0; k < N; k += 8) {
          uint32_t ah[4], al[4];
          a_frag(br, LDN, k, e0, e1, ah, al);
          const float* gk = st + (k + t) * LDG + gr;
#pragma unroll
          for (int n = 0; n < NP8; ++n)
            if (n < np && (n & 1) == hf)
              mma3f(dxa[n], ah, al, gk[8 * n], gk[4 * LDG + 8 * n]);
        }
#pragma unroll 2
        for (int k = 0; k < P; k += 8) {
          uint32_t ah[4], al[4];
          a_frag(xr, LDP, k, e0, e1, ah, al);
          const float* gk = st + gr * LDG + k + t;
#pragma unroll
          for (int n = 0; n < NN8; ++n)
            if (n < nn && (n & 1) == hf)
              mma3f(dba[n], ah, al, gk[8 * n * LDG], gk[8 * n * LDG + 4]);
        }
        float v0 = 0.f, v1 = 0.f;
        const float* b0 = bres + rr * LDN + 2 * t;
#pragma unroll
        for (int n = 0; n < NN8; ++n)
          if (n < nn && (n & 1) == hf) {
            v0 += b0[8 * n] * dba[n][0] + b0[8 * n + 1] * dba[n][1];
            v1 += b0[8 * LDN + 8 * n] * dba[n][2] +
                  b0[8 * LDN + 8 * n + 1] * dba[n][3];
          }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          v0 += __shfl_xor_sync(FULL, v0, o);
          v1 += __shfl_xor_sync(FULL, v1, o);
        }
        if (t == 0) {
          if (rr < jn) vp[hf * q4 + j0 + rr] = v0;
          if (rr + 8 < jn) vp[hf * q4 + j0 + rr + 8] = v1;
        }
      }
      const int i0 = it * T, in = min(T, Q - i0);
      // the i n8 tiles holding a pair i >= j of this warp's rows
      unsigned live = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ii = 2 * q + hf;
        live |= (unsigned)(busy && 8 * ii < in && (it > jt || ii >= 2 * rg))
                << q;
      }
      if (live) {
        const float* cs = strm + buf * pair;     // C_i [T][LDN]
        const float* ys = cs + T * LDN;          // dy_i [T][LDP]
        float s1[4][4], s2[4][4];
        tile_scores(s1, br, LDN, cs, LDN, N, hf, live);   // (B C^T)^T
        tile_scores(s2, xr, LDP, ys, LDP, P, hf, live);   // (dy x^T)^T
        const float lj[2] = {rr < jn ? lc[j0 + rr] : 0.f,
                             rr + 8 < jn ? lc[j0 + rr + 8] : 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!((live >> q) & 1u)) continue;
          float wc[2] = {0.f, 0.f};      // this lane's columns' W
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gj = j0 + rr + 8 * (e >> 1);
            const int gi = i0 + 8 * (2 * q + hf) + 2 * t + (e & 1);
            const bool ok = gi >= gj && gi < Q && gj < Q;
            const float L = ok ? expf(fminf(lc[gi] - lj[e >> 1], 0.f)) : 0.f;
            const float w = gi > gj ? s1[q][e] * s2[q][e] * L : 0.f;
            colw[e >> 1] += w;
            wc[e & 1] += w;
            s1[q][e] *= L;
            s2[q][e] *= L;
          }
          // W's row sums (columns here): over this warp's rows, into the
          // row group's partials (only this warp writes these entries)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = wc[e];
            v += __shfl_xor_sync(FULL, v, 4);
            v += __shfl_xor_sync(FULL, v, 8);
            v += __shfl_xor_sync(FULL, v, 16);
            const int gi = i0 + 8 * (2 * q + hf) + 2 * t + e;
            if (gr == 0 && gi < Q) rp[rg * q4 + gi] += v;
          }
        }
        tile_product<NP8>(dxa, s1, ys, LDP, np, hf, live);   // M1^T dy
        tile_product<NN8>(dba, s2, cs, LDN, nn, hf, live);   // M2^T C
      }
      __syncthreads();                 // this buffer is free for it + 2
    }
    // W's column sums: this lane's rows, over the quad
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      colw[e] += __shfl_xor_sync(FULL, colw[e], 1);
      colw[e] += __shfl_xor_sync(FULL, colw[e], 2);
      if (t == 0 && rr + 8 * e < jn) cp[hf * q4 + j0 + rr + 8 * e] = colw[e];
    }
    fold_halves(dxa, strm, rg, hf, np);
    __syncthreads();
    fold_halves(dba, strm, rg, hf, nn);
    if (hf == 0 && busy) {
      store_rows<NP8>(g.dx, dxa, row0, H, P, c0 + j0, rr, jn, np);
      store_rows<NN8>(g.db, dba, row0, H, N, c0 + j0, rr, jn, nn);
    }
    __syncthreads();                   // res and strm are free
  }

  // ---- sweep B: rows i of dC -----------------------------------------------
  if (has_h) {                         // H^T [P][LDH]
    const float* hs = g.fst + ((int64_t)r * (nc - 1) + c - 1) * np_;
    for (int e = tid; e < N * P; e += CHUNK_THREADS)
      st[(e % P) * LDH + e / P] = hs[e];
  }
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * T, in = min(T, Q - i0);
    const int64_t pi = row0 + (int64_t)(c0 + i0) * H;
    float* cres = res;                 // C_i [T][LDN]
    float* yres = res + T * LDN;       // dy_i [T][LDP]
    load_rows(cres, LDN, g.c + pi * N, (int64_t)H * N, in, N, CHUNK_THREADS);
    load_rows(yres, LDP, g.dy + pi * P, (int64_t)H * P, in, P, CHUNK_THREADS);
    stream(g.b, g.x, 0, 0);
    tc::cp_commit();

    const bool busy = rg * 16 < in;
    const float* yr = yres + rr * LDP + t;
    float dca[NN8][4];
    zero(dca);
    const float li[2] = {rr < in ? lc[i0 + rr] : 0.f,
                         rr + 8 < in ? lc[i0 + rr + 8] : 0.f};

    for (int jt = 0; jt <= it; ++jt) {
      const int buf = jt & 1;
      if (jt + 1 <= it) stream(g.b, g.x, (jt + 1) * T, buf ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
      __syncthreads();
      if (jt == 0 && has_h && busy) {
        // inter term: dC = e^lc_i dy_i H^T, this half's n8 tiles of N;
        // then u_i = C_i . dC
        const float e0 = rr < in ? expf(li[0]) : 0.f;
        const float e1 = rr + 8 < in ? expf(li[1]) : 0.f;
#pragma unroll 2
        for (int k = 0; k < P; k += 8) {
          uint32_t ah[4], al[4];
          a_frag(yr, LDP, k, e0, e1, ah, al);
          const float* hk = st + (k + t) * LDH + gr;
#pragma unroll
          for (int n = 0; n < NN8; ++n)
            if (n < nn && (n & 1) == hf)
              mma3f(dca[n], ah, al, hk[8 * n], hk[4 * LDH + 8 * n]);
        }
        float u0 = 0.f, u1 = 0.f;
        const float* c0p = cres + rr * LDN + 2 * t;
#pragma unroll
        for (int n = 0; n < NN8; ++n)
          if (n < nn && (n & 1) == hf) {
            u0 += c0p[8 * n] * dca[n][0] + c0p[8 * n + 1] * dca[n][1];
            u1 += c0p[8 * LDN + 8 * n] * dca[n][2] +
                  c0p[8 * LDN + 8 * n + 1] * dca[n][3];
          }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          u0 += __shfl_xor_sync(FULL, u0, o);
          u1 += __shfl_xor_sync(FULL, u1, o);
        }
        if (t == 0) {
          if (rr < in) up[hf * q4 + i0 + rr] = u0;
          if (rr + 8 < in) up[hf * q4 + i0 + rr + 8] = u1;
        }
      }
      const int j0 = jt * T, jn = min(T, Q - j0);
      // the j n8 tiles holding a pair j <= i of this warp's rows
      unsigned live = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jj = 2 * q + hf;
        live |= (unsigned)(busy && 8 * jj < jn &&
                           (jt < it || jj <= 2 * rg + 1)) << q;
      }
      if (live) {
        const float* bs = strm + buf * pair;     // B_j [T][LDN]
        const float* xs = bs + T * LDN;          // x_j [T][LDP]
        float s2[4][4];
        tile_scores(s2, yr, LDP, xs, LDP, P, hf, live);   // dy x^T
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!((live >> q) & 1u)) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gi = i0 + rr + 8 * (e >> 1);
            const int gj = j0 + 8 * (2 * q + hf) + 2 * t + (e & 1);
            const bool ok = gj <= gi && gi < Q && gj < Q;
            s2[q][e] = ok ? s2[q][e] * expf(fminf(li[e >> 1] - lc[gj], 0.f))
                          : 0.f;
          }
        }
        tile_product<NN8>(dca, s2, bs, LDN, nn, hf, live);   // M2 B
      }
      __syncthreads();                 // this buffer is free for jt + 2
    }
    fold_halves(dca, strm, rg, hf, nn);
    if (hf == 0 && busy)
      store_rows<NN8>(g.dc, dca, row0, H, N, c0 + i0, rr, in, nn);
    __syncthreads();                   // res and strm are free
  }

  // ---- da: the four parts ------------------------------------------------
  for (int k = tid; k < Q; k += CHUNK_THREADS) {
    const float rows = rp[k] + rp[q4 + k] + rp[2 * q4 + k] + rp[3 * q4 + k];
    cp[k] = cp[k] + cp[q4 + k] - rows;
    up[k] += up[q4 + k];
    vp[k] += vp[q4 + k];
  }
  __syncthreads();
  if (warp == 0) warp_scan(cp, Q, false, true);   // the intra term
  if (warp == 1) warp_scan(up, Q, true, false);   // suffix sums of u
  if (warp == 2) warp_scan(vp, Q, false, true);   // exclusive prefix of v
  __syncthreads();
  float kap = 0.f;
  for (int w = 0; w < WARPS; ++w) kap += kp[w];
  kap *= expf(gam);
  for (int k = tid; k < Q; k += CHUNK_THREADS)
    g.da[row0 + (int64_t)(c0 + k) * H] = cp[k] + up[k] + vp[k] + kap;
}

}  // namespace

extern "C" {

// x, dy [B, S, H, P]; a [B, S, H]; b, c [B, S, H, N]; fst the forward's
// states entering chunks 1.. [B H, S / Q - 1, N, P]; rst and rgam scratch
// [B H, S / Q - 1, N, P] and [B H, S / Q - 1] (all three unused, and may be
// NULL, when S == Q); outputs dx, da, db, dc in the inputs' layouts; all
// f32, contiguous. Returns a cudaError_t (0 = launched).
int ssd_scan_backward(const void* x, const void* a, const void* b,
                      const void* c, const void* dy, const void* fst,
                      void* rst, void* rgam, void* dx, void* da, void* db,
                      void* dc, int B, int S, int H, int P, int N, int Q,
                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > QMAX || S % Q != 0 || P % 8 != 0 || P > 8 * NP8 || N % 8 != 0 ||
      N > 8 * NN8)
    return (int)cudaErrorInvalidValue;
  const int nc = S / Q, nb = (N + NB - 1) / NB;
  const int64_t rows = (int64_t)B * H;
  if (rows * nc * nb > 0x7fffffff ||
      (nc > 1 && (fst == nullptr || rst == nullptr || rgam == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t ssm = state_smem(N, P, Q), bsm = bwd_smem(N, P, Q);
  if (ssm > MAX_SMEM || bsm > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const bool p64 = P == 64;
  void (*rstate)(Args) =
      p64 ? ssd_scan_state_kernel<8, true> : ssd_scan_state_kernel<0, true>;
  void (*chunk)(BwdArgs) =
      p64 && N == 128 ? ssd_scan_bwd_chunk_kernel<16, 8>
      : p64 && N == 64 ? ssd_scan_bwd_chunk_kernel<8, 8>
                       : ssd_scan_bwd_chunk_kernel<0, 0>;
  int e = set_smem((const void*)rstate, ssm);
  if (e == 0) e = set_smem((const void*)chunk, bsm);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc > 1) {
    const unsigned sgrid = (unsigned)(rows * (nc - 1) * nb);
    const dim3 pgrid((unsigned)rows,
                     (N * P + PASS_THREADS - 1) / PASS_THREADS);
    // R_c = (C .* e^lc)^T dy of chunks 1.., then G_c from the last down
    Args rv{static_cast<const float*>(dy), static_cast<const float*>(a),
            static_cast<const float*>(c), nullptr, nullptr,
            static_cast<float*>(rst), static_cast<float*>(rgam), S, H, P, N,
            Q, nc};
    rstate<<<sgrid, STATE_THREADS, ssm, s>>>(rv);
    if ((e = (int)cudaGetLastError()) != 0) return e;
    ssd_scan_pass_kernel<true><<<pgrid, PASS_THREADS, 0, s>>>(
        rv.st, rv.gam, nc - 1, N * P);
    if ((e = (int)cudaGetLastError()) != 0) return e;
  }
  BwdArgs g{static_cast<const float*>(x), static_cast<const float*>(a),
            static_cast<const float*>(b), static_cast<const float*>(c),
            static_cast<const float*>(dy), static_cast<const float*>(fst),
            static_cast<const float*>(rst), static_cast<float*>(dx),
            static_cast<float*>(da), static_cast<float*>(db),
            static_cast<float*>(dc), S, H, P, N, Q, nc};
  chunk<<<(unsigned)(rows * nc), CHUNK_THREADS, bsm, s>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
