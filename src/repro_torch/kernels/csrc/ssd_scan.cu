// Mamba2 SSD chunked scan for Hopper (sm_90a), chunk-parallel on the
// tensor cores.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan_state_kernel, ssd_scan_pass_kernel, ssd_scan_chunk_kernel
//   <- ssd_scan_bhsp (body _kernel)
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
// inputs and the output move 605 MB (0.181 ms at 3.35 TB/s); the visible
// work is 32.3 GFLOP (causal scores, scores times x, the inter-chunk term
// and the state update), which three TF32 passes on the tensor cores run
// in 0.196 ms (495 TFLOP/s, H100 SXM data sheet). Operations and bytes
// bound it alike; what this design reads besides (B and x twice, the chunk
// states four times) puts its own traffic near 1.3 GB.
//
// What the design does about it. The TPU walks the chunks as a sequential
// grid axis with the state in VMEM; here the recurrence is taken apart, as
// the plain version computes it, and only its elementwise middle is
// sequential:
//   1. ssd_scan_state_kernel, one CTA (8 warps) per (row, chunk, 128 state
//      rows): lc by a warp scan, then the chunk's own state
//      s_c = (B .* exp(lc_last - lc))^T x, [N, P] over the chunk's Q
//      positions in 64-position tiles, and gamma_c = exp(lc_last). Each
//      warp owns an m16 tile of state rows. The last chunk's state is never
//      read, so it is not computed.
//   2. ssd_scan_pass_kernel, one thread per (row, state entry): walks the
//      chunks in order, t = gamma_c t + s_c, and overwrites s_c with t: the
//      state entering chunk c + 1.
//   3. ssd_scan_chunk_kernel, one CTA (8 warps) per (row, chunk, 64-row
//      tile of Q), heaviest tile of a chunk first and the tiles of a chunk
//      adjacent in the grid so they share B and x in L2. Four row groups of
//      16 rows, two warps each: a warp takes every other key n8 tile (and
//      every other n8 tile of P for the inter term), so the diagonal tile's
//      visible keys fall to both alike, and the pair's sums meet in shared
//      memory at the end. A warp adds (C .* exp(lc)) t_in, then walks the
//      key tiles j <= i: scores C_i B_j^T, decayed and masked in
//      registers, handed to the product with x_j by the k-index
//      permutation of mma.cuh. Key n8 tiles wholly above the diagonal are
//      skipped; full key tiles run a branch-free instantiation.
// At the forward's shape that is 1440 + 3072 + 6144 CTAs, against 192
// before. Every product runs on mma.sync m16n8k8 TF32 in three passes
// (lo.hi + hi.lo + hi.hi), f32 accuracy, split by tc::split_int (hi
// rounded by integer arithmetic, lo truncated by the tensor cores). The x tile, which every warp reads as its B operand, is
// split into hi / lo planes once in shared memory. Tiles arrive by 16-byte
// cp.async into rows padded so each fragment load of a warp hits 32
// distinct banks.
//
// Shapes: P % 8 == 0 and P <= 64 (a warp holds all of P), N % 8 == 0, any
// Q that divides S, and the chunk kernel's shared memory (chunk_smem) at
// most 227 KB: 101 KB at N 128, P 64, Q 256 (two CTAs an SM; the state
// kernel 71 KB, three). P = 64 runs instantiations with P's tile count
// fixed. With one group every head reads the same B and C (the wrapper
// repeats them, as the JAX one does); reading them once per group is left
// for later.
//
// The state and pass kernels, the loads and the split live in
// ssd_common.cuh, which the backward (ssd_scan_bwd.cu) shares.
//
// Interface: plain C, loaded with ctypes. The entry launches the three
// kernels on one stream and returns cudaGetLastError() after each launch;
// the Python wrapper raises on non-0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

// C tile [T][N + 4]; then t_in [N][P + 8], later the B tile [T][N + 4] and
// the x tile's hi and lo planes [T][P + 4] each; lc [Q]
size_t chunk_smem(int N, int P, int Q) {
  const size_t tin = (size_t)N * (P + 8);
  const size_t tiles = (size_t)T * (N + 4) + 2 * (size_t)T * (P + 4);
  return 4 * ((size_t)T * (N + 4) + (tin > tiles ? tin : tiles) + round4(Q));
}

// Where a chunk-kernel warp works: 16 rows of the tile (row group rg) and
// half `hf` of the key n8 tiles (2 q + hf) and of P's n8 tiles for the
// inter-chunk term (2 q + hf), so that the diagonal's visible key tiles
// fall to both halves alike.
struct Lane {
  int rg, hf, gr, t, ia, ib;   // ia, ib: this lane's two rows in the chunk
};

// One key tile for a warp: scores of its rows against its key n8 tiles
// (JM: all 8 of the tile are visible, or 0 for the first `jmax`), decayed
// and masked in registers, then their product with x_j added to y.
template <int NPT, int JM>
__device__ __forceinline__ void key_tile(float (&y)[NP8][4], const Lane& L,
                                         const float* cs, const float* bs,
                                         const float* xh, const float* xl,
                                         const float* lc, int N, int LDC,
                                         int LDX, int np8, int jmax, int Q,
                                         int j0) {
  const int jm = JM ? JM : jmax;
  float s[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q][0] = s[q][1] = s[q][2] = s[q][3] = 0.f;
  const float* cr = cs + (L.rg * 16 + L.gr) * LDC + L.t;
  const float* br = bs + L.gr * LDC + L.t;
  // not unrolled: at the 128-register cap of two CTAs an SM, unrolling it
  // spills
#pragma unroll 1
  for (int k = 0; k < N; k += 8) {
    const float v[4] = {cr[k], cr[8 * LDC + k], cr[k + 4],
                        cr[8 * LDC + k + 4]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split_int(v[e], ah[e], al[e]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 2 * q + L.hf;
      if (j < jm) mma3f(s[q], ah, al, br[8 * j * LDC + k], br[8 * j * LDC + k + 4]);
    }
  }
  // decay (clamped) and causal mask, in registers
  const float la = L.ia < Q ? lc[L.ia] : 0.f, lb = L.ib < Q ? lc[L.ib] : 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 2 * q + L.hf;
    if (j >= jm) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? L.ia : L.ib;
      const int jj = j0 + 8 * j + 2 * L.t + (e & 1);
      const float li = e < 2 ? la : lb;
      s[q][e] = jj <= i && i < Q ? s[q][e] * expf(fminf(li - lc[jj], 0.f))
                                 : 0.f;
    }
  }
  // y += M x_j: A column t is key 2t, column t + 4 key 2t + 1
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 2 * q + L.hf;
    if (j >= jm) continue;
    uint32_t ah[4], al[4];
    tc::split_int(s[q][0], ah[0], al[0]);
    tc::split_int(s[q][2], ah[1], al[1]);
    tc::split_int(s[q][1], ah[2], al[2]);
    tc::split_int(s[q][3], ah[3], al[3]);
    const int o = (8 * j + 2 * L.t) * LDX + L.gr;
#pragma unroll
    for (int n = 0; n < NP8; ++n)
      if (n < np8)
        tc::mma3(y[n], ah, al, bits(xh[o + 8 * n]), bits(xh[o + LDX + 8 * n]),
                 bits(xl[o + 8 * n]), bits(xl[o + LDX + 8 * n]));
  }
}

template <int NPT>
__global__ void __launch_bounds__(CHUNK_THREADS, 2)
ssd_scan_chunk_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N, P = g.P, Q = g.Q, H = g.H, nc = g.nc;
  const int nt = (Q + T - 1) / T;
  const int it = nt - 1 - blockIdx.x % nt, rc = blockIdx.x / nt;
  const int c = rc % nc, r = rc / nc;
  const int LDC = N + 4, LDT = P + 8, LDX = P + 4;
  float* cs = smem;                  // [T][LDC]  C tile, rows i
  float* ts = cs + T * LDC;          // [N][LDT]  t_in ...
  float* bs = ts;                    // [T][LDC]  ... then B tile, keys j,
  float* xh = bs + T * LDC;          // [T][LDX]  x tile, TF32 hi bits
  float* xl = xh + T * LDX;          // [T][LDX]  ... and lo bits
  float* lc = ts + max(N * LDT, T * LDC + 2 * T * LDX);   // [Q]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = r / H, h = r % H, c0 = c * Q, i0 = it * T;
  const int in = min(T, Q - i0);     // rows of this tile
  const int64_t row0 = (int64_t)bi * g.S * H + h;
  const int64_t pos_i = row0 + (int64_t)(c0 + i0) * H;
  Lane L;
  L.rg = warp & 3;
  L.hf = warp >> 2;
  L.gr = lane >> 2;
  L.t = lane & 3;
  L.ia = i0 + L.rg * 16 + L.gr;
  L.ib = L.ia + 8;

  load_rows(cs, LDC, g.c + pos_i * N, (int64_t)H * N, in, N, CHUNK_THREADS);
  if (c > 0) {                       // the state entering this chunk
    const float* tin = g.st + ((int64_t)r * (nc - 1) + c - 1) * N * P;
    const int ch = P / 4;
    for (int i = tid; i < N * ch; i += CHUNK_THREADS) {
      const int n = i / ch, u = (i % ch) * 4;
      tc::cp_async16(ts + n * LDT + u, tin + (int64_t)n * P + u, tin);
    }
  }
  tc::cp_commit();
  if (warp == 0) chunk_lc(g.a, row0, H, c0, Q, lc);
  tc::cp_wait<0>();
  __syncthreads();

  const int np8 = NPT ? NPT : P / 8;
  const bool busy = L.rg * 16 < in;
  float y[NP8][4];
#pragma unroll
  for (int n = 0; n < NP8; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;

  // inter-chunk term: (C_i exp(lc_i)) . t_in, this half's n8 tiles of P
  if (c > 0 && busy) {
    const float ea = L.ia < Q ? expf(lc[L.ia]) : 0.f;
    const float eb = L.ib < Q ? expf(lc[L.ib]) : 0.f;
    const float* cr = cs + (L.rg * 16 + L.gr) * LDC + L.t;
#pragma unroll 2
    for (int k = 0; k < N; k += 8) {
      const float v[4] = {cr[k] * ea, cr[8 * LDC + k] * eb, cr[k + 4] * ea,
                          cr[8 * LDC + k + 4] * eb};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::split_int(v[e], ah[e], al[e]);
      const float* tr = ts + (k + L.t) * LDT + L.gr;
      // n runs at compile time (y stays in registers); the half at run time
#pragma unroll
      for (int n = 0; n < NP8; ++n)
        if ((n & 1) == L.hf && n < np8)
          mma3f(y[n], ah, al, tr[8 * n], tr[4 * LDT + 8 * n]);
    }
  }
  __syncthreads();                   // t_in's room becomes the B / x tiles

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * T, jn = min(T, Q - j0);
    const int64_t pos_j = row0 + (int64_t)(c0 + j0) * H;
    load_rows(bs, LDC, g.b + pos_j * N, (int64_t)H * N, jn, N, CHUNK_THREADS);
    load_rows(xl, LDX, g.x + pos_j * P, (int64_t)H * P, jn, P,
              CHUNK_THREADS);
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
    split_tile(xh, xl, LDX, P, CHUNK_THREADS);
    __syncthreads();
    if (busy) {
      // key n8 tiles the tile's rows can see: on the diagonal tile keys
      // past the row group's last row are skipped
      int jmax = min(8, (jn + 7) / 8);
      if (jt == it) jmax = min(jmax, 2 * L.rg + 2);
      if (jmax == 8)
        key_tile<NPT, 8>(y, L, cs, bs, xh, xl, lc, N, LDC, LDX, np8, 8, Q,
                         j0);
      else
        key_tile<NPT, 0>(y, L, cs, bs, xh, xl, lc, N, LDC, LDX, np8, jmax, Q,
                         j0);
    }
    __syncthreads();
  }

  // the two halves' sums: the second half hands its y over shared memory
  float* ys = ts;                    // [T][P]
  const int ra = L.rg * 16 + L.gr, rb = ra + 8;
  if (L.hf == 1 && busy) {
#pragma unroll
    for (int n = 0; n < NP8; ++n) {
      if (n >= np8) continue;
      const int p = 8 * n + 2 * L.t;
      *reinterpret_cast<float2*>(ys + ra * P + p) = make_float2(y[n][0], y[n][1]);
      *reinterpret_cast<float2*>(ys + rb * P + p) = make_float2(y[n][2], y[n][3]);
    }
  }
  __syncthreads();
  if (L.hf == 1 || !busy) return;
#pragma unroll
  for (int n = 0; n < NP8; ++n) {
    if (n >= np8) continue;
    const int p = 8 * n + 2 * L.t;
    const float2 ua = *reinterpret_cast<const float2*>(ys + ra * P + p);
    const float2 ub = *reinterpret_cast<const float2*>(ys + rb * P + p);
    if (ra < in)
      *reinterpret_cast<float2*>(g.y + (row0 + (int64_t)(c0 + L.ia) * H) * P +
                                 p) = make_float2(y[n][0] + ua.x,
                                                  y[n][1] + ua.y);
    if (rb < in)
      *reinterpret_cast<float2*>(g.y + (row0 + (int64_t)(c0 + L.ib) * H) * P +
                                 p) = make_float2(y[n][2] + ub.x,
                                                  y[n][3] + ub.y);
  }
}

}  // namespace

extern "C" {

// st [B H, S / Q - 1, N, P] and gam [B H, S / Q - 1] are f32 scratch the
// caller allocates (unused, and may be NULL, when S == Q). The wrapper
// refuses the shapes this rejects before it launches. Returns a
// cudaError_t (0 = launched).
int ssd_scan_forward(const void* x, const void* a, const void* b,
                     const void* c, void* y, void* st, void* gam, int B,
                     int S, int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      S % Q != 0 || P % 8 != 0 || P > 8 * NP8 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = S / Q, nt = (Q + T - 1) / T, nb = (N + NB - 1) / NB;
  const int64_t rows = (int64_t)B * H;
  if (rows * nc * nt > 0x7fffffff || rows * nc * nb > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t ssm = state_smem(N, P, Q), csm = chunk_smem(N, P, Q);
  if (ssm > MAX_SMEM || csm > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // P = 64 (mamba2's head dim) runs with its n8 tiles fixed at compile time
  const bool p64 = P == 64;
  void (*state)(Args) =
      p64 ? ssd_scan_state_kernel<8, false> : ssd_scan_state_kernel<0, false>;
  void (*chunk)(Args) =
      p64 ? ssd_scan_chunk_kernel<8> : ssd_scan_chunk_kernel<0>;
  int e = set_smem((const void*)state, ssm);
  if (e == 0) e = set_smem((const void*)chunk, csm);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args g{static_cast<const float*>(x), static_cast<const float*>(a),
         static_cast<const float*>(b), static_cast<const float*>(c),
         static_cast<float*>(y), static_cast<float*>(st),
         static_cast<float*>(gam), S, H, P, N, Q, nc};
  if (nc > 1) {
    state<<<(unsigned)(rows * (nc - 1) * nb), STATE_THREADS, ssm, s>>>(g);
    if ((e = (int)cudaGetLastError()) != 0) return e;
    const dim3 grid((unsigned)rows, (N * P + PASS_THREADS - 1) / PASS_THREADS);
    ssd_scan_pass_kernel<false><<<grid, PASS_THREADS, 0, s>>>(
        g.st, g.gam, nc - 1, N * P);
    if ((e = (int)cudaGetLastError()) != 0) return e;
  }
  chunk<<<(unsigned)(rows * nc * nt), CHUNK_THREADS, csm, s>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
