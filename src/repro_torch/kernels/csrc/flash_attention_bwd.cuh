// Backward pass of blocked causal / windowed GQA attention (flash attention)
// for Hopper (sm_90a), f32 and bf16, on the tensor cores.
//
// Replaces no TPU kernel: the Pallas kernel of
// src/repro/kernels/flash_attention.py (flash_attention_bhsd) has no
// backward, and the JAX package trains through its plain attention instead
// (use_pallas=False). The port routes by device, so training on the card
// reaches flash_attention_forward; this is the backward of that function,
// behind a torch.autograd.Function in kernels/ops.py.
//
// What it computes. With q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (read in
// place through their (batch, seq, head) strides, unit stride along D), the
// forward's output o and its gradient do ([B, Sq, Hq, D], contiguous), the
// forward's row log-sum-exp L ([B Hq, Sq], f32), the visibility of the
// forward (query i sits at position i + off, off the query offset, 0 and
// Sq == Sk for self-attention; key j < Sk is seen by query i < Sq when (not
// causal or j <= i + off) and (window == 0 or i + off - j < window)),
// s_ij = q_i.k_j / sqrt(D) and P_ij = exp(s_ij - L_i) over the visible
// keys, it writes
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_{i, h in group} dS_ij q_i,
//   dv_j = sum_{i, h in group} P_ij do_i,  dS_ij = P_ij (do_i.v_j - D_i),
//   D_i = do_i.o_i
// ([B, Sq, Hq, D] and [B, Sk, Hkv, D], contiguous, in the inputs' dtype;
// every sum, P, dS and D_i in f32; a key no query sees gets dk = dv = 0).
// With an offset (a rank's block of query rows under q-seq sharding) the
// rank's dk and dv are its rows' part of the keys' gradients, which the
// caller sums over the ranks. L comes from the forward
// (flash_attention.cu's lse output): a row that sees no key has L = 1e30
// there and every P of it is masked to 0 here, so it gets no gradient, as
// the forward gives it output 0.
//
// The FlashAttention-2 split, two launches, no atomics (deterministic):
//   1. flash_bwd_dq_kernel, one CTA per (b * Hq + h, BR-row query tile):
//      D_i of its rows (written for the second launch), then the walk over
//      the key tiles the tile sees: S = Q K^T, dP = dO V^T, dS, dQ += dS K.
//   2. flash_bwd_dkdv_kernel, one CTA per (b * Hkv + hk, BR-key tile): the
//      walk over the G q heads of its kv head and the 64-row query tiles
//      that see the tile: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T, then
//      dV += P^T dO and dK += dS^T Q.
// A CTA has 8 warps in 16-row groups of its own rows, the warps of a group
// each taking an equal share of every streamed 64-row tile (the forward's
// key quarters); the shares' partial sums meet through shared memory at
// the end, in a fixed order. Four groups of two warps (BR 64: a warp's
// fragment loads feed four n8 tiles of the streamed tile) where their
// fragments fit beside the tiles (D <= 96) and the grid still fills the
// card four times over; else two groups of four, as the forward (BR 32),
// twice the CTAs. The staged fragments are read again for every streamed
// tile, so the loads a product takes from shared memory set the pace as
// much as the tensor cores do (tools/time_backward_kernels.py times the two
// shapes against each other). Computing the scores of the dk/dv kernel
// transposed (keys as rows) makes every product's A
// operand either a tile staged once in fragment order (Q and dO, or K and
// V) or an accumulator handed on in registers (P, dS, P^T, dS^T), and
// every B operand a row-major tile: nothing is transposed through shared
// memory by hand.
//
// Products (mma.cuh). f32 inputs: mma.sync m16n8k8 TF32 in three passes
// (lo.hi + hi.lo + hi.hi): seven 16 x 8 x 8 product streams a visible pair
// (S and dP in both kernels, dQ, dV, dK). The staged fragments are split
// once (tc::split); every operand split in the loops (the streamed tiles'
// B fragments, the accumulators handed on) takes tc::split_int, hi rounded
// by integer arithmetic and lo truncated by the tensor cores, since the
// conversion instruction issues at a fraction of the integer rate; an
// accumulator handed on keeps its registers through mma.cuh's k
// permutation. bf16 inputs: mma.sync m16n8k16 bf16 with f32 accumulation,
// one pass. The score products read their B fragments as 32-bit pairs of a
// streamed row, as the forward's S = Q K^T does; P, dS, P^T and dS^T are
// rounded to bf16 where they enter a product (the accumulator pairs of two
// n8 tiles are the A pairs of one k16 step, as the forward hands P to
// P.V), and the B fragments of dQ += dS K, dV += P^T dO and dK += dS^T Q
// come from ldmatrix.trans over the streamed rows (the forward's V). The
// softmax is recomputed in f32 from the f32 L. Streamed tiles arrive by
// 16-byte cp.async into two buffers, the next tile loading while this one
// computes (plain loads into the same buffers where a row is not 16-byte
// aligned), in rows of D + 4 floats or D + 8 bf16, so each fragment load
// of a warp hits 32 distinct banks.
//
// What bounds it on this card. At phi-3-vision-4.2b's training shape
// ([2, 1024, 32, 96], causal) the five products over the visible pairs are
// ~32 GFLOP: three TF32 passes of them on the tensor cores take 0.195 ms at
// 495 TFLOP/s, one bf16 pass 0.033 ms at 989 TFLOP/s (H100 SXM data sheet);
// q, k, v, o, do, dq, dk and dv move ~200 MB in f32 (0.06 ms at 3.35 TB/s)
// and ~100 MB in bf16 (0.03 ms): both are bound by operations, bf16 only
// just.
//
// Shared memory: the staged fragments of the groups (f32: hi and lo, two
// operands: 4 x 12 KB a group pair at D 96, 4 x 16 KB at D 128; bf16: 3 KB
// a group and operand at D 96) and two buffers of two streamed [64][LD]
// tiles (f32: 100 KB at D 96, 132 KB at D 128; bf16: 52 KB and 68 KB),
// plus 1 KB of row vectors: f32 197 KB at D 96 and 128, 133 KB at D 64,
// within the 227 KB a block may take, one CTA an SM; bf16 78 KB at D 96.
// Head dims 32, 64, 96 and 128.
//
// Interface: plain C, loaded with ctypes (flash_attention_bwd.cu, which
// also instantiates the f32 kernels; flash_attention_bwd_bf16.cu the bf16
// ones, each source one nvcc of the parallel build). dsum is [B Hq, S] f32
// scratch the caller allocates. The entry returns cudaGetLastError() after
// each launch; the Python wrapper raises on non-0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace flash_bwd {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // [B, Sq, Hq, D], contiguous
  const void* dout;    // [B, Sq, Hq, D], contiguous
  const float* lse;    // [B Hq, Sq], the forward's
  void* dq;            // [B, Sq, Hq, D]
  void* dk;            // [B, Sk, Hkv, D]
  void* dv;
  float* dsum;         // [B Hq, Sq]: D_i, written by the dq kernel
  int Sq, Sk, off;     // query rows, keys, the queries' first position
  int Hq, Hkv, G;
  long long qb, qs, qh;
  long long kb, ks, kh;
  long long vb, vs, vh;
  int causal, window;
  int async;           // every q, k, v row 16-byte aligned: cp.async
  float scale;
};

// The bf16 instantiation, compiled in flash_attention_bwd_bf16.cu so the
// two dtypes' kernels build in parallel.
int launch_bf16(const Args& a, int B, int D, int groups, cudaStream_t s);

}  // namespace flash_bwd

namespace {

using flash_bwd::Args;

using attn::BK;                        // rows of a streamed tile
using tc::is_f32;
using tc::to_f32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NO_ROW = 1e30f;        // L of a row past Sq: P = 0
constexpr unsigned FULL = 0xffffffffu;

// A CTA's shape: GROUPS 16-row groups of its own rows, SPLIT warps a
// group, each taking 1 / SPLIT of every streamed tile (NJ n8 tiles): 4 x 2
// (each fragment load feeds four n8 tiles; its fragments fit beside the
// tiles at D <= 96) or 2 x 4 (twice the CTAs, as the forward).
template <int GROUPS_>
struct Shape {
  static constexpr int GROUPS = GROUPS_;
  static constexpr int SPLIT = WARPS / GROUPS;
  static constexpr int BR = GROUPS * 16;       // a CTA's own rows
  static constexpr int NJ = BK / 8 / SPLIT;    // even: bf16 k16 steps
};

template <typename T, int D>
__host__ __device__ constexpr int qf_u4() {
  return attn::qfrag_u4<T, D>();
}
template <typename T, int D>
__host__ __device__ constexpr int ld() { return attn::ld_kv<T, D>(); }

// Staged fragments of both row operands of every group, two buffers of two
// streamed tiles, and two buffers of two BK-long row vectors (the dk/dv
// kernel's L and D of the streamed queries; the dq kernel uses BR of them).
template <typename T, int D, int GROUPS>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)2 * GROUPS * qf_u4<T, D>() * 16 +
         (size_t)2 * 2 * BK * ld<T, D>() * sizeof(T) +
         (size_t)2 * 2 * BK * sizeof(float);
}

__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// c += a . b in three TF32 passes, b given as f32 and split here
__device__ __forceinline__ void mma3i(float (&c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0,
                                      float b1) {
  uint32_t h0, l0, h1, l1;
  tc::split_int(b0, h0, l0);
  tc::split_int(b1, h1, l1);
  tc::mma3(c, ah, al, h0, h1, l0, l1);
}

// query row i (at position i + off) sees key j
__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return i < a.Sq && j < a.Sk && (!a.causal || j <= i + a.off) &&
         (a.window == 0 || i + a.off - j < a.window);
}

// c[j] += A . B_j^T over D for this warp's NJ n8 tiles of a streamed tile
// (rows 8 (jb + j) + g of `tile`), both products at once: (s, A = f1) and
// (s2, A = f2) against tiles t1 and t2. Only tiles with bit j of `live`.
template <typename T, int D, int NJ>
__device__ __forceinline__ void scores(float (&s)[NJ][4], float (&s2)[NJ][4],
                                       const uint4* f1, const uint4* f2,
                                       const T* t1, const T* t2, int jb,
                                       unsigned live) {
  constexpr int LD = ld<T, D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
  if constexpr (is_f32<T>()) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint4 h1 = f1[kk * 32 + lane], l1 = f1[(D / 8 + kk) * 32 + lane];
      const uint4 h2 = f2[kk * 32 + lane], l2 = f2[(D / 8 + kk) * 32 + lane];
      const uint32_t ah[4] = {h1.x, h1.y, h1.z, h1.w};
      const uint32_t al[4] = {l1.x, l1.y, l1.z, l1.w};
      const uint32_t bh[4] = {h2.x, h2.y, h2.z, h2.w};
      const uint32_t bl[4] = {l2.x, l2.y, l2.z, l2.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (!((live >> j) & 1u)) continue;
        const int o = (8 * (jb + j) + g) * LD + 8 * kk + t;
        mma3i(s[j], ah, al, t1[o], t1[o + 4]);
        mma3i(s2[j], bh, bl, t2[o], t2[o + 4]);
      }
    }
  } else {
    // B pairs (2t.., g) and (2t+8.., g) of a k16 step: row g of the tile
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint4 a1 = f1[kk * 32 + lane], a2 = f2[kk * 32 + lane];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (!((live >> j) & 1u)) continue;
        const int o = (8 * (jb + j) + g) * LD + 16 * kk + 2 * t;
        tc::mma_bf16(s[j], a1, pair_at(t1 + o), pair_at(t1 + o + 8));
        tc::mma_bf16(s2[j], a2, pair_at(t2 + o), pair_at(t2 + o + 8));
      }
    }
  }
}

// acc[n] += W . X over this warp's keys of a streamed tile: W the
// accumulator w (16 x 8 NJ, k = the tile's rows 8 (jb + j) ..), handed on as
// the A operand, X the [BK][LD] tile's rows. f32: mma.cuh's k permutation;
// bf16: the pairs of n8 tiles 2 kk and 2 kk + 1 are one k16 step's A,
// rounded to bf16, and ldmatrix.trans reads the B fragments of two n8
// output tiles at once (a k16 step with either n8 tile live runs; a tile
// that is not live holds zeros).
template <typename T, int D, int NJ>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&w)[NJ][4],
                                           const T* x, int jb,
                                           unsigned live) {
  constexpr int LD = ld<T, D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (is_f32<T>()) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (!((live >> j) & 1u)) continue;
      uint32_t ah[4], al[4];
      tc::split_int(w[j][0], ah[0], al[0]);
      tc::split_int(w[j][2], ah[1], al[1]);
      tc::split_int(w[j][1], ah[2], al[2]);
      tc::split_int(w[j][3], ah[3], al[3]);
      const T* xr = x + (8 * (jb + j) + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma3i(acc[n], ah, al, xr[8 * n], xr[LD + 8 * n]);
    }
  } else {
    static_assert(NJ % 2 == 0, "bf16 k16 steps take n8 tiles in pairs");
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      if (!((live >> (2 * kk)) & 3u)) continue;
      const int j = 2 * kk;
      const uint4 a = make_uint4(tc::pack_bf16(w[j][0], w[j][1]),
                                 tc::pack_bf16(w[j][2], w[j][3]),
                                 tc::pack_bf16(w[j + 1][0], w[j + 1][1]),
                                 tc::pack_bf16(w[j + 1][2], w[j + 1][3]));
      const T* xr = x + (8 * (jb + j) + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t b[4];
        tc::ldsm_x4_trans(b, xr + 8 * n);
        tc::mma_bf16(acc[n], a, b[0], b[1]);
        tc::mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// The SPLIT warps of a group hold partial sums of the same 16 rows: parts
// 1.. hand theirs to part 0 through `red` (free shared memory, (SPLIT - 1)
// D / 2 32 floats a group) and part 0 adds them in part order. Every thread
// of the CTA calls it (one __syncthreads).
template <int D, int SPLIT>
__device__ __forceinline__ void fold_parts(float (&acc)[D / 8][4], float* red,
                                           int grp, int part) {
  constexpr int NA = D / 2;
  red += grp * (SPLIT - 1) * NA * 32 + (threadIdx.x & 31);
  if (part > 0) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((part - 1) * NA + 4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (part > 0) return;
  for (int p = 1; p < SPLIT; ++p)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] += red[((p - 1) * NA + 4 * n + e) * 32];
}

// Stage 16 rows of an [S, D] matrix (row r at base + r * rs, zeros past S)
// in fragment order (f32: split into hi and lo).
template <typename T, int D>
__device__ __forceinline__ void stage(uint4* f, const T* base, long long rs,
                                      int r0, int S) {
  attn::stage_q<T, D>(f, [&](int r) -> const T* {
    return r0 + r < S ? base + (size_t)(r0 + r) * rs : nullptr;
  });
}

template <typename T, int D, int GROUPS>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
  using SH = Shape<GROUPS>;
  constexpr int LD = ld<T, D>(), BR = SH::BR, NJ = SH::NJ;
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % GROUPS, part = warp / GROUPS;
  uint4* qf = smem + grp * qf_u4<T, D>();              // Q fragments
  uint4* of = smem + (GROUPS + grp) * qf_u4<T, D>();   // dO fragments
  T* kv = reinterpret_cast<T*>(smem + 2 * GROUPS * qf_u4<T, D>());
  float* ds = reinterpret_cast<float*>(kv + 2 * 2 * BK * LD);  // [BR] D_i

  const int Sq = a.Sq, Sk = a.Sk, off = a.off;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;    // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const T* q = static_cast<const T*>(a.q) + (size_t)b * a.qb +
               (size_t)h * a.qh;
  const T* k = static_cast<const T*>(a.k) + (size_t)b * a.kb +
               (size_t)hk * a.kh;
  const T* v = static_cast<const T*>(a.v) + (size_t)b * a.vb +
               (size_t)hk * a.vh;
  const long long rs = (long long)a.Hq * D;            // o / do row stride
  const T* o = static_cast<const T*>(a.o) + ((size_t)b * Sq * a.Hq + h) * D;
  const T* dout =
      static_cast<const T*>(a.dout) + ((size_t)b * Sq * a.Hq + h) * D;

  // the key tiles the tile's rows (positions q0 + off .. q_last + off) see
  const int q_last = min(q0 + BR, Sq) - 1;
  int kt_lo = 0, kt_hi = (Sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, (q_last + off) / BK + 1);
  if (a.window > 0) kt_lo = min(max(0, q0 + off - a.window + 1) / BK, kt_hi);

  auto load = [&](int kt, int buf) {
    T* kd = kv + buf * 2 * BK * LD;
    const int k0 = kt * BK;
    attn::load_tile<T, D, THREADS>(kd, [&](int i) -> const T* {
      return k0 + i < Sk ? k + (size_t)(k0 + i) * a.ks : nullptr;
    }, a.async, k);
    attn::load_tile<T, D, THREADS>(
        kd + BK * LD, [&](int i) -> const T* {
          return k0 + i < Sk ? v + (size_t)(k0 + i) * a.vs : nullptr;
        }, a.async, v);
    attn::cp_commit();
  };
  if (kt_lo < kt_hi) load(kt_lo, 0);

  const int wr0 = q0 + grp * 16;                       // this warp's rows
  const int wr_last = min(wr0 + 15, Sq - 1);
  if (part == 0) stage<T, D>(qf, q, a.qs, wr0, Sq);
  if (part == 1) stage<T, D>(of, dout, rs, wr0, Sq);
  {  // D_i = do_i . o_i: BR / 8 rows a warp, LR lanes a row
    constexpr int LR = 32 / (BR / WARPS);
    const int r = warp * (BR / WARPS) + lane / LR, row = q0 + r;
    float acc = 0.f;
    if (row < Sq)
      for (int d = lane % LR; d < D; d += LR)
        acc = fmaf(to_f32(dout[(size_t)row * rs + d]),
                   to_f32(o[(size_t)row * rs + d]), acc);
#pragma unroll
    for (int o2 = 1; o2 < LR; o2 <<= 1)
      acc += __shfl_xor_sync(FULL, acc, o2);
    if (lane % LR == 0) {
      ds[r] = acc;
      if (row < Sq) a.dsum[(size_t)bh * Sq + row] = acc;
    }
  }
  float lrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr0 + g + 8 * r;
    lrow[r] = row < Sq ? a.lse[(size_t)bh * Sq + row] : NO_ROW;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float drow[2] = {0.f, 0.f};
  if (kt_lo >= kt_hi) __syncthreads();   // no key tile: D_i and ds written
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) load(kt + 1, buf ^ 1);
    else attn::cp_commit();
    attn::cp_wait_one();
    __syncthreads();                   // (first: the staged rows and D_i too)
    if (kt == kt_lo) {
      drow[0] = ds[grp * 16 + g];
      drow[1] = ds[grp * 16 + g + 8];
    }
    const int jb = NJ * part, k0 = kt * BK + 8 * jb;    // this warp's keys
    int jmax = wr0 < Sq && k0 < Sk ? min(NJ, (Sk - k0 + 7) / 8) : 0;
    if (a.causal)
      jmax = wr_last + off < k0 ? 0
                                : min(jmax, (wr_last + off - k0) / 8 + 1);
    const int k1 = k0 + 8 * NJ - 1;
    const bool full = jmax == NJ && k1 < Sk &&
                      (!a.causal || k1 <= wr0 + off) &&
                      (a.window == 0 || wr_last + off - k0 < a.window);
    if (jmax > 0) {
      const T* ks = kv + buf * 2 * BK * LD;
      const T* vs = ks + BK * LD;
      const unsigned live = (1u << jmax) - 1u;
      float s[NJ][4], dp[NJ][4];
      scores<T, D, NJ>(s, dp, qf, of, ks, vs, jb, live);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool vis = j < jmax &&
                           (full || visible(a, wr0 + g + 8 * r,
                                            k0 + 8 * j + 2 * t + (e & 1)));
          const float p = vis ? expf(s[j][e] * a.scale - lrow[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - drow[r]);            // dS
        }
      accumulate<T, D, NJ>(dq, s, ks, jb, live);           // dQ += dS K
    }
    __syncthreads();                   // this buffer is free for kt + 2
  }

  fold_parts<D, SH::SPLIT>(dq, reinterpret_cast<float*>(kv), grp, part);
  if (part > 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = wr0 + g + 8 * r;
    if (qpos >= Sq) continue;
    T* out = static_cast<T*>(a.dq) + (((size_t)b * Sq + qpos) * a.Hq + h) * D +
             2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + 8 * n, dq[n][2 * r] * a.scale,
             dq[n][2 * r + 1] * a.scale);
  }
}

template <typename T, int D, int GROUPS>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(Args a) {
  using SH = Shape<GROUPS>;
  constexpr int LD = ld<T, D>(), BR = SH::BR, NJ = SH::NJ;
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % GROUPS, part = warp / GROUPS;
  uint4* kf = smem + grp * qf_u4<T, D>();              // K fragments
  uint4* vf = smem + (GROUPS + grp) * qf_u4<T, D>();   // V fragments
  T* qo = reinterpret_cast<T*>(smem + 2 * GROUPS * qf_u4<T, D>());
  float* vec = reinterpret_cast<float*>(qo + 2 * 2 * BK * LD);  // [2][2][BK]

  const int Sq = a.Sq, Sk = a.Sk, off = a.off;
  const int k0 = blockIdx.x * BR, bh = blockIdx.y;     // key tile 0 first
  const int b = bh / a.Hkv, hk = bh % a.Hkv;
  const T* k = static_cast<const T*>(a.k) + (size_t)b * a.kb +
               (size_t)hk * a.kh;
  const T* v = static_cast<const T*>(a.v) + (size_t)b * a.vb +
               (size_t)hk * a.vh;
  const long long rs = (long long)a.Hq * D;

  // the query tiles that see the key tile, for each of the G q heads:
  // row i sees key j from i = j - off (causal) to i = j + window - 1 - off
  const int nq = (Sq + BK - 1) / BK;
  const int k_last = min(k0 + BR, Sk) - 1;
  const int qt_lo = a.causal ? max(0, k0 - off) / BK : 0;
  const int i_hi = k_last + a.window - 1 - off;        // last row (window)
  const int qt_hi = a.window > 0 ? (i_hi < 0 ? 0 : min(nq, i_hi / BK + 1))
                                 : nq;
  const int nqt = max(0, qt_hi - qt_lo), n_it = a.G * nqt;

  auto load = [&](int it, int buf) {
    const int h = hk * a.G + it / nqt, q0 = (qt_lo + it % nqt) * BK;
    const T* q = static_cast<const T*>(a.q) + (size_t)b * a.qb +
                 (size_t)h * a.qh;
    const T* dout =
        static_cast<const T*>(a.dout) + ((size_t)b * Sq * a.Hq + h) * D;
    T* qd = qo + buf * 2 * BK * LD;
    attn::load_tile<T, D, THREADS>(qd, [&](int i) -> const T* {
      return q0 + i < Sq ? q + (size_t)(q0 + i) * a.qs : nullptr;
    }, a.async, q);
    attn::load_tile<T, D, THREADS>(
        qd + BK * LD, [&](int i) -> const T* {
          return q0 + i < Sq ? dout + (size_t)(q0 + i) * rs : nullptr;
        }, a.async, dout);
    attn::cp_commit();
    float* vb = vec + buf * 2 * BK;
    const size_t row = (size_t)(b * a.Hq + h) * Sq + q0;
    if (tid < BK)
      vb[tid] = q0 + tid < Sq ? a.lse[row + tid] : NO_ROW;
    else if (tid < 2 * BK)
      vb[tid] = q0 + tid - BK < Sq ? a.dsum[row + tid - BK] : 0.f;
  };
  if (n_it > 0) load(0, 0);

  const int kw0 = k0 + grp * 16;                       // this warp's keys
  const int kw_last = min(kw0 + 15, Sk - 1);
  if (part == 0) stage<T, D>(kf, k, a.ks, kw0, Sk);
  if (part == 1) stage<T, D>(vf, v, a.vs, kw0, Sk);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int jb = NJ * part;
  if (n_it == 0) __syncthreads();        // the staged K / V (no query tile)
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) load(it + 1, buf ^ 1);
    else attn::cp_commit();
    attn::cp_wait_one();
    __syncthreads();                   // (first: the staged K / V too)
    const int qb0 = (qt_lo + it % nqt) * BK + 8 * jb;  // this warp's queries
    // the n8 query tiles holding a visible pair, and whether all are
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int q8 = qb0 + 8 * j;
      live |= (unsigned)(q8 < Sq && kw0 < Sk &&
                         (!a.causal || q8 + 7 + off >= kw0) &&
                         (a.window == 0 || q8 + off - kw_last < a.window))
              << j;
    }
    const int q1 = qb0 + 8 * NJ - 1;
    const bool full = live == (1u << NJ) - 1u && q1 < Sq && kw0 + 15 < Sk &&
                      (!a.causal || kw0 + 15 <= qb0 + off) &&
                      (a.window == 0 || q1 + off - kw0 < a.window);
    if (live) {
      const T* qs = qo + buf * 2 * BK * LD;
      const T* dos = qs + BK * LD;
      const float* lv = vec + buf * 2 * BK;
      const float* dv_ = lv + BK;
      float s[NJ][4], dp[NJ][4];
      scores<T, D, NJ>(s, dp, kf, vf, qs, dos, jb, live);  // S^T, dP^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * (jb + j) + 2 * t + (e & 1);   // tile row
          const bool vis = ((live >> j) & 1u) &&
                           (full || visible(a, qb0 - 8 * jb + qi,
                                            kw0 + g + 8 * (e >> 1)));
          const float p = vis ? expf(s[j][e] * a.scale - lv[qi]) : 0.f;
          s[j][e] = p;                                 // P^T
          dp[j][e] = p * (dp[j][e] - dv_[qi]);         // dS^T
        }
      accumulate<T, D, NJ>(dv, s, dos, jb, live);          // dV += P^T dO
      accumulate<T, D, NJ>(dk, dp, qs, jb, live);          // dK += dS^T Q
    }
    __syncthreads();                   // this buffer is free for it + 2
  }

  float* red = reinterpret_cast<float*>(qo);
  fold_parts<D, SH::SPLIT>(dk, red, grp, part);
  __syncthreads();                     // part 0 has read dk's parts
  fold_parts<D, SH::SPLIT>(dv, red, grp, part);
  if (part > 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kw0 + g + 8 * r;
    if (kpos >= Sk) continue;
    const size_t at = (((size_t)b * Sk + kpos) * a.Hkv + hk) * D + 2 * t;
    T* dko = static_cast<T*>(a.dk) + at;
    T* dvo = static_cast<T*>(a.dv) + at;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(dko + 8 * n, dk[n][2 * r] * a.scale,
             dk[n][2 * r + 1] * a.scale);
      store2(dvo + 8 * n, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <typename T, int D, int GROUPS>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, D, GROUPS>();
  // the shares' fold reuses the streamed tiles' buffers
  static_assert((size_t)GROUPS * (Shape<GROUPS>::SPLIT - 1) * (D / 2) * 32 *
                        sizeof(float) <=
                    (size_t)2 * 2 * BK * ld<T, D>() * sizeof(T),
                "fold_parts' shared memory overruns the tile buffers");
  constexpr int BR = Shape<GROUPS>::BR;
  const void* kernels[2] = {
      (const void*)flash_bwd_dq_kernel<T, D, GROUPS>,
      (const void*)flash_bwd_dkdv_kernel<T, D, GROUPS>};
  if (smem > 48 * 1024)
    for (int i = 0; i < 2; ++i) {
      cudaError_t e = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  flash_bwd_dq_kernel<T, D, GROUPS>
      <<<dim3((a.Sq + BR - 1) / BR, B * a.Hq), THREADS, smem, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  flash_bwd_dkdv_kernel<T, D, GROUPS>
      <<<dim3((a.Sk + BR - 1) / BR, B * a.Hkv), THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The 4 x 2 shape where it fits (D <= 96) and its dq grid still fills the
// card WIDE_WAVES times over (one CTA an SM); else 2 x 4, twice the CTAs.
// ``groups`` 4 or 2 forces the 4 x 2 or the 2 x 4 shape (0: this rule).
constexpr int WIDE_WAVES = 4;

template <typename T, int D>
int launch_shape(const Args& a, int B, int groups, cudaStream_t s) {
  if (groups == 2) return launch<T, D, 2>(a, B, s);
  if constexpr (D <= 96) {
    if (groups == 4) return launch<T, D, 4>(a, B, s);
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long ctas = (long long)(a.Sq + 63) / 64 * B * a.Hq;
    if (ctas >= (long long)WIDE_WAVES * sms) return launch<T, D, 4>(a, B, s);
  }
  if (groups != 0) return (int)cudaErrorInvalidValue;
  return launch<T, D, 2>(a, B, s);
}

template <typename T>
int dispatch(const Args& a, int B, int D, int groups, cudaStream_t s) {
  switch (D) {
    case 32: return launch_shape<T, 32>(a, B, groups, s);
    case 64: return launch_shape<T, 64>(a, B, groups, s);
    case 96: return launch_shape<T, 96>(a, B, groups, s);
    case 128: return launch_shape<T, 128>(a, B, groups, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
