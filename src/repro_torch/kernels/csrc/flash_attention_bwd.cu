// Backward pass of blocked causal / windowed GQA attention (flash attention)
// for Hopper (sm_90a), f32.
//
// Replaces no TPU kernel: the Pallas kernel of
// src/repro/kernels/flash_attention.py (flash_attention_bhsd) has no
// backward, and the JAX package trains through its plain attention instead
// (use_pallas=False). The port routes by device, so training on the card
// reaches flash_attention_forward; this is the backward of that function,
// behind a torch.autograd.Function in kernels/ops.py.
//
// What it computes. With q [B, S, Hq, D], k/v [B, S, Hkv, D] (read in place
// through their (batch, seq, head) strides, unit stride along D), the
// forward's output o and its gradient do ([B, S, Hq, D], contiguous), the
// visibility of the forward (key j < S is seen by query i when (not causal
// or j <= i) and (window == 0 or i - j < window)), s_ij = q_i.k_j / sqrt(D)
// and P = softmax over the visible keys, it writes
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_{i, h in group} dS_ij q_i,
//   dv_j = sum_{i, h in group} P_ij do_i,  dS_ij = P_ij (do_i.v_j - D_i),
//   D_i = do_i.o_i
// in f32 ([B, S, Hq, D] and [B, S, Hkv, D], contiguous). A row that sees no
// key has P = 0 and gets no gradient, as the forward gives it output 0.
//
// The FlashAttention-2 split, three launches, no atomics (deterministic):
//   1. flash_bwd_prep_kernel, one CTA per (b * Hq + h, 64-row query tile):
//      the row log-sum-exp L_i of the visible scores (recomputed here, so
//      the forward and its serving callers are untouched) and D_i.
//   2. flash_bwd_dkdv_kernel, one CTA per (b * Hkv + hk, 64-key tile): walks
//      the G q heads of its kv head and the query tiles that see the tile,
//      recomputes P = exp(s - L) and accumulates dk and dv in registers.
//   3. flash_bwd_dq_kernel, one CTA per (b * Hq + h, 64-row query tile):
//      walks the key tiles the tile sees and accumulates dq.
// Tiles are 64 x 64 in shared memory (rows padded to D + 1 floats, so a
// warp's column reads hit distinct banks); each of the 256 threads owns a
// 4 x 4 block of a score tile (rows ty + 16 i, columns tx + 16 j) and a
// 4 x D/16 block of an accumulator. Every product runs in f32 on the SIMT
// units (the simple first kernel; the tensor-core redesign is ROADMAP
// queue B).
//
// What bounds it on this card. At phi-3-vision-4.2b's training shape
// ([2, 1024, 32, 96], causal) the five products of the backward over the
// visible pairs are ~32 GFLOP, 0.48 ms at the 67 TFLOP/s f32 peak outside
// the tensor cores (H100 SXM data sheet); q, k, v, o, do, dq, dk and dv move
// ~200 MB (0.06 ms at 3.35 TB/s): it is bound by operations. This design
// does eight 64 x 64 x D products a visible tile pair (the scores three
// times, do.v^T twice) and reads two shared-memory operands per four FMAs.
//
// Interface: plain C, loaded with ctypes. lse and dsum are [B Hq, S] f32
// scratch the caller allocates. The entry returns cudaGetLastError() after
// each launch; the Python wrapper raises on non-0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;                 // rows of a query tile, keys of a key tile
constexpr int THREADS = 256;           // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int LDP = BT + 1;            // row stride of the P / dS tile
constexpr float NO_ROW = 1e30f;        // L of a row that sees no key: P = 0

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;      // [B, S, Hq, D], contiguous
  const float* dout;   // [B, S, Hq, D], contiguous
  float* dq;           // [B, S, Hq, D]
  float* dk;           // [B, S, Hkv, D]
  float* dv;
  float* lse;          // [B Hq, S]
  float* dsum;         // [B Hq, S]
  int S, Hq, Hkv, G;
  long long qb, qs, qh;
  long long kb, ks, kh;
  long long vb, vs, vh;
  int causal, window;
  float scale;
};

template <int D>
__host__ __device__ constexpr int ld() { return D + 1; }

// Dynamic shared memory of the dk/dv and dq kernels (four [BT][D + 1]
// tiles, the P / dS tile, L and D of the query tile) and of the prep
// kernel (two tiles): 146 and 65 KB at D 128.
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(4 * BT * ld<D>() + BT * LDP + 2 * BT) * sizeof(float);
}
template <int D>
constexpr size_t prep_smem_bytes() {
  return (size_t)2 * BT * ld<D>() * sizeof(float);
}

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return i < a.S && j < a.S && (!a.causal || j <= i) &&
         (a.window == 0 || i - j < a.window);
}

// Rows r0 .. r0 + 63 of a [S, D] matrix whose row r starts at base + r * rs
// into dst [BT][D + 1]; rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long long rs, int r0, int S) {
  for (int e = threadIdx.x; e < BT * D; e += THREADS) {
    const int r = e / D, d = e % D;
    dst[r * ld<D>() + d] = r0 + r < S ? base[(size_t)(r0 + r) * rs + d] : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . Bm[tx + 16 j] over D.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         float (&s)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(ty + 16 * i) * ld<D>() + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = Bm[(tx + 16 * j) * ld<D>() + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][n] += sum_r W[r][ty + 16 i] X[r][tx + 16 n] (W the [BT][LDP] P or
// dS tile read transposed, X a [BT][D + 1] tile): the dk / dv update.
template <int D>
__device__ __forceinline__ void acc_tn(const float* W, const float* X,
                                       float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int r = 0; r < BT; ++r) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[r * LDP + ty + 16 * i];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      const float x = X[r * ld<D>() + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(w[i], x, acc[i][n]);
    }
  }
}

// acc[i][n] += sum_c W[ty + 16 i][c] X[c][tx + 16 n]: the dq update.
template <int D>
__device__ __forceinline__ void acc_nn(const float* W, const float* X,
                                       float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int c = 0; c < BT; ++c) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ty + 16 * i) * LDP + c];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      const float x = X[c * ld<D>() + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(w[i], x, acc[i][n]);
    }
  }
}

// The key tiles a query tile starting at q0 sees: [lo, hi).
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& lo,
                                          int& hi) {
  const int q_last = min(q0 + BT, a.S) - 1;
  lo = 0;
  hi = (a.S + BT - 1) / BT;
  if (a.causal) hi = min(hi, q_last / BT + 1);
  if (a.window > 0) lo = max(0, q0 - a.window + 1) / BT;
}

// Reduce over the 16 lanes of a half warp that share ty.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_prep_kernel(Args a) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BT * ld<D>();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  load_rows<D>(Qs, a.q + (size_t)b * a.qb + (size_t)h * a.qh, a.qs, q0, a.S);
  const float* kbase = a.k + (size_t)b * a.kb + (size_t)hk * a.kh;

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  int lo, hi;
  key_tiles(a, q0, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();                    // Ks free (and Qs written)
    load_rows<D>(Ks, kbase, a.ks, kt * BT, a.S);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = visible(a, q0 + ty + 16 * i, kt * BT + tx + 16 * j);
        s[i][j] = vis ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // no branch on the row's state: the two half warps hold other rows
      const float mn = fmaxf(m[i], row_max(mx));
      const float ms = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - ms);
      l[i] = l[i] * expf(m[i] - ms) + row_sum(sum);
      m[i] = mn;
    }
  }
  // D_i = do_i . o_i over D, 16 lanes a row
  const size_t row_stride = (size_t)a.Hq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    float acc = 0.f;
    if (r < a.S) {
      const size_t off = ((size_t)b * a.S + r) * row_stride + (size_t)h * D;
      for (int d = tx; d < D; d += 16) acc += a.dout[off + d] * a.o[off + d];
    }
    acc = row_sum(acc);
    if (tx == 0 && r < a.S) {
      a.lse[(size_t)bh * a.S + r] = l[i] > 0.f ? m[i] + logf(l[i]) : NO_ROW;
      a.dsum[(size_t)bh * a.S + r] = acc;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(Args a) {
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + BT * ld<D>();
  float* Qs = Vs + BT * ld<D>();
  float* Os = Qs + BT * ld<D>();       // do rows
  float* Ps = Os + BT * ld<D>();
  float* Ls = Ps + BT * LDP;
  float* Ds = Ls + BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * BT, bh = blockIdx.y;
  const int b = bh / a.Hkv, hk = bh % a.Hkv;
  load_rows<D>(Ks, a.k + (size_t)b * a.kb + (size_t)hk * a.kh, a.ks, k0, a.S);
  load_rows<D>(Vs, a.v + (size_t)b * a.vb + (size_t)hk * a.vh, a.vs, k0, a.S);

  const int nq = (a.S + BT - 1) / BT;
  const int k_last = min(k0 + BT, a.S) - 1;
  const int qt_lo = a.causal ? k0 / BT : 0;
  const int qt_hi =
      a.window > 0 ? min(nq, (k_last + a.window - 1) / BT + 1) : nq;

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dk[i][n] = dv[i][n] = 0.f;

  for (int h = hk * a.G; h < (hk + 1) * a.G; ++h) {
    const int qh = b * a.Hq + h;
    const float* qbase = a.q + (size_t)b * a.qb + (size_t)h * a.qh;
    const float* obase = a.dout + ((size_t)b * a.S * a.Hq + h) * D;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                  // the last tile's readers are done
      load_rows<D>(Qs, qbase, a.qs, q0, a.S);
      load_rows<D>(Os, obase, (long long)a.Hq * D, q0, a.S);
      if (threadIdx.x < BT) {
        const int r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < a.S ? a.lse[(size_t)qh * a.S + r] : NO_ROW;
        Ds[threadIdx.x] = r < a.S ? a.dsum[(size_t)qh * a.S + r] : 0.f;
      }
      __syncthreads();
      float p[4][4], dp[4][4];
      tile_dot<D>(Qs, Ks, p);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          p[i][j] = visible(a, q0 + r, k0 + c)
                        ? expf(p[i][j] * a.scale - Ls[r]) : 0.f;
          Ps[r * LDP + c] = p[i][j];
        }
      __syncthreads();
      acc_tn<D>(Ps, Os, dv);            // dv += P^T do
      tile_dot<D>(Os, Vs, dp);          // dP = do v^T
      __syncthreads();                  // every thread is done reading P
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          Ps[r * LDP + c] = p[i][j] * (dp[i][j] - Ds[r]);
        }
      __syncthreads();
      acc_tn<D>(Ps, Qs, dk);            // dk += dS^T q
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= a.S) continue;
    const size_t off = (((size_t)b * a.S + c) * a.Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      a.dk[off + tx + 16 * n] = dk[i][n] * a.scale;
      a.dv[off + tx + 16 * n] = dv[i][n];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Os = Qs + BT * ld<D>();
  float* Ks = Os + BT * ld<D>();
  float* Vs = Ks + BT * ld<D>();
  float* Ps = Vs + BT * ld<D>();
  float* Ls = Ps + BT * LDP;
  float* Ds = Ls + BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  load_rows<D>(Qs, a.q + (size_t)b * a.qb + (size_t)h * a.qh, a.qs, q0, a.S);
  load_rows<D>(Os, a.dout + ((size_t)b * a.S * a.Hq + h) * D,
               (long long)a.Hq * D, q0, a.S);
  if (threadIdx.x < BT) {
    const int r = q0 + threadIdx.x;
    Ls[threadIdx.x] = r < a.S ? a.lse[(size_t)bh * a.S + r] : NO_ROW;
    Ds[threadIdx.x] = r < a.S ? a.dsum[(size_t)bh * a.S + r] : 0.f;
  }
  const float* kbase = a.k + (size_t)b * a.kb + (size_t)hk * a.kh;
  const float* vbase = a.v + (size_t)b * a.vb + (size_t)hk * a.vh;

  float dq[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dq[i][n] = 0.f;
  int lo, hi;
  key_tiles(a, q0, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                    // the last tile's readers are done
    load_rows<D>(Ks, kbase, a.ks, k0, a.S);
    load_rows<D>(Vs, vbase, a.vs, k0, a.S);
    __syncthreads();
    float p[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, p);
    tile_dot<D>(Os, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float pv = visible(a, q0 + r, k0 + c)
                             ? expf(p[i][j] * a.scale - Ls[r]) : 0.f;
        Ps[r * LDP + c] = pv * (dp[i][j] - Ds[r]);
      }
    __syncthreads();
    acc_nn<D>(Ps, Ks, dq);              // dq += dS k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.S) continue;
    const size_t off = (((size_t)b * a.S + r) * a.Hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) a.dq[off + tx + 16 * n] = dq[i][n] * a.scale;
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>(), psmem = prep_smem_bytes<D>();
  const void* kernels[3] = {(const void*)flash_bwd_prep_kernel<D>,
                            (const void*)flash_bwd_dkdv_kernel<D>,
                            (const void*)flash_bwd_dq_kernel<D>};
  const size_t bytes[3] = {psmem, smem, smem};
  for (int i = 0; i < 3; ++i)
    if (bytes[i] > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes[i]);
      if (e != cudaSuccess) return (int)e;
    }
  const unsigned tiles = (a.S + BT - 1) / BT;
  flash_bwd_prep_kernel<D><<<dim3(tiles, B * a.Hq), THREADS, psmem, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  flash_bwd_dkdv_kernel<D><<<dim3(tiles, B * a.Hkv), THREADS, smem, s>>>(a);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  flash_bwd_dq_kernel<D><<<dim3(tiles, B * a.Hq), THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 only. Strides are in elements; o and dout contiguous. Returns a
// cudaError_t (0 = launched).
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, void* lse, void* dsum, int B,
                             int S, int Hq, int Hkv, int D, long long qb,
                             long long qs, long long qh, long long kb,
                             long long ks, long long kh, long long vb,
                             long long vs, long long vh, int causal,
                             int window, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(o),
         static_cast<const float*>(dout), static_cast<float*>(dq),
         static_cast<float*>(dk), static_cast<float*>(dv),
         static_cast<float*>(lse), static_cast<float*>(dsum), S, Hq, Hkv,
         Hq / Hkv, qb, qs, qh, kb, ks, kh, vb, vs, vh, causal, window,
         1.f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    case 96: return launch<96>(a, B, s);
    case 128: return launch<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
