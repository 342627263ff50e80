// Blocked online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_kernel <- flash_attention_bhsd (body _kernel)
//
// What it computes. q [B, S, Hq, D], k/v [B, S, Hkv, D], read in place
// through their (batch, seq, head) strides with a unit stride along D; q
// head h attends kv head h / G, G = Hq / Hkv (any G, not only powers of
// two). Key j is visible to query i when j < S, (not causal or j <= i) and
// (window == 0 or i - j < window). Scores are q.k / sqrt(D) in f32; masked
// scores are -1e30; the softmax is online over key tiles with the TPU
// kernel's edge rules (m_safe = 0 while m <= -1e30 / 2, alpha = 0 from that
// state, probabilities zeroed outside the mask, l == 0 -> 1), so a row that
// sees no key outputs 0. The output [B, S, Hq, D] is contiguous, in q's
// dtype; f32 and bf16 inputs, f32 softmax and accumulation (bf16 inputs
// multiply P rounded to bf16 by V, as flash attention does).
//
// The TPU kernel pads S to its 128-row block and flattens heads into
// [BH, S, D]; this kernel reads the native layout and masks the ragged end
// of S instead (keys past S are never visible, rows past S are not written),
// which gives the padded TPU call's result for causal inputs. The wrapper
// raises, as the JAX wrapper does, for a non-causal S that is not a
// multiple of the TPU block.
//
// What bounds it on this card. At olmoe-1b-7b's prefill (B 1, S 128-256,
// 16 heads, D 128, causal) one call moves ~8 MB (q, k, v, out once each:
// ~2.5 us at 3.35 TB/s) and does ~0.27 GFLOP of visible (query, key) pairs
// (~4 us at the 67 TFLOP/s f32 peak, H100 SXM data sheet; three TF32
// passes on the tensor cores, 3 x 0.27 GFLOP over 495 TFLOP/s, ~1.6 us):
// a few microseconds either way, so in practice bound by latency, by how
// many SMs the grid fills and by the longest causal chain.
//
// What the design does about it (attention_mma.cuh has the shared parts).
//   * Both products on the tensor cores with mma.sync: three TF32 passes
//     for f32 inputs, one bf16 pass for bf16.
//   * One CTA of 8 warps per (b * Hq + h, 32-row query tile): 128 CTAs at
//     olmoe's S 256 for 132 SMs. The TPU's sequential key-block grid axis
//     becomes a loop over 64-key tiles, (m, l, acc) in registers; nothing
//     is carried between CTAs. Each 16-row group has four warps, one for
//     each 16-key quarter of every tile, which quarters the longest causal
//     chain (the last group's walk along the diagonal) and gives each SM
//     sub-partition two warps; the quarters merge their states through
//     shared memory at the end. The query-tile index is reversed, so the
//     heaviest causal tiles start first.
//   * K/V tiles arrive by 16-byte cp.async into two buffers (the next tile
//     loads while this one computes) when every row is 16-byte aligned,
//     else by plain loads into the same buffers; keys past S are zeros.
//   * Tiles the TPU skips are never read: with causal, tiles wholly past
//     the query tile's last row; with a window, tiles wholly before its
//     first row's window. Within a tile a warp stops at the last n8 tile
//     its own rows can see; where its rows see all of its keys it skips
//     the mask.
//   * Shared memory: f32 D 128 takes 164.5 KB (Q fragments split into hi
//     and lo 32 KB, two K/V buffers 132 KB), one CTA an SM; D 96 124.5 KB;
//     dynamic shared memory with cudaFuncSetAttribute. Head dims 32, 64,
//     96 (phi-3-vision) and 128.
//
// A query offset (q-seq sharding: a rank's block of query rows). q holds
// Sq rows at positions q_offset .. q_offset + Sq - 1 and k/v Sk >= Sq keys at
// positions 0 .. Sk - 1; the masks, the tile skip and the unmasked-tile test
// read the rows' positions. Offset 0 and Sq == Sk is the call above.
//
// The backward (flash_attention_bwd.cu) takes each row's log-sum-exp from
// here: with a non-null `lse` ([B Hq, S] f32, for f32 and bf16 inputs) an
// instantiation of its own (LSE) has part 0 write m + log(l) of each row
// it outputs, or 1e30 for a row that sees no key (its P is then 0 in the
// backward, as its output is 0 here). m and l are the f32 softmax state
// (in bf16, l sums the probabilities before they are rounded for P.V).
// Every serving path passes NULL and runs the instantiations without it.
//
// Interface: plain C, loaded with ctypes. The entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using attn::BK;
using attn::NEG_INF;
constexpr int GROUPS = 2;              // 16-row groups a CTA
constexpr int KSPLIT = 4;              // warps a group: each a key quarter
constexpr int WARPS = GROUPS * KSPLIT;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = GROUPS * 16;        // query rows per CTA

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;      // [B, S, Hq, D]
  const void* k;      // [B, S, Hkv, D]
  const void* v;
  void* out;          // [B, Sq, Hq, D], contiguous
  int Sq, Sk, q_off;  // query rows, keys, position of query row 0
  int Hq, G;
  long long qb, qs, qh;   // element strides of q (batch, seq, head)
  long long kb, ks, kh;
  long long vb, vs, vh;
  int causal, window;
  int async;              // every K/V row 16-byte aligned: cp.async
  float scale;
  float* lse;             // [B Hq, Sq] row log-sum-exp (LSE only)
};

// Warp w owns rows 16 (w % GROUPS) .. + 15 of the query tile and keys
// 16 (w / GROUPS) .. + 15 of every 64-key tile; the KSPLIT warps of a
// group merge their online-softmax states through shared memory at the end.
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Args a) {
  constexpr int LD = attn::ld_kv<T, D>();
  constexpr int NJ = BK / 8 / KSPLIT;          // n8 key tiles a warp a tile
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % GROUPS, part = warp / GROUPS;
  uint4* qf = smem + grp * attn::qfrag_u4<T, D>();
  T* kv = reinterpret_cast<T*>(smem + GROUPS * attn::qfrag_u4<T, D>());

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int Sq = a.Sq, Sk = a.Sk, qo = a.q_off;
  const T* q = static_cast<const T*>(a.q) + (size_t)b * a.qb +
               (size_t)h * a.qh;
  const T* k = static_cast<const T*>(a.k) + (size_t)b * a.kb +
               (size_t)hk * a.kh;
  const T* v = static_cast<const T*>(a.v) + (size_t)b * a.vb +
               (size_t)hk * a.vh;

  const int q_last = qo + min(q0 + BQ, Sq) - 1;        // a position
  int kt_lo = 0, kt_hi = (Sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, q_last / BK + 1);
  if (a.window > 0) kt_lo = max(0, qo + q0 - a.window + 1) / BK;

  auto load = [&](int kt, int buf) {
    T* kd = kv + buf * 2 * BK * LD;
    const int k0 = kt * BK;
    attn::load_tile<T, D, THREADS>(kd, [&](int i) -> const T* {
      return k0 + i < Sk ? k + (size_t)(k0 + i) * a.ks : nullptr;
    }, a.async, k);
    attn::load_tile<T, D, THREADS>(kd + BK * LD, [&](int i) -> const T* {
      return k0 + i < Sk ? v + (size_t)(k0 + i) * a.vs : nullptr;
    }, a.async, v);
    attn::cp_commit();
  };
  load(kt_lo, 0);

  const int wr0 = q0 + grp * 16;                       // this warp's rows
  const int wp0 = qo + wr0, wp_last = qo + min(wr0 + 15, Sq - 1);
  if (part == 0)                       // read by every part after a barrier
    attn::stage_q<T, D>(qf, [&](int r) -> const T* {
      return wr0 + r < Sq ? q + (size_t)(wr0 + r) * a.qs : nullptr;
    });

  attn::WarpState<T, D> st;
  st.init();
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) load(kt + 1, buf ^ 1);
    else attn::cp_commit();
    attn::cp_wait_one();
    __syncthreads();
    const int k0 = kt * BK + 8 * NJ * part;            // this warp's keys
    int jmax = wr0 < Sq && k0 < Sk ? min(NJ, (Sk - k0 + 7) / 8) : 0;
    if (a.causal) jmax = wp_last < k0 ? 0 : min(jmax, (wp_last - k0) / 8 + 1);
    const T* kd = kv + buf * 2 * BK * LD;
    auto vis = [&](int r, int key) {
      const int qpos = wp0 + g + 8 * r, kpos = kt * BK + key;
      return kpos < Sk && (!a.causal || kpos <= qpos) &&
             (a.window == 0 || qpos - kpos < a.window);
    };
    // every (row, key) pair visible: no mask (warp-uniform)
    const int k1 = k0 + 8 * NJ - 1;
    const bool full = jmax == NJ && k1 < Sk && (!a.causal || k1 <= wp0) &&
                      (a.window == 0 || wp_last - k0 < a.window);
    if (full)
      st.template step<NJ, false>(qf, kd, kd + BK * LD, NJ * part, NJ,
                                  a.scale, vis);
    else if (jmax > 0)
      st.template step<NJ, true>(qf, kd, kd + BK * LD, NJ * part, jmax,
                                 a.scale, vis);
    __syncthreads();                  // this buffer is free for kt + 2
  }

  // the other parts' states through shared memory (the K/V buffers are
  // free now), one region per group
  st.template merge_parts<KSPLIT>(
      reinterpret_cast<float*>(kv) +
          grp * (KSPLIT - 1) * attn::WarpState<T, D>::NV * 32,
      part);
  if (part > 0) return;

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = wr0 + g + 8 * r;
    if (qrow < Sq) {
      const float inv = 1.f / (st.l[r] == 0.f ? 1.f : st.l[r]);
      if constexpr (LSE) {
        if (t == 0)
          a.lse[(size_t)bh * Sq + qrow] =
              st.l[r] > 0.f ? st.m[r] + logf(st.l[r]) : 1e30f;
      }
      T* o = out + (((size_t)b * Sq + qrow) * a.Hq + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[8 * n] = from_f32<T>(st.o[n][2 * r] * inv);
        o[8 * n + 1] = from_f32<T>(st.o[n][2 * r + 1] * inv);
      }
    }
  }
}

template <typename T, int D, bool LSE>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = attn::smem_bytes<T, D, GROUPS>();
  auto kern = flash_attention_kernel<T, D, LSE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.Hq);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool LSE = false>
int dispatch(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32, LSE>(a, B, s);
    case 64: return launch<T, 64, LSE>(a, B, s);
    case 96: return launch<T, 96, LSE>(a, B, s);
    case 128: return launch<T, 128, LSE>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. S query rows
// at positions q_offset .. q_offset + S - 1 against Sk >= S keys at 0 ..
// Sk - 1 (Sk == S, q_offset 0: self-attention). lse: [B Hq, S] f32 or NULL.
// Returns a cudaError_t (0 = launched).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int S, int Hq,
                            int Hkv, int D, long long qb, long long qs,
                            long long qh,
                            long long kb, long long ks, long long kh,
                            long long vb, long long vs, long long vh,
                            int causal, int window, int Sk, int q_offset,
                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Sk < S || q_offset < 0 || Hkv <= 0 ||
      Hq % Hkv != 0 || window < 0 || (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  // cp.async needs every K/V row 16-byte aligned
  const long long el = dtype == 0 ? 4 : 2, al = 16 / el;
  const int async = ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0) &&
                    kb % al == 0 && ks % al == 0 && kh % al == 0 &&
                    vb % al == 0 && vs % al == 0 && vh % al == 0;
  Args a{q, k, v, out, S, Sk, q_offset, Hq, Hq / Hkv, qb, qs, qh, kb, ks,
         kh, vb, vs, vh, causal, window, async, 1.f / sqrtf((float)D),
         static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && lse) return dispatch<float, true>(a, B, D, s);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1 && lse) return dispatch<__nv_bfloat16, true>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
