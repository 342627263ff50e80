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
// dtype; f32 and bf16 inputs, f32 arithmetic throughout.
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
// (~4 us at 67 TFLOP/s f32, H100 SXM data sheet): compute-bound on paper,
// at a few microseconds either way, so in practice bound by latency and
// by how many SMs the grid fills.
//
// What the design does about it.
//   * The TPU's sequential key-block grid axis, which carries (m, l, acc)
//     in VMEM, becomes a loop over 32-key tiles inside one CTA per
//     (b * Hq + h, 32-row query tile): 128 CTAs at S = 256 for the H100's
//     132 SMs. Nothing is carried between CTAs.
//   * Tiles the TPU skips are skipped before they are read: with causal,
//     tiles wholly past the query tile's last row; with a window, tiles
//     wholly before its first row's window.
//   * D = 128 f32 tiles (Q 32 x 128, K 32 x 129 padded, V 32 x 128) take
//     48.5 KB of shared memory, over the 48 KB static limit: dynamic shared
//     memory with cudaFuncSetAttribute.
//   * One warp per query row (4 rows a warp): lane t scores key t of the
//     tile against the row (K rows padded to D + 1 floats, so the 32 lanes
//     hit 32 banks), the warp reduces max and sum with shuffles, and each
//     lane owns D / 32 output columns, so the f32 accumulator of a warp is
//     4 x D / 32 registers a lane.
// This is the simple first kernel: no wgmma, no TMA, no split over keys.
//
// Interface: plain C, loaded with ctypes. The entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;               // query rows per warp
constexpr int BQ = WARPS * RPW;      // query rows per CTA
constexpr int BK = 32;               // keys per tile: one per lane
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct Args {
  const void* q;      // [B, S, Hq, D]
  const void* k;      // [B, S, Hkv, D]
  const void* v;
  void* out;          // [B, S, Hq, D], contiguous
  int S, Hq, G;
  long long qb, qs, qh;   // element strides of q (batch, seq, head)
  long long kb, ks, kh;
  long long vb, vs, vh;
  int causal, window;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Args a) {
  constexpr int DPL = D / 32;        // output columns per lane
  extern __shared__ float smem[];
  float* qsm = smem;                 // [BQ][D]
  float* ksm = qsm + BQ * D;         // [BK][D + 1]
  float* vsm = ksm + BK * (D + 1);   // [BK][D]

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* q = static_cast<const T*>(a.q) + (size_t)b * a.qb +
               (size_t)h * a.qh;
  const T* k = static_cast<const T*>(a.k) + (size_t)b * a.kb +
               (size_t)hk * a.kh;
  const T* v = static_cast<const T*>(a.v) + (size_t)b * a.vb +
               (size_t)hk * a.vh;
  const int rows = min(BQ, a.S - q0);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qsm[i] = r < rows ? to_f32(q[(size_t)(q0 + r) * a.qs + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const int q_last = q0 + rows - 1;
  for (int k0 = 0; k0 < a.S; k0 += BK) {   // the TPU's key-block grid axis
    if (a.causal && k0 > q_last) break;    // wholly past the diagonal
    if (a.window > 0 && k0 + BK - 1 <= q0 - a.window) continue;
    __syncthreads();                       // the previous tile is consumed
    const int nk = min(BK, a.S - k0);
    for (int i = tid; i < BK * D; i += THREADS) {
      const int t = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (t < nk) {
        kv = to_f32(k[(size_t)(k0 + t) * a.ks + d]);
        vv = to_f32(v[(size_t)(k0 + t) * a.vs + d]);
      }
      ksm[t * (D + 1) + d] = kv;
      vsm[t * D + d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rl = warp + i * WARPS;
      if (rl < rows) {                     // warp-uniform
        const int qpos = q0 + rl, kpos = k0 + lane;
        const bool ok = kpos < a.S && (!a.causal || kpos <= qpos) &&
                        (a.window == 0 || qpos - kpos < a.window);
        const float* qr = qsm + rl * D;
        const float* kr = ksm + lane * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        const float s = ok ? dot * a.scale : NEG_INF;
        const float m_cur = fmaxf(m[i], warp_max(s));
        const float m_safe = m_cur <= NEG_INF / 2 ? 0.f : m_cur;
        const float pr = ok ? expf(s - m_safe) : 0.f;
        const float alpha = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - m_safe);
        l[i] = alpha * l[i] + warp_sum(pr);
        m[i] = m_cur;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
#pragma unroll 8
        for (int t = 0; t < BK; ++t) {
          const float pt = __shfl_sync(FULL, pr, t);
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[i][e] = fmaf(pt, vsm[t * D + lane + 32 * e], acc[i][e]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rl = warp + i * WARPS;
    if (rl < rows) {
      const float denom = l[i] == 0.f ? 1.f : l[i];
      T* o = out + (((size_t)b * a.S + q0 + rl) * a.Hq + h) * D;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        o[lane + 32 * e] = from_f32<T>(acc[i][e] / denom);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * D + BK * (D + 1) + BK * D) * sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, B * a.Hq);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t (0 = launched).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* out, int B, int S, int Hq, int Hkv, int D,
                            long long qb, long long qs, long long qh,
                            long long kb, long long ks, long long kh,
                            long long vb, long long vs, long long vh,
                            int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, S, Hq, Hq / Hkv, qb, qs, qh, kb, ks, kh, vb, vs, vh,
         causal, window, 1.f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
