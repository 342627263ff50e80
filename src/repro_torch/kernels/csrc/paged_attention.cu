// Paged decode and prefill attention for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   paged_decode_kernel  <- paged_attention_bkgd (body _kernel)
//   paged_prefill_kernel <- paged_prefill_bkgd   (body _prefill_kernel)
//
// What they compute. Row b of the batch holds C query tokens at logical
// positions start[b] + c (decode: C == 1 and start == pos). Every q head of
// kv head h attends the K/V positions its block table names: position p
// lives in block tables[b, p / BS] at offset p % BS, -1 marks an unassigned
// table column. Key k_pos is visible to a query at q_pos when
// k_pos <= q_pos and (window == 0 or k_pos > q_pos - window). A row with no
// visible key outputs 0, never NaN (the TPU kernel's l == 0 -> 1 rule).
//
// What bounds them on this card. Every key position is used by the whole
// group of q heads of its kv head and by every row of the chunk, so the
// work is a few flops per byte of K/V, far below the ~295 bf16 flops per
// byte an H100 SXM (data sheet, 700 W limit) needs before compute binds.
// Both kernels are bound by the bytes of K/V they read (plus q and the
// output), i.e. by HBM bandwidth (3.35 TB/s on the same data sheet).
//
// What the design does about it.
//   * One CTA per (slot, kv head), as the TPU grid's (slot, kv head)
//     cells. The TPU's sequential table-column grid axis becomes a loop
//     inside the CTA that reads each assigned block of K and V exactly once
//     for all G q heads of the kv head (GQA rides in the row dimension, no
//     K/V repeat) and for all C rows of the chunk.
//   * The loop stops at the first column past the last query position and
//     skips -1 columns and, under a sliding window, columns wholly before
//     it, so only blocks some query can see are read. A -1 column is never
//     clamped to block 0 and masked, as the TPU DMA did.
//   * The CTA reads its own table row and start/pos from device memory: no
//     host sync, no scalar prefetch.
//   * The online softmax (m, l, acc) lives in registers in f32, one warp
//     per query row, with the TPU kernel's edge rules (NEG_INF = -1e30,
//     m_safe where m <= NEG_INF / 2, probabilities zeroed outside the mask).
//   * Rows that are not a multiple of anything (G = 7, C * G = 112 for
//     qwen2-0.5b) are padded in the loop bounds only, never in the inputs.
// This is the simple first kernel: no wgmma, no TMA, no split-K. At the
// serve path's shapes there are only W x Hkv = 2 to 16 CTAs for the
// H100's 132 SMs, so it is latency-bound, far from the bandwidth bound
// (PERF.md has its times beside that bound).
//
// Interface: plain C, loaded with ctypes. Each entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
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
  const void* q;       // [B, C, Hq, D], q heads grouped per kv head
  const void* k;       // pool [NB, BS, Hkv, D] (strides below, in elements)
  const void* v;
  const int* tables;   // [B, MB]
  const int* start;    // [B]: first query position of row b
  void* out;           // [B, C, Hq, D]
  int C, Hq, Hkv, G, BS, MB;
  long long s_blk, s_tok, s_head;
  int window;          // 0 = full attention
  float scale;
};

// One CTA per (row b, kv head h). Query rows r = c * G + g are processed
// in tiles of WARPS * RPW rows, one warp per row; lane t scores key t of
// the current block (BS <= 32) and owns D / 32 output columns.
template <typename T, int D, int RPW>
__device__ __forceinline__ void attend(const Args& a) {
  constexpr int DPL = D / 32;
  constexpr int TILE = WARPS * RPW;
  extern __shared__ float smem[];
  float* qs = smem;                    // [TILE][D]
  float* ks = qs + TILE * D;           // [BS][D + 1]: padded, conflict-free
  float* vs = ks + a.BS * (D + 1);     // [BS][D]

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = a.C * a.G;
  const int start = a.start[b];
  const int last = start + a.C - 1;
  const int* table = a.tables + (size_t)b * a.MB;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  for (int r0 = 0; r0 < R; r0 += TILE) {
    const int rows = min(TILE, R - r0);
    __syncthreads();                   // the previous tile is done with qs
    for (int i = tid; i < rows * D; i += THREADS) {
      const int r = r0 + i / D, d = i % D;
      const int c = r / a.G, g = r % a.G;
      qs[i] = to_f32(q[(((size_t)b * a.C + c) * a.Hq + h * a.G + g) * D + d]);
    }
    float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
    }

    for (int j = 0; j < a.MB; ++j) {   // the TPU's table-column grid axis
      const int k0 = j * a.BS;
      if (k0 > last) break;            // no query reaches this column
      const int blk = table[j];
      if (blk < 0) continue;           // unassigned: skipped, never read
      if (a.window > 0 && k0 + a.BS - 1 <= start - a.window) continue;
      __syncthreads();                 // the previous block is consumed
      const T* kb = kp + (size_t)blk * a.s_blk + (size_t)h * a.s_head;
      const T* vb = vp + (size_t)blk * a.s_blk + (size_t)h * a.s_head;
      for (int i = tid; i < a.BS * D; i += THREADS) {
        const int t = i / D, d = i % D;
        ks[t * (D + 1) + d] = to_f32(kb[(size_t)t * a.s_tok + d]);
        vs[t * D + d] = to_f32(vb[(size_t)t * a.s_tok + d]);
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rl = warp + i * WARPS;
        if (rl < rows) {               // warp-uniform
          const int qpos = start + (r0 + rl) / a.G;
          const int kpos = k0 + lane;
          const bool ok = lane < a.BS && kpos <= qpos &&
                          (a.window == 0 || kpos > qpos - a.window);
          float s = NEG_INF;
          if (lane < a.BS) {
            const float* qr = qs + rl * D;
            const float* kr = ks + lane * (D + 1);
            float dot = 0.f;
#pragma unroll 16
            for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
            s = ok ? dot * a.scale : NEG_INF;
          }
          const float m_cur = fmaxf(m[i], warp_max(s));
          const float m_safe = m_cur <= NEG_INF / 2 ? 0.f : m_cur;
          const float pr = ok ? expf(s - m_safe) : 0.f;
          const float alpha = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - m_safe);
          l[i] = alpha * l[i] + warp_sum(pr);
          m[i] = m_cur;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
          for (int t = 0; t < a.BS; ++t) {
            const float pt = __shfl_sync(FULL, pr, t);
#pragma unroll
            for (int e = 0; e < DPL; ++e)
              acc[i][e] = fmaf(pt, vs[t * D + lane + 32 * e], acc[i][e]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rl = warp + i * WARPS;
      if (rl < rows) {
        const int r = r0 + rl, c = r / a.G, g = r % a.G;
        const float denom = l[i] == 0.f ? 1.f : l[i];
        T* o = out + (((size_t)b * a.C + c) * a.Hq + h * a.G + g) * D;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          o[lane + 32 * e] = from_f32<T>(acc[i][e] / denom);
      }
    }
  }
}

// Decode: one query token per row, G <= 16 q heads per kv head in one tile.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Args a) {
  attend<T, D, 2>(a);
}

// Prefill: a C-token chunk per row, C * G <= 128 rows per tile.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_prefill_kernel(Args a) {
  attend<T, D, 16>(a);
}

template <int RPW>
size_t smem_bytes(int D, int BS) {
  return (size_t)(WARPS * RPW * D + BS * (D + 1) + BS * D) * sizeof(float);
}

template <typename Kernel>
int launch(Kernel kern, const Args& a, int B, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, a.Hkv), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool prefill, const Args& a, int B, int D, cudaStream_t s) {
  const size_t sm = prefill ? smem_bytes<16>(D, a.BS) : smem_bytes<2>(D, a.BS);
  switch (D) {
    case 32:
      return prefill ? launch(paged_prefill_kernel<T, 32>, a, B, sm, s)
                     : launch(paged_decode_kernel<T, 32>, a, B, sm, s);
    case 64:
      return prefill ? launch(paged_prefill_kernel<T, 64>, a, B, sm, s)
                     : launch(paged_decode_kernel<T, 64>, a, B, sm, s);
    case 128:
      return prefill ? launch(paged_prefill_kernel<T, 128>, a, B, sm, s)
                     : launch(paged_decode_kernel<T, 128>, a, B, sm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int run(bool prefill, const void* q, const void* k, const void* v,
        const int* tables, const int* start, void* out, int B, int C, int Hq,
        int Hkv, int D, int BS, int MB, long long s_blk, long long s_tok,
        long long s_head, int window, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || BS > 32)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, tables, start, out, C, Hq, Hkv, Hq / Hkv, BS, MB,
         s_blk, s_tok, s_head, window, 1.f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(prefill, a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(prefill, a, B, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_attention_decode(const void* q, const void* k, const void* v,
                           const int* tables, const int* pos, void* out,
                           int B, int Hq, int Hkv, int D, int BS, int MB,
                           long long s_blk, long long s_tok, long long s_head,
                           int window, int dtype, void* stream) {
  return run(false, q, k, v, tables, pos, out, B, 1, Hq, Hkv, D, BS, MB,
             s_blk, s_tok, s_head, window, dtype, stream);
}

int paged_attention_prefill(const void* q, const void* k, const void* v,
                            const int* tables, const int* start, void* out,
                            int B, int C, int Hq, int Hkv, int D, int BS,
                            int MB, long long s_blk, long long s_tok,
                            long long s_head, int window, int dtype,
                            void* stream) {
  return run(true, q, k, v, tables, start, out, B, C, Hq, Hkv, D, BS, MB,
             s_blk, s_tok, s_head, window, dtype, stream);
}

}  // extern "C"
