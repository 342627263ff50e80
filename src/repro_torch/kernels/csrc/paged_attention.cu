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
// work is a few flops per byte of K/V: at the serve path's shapes a call
// reads a few hundred KB to a few MB and does well under a GFLOP, so both
// bounds (3.35 TB/s HBM, 67 TFLOP/s f32; H100 SXM data sheet) are around
// a microsecond and the kernels are bound by latency and by how much of
// the card the grid fills.
//
// Decode (the simple first kernel, unchanged since it was ported).
//   * One CTA per (slot, kv head), as the TPU grid's (slot, kv head)
//     cells. The TPU's sequential table-column grid axis becomes a loop
//     inside the CTA that reads each assigned block of K and V once for all
//     G q heads of the kv head (GQA rides in the row dimension).
//   * The loop stops at the first column past the query position, skips -1
//     columns and, under a sliding window, columns wholly before it. A -1
//     column is never clamped to block 0 and masked, as the TPU DMA did.
//   * The CTA reads its own table row and pos from device memory: no host
//     sync, no scalar prefetch.
//   * The online softmax (m, l, acc) lives in registers in f32, one warp
//     per query row, with the TPU kernel's edge rules (NEG_INF = -1e30,
//     m_safe where m <= NEG_INF / 2, probabilities zeroed outside the mask).
//
// Prefill (redesigned for the tensor cores; attention_mma.cuh).
//   * The table walk is split: the grid is (B x Hkv, nsplit, row groups),
//     split s owning columns [s cps, (s + 1) cps). nsplit comes from the
//     host-known MB and a fixed cps (the wrapper never reads start to the
//     host). At qwen2-0.5b's engine shape (B 4, Hkv 2, MB 64, BS 16, cps 2)
//     that is 256 CTAs for 132 SMs where one CTA per (slot, kv head) made 8.
//   * A split whose columns are all -1, past the chunk's last position or
//     wholly before the window writes an empty partial (m = -1e30, l = 0)
//     and exits; live columns are gathered max(1, 64 / BS) at a time into
//     64-key tiles through s_tok by 16-byte cp.async, two buffers deep;
//     dead keys are zeros and masked.
//   * The C x G rows (112 at C 16, G 7, in the TPU's r = c G + g order,
//     position start + r / G) are m16 tiles, one warp each; both products
//     run on mma.sync (three TF32 passes for f32, bf16 for bf16).
//   * A second small kernel merges the splits' (m, l, acc) partials (f32
//     scratch from the wrapper) and applies l == 0 -> 1 after the merge;
//     with one split the first kernel writes the output itself.
//
// Interface: plain C, loaded with ctypes. Each entry returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

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
int dispatch_decode(const Args& a, int B, int D, cudaStream_t s) {
  const size_t sm = smem_bytes<2>(D, a.BS);
  switch (D) {
    case 32: return launch(paged_decode_kernel<T, 32>, a, B, sm, s);
    case 64: return launch(paged_decode_kernel<T, 64>, a, B, sm, s);
    case 128: return launch(paged_decode_kernel<T, 128>, a, B, sm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Prefill: tensor cores (attention_mma.cuh) over a split table walk.
// ---------------------------------------------------------------------------
struct PrefillArgs {
  const void* q;       // [B, C, Hq, D]
  const void* k;       // pool [NB, BS, Hkv, D], contiguous
  const void* v;
  const int* tables;   // [B, MB]
  const int* start;    // [B]
  void* out;           // [B, C, Hq, D]
  float* part_acc;     // [nsplit, B, Hkv, R, D]: each split's unnormalised acc
  float2* part_ml;     // [nsplit, B, Hkv, R]: each split's (m, l)
  int B, C, Hq, Hkv, G, BS, MB, cps, nsplit;
  long long s_blk, s_tok, s_head;
  int window;
  float scale;
};

// Warps a CTA: 8 (128 rows), 4 for f32 at D 128 to stay in shared memory.
template <typename T, int D>
__host__ __device__ constexpr int prefill_warps() {
  return attn::is_f32<T>() && D == 128 ? 4 : 8;
}

// One CTA per (row b x kv head h, split, group of 16 W query rows). Split s
// owns table columns [s cps, (s + 1) cps); its live columns (assigned, not
// past the chunk's last position, not wholly before the first row's
// window) are gathered max(1, 64 / BS) at a time into 64-key tiles. Query
// row r = c G + g sits at position start + r / G. With one split the CTA
// writes the output; otherwise its (m, l, acc) partial, merged below.
template <typename T, int D>
__global__ void __launch_bounds__(8 * 32) paged_prefill_kernel(PrefillArgs a) {
  using attn::BK;
  constexpr int W = prefill_warps<T, D>();
  constexpr int LD = attn::ld_kv<T, D>();
  extern __shared__ uint4 pre_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint4* qf = pre_smem + warp * attn::qfrag_u4<T, D>();
  T* kv = reinterpret_cast<T*>(pre_smem + W * attn::qfrag_u4<T, D>());
  int* kvalid = reinterpret_cast<int*>(kv + 2 * 2 * BK * LD);   // [2][BK]

  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;
  const int R = a.C * a.G, G = a.G, BS = a.BS;
  const int rg0 = blockIdx.z * W * 16;           // the CTA's first row
  const int start = a.start[b], last = start + a.C - 1;
  const int* table = a.tables + (size_t)b * a.MB;
  const int j0 = split * a.cps, j1 = min(a.MB, j0 + a.cps);
  const int ncol = max(1, BK / BS);              // table columns a tile
  const bool direct = a.nsplit == 1;
  const size_t prow =
      ((size_t)split * a.B * a.Hkv + (size_t)b * a.Hkv + h) * R;
  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  auto row_off = [&](int r) {                    // q / out offset of row r
    return (((size_t)b * a.C + r / G) * a.Hq + h * G + r % G) * D;
  };
  auto live = [&](int j) {
    const int k0 = j * BS;
    return table[j] >= 0 && k0 <= last &&
           !(a.window > 0 && k0 + BS - 1 <= start - a.window);
  };
  auto next_tile = [&](int jt) {                 // first tile with a live column
    for (; jt < j1; jt += ncol)
      for (int j = jt; j < min(jt + ncol, j1); ++j)
        if (live(j)) return jt;
    return j1;
  };

  int jt = next_tile(j0);
  if (jt >= j1) {                // nothing visible: zeros, or an empty partial
    for (int r = rg0 + tid; r < min(R, rg0 + W * 16); r += blockDim.x) {
      if (direct) {
        for (int d = 0; d < D; ++d) out[row_off(r) + d] = from_f32<T>(0.f);
      } else {
        a.part_ml[prow + r] = make_float2(NEG_INF, 0.f);
      }
    }
    return;
  }

  auto load = [&](int tile, int buf) {
    T* kd = kv + buf * 2 * BK * LD;
    const int nkeys = (min(tile + ncol, j1) - tile) * BS;
    auto off = [&](int i) -> long long {         // pool offset of tile key i
      if (i >= nkeys || !live(tile + i / BS)) return -1;
      return (long long)table[tile + i / BS] * a.s_blk +
             (long long)(i % BS) * a.s_tok + (long long)h * a.s_head;
    };
    attn::load_kv_pair<T, D, W * 32>(kd, kd + BK * LD, kp, vp, off);
    for (int i = tid; i < BK; i += blockDim.x)
      kvalid[buf * BK + i] = off(i) >= 0;
    attn::cp_commit();
  };
  load(jt, 0);

  const int wr0 = rg0 + warp * 16;               // this warp's first row
  attn::stage_q<T, D>(qf, [&](int r) -> const T* {
    return wr0 + r < R ? qp + row_off(wr0 + r) : nullptr;
  });
  __syncwarp();
  const int wq_last = start + min(wr0 + 15, R - 1) / G;
  const int qpos[2] = {start + (wr0 + g) / G, start + (wr0 + g + 8) / G};

  attn::WarpState<T, D> st;
  st.init();
  int buf = 0;
  while (jt < j1) {
    const int nxt = next_tile(jt + ncol);
    if (nxt < j1) load(nxt, buf ^ 1);
    else attn::cp_commit();
    attn::cp_wait_one();
    __syncthreads();
    const int k0 = jt * BS;                      // position of tile key 0
    const int nkeys = (min(jt + ncol, j1) - jt) * BS;
    const int jmax = wr0 < R && wq_last >= k0
                         ? min((nkeys + 7) / 8, (wq_last - k0) / 8 + 1)
                         : 0;
    if (jmax > 0) {                              // warp-uniform
      const T* kd = kv + buf * 2 * BK * LD;
      const int* ok = kvalid + buf * BK;
      st.template step<8, true>(qf, kd, kd + BK * LD, 0, jmax, a.scale,
                          [&](int r, int key) {
        const int kpos = k0 + key;
        return ok[key] && kpos <= qpos[r] &&
               (a.window == 0 || kpos > qpos[r] - a.window);
      });
    }
    __syncthreads();                             // this buffer is free again
    jt = nxt;
    buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr0 + g + 8 * r;
    if (row >= R) continue;
    if (direct) {
      const float inv = 1.f / (st.l[r] == 0.f ? 1.f : st.l[r]);
      T* o = out + row_off(row) + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[8 * n] = from_f32<T>(st.o[n][2 * r] * inv);
        o[8 * n + 1] = from_f32<T>(st.o[n][2 * r + 1] * inv);
      }
    } else {
      float* o = a.part_acc + (prow + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(st.o[n][2 * r], st.o[n][2 * r + 1]);
      if (t == 0) a.part_ml[prow + row] = make_float2(st.m[r], st.l[r]);
    }
  }
}

// One warp per query row: the splits' partials rescaled to their common
// max and summed; the l == 0 -> 1 rule applies after the merge.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    paged_prefill_merge_kernel(PrefillArgs a) {
  const int R = a.C * a.G, rows = a.B * a.Hkv * R;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float M = NEG_INF;
  for (int s = 0; s < a.nsplit; ++s) {
    const float2 ml = a.part_ml[(size_t)s * rows + row];
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
  float L = 0.f, acc[D / 32];
#pragma unroll
  for (int e = 0; e < D / 32; ++e) acc[e] = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float2 ml = a.part_ml[(size_t)s * rows + row];
    if (ml.y > 0.f) {                  // an empty split's acc is never read
      const float w = expf(ml.x - M);
      const float* p = a.part_acc + ((size_t)s * rows + row) * D + lane;
      L += w * ml.y;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) acc[e] += w * p[32 * e];
    }
  }
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  const int r = row % R, bh = row / R, b = bh / a.Hkv, h = bh % a.Hkv;
  T* o = static_cast<T*>(a.out) +
         (((size_t)b * a.C + r / a.G) * a.Hq + h * a.G + r % a.G) * D + lane;
#pragma unroll
  for (int e = 0; e < D / 32; ++e) o[32 * e] = from_f32<T>(acc[e] * inv);
}

template <typename T, int D>
int launch_prefill(const PrefillArgs& a, cudaStream_t stream) {
  constexpr int W = prefill_warps<T, D>();
  constexpr size_t smem = attn::smem_bytes<T, D, W>();
  auto kern = paged_prefill_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int R = a.C * a.G;
  const dim3 grid(a.B * a.Hkv, a.nsplit, (R + 16 * W - 1) / (16 * W));
  kern<<<grid, W * 32, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return (int)e;
  const int rows = a.B * a.Hkv * R;
  paged_prefill_merge_kernel<T, D>
      <<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_prefill(const PrefillArgs& a, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch_prefill<T, 32>(a, s);
    case 64: return launch_prefill<T, 64>(a, s);
    case 128: return launch_prefill<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_attention_decode(const void* q, const void* k, const void* v,
                           const int* tables, const int* pos, void* out,
                           int B, int Hq, int Hkv, int D, int BS, int MB,
                           long long s_blk, long long s_tok, long long s_head,
                           int window, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || BS > 32)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, tables, pos, out, 1, Hq, Hkv, Hq / Hkv, BS, MB,
         s_blk, s_tok, s_head, window, 1.f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_decode<float>(a, B, D, s);
  if (dtype == 1) return dispatch_decode<__nv_bfloat16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}

// The table walk is split into ceil(MB / cols_per_split) ranges (at least
// one); with more than one, part_acc [nsplit * B * Hkv * C * G * D] and
// part_ml [nsplit * B * Hkv * C * G * 2] are f32 scratch the caller
// allocates. k and v must be 16-byte aligned (cp.async).
int paged_attention_prefill(const void* q, const void* k, const void* v,
                            const int* tables, const int* start, void* out,
                            float* part_acc, float* part_ml, int B, int C,
                            int Hq, int Hkv, int D, int BS, int MB,
                            int cols_per_split, long long s_blk,
                            long long s_tok, long long s_head, int window,
                            int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || BS > 32 ||
      MB < 0 || cols_per_split <= 0 || window < 0 ||
      (uintptr_t)k % 16 != 0 || (uintptr_t)v % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nsplit = max(1, (MB + cols_per_split - 1) / cols_per_split);
  if (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  PrefillArgs a{q, k, v, tables, start, out, part_acc,
                reinterpret_cast<float2*>(part_ml), B, C, Hq, Hkv, Hq / Hkv,
                BS, MB, cols_per_split, nsplit, s_blk, s_tok, s_head, window,
                1.f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_prefill<float>(a, D, s);
  if (dtype == 1) return dispatch_prefill<__nv_bfloat16>(a, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
