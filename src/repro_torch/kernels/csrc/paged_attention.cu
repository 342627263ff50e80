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
// work is a few flops per byte of K/V. At qwen2-0.5b's serve shapes (14 q
// / 2 kv heads, D 64, block 16) a decode call over 8 slots at positions
// 192-383 reads ~2.2 MB of K/V, ~8.4 MB with the 64-column table full, and
// does a few MFLOP: both bounds (3.35 TB/s HBM; 495 TFLOP/s TF32, H100 SXM
// data sheet) are 0.7-2.5 us, below a kernel launch. The kernels are bound
// by latency: the longest chain of dependent loads and products a CTA
// walks, and how much of the card the grid keeps busy.
//
// What the design does about it (both kernels; attention_mma.cuh has the
// warp-level parts).
//   * The table walk is split: the grid is (B x Hkv, nsplit, row tiles),
//     split s owning columns [s cps, (s + 1) cps). nsplit comes from the
//     host-known MB and a fixed cps per kernel (the wrapper never reads
//     start to the host). A CTA walks a few columns, not a row's whole
//     table: decode at the engine shape (W 8, Hkv 2, MB 64, four columns
//     a split) gets 256 CTAs where one CTA per (slot, kv head) made 16.
//   * A split whose columns are all -1, past the last query position or
//     wholly before the window writes an empty partial (m = -1e30, l = 0)
//     and exits; live columns are gathered max(1, 64 / BS) at a time into
//     64-key tiles by 16-byte cp.async, two buffers deep, the next tile
//     loading while this one computes; dead keys are zeros and masked. A
//     -1 column is never read (the TPU DMA clamped it to block 0).
//   * Query row r = c G + g (the TPU's order; decode: the G q heads) sits
//     at position start + r / G; rows come in m16 tiles and both products
//     run on mma.sync (three TF32 passes for f32, one bf16 pass for bf16).
//     The prefill has C G rows (112 at C 16, G 7): each of its 8 warps (4
//     for f32 at D 128) takes 16 rows and every key. Head dims 32, 64, 96
//     and 128 (D 96: 12 TF32 k8 steps or 6 bf16 k16 steps in Q.K, 12 n8
//     tiles in P.V). Decode has G rows a kv
//     head, one m16 tile (G > 16: more tiles on the grid's z), so its 4
//     warps share the tile and each takes a 16-key quarter of every 64-key
//     tile; the quarters merge through shared memory at the end
//     (WarpState::merge_parts), so a tile costs a quarter of the chain.
//   * A second small kernel merges the splits' (m, l, acc) partials (f32
//     scratch from the wrapper) and applies l == 0 -> 1 after the merge;
//     with one split the first kernel writes the output itself. One C
//     entry launches both.
//   * No host read, no device-side counter or semaphore: a call can be
//     captured in a CUDA graph and replayed as it is.
//
// Interface: plain C, loaded with ctypes. Each entry returns
// cudaGetLastError() after the launches; the Python wrapper raises on non-0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using attn::BK;
using attn::NEG_INF;
constexpr int DECODE_WARPS = 4;        // key quarters of every tile
constexpr int MERGE_WARPS = 8;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;       // [B, C, Hq, D], q heads grouped per kv head
  const void* k;       // pool [NB, BS, Hkv, D], contiguous
  const void* v;
  const int* tables;   // [B, MB]
  const int* start;    // [B]: position of row b's first query (decode: pos)
  void* out;           // [B, C, Hq, D]
  float* part_acc;     // [nsplit, B, Hkv, R, D]: each split's unnormalised acc
  float2* part_ml;     // [nsplit, B, Hkv, R]: each split's (m, l)
  int B, C, Hq, Hkv, G, BS, MB, cps, nsplit;
  long long s_blk, s_tok, s_head;
  int window;
  float scale;
};

// Prefill warps a CTA: 8 (128 rows), 4 for f32 at D 128 to stay in the
// 227 KB of shared memory a block may take (attention_mma.cuh smem_bytes:
// f32 at D 128 takes 260.5 KB with 8 warps, 196.5 KB with 4; at D 96, 8
// warps take 196.5 KB).
template <typename T, int D>
__host__ __device__ constexpr int prefill_warps() {
  return attn::is_f32<T>() && D == 128 ? 4 : 8;
}

// One CTA per (row b x kv head h, split, tile of 16 GROUPS query rows), of
// GROUPS x KSPLIT warps: warp w takes rows 16 (w % GROUPS) .. + 15 of the
// tile and the 64 / KSPLIT keys (w / GROUPS) 64 / KSPLIT .. of every 64-key
// tile. Split s owns table columns [s cps, (s + 1) cps); its live columns
// (assigned, not past the last query position, not wholly before the first
// row's window) are gathered max(1, 64 / BS) at a time into tiles. With one
// split the CTA writes the output; otherwise its (m, l, acc) partial. CT is
// C where the compiler may fold it (1: decode, every row at start), 0 for
// the runtime a.C (prefill).
template <typename T, int D, int GROUPS, int KSPLIT, int CT>
__device__ __forceinline__ void attend_split(const Args& a) {
  constexpr int W = GROUPS * KSPLIT;
  constexpr int NJ = BK / 8 / KSPLIT;            // n8 key tiles a warp a tile
  constexpr int LD = attn::ld_kv<T, D>();
  constexpr int NV = attn::WarpState<T, D>::NV;
  static_assert(KSPLIT == 1 || GROUPS * (KSPLIT - 1) * NV * 32 * 4 <=
                                   2 * 2 * BK * LD * (int)sizeof(T),
                "merge_parts' states must fit in the K/V buffers");
  extern __shared__ uint4 pa_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = KSPLIT == 1 ? warp : warp % GROUPS;
  const int part = KSPLIT == 1 ? 0 : warp / GROUPS;
  uint4* qf = pa_smem + grp * attn::qfrag_u4<T, D>();
  T* kv = reinterpret_cast<T*>(pa_smem + GROUPS * attn::qfrag_u4<T, D>());
  int* kvalid = reinterpret_cast<int*>(kv + 2 * 2 * BK * LD);   // [2][BK]

  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;
  const int C = CT > 0 ? CT : a.C;
  const int R = C * a.G, G = a.G, BS = a.BS;
  const int rg0 = blockIdx.z * GROUPS * 16;      // the CTA's first row
  const int start = a.start[b], last = start + C - 1;
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
    if (CT == 1) return ((size_t)b * a.Hq + h * G + r) * D;
    return (((size_t)b * C + r / G) * a.Hq + h * G + r % G) * D;
  };
  auto row_pos = [&](int r) {    // position of row r (decode: rows past G too)
    return CT == 1 ? start : start + r / G;
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
    for (int r = rg0 + tid; r < min(R, rg0 + GROUPS * 16); r += blockDim.x) {
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

  const int wr0 = rg0 + grp * 16;                // this warp's first row
  if (part == 0)                 // read by every part after a barrier
    attn::stage_q<T, D>(qf, [&](int r) -> const T* {
      return wr0 + r < R ? qp + row_off(wr0 + r) : nullptr;
    });
  __syncwarp();
  const int wq_last = row_pos(min(wr0 + 15, R - 1));
  const int qpos[2] = {row_pos(wr0 + g), row_pos(wr0 + g + 8)};
  const int kw = 8 * NJ * part;                  // this warp's first tile key

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
    const int jmax = wr0 < R && nkeys > kw && wq_last >= k0 + kw
                         ? min(min(NJ, (nkeys - kw + 7) / 8),
                               (wq_last - k0 - kw) / 8 + 1)
                         : 0;
    if (jmax > 0) {                              // warp-uniform
      const T* kd = kv + buf * 2 * BK * LD;
      const int* ok = kvalid + buf * BK;
      st.template step<NJ, true>(qf, kd, kd + BK * LD, NJ * part, jmax,
                                 a.scale, [&](int r, int key) {
        const int kpos = k0 + key;
        return ok[key] && kpos <= qpos[r] &&
               (a.window == 0 || kpos > qpos[r] - a.window);
      });
    }
    __syncthreads();                             // this buffer is free again
    jt = nxt;
    buf ^= 1;
  }
  if constexpr (KSPLIT > 1) {    // the key parts' states, through shared memory
    st.template merge_parts<KSPLIT>(
        reinterpret_cast<float*>(kv) + grp * (KSPLIT - 1) * NV * 32, part);
    if (part > 0) return;
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

// Decode: one m16 tile of the G q heads, four warps over the keys.
template <typename T, int D>
__global__ void __launch_bounds__(DECODE_WARPS * 32)
    paged_decode_kernel(Args a) {
  attend_split<T, D, 1, DECODE_WARPS, 1>(a);
}

// Prefill: 16-row tiles of the chunk's C G rows, one a warp, every key.
template <typename T, int D>
__global__ void __launch_bounds__(8 * 32) paged_prefill_kernel(Args a) {
  attend_split<T, D, prefill_warps<T, D>(), 1, 0>(a);
}

// One warp per query row: the splits' partials rescaled to their common
// max and summed; the l == 0 -> 1 rule applies after the merge. CT as in
// attend_split.
template <typename T, int D, int CT>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    paged_merge_kernel(Args a) {
  const int C = CT > 0 ? CT : a.C;
  const int R = C * a.G, rows = a.B * a.Hkv * R;
  const int row = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
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
         (((size_t)b * C + r / a.G) * a.Hq + h * a.G + r % a.G) * D + lane;
#pragma unroll
  for (int e = 0; e < D / 32; ++e) o[32 * e] = from_f32<T>(acc[e] * inv);
}

// The split kernel on its (B x Hkv, nsplit, row tiles) grid, then, with
// more than one split, the merge.
template <typename T, int D, int GROUPS, int KSPLIT, int CT, class Kernel>
int launch_split(Kernel kern, const Args& a, cudaStream_t stream) {
  constexpr size_t smem = attn::smem_bytes<T, D, GROUPS>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int R = a.C * a.G;
  const dim3 grid(a.B * a.Hkv, a.nsplit, (R + 16 * GROUPS - 1) / (16 * GROUPS));
  kern<<<grid, GROUPS * KSPLIT * 32, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return (int)e;
  const int rows = a.B * a.Hkv * R;
  paged_merge_kernel<T, D, CT>
      <<<(rows + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0,
         stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Args& a, bool decode, cudaStream_t s) {
  if (decode)
    return launch_split<T, D, 1, DECODE_WARPS, 1>(paged_decode_kernel<T, D>,
                                                  a, s);
  return launch_split<T, D, prefill_warps<T, D>(), 1, 0>(
      paged_prefill_kernel<T, D>, a, s);
}

// Check the arguments both entries share, build Args and launch.
int run(const void* q, const void* k, const void* v, const int* tables,
        const int* start, void* out, float* part_acc, float* part_ml, int B,
        int C, int Hq, int Hkv, int D, int BS, int MB, int cols_per_split,
        long long s_blk, long long s_tok, long long s_head, int window,
        int dtype, bool decode, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || BS > 32 ||
      MB < 0 || cols_per_split <= 0 || window < 0 ||
      (uintptr_t)k % 16 != 0 || (uintptr_t)v % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nsplit = max(1, (MB + cols_per_split - 1) / cols_per_split);
  if (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, tables, start, out, part_acc,
               reinterpret_cast<float2*>(part_ml), B, C, Hq, Hkv, Hq / Hkv,
               BS, MB, cols_per_split, nsplit, s_blk, s_tok, s_head, window,
               1.f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return dtype == 0 ? launch<float, 32>(a, decode, s)
                               : launch<__nv_bfloat16, 32>(a, decode, s);
    case 64: return dtype == 0 ? launch<float, 64>(a, decode, s)
                               : launch<__nv_bfloat16, 64>(a, decode, s);
    case 96: return dtype == 0 ? launch<float, 96>(a, decode, s)
                               : launch<__nv_bfloat16, 96>(a, decode, s);
    case 128: return dtype == 0 ? launch<float, 128>(a, decode, s)
                                : launch<__nv_bfloat16, 128>(a, decode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
// The table walk is split into ceil(MB / cols_per_split) ranges (at least
// one); with more than one, part_acc [nsplit * B * Hkv * R * D] and
// part_ml [nsplit * B * Hkv * R * 2] are f32 scratch the caller allocates
// (R = C G rows a kv head; decode: R = G). k and v must be 16-byte aligned
// (cp.async).
int paged_attention_decode(const void* q, const void* k, const void* v,
                           const int* tables, const int* pos, void* out,
                           float* part_acc, float* part_ml, int B, int Hq,
                           int Hkv, int D, int BS, int MB, int cols_per_split,
                           long long s_blk, long long s_tok, long long s_head,
                           int window, int dtype, void* stream) {
  return run(q, k, v, tables, pos, out, part_acc, part_ml, B, 1, Hq, Hkv, D,
             BS, MB, cols_per_split, s_blk, s_tok, s_head, window, dtype,
             true, stream);
}

int paged_attention_prefill(const void* q, const void* k, const void* v,
                            const int* tables, const int* start, void* out,
                            float* part_acc, float* part_ml, int B, int C,
                            int Hq, int Hkv, int D, int BS, int MB,
                            int cols_per_split, long long s_blk,
                            long long s_tok, long long s_head, int window,
                            int dtype, void* stream) {
  return run(q, k, v, tables, start, out, part_acc, part_ml, B, C, Hq, Hkv,
             D, BS, MB, cols_per_split, s_blk, s_tok, s_head, window, dtype,
             false, stream);
}

}  // extern "C"
