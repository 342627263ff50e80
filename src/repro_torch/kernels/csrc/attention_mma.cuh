// Tensor-core building blocks of the flash and paged (decode and prefill)
// attention kernels (flash_attention.cu, paged_attention.cu) for Hopper
// (sm_90a).
//
// One warp owns 16 query rows and walks key tiles of BK = 64 keys staged
// in shared memory, all of each tile's keys or a share of them; warps that
// share rows fold their states together at the end (merge_parts). Both
// products run on the tensor cores through the mma.sync primitives of
// mma.cuh (three TF32 passes for f32 inputs, one
// bf16 pass for bf16; its header has the fragment layouts). One TF32 pass
// is ~1e-3 off at these shapes; tests/test_torch_flash_attention.py and
// test_torch_paged_attention.py emulate both on the CPU.
// Handing P (an accumulator) to P.V: for bf16 the accumulator pairs of two
// n8 tiles are exactly the A pairs of one k16 step. For tf32 they are not,
// so the k index of the k8 step is permuted (mma.cuh): A column t stands
// for key 2t and column t+4 for key 2t+1, and the B fragment is read from
// V rows 2t and 2t+1 to match.
//
// Shared memory. K and V tiles are [BK][LD] in the input type, rows padded
// (f32 LD = D + 4, bf16 LD = D + 8) so every fragment load of a warp hits
// 32 distinct banks; tiles arrive through 16-byte cp.async.cg into two
// buffers, the next tile loading while this one computes. A warp's Q
// fragments are staged once, in fragment order (f32: already split into hi
// and lo), so each k step reads them with one or two 16-byte loads.
//
// The online softmax keeps the TPU kernels' edge rules: masked scores are
// -1e30, m_safe = 0 while m <= -1e30 / 2, alpha = 0 from that state,
// probabilities are zeroed outside the mask, and the caller applies
// l == 0 -> 1. A row's scores lie in the four lanes of a quad: its max and
// sum take two __shfl_xor_sync steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;                 // keys per tile: 8 n8 tiles
constexpr unsigned FULL = 0xffffffffu;

using tc::cp_async16;
using tc::cp_commit;
using tc::cp_wait_one;
using tc::is_f32;
using tc::ldsm_x4_trans;
using tc::mma3;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::split;
using tc::to_f32;

// Row stride of a K/V tile in elements.
template <typename T, int D>
__host__ __device__ constexpr int ld_kv() { return is_f32<T>() ? D + 4 : D + 8; }

// 16-byte units of one warp's Q fragments.
template <typename T, int D>
__host__ __device__ constexpr int qfrag_u4() {
  return is_f32<T>() ? 2 * (D / 8) * 32 : (D / 16) * 32;
}

// Dynamic shared memory of a CTA of W warps: Q fragments, two buffers of
// K and V tiles, and two BK-long int vectors (the paged kernels' tile key
// positions).
template <typename T, int D, int W>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)W * qfrag_u4<T, D>() * 16 +
         (size_t)2 * 2 * BK * ld_kv<T, D>() * sizeof(T) + 2 * BK * sizeof(int);
}

// Copy BK rows of D elements into a [BK][LD] tile; row i comes from
// src(i), or is zero where src(i) is null (past the end, an unassigned
// table column), so a masked key never brings NaN into P.V. `async`:
// 16-byte cp.async (every row 16-byte aligned), else plain loads.
// NT: the CTA's threads.
template <typename T, int D, int NT, class Src>
__device__ __forceinline__ void load_tile(T* dst, Src src, bool async,
                                          const void* any) {
  constexpr int E = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int CH = D / E;            // chunks per row
  constexpr int LD = ld_kv<T, D>();
#pragma unroll 4
  for (int c = threadIdx.x; c < BK * CH; c += NT) {
    const int i = c / CH, u = c % CH;
    const T* s = src(i);
    T* d = dst + i * LD + u * E;
    if (async) {
      cp_async16(d, s ? s + u * E : nullptr, any);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = s ? s[u * E + e] : T(0.f);
    }
  }
}

// K and V tiles of a paged pool, whose K and V rows share one offset:
// row i of both comes from offset off(i) (elements, < 0: zeros), found once
// for the two copies. Always cp.async (the pool is 16-byte aligned).
template <typename T, int D, int NT, class Off>
__device__ __forceinline__ void load_kv_pair(T* kd, T* vd, const T* kp,
                                             const T* vp, Off off) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = D / E;
  constexpr int LD = ld_kv<T, D>();
  for (int c = threadIdx.x; c < BK * CH; c += NT) {
    const int i = c / CH, u = c % CH;
    const long long o = off(i);
    cp_async16(kd + i * LD + u * E, o < 0 ? nullptr : kp + o + u * E, kp);
    cp_async16(vd + i * LD + u * E, o < 0 ? nullptr : vp + o + u * E, vp);
  }
}

// Stage this warp's Q fragments: row(r) points at the warp's row r
// (0..15) or is null for a row past the end (zeros).
template <typename T, int D, class Row>
__device__ __forceinline__ void stage_q(uint4* qf, Row row) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* r0 = row(g);
  const T* r1 = row(g + 8);
  auto ld = [](const T* r, int d) { return r ? to_f32(r[d]) : 0.f; };
  if constexpr (is_f32<T>()) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float x[4] = {ld(r0, 8 * kk + t), ld(r1, 8 * kk + t),
                          ld(r0, 8 * kk + t + 4), ld(r1, 8 * kk + t + 4)};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], h[e], l[e]);
      qf[kk * 32 + lane] = make_uint4(h[0], h[1], h[2], h[3]);
      qf[(D / 8 + kk) * 32 + lane] = make_uint4(l[0], l[1], l[2], l[3]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int d = 16 * kk + 2 * t;
      qf[kk * 32 + lane] = make_uint4(
          pack_bf16(ld(r0, d), ld(r0, d + 1)),
          pack_bf16(ld(r1, d), ld(r1, d + 1)),
          pack_bf16(ld(r0, d + 8), ld(r0, d + 9)),
          pack_bf16(ld(r1, d + 8), ld(r1, d + 9)));
    }
  }
}

// The online-softmax state of one warp's 16 rows: this lane holds rows g
// (index 0) and g + 8 (index 1), output columns 8 n + 2 t and + 1.
template <typename T, int D>
struct WarpState {
  float o[D / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // Keys 8 jb .. 8 (jb + NJ) - 1 of one tile: ks / vs are [BK][LD]; only
  // the first `jmax` (1..NJ) of these NJ n8 tiles can hold a visible key;
  // vis(r, key) says whether row r (0 or 1, as above) sees tile key `key`;
  // MASK = false: every key of the first jmax n8 tiles is visible to every
  // row (vis is not called).
  template <int NJ, bool MASK, class Vis>
  __device__ __forceinline__ void step(const uint4* qf, const T* ks,
                                       const T* vs, int jb, int jmax,
                                       float scale, Vis vis) {
    constexpr int LD = ld_kv<T, D>();
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    ks += 8 * jb * LD;
    vs += 8 * jb * LD;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

    // S = Q K^T
    if constexpr (is_f32<T>()) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint4 h4 = qf[kk * 32 + lane], l4 = qf[(D / 8 + kk) * 32 + lane];
        const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w};
        const uint32_t al[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < jmax) {
            const T* kr = ks + (8 * j + g) * LD + 8 * kk + t;
            mma3(s[j], ah, al, kr[0], kr[4]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint4 a = qf[kk * 32 + lane];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < jmax) {
            const T* kr = ks + (8 * j + g) * LD + 16 * kk + 2 * t;
            mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kr),
                     *reinterpret_cast<const uint32_t*>(kr + 8));
          }
        }
      }
    }

    // mask, scale, row max
    uint32_t ok = 0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool v =
            j < jmax && (!MASK || vis(r, 8 * (jb + j) + 2 * t + (e & 1)));
        ok |= (uint32_t)v << (4 * j + e);
        s[j][e] = v ? s[j][e] * scale : NEG_INF;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float msafe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_cur = fmaxf(m[r], mx[r]);
      msafe[r] = m_cur <= NEG_INF / 2 ? 0.f : m_cur;
      alpha[r] = m[r] <= NEG_INF / 2 ? 0.f : expf(m[r] - msafe[r]);
      m[r] = m_cur;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            (ok >> (4 * j + e)) & 1u ? expf(s[j][e] - msafe[r]) : 0.f;
        s[j][e] = p;
        rs[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(FULL, rs[r], 1);
      rs[r] += __shfl_xor_sync(FULL, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {      // the max moved
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // O += P V
    if constexpr (is_f32<T>()) {
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        if (kk < jmax) {
          // A column t = key 2t, column t + 4 = key 2t + 1 (header note)
          uint32_t ah[4], al[4];
          split(s[kk][0], ah[0], al[0]);
          split(s[kk][2], ah[1], al[1]);
          split(s[kk][1], ah[2], al[2]);
          split(s[kk][3], ah[3], al[3]);
          const T* vr = vs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            mma3(o[n], ah, al, vr[8 * n], vr[LD + 8 * n]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        if (2 * kk < jmax) {
          const uint4 a = make_uint4(pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                     pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                     pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                     pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]));
          const T* vr = vs + (16 * kk + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < D / 8; n += 2) {
            uint32_t b[4];
            ldsm_x4_trans(b, vr + 8 * n);
            mma_bf16(o[n], a, b[0], b[1]);
            mma_bf16(o[n + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }

  // Fold in another warp's state over the same rows and other keys
  // (m_safe and alpha rules as in step).
  __device__ __forceinline__ void merge(const float (&o2)[D / 8][4],
                                        const float (&m2)[2],
                                        const float (&l2)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mm = fmaxf(m[r], m2[r]);
      const float ms = mm <= NEG_INF / 2 ? 0.f : mm;
      const float a1 = m[r] <= NEG_INF / 2 ? 0.f : expf(m[r] - ms);
      const float a2 = m2[r] <= NEG_INF / 2 ? 0.f : expf(m2[r] - ms);
      m[r] = mm;
      l[r] = a1 * l[r] + a2 * l2[r];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * r] = a1 * o[n][2 * r] + a2 * o2[n][2 * r];
        o[n][2 * r + 1] = a1 * o[n][2 * r + 1] + a2 * o2[n][2 * r + 1];
      }
    }
  }

  // Floats a lane hands over in merge_parts: its o, m and l.
  static constexpr int NV = D / 2 + 4;

  // The KSPLIT warps of a row group (parts 0 .. KSPLIT - 1) hold the same
  // 16 rows over different keys: parts 1.. hand their states to part 0
  // through `red`, (KSPLIT - 1) NV 32 floats of shared memory free for
  // reuse, laid out [part - 1][value][lane] so a warp's accesses are
  // consecutive; part 0 folds them in (merge). Every thread of the CTA
  // calls it (one __syncthreads); afterwards only part 0's state counts.
  template <int KSPLIT>
  __device__ __forceinline__ void merge_parts(float* red, int part) {
    red += threadIdx.x & 31;
    if (part > 0) {
      float* x = red + (part - 1) * NV * 32;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 * n + e) * 32] = o[n][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[(D / 2 + r) * 32] = m[r];
        x[(D / 2 + 2 + r) * 32] = l[r];
      }
    }
    __syncthreads();
    if (part > 0) return;
    for (int p = 1; p < KSPLIT; ++p) {
      const float* x = red + (p - 1) * NV * 32;
      float o2[D / 8][4], m2[2], l2[2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o2[n][e] = x[(4 * n + e) * 32];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m2[r] = x[(D / 2 + r) * 32];
        l2[r] = x[(D / 2 + 2 + r) * 32];
      }
      merge(o2, m2, l2);
    }
  }
};

}  // namespace attn
