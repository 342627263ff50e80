// Tensor-core and copy primitives for Hopper (sm_90a), shared by the
// attention kernels (through attention_mma.cuh), the grouped matmul and the
// SSD scan.
//
// Products run on mma.sync (inline PTX):
//   * f32 inputs: m16n8k8 TF32 in three passes. Each f32 operand x is
//     split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round to
//     nearest on the 10-bit mantissa) and a product is
//     lo.hi' + hi.lo' + hi.hi', which keeps f32 accuracy where one TF32
//     pass is ~1e-3 off (the CPU tests emulate both).
//   * bf16 inputs: m16n8k16 bf16 with f32 accumulation, one pass.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8/k16"),
// lane = 4 g + t:
//   accumulator m16n8: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   tf32 A m16k8:      a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   tf32 B k8n8:       b0 (t, g), b1 (t+4, g)
//   bf16 A m16k16:     pairs (g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   bf16 B k16n8:      pairs (2t.., g), (2t+8.., g)
// An accumulator handed on as the A operand of a tf32 product keeps its
// registers: A column t stands for accumulator column 2t and column t + 4
// for 2t + 1, and the B fragment is read from rows 2t and 2t + 1 to match
// (the sum over k is the same; no shuffle, no staging).
//
// Copies: 16-byte cp.async.cg from global to shared memory, zero-filled
// where the source is null.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__host__ __device__ constexpr bool is_f32() { return sizeof(T) == 4; }

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The split of the grouped-matmul and SSD kernels, in fewer instructions:
// hi by integer arithmetic on the bits (adding half a TF32 ulp to the
// magnitude and clearing the 13 low bits rounds to nearest, ties away from
// zero, exactly as cvt.rna does for finite x) and lo = x - hi handed over
// as it is: the tensor cores read the top 19 bits of a TF32 operand and
// drop the rest (tools/mma_probe.py shows it: 1 + 3 2^-12 multiplies as
// 1), so lo is truncated to TF32, off by at most 2^-21 |x|.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_int(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in three TF32 passes (lo.hi + hi.lo + hi.hi), b already
// split into (h0, h1) and (l0, l1).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t h0,
                                     uint32_t h1, uint32_t l0, uint32_t l1) {
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

// c += a . b in three TF32 passes; b given as f32 and split here.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma3(c, ah, al, h0, h1, l0, l1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices, transposed: the B fragments of two n8 tiles.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared; zeros when src is null (src-size 0 reads
// nothing; `any` is a valid global address for the instruction).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           const void* any) {
  const void* from = src ? src : any;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(from), "r"(src ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tc
