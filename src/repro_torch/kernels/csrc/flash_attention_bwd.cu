// Backward pass of flash attention (design, bound and interface in
// flash_attention_bwd.cuh): the C entry and the f32 instantiation.
#include "flash_attention_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and dq, dk, dv all of
// it; lse and dsum f32). Strides are in elements; o and dout contiguous;
// lse the forward's [B Hq, S]; S query rows at positions q_offset .. over
// Sk keys (Sk == S and q_offset 0: self-attention); groups 0 (the shape
// rule above), 4 or 2. Returns a cudaError_t (0 = launched).
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, void* dk, void* dv, void* dsum, int B,
                             int S, int Hq, int Hkv, int D, long long qb,
                             long long qs, long long qh, long long kb,
                             long long ks, long long kh, long long vb,
                             long long vs, long long vh, int causal,
                             int window, int Sk, int q_offset, int groups,
                             int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || q_offset < 0 || Hkv <= 0 ||
      Hq % Hkv != 0 || window < 0 ||
      (long long)B * Hq > 65535 ||
      (groups != 0 && groups != 2 && groups != 4) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // cp.async needs every streamed row 16-byte aligned (o and dout are
  // contiguous rows of D elements, D a multiple of 8)
  const long long al = dtype == 0 ? 4 : 8;
  const int async = (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                    (uintptr_t)v % 16 == 0 && (uintptr_t)dout % 16 == 0 &&
                    qb % al == 0 && qs % al == 0 && qh % al == 0 &&
                    kb % al == 0 && ks % al == 0 && kh % al == 0 &&
                    vb % al == 0 && vs % al == 0 && vh % al == 0;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(dsum), S, Sk, q_offset, Hq, Hkv, Hq / Hkv, qb,
         qs, qh, kb, ks, kh, vb, vs, vh, causal, window, async,
         1.f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, groups, s);
  return flash_bwd::launch_bf16(a, B, D, groups, s);
}

}  // extern "C"
