// Backward pass of flash attention (flash_attention_bwd.cuh): the bf16
// instantiation, its own source so it compiles beside the f32 one.
#include "flash_attention_bwd.cuh"

int flash_bwd::launch_bf16(const Args& a, int B, int D, int groups,
                           cudaStream_t s) {
  return dispatch<__nv_bfloat16>(a, B, D, groups, s);
}
