// Shared helpers of the decoder-layer kernels (csrc/*.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define LTD_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Two floats -> one register of two bf16 (round to nearest even), low half first.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 8 floats -> 8 bf16 (round to nearest even) packed into 16 bytes.
__device__ __forceinline__ uint4 pack8_bf16(const float* v) {
  uint4 r;
  __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
  __nv_bfloat162 p2 = __floats2bfloat162_rn(v[4], v[5]);
  __nv_bfloat162 p3 = __floats2bfloat162_rn(v[6], v[7]);
  r.x = *reinterpret_cast<uint32_t*>(&p0);
  r.y = *reinterpret_cast<uint32_t*>(&p1);
  r.z = *reinterpret_cast<uint32_t*>(&p2);
  r.w = *reinterpret_cast<uint32_t*>(&p3);
  return r;
}
