// dwconv_gelu: act = bf16(GELU(3x3 depthwise(h) + dwb)) on the token grid.
//
// Replaces the depthwise convolution and GELU of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (fused_stack.py:84-88: `_dw_fwd` from ops/fused_mlp_vjp.py:68 and
// `_gelu_exact` from ops/fused_block.py:60).
//
// What bounds it on the H100: 9 multiply-adds and one erf per element
// against 4 bytes moved (bf16 in, bf16 out): memory-bound (3.35 TB/s).
//
// What this design does about that: one block per (image, 64 channels)
// copies that slab of the whole hw x hw grid into shared memory once, with
// a ring of zeros as the padding (18 x 18 x 64 bf16 = 41 KB at hw = 16), so
// device memory sees exactly one read and one write per element and the 9
// neighbour reads of every output come from shared memory. Each thread owns
// 8 channels (16-byte loads and stores; a warp reads 512 contiguous bytes
// of shared memory, conflict-free) and keeps their 9 taps and bias in
// registers while it walks over pixels. Everything in float32 in the TPU
// kernel's summation order (row taps per column shift first, then the three
// column shifts), + dwb, then the exact erf GELU (`erff`; the TPU kernel's
// polynomial only stood in for a missing erf), rounded to bf16 once.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;     // channels per thread (16 bytes of bf16)
constexpr int CHUNK = 64;  // channels per block
constexpr int GROUPS = CHUNK / VEC;

inline size_t smem_bytes(int hw) {
  return static_cast<size_t>(hw + 2) * (hw + 2) * CHUNK * sizeof(bf16);
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(p[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

__global__ void __launch_bounds__(THREADS)
dwconv_gelu_kernel(const bf16* __restrict__ h, const bf16* __restrict__ dw,
                   const float* __restrict__ dwb, bf16* __restrict__ out, int hw, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tile = reinterpret_cast<uint4*>(smem);  // [(hw+2) * (hw+2)][GROUPS]
  const int pw = hw + 2;
  const int c0 = blockIdx.x * CHUNK;
  const size_t b = blockIdx.y;
  const bf16* hb = h + b * hw * hw * C + c0;
  bf16* ob = out + b * hw * hw * C + c0;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < pw * pw * GROUPS; idx += THREADS) {
    const int grp = idx % GROUPS, p = idx / GROUPS;
    const int i = p / pw - 1, j = p % pw - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i >= 0 && i < hw && j >= 0 && j < hw)
      v = *reinterpret_cast<const uint4*>(hb + static_cast<size_t>(i * hw + j) * C + grp * VEC);
    tile[idx] = v;
  }

  const int grp = tid % GROUPS;
  const int c = c0 + grp * VEC;
  float w[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t) unpack8(*reinterpret_cast<const uint4*>(dw + t * C + c), w[t]);
  const float4 b0 = *reinterpret_cast<const float4*>(dwb + c);
  const float4 b1 = *reinterpret_cast<const float4*>(dwb + c + 4);
  const float bias[VEC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  __syncthreads();

  for (int p = tid / GROUPS; p < hw * hw; p += THREADS / GROUPS) {
    const int i = p / hw, j = p % hw;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    // z[dj] at column j + dj - 1: the three row taps of column shift dj
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      float z[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) z[e] = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        float v[VEC];
        unpack8(tile[((i + di) * pw + (j + dj)) * GROUPS + grp], v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) z[e] += v[e] * w[di * 3 + dj][e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += z[e];
    }
    float g[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float x = acc[e] + bias[e];
      g[e] = 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    }
    *reinterpret_cast<uint4*>(ob + static_cast<size_t>(p) * C + grp * VEC) = pack8_bf16(g);
  }
}

}  // namespace

// h, out: (B*hw*hw, C) bf16 token rows of a row-major hw x hw grid.
// dw: (9, C) bf16 taps, tap di*3+dj. dwb: (C,) float32.
// Requires C % 64 == 0 and hw <= 32.
LTD_API int ltd_dwconv_gelu(const void* h, const void* dw, const float* dwb, void* out, int B,
                            int hw, int C, void* stream) {
  const size_t smem = smem_bytes(hw);
  cudaError_t err = cudaFuncSetAttribute(
      dwconv_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dwconv_gelu_kernel<<<dim3(C / CHUNK, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(dw), dwb, static_cast<bf16*>(out), hw,
      C);
  return static_cast<int>(cudaGetLastError());
}
