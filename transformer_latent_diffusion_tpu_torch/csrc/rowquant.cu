// rowquant: per-row symmetric int8 quantization of float32 rows, with an
// optional float32 LayerNorm in front.
//
// Replaces the activation quantization of
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel:
// `_rowquant` (:48-53) of the LN1, LN2 and LN3 outputs (`_ln_f32`,
// ops/fused_block.py:40-43; fused_stack_int8.py:80, 85, 91) and of the
// float32 GELU output over its full 3072-wide row (:99). The W8A8 layer
// now quantizes those rows inside its fused kernels (gemm_i8.cu's
// LayerNorm mode, ln_gemm_i8, for LN1-3; dwconv_gelu.cu's dwconv_gelu_q8
// for the GELU row), with this kernel's arithmetic and order
// (quant_row.cuh holds them for those kernels; the smoke holds their int8
// rows and scales bit-equal to this kernel's); this kernel stays for the
// probe S1 (scripts/microbench_int8.py), which quantizes its rows on their
// own.
//
// What it computes, per row of K float32 values x:
//   y      = LN(x) (mean, then mean of squared deviations, eps 1e-5,
//            (x - mean) * rstd * scale + shift) or x itself
//   rscale = max(max|y|, 1e-8) * (1/127)
//   q      = round_half_even(y * (1 / rscale))    (int8)
// Each product and sum of the LayerNorm's output and of the quantization
// is an explicitly rounded float32 operation (`__fmul_rn`, `__fadd_rn`,
// `__fdiv_rn`), so nvcc cannot contract them into FMAs: the plain version
// (ops/fused_stack_int8.py::rowquant_plain) rounds at the same points, and
// only the LayerNorm statistics (summed in another order) can move a value
// by one float32 step and so, rarely, an int8 value by one.
//
// What bounds it on the H100: a handful of operations per element against
// 5 bytes moved (float32 in, int8 out): memory-bound (3.35 TB/s).
//
// What this design does about that: one warp per row reads the row once
// into registers (lane l holds the float4s l, l + 32, ...; up to K = 3072,
// 24 float4 a lane), takes the statistics and the absolute maximum with
// warp shuffles, and writes the int8 row with 4-byte stores (a warp covers
// 128 contiguous bytes) and the row's scale. Nothing is read twice and
// nothing but the int8 row and its scale is written. A wider row (the GELU
// output at D = 1024 is 4096 wide) keeps its first 3072 values in
// registers and reads the rest again for each pass (mean, variance,
// maximum, quantization), from L2 after the first; each lane visits its
// values in the same order either way, so the sums and the roundings are
// those of the register path.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps, one row each
constexpr int MAX_VEC = 24;   // float4s a lane holds: K <= 3072 in registers
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ uint32_t quant4(const float4& v, float inv) {
  const int a = __float2int_rn(__fmul_rn(v.x, inv));
  const int b = __float2int_rn(__fmul_rn(v.y, inv));
  const int c = __float2int_rn(__fmul_rn(v.z, inv));
  const int d = __float2int_rn(__fmul_rn(v.w, inv));
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ float ln1(float x, float mean, float rstd, float sc, float sh) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), sc), sh);
}

__global__ void __launch_bounds__(THREADS)
rowquant_kernel(const float* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, int8_t* __restrict__ q,
                float* __restrict__ rscale, int M, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= M) return;
  // slot j of this lane: float4 32 j + lane of the row, for j < nv (all
  // lanes alike when K % 128 == 0); in registers for j < MAX_VEC, re-read
  // past them
  const int nv = (K / 4 - lane + 31) / 32;
  const float4* xr = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * K);
  const bool ln = ln_s != nullptr;
  float4 v[MAX_VEC];
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j)
    if (j < nv) v[j] = xr[32 * j + lane];
  auto slot = [&](int j) { return xr[32 * j + lane]; };

  float mean = 0.f, rstd = 0.f;
  if (ln) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_VEC; ++j)
      if (j < nv) s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    for (int j = MAX_VEC; j < nv; ++j) {
      const float4 u = slot(j);
      s += (u.x + u.y) + (u.z + u.w);
    }
    mean = warp_sum(s) / K;
    float sq = 0.f;
    auto dev2 = [&](const float4& u) {
      const float d0 = u.x - mean, d1 = u.y - mean;
      const float d2 = u.z - mean, d3 = u.w - mean;
      return (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    };
#pragma unroll
    for (int j = 0; j < MAX_VEC; ++j)
      if (j < nv) sq += dev2(v[j]);
    for (int j = MAX_VEC; j < nv; ++j) sq += dev2(slot(j));
    rstd = rsqrtf(warp_sum(sq) / K + LN_EPS);
  }
  // the value quantized: LN(x) or x
  auto y = [&](float4 u, int j) {
    if (ln) {
      const int k = 4 * (32 * j + lane);
      const float4 sc = *reinterpret_cast<const float4*>(ln_s + k);
      const float4 sh = *reinterpret_cast<const float4*>(ln_b + k);
      u.x = ln1(u.x, mean, rstd, sc.x, sh.x);
      u.y = ln1(u.y, mean, rstd, sc.y, sh.y);
      u.z = ln1(u.z, mean, rstd, sc.z, sh.z);
      u.w = ln1(u.w, mean, rstd, sc.w, sh.w);
    }
    return u;
  };
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j)
    if (j < nv) v[j] = y(v[j], j);

  auto amax4 = [](const float4& u) {
    return fmaxf(fmaxf(fabsf(u.x), fabsf(u.y)), fmaxf(fabsf(u.z), fabsf(u.w)));
  };
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j)
    if (j < nv) amax = fmaxf(amax, amax4(v[j]));
  for (int j = MAX_VEC; j < nv; ++j) amax = fmaxf(amax, amax4(y(slot(j), j)));
  amax = warp_max(amax);
  const float rs = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  const float inv = __fdiv_rn(1.0f, rs);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + static_cast<size_t>(row) * K);
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j)
    if (j < nv) qr[32 * j + lane] = quant4(v[j], inv);
  for (int j = MAX_VEC; j < nv; ++j) qr[32 * j + lane] = quant4(y(slot(j), j), inv);
  if (lane == 0) rscale[row] = rs;
}

}  // namespace

// x: (M, K) float32 rows. ln_s, ln_b: (K,) float32, or both null for no
// LayerNorm. q: (M, K) int8 out; rscale: (M,) float32 out. Requires
// K % 4 == 0 (16-byte rows: K % 16 == 0 for the int8 product's maps).
LTD_API int ltd_rowquant(const float* x, const float* ln_s, const float* ln_b, void* q,
                         float* rscale, int M, int K, void* stream) {
  if (K < 4 || K % 4 || (ln_s == nullptr) != (ln_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = THREADS / 32;
  rowquant_kernel<<<(M + rows - 1) / rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ln_s, ln_b, static_cast<int8_t*>(q), rscale, M, K);
  return static_cast<int>(cudaGetLastError());
}
