// Per-row symmetric int8 quantization of float32 rows, with an optional
// float32 LayerNorm in front: rowquant.cu's arithmetic, summation order
// and roundings, written once for gemm_i8.cu's LayerNorm mode (ln_gemm_i8)
// and dwconv_gelu.cu's quantizing body (dwconv_gelu_q8), so that they
// give rowquant's int8 values and scales bit for bit (chip_smoke.py's
// [int8-kernels] holds them so). rowquant.cu keeps its own copy, its
// code unchanged.
//
// Per row of K float32 values x:
//   y      = LN(x) (mean, then mean of squared deviations, eps 1e-5,
//            (x - mean) * rstd * scale + shift) or x itself
//   rscale = max(max|y|, 1e-8) * (1/127)
//   q      = round_half_even(y * (1 / rscale))    (int8)
// Each product and sum of the LayerNorm's output and of the quantization
// is an explicitly rounded float32 operation (`__fmul_rn`, `__fadd_rn`,
// `__fdiv_rn`), so nvcc cannot contract them into FMAs.
#pragma once

#include "common.cuh"

namespace qrow {

constexpr float LN_EPS = 1e-5f;

// four values quantized with 1 / rscale = inv, packed low byte first
__device__ __forceinline__ uint32_t quant4(const float4& v, float inv) {
  const int a = __float2int_rn(__fmul_rn(v.x, inv));
  const int b = __float2int_rn(__fmul_rn(v.y, inv));
  const int c = __float2int_rn(__fmul_rn(v.z, inv));
  const int d = __float2int_rn(__fmul_rn(v.w, inv));
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ float amax4(const float4& u) {
  return fmaxf(fmaxf(fabsf(u.x), fabsf(u.y)), fmaxf(fabsf(u.z), fabsf(u.w)));
}

// a row's scale from its |max|
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
}

__device__ __forceinline__ float ln1(float x, float mean, float rstd, float sc, float sh) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), sc), sh);
}

// a float4's part of a row's sum, and of its sum of squared deviations
__device__ __forceinline__ float sum4(const float4& u) { return (u.x + u.y) + (u.z + u.w); }
__device__ __forceinline__ float dev4(const float4& u, float mean) {
  const float d0 = u.x - mean, d1 = u.y - mean;
  const float d2 = u.z - mean, d3 = u.w - mean;
  return (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
}

__device__ __forceinline__ float4 ln4(float4 u, float mean, float rstd, const float4& sc,
                                      const float4& sh) {
  u.x = ln1(u.x, mean, rstd, sc.x, sh.x);
  u.y = ln1(u.y, mean, rstd, sc.y, sh.y);
  u.z = ln1(u.z, mean, rstd, sc.z, sh.z);
  u.w = ln1(u.w, mean, rstd, sc.w, sh.w);
  return u;
}

// One row of K float32 values quantized by one warp: the row at x, its
// int8 values to q (4-byte stores, a warp covering 128 contiguous bytes),
// its scale returned (every lane). ln_s / ln_b: the LayerNorm's float32
// (K,) scale and shift, or null for none. K % 4 == 0.
//
// Lane l holds the float4s l, l + 32, ... of the row, in registers for the
// first MAX_VEC of them, re-read past them for each pass (mean, variance,
// maximum, quantization; from L2 after the first). Each lane visits its
// values in the same order either way, and warp shuffles add the lanes'
// sums in a fixed order, so every MAX_VEC gives the same statistics and
// roundings, rowquant.cu's.
template <int MAX_VEC>
__device__ __forceinline__ float quant_row(const float* x, const float* __restrict__ ln_s,
                                           const float* __restrict__ ln_b, uint32_t* q, int K,
                                           int lane) {
  const int nv = (K / 4 - lane + 31) / 32;  // this lane's float4s of the row
  const bool ln = ln_s != nullptr;
  const float4* xr = reinterpret_cast<const float4*>(x);
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
      if (j < nv) s += sum4(v[j]);
    for (int j = MAX_VEC; j < nv; ++j) s += sum4(slot(j));
    mean = warp_sum(s) / K;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_VEC; ++j)
      if (j < nv) sq += dev4(v[j], mean);
    for (int j = MAX_VEC; j < nv; ++j) sq += dev4(slot(j), mean);
    rstd = rsqrtf(warp_sum(sq) / K + LN_EPS);
  }
  // the value quantized: LN(x) or x
  auto y = [&](float4 u, int j) {
    if (ln) {
      const int k = 4 * (32 * j + lane);
      u = ln4(u, mean, rstd, *reinterpret_cast<const float4*>(ln_s + k),
              *reinterpret_cast<const float4*>(ln_b + k));
    }
    return u;
  };
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j)
    if (j < nv) v[j] = y(v[j], j);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j)
    if (j < nv) amax = fmaxf(amax, amax4(v[j]));
  for (int j = MAX_VEC; j < nv; ++j) amax = fmaxf(amax, amax4(y(slot(j), j)));
  amax = warp_max(amax);
  const float r = row_scale(amax);
  const float inv = __fdiv_rn(1.0f, r);
#pragma unroll
  for (int j = 0; j < MAX_VEC; ++j)
    if (j < nv) q[32 * j + lane] = quant4(v[j], inv);
  for (int j = MAX_VEC; j < nv; ++j) q[32 * j + lane] = quant4(y(slot(j), j), inv);
  return r;
}

}  // namespace qrow
