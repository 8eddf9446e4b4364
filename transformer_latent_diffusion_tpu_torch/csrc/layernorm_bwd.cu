// layernorm_bwd: dx = upstream + LayerNorm backward of dy, with partial dscale / dbias.
//
// Replaces `_ln_bwd` (transformer_latent_diffusion_tpu/ops/fused_attn_vjp.py:59-69)
// and the residual adds that follow it in
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
// (:189-192 dx2 = g + dx2_ln, :216-219, :240-243). The TPU kernel keeps the
// forward's xhat and rstd in VMEM from its recompute; here they are
// recomputed from the float32 LayerNorm input x, which the recompute keeps
// anyway, so nothing extra is stored.
//
// What bounds it on the H100: per element it reads dy, x and the upstream
// gradient (float32, 12 bytes) and writes dx (4 bytes), against ~15 FLOP:
// memory-bound (3.35 TB/s).
//
// What this design does about that: one warp per row (D <= 1024, so a row
// is at most 32 values per lane, held in registers; a template parameter
// holds 24 up to D = 768, the flagship's width, and 32 beyond; the lanes'
// sums run over their values in the same order for either), each element
// read once with 16-byte loads. Mean and variance in float32, two passes
// over the registers, eps 1e-5, exactly the forward's statistics;
// dxhat = dy * scale; dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat
// xhat)). dscale = sum dy xhat and dbias = sum dy over rows are summed per
// warp over its ROWS_PER_WARP rows and written as one partial row per warp;
// colsum (gemm_bwd.cu) adds the partials in a fixed order, so the result
// is deterministic and needs no atomics.
//
// x is float32 on the training path; the "bf16res" backward of the probe
// scripts/probe_train_bwd_stage.py (`pallas_bwd_variant`, pallas_call at
// :259), which keeps its residuals in bf16, passes a bf16 x (a template
// parameter: the statistics and xhat are then those of the rounded rows).

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 32;
constexpr float LN_EPS = 1e-5f;

// four consecutive elements of x as float32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename XT, int MAX_V>  // MAX_V: float4 per lane (D <= 128 MAX_V)
__global__ void __launch_bounds__(WARPS * 32)
layernorm_bwd_kernel(const float* __restrict__ dy, const XT* __restrict__ x,
                     const float* __restrict__ scale, const float* __restrict__ upstream,
                     float* __restrict__ dx, float* __restrict__ partial, int M, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * WARPS + warp;
  const int r0 = wid * ROWS_PER_WARP;
  const int r1 = min(M, r0 + ROWS_PER_WARP);
  if (r0 >= M) return;  // past the last partial row
  float4 ds[MAX_V], db[MAX_V], sc[MAX_V];
#pragma unroll
  for (int j = 0; j < MAX_V; ++j) {
    ds[j] = db[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int k = j * 128 + lane * 4;
    sc[j] = k < D ? *reinterpret_cast<const float4*>(scale + k) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r = r0; r < r1; ++r) {
    const size_t off = static_cast<size_t>(r) * D;
    float4 xv[MAX_V], gv[MAX_V];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_V; ++j) {
      const int k = j * 128 + lane * 4;
      const bool in = k < D;
      xv[j] = in ? load4(x + off + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      gv[j] = in ? *reinterpret_cast<const float4*>(dy + off + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (xv[j].x + xv[j].y) + (xv[j].z + xv[j].w);
    }
    const float mean = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_V; ++j) {
      if (j * 128 + lane * 4 < D) {
        const float d0 = xv[j].x - mean, d1 = xv[j].y - mean;
        const float d2 = xv[j].z - mean, d3 = xv[j].w - mean;
        q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
    // xhat replaces x in xv; m1, m2: the row means of dxhat and dxhat * xhat
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_V; ++j) {
      if (j * 128 + lane * 4 < D) {
        float4& xh = xv[j];
        xh.x = (xh.x - mean) * rstd;
        xh.y = (xh.y - mean) * rstd;
        xh.z = (xh.z - mean) * rstd;
        xh.w = (xh.w - mean) * rstd;
        const float4 g = gv[j];
        ds[j].x += g.x * xh.x;
        ds[j].y += g.y * xh.y;
        ds[j].z += g.z * xh.z;
        ds[j].w += g.w * xh.w;
        db[j].x += g.x;
        db[j].y += g.y;
        db[j].z += g.z;
        db[j].w += g.w;
        const float e0 = g.x * sc[j].x, e1 = g.y * sc[j].y, e2 = g.z * sc[j].z,
                    e3 = g.w * sc[j].w;
        m1 += (e0 + e1) + (e2 + e3);
        m2 += (e0 * xh.x + e1 * xh.y) + (e2 * xh.z + e3 * xh.w);
      }
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int j = 0; j < MAX_V; ++j) {
      const int k = j * 128 + lane * 4;
      if (k < D) {
        const float4 u = *reinterpret_cast<const float4*>(upstream + off + k);
        const float4 g = gv[j], xh = xv[j];
        float4 o;
        o.x = u.x + rstd * (g.x * sc[j].x - m1 - xh.x * m2);
        o.y = u.y + rstd * (g.y * sc[j].y - m1 - xh.y * m2);
        o.z = u.z + rstd * (g.z * sc[j].z - m1 - xh.z * m2);
        o.w = u.w + rstd * (g.w * sc[j].w - m1 - xh.w * m2);
        *reinterpret_cast<float4*>(dx + off + k) = o;
      }
    }
  }
  // this warp's partial sums: row wid of (warps, 2, D)
  float* p = partial + static_cast<size_t>(wid) * 2 * D;
#pragma unroll
  for (int j = 0; j < MAX_V; ++j) {
    const int k = j * 128 + lane * 4;
    if (k < D) {
      *reinterpret_cast<float4*>(p + k) = ds[j];
      *reinterpret_cast<float4*>(p + D + k) = db[j];
    }
  }
}

template <int V>
void launch(const float* dy, const void* x, const float* scale, const float* upstream, float* dx,
            float* partial, int M, int D, bool x_bf16, int blocks, cudaStream_t s) {
  if (x_bf16)
    layernorm_bwd_kernel<bf16, V><<<blocks, WARPS * 32, 0, s>>>(
        dy, static_cast<const bf16*>(x), scale, upstream, dx, partial, M, D);
  else
    layernorm_bwd_kernel<float, V><<<blocks, WARPS * 32, 0, s>>>(
        dy, static_cast<const float*>(x), scale, upstream, dx, partial, M, D);
}

}  // namespace

// dy, upstream, dx: (M, D) float32, dx not aliasing the inputs; x: (M, D)
// float32, or bf16 when x_bf16 is non-zero; scale: (D,) float32; partial:
// (ceil(M / 32), 2, D) float32, per 32 rows the sums of dy * xhat (dscale)
// and of dy (dbias). Requires D % 4 == 0 and D <= 1024.
LTD_API int ltd_layernorm_bwd(const float* dy, const void* x, const float* scale,
                              const float* upstream, float* dx, float* partial, int M, int D,
                              int x_bf16, void* stream) {
  if (D % 4 || D > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = (M + ROWS_PER_WARP - 1) / ROWS_PER_WARP;
  const int blocks = (warps + WARPS - 1) / WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 768)
    launch<6>(dy, x, scale, upstream, dx, partial, M, D, x_bf16 != 0, blocks, s);
  else
    launch<8>(dy, x, scale, upstream, dx, partial, M, D, x_bf16 != 0, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
