// dwconv_gelu_bwd: backward of GELU(3x3 depthwise(h) + dwb) on the token grid.
//
// Replaces the depthwise and GELU backward of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
// (:179-187): dc = da * GELU'(c); ddwb = sum dc; the 9 tap gradients
// sum h[p + (di-1, dj-1)] dc[p] (`_dw_tap_grads`, ops/fused_mlp_vjp.py:100);
// the input gradient dhid = the 3x3 correlation of dc with the flipped taps
// (`_dw_input_grad`, :95); db1 = sum dhid (float32, before the bf16
// rounding that the weight-gradient products see).
//
// What bounds it on the H100: per element it reads da, c and h (float32,
// 12 bytes) and writes dhid (bf16, 2 bytes), against ~40 FLOP and one erf
// and one exp: memory-bound (3.35 TB/s).
//
// What this design does about that: one block per (image, 32 channels)
// stages dc (computed once per element from da and c) and h for the whole
// hw x hw grid in shared memory with a zero ring (2 x 18 x 18 x 32 float32
// = 83 KB at hw = 16), so device memory sees one read per input element
// and the 9 neighbour reads of every output come from shared memory. A
// thread owns 4 channels (16-byte accesses) and keeps their flipped taps
// in registers while it walks over pixels, accumulating its share of the
// 9 tap sums, ddwb and db1. The 32 threads of a channel group then add
// their sums in a fixed order through shared memory, and the block writes
// one partial row per image; colsum (gemm_bwd.cu) sums the images, so no
// atomics. GELU' is exact: Phi(c) + c phi(c) with `erff` and `expf`, the
// derivative of the exact GELU the forward uses. The input gradient sums
// in the TPU kernel's order (row taps per column shift, then the shifts).
//
// Two bodies, one per template flag, as dwconv_gelu.cu has. The whole-grid
// body (above) holds two (hw+2)^2 x 32 float32 slabs, up to hw = 28 within
// the 227 KB a block may use. The row-band body serves larger grids, such as
// the backward of the hi-res sep-conv MLP (TPU kernel
// transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py::_pallas_bwd,
// `_bwd_kernel` :135-179, at hw = 32, where the whole grid's 296 KB would
// not fit): one block per (32 channels, band of `band` grid rows, image)
// stages dc and h of the band plus a one-row halo above and below,
// 2 x (band+2) x (hw+2) x 32 float32 (87 KB for 8 rows at hw = 32, two
// blocks per SM). The halo's dc is recomputed from da and c by both blocks
// that read it, so device memory sees (band+2)/band reads per input
// element. Each block writes one partial row per (image, band), and colsum
// sums those; the arithmetic and its order are the whole-grid body's. The
// wrapper (ops/fused_layer_vjp.py::dwconv_gelu_bwd_body) takes the whole
// grid where it fits and bands of 8 rows beyond (up to hw = 88).
//
// c and h are float32 on the training path; the "bf16res" backward of the
// probe scripts/probe_train_bwd_stage.py (`pallas_bwd_variant`,
// pallas_call at :259), which keeps its residuals in bf16, passes them in
// bf16 (a template parameter, whole-grid body; they are widened to float32
// as they are staged, and the arithmetic is the same).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;     // channels per thread (16 bytes of float32)
constexpr int CHUNK = 32;  // channels per block
constexpr int GROUPS = CHUNK / VEC;
constexpr int PIX = THREADS / GROUPS;  // pixels in flight
constexpr int NSUM = 11;               // 9 taps, ddwb, db1

inline size_t smem_bytes(int rows, int hw) {
  const size_t tiles = 2 * static_cast<size_t>(rows + 2) * (hw + 2) * CHUNK * sizeof(float);
  const size_t red = static_cast<size_t>(NSUM) * VEC * THREADS * sizeof(float);
  return tiles > red ? tiles : red;
}

__device__ __forceinline__ float gelu_grad(float c) {
  const float cdf = 0.5f * (1.f + erff(c * 0.70710678118654752f));
  const float pdf = expf(-0.5f * c * c) * 0.39894228040143268f;
  return cdf + c * pdf;
}

// four consecutive channels as float32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <bool BAND, typename IT>
__global__ void __launch_bounds__(THREADS)
dwconv_gelu_bwd_kernel(const float* __restrict__ da, const IT* __restrict__ cpre,
                       const IT* __restrict__ h, const bf16* __restrict__ dw,
                       bf16* __restrict__ dhid, float* __restrict__ partial, int hw, int C,
                       int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pw = hw + 2;
  const int c0 = blockIdx.x * CHUNK;
  // whole grid: blockIdx.y is the image; row band: the band, and blockIdx.z the image
  const int b = BAND ? blockIdx.z : blockIdx.y;
  const int r0 = BAND ? blockIdx.y * band : 0;
  const int rows = BAND ? min(band, hw - r0) : hw;
  const size_t part = BAND ? static_cast<size_t>(b) * gridDim.y + blockIdx.y : b;  // partial row
  float4* dcs = reinterpret_cast<float4*>(smem);  // [(rows+2) * pw][GROUPS]
  float4* hs = dcs + (rows + 2) * pw * GROUPS;
  const size_t img = static_cast<size_t>(b) * hw * hw;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < (rows + 2) * pw * GROUPS; idx += THREADS) {
    const int grp = idx % GROUPS, p = idx / GROUPS;
    const int i = r0 + p / pw - 1, j = p % pw - 1;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f), hv = d;
    if (i >= 0 && i < hw && j >= 0 && j < hw) {
      const size_t at = (img + i * hw + j) * C + c0 + grp * VEC;
      const float4 a = *reinterpret_cast<const float4*>(da + at);
      const float4 c = load4(cpre + at);
      d = make_float4(a.x * gelu_grad(c.x), a.y * gelu_grad(c.y), a.z * gelu_grad(c.z),
                      a.w * gelu_grad(c.w));
      hv = load4(h + at);
    }
    dcs[idx] = d;
    hs[idx] = hv;
  }

  const int grp = tid % GROUPS;
  const int c = c0 + grp * VEC;
  float w[9][VEC];  // flipped: w[t] is tap 8 - t
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const uint2 u = *reinterpret_cast<const uint2*>(dw + (8 - t) * C + c);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    w[t][0] = lo.x, w[t][1] = lo.y, w[t][2] = hi.x, w[t][3] = hi.y;
  }
  float sums[NSUM][VEC];
#pragma unroll
  for (int q = 0; q < NSUM; ++q)
#pragma unroll
    for (int e = 0; e < VEC; ++e) sums[q][e] = 0.f;
  __syncthreads();

  for (int p = tid / GROUPS; p < rows * hw; p += PIX) {
    const int i = p / hw, j = p % hw;  // i counts rows from the band's first
    float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
    const float4 dc4 = dcs[((i + 1) * pw + (j + 1)) * GROUPS + grp];
    const float dcv[VEC] = {dc4.x, dc4.y, dc4.z, dc4.w};
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      float z[VEC] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int at = ((i + di) * pw + (j + dj)) * GROUPS + grp;
        const float4 v = dcs[at];
        const float4 hv = hs[at];
        const float vv[VEC] = {v.x, v.y, v.z, v.w};
        const float hh[VEC] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          z[e] += vv[e] * w[di * 3 + dj][e];
          sums[di * 3 + dj][e] += hh[e] * dcv[e];
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += z[e];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sums[9][e] += dcv[e];
      sums[10][e] += acc[e];
    }
    uint2 o;
    o.x = pack_bf16x2(acc[0], acc[1]);
    o.y = pack_bf16x2(acc[2], acc[3]);
    *reinterpret_cast<uint2*>(dhid + (img + static_cast<size_t>(r0) * hw + p) * C + c) = o;
  }

  // the 32 threads of each channel group add their sums in a fixed order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [NSUM * VEC][THREADS]
#pragma unroll
  for (int q = 0; q < NSUM; ++q)
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[(q * VEC + e) * THREADS + tid] = sums[q][e];
  __syncthreads();
  for (int o = tid; o < NSUM * CHUNK; o += THREADS) {
    const int q = o / CHUNK, ch = o % CHUNK;
    const float* row = red + (q * VEC + ch % VEC) * THREADS + ch / VEC;
    float t = 0.f;
    for (int l = 0; l < PIX; ++l) t += row[l * GROUPS];
    partial[(part * NSUM + q) * C + c0 + ch] = t;
  }
}

template <bool BAND, typename IT>
int launch(const float* da, const void* c, const void* h, const void* dw, void* dhid,
           float* partial, int B, int hw, int C, int band, cudaStream_t s) {
  const size_t smem = smem_bytes(BAND ? band : hw, hw);
  cudaError_t err = cudaFuncSetAttribute(dwconv_gelu_bwd_kernel<BAND, IT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = BAND ? dim3(C / CHUNK, (hw + band - 1) / band, B) : dim3(C / CHUNK, B);
  dwconv_gelu_bwd_kernel<BAND, IT><<<grid, THREADS, smem, s>>>(
      da, static_cast<const IT*>(c), static_cast<const IT*>(h), static_cast<const bf16*>(dw),
      static_cast<bf16*>(dhid), partial, hw, C, band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// da: (B*hw*hw, C) float32 token rows of a row-major hw x hw grid (the
// upstream gradient of the GELU output); c, h: the same rows of the
// pre-GELU values and the convolution's input, float32, or bf16 when
// in_bf16 is non-zero (whole-grid body only). dw: (9, C) bf16 taps, tap
// di*3+dj. dhid: (B*hw*hw, C) bf16. band: 0 for the whole-grid body, else
// the grid rows of each block of the row-band body. partial: (B, 11, C)
// float32 for the whole grid, (B, ceil(hw / band), 11, C) for bands: per
// image (and band) the 9 tap gradients, ddwb and db1. Requires C % 32 == 0
// and the body's slabs within 227 KB (see the header).
LTD_API int ltd_dwconv_gelu_bwd(const float* da, const void* c, const void* h, const void* dw,
                                void* dhid, float* partial, int B, int hw, int C, int band,
                                int in_bf16, void* stream) {
  if (C % CHUNK || band < 0 || (in_bf16 && band > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch<false, bf16>(da, c, h, dw, dhid, partial, B, hw, C, 0, s);
  return band > 0 ? launch<true, float>(da, c, h, dw, dhid, partial, B, hw, C, band, s)
                  : launch<false, float>(da, c, h, dw, dhid, partial, B, hw, C, 0, s);
}
