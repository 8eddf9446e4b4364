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
//
// The training layer (TPU kernel
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_mlp_fwd,
// :99-112) keeps the expanded hidden state h and the convolution's output
// c in float32 and rounds only the GELU output to bf16; for it the kernel
// is instantiated with float32 input (the slab in shared memory is then
// 83 KB) and optionally also stores c (float32), which the backward reads
// for GELU'(c).
//
// The W8A8 engine (TPU kernel
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel,
// :92-99) feeds the float32 hidden state and quantizes the GELU output in
// float32 (ops/fused_stack_int8.py: rowquant.cu reads it), so `out_f32`
// stores the GELU output as float32, unrounded (twice the bytes out).
//
// Two bodies, one per template flag. The whole-grid body (above; one block
// per (image, 64 channels)) holds a (hw+2)^2 x 64 slab: bf16 up to hw = 40,
// float32 up to hw = 28 within the 227 KB a block may use. The row-band
// body serves larger grids, such as the float32 hidden state of the hi-res
// sep-conv MLP (TPU kernel
// transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py::_pallas_fwd,
// :182-205, at hw = 32: 34 x 34 x 64 float32 = 296 KB would not fit): one
// block per (band of `band` grid rows, 64 channels, image) stages the band
// plus a one-row halo above and below, (band+2) x (hw+2) x 64 (87 KB for
// 8 rows of float32 at hw = 32, two blocks per SM). Each halo row is read
// by two blocks, so device memory sees (band+2)/band reads per input
// element; the arithmetic and its order are the whole-grid body's. The
// wrapper (ops/fused_stack.py::dwconv_gelu_body) takes the whole grid where
// it fits and bands of 8 rows beyond (float32 up to hw = 88, bf16 up to
// hw = 179).
//
// Two more template parameters serve the probes; the instantiations above
// are <MODE = DW_BASE, CT = float> and unchanged by them.
// - MODE, the depthwise variants of scripts/microbench_layer.py
//   (`_mlp_tail`, pallas_call at :252), whole-grid body and float32 input:
//   DW_NONE ("nodw": c = h + dwb, no convolution; no slab, each element
//   read once from device memory) and DW_COMMUTED ("dw_commuted",
//   `_dw_fwd_commuted`: the row taps z_dj of each padded column first, then
//   acc[j] = z0[j-1] + z1[j] + z2[j+1]). DW_COMMUTED computes the same
//   float32 sums in the same order as DW_BASE, so its output is the same;
//   what changes is the walk: a thread slides along 8 pixels of a row,
//   computing each padded column's three z once (3 slab reads a column)
//   instead of reading the 9 neighbours of every pixel.
// - CT, the type of the stored pre-GELU c: bf16 for the "bf16res" backward
//   of scripts/probe_train_bwd_stage.py (pallas_call at :259), which keeps
//   its residuals in bf16 (whole-grid body, base mode).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;     // channels per thread (16 bytes of bf16)
constexpr int CHUNK = 64;  // channels per block
constexpr int GROUPS = CHUNK / VEC;
constexpr int SEG = 8;  // DW_COMMUTED: pixels of a row per thread
enum { DW_BASE = 0, DW_NONE = 1, DW_COMMUTED = 2 };

template <typename T>
inline size_t smem_bytes(int rows, int hw) {
  return static_cast<size_t>(rows + 2) * (hw + 2) * CHUNK * sizeof(T);
}

// 8 channels of one pixel as the tile stores them (16 bytes of bf16, 32 of float)
template <typename T>
struct Vec8;
template <>
struct Vec8<bf16> {
  uint4 u;
};
template <>
struct Vec8<float> {
  float4 a, b;
};

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(p[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack8(const Vec8<bf16>& v, float* f) { unpack8(v.u, f); }

__device__ __forceinline__ void unpack8(const Vec8<float>& v, float* f) {
  f[0] = v.a.x, f[1] = v.a.y, f[2] = v.a.z, f[3] = v.a.w;
  f[4] = v.b.x, f[5] = v.b.y, f[6] = v.b.z, f[7] = v.b.w;
}

template <typename T, bool BAND, int MODE, typename CT>
__global__ void __launch_bounds__(THREADS)
dwconv_gelu_kernel(const T* __restrict__ h, const bf16* __restrict__ dw,
                   const float* __restrict__ dwb, void* __restrict__ out,
                   CT* __restrict__ c_out, int hw, int C, int band, bool out_f32) {
  extern __shared__ __align__(16) unsigned char smem[];
  Vec8<T>* tile = reinterpret_cast<Vec8<T>*>(smem);  // [(rows+2) * (hw+2)][GROUPS]
  const int pw = hw + 2;
  const int c0 = blockIdx.x * CHUNK;
  // whole grid: blockIdx.y is the image; row band: the band, and blockIdx.z the image
  const size_t b = BAND ? blockIdx.z : blockIdx.y;
  const int r0 = BAND ? blockIdx.y * band : 0;
  const int rows = BAND ? min(band, hw - r0) : hw;
  const T* hb = h + b * hw * hw * C + c0;
  const int tid = threadIdx.x;

  if constexpr (MODE != DW_NONE) {
    for (int idx = tid; idx < (rows + 2) * pw * GROUPS; idx += THREADS) {
      const int grp = idx % GROUPS, p = idx / GROUPS;
      const int i = r0 + p / pw - 1, j = p % pw - 1;
      Vec8<T> v = {};
      if (i >= 0 && i < hw && j >= 0 && j < hw)
        v = *reinterpret_cast<const Vec8<T>*>(hb + static_cast<size_t>(i * hw + j) * C + grp * VEC);
      tile[idx] = v;
    }
  }

  const int grp = tid % GROUPS;
  const int c = c0 + grp * VEC;
  float w[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t) unpack8(*reinterpret_cast<const uint4*>(dw + t * C + c), w[t]);
  const float4 b0 = *reinterpret_cast<const float4*>(dwb + c);
  const float4 b1 = *reinterpret_cast<const float4*>(dwb + c + 4);
  const float bias[VEC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  if constexpr (MODE != DW_NONE) __syncthreads();

  // + dwb, exact GELU, stores; p counts pixels from the band's first
  auto finish = [&](const float (&acc)[VEC], int p) {
    float g[VEC], x[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      x[e] = acc[e] + bias[e];
      g[e] = 0.5f * x[e] * (1.f + erff(x[e] * 0.70710678118654752f));
    }
    const size_t pix = static_cast<size_t>(r0) * hw + p;  // the pixel's index in the image
    const size_t at = (b * hw * hw + pix) * C + c0 + grp * VEC;
    if (out_f32) {
      float4* op = reinterpret_cast<float4*>(static_cast<float*>(out) + at);
      op[0] = make_float4(g[0], g[1], g[2], g[3]);
      op[1] = make_float4(g[4], g[5], g[6], g[7]);
    } else {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + at) = pack8_bf16(g);
    }
    if (c_out != nullptr) {
      if constexpr (sizeof(CT) == 2) {
        *reinterpret_cast<uint4*>(c_out + at) = pack8_bf16(x);
      } else {
        float4* cp = reinterpret_cast<float4*>(c_out + at);
        cp[0] = make_float4(x[0], x[1], x[2], x[3]);
        cp[1] = make_float4(x[4], x[5], x[6], x[7]);
      }
    }
  };

  if constexpr (MODE == DW_NONE) {
    for (int p = tid / GROUPS; p < rows * hw; p += THREADS / GROUPS) {
      float acc[VEC];
      unpack8(*reinterpret_cast<const Vec8<T>*>(hb + (static_cast<size_t>(r0) * hw + p) * C +
                                                grp * VEC),
              acc);
      finish(acc, p);
    }
  } else if constexpr (MODE == DW_COMMUTED) {
    // a thread slides along SEG pixels of a row: at padded column col it
    // takes that column's three row taps z_dj once; pixel j = col - 2 then
    // sums z0 (column j), z1 (j + 1) and z2 (j + 2)
    const int segs = (hw + SEG - 1) / SEG;
    for (int item = tid / GROUPS; item < rows * segs; item += THREADS / GROUPS) {
      const int i = item / segs, j0 = (item % segs) * SEG, j1 = min(j0 + SEG, hw);
      float z0a[VEC] = {}, z0b[VEC] = {}, z1b[VEC] = {};  // z0 two and one columns back, z1 one back
      for (int col = j0; col < j1 + 2; ++col) {
        float z[3][VEC];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int e = 0; e < VEC; ++e) z[dj][e] = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          float v[VEC];
          unpack8(tile[((i + di) * pw + col) * GROUPS + grp], v);
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int e = 0; e < VEC; ++e) z[dj][e] += v[e] * w[di * 3 + dj][e];
        }
        if (col >= j0 + 2) {
          float acc[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = z0a[e] + z1b[e] + z[2][e];
          finish(acc, i * hw + col - 2);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          z0a[e] = z0b[e];
          z0b[e] = z[0][e];
          z1b[e] = z[1][e];
        }
      }
    }
  } else {
    for (int p = tid / GROUPS; p < rows * hw; p += THREADS / GROUPS) {
      const int i = p / hw, j = p % hw;  // i counts rows from the band's first
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
      finish(acc, p);
    }
  }
}

template <typename T, bool BAND, int MODE, typename CT>
int launch(const void* h, const void* dw, const float* dwb, void* out, void* c_out, int B, int hw,
           int C, int band, bool out_f32, cudaStream_t s) {
  const size_t smem = MODE == DW_NONE ? 0 : smem_bytes<T>(BAND ? band : hw, hw);
  cudaError_t err = cudaFuncSetAttribute(dwconv_gelu_kernel<T, BAND, MODE, CT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = BAND ? dim3(C / CHUNK, (hw + band - 1) / band, B) : dim3(C / CHUNK, B);
  dwconv_gelu_kernel<T, BAND, MODE, CT><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(h), static_cast<const bf16*>(dw), dwb, out, static_cast<CT*>(c_out),
      hw, C, band, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: (B*hw*hw, C) token rows of a row-major hw x hw grid, float32 when
// h_f32 is non-zero, else bf16. out: the same rows, float32 when out_f32
// is non-zero, else bf16. c_out: null, or (B*hw*hw, C) for the pre-GELU
// values, bf16 when c_bf16 is non-zero, else float32. dw: (9, C) bf16
// taps, tap di*3+dj. dwb: (C,) float32. band: 0 for the whole-grid body,
// else the grid rows of each block of the row-band body. dw_mode: 0 base,
// 1 none, 2 commuted. Requires C % 64 == 0 and the body's slab within 227
// KB (see the header); dw_mode 1 and 2 only with the whole-grid body and
// float32 h and c, c_bf16 only with the whole-grid body, bf16 h and base mode.
LTD_API int ltd_dwconv_gelu(const void* h, const void* dw, const float* dwb, void* out,
                            void* c_out, int B, int hw, int C, int h_f32, int out_f32,
                            int band, int c_bf16, int dw_mode, void* stream) {
  if (C % CHUNK || band < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool of = out_f32 != 0;
  if (dw_mode != DW_BASE || c_bf16) {
    if (band > 0) return static_cast<int>(cudaErrorInvalidValue);
    if (c_bf16)
      return dw_mode == DW_BASE && !h_f32
                 ? launch<bf16, false, DW_BASE, bf16>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s)
                 : static_cast<int>(cudaErrorInvalidValue);
    if (!h_f32) return static_cast<int>(cudaErrorInvalidValue);
    if (dw_mode == DW_NONE)
      return launch<float, false, DW_NONE, float>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s);
    if (dw_mode == DW_COMMUTED)
      return launch<float, false, DW_COMMUTED, float>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (band > 0)
    return h_f32 ? launch<float, true, DW_BASE, float>(h, dw, dwb, out, c_out, B, hw, C, band, of, s)
                 : launch<bf16, true, DW_BASE, float>(h, dw, dwb, out, c_out, B, hw, C, band, of, s);
  return h_f32 ? launch<float, false, DW_BASE, float>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s)
               : launch<bf16, false, DW_BASE, float>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s);
}
