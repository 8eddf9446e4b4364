// self_attention_f32: x += softmax(q k^T / sqrt(64)) v per head, float32 q, k,
// v and probabilities, into the float32 residual: the float32 form of
// self_attention.cu.
//
// Replaces the self-attention of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (`_mha`, fused_stack.py:40-56 and :72) when the compute dtype `mxu` is
// float32 (the JAX package's default configuration), and the same stage of
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel.
// With mxu float32 the probabilities are not rounded before they weigh V
// (fused_block.py:105: `.astype(mxu_dtype)` is a no-op), and both products
// accumulate in float32.
//
// What bounds it on the H100: operations. Per (batch, head) at N = 256 it
// does 16.8 MFLOP of float32 products (no tensor-core path for full float32:
// FFMA at 67 TFLOP/s) against 3 x 256 x 64 float32 in and 256 x 64 float32
// read and written (320 KB): ~52 FLOP per byte, past float32's balance
// point of 20.
//
// What this design does about that: a block of 256 threads takes one
// (batch, head, 64-query tile) and keeps the whole score block in shared
// memory, so each softmax is exact (no running rescale) and each row is
// normalised once, in the plain version's order (max, exp, sum, divide).
// - Q (64 x 64) is staged transposed (d-major), then K in chunks of 64
//   keys, transposed; each thread computes a 4 x 4 block of scores as 64
//   outer-product steps of two 16-byte shared-memory reads and 16 FFMAs,
//   scales by 1/8 and stores the block key-major (S^T: 16-byte stores along
//   the queries). Keys past N are -inf.
// - The softmax: four threads a query column, each over a quarter of the
//   keys, combined through shared memory: the row max, then exp(s - max)
//   in place with its partial sums, then p = e / sum in place.
// - O = P V: V in chunks of 64 keys (row-major, 16-byte copies); each
//   thread a 4 x 4 block of O, 64 outer-product steps per chunk of a P^T
//   row (16 bytes along the queries) and a V row (16 bytes along the head
//   columns).
// - O is added into the float32 residual with 16-byte read-modify-writes.
//   Each residual element belongs to one block and one thread, which adds
//   once, so two launches are bit-equal.
// Shared memory: 104 KB a block (Q, one K or V chunk, the 256-key score
// block), two blocks per SM.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QT = 64;         // queries per block
constexpr int KC = 64;         // keys per chunk
constexpr int DH = 64;         // head dim
constexpr int MAX_KEYS = 256;  // N
constexpr int LD = 68;         // padded row of the staged tiles and the scores

__global__ void __launch_bounds__(THREADS, 2)
self_attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ resid, int N, int D) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [DH][LD]: Q^T of the tile
  float* kvs = qt + DH * LD;      // [KC][LD]: K^T of a chunk, then a V chunk
  float* st = kvs + KC * LD;      // [MAX_KEYS][LD]: S^T, then P^T
  float* red = st + MAX_KEYS * LD;  // [4][QT]: the softmax's partial values

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = static_cast<size_t>(b) * N;
  const int three_d = 3 * D;
  const int chunks = (N + KC - 1) / KC;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // stage 64 rows x 64 columns of part `part` (0 q, 1 k, 2 v) of the head,
  // from token r0 on: transposed into dst[d][r], or row-major dst[r][d]
  auto stage = [&](int part, int r0, float* dst, bool transpose) {
    for (int i = tid; i < 64 * 16; i += THREADS) {
      const int r = i / 16, c4 = (i % 16) * 4;
      const int tok = r0 + r;
      const float4 v =
          tok < N ? *reinterpret_cast<const float4*>(qkv + (row0 + tok) * three_d + part * D +
                                                     h * DH + c4)
                  : zero;
      if (transpose) {
        dst[(c4 + 0) * LD + r] = v.x, dst[(c4 + 1) * LD + r] = v.y;
        dst[(c4 + 2) * LD + r] = v.z, dst[(c4 + 3) * LD + r] = v.w;
      } else {
        *reinterpret_cast<float4*>(dst + r * LD + c4) = v;
      }
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  stage(0, q0, qt, true);
  // S^T = (Q K^T / 8)^T, chunk by chunk
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // the previous chunk's reads of kvs are done
    stage(1, c * KC, kvs, true);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * LD + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kvs + d * LD + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = c * KC + tx * 4 + j;
      const float ninf = -INFINITY;
      const float4 col = key < N ? make_float4(s[0][j] * 0.125f, s[1][j] * 0.125f,
                                               s[2][j] * 0.125f, s[3][j] * 0.125f)
                                 : make_float4(ninf, ninf, ninf, ninf);
      *reinterpret_cast<float4*>(st + key * LD + ty * 4) = col;
    }
  }
  __syncthreads();

  // softmax over the keys of each query column: thread (part, q)
  const int q = tid % QT, part = tid / QT;
  const int keys = chunks * KC, per = keys / 4;
  float mx = -INFINITY;
  for (int k = part * per; k < (part + 1) * per; ++k) mx = fmaxf(mx, st[k * LD + q]);
  red[part * QT + q] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[q], red[QT + q]), fmaxf(red[2 * QT + q], red[3 * QT + q]));
  __syncthreads();  // every thread has read the maxima
  float sum = 0.f;
  for (int k = part * per; k < (part + 1) * per; ++k) {
    const float e = expf(st[k * LD + q] - mx);
    st[k * LD + q] = e;
    sum += e;
  }
  red[part * QT + q] = sum;
  __syncthreads();
  sum = (red[q] + red[QT + q]) + (red[2 * QT + q] + red[3 * QT + q]);
  for (int k = part * per; k < (part + 1) * per; ++k) st[k * LD + q] = st[k * LD + q] / sum;

  // O = P V, chunk by chunk: thread (ty, tx) rows ty*4.., head columns tx*4..
  float o[4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // P is complete; the previous chunk's reads of kvs are done
    stage(2, c * KC, kvs, false);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float4 pa = *reinterpret_cast<const float4*>(st + (c * KC + k) * LD + ty * 4);
      const float4 vb = *reinterpret_cast<const float4*>(kvs + k * LD + tx * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w}, vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tok = q0 + ty * 4 + i;
    if (tok >= N) continue;
    float4* dst = reinterpret_cast<float4*>(resid + (row0 + tok) * D + h * DH + tx * 4);
    float4 x = *dst;
    x.x += o[i][0], x.y += o[i][1], x.z += o[i][2], x.w += o[i][3];
    *dst = x;
  }
}

constexpr size_t SMEM_BYTES = sizeof(float) * ((DH + KC + MAX_KEYS) * LD + 4 * QT);

}  // namespace

// qkv: (B*N, 3D) float32 rows [q | k | v], heads of 64 columns. resid:
// (B*N, D) float32, updated in place. Requires D == n_heads * 64,
// 1 <= N <= 256, pointers 16-byte aligned.
LTD_API int ltd_self_attention_f32(const float* qkv, float* resid, int B, int N, int D,
                                   int n_heads, void* stream) {
  if (B < 1 || N < 1 || N > MAX_KEYS || n_heads < 1 || D != n_heads * DH)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cudaFuncSetAttribute(self_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + QT - 1) / QT, n_heads, B);
  self_attention_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      qkv, resid, N, D);
  return static_cast<int>(cudaGetLastError());
}
