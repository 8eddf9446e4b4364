// self_attention_bwd_f32: the self-attention backward of the training layer
// with float32 operands (the float32 compute dtype).
//
// Replaces the self-attention backward of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
// (:221-236) and of transformer_latent_diffusion_tpu/ops/fused_attn_vjp.py::
// _bwd_kernel when the weights, and so `mxu`, are float32: with p the
// float32 softmax recomputed from q and k, dO the gradient of a head's
// output, dp = dO v^T and ds = p (dp - sum_j dp p) / sqrt(64), it gives
// dq = ds k, dk = ds^T q and dv = p^T dO, all float32, nothing rounded.
//
// What bounds it on the H100: operations. Per (batch, head) at N = 256 the
// function needs five 256 x 256 x 64 products (s, dp, dq, dk, dv), 42
// MFLOP, and moves 448 KB (qkv and dO read, dqkv written); at batch 128 x
// 12 heads that is 64.4 GFLOP, 0.39 ms at the card's rate for products at
// float32 accuracy (3xTF32 on the tensor cores, 165 TFLOP/s), against
// 0.21 ms of bytes (chip_smoke.py's f32_train_bounds).
//
// What this design does about that: the simplest body that is right, on
// the CUDA cores (FFMA, float32 sums in a fixed order). It does seven
// products (phase 2 recomputes s and dp), 90.2 GFLOP at that batch, so
// the CUDA cores' 67 TFLOP/s of FFMA hold it above 1.35 ms; the 3xTF32
// `wgmma` body that would approach the bound is later work. The bf16 body keeps
// a whole head on chip (attention_bwd.cu); in float32 Q, K, V and dO of one
// head at N = 256 are 256 KB, more than a block's 227 KB, so here:
// - One block per (head, batch element), 256 threads, each owning a 4 x 4
//   micro-tile (rows ty + 16 i, columns tx + 16 j) of every 64 x 64 product;
//   64 x 64 tiles sit in shared memory with rows padded to 65 floats, so
//   the threads of a warp that read 16 rows at one column hit 16 banks.
// - Phase 1, query-major, per 64-query tile: Q and dO of the tile, then for
//   each 64-key chunk K and V (from L2 after the first tile): s = Q K^T / 8
//   (keys past N -inf) and dp = dO V^T into two 64 x 256 rows of shared
//   memory; each warp takes 8 rows: the row max, e = exp(s - max), its sum,
//   p = e / sum, delta = sum p dp and ds = p (dp - delta) / 8 in place; the
//   row statistics (max, sum, delta) are kept; then dq = ds K over the key
//   chunks again.
// - Phase 2, key-major, per 64-key tile: K and V of the tile, then for each
//   64-query chunk Q and dO: s^T = K Q^T / 8 and dp^T = V dO^T, p^T from the
//   kept statistics (the same sums in the same order as phase 1, so the same
//   p), ds^T = p^T (dp^T - delta) / 8, and dv += p^T dO, dk += ds^T Q in
//   registers over the chunks.
// Each output element has one writer and every sum runs in one fixed
// order, so two launches are bit-equal. Rows past N of a ragged last tile
// are read as zeros and never stored.
//
// Shared memory: four 64 x 65 tiles (66.6 KB), the s and dp rows (2 x 64 x
// 257 floats, 131.6 KB) and the statistics (3 KB): 201 KB, one block an SM.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;
constexpr float SCALE = 0.125f;  // 1 / sqrt(64)
constexpr int T = 64;            // rows of a tile: queries or keys
constexpr int LD = T + 1;        // a tile's padded row
constexpr int NMAX = 256;
constexpr int SLD = NMAX + 1;    // a row of s or dp, padded
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_FLOATS = 4 * T * LD + 2 * T * SLD + 3 * NMAX;
constexpr int SMEM = SMEM_FLOATS * 4;

// rows t0 .. t0 + 63 (zeros past N) of the 64 columns at `col` of the
// (B*N, ld) rows of element b, into a 64 x LD tile
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int ld,
                                          int col, size_t row0, int t0, int N) {
  for (int i = threadIdx.x; i < T * DH / 4; i += THREADS) {
    const int r = i / (DH / 4), c4 = i % (DH / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < N)
      v = *reinterpret_cast<const float4*>(src + (row0 + t0 + r) * ld + col + 4 * c4);
    float* d = dst + r * LD + 4 * c4;
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  }
}

// acc[i][j] += sum_e A[(ty + 16 i) lda + e] B[(tx + 16 j) ldb + e]: A B^T
// of two row-major operands, 64 terms
__device__ __forceinline__ void mma_abt(float (&acc)[4][4], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll 4
  for (int e = 0; e < DH; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ldb + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_e A[(ty + 16 i) lda + e] B[e ldb + tx + 16 j]: A B, 64 terms
__device__ __forceinline__ void mma_ab(float (&acc)[4][4], const float* A, int lda,
                                       const float* B, int ldb, int ty, int tx) {
#pragma unroll 4
  for (int e = 0; e < T; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[e * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__global__ void __launch_bounds__(THREADS, 1)
self_attention_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                              float* __restrict__ dqkv, int N, int D) {
  extern __shared__ float sm[];
  float* qs = sm;                 // Q tile (phase 1) or chunk (phase 2)
  float* gs = qs + T * LD;        // dO, the same rows
  float* ks = gs + T * LD;        // K chunk (phase 1) or tile (phase 2)
  float* vs = ks + T * LD;        // V, the same rows
  float* srow = vs + T * LD;      // phase 1: s, then p (64 x SLD); phase 2: p^T (64 x LD)
  float* drow = srow + T * SLD;   // phase 1: dp, then ds; phase 2: ds^T
  float* rmax = drow + T * SLD;   // per query: the row max of s,
  float* rsum = rmax + NMAX;      // the sum of exp(s - max),
  float* rdelta = rsum + NMAX;    // and delta = sum p dp
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int nt = (N + T - 1) / T, np = nt * T;
  const size_t row0 = static_cast<size_t>(b) * N;
  const int ld3 = 3 * D;
  const int qcol = h * DH, kcol = D + h * DH, vcol = 2 * D + h * DH;
  float acc[4][4], acc2[4][4];

  // ---- phase 1: per 64-query tile, the softmax rows, their statistics and dq
  for (int qt = 0; qt < nt; ++qt) {
    const int q0 = qt * T;
    load_tile(qs, qkv, ld3, qcol, row0, q0, N);
    load_tile(gs, dout, D, h * DH, row0, q0, N);
    for (int kc = 0; kc < nt; ++kc) {
      load_tile(ks, qkv, ld3, kcol, row0, kc * T, N);
      load_tile(vs, qkv, ld3, vcol, row0, kc * T, N);
      __syncthreads();
      zero(acc);
      zero(acc2);
      mma_abt(acc, qs, LD, ks, LD, ty, tx);
      mma_abt(acc2, gs, LD, vs, LD, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kc * T + tx + 16 * j;
          srow[(ty + 16 * i) * SLD + k] = k < N ? acc[i][j] * SCALE : -INFINITY;
          drow[(ty + 16 * i) * SLD + k] = acc2[i][j];
        }
      __syncthreads();  // K and V are read: the next chunk may overwrite them
    }
    // the softmax of each row and its backward: warp w takes rows w, w + 8, ...
    for (int r = warp; r < T; r += WARPS) {
      float* s = srow + r * SLD;
      float* dp = drow + r * SLD;
      float m = -INFINITY;
      for (int k = lane; k < np; k += 32) m = fmaxf(m, s[k]);
      m = warp_max(m);
      float sum = 0.f;
      for (int k = lane; k < np; k += 32) {
        const float e = expf(s[k] - m);
        s[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float delta = 0.f;
      for (int k = lane; k < np; k += 32) {
        const float p = s[k] / sum;
        s[k] = p;
        delta += p * dp[k];
      }
      delta = warp_sum(delta);
      for (int k = lane; k < np; k += 32) dp[k] = s[k] * (dp[k] - delta) * SCALE;
      if (lane == 0) {
        rmax[q0 + r] = m;
        rsum[q0 + r] = sum;
        rdelta[q0 + r] = delta;
      }
    }
    // dq = ds K over the key chunks
    zero(acc);
    for (int kc = 0; kc < nt; ++kc) {
      __syncthreads();  // the rows are done (kc = 0), the last chunk is read
      load_tile(ks, qkv, ld3, kcol, row0, kc * T, N);
      __syncthreads();
      mma_ab(acc, drow + kc * T, SLD, ks, LD, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q < N)
#pragma unroll
        for (int j = 0; j < 4; ++j) dqkv[(row0 + q) * ld3 + qcol + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();  // every read of this tile's Q, dO and rows is done
  }

  // ---- phase 2: per 64-key tile, dk and dv over the query chunks
  float* pt = srow;  // p^T (64 keys x 64 queries)
  float* dst = drow;  // ds^T
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * T;
    load_tile(ks, qkv, ld3, kcol, row0, k0, N);
    load_tile(vs, qkv, ld3, vcol, row0, k0, N);
    float dk[4][4], dv[4][4];
    zero(dk);
    zero(dv);
    for (int qc = 0; qc < nt; ++qc) {
      const int q0 = qc * T;
      load_tile(qs, qkv, ld3, qcol, row0, q0, N);
      load_tile(gs, dout, D, h * DH, row0, q0, N);
      __syncthreads();
      zero(acc);
      zero(acc2);
      // s^T = K Q^T (the sums of phase 1's s, in its order) and dp^T = V dO^T
      mma_abt(acc, ks, LD, qs, LD, ty, tx);
      mma_abt(acc2, vs, LD, gs, LD, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = q0 + tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (q < N) {
            p = expf(acc[i][j] * SCALE - rmax[q]) / rsum[q];
            ds = p * (acc2[i][j] - rdelta[q]) * SCALE;
          }
          pt[(ty + 16 * i) * LD + tx + 16 * j] = p;
          dst[(ty + 16 * i) * LD + tx + 16 * j] = ds;
        }
      __syncthreads();
      mma_ab(dv, pt, LD, gs, LD, ty, tx);
      mma_ab(dk, dst, LD, qs, LD, ty, tx);
      __syncthreads();  // the chunk is read: the next may overwrite it
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ty + 16 * i;
      if (k < N)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dqkv[(row0 + k) * ld3 + kcol + tx + 16 * j] = dk[i][j];
          dqkv[(row0 + k) * ld3 + vcol + tx + 16 * j] = dv[i][j];
        }
    }
  }
}

}  // namespace

// qkv: (B*N, 3D) float32 rows [q | k | v] of the forward; dout: (B*N, D)
// float32, the gradient of the attention's output; dqkv: (B*N, 3D) float32
// rows [dq | dk | dv], every row written. Requires D == H * 64, 1 <= N <=
// 256, 16-byte aligned qkv and dout.
LTD_API int ltd_self_attention_bwd_f32(const float* qkv, const float* dout, float* dqkv, int B,
                                       int N, int D, int H, void* stream) {
  if (B < 1 || H < 1 || D != H * DH || N < 1 || N > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(self_attention_bwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  self_attention_bwd_f32_kernel<<<dim3(H, B), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      qkv, dout, dqkv, N, D);
  return static_cast<int>(cudaGetLastError());
}
