// weight_grad: dW = dY^T X (float32 out), and colsum: deterministic column sums.
//
// Replace the weight-gradient products and the bias/scale sums of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
// (:176-187 dw2, db2, dw1, db1; :211 dwq; :214 dwkv; :238 dwqkv; the
// partial sums of the LayerNorm, depthwise and bias gradients). The TPU
// kernel accumulates each weight gradient in VMEM across its sequential
// batch grid. CUDA blocks run in no order, so here the reduction over the
// B*N rows is split over blocks that each write a float32 partial, and a
// second launch sums the partials in a fixed order (colsum): the result
// does not depend on the schedule, and no atomics are used.
//
// weight_grad. dW[n, k] = sum_m dY[m, n] X[m, k], dY (M, N) and X (M, K)
// bf16 row-major (the bf16 gradient and the bf16 forward operand, as the
// TPU kernel rounds both before its product), float32 accumulation. What
// bounds it on the H100: at M = 32768 rows it does 2*N*K*M FLOP on
// 2*M*(N+K) bytes, 100-800 FLOP per byte, so the tensor cores (989 TFLOP/s
// dense bf16 at 700 W). The design: 128 x 128 output tiles, 8 warps of
// 64 x 32, m16n8k16 bf16 `mma.sync`; both operands arrive as [m][n] and
// [m][k] tiles of 32 rows through a 4-stage `cp.async` ring, and both are
// read transposed with `ldmatrix.trans` (dY^T is the A operand, X the
// row-major B operand), so neither is transposed in device memory. When
// the output has too few tiles to fill the card, the M rows are split over
// gridDim.z blocks, each writing its own float32 partial slab.
//
// colsum. out[c] = sum_r x[r, c], float32. Memory-bound (one read of x).
// 32 columns per block, 8 row lanes per column summing strided rows, then
// the 8 lane sums added in a fixed order in shared memory.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 32;          // rows of the reduction per stage
constexpr int BT = 128;         // output tile: 128 x 128
constexpr int LDS = BT + 8;     // bf16 row stride of a stage tile (272 bytes)
constexpr int STAGES = 4;
constexpr int STAGE_ELEMS = 2 * BM * LDS;
constexpr int SMEM = STAGES * STAGE_ELEMS * 2;

__global__ void __launch_bounds__(THREADS)
weight_grad_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                   float* __restrict__ out, int M, int N, int K, int m_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* base = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp >> 2;  // 0..1: 64-row half (n) of the tile
  const int wn = warp & 3;   // 0..3: 32-column quarter (k) of the tile
  const int k_blk = blockIdx.x * BT;
  const int n_blk = blockIdx.y * BT;
  const int m_begin = blockIdx.z * m_chunk;
  const int m_end = min(M, m_begin + m_chunk);
  const int steps = max(0, (m_end - m_begin) / BM);

  auto load_stage = [&](int step) {
    bf16* ys = base + (step % STAGES) * STAGE_ELEMS;
    bf16* xs = ys + BM * LDS;
    const int m0 = m_begin + step * BM;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 32 rows x 16 chunks of 16 bytes, each operand
      const int c = tid + i * THREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      cp_async16(ys + r * LDS + col, dy + static_cast<size_t>(m0 + r) * N + n_blk + col, 16);
      cp_async16(xs + r * LDS + col, x + static_cast<size_t>(m0 + r) * K + k_blk + col, 16);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (step + STAGES - 1 < steps) load_stage(step + STAGES - 1);
    cp_async_commit();
    const bf16* ys = base + (step % STAGES) * STAGE_ELEMS;
    const bf16* xs = ys + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BM; kk += 16) {
      // A = dY^T: the 16 x 16 fragment (n rows, m cols) from the [m][n] tile
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(af[i], ys + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDS + wm * 64 +
                                     i * 16 + ((lane >> 3) & 1) * 8);
      // B = X: k x n = m x k, row-major [m][k]
      uint32_t bfr[4][2];
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, xs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + wn * 32 +
                                  j2 * 16 + (lane >> 4) * 8);
        bfr[2 * j2][0] = r4[0];
        bfr[2 * j2][1] = r4[1];
        bfr[2 * j2 + 1][0] = r4[2];
        bfr[2 * j2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  float* o = out + static_cast<size_t>(blockIdx.z) * N * K;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_blk + wm * 64 + i * 16 + h * 8 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k_blk + wn * 32 + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(o + static_cast<size_t>(n) * K + k) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

constexpr int CS_COLS = 32;
constexpr int CS_LANES = THREADS / CS_COLS;

__global__ void __launch_bounds__(THREADS)
colsum_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int C,
              int rows_per_block) {
  __shared__ float part[CS_LANES][CS_COLS];
  const int col = blockIdx.x * CS_COLS + (threadIdx.x & (CS_COLS - 1));
  const int lane_r = threadIdx.x / CS_COLS;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  float s = 0.f;
  if (col < C)
    for (int r = r0 + lane_r; r < r1; r += CS_LANES) s += x[static_cast<size_t>(r) * C + col];
  part[lane_r][threadIdx.x & (CS_COLS - 1)] = s;
  __syncthreads();
  if (lane_r == 0 && col < C) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < CS_LANES; ++i) t += part[i][threadIdx.x];
    out[static_cast<size_t>(blockIdx.y) * C + col] = t;
  }
}

}  // namespace

// dy: (M, N) bf16; x: (M, K) bf16; out: (splits, N, K) float32, one slab of
// partial sums per split of the M rows (splits == 1: the result itself).
// Requires M % 32 == 0, N % 128 == 0, K % 128 == 0 and m_chunk % 32 == 0
// with splits * m_chunk >= M.
LTD_API int ltd_weight_grad(const void* dy, const void* x, float* out, int M, int N, int K,
                            int splits, int m_chunk, void* stream) {
  if (M % BM || N % BT || K % BT || m_chunk % BM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  weight_grad_kernel<<<dim3(K / BT, N / BT, splits), THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(x), out, M, N, K, m_chunk);
  return static_cast<int>(cudaGetLastError());
}

// x: (R, C) float32; out: (ceil(R / rows_per_block), C) float32, the sums
// of each block of rows_per_block rows (one block of rows: the column sums).
LTD_API int ltd_colsum(const float* x, float* out, int R, int C, int rows_per_block,
                       void* stream) {
  const dim3 grid((C + CS_COLS - 1) / CS_COLS, (R + rows_per_block - 1) / rows_per_block);
  colsum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, R, C,
                                                                        rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
