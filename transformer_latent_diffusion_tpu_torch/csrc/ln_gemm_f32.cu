// ln_gemm_f32: C = LN?(A) @ W^T in float32 on the CUDA cores, with a bias /
// residual epilogue: the float32 form of ln_gemm.cu.
//
// Replaces the five matrix products of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (and the conditioning K/V product of
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel)
// when the compute dtype (`mxu`, the weights' dtype) is float32, the JAX
// package's default configuration: LN1 -> QKV, LN2 -> Q, the conditioning
// K/V, expand + b1 (from the float32 LN3 rows) and contract + b2 added into
// the residual. The TPU kernel's `_mm` takes float32 operands and
// accumulates in float32 (fused_block.py:65-78).
//
// What bounds it on the H100: operations. Hopper's tensor cores take
// float32 operands only as TF32 (a 10-bit mantissa, about bf16's error), so
// a float32 product runs as FFMA on the CUDA cores: 67 TFLOP/s at 700 W.
// At M = 16384 rows the products do ~100 to ~390 FLOP per byte they move,
// far past the 20 FLOP per byte where float32 FFMA stops waiting on device
// memory.
//
// What this design does about that: the classic register-blocked SIMT
// GEMM. A block of 256 threads computes a 128 x 128 tile of C; each thread
// an 8 x 8 sub-tile (two 4-row by two 4-column groups, 64 apart, so that
// its shared-memory reads are 16-byte vectors that a warp broadcasts or
// reads as contiguous lines), 64 float32 accumulators in registers. Per
// step of BK = 8 along K, the thread reads 16 floats from shared memory
// and issues 64 FFMAs. A and W tiles (both K-major as stored) are
// transposed on their way into shared memory (k-major, rows padded by 4
// floats: the transposed stores fall in distinct banks), double-buffered:
// the next tile's 16-byte global loads are in flight in registers while
// this tile is multiplied, and one barrier per step hands the buffers
// over. blockIdx.x walks the column tiles fastest, so the blocks that run
// at once share their A row block in L2, and W (at most 9.4 MB) stays in
// L2.
// - LayerNorm mode (A the float32 residual): before its main loop the block
//   takes the float32 statistics of its 128 rows (each warp 16 rows, the
//   mean, then the mean of squared deviations, eps 1e-5, the plain
//   version's two passes), keeps them in shared memory, and normalises each
//   A element as it is loaded: ((x - mean) * rstd) * scale + shift, the
//   plain version's order. The rows are read once more per block for the
//   statistics, from L2.
// - The epilogue adds the bias to each accumulator and writes float32 C,
//   or adds (acc + bias) into the float32 residual in place, the plain
//   version's order, with 16-byte accesses. Rows past M and columns past
//   N are masked (N % 4 == 0, so a 16-byte group is all in or all out).
//   Each element has one writer and its K products are summed in one
//   fixed order, so two launches give bit-equal results.
// Not TF32, and no split into TF32 parts: every product is a float32 FFMA.

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int THREADS = 256;
constexpr int LDS = BM + 4;  // padded row of the k-major tiles
constexpr float LN_EPS = 1e-5f;

template <bool LN, bool RESID>
__global__ void __launch_bounds__(THREADS, 2)
ln_gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int M, int N,
                   int K) {
  __shared__ __align__(16) float As[2][BK][LDS];
  __shared__ __align__(16) float Ws[2][BK][LDS];
  __shared__ float mean_s[BM], rstd_s[BM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if constexpr (LN) {
    // the float32 statistics of the block's rows: warp w takes rows w, w + 8, ...
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int row = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (row < M) {
        const float4* x4 = reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * K);
        float s = 0.f;
        for (int c = lane; c < K / 4; c += 32) {
          const float4 v = x4[c];
          s += (v.x + v.y) + (v.z + v.w);
        }
        mean = warp_sum(s) / K;
        float q = 0.f;
        for (int c = lane; c < K / 4; c += 32) {
          const float4 v = x4[c];
          const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
          q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
        }
        rstd = rsqrtf(warp_sum(q) / K + LN_EPS);
      }
      if (lane == 0) mean_s[r] = mean, rstd_s[r] = rstd;
    }
    __syncthreads();
  }

  // each thread loads one 16-byte group of A's and of W's 128 x 8 tile:
  // row lr, columns lk .. lk + 3 of the k-tile
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool a_in = m0 + lr < M, w_in = n0 + lr < N;
  const float* a_row = a + static_cast<size_t>(a_in ? m0 + lr : 0) * K + lk;
  const float* w_row = w + static_cast<size_t>(w_in ? n0 + lr : 0) * K + lk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra, rw;
  auto load = [&](int k0) {
    ra = a_in ? *reinterpret_cast<const float4*>(a_row + k0) : zero;
    rw = w_in ? *reinterpret_cast<const float4*>(w_row + k0) : zero;
    if constexpr (LN) {
      if (a_in) {
        const float mu = mean_s[lr], rs = rstd_s[lr];
        const float4 sc = *reinterpret_cast<const float4*>(ln_s + k0 + lk);
        const float4 sh = *reinterpret_cast<const float4*>(ln_b + k0 + lk);
        ra.x = ((ra.x - mu) * rs) * sc.x + sh.x;
        ra.y = ((ra.y - mu) * rs) * sc.y + sh.y;
        ra.z = ((ra.z - mu) * rs) * sc.z + sh.z;
        ra.w = ((ra.w - mu) * rs) * sc.w + sh.w;
      }
    }
  };
  auto store = [&](int buf) {
    As[buf][lk + 0][lr] = ra.x, As[buf][lk + 1][lr] = ra.y;
    As[buf][lk + 2][lr] = ra.z, As[buf][lk + 3][lr] = ra.w;
    Ws[buf][lk + 0][lr] = rw.x, Ws[buf][lk + 1][lr] = rw.y;
    Ws[buf][lk + 2][lr] = rw.z, Ws[buf][lk + 3][lr] = rw.w;
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int tiles = K / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) load((t + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[8], wv[8];
      *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      *reinterpret_cast<float4*>(wv) = *reinterpret_cast<const float4*>(&Ws[buf][k][tx * 4]);
      *reinterpret_cast<float4*>(wv + 4) =
          *reinterpret_cast<const float4*>(&Ws[buf][k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    if (t + 1 < tiles) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: rows ty*4 + i (+64), columns tx*4 .. +3 (+64)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= N) continue;
      float4 v = make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                             acc[i][h * 4 + 3]);
      if (bias != nullptr) {
        const float4 b = *reinterpret_cast<const float4*>(bias + col);
        v.x += b.x, v.y += b.y, v.z += b.z, v.w += b.w;
      }
      float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col);
      if constexpr (RESID) {
        float4 r = *dst;
        r.x += v.x, r.y += v.y, r.z += v.z, r.w += v.w;
        *dst = r;
      } else {
        *dst = v;
      }
    }
  }
}

}  // namespace

// a: (M, K) float32 (the residual when ln_s/ln_b are given: LayerNorm
// prologue). w: (N, K) float32. bias: (N,) float32 or null. out: (M, N)
// float32; with resid != 0 it is the float32 residual, updated in place
// (out += acc + bias). Requires N % 4 == 0, K % 8 == 0, any M >= 1, every
// pointer 16-byte aligned.
LTD_API int ltd_ln_gemm_f32(const float* a, const float* ln_s, const float* ln_b, const float* w,
                            const float* bias, float* out, int resid, int M, int N, int K,
                            void* stream) {
  if (M < 1 || N < 4 || N % 4 || K < 8 || K % 8 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ln = ln_s != nullptr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto kernel = ln ? (resid ? ln_gemm_f32_kernel<true, true> : ln_gemm_f32_kernel<true, false>)
                   : (resid ? ln_gemm_f32_kernel<false, true> : ln_gemm_f32_kernel<false, false>);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, ln_s, ln_b, w, bias, out, M,
                                                                   N, K);
  return static_cast<int>(cudaGetLastError());
}
