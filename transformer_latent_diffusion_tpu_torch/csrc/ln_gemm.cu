// ln_gemm: C = LN?(A) @ W^T on the tensor cores, with a bias / residual epilogue.
//
// Replaces the five matrix products of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel:
// LN1 -> QKV (768 -> 2304), LN2 -> Q (768 -> 768), the conditioning K/V
// projection (2B rows, 768 -> 1536), expand + b1 (768 -> 3072, from the
// LN3 rows that cross_attention.cu writes in bf16) and contract + b2 added
// into the residual (3072 -> 768).
//
// What bounds it on the H100: at M = B*N = 16384 rows these products do
// ~150 to ~300 FLOP per byte they must move, so they are compute-bound on
// the tensor cores (989 TFLOP/s dense bf16 at 700 W), provided the operand
// loads are hidden behind the multiplies and operands are not re-read from
// L2 more often than the tiling needs.
//
// What this design does about that. Both variants multiply with m16n8k16
// bf16 `mma.sync` (float32 accumulation in registers), read W in its
// (out, in) layout, which is the column-major B operand, with `ldmatrix`
// from rows padded so that `ldmatrix` is conflict-free, stream W through a
// `cp.async` ring (several tiles in flight while one multiplies), and
// run the epilogue (bias, bf16 rounding or the residual add) from the
// accumulator registers. Each of the 8 warps owns a 64 x 32 sub-tile of a
// 128 x 128 output tile.
//
// * With a LayerNorm prologue (A is the float32 residual, K <= 768): each
//   block owns 128 rows. It reads them once, takes float32 mean and
//   variance (two passes over registers, eps 1e-5), normalises, scales,
//   shifts and rounds them to bf16 into shared memory (128 x 776 bf16,
//   194 KB), and then walks over its share of the N columns in 128-wide
//   tiles with the rows resident (W in a 3-stage ring: what is left of
//   the 227 KB). The normalised activations never go to
//   device memory, and A is read once per row block instead of once per
//   output tile. When there are fewer row blocks than SMs the N columns
//   are split over more blocks.
// * Without it (A bf16: the expand and contract products and the
//   conditioning K/V): A and W both in a 4-stage ring.
// The two bodies sit behind one entry point, `ltd_ln_gemm`, which picks by
// whether a LayerNorm is given. Not yet used: wgmma, TMA, warp
// specialisation (later work); a wgmma/TMA GEMM should take the LayerNorm
// prologue in and leave a single body.
//
// Rounding points are the TPU kernel's: float32 accumulation; the stored
// output is bf16(acc [+ bias]); the residual epilogue adds (x + acc) + bias
// in float32.
//
// The training layer (ops/fused_layer_vjp.py, TPU kernel
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_fwd_kernel and
// the recompute of _bwd_kernel) uses two more modes of the same bodies:
// `out_f32` stores acc [+ bias] in float32 (the expanded hidden state h,
// which that kernel keeps float32, and the backward's input gradients
// dX = dY W, run here with W^T as the (out, in) operand), and `xn_out`
// has the LayerNorm prologue also write its bf16 normalised rows (the
// xn1 / xn2 operands of the weight gradients), from the first column
// split of each row block only, so each row has one writer.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int LDT = BK + 8;  // bf16 row stride of a streamed tile (80 bytes)
constexpr float LN_EPS = 1e-5f;

// epilogue of accumulator elements (2h, 2h+1) of one 16x8 fragment
__device__ __forceinline__ void store_pair(const float (&acc)[4], int h, int row, int col, int N,
                                           const float* __restrict__ bias, void* __restrict__ out,
                                           float* __restrict__ resid, bool out_f32) {
  float v0 = acc[2 * h], v1 = acc[2 * h + 1];
  if (resid != nullptr) {
    float2* rp = reinterpret_cast<float2*>(resid + static_cast<size_t>(row) * N + col);
    float2 x = *rp;
    x.x += v0;
    x.y += v1;
    if (bias != nullptr) {
      x.x += bias[col];
      x.y += bias[col + 1];
    }
    *rp = x;
  } else {
    if (bias != nullptr) {
      v0 += bias[col];
      v1 += bias[col + 1];
    }
    const size_t at = static_cast<size_t>(row) * N + col;
    if (out_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
    else
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + at) = pack_bf16x2(v0, v1);
  }
}

// B fragments of 4 n8 tiles (32 columns from row n0 of the W tile) at k kk
__device__ __forceinline__ void load_b4(uint32_t (&bfr)[4][2], const bf16* ws, int n0, int kk,
                                        int lane) {
#pragma unroll
  for (int j2 = 0; j2 < 2; ++j2) {
    uint32_t r4[4];
    ldmatrix_x4(r4, ws + (n0 + j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + kk +
                        ((lane >> 3) & 1) * 8);
    bfr[2 * j2][0] = r4[0];
    bfr[2 * j2][1] = r4[1];
    bfr[2 * j2 + 1][0] = r4[2];
    bfr[2 * j2 + 1][1] = r4[3];
  }
}

// ---------------------------------------------------------------------------
// LayerNorm prologue, rows resident

constexpr int RBM = 128;
constexpr int RBN = 128;
constexpr int RSTAGES = 3;
constexpr int MAX_LN_K = 768;

inline int resident_smem(int K) { return (RBM * (K + 8) + RSTAGES * RBN * LDT) * 2; }

__global__ void __launch_bounds__(THREADS)
ln_gemm_resident_kernel(const float* __restrict__ a, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, const bf16* __restrict__ w,
                        const float* __restrict__ bias, void* __restrict__ out,
                        float* __restrict__ resid, bf16* __restrict__ xn_out, int M, int N, int K,
                        bool out_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = K + 8;
  const bool write_xn = xn_out != nullptr && blockIdx.x == 0;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + RBM * lda;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp >> 2;  // 0..1: 64-row half of the tile
  const int wn = warp & 3;   // 0..3: 32-column quarter of the tile
  const int m_blk = blockIdx.y * RBM;
  const int tiles = N / RBN;
  const int per = (tiles + gridDim.x - 1) / gridDim.x;
  const int t_begin = blockIdx.x * per;
  const int t_end = min(t_begin + per, tiles);
  const int nk = K / BK;
  const int steps = max(t_end - t_begin, 0) * nk;

  auto load_w = [&](int step) {
    const int n0 = (t_begin + step / nk) * RBN, k0 = (step % nk) * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 bytes
      const int c = tid + i * THREADS;
      const int r = c >> 2, col = (c & 3) * 8;
      cp_async16(Ws + (step % RSTAGES) * RBN * LDT + r * LDT + col,
                 w + static_cast<size_t>(n0 + r) * K + k0 + col, 16);
    }
  };
#pragma unroll
  for (int s = 0; s < RSTAGES - 1; ++s) {
    if (s < steps) load_w(s);
    cp_async_commit();
  }

  // normalise this block's rows into shared memory, one warp per row
  for (int r = warp; r < RBM; r += THREADS / 32) {
    const int row = m_blk + r;
    bf16* dst = As + r * lda;
    if (row >= M) {
      for (int k = lane * 4; k < K; k += 128)
        *reinterpret_cast<uint2*>(dst + k) = make_uint2(0u, 0u);
      continue;
    }
    const float* x = a + static_cast<size_t>(row) * K;
    float4 v[MAX_LN_K / 128];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_LN_K / 128; ++j) {
      const int k = j * 128 + lane * 4;
      v[j] = k < K ? *reinterpret_cast<const float4*>(x + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
    const float mean = warp_sum(s) / K;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_LN_K / 128; ++j) {
      if (j * 128 + lane * 4 < K) {
        const float d0 = v[j].x - mean, d1 = v[j].y - mean;
        const float d2 = v[j].z - mean, d3 = v[j].w - mean;
        q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / K + LN_EPS);
#pragma unroll
    for (int j = 0; j < MAX_LN_K / 128; ++j) {
      const int k = j * 128 + lane * 4;
      if (k < K) {
        const float4 sc = *reinterpret_cast<const float4*>(ln_s + k);
        const float4 sh = *reinterpret_cast<const float4*>(ln_b + k);
        uint2 p;
        p.x = pack_bf16x2((v[j].x - mean) * rstd * sc.x + sh.x,
                          (v[j].y - mean) * rstd * sc.y + sh.y);
        p.y = pack_bf16x2((v[j].z - mean) * rstd * sc.z + sh.z,
                          (v[j].w - mean) * rstd * sc.w + sh.w);
        *reinterpret_cast<uint2*>(dst + k) = p;
        if (write_xn) *reinterpret_cast<uint2*>(xn_out + static_cast<size_t>(row) * K + k) = p;
      }
    }
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<RSTAGES - 2>();
    __syncthreads();  // also orders the normalised rows before their first use
    if (step + RSTAGES - 1 < steps) load_w(step + RSTAGES - 1);
    cp_async_commit();
    const int kt = step % nk;
    const bf16* ws = Ws + (step % RSTAGES) * RBN * LDT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], As + (wm * 64 + i * 16 + (lane & 15)) * lda + kt * BK + kk +
                               (lane >> 4) * 8);
      uint32_t bfr[4][2];
      load_b4(bfr, ws, wn * 32, kk, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    if (kt == nk - 1) {  // this 128 x 128 output tile is complete
      const int n0 = (t_begin + step / nk) * RBN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m_blk + wm * 64 + i * 16 + h * 8 + g;
          if (row < M) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              store_pair(acc[i][j], h, row, n0 + wn * 32 + j * 8 + 2 * t4, N, bias, out, resid,
                         out_f32);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 A, both operands streamed

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int STREAM_STAGE = (BM + BN) * LDT * 2;
constexpr int STREAM_SMEM = STAGES * STREAM_STAGE;

__global__ void __launch_bounds__(THREADS)
gemm_stream_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   const float* __restrict__ bias, void* __restrict__ out,
                   float* __restrict__ resid, int M, int N, int K, bool out_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp >> 2;  // 0..1: 64-row half of the tile
  const int wn = warp & 3;   // 0..3: 32-column quarter of the tile
  const int m_blk = blockIdx.y * BM;
  const int n_blk = blockIdx.x * BN;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = reinterpret_cast<bf16*>(smem + stage * STREAM_STAGE);
    bf16* ws = as + BM * LDT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2, col = (c & 3) * 8;
      const int row = m_blk + r;
      cp_async16(as + r * LDT + col, a + static_cast<size_t>(row < M ? row : 0) * K + k0 + col,
                 row < M ? 16 : 0);
      cp_async16(ws + r * LDT + col, w + static_cast<size_t>(n_blk + r) * K + k0 + col, 16);
    }
  };

  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const bf16* as = reinterpret_cast<const bf16*>(smem + (kt % STAGES) * STREAM_STAGE);
    const bf16* ws = as + BM * LDT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + (wm * 64 + i * 16 + (lane & 15)) * LDT + kk + (lane >> 4) * 8);
      uint32_t bfr[4][2];
      load_b4(bfr, ws, wn * 32, kk, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_blk + wm * 64 + i * 16 + h * 8 + g;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_pair(acc[i][j], h, row, n_blk + wn * 32 + j * 8 + 2 * t4, N, bias, out, resid,
                   out_f32);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

}  // namespace

// a: (M, K) float32 when ln_s/ln_b are given (LayerNorm prologue; then
// K <= 768), else bf16. N % 128 == 0. w: (N, K)
// bf16. bias: (N,) float32 or null. Exactly one of out (M, N) and
// resid (M, N) float32 (updated in place) is non-null; out is float32 when
// out_f32 is non-zero, else bf16. xn_out: (M, K) bf16 or null, the
// normalised rows (LayerNorm prologue only). Requires K % 32 == 0; any
// M >= 1.
LTD_API int ltd_ln_gemm(const void* a, const float* ln_s, const float* ln_b, const void* w,
                        const float* bias, void* out, float* resid, void* xn_out, int M, int N,
                        int K, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wb = static_cast<const bf16*>(w);
  cudaError_t err;
  if (ln_s != nullptr) {
    const int smem = resident_smem(K);
    err = cudaFuncSetAttribute(ln_gemm_resident_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int row_blocks = (M + RBM - 1) / RBM;
    const int splits = max(1, min(N / RBN, sm_count() / row_blocks));
    ln_gemm_resident_kernel<<<dim3(splits, row_blocks), THREADS, smem, s>>>(
        static_cast<const float*>(a), ln_s, ln_b, wb, bias, out, resid,
        static_cast<bf16*>(xn_out), M, N, K, out_f32 != 0);
  } else {
    if (xn_out != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(gemm_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STREAM_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    gemm_stream_kernel<<<dim3(N / BN, (M + BM - 1) / BM), THREADS, STREAM_SMEM, s>>>(
        static_cast<const bf16*>(a), wb, bias, out, resid, M, N, K, out_f32 != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
