// gemm_i8: C = dequant(A_q @ W_q^T) on the int8 tensor cores, with a bf16,
// a float32 + bias, or an in-place residual epilogue.
//
// Replaces the four W8A8 products of
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel
// (`_qmm` = `_mm_i8` and its dequantization, :56-66): LN1 -> QKV (768 ->
// 2304) and LN2 -> Q (768 -> 768), both rounded to bf16 (:81, 86); LN3 ->
// expand (768 -> 3072) + b1, kept float32 (:92-93); GELU -> contract
// (3072 -> 768), added with b2 into the residual (:99-100). A_q and its
// per-row scales come from rowquant.cu; W_q and its per-output-channel
// scales from ops/fused_stack_int8.py::pack_layer_stack_int8.
//
// What it computes: acc = sum_k A_q[m, k] * W_q[n, k] in int32 (exact),
// then deq = (float(acc) * rs[m]) * cs[n] with each product rounded
// (`__fmul_rn`), as the TPU kernel's `acc.astype(f32) * rs * cs`. Then one
// of: bf16(deq [+ bias]); float32 deq [+ bias]; or, in place,
// resid = (resid + deq) [+ bias] (`__fadd_rn`; the TPU kernel's
// `x + deq + b2`). No FMA contraction is possible in the epilogue, so on
// the same int8 operands the kernel gives the plain version's result
// (ops/fused_stack_int8.py::gemm_i8_plain) bit for bit.
//
// What bounds it on the H100: at M = B*N = 16384 rows these products do
// ~360 to ~650 operations per byte they must move, around the int8 ridge
// of ~590 (1979 TOPS dense at 700 W over 3.35 TB/s): the QKV product is
// bound by the tensor cores; the expand product's float32 output and the
// contract product's float32 residual (read and written) make the others
// bound by bytes. Either way the operand loads must hide behind the
// multiplies.
//
// What this design does about that: the shape of ln_gemm.cu's streaming
// body. A 128 x 128 output tile per block of 8 warps, each warp a 64 x 32
// sub-tile; A and W stream through a 4-stage `cp.async` ring in k-tiles of
// 64 int8 values (64 bytes a row, rows padded to 80 bytes so that
// `ldmatrix` is conflict-free); `mma.sync.m16n8k32.s8.s8.s32`. The int8
// fragments of m16n8k32 have byte for byte the layout of bf16's m16n8k16
// (a 16-byte row of 16 int8 values is 8 bf16 to `ldmatrix`), so one k32
// slice loads with the same `ldmatrix_x4` addressing as one k16 bf16
// slice, and each `mma` does twice the multiply-adds. The dequantization
// and the epilogue run from the int32 accumulators in registers. Not yet
// used: wgmma's s8 form, TMA, warp specialisation (later work).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;        // int8 values (bytes) of a row of a streamed tile
constexpr int LDT = BK + 16;  // its byte row stride (80: conflict-free ldmatrix)
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = (BM + BN) * LDT;
constexpr int SMEM = STAGES * STAGE_BYTES;

// d += a (16x32 int8, row-major) * b (32x8 int8, column-major), int32 sums.
// Fragments (g = lane / 4, t = lane % 4), each register 4 int8 values:
// a = {(g, 4t..4t+3), (g+8, 4t..), (g, 16+4t..), (g+8, 16+4t..)};
// b = {(k 4t..4t+3, n g), (k 16+4t.., n g)}; d as in m16n8k16.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
gemm_i8_kernel(const int8_t* __restrict__ a, const float* __restrict__ rs,
               const int8_t* __restrict__ w, const float* __restrict__ cs,
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
    unsigned char* as = smem + stage * STAGE_BYTES;
    unsigned char* ws = as + BM * LDT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 bytes, each operand
      const int c = tid + i * THREADS;
      const int r = c >> 2, col = (c & 3) * 16;
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

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* as = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* ws = as + BM * LDT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + (wm * 64 + i * 16 + (lane & 15)) * LDT + kk + (lane >> 4) * 16);
      uint32_t bfr[4][2];
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r4[4];
        ldmatrix_x4(r4, ws + (wn * 32 + j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + kk +
                            ((lane >> 3) & 1) * 16);
        bfr[2 * j2][0] = r4[0];
        bfr[2 * j2][1] = r4[1];
        bfr[2 * j2 + 1][0] = r4[2];
        bfr[2 * j2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_blk + wm * 64 + i * 16 + h * 8 + g;
      if (row >= M) continue;
      const float r = rs[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n_blk + wn * 32 + j * 8 + 2 * t4;
        float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), r), cs[col]);
        float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), r), cs[col + 1]);
        const size_t at = static_cast<size_t>(row) * N + col;
        if (resid != nullptr) {
          float2 x = *reinterpret_cast<float2*>(resid + at);
          x.x = __fadd_rn(x.x, v0);
          x.y = __fadd_rn(x.y, v1);
          if (bias != nullptr) {
            x.x = __fadd_rn(x.x, bias[col]);
            x.y = __fadd_rn(x.y, bias[col + 1]);
          }
          *reinterpret_cast<float2*>(resid + at) = x;
          continue;
        }
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bias[col]);
          v1 = __fadd_rn(v1, bias[col + 1]);
        }
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + at) = pack_bf16x2(v0, v1);
      }
    }
  }
}

}  // namespace

// a: (M, K) int8 rows, rs: (M,) float32 row scales. w: (N, K) int8 (the
// (out, in) layout), cs: (N,) float32 per-output-channel scales. bias: (N,)
// float32 or null. Exactly one of out (M, N) and resid (M, N) float32
// (updated in place) is non-null; out is float32 when out_f32 is non-zero,
// else bf16. Requires N % 128 == 0 and K % 64 == 0; any M >= 1.
LTD_API int ltd_gemm_i8(const void* a, const float* rs, const void* w, const float* cs,
                        const float* bias, void* out, float* resid, int M, int N, int K,
                        int out_f32, void* stream) {
  if (N % BN || K % BK || (out == nullptr) == (resid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(gemm_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_i8_kernel<<<dim3(N / BN, (M + BM - 1) / BM), THREADS, SMEM,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), rs, static_cast<const int8_t*>(w), cs, bias, out, resid, M,
      N, K, out_f32 != 0);
  return static_cast<int>(cudaGetLastError());
}
