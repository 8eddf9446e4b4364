// self_attention: x += softmax(q k^T / sqrt(64)) v, per head, into the float32 residual.
//
// Replaces the self-attention of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (`_mha` over the fused QKV projection, fused_stack.py:40-56 and :72).
//
// What bounds it on the H100: per (batch, head) it reads 3 x 256 x 64 bf16
// (96 KB) and does 2 x 2 x 256 x 256 x 64 = 16.8 MFLOP, ~170 FLOP per byte:
// near the card's balance point, so it is bound by how well the loads, the
// two products and the softmax overlap rather than by either peak.
//
// What this design does about that: one block per (batch, head, 64-query
// tile), four warps of 16 query rows each. `cp.async` brings the head's K
// and V for all (<= 256) tokens and the tile's Q into shared memory
// (2 x 36 KB + 9 KB, padded rows so `ldmatrix` is conflict-free), so two
// blocks fit on an SM. Each warp then works in registers only: S = Q K^T as
// m16n8k16 bf16 `mma.sync` products with float32 accumulation (the warp's
// 16 x N score rows stay in registers), the float32 row softmax with quad
// shuffles for the max and the sum, the probabilities rounded to bf16
// (exactly where the TPU kernel rounds them, fused_stack.py:54) and reused
// in registers as the A operand of O = P V (V read with transposing
// `ldmatrix`), and O added into the float32 residual straight from the
// accumulators. Each residual element has one writer, so no atomics. At
// <= 256 tokens the whole score row fits, so no online (flash) rescaling.
//
// Any N <= 256 is taken: the block works on N rounded up to a multiple of
// 64 (its template), the ragged last tile's K, V and Q rows past N are
// zero-filled in shared memory and never read from device memory, key
// columns past N enter the softmax as -inf (before the row max), and query
// rows past N are not written.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;
constexpr int LDH = DH + 8;  // bf16 row stride of Q, K, V in shared memory (144 bytes)
constexpr int QT = 64;       // query rows per block
constexpr int THREADS = 128;

inline size_t smem_bytes(int n) {
  return static_cast<size_t>(2 * n * LDH + QT * LDH) * sizeof(bf16);
}

// NT = ceil(N / 64) (1..4): the warp's score row has 8 * NT tiles of 8 keys
template <int NT>
__global__ void __launch_bounds__(THREADS)
self_attention_kernel(const bf16* __restrict__ qkv, float* __restrict__ resid, int N, int D) {
  constexpr int NP = NT * 64;  // N padded to whole tiles
  constexpr int NK8 = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * LDH;
  bf16* Qs = Vs + NP * LDH;

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * N * row_stride + h * DH;

  // K and V of every token, Q of this tile: 8 chunks of 16 bytes per row;
  // rows past N are zero-filled (src-size 0: nothing is read)
  for (int c = tid; c < NP * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int ok = r < N ? 16 : 0;
    const bf16* src = base + (ok ? r : 0) * row_stride + col;
    cp_async16(&Ks[r * LDH + col], src + D, ok);
    cp_async16(&Vs[r * LDH + col], src + 2 * D, ok);
  }
  for (int c = tid; c < QT * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int ok = q0 + r < N ? 16 : 0;
    cp_async16(&Qs[r * LDH + col], base + (ok ? q0 + r : 0) * row_stride + col, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldmatrix_x4(qf[kc], &Qs[(wr + (lane & 15)) * LDH + kc * 16 + (lane >> 4) * 8]);

  // S = Q K^T * 1/8: rows g and g+8, keys 8j + 2t, 8j + 2t + 1
  float s[NK8][4];
#pragma unroll
  for (int j = 0; j < NK8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < NK8 / 2; ++j2) {
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      uint32_t kb[4];
      ldmatrix_x4(kb, &Ks[(j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH + kc * 16 +
                          ((lane >> 3) & 1) * 8]);
      mma_bf16_16816(s[2 * j2], qf[kc], kb[0], kb[1]);
      mma_bf16_16816(s[2 * j2 + 1], qf[kc], kb[2], kb[3]);
    }
  }

  // float32 row softmax; the 4 lanes of a quad hold one row; keys past N
  // are -inf, so they weigh nothing
  float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < NK8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = 8 * j + 2 * t4 + (e & 1) < N ? s[j][e] * 0.125f : -INFINITY;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NK8; ++j) {
    s[j][0] = expf(s[j][0] - mx0);
    s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1);
    s[j][3] = expf(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }

  // O = P V: P's accumulator layout is the A-operand layout of the next product
  float o[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NP / 16; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(s[2 * kc][0] / sum0, s[2 * kc][1] / sum0);
    pa[1] = pack_bf16x2(s[2 * kc][2] / sum1, s[2 * kc][3] / sum1);
    pa[2] = pack_bf16x2(s[2 * kc + 1][0] / sum0, s[2 * kc + 1][1] / sum0);
    pa[3] = pack_bf16x2(s[2 * kc + 1][2] / sum1, s[2 * kc + 1][3] / sum1);
#pragma unroll
    for (int d2 = 0; d2 < DH / 16; ++d2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, &Vs[(kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + d2 * 16 +
                                (lane >> 4) * 8]);
      mma_bf16_16816(o[2 * d2], pa, vb[0], vb[1]);
      mma_bf16_16816(o[2 * d2 + 1], pa, vb[2], vb[3]);
    }
  }

  // rows past N are neither read nor written
  const int r0 = q0 + wr + g;
  float* x0 = resid + (static_cast<size_t>(b) * N + r0) * D + h * DH + 2 * t4;
  float* x1 = x0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    if (r0 < N) {
      float2* p0 = reinterpret_cast<float2*>(x0 + d * 8);
      float2 a = *p0;
      a.x += o[d][0];
      a.y += o[d][1];
      *p0 = a;
    }
    if (r0 + 8 < N) {
      float2* p1 = reinterpret_cast<float2*>(x1 + d * 8);
      float2 c = *p1;
      c.x += o[d][2];
      c.y += o[d][3];
      *p1 = c;
    }
  }
}

template <int NT>
int launch(const bf16* qkv, float* resid, int B, int N, int D, int n_heads, cudaStream_t s) {
  const size_t smem = smem_bytes(NT * 64);
  cudaError_t err = cudaFuncSetAttribute(
      self_attention_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(NT * 64 / QT, n_heads, B);
  self_attention_kernel<NT><<<grid, THREADS, smem, s>>>(qkv, resid, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B*N, 3D) bf16, rows [q | k | v], head h at columns h*64 of each.
// resid: (B*N, D) float32, updated in place. Requires D == n_heads * 64 and
// 1 <= N <= 256.
LTD_API int ltd_self_attention(const void* qkv, float* resid, int B, int N, int D,
                               int n_heads, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch ((N + 63) / 64) {
    case 1: return launch<1>(q, resid, B, N, D, n_heads, s);
    case 2: return launch<2>(q, resid, B, N, D, n_heads, s);
    case 3: return launch<3>(q, resid, B, N, D, n_heads, s);
    default: return launch<4>(q, resid, B, N, D, n_heads, s);
  }
}
