// head_group_attention: x += attention with one row max shared across a group of heads,
// or with the heads' scores summed into one head, into the float32 residual.
//
// Replaces the self-attention variants of the probe
// scripts/microbench_layer.py (`make_variant` / `_variant_kernel`,
// pallas_call at :252): `_attn_packed_softmax` (attn_mode "packed": the
// per-head scores of all 12 heads concatenated into one (N, 12 N) row, one
// max over it, a per-head denominator), `_paired_mha` ("paired": heads two
// at a time, a max shared by the pair; the TPU multiplies masked K and V
// stacks at twice the operations, which is the same function as per-head
// products with a pair-shared max, and that is what runs here) and
// `_attn_onehead` ("onehead": one head as wide as D, scale still
// 1/sqrt(D / heads) = 1/8; its scores are the per-head scores summed over
// the heads, and one P weighs all D columns of V). Group size 1 is the
// per-head softmax of self_attention.cu.
//
// A shared max underflows a head whose scores all lie more than ~87 below
// the group's max: its denominator is 0 and its output NaN. That is the TPU
// variants' own behaviour, kept here.
//
// What bounds it on the H100: as self_attention.cu (96 KB read and 16.8
// MFLOP per (image, head) at 256 tokens, ~170 operations per byte, near the
// balance point). The shared max costs a second Q K^T pass.
//
// What this design does about that (a simple first kernel): one block per
// (64-query tile, group of heads, image), four warps of 16 query rows.
// Shared memory holds one head at a time, K and V of every token and the
// tile's Q (2 x 36 KB + 9 KB at 256 tokens, padded rows so `ldmatrix` is
// conflict-free). Grouped (SUMMED = false): pass 1, for group size > 1,
// walks the group's heads computing each head's scores (m16n8k16 bf16
// `mma.sync`, float32) and keeps the running row max over all of them;
// pass 2 walks the heads again, recomputes the scores, e = exp(s - M) with
// the group's max M, the head's own float32 row sum z, p = e / z rounded to
// bf16, O = P V, added into the head's 64 residual columns. Summed
// (onehead): pass 1 accumulates S over the heads' 64-column chunks of Q and
// K in the same float32 registers (a head as wide as D does not fit shared
// memory at 256 tokens), then one softmax, p rounded to bf16 and kept in
// registers as A fragments; pass 2 streams V in 64-column chunks and adds
// P V into each chunk's residual columns. Each residual element has one
// writer. Ragged N: as self_attention.cu (zero-filled rows, -inf keys,
// unwritten query rows).

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

// NT = ceil(N / 64) (1..4). SUMMED: one head as wide as D (the group is
// every head); else a max shared by each group of G heads.
template <int NT, bool SUMMED>
__global__ void __launch_bounds__(THREADS)
head_group_attention_kernel(const bf16* __restrict__ qkv, float* __restrict__ resid, int N,
                            int D, int G) {
  constexpr int NP = NT * 64;  // N padded to whole tiles
  constexpr int NK8 = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * LDH;
  bf16* Qs = Vs + NP * LDH;

  const int q0 = blockIdx.x * QT;
  const int heads = SUMMED ? D / DH : G;
  const int h0 = SUMMED ? 0 : blockIdx.y * G;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * 16;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * N * row_stride;

  // head h's Q tile, K and V of every token (each if asked) into shared
  // memory; rows past N are zero-filled. Waits until the previous head's
  // tiles are no longer read, and until the new ones have landed.
  auto load = [&](int h, bool q, bool k, bool v) {
    __syncthreads();
    const bf16* hb = base + h * DH;
    for (int c = tid; c < NP * 8; c += THREADS) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int ok = r < N ? 16 : 0;
      const bf16* src = hb + (ok ? r : 0) * row_stride + col;
      if (k) cp_async16(&Ks[r * LDH + col], src + D, ok);
      if (v) cp_async16(&Vs[r * LDH + col], src + 2 * D, ok);
    }
    if (q) {
      for (int c = tid; c < QT * 8; c += THREADS) {
        const int r = c >> 3, col = (c & 7) * 8;
        const int ok = q0 + r < N ? 16 : 0;
        cp_async16(&Qs[r * LDH + col], hb + (ok ? q0 + r : 0) * row_stride + col, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  // s += Q K^T of the head in shared memory: rows g and g+8, keys 8j + 2t, 8j + 2t + 1
  auto scores = [&](float (&s)[NK8][4]) {
    uint32_t qf[DH / 16][4];
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
      ldmatrix_x4(qf[kc], &Qs[(wr + (lane & 15)) * LDH + kc * 16 + (lane >> 4) * 8]);
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
  };

  // scale by 1/8, keys past N to -inf; returns the rows' max (quad-reduced)
  auto scale_max = [&](float (&s)[NK8][4], float& mx0, float& mx1) {
    mx0 = -3.0e38f;
    mx1 = -3.0e38f;
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
  };

  // e = exp(s - m) in place; returns the rows' float32 sums (quad-reduced)
  auto exp_sum = [&](float (&s)[NK8][4], float m0, float m1, float& sum0, float& sum1) {
    sum0 = 0.f;
    sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK8; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
  };

  // p = e / z rounded to bf16, in the A-operand layout of P V
  auto round_p = [&](const float (&s)[NK8][4], float sum0, float sum1,
                     uint32_t (&pa)[NP / 16][4]) {
#pragma unroll
    for (int kc = 0; kc < NP / 16; ++kc) {
      pa[kc][0] = pack_bf16x2(s[2 * kc][0] / sum0, s[2 * kc][1] / sum0);
      pa[kc][1] = pack_bf16x2(s[2 * kc][2] / sum1, s[2 * kc][3] / sum1);
      pa[kc][2] = pack_bf16x2(s[2 * kc + 1][0] / sum0, s[2 * kc + 1][1] / sum0);
      pa[kc][3] = pack_bf16x2(s[2 * kc + 1][2] / sum1, s[2 * kc + 1][3] / sum1);
    }
  };

  // residual columns h*64.. of this warp's rows += P V of the V in shared memory
  auto add_pv = [&](const uint32_t (&pa)[NP / 16][4], int h) {
    float o[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NP / 16; ++kc) {
#pragma unroll
      for (int d2 = 0; d2 < DH / 16; ++d2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[(kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                                  d2 * 16 + (lane >> 4) * 8]);
        mma_bf16_16816(o[2 * d2], pa[kc], vb[0], vb[1]);
        mma_bf16_16816(o[2 * d2 + 1], pa[kc], vb[2], vb[3]);
      }
    }
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
  };

  float s[NK8][4];
  uint32_t pa[NP / 16][4];
  float m0, m1, sum0, sum1;
  if constexpr (SUMMED) {
    // S = sum over heads of Q_h K_h^T, then one softmax over the keys
#pragma unroll
    for (int j = 0; j < NK8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int hh = 0; hh < heads; ++hh) {
      load(hh, true, true, false);
      scores(s);
    }
    scale_max(s, m0, m1);
    exp_sum(s, m0, m1, sum0, sum1);
    round_p(s, sum0, sum1, pa);
    for (int hh = 0; hh < heads; ++hh) {
      load(hh, false, false, true);
      add_pv(pa, hh);
    }
  } else {
    // pass 1 (groups of more than one head): the row max over the group
    float gm0 = -3.0e38f, gm1 = -3.0e38f;
    if (heads > 1) {
      for (int hh = 0; hh < heads; ++hh) {
        load(h0 + hh, true, true, false);
#pragma unroll
        for (int j = 0; j < NK8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        scores(s);
        scale_max(s, m0, m1);
        gm0 = fmaxf(gm0, m0);
        gm1 = fmaxf(gm1, m1);
      }
    }
    // pass 2: each head's e = exp(s - M), its own sum, P V
    for (int hh = 0; hh < heads; ++hh) {
      load(h0 + hh, true, true, true);
#pragma unroll
      for (int j = 0; j < NK8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      scores(s);
      scale_max(s, m0, m1);
      if (heads > 1) {
        m0 = gm0;
        m1 = gm1;
      }
      exp_sum(s, m0, m1, sum0, sum1);
      round_p(s, sum0, sum1, pa);
      add_pv(pa, h0 + hh);
    }
  }
}

template <int NT>
int launch(const bf16* qkv, float* resid, int B, int N, int D, int n_heads, int group,
           int summed, cudaStream_t s) {
  const size_t smem = smem_bytes(NT * 64);
  auto kernel = summed ? head_group_attention_kernel<NT, true> : head_group_attention_kernel<NT, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(NT * 64 / QT, summed ? 1 : n_heads / group, B);
  kernel<<<grid, THREADS, smem, s>>>(qkv, resid, N, D, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B*N, 3D) bf16, rows [q | k | v], head h at columns h*64 of each.
// resid: (B*N, D) float32, updated in place. summed != 0: one head as wide
// as D (group not read); else one row max per group of `group` heads, with
// n_heads % group == 0. Requires D == n_heads * 64 and 1 <= N <= 256.
LTD_API int ltd_head_group_attention(const void* qkv, float* resid, int B, int N, int D,
                                     int n_heads, int group, int summed, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 256 || D != n_heads * DH) return static_cast<int>(cudaErrorInvalidValue);
  if (!summed && (group < 1 || n_heads % group)) return static_cast<int>(cudaErrorInvalidValue);
  switch ((N + 63) / 64) {
    case 1: return launch<1>(q, resid, B, N, D, n_heads, group, summed, s);
    case 2: return launch<2>(q, resid, B, N, D, n_heads, group, summed, s);
    case 3: return launch<3>(q, resid, B, N, D, n_heads, group, summed, s);
    default: return launch<4>(q, resid, B, N, D, n_heads, group, summed, s);
  }
}
