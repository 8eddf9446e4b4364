// flash_attention: o = softmax(q k^T / sqrt(64)) v per (image, head), any N >= 8.
//
// Replaces transformer_latent_diffusion_tpu/ops/attention.py::_pallas_attention
// (`_flash_kernel`, pallas_call at attention.py:99): one program per
// (batch*head, 256-query block) holding the head's whole K and V in VMEM.
//
// What bounds it on the H100: 4 * N^2 * 64 operations per (image, head)
// against 4 * N * 64 * 2 bytes of q, k, v and o, i.e. N / 2 operations per
// byte: at N = 1024 that is 512, above the card's ~295 balance point, so the
// tensor cores bound it (0.21 ms for 64 images x 12 heads at 989 TFLOP/s),
// and more so at 4096 tokens.
//
// What this design does about that: a Hopper SM has 227 KB of shared
// memory, and one head's K and V are already 256 KB of bf16 at 1024 tokens,
// so unlike the TPU kernel (and the <= 256-token self_attention.cu) it never
// holds a whole score row. One block per (64-query tile, head, image), four
// warps of 16 query rows. The tile's Q goes to shared memory once and to
// registers as `ldmatrix` fragments; K and V stream through a 3-stage
// `cp.async` ring of 64-key tiles (18 KB per stage with padded rows, so
// `ldmatrix` is conflict-free; 63 KB per block, three blocks per SM), so the
// next two tiles load while the warps work on this one. Per tile each warp
// computes its 16 x 64 scores with m16n8k16 bf16 `mma.sync` products
// (float32 accumulation), scales them by 1/8, masks keys past N, and runs
// the online softmax in float32: a running row max m and sum l, the output
// accumulators rescaled by exp(m_old - m_new). p = exp(s - m) is rounded to
// bf16 and reused in registers as the A operand of O += P V (V through a
// transposing `ldmatrix`). After the last tile O / l is rounded to bf16 and
// stored. q, k and v are read by row stride, so the wrapper passes the
// (B*N, 3D) fused QKV rows without transposes; o is written as (B*N, D)
// rows, head h at columns h*64. The ragged last query and key tiles are
// masked (zero-filled rows, -inf scores), so any N >= 8 works.
//
// Rounding differs from the TPU kernel, which normalises p in float32 and
// then rounds it to bf16 before P V; here exp(s - m) is rounded (m is the
// running max, not yet the row's) and the float32 sum of the unrounded
// values divides at the end. Both round p once to bf16 with a float32
// softmax; they differ by about one bf16 step of p.
//
// For training, the wrapper also passes `lse`, and the kernel writes each
// query row's float32 log-sum-exp m + log(l) of the scaled scores there,
// (B, H, Nq) row-major, which the backward (flash_attention_bwd.cu, TPU
// kernel K4) reads to recompute p = exp(s - lse) without a row pass of its
// own. Serving passes null and writes nothing more.
//
// Not yet: `wgmma` and TMA (a later PR).

#include "common.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;
constexpr int LDH = DH + 8;  // bf16 row stride of the Q, K and V tiles in shared memory (144 bytes)
constexpr int QT = 64;       // query rows per block
constexpr int KT = 64;       // keys per streamed tile
constexpr int STAGES = 3;    // K/V tiles in flight
constexpr int THREADS = 128;

constexpr size_t SMEM_BYTES = static_cast<size_t>(QT * LDH + STAGES * 2 * KT * LDH) * sizeof(bf16);

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int Nq, int Nk, int D, int q_row, int k_row,
                       int v_row) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + QT * LDH;  // stage s: K at KVs + s * 2 * KT * LDH, V after it

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bf16* qb = q + b * Nq * q_row + h * DH;
  const bf16* kb = k + b * Nk * k_row + h * DH;
  const bf16* vb = v + b * Nk * v_row + h * DH;
  const int n_tiles = (Nk + KT - 1) / KT;

  // 8 chunks of 16 bytes per row; rows past the end are zero-filled
  auto load_kv = [&](int tile) {
    bf16* Ks = KVs + (tile % STAGES) * 2 * KT * LDH;
    bf16* Vs = Ks + KT * LDH;
    for (int c = tid; c < KT * 8; c += THREADS) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int key = tile * KT + r;
      const bool ok = key < Nk;
      const size_t src = ok ? key : 0;
      cp_async16(&Ks[r * LDH + col], kb + src * k_row + col, ok ? 16 : 0);
      cp_async16(&Vs[r * LDH + col], vb + src * v_row + col, ok ? 16 : 0);
    }
  };

  for (int c = tid; c < QT * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    const bool ok = q0 + r < Nq;
    const size_t src = ok ? q0 + r : 0;
    cp_async16(&Qs[r * LDH + col], qb + src * q_row + col, ok ? 16 : 0);
  }
  load_kv(0);
  cp_async_commit();  // group 0: Q and tile 0
#pragma unroll
  for (int t = 1; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();  // group t: tile t (empty past the end, so the count stays uniform)
  }

  const int wr = warp * 16;
  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  // running max and sum of rows g (0) and g + 8 (1)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this tile's group has landed
    __syncthreads();              // ... for every thread; and the stage refilled below is free
    if (tile + STAGES - 1 < n_tiles) load_kv(tile + STAGES - 1);
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc)
        ldmatrix_x4(qf[kc], &Qs[(wr + (lane & 15)) * LDH + kc * 16 + (lane >> 4) * 8]);
    }
    const bf16* Ks = KVs + (tile % STAGES) * 2 * KT * LDH;
    const bf16* Vs = Ks + KT * LDH;

    // S = Q K^T: rows g and g+8, keys 8j + 2t4 and 8j + 2t4 + 1
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < KT / 16; ++j2) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[(j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH + kc * 16 +
                            ((lane >> 3) & 1) * 8]);
        mma_bf16_16816(s[2 * j2], qf[kc], kf[0], kf[1]);
        mma_bf16_16816(s[2 * j2 + 1], qf[kc], kf[2], kf[3]);
      }
    }

    const int key0 = tile * KT + 2 * t4;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= 0.125f;
        if (key0 + 8 * j + (e & 1) >= Nk) s[j][e] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the 4 lanes of a quad hold one row
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    // every tile holds at least one key, so the new max is finite
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      o[d][0] *= c0;
      o[d][1] *= c0;
      o[d][2] *= c1;
      o[d][3] *= c1;
    }

    // O += P V: P's accumulator layout is the A-operand layout of this product
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < DH / 16; ++d2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &Vs[(kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                                  d2 * 16 + (lane >> 4) * 8]);
        mma_bf16_16816(o[2 * d2], pa, vf[0], vf[1]);
        mma_bf16_16816(o[2 * d2 + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  bf16* o0 = out + (b * Nq + r0) * D + h * DH + 2 * t4;
  bf16* o1 = o0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    if (r0 < Nq)
      *reinterpret_cast<uint32_t*>(o0 + d * 8) = pack_bf16x2(o[d][0] * inv0, o[d][1] * inv0);
    if (r1 < Nq)
      *reinterpret_cast<uint32_t*>(o1 + d * 8) = pack_bf16x2(o[d][2] * inv1, o[d][3] * inv1);
  }
  if (lse != nullptr && t4 == 0) {  // the 4 lanes of a quad hold the same m and l
    float* lb = lse + (b * gridDim.y + h) * Nq;
    if (r0 < Nq) lb[r0] = m0 + logf(l0);
    if (r1 < Nq) lb[r1] = m1 + logf(l1);
  }
}

}  // namespace

// q: (B*Nq, *) bf16 rows with row stride q_row elements, head h at columns
// h*64; k, v: (B*Nk, *) bf16 rows with strides k_row, v_row. out: (B*Nq, D)
// bf16, D = n_heads * 64. lse: null, or (B, n_heads, Nq) float32 for each
// row's log-sum-exp. Row strides are multiples of 8 and the pointers
// 16-byte aligned. Requires Nq, Nk >= 1 (the wrapper asks for >= 8).
LTD_API int ltd_flash_attention(const void* q, const void* k, const void* v, void* out,
                                float* lse, int B, int Nq, int Nk, int n_heads, int q_row,
                                int k_row, int v_row, void* stream) {
  if (Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Nq + QT - 1) / QT, n_heads, B);
  flash_attention_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, Nq, Nk, n_heads * DH, q_row, k_row, v_row);
  return static_cast<int>(cudaGetLastError());
}
