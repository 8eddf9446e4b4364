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
// Softmax variants (the probe scripts/probe_attn_softmax.py, `attn` /
// `_kernel`, pallas_call at :55: the same attention with the whole key row in
// VMEM, in four forms) are template flags of the same kernel; K3 is
// <EXP2 = false, PREDIV = false>, and its arithmetic is unchanged by them.
// - EXP2: exp(x) as exp2(x log2 e). log2 e is folded into the score scale
//   (1/8 * log2 e), so the running max, the rescale factors and
//   p = exp2f(s - m) are in base 2. NVCC_FLAGS has no fast math, so
//   `expf` is not `__expf`; what each form compiles to (cuobjdump -sass) is
//   in PERF.md.
// - PREDIV: p normalised in float32 before it is rounded to bf16, as the TPU
//   K3 and the probe's "prediv" form round it: (e / z) -> bf16, then P V.
//   z is needed first, so the key tiles are read twice: pass 1 streams K
//   only and takes the online row max m and sum l; pass 2 streams K and V
//   again, p = exp(s - m) / l (a float32 division per score, as the probe
//   asks), rounded to bf16 and accumulated without rescaling, and O is
//   stored undivided. Without PREDIV ("postdiv", K3's own form) e = exp(s -
//   m_running) is rounded and O / l is taken once at the end.
// The ring of cp.async stages runs over both passes as one sequence of
// 2 * n_tiles tiles, so pass 2's first tiles load while pass 1 ends.
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

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <bool EXP2>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (EXP2)
    return exp2f(x);
  else
    return expf(x);
}

// O += P V for one warp's 16 query rows and a 64-key tile: P (the float32
// scores s, already exponentiated) is rounded to bf16 in the accumulator
// layout, which is the A-operand layout of this product; V through a
// transposing `ldmatrix`.
__device__ __forceinline__ void accumulate_pv(float (&o)[DH / 8][4], const float (&s)[KT / 8][4],
                                              const bf16* Vs, int lane) {
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

template <bool EXP2, bool PREDIV>
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
  // PREDIV reads the key tiles twice: steps [0, n_tiles) are pass 1 (K only)
  const int n_steps = PREDIV ? 2 * n_tiles : n_tiles;

  // 8 chunks of 16 bytes per row; rows past the end are zero-filled. Step
  // `step` goes to ring stage step % STAGES and holds key tile step % n_tiles.
  auto load_kv = [&](int step) {
    bf16* Ks = KVs + (step % STAGES) * 2 * KT * LDH;
    bf16* Vs = Ks + KT * LDH;
    const int tile = PREDIV ? step % n_tiles : step;
    const bool with_v = !PREDIV || step >= n_tiles;
    for (int c = tid; c < KT * 8; c += THREADS) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int key = tile * KT + r;
      const bool ok = key < Nk;
      const size_t src = ok ? key : 0;
      cp_async16(&Ks[r * LDH + col], kb + src * k_row + col, ok ? 16 : 0);
      if (with_v) cp_async16(&Vs[r * LDH + col], vb + src * v_row + col, ok ? 16 : 0);
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
    if (t < n_steps) load_kv(t);
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

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();  // this step's group has landed
    __syncthreads();              // ... for every thread; and the stage refilled below is free
    if (step + STAGES - 1 < n_steps) load_kv(step + STAGES - 1);
    cp_async_commit();
    const int tile = PREDIV ? step % n_tiles : step;
    if (step == 0) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc)
        ldmatrix_x4(qf[kc], &Qs[(wr + (lane & 15)) * LDH + kc * 16 + (lane >> 4) * 8]);
    }
    const bf16* Ks = KVs + (step % STAGES) * 2 * KT * LDH;
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
    // EXP2: scores in base 2 (the scale times log2 e)
    constexpr float scale = EXP2 ? 0.125f * LOG2E : 0.125f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale;
        if (key0 + 8 * j + (e & 1) >= Nk) s[j][e] = -INFINITY;
      }
    if constexpr (PREDIV) {
      if (step >= n_tiles) {  // pass 2: p = exp(s - m) / l, rounded, then O += P V
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          s[j][0] = exp_of<EXP2>(s[j][0] - m0) / l0;
          s[j][1] = exp_of<EXP2>(s[j][1] - m0) / l0;
          s[j][2] = exp_of<EXP2>(s[j][2] - m1) / l1;
          s[j][3] = exp_of<EXP2>(s[j][3] - m1) / l1;
        }
        accumulate_pv(o, s, Vs, lane);
        continue;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
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
    const float c0 = exp_of<EXP2>(m0 - mx0), c1 = exp_of<EXP2>(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = exp_of<EXP2>(s[j][0] - mx0);
      s[j][1] = exp_of<EXP2>(s[j][1] - mx0);
      s[j][2] = exp_of<EXP2>(s[j][2] - mx1);
      s[j][3] = exp_of<EXP2>(s[j][3] - mx1);
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
    if constexpr (PREDIV) continue;  // pass 1 takes only m and l
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      o[d][0] *= c0;
      o[d][1] *= c0;
      o[d][2] *= c1;
      o[d][3] *= c1;
    }
    accumulate_pv(o, s, Vs, lane);
  }
  cp_async_wait<0>();

  // PREDIV's P was normalised already
  const float inv0 = PREDIV ? 1.f : 1.f / l0, inv1 = PREDIV ? 1.f : 1.f / l1;
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
    // in natural-log units (EXP2's m is in base 2)
    if (r0 < Nq) lb[r0] = (EXP2 ? m0 * LN2 : m0) + logf(l0);
    if (r1 < Nq) lb[r1] = (EXP2 ? m1 * LN2 : m1) + logf(l1);
  }
}

template <bool EXP2, bool PREDIV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Nq,
           int Nk, int n_heads, int q_row, int k_row, int v_row, void* stream) {
  if (Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<EXP2, PREDIV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Nq + QT - 1) / QT, n_heads, B);
  flash_attention_kernel<EXP2, PREDIV>
      <<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Nq, Nk, n_heads * DH,
          q_row, k_row, v_row);
  return static_cast<int>(cudaGetLastError());
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
  return launch<false, false>(q, k, v, out, lse, B, Nq, Nk, n_heads, q_row, k_row, v_row,
                              stream);
}

// The softmax variants of the probe (see the header), with the operands of
// ltd_flash_attention and no lse: use_exp2 and prediv select the form.
LTD_API int ltd_flash_attention_variant(const void* q, const void* k, const void* v, void* out,
                                        int B, int Nq, int Nk, int n_heads, int q_row,
                                        int k_row, int v_row, int use_exp2, int prediv,
                                        void* stream) {
  if (use_exp2)
    return prediv ? launch<true, true>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                       v_row, stream)
                  : launch<true, false>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                        v_row, stream);
  return prediv ? launch<false, true>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                      v_row, stream)
                : launch<false, false>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                       v_row, stream);
}
