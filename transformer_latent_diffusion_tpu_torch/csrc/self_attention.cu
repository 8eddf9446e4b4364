// self_attention: x += softmax(q k^T / sqrt(64)) v, per head, into the float32 residual.
//
// Replaces the self-attention of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (`_mha` over the fused QKV projection, fused_stack.py:40-56 and :72).
//
// What bounds it on the H100: device memory. Per (batch, head) at N = 256
// it reads 3 x 256 x 64 bf16 (96 KB) and reads and writes 256 x 64 float32
// of the residual (128 KB), for 16.8 MFLOP: ~75 FLOP per byte, a quarter of
// the card's balance point. At batch 64 x 12 heads that is 176 MB, 0.053
// ms at 3.35 TB/s; the products alone would take 0.013 ms at 989 TFLOP/s.
//
// What this design does about that: every byte crosses device memory once
// and the copies run behind the products.
// - A persistent grid (one block per SM) walks the (batch, head) pairs.
//   One producer warp brings a pair's Q, K and V with TMA
//   (`cp.async.bulk.tensor`) through a 3-D tensor map over (B, N, 3D), in
//   64 x 64 boxes, 128-byte swizzled, into a ring of two stages with full
//   and empty `mbarrier`s: the next pair's copies are in flight while this
//   one computes, and K and V are read once per (batch, head), not once
//   per query tile. The map's middle dimension is N, so the rows of a
//   ragged last tile past N arrive as zeros and never as the next image's
//   rows.
// - Two consumer warpgroups (`setmaxnreg` gives them the registers) take
//   the query tiles of 64 rows in turn (N = 256: two each). S = Q K^T is
//   `wgmma` m64nNk16 (N = the keys, up to 256) from shared memory, float32
//   accumulation; the row max and sum are float32 over quad shuffles, with
//   log2(e) / 8 folded into one scale for `exp2f`, and one division per
//   row (p = e * (1 / sum): at most one float32 ulp from e / sum before the
//   bf16 rounding, where the TPU kernel rounds, fused_stack.py:54; the
//   plain version keeps the division). Keys past N enter as -inf before
//   the row max. P stays in registers as the A operand of O = P V
//   (`wgmma` m64n64k16, V the MN-major B operand: its rows of 64 head
//   columns are K rows of the product).
// - O is staged in shared memory in the residual map's 128-byte swizzle
//   and added into the float32 residual by a TMA reduce-add
//   (`cp.reduce.async.bulk.tensor .add`) over a 3-D map on (B, N, D):
//   whole lines leave the SM, the residual is never read into it, and rows
//   past N are clipped. Each element has one writer and one float32 add,
//   so two runs give bit-equal residuals.
//
// X1 (a template flag; K1's and K2's instantiation is the other) is the
// body of the bf16 attention pair's route (ops/fused_attn_vjp.py, TPU
// kernel K6): the residual source is the bf16 input x, read by each thread
// at its accumulator positions (issued before the tile's products), and
// x1 = x + O, float32, leaves by a TMA store into x1: the pair makes no
// float32 copy of x, and x1 is written once and read by nothing else
// first. The sum is the reduce-add's (float32 x + O).
//
// Shared memory at N = 256: a stage holds Q, K and V, 3 x 4 boxes of 8 KB
// (96 KB); two stages are 192 KB, the two warpgroups' O staging 2 x 16 KB,
// 224 KB in all plus barriers (227 KB is the limit): hence two stages and
// two consumer warpgroups (the registers allow no third: 2 x 128 threads
// at 232 registers and a producer warpgroup at 40 fill the SM's 64 K).

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;                    // head dim
constexpr int TILE = 64;                  // rows of a TMA box and of a query tile
constexpr int BOX_BYTES = TILE * DH * 2;  // one 64 x 64 bf16 box: 8 KB
constexpr int OUT_BYTES = TILE * DH * 4;  // one query tile's float32 O: two 64 x 32 boxes
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
// log2(e) / sqrt(64): exp((s - m) / 8) = exp2(s * C - m * C)
constexpr float SCALE_LOG2 = 0.18033688011112042f;

__host__ __device__ constexpr int stage_bytes(int nt) { return 3 * nt * BOX_BYTES; }
__host__ __device__ constexpr int smem_bytes(int nt) {
  return STAGES * stage_bytes(nt) + CONSUMERS * OUT_BYTES + 1024 + 2 * STAGES * 8;
}

template <int NT>
__device__ __forceinline__ void scores(float (&s)[NT * 32], uint64_t da, uint64_t db) {
  if constexpr (NT == 1) wgmma_m64n64k16_ss<0, 0>(s, da, db);
  if constexpr (NT == 2) wgmma_m64n128k16_ss<0, 0>(s, da, db);
  if constexpr (NT == 3) wgmma_m64n192k16_ss<0, 0>(s, da, db);
  if constexpr (NT == 4) wgmma_m64n256k16_ss<0, 0>(s, da, db);
}

// NT = ceil(N / 64) (1..4): the keys of a pair fill NT boxes; X1: x1 = x
// + O stored (x bf16 (B*N, D)), else O added into the residual
template <int NT, bool X1>
__global__ void __launch_bounds__(THREADS, 1)
self_attention_kernel(const __grid_constant__ CUtensorMap map_qkv,
                      const __grid_constant__ CUtensorMap map_res, const bf16* __restrict__ x,
                      int n_pairs, int n_heads, int N, int D) {
  constexpr int SB = stage_bytes(NT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * SB + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
        const int b = p / n_heads, col = (p % n_heads) * DH;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], SB);
        unsigned char* q = smem + stage * SB;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          tma_load_3d(q + t * BOX_BYTES, &map_qkv, &full[stage], col, t * TILE, b);
          tma_load_3d(q + (NT + t) * BOX_BYTES, &map_qkv, &full[stage], D + col, t * TILE, b);
          tma_load_3d(q + (2 * NT + t) * BOX_BYTES, &map_qkv, &full[stage], 2 * D + col,
                      t * TILE, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r_lo = (wt >> 5) * 16 + g;  // this thread's rows r_lo and r_lo + 8 of a tile
    unsigned char* obuf = smem + STAGES * SB + wg * OUT_BYTES;
    int stage = 0;
    uint32_t phase = 0;
    for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
      const int b = p / n_heads, col = (p % n_heads) * DH;
      mbar_wait(&full[stage], phase);
      const unsigned char* qs = smem + stage * SB;
      const unsigned char* ks = qs + NT * BOX_BYTES;
      const unsigned char* vs = qs + 2 * NT * BOX_BYTES;
      for (int qt = wg; qt < NT; qt += CONSUMERS) {
        // X1: this thread's 2 x 16 elements of x, in flight during the products
        uint32_t xr[X1 ? 16 : 1];
        if constexpr (X1) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = qt * TILE + r_lo + 8 * h;
            const bf16* xp = x + (static_cast<size_t>(b) * N + (n < N ? n : 0)) * D + col + 2 * t4;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              xr[8 * h + j] = n < N ? __ldg(reinterpret_cast<const unsigned int*>(xp + 8 * j)) : 0u;
          }
        }
        // S = Q K^T: Q (64 x 64) and K (keys x 64) both K-major
        float s[NT * 32];
#pragma unroll
        for (int i = 0; i < NT * 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          scores<NT>(s, sw128_desc(qs + qt * BOX_BYTES + kk * 32, 16, 1024),
                     sw128_desc(ks + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // float32 row softmax; the 4 lanes of a quad hold rows r_lo, r_lo + 8
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT * 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t4 + (e & 1) >= N) s[4 * j + e] = -INFINITY;
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float off0 = -mx0 * SCALE_LOG2, off1 = -mx1 * SCALE_LOG2;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT * 8; ++j) {
          s[4 * j] = exp2f(fmaf(s[4 * j], SCALE_LOG2, off0));
          s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], SCALE_LOG2, off0));
          s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], SCALE_LOG2, off1));
          s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], SCALE_LOG2, off1));
          sum0 += s[4 * j] + s[4 * j + 1];
          sum1 += s[4 * j + 2] + s[4 * j + 3];
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
        }
        const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;

        // P in bf16, in the A-operand layout of m64k16: block kc holds keys
        // 16 kc .. 16 kc + 15, i.e. accumulator blocks 2 kc and 2 kc + 1
        uint32_t pa[NT * 4][4];
#pragma unroll
        for (int kc = 0; kc < NT * 4; ++kc) {
          const float* s0 = s + 8 * kc;
          pa[kc][0] = pack_bf16x2(s0[0] * inv0, s0[1] * inv0);
          pa[kc][1] = pack_bf16x2(s0[2] * inv1, s0[3] * inv1);
          pa[kc][2] = pack_bf16x2(s0[4] * inv0, s0[5] * inv0);
          pa[kc][3] = pack_bf16x2(s0[6] * inv1, s0[7] * inv1);
        }

        // O = P V: V (keys x 64) is the MN-major B operand
        float o[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < NT * 4; ++kc)
          wgmma_m64n64k16_rs<1>(o, pa[kc], sw128_desc(vs + kc * 2048, BOX_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kc = 0; kc < NT * 4; ++kc) fence_regs(pa[kc]);
        if constexpr (X1) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 xv =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[8 * h + j]));
              o[4 * j + 2 * h] = xv.x + o[4 * j + 2 * h];
              o[4 * j + 2 * h + 1] = xv.y + o[4 * j + 2 * h + 1];
            }
        }

        // stage O as two 64 x 32 float32 boxes in the residual map's
        // 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)),
        // once the previous tile's reduce has read the buffer
        if (wt == 0) bulk_wait_read();
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = 8 * (j & 3) + 2 * t4;  // column within the 32-wide box
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_lo + 8 * h;
            const int off =
                (j >> 2) * (OUT_BYTES / 2) + r * 128 + (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4;
            *reinterpret_cast<float2*>(obuf + off) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        if (wt == 0) {
          if constexpr (X1) {
            tma_store_3d(&map_res, obuf, col, qt * TILE, b);
            tma_store_3d(&map_res, obuf + OUT_BYTES / 2, col + 32, qt * TILE, b);
          } else {
            tma_reduce_add_3d(&map_res, obuf, col, qt * TILE, b);
            tma_reduce_add_3d(&map_res, obuf + OUT_BYTES / 2, col + 32, qt * TILE, b);
          }
          bulk_commit();
        }
      }
      // every wgmma that read this stage has completed
      if (wt == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (wt == 0) bulk_wait();
  }
}

template <int NT, bool X1>
int launch(const void* qkv, float* resid, const bf16* x, int B, int N, int D, int n_heads,
           cudaStream_t s) {
  CUtensorMap map_qkv, map_res;
  const uint64_t qdims[3] = {static_cast<uint64_t>(3 * D), static_cast<uint64_t>(N),
                             static_cast<uint64_t>(B)};
  const uint64_t qstrides[2] = {static_cast<uint64_t>(3 * D) * 2,
                                static_cast<uint64_t>(N) * 3 * D * 2};
  const uint32_t qbox[3] = {DH, TILE, 1};
  const uint64_t rdims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                             static_cast<uint64_t>(B)};
  const uint64_t rstrides[2] = {static_cast<uint64_t>(D) * 4, static_cast<uint64_t>(N) * D * 4};
  const uint32_t rbox[3] = {32, TILE, 1};
  int err = encode_map(&map_qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qkv, qdims, qstrides, qbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = encode_map(&map_res, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, resid, rdims, rstrides, rbox,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const int smem = smem_bytes(NT);
  cudaError_t e = cudaFuncSetAttribute(self_attention_kernel<NT, X1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int pairs = B * n_heads;
  self_attention_kernel<NT, X1><<<pairs < sms ? pairs : sms, THREADS, smem, s>>>(
      map_qkv, map_res, x, pairs, n_heads, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B*N, 3D) bf16, rows [q | k | v], head h at columns h*64 of each.
// resid: (B*N, D) float32, updated in place. Requires D == n_heads * 64,
// 1 <= N <= 256, both 16-byte aligned (TMA).
LTD_API int ltd_self_attention(const void* qkv, float* resid, int B, int N, int D,
                               int n_heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 256 || D != n_heads * DH) return static_cast<int>(cudaErrorInvalidValue);
  switch ((N + TILE - 1) / TILE) {
    case 1: return launch<1, false>(qkv, resid, nullptr, B, N, D, n_heads, s);
    case 2: return launch<2, false>(qkv, resid, nullptr, B, N, D, n_heads, s);
    case 3: return launch<3, false>(qkv, resid, nullptr, B, N, D, n_heads, s);
    default: return launch<4, false>(qkv, resid, nullptr, B, N, D, n_heads, s);
  }
}

// The X1 body: x1 (B*N, D) float32 = x + attention, x (B*N, D) bf16 (the
// attention pair's input rows); otherwise as ltd_self_attention.
LTD_API int ltd_self_attention_x1(const void* qkv, const void* x, float* x1, int B, int N, int D,
                                  int n_heads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 256 || D != n_heads * DH) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  switch ((N + TILE - 1) / TILE) {
    case 1: return launch<1, true>(qkv, x1, xb, B, N, D, n_heads, s);
    case 2: return launch<2, true>(qkv, x1, xb, B, N, D, n_heads, s);
    case 3: return launch<3, true>(qkv, x1, xb, B, N, D, n_heads, s);
    default: return launch<4, true>(qkv, x1, xb, B, N, D, n_heads, s);
  }
}
