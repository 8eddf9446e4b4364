// attention_bwd: the backward of the layer's two attentions.
//
// Replaces the attention backward of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel:
// the self-attention (:221-236) and the 2-key cross-attention (:194-209).
// With p the float32 softmax recomputed from q and k, dO the upstream
// gradient of a head's output rounded to bf16, dp = dO v^T and
// ds = p (dp - sum_j dp p) / sqrt(64) rounded to bf16, they give
// dq = ds k, dk = ds^T q and dv = bf16(p)^T dO, each accumulated in
// float32 and rounded to bf16 once (the bf16 dqkv / dqc / dkv operands of
// the weight-gradient products), exactly where the TPU kernel rounds.
//
// Self-attention, what bounds it on the H100: device memory. Per (batch,
// head) at N = 256 it reads q, k, v (3 x 32 KB of bf16) and the float32
// dO (64 KB) and writes dq, dk, dv (96 KB): 256 KB for five 256 x 256 x
// 64 products (42 MFLOP), ~160 FLOP per byte, half the card's balance
// point. At batch 128 x 12 heads that is 402 MB, 0.120 ms at 3.35 TB/s;
// the five products take 0.065 ms at 989 TFLOP/s.
//
// What this design does about that: every input byte crosses device
// memory once, and the next head's copies run behind this one's products.
// - A persistent grid (one block per SM) walks the (batch, head) pairs.
//   At N <= 256 a whole head fits on chip: one producer thread brings Q,
//   K and V by TMA through a 3-D tensor map over (B, N, 3D) in 64 x 64
//   boxes, 128-byte swizzled (rows past N of a ragged last tile arrive as
//   zeros, never as the next image's rows), and dO through a float32 map
//   over (B, N, D) into a staging buffer. The consumers round dO to bf16
//   once, into the swizzled layout the products read, and free the
//   staging buffer at once, so the next pair's dO is loaded while this
//   pair computes; the next pair's Q, K and V are asked of L2 ahead
//   (`cp.async.bulk.prefetch.tensor`) and copied in when this pair is done.
// - Two consumer warpgroups (`setmaxnreg`: 240 registers; the producer's
//   warpgroup 24, all the 168 x 384 a block is given at launch) compute in
//   two phases, every product a `wgmma` with
//   float32 accumulators:
//   1. query-major: both warpgroups on each 64-query tile, each over its
//      own 64-key tiles (kt = wg, wg + 2): s = Q K^T and dp = dO V^T
//      (m64n64k16 from shared memory), the float32 softmax (keys past N
//      -inf before the row max; one MUFU.EX2 per score), with the row max,
//      the row sum of e = exp(s / 8 - m) and the sum of e dp exchanged
//      between the two through shared memory (two named barriers), so
//      p = e / sum and delta = sum_j p dp are the whole row's; then
//      ds = p (dp - delta) / 8 in bf16 registers as the A operand of this
//      warpgroup's part of dq = ds K (K the MN-major B operand). Warpgroup
//      1 hands its part over; warpgroup 0 adds it (one fixed order), stores
//      dq from the registers and each row's max, 1 / sum and delta.
//   2. key-major, a 64-key tile per warpgroup: K and V of the tile as
//      register A operands (`ldmatrix` from the swizzled tile), then over
//      64-query chunks s^T = K Q^T and dp^T = V dO^T, p^T and ds^T from
//      the stored statistics, dv += bf16(p^T) dO and dk += ds^T Q (p^T and
//      ds^T the register A operands, dO and Q the MN-major B operands);
//      chunk c's s^T and dp^T are issued before chunk c - 1's dv and dk
//      products, so the exponentials run while the tensor cores do, and
//      dk and dv stay in float32 registers over the chunks.
//   Seven 64 x N x 64 products where the TPU kernel does five (phase 2
//   recomputes s and dp): the tensor work is not what bounds it. The key
//   split of phase 1 keeps each warpgroup's s and dp at 64 x 128 float32
//   (no spills), where a whole 64 x 256 score row would not leave room.
// - Each output element has one writer (dq by warpgroup 0, dk and dv by
//   the warpgroup of their key tile) and every sum runs in a fixed order,
//   so two launches are bit-equal. Query rows past N carry zero q and dO,
//   so their p^T and ds^T add nothing; no row past N is stored.
//
// Shared memory at N = 256: Q, K, V and the bf16 dO, 4 x 32 KB; the
// float32 dO staging, 64 KB; the statistics and the warpgroups' exchange
// (a 64 x 64 float32 dq part), 20.5 KB: 213 KB of the 227.
//
// Cross-attention: per token two 64-wide dot products per head: 4
// multiply-adds per byte read, memory-bound. One block per (batch, head),
// a warp per token (a lane holds 2 of the head's 64 columns; dot products
// are warp-shuffle sums), dqc written per token, dk and dv of the two
// conditioning tokens summed over the batch element's tokens in registers
// and then over the 8 warps in a fixed order in shared memory. The same
// body with T = float is the cross-attention backward of the float32
// compute dtype (nothing rounded); the float32 self-attention backward is
// attention_bwd_f32.cu.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;
constexpr float SCALE = 0.125f;  // 1 / sqrt(64)

// ------------------------------ self-attention ------------------------------

constexpr int TILE = 64;                   // rows of a TMA box, a query tile and a key tile
constexpr int BOX = TILE * DH * 2;         // one 64 x 64 bf16 box: 8 KB
constexpr int F32_BOX = TILE * DH * 4;     // one 64 x 64 float32 box of dO: 16 KB
constexpr int SA_CONSUMERS = 2;
constexpr int SA_THREADS = (SA_CONSUMERS + 1) * 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float C2 = SCALE * LOG2E;  // exp(s / 8 - m) = exp2(s C2 - m C2)

// NT = ceil(N / 64) (1..4): Q, K, V and dO fill NT boxes each
template <int NT>
struct SaShape {
  static constexpr int NP = NT * TILE;
  static constexpr int QKV_BYTES = 3 * NT * BOX;
  static constexpr int F32_BYTES = NT * F32_BOX;
  // byte offsets: Q, K, V, dO (bf16, NT boxes each), the float32 dO
  // staging, the statistics (per query row: m C2, 1 / sum, delta), the two
  // warpgroups' exchange (row max, sum, sum of e dp: [2][64] each; a
  // 64 x 64 dq part), 4 barriers
  static constexpr int F32_OFF = 4 * NT * BOX;
  static constexpr int STATS_OFF = F32_OFF + F32_BYTES;
  static constexpr int X_OFF = STATS_OFF + 3 * NP * 4;
  static constexpr int BAR_OFF = X_OFF + (3 * 2 * TILE + TILE * DH) * 4;
  static constexpr int SMEM = 1024 + BAR_OFF + 4 * 8;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the float32 dO of pair p (NT boxes of 64 rows) into the staging buffer
template <int NT>
__device__ __forceinline__ void load_do(float* fs, const CUtensorMap* map, uint64_t* bar, int p,
                                        int n_heads) {
  const int b = p / n_heads, col = (p % n_heads) * DH;
  mbar_arrive_expect_tx(bar, SaShape<NT>::F32_BYTES);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    tma_load_3d(reinterpret_cast<unsigned char*>(fs) + t * F32_BOX, map, bar, col, t * TILE, b);
}

template <int NT>
__global__ void __launch_bounds__(SA_THREADS, 1)
self_attention_bwd_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          const __grid_constant__ CUtensorMap map_do, bf16* __restrict__ dqkv,
                          int n_pairs, int n_heads, int N, int D) {
  using S = SaShape<NT>;
  constexpr int NP = S::NP;
  constexpr int KU = (NT + 1) / 2;  // key tiles per warpgroup in phase 1, at most
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* fs = reinterpret_cast<float*>(smem + S::F32_OFF);  // dO in float32, [NP][64]
  float* st_m = reinterpret_cast<float*>(smem + S::STATS_OFF);
  float* st_inv = st_m + NP;
  float* st_dl = st_inv + NP;
  float* xmax = reinterpret_cast<float*>(smem + S::X_OFF);
  float* xsum = xmax + 2 * TILE;
  float* xde = xsum + 2 * TILE;
  float* xdq = xde + 2 * TILE;  // [32][128]: warpgroup 1's dq part, accumulator order
  uint64_t* qkv_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* qkv_empty = qkv_full + 1;
  uint64_t* do_full = qkv_full + 2;
  uint64_t* do_empty = qkv_full + 3;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(qkv_full, 1);
    mbar_init(qkv_empty, SA_CONSUMERS);
    mbar_init(do_full, 1);
    mbar_init(do_empty, SA_CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= SA_CONSUMERS * 128) {
    // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<24>();
    if (tid == SA_CONSUMERS * 128) {
      unsigned char* qs = smem;
      unsigned char* ks = qs + NT * BOX;
      unsigned char* vs = ks + NT * BOX;
      if (static_cast<int>(blockIdx.x) < n_pairs)
        load_do<NT>(fs, &map_do, do_full, blockIdx.x, n_heads);
      int i = 0;
      for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, ++i) {
        const int b = p / n_heads, col = (p % n_heads) * DH;
        mbar_wait(qkv_empty, (i & 1) ^ 1);  // the last pair is done with Q, K, V
        mbar_arrive_expect_tx(qkv_full, S::QKV_BYTES);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          tma_load_3d(qs + t * BOX, &map_qkv, qkv_full, col, t * TILE, b);
          tma_load_3d(ks + t * BOX, &map_qkv, qkv_full, D + col, t * TILE, b);
          tma_load_3d(vs + t * BOX, &map_qkv, qkv_full, 2 * D + col, t * TILE, b);
        }
        const int next = p + gridDim.x;
        if (next < n_pairs) {
          const int nb = next / n_heads, ncol = (next % n_heads) * DH;
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int w = 0; w < 3; ++w) tma_prefetch_3d(&map_qkv, w * D + ncol, t * TILE, nb);
          mbar_wait(do_empty, i & 1);  // this pair's dO has been rounded to bf16
          load_do<NT>(fs, &map_do, do_full, next, n_heads);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r_lo = (wt >> 5) * 16 + g;  // this thread's rows r_lo and r_lo + 8 of a tile
  const size_t stride = 3 * static_cast<size_t>(D);
  int i = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, ++i) {
    const int b = p / n_heads, col = (p % n_heads) * DH;
    const size_t row0 = static_cast<size_t>(b) * N;
    // the tiles through a base the compiler cannot see through, so that it
    // computes each wgmma descriptor next to its product instead of
    // hoisting all of them out of the pair loop (and spilling them)
    unsigned char* qs = smem;
    asm volatile("" : "+l"(qs));
    unsigned char* ks = qs + NT * BOX;
    unsigned char* vs = ks + NT * BOX;
    unsigned char* os = vs + NT * BOX;
    // both warpgroups are done with the last pair's dO and statistics
    named_barrier(1, SA_CONSUMERS * 128);
    mbar_wait(do_full, i & 1);
    // dO to bf16 once, in the 128-byte swizzle of the boxes the products
    // read (16-byte chunk c of row r at chunk c ^ (r % 8))
    for (int idx = tid; idx < NP * 8; idx += SA_CONSUMERS * 128) {
      const int r = idx >> 3, c = idx & 7;
      const float4* src = reinterpret_cast<const float4*>(fs + r * DH + c * 8);
      const float4 a = src[0], bq = src[1];
      uint4 u;
      u.x = pack_bf16x2(a.x, a.y);
      u.y = pack_bf16x2(a.z, a.w);
      u.z = pack_bf16x2(bq.x, bq.y);
      u.w = pack_bf16x2(bq.z, bq.w);
      *reinterpret_cast<uint4*>(os + (r >> 6) * BOX + (r & 63) * 128 + ((c ^ (r & 7)) << 4)) = u;
    }
    fence_proxy_async();  // the bf16 dO is read by wgmma (the async proxy)
    named_barrier(1, SA_CONSUMERS * 128);
    if (wt == 0) mbar_arrive(do_empty);  // the staging buffer is free for the next pair
    mbar_wait(qkv_full, i & 1);

    // phase 1, query-major: both warpgroups on each 64-query tile, each
    // over its own 64-key tiles kt = wg, wg + 2, ..., the row statistics and
    // dq summed across the two in a fixed order through shared memory
    for (int qt = 0; qt < NT; ++qt) {
      const int q0 = qt * TILE;
      float s[KU][32], dp[KU][32];
      // a tile index past NT (NT odd: warpgroup 1's last) multiplies the
      // last tile and is masked below: every wgmma is issued on every path
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int kt = min(wg + 2 * u, NT - 1);
        wgmma_abt64_ss(s[u], qs + qt * BOX, ks + kt * BOX);
        wgmma_abt64_ss(dp[u], os + qt * BOX, vs + kt * BOX);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        fence_regs(s[u]);
        fence_regs(dp[u]);
      }
      // the float32 softmax of rows r_lo (e < 2) and r_lo + 8: keys past N,
      // and the tiles this warpgroup does not have, -inf
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int key0 = (wg + 2 * u) * TILE;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * j + 2 * t4 + (e & 1) >= N) {
              s[u][4 * j + e] = -INFINITY;
              dp[u][4 * j + e] = 0.f;
            }
          mx0 = fmaxf(mx0, fmaxf(s[u][4 * j], s[u][4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[u][4 * j + 2], s[u][4 * j + 3]));
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      if (t4 == 0) {
        xmax[wg * TILE + r_lo] = mx0;
        xmax[wg * TILE + r_lo + 8] = mx1;
      }
      named_barrier(1, SA_CONSUMERS * 128);
      mx0 = fmaxf(xmax[r_lo], xmax[TILE + r_lo]) * C2;
      mx1 = fmaxf(xmax[r_lo + 8], xmax[TILE + r_lo + 8]) * C2;
      // e = exp(s / 8 - m); the sums of e and of e dp
      float sum0 = 0.f, sum1 = 0.f, de0 = 0.f, de1 = 0.f;
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* sj = s[u] + 4 * j;
          const float* dj = dp[u] + 4 * j;
          sj[0] = exp2_approx(fmaf(sj[0], C2, -mx0));
          sj[1] = exp2_approx(fmaf(sj[1], C2, -mx0));
          sj[2] = exp2_approx(fmaf(sj[2], C2, -mx1));
          sj[3] = exp2_approx(fmaf(sj[3], C2, -mx1));
          sum0 += sj[0] + sj[1];
          sum1 += sj[2] + sj[3];
          de0 += sj[0] * dj[0] + sj[1] * dj[1];
          de1 += sj[2] * dj[2] + sj[3] * dj[3];
        }
      sum0 = quad_sum(sum0);
      sum1 = quad_sum(sum1);
      de0 = quad_sum(de0);
      de1 = quad_sum(de1);
      if (t4 == 0) {
        xsum[wg * TILE + r_lo] = sum0;
        xsum[wg * TILE + r_lo + 8] = sum1;
        xde[wg * TILE + r_lo] = de0;
        xde[wg * TILE + r_lo + 8] = de1;
      }
      named_barrier(1, SA_CONSUMERS * 128);
      // p = e / sum; delta = sum_j p dp; ds = p (dp - delta) / 8 in bf16
      const float inv0 = 1.f / (xsum[r_lo] + xsum[TILE + r_lo]);
      const float inv1 = 1.f / (xsum[r_lo + 8] + xsum[TILE + r_lo + 8]);
      const float dl0 = (xde[r_lo] + xde[TILE + r_lo]) * inv0;
      const float dl1 = (xde[r_lo + 8] + xde[TILE + r_lo + 8]) * inv1;
      uint32_t da[KU][4][4];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* sj = s[u] + 4 * j;
          float* dj = dp[u] + 4 * j;
          dj[0] = sj[0] * inv0 * (dj[0] - dl0) * SCALE;
          dj[1] = sj[1] * inv0 * (dj[1] - dl0) * SCALE;
          dj[2] = sj[2] * inv1 * (dj[2] - dl1) * SCALE;
          dj[3] = sj[3] * inv1 * (dj[3] - dl1) * SCALE;
        }
        pack_frags(da[u], dp[u]);
      }
      // this warpgroup's part of dq = ds K
      float dq[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[e] = 0.f;
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < KU; ++u) wgmma_ab64_rs<4>(dq, da[u], ks + min(wg + 2 * u, NT - 1) * BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int u = 0; u < KU; ++u) fence_frags(da[u]);
      // dq = part 0 + part 1: warpgroup 1 hands its part over
      if (wg == 1) {
#pragma unroll
        for (int e = 0; e < 32; ++e) xdq[e * 128 + wt] = dq[e];
      }
      named_barrier(1, SA_CONSUMERS * 128);
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) dq[e] += xdq[e * 128 + wt];
        if (t4 == 0) {
          st_m[q0 + r_lo] = mx0;
          st_inv[q0 + r_lo] = inv0;
          st_dl[q0 + r_lo] = dl0;
          st_m[q0 + r_lo + 8] = mx1;
          st_inv[q0 + r_lo + 8] = inv1;
          st_dl[q0 + r_lo + 8] = dl1;
        }
        store_acc64(dqkv, stride, row0 + q0, r_lo, N - q0, col + 2 * t4, dq);
      }
    }
    // every query row's statistics are in shared memory
    named_barrier(1, SA_CONSUMERS * 128);

    // phase 2, key-major: dk and dv of a 64-key tile over 64-query chunks;
    // chunk c's s^T and dp^T are issued before chunk c - 1's dv and dk
    // products, so its exponentials run while those do
    for (int kt = wg; kt < NT; kt += SA_CONSUMERS) {
      uint32_t kf[4][4], vf[4][4];  // the tile's K and V as register A operands
      sw128_frags(kf, ks + kt * BOX, wt >> 5, lane);
      sw128_frags(vf, vs + kt * BOX, wt >> 5, lane);
      float dk[32], dv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
      fence_regs(dk);
      fence_regs(dv);
      float sT[32], dpT[32];  // rows: this tile's keys; columns: the chunk's queries
      uint32_t pa[4][4], dsa[4][4];
      // p^T and ds^T of chunk c in place, from the stored statistics
      auto grads = [&](int c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qi = c * TILE + 8 * j + 2 * t4;  // columns qi, qi + 1
          const float2 m = *reinterpret_cast<const float2*>(st_m + qi);
          const float2 iv = *reinterpret_cast<const float2*>(st_inv + qi);
          const float2 dl = *reinterpret_cast<const float2*>(st_dl + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const float pv = exp2_approx(fmaf(sT[4 * j + e], C2, -(odd ? m.y : m.x))) *
                             (odd ? iv.y : iv.x);
            sT[4 * j + e] = pv;
            dpT[4 * j + e] = pv * (dpT[4 * j + e] - (odd ? dl.y : dl.x)) * SCALE;
          }
        }
      };
      wgmma_fence();
      wgmma_abt64_rs(sT, kf, qs);
      wgmma_abt64_rs(dpT, vf, os);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      grads(0);
      pack_frags(pa, sT);
      pack_frags(dsa, dpT);
#pragma unroll 1
      for (int c = 1; c < NT; ++c) {
        wgmma_fence();
        wgmma_abt64_rs(sT, kf, qs + c * BOX);
        wgmma_abt64_rs(dpT, vf, os + c * BOX);
        wgmma_commit();
        wgmma_ab64_rs<4>(dv, pa, os + (c - 1) * BOX);
        wgmma_ab64_rs<4>(dk, dsa, qs + (c - 1) * BOX);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sT);
        fence_regs(dpT);
        grads(c);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_frags(pa);
        fence_frags(dsa);
        pack_frags(pa, sT);
        pack_frags(dsa, dpT);
      }
      wgmma_fence();
      wgmma_ab64_rs<4>(dv, pa, os + (NT - 1) * BOX);
      wgmma_ab64_rs<4>(dk, dsa, qs + (NT - 1) * BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_frags(pa);
      fence_frags(dsa);
      const int k0 = kt * TILE;
      store_acc64(dqkv, stride, row0 + k0, r_lo, N - k0, D + col + 2 * t4, dk);
      store_acc64(dqkv, stride, row0 + k0, r_lo, N - k0, 2 * D + col + 2 * t4, dv);
    }
    // every wgmma of this warpgroup that read Q, K or V has completed
    if (wt == 0) mbar_arrive(qkv_empty);
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

template <int NT>
int launch_self(const void* qkv, const float* dout, void* dqkv, int B, int N, int D, int H,
                cudaStream_t s) {
  CUtensorMap map_qkv, map_do;
  const uint64_t qdims[3] = {static_cast<uint64_t>(3 * D), static_cast<uint64_t>(N),
                             static_cast<uint64_t>(B)};
  const uint64_t qstrides[2] = {static_cast<uint64_t>(3 * D) * 2,
                                static_cast<uint64_t>(N) * 3 * D * 2};
  const uint32_t qbox[3] = {DH, TILE, 1};
  const uint64_t ddims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                             static_cast<uint64_t>(B)};
  const uint64_t dstrides[2] = {static_cast<uint64_t>(D) * 4, static_cast<uint64_t>(N) * D * 4};
  const uint32_t dbox[3] = {DH, TILE, 1};
  int err = encode_map(&map_qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qkv, qdims, qstrides, qbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = encode_map(&map_do, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dout, ddims, dstrides, dbox,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  const int smem = SaShape<NT>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(self_attention_bwd_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = B * H;
  const int sms = sm_count();
  self_attention_bwd_kernel<NT><<<pairs < sms ? pairs : sms, SA_THREADS, smem, s>>>(
      map_qkv, map_do, static_cast<bf16*>(dqkv), pairs, H, N, D);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------ cross-attention ------------------------------

constexpr int CA_WARPS = 8;

// Two columns c, c + 1 of a T row as float32 (pair c), the value in T's
// rounding (bf16: rounded to bf16; float32: as it is), and two float32
// values stored as T.
__device__ __forceinline__ float2 ca_pair(const bf16* p, int c) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[c]);
}
__device__ __forceinline__ float2 ca_pair(const float* p, int c) {
  return reinterpret_cast<const float2*>(p)[c];
}
template <typename T>
__device__ __forceinline__ float ca_round(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}
__device__ __forceinline__ void ca_store(bf16* p, int c, float x, float y) {
  reinterpret_cast<uint32_t*>(p)[c] = pack_bf16x2(x, y);
}
__device__ __forceinline__ void ca_store(float* p, int c, float x, float y) {
  reinterpret_cast<float2*>(p)[c] = make_float2(x, y);
}
__device__ __forceinline__ void ca_store1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void ca_store1(float* p, float x) { *p = x; }

// T: the compute dtype of qc, kv, dqc and dkv: bf16 (the TPU kernel's
// rounding points: the output gradient, ds and p rounded to bf16 before
// their products), or float32 (the float32 compute dtype: nothing rounded,
// the same sums)
template <typename T>
__global__ void __launch_bounds__(CA_WARPS * 32)
cross_attention_bwd_kernel(const T* __restrict__ qc, const T* __restrict__ kv,
                           const float* __restrict__ dout, T* __restrict__ dqc,
                           T* __restrict__ dkv, int N, int D) {
  __shared__ float red[CA_WARPS][4][DH];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = h * 32 + lane;  // column pair index within a row
  const T* kvb = kv + static_cast<size_t>(b) * 4 * D;
  const float2 k0 = ca_pair(kvb, c);
  const float2 v0 = ca_pair(kvb, D / 2 + c);
  const float2 k1 = ca_pair(kvb, D + c);
  const float2 v1 = ca_pair(kvb, 3 * D / 2 + c);
  float2 dk0 = make_float2(0.f, 0.f), dk1 = dk0, dv0 = dk0, dv1 = dk0;

  for (int n = warp; n < N; n += CA_WARPS) {
    const size_t row = static_cast<size_t>(b) * N + n;
    const float2 q = ca_pair(qc + row * D, c);
    const float2 gf = reinterpret_cast<const float2*>(dout + row * D)[c];
    const float2 gh = make_float2(ca_round<T>(gf.x), ca_round<T>(gf.y));
    const float s0 = warp_sum(q.x * k0.x + q.y * k0.y) * SCALE;
    const float s1 = warp_sum(q.x * k1.x + q.y * k1.y) * SCALE;
    const float m = fmaxf(s0, s1);
    const float e0 = expf(s0 - m), e1 = expf(s1 - m);
    const float den = e0 + e1;
    const float p0 = e0 / den, p1 = e1 / den;
    const float dp0 = warp_sum(gh.x * v0.x + gh.y * v0.y);
    const float dp1 = warp_sum(gh.x * v1.x + gh.y * v1.y);
    const float dl = dp0 * p0 + dp1 * p1;
    const float ds0 = ca_round<T>(p0 * (dp0 - dl) * SCALE);
    const float ds1 = ca_round<T>(p1 * (dp1 - dl) * SCALE);
    ca_store(dqc + row * D, c, ds0 * k0.x + ds1 * k1.x, ds0 * k0.y + ds1 * k1.y);
    const float pl0 = ca_round<T>(p0);
    const float pl1 = ca_round<T>(p1);
    dk0.x += ds0 * q.x, dk0.y += ds0 * q.y;
    dk1.x += ds1 * q.x, dk1.y += ds1 * q.y;
    dv0.x += pl0 * gh.x, dv0.y += pl0 * gh.y;
    dv1.x += pl1 * gh.x, dv1.y += pl1 * gh.y;
  }
  const float2 parts[4] = {dk0, dv0, dk1, dv1};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[warp][j][2 * lane] = parts[j].x;
    red[warp][j][2 * lane + 1] = parts[j].y;
  }
  __syncthreads();
  // thread t: part j = t / 64 (dk0, dv0, dk1, dv1), column d = t % 64
  const int j = threadIdx.x / DH, d = threadIdx.x % DH;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < CA_WARPS; ++w) t += red[w][j][d];
  const size_t out_row = static_cast<size_t>(2 * b + (j >> 1)) * 2 * D;
  ca_store1(dkv + out_row + (j & 1) * D + h * DH + d, t);
}

}  // namespace

// qkv: (B*N, 3D) bf16 rows [q | k | v] of the forward; dout: (B*N, D)
// float32, the gradient of the attention's output (rounded to bf16 here);
// dqkv: (B*N, 3D) bf16 rows [dq | dk | dv], every row written. Requires
// D == H * 64, 1 <= N <= 256, 16-byte aligned qkv and dout (TMA).
LTD_API int ltd_self_attention_bwd(const void* qkv, const float* dout, void* dqkv, int B, int N,
                                   int D, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || D != H * DH || N < 1 || N > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch ((N + TILE - 1) / TILE) {
    case 1: return launch_self<1>(qkv, dout, dqkv, B, N, D, H, s);
    case 2: return launch_self<2>(qkv, dout, dqkv, B, N, D, H, s);
    case 3: return launch_self<3>(qkv, dout, dqkv, B, N, D, H, s);
    default: return launch_self<4>(qkv, dout, dqkv, B, N, D, H, s);
  }
}

// qc: (B*N, D) bf16 queries; kv: (B*2, 2D) bf16, row 2b+j = [k | v] of
// conditioning token j; dout: (B*N, D) float32, the gradient of the
// attention's output (rounded to bf16 here); dqc: (B*N, D) bf16; dkv:
// (B*2, 2D) bf16 in kv's layout. Requires D == H * 64 (one block per
// (head, batch element): any number of heads).
LTD_API int ltd_cross_attention_bwd(const void* qc, const void* kv, const float* dout, void* dqc,
                                    void* dkv, int B, int N, int D, int H, void* stream) {
  if (H < 1 || D != H * DH) return static_cast<int>(cudaErrorInvalidValue);
  cross_attention_bwd_kernel<bf16>
      <<<dim3(H, B), CA_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(qc), static_cast<const bf16*>(kv), dout,
          static_cast<bf16*>(dqc), static_cast<bf16*>(dkv), N, D);
  return static_cast<int>(cudaGetLastError());
}

// The float32 form (the float32 compute dtype): qc, kv, dqc and dkv
// float32, as ltd_cross_attention_bwd's otherwise; nothing is rounded.
LTD_API int ltd_cross_attention_bwd_f32(const float* qc, const float* kv, const float* dout,
                                        float* dqc, float* dkv, int B, int N, int D, int H,
                                        void* stream) {
  if (H < 1 || D != H * DH) return static_cast<int>(cudaErrorInvalidValue);
  cross_attention_bwd_kernel<float>
      <<<dim3(H, B), CA_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(qc, kv, dout, dqc,
                                                                            dkv, N, D);
  return static_cast<int>(cudaGetLastError());
}
