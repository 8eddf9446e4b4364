// flash_attention_bwd: dq, dk, dv of o = softmax(q k^T / sqrt(64)) v per
// (image, head), N tokens with N % 64 == 0.
//
// Replaces transformer_latent_diffusion_tpu/ops/attention.py::
// _pallas_attention_bwd (`_flash_bwd_kernel`, pallas_call at attention.py:247,
// K4a: one program per (batch*head) holding the whole N x N score set in
// VMEM, 512 <= N <= 2048) and ::_pallas_attention_bwd_tiled
// (`_flash_bwd_tiled_kernel`, pallas_call at attention.py:313, K4b: 512-query
// blocks with dk and dv summed in float32 VMEM scratch, N <= 8192). Both
// compute the same function; one design here serves both.
//
// What bounds it on the H100: five products of 2 N^2 64 operations per
// (image, head) (the recomputed q k^T, dp = g v^T, dq = ds k, dk = ds^T q,
// dv = p^T g) against 7 N 64 x 2 bytes (q, k, v, g in, dq, dk, dv out):
// 5 N / 7 operations per byte, 731 at N = 1024, far above the card's ~295
// balance point, so the tensor cores bound it (0.52 ms per layer at 512 px,
// batch 64; 2.08 ms at 1024 px, batch 16). Beside them, the N^2
// exponentials per (image, head) run on the SM's 16 MUFU lanes a clock,
// about half the products' time at head dim 64, so they have to overlap.
//
// What this design does about that. A Hopper SM cannot hold a head's N x N
// set nor its K and V (256 KB of bf16 at 1024 tokens), so two kernels
// stream tiles past a block that stays on chip, the FlashAttention-2/3
// split:
//
//   dq kernel   a persistent grid walks (image, head, 128-query block)
//               items, the blocks of a head one after another, so the SMs
//               that run at once read the same K and V from L2. One
//               producer thread brings the item's Q and g (two 64 x 64
//               boxes each, into one of two buffers, so the next item's
//               arrive during this one) and K and V in 128-key tiles
//               through a ring of four 32 KB stages with full and empty
//               `mbarrier`s, all by TMA over 3-D tensor maps (columns,
//               tokens, images) of the strided q, k, v and g views. Two
//               consumer warpgroups (`setmaxnreg`: 232 registers, the
//               producer's 40) own 64 query rows each. Per key tile:
//               S = Q K^T and dP = g V^T (`wgmma` m64n128k16 from shared
//               memory, float32), p = exp(s / 8 - lse) as one FFMA and one
//               MUFU.EX2, ds = p (dp - D) / 8, rounded to bf16 in registers
//               as the A operand of dq += ds K (`wgmma` m64n64k16, K the
//               MN-major B operand). Step j issues S and dP of tile j, then
//               dq's product of tile j - 1, and waits for the first two
//               only, so the exponentials of tile j run while the tensor
//               cores finish tile j - 1.
//   dkv kernel  items (image, head, 128-key block), K and V of the block
//               double-buffered as the dq kernel's Q; the producer streams
//               64-query stages (Q and g tiles, and their 64 lse and D
//               values by a bulk copy) through a ring of six. Each
//               consumer warpgroup owns 64 keys: it takes their K and V
//               into registers once (`ldmatrix` from the swizzled tiles,
//               then frees the buffer), as the A operands of s^T = K Q^T
//               and dp^T = V g^T (m64n64k16, so the stream's products read
//               only Q and g from shared memory), keeps dk and dv in
//               float32 registers over the whole stream, and takes p^T
//               and ds^T as above, then dv += bf16(p^T) g and
//               dk += bf16(ds^T) Q (p^T and ds^T the register A operands,
//               g and Q the MN-major B operands), issued behind the next
//               stage's s^T and dp^T.
//
// Each output element has one writer (dq by its query block, dk and dv by
// their key block) and every sum runs in a fixed order, so two launches are
// bit-equal; the cost is the recompute of q k^T and g v^T in both kernels
// (7 products instead of 5) where a single kernel would sum dq over the
// key blocks.
//
// Row statistics: lse, each query row's log-sum-exp, comes from the forward
// (flash_attention.cu with `lse`). D = rowsum(p * dp) is computed as
// rowsum(g * o) = g . (p v), by the dq kernel (two threads per row) from
// the forward's bf16 output o, and written to `delta` for the dkv kernel,
// which runs after it on the same stream. The TPU kernel sums p * dp in
// float32; o here is rounded to bf16, so D differs by about one bf16 step
// of o (held against the plain version at rel-L2 < 1e-2 per output). ds
// and p are rounded to bf16 before their products, as the TPU kernel
// rounds them (attention.py:226-227); every sum is float32.
//
// Rows past N of a ragged last 128-row block (N % 128 == 64) arrive from
// the tensor maps as zeros: query rows past N add nothing (zero Q and g)
// and are neither read from lse nor stored, keys past N get ds = 0 in the
// dq kernel and are not stored by the dkv kernel. dq, dk and dv are
// written from the registers as (B*N, D) rows, head h at columns h*64.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;
constexpr int BOX = 64 * DH * 2;  // one 64 x 64 bf16 TMA box: 8 KB
constexpr int CONSUMERS = 2;      // consumer warpgroups, 64 rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int BLOCK = 64 * CONSUMERS;  // rows of an item: queries (dq) or keys (dkv)
constexpr float SCALE = 0.125f;        // 1 / sqrt(64)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float C2 = SCALE * LOG2E;  // exp(s / 8 - lse) = exp2(s C2 - lse log2 e)

// dq kernel: the item's Q and g (two buffers), then the ring of K/V tiles
constexpr int DQ_KT = 128;                   // keys per stage
constexpr int DQ_ITEM_BYTES = 4 * BOX;       // Q and g of 128 queries
constexpr int DQ_STAGE_BYTES = 4 * BOX;      // K and V of 128 keys
constexpr int DQ_STAGES = 4;
constexpr int DQ_SMEM = 1024 + 2 * DQ_ITEM_BYTES + DQ_STAGES * DQ_STAGE_BYTES +
                        CONSUMERS * 64 * 4 + (2 * DQ_STAGES + 4) * 8;
// dkv kernel: the item's K and V (two buffers), then the ring of query
// stages: Q and g tiles of 64 queries, their lse and D
constexpr int KV_ITEM_BYTES = 4 * BOX;
constexpr int KV_STAGE_BYTES = 2 * BOX + 1024;  // 512 bytes of lse and D, padded to 1 KB
constexpr int KV_STAGES = 6;
constexpr int DKV_SMEM = 1024 + 2 * KV_ITEM_BYTES + KV_STAGES * KV_STAGE_BYTES +
                         (2 * KV_STAGES + 4) * 8;

// d (64 x 128) = A B^T, A a 64-row tile, B a 128-row tile (two boxes),
// both K-major (issued, not committed)
__device__ __forceinline__ void issue_abt128(float (&d)[64], const unsigned char* a,
                                             const unsigned char* b) {
  wgmma_m64n128k16_ss_first(d, sw128_desc(a, 16, 1024), sw128_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < DH / 16; ++kk)
    wgmma_m64n128k16_ss<0, 0>(d, sw128_desc(a + kk * 32, 16, 1024),
                              sw128_desc(b + kk * 32, 16, 1024));
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_g, const bf16* __restrict__ o,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int B, int N, int H,
                    int o_row, int g_row) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ibuf = smem;  // item buffer i: Q (two boxes), then g
  unsigned char* ring = smem + 2 * DQ_ITEM_BYTES;
  float* dsh = reinterpret_cast<float*>(ring + DQ_STAGES * DQ_STAGE_BYTES);  // D per warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(dsh + CONSUMERS * 64);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* ifull = empty + DQ_STAGES;
  uint64_t* iempty = ifull + 2;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < DQ_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ifull[i], 1);
      mbar_init(&iempty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_qb = (N + BLOCK - 1) / BLOCK;
  const int items = B * H * n_qb;
  const int n_tiles = (N + DQ_KT - 1) / DQ_KT;

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0, qi = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
        const int b = it / (H * n_qb), col = ((it / n_qb) % H) * DH, q0 = (it % n_qb) * BLOCK;
        const int ib = qi & 1;
        mbar_wait(&iempty[ib], ((qi >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&ifull[ib], DQ_ITEM_BYTES);
        unsigned char* dst = ibuf + ib * DQ_ITEM_BYTES;
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) {
          tma_load_3d(dst + w * BOX, &map_q, &ifull[ib], col, q0 + 64 * w, b);
          tma_load_3d(dst + (CONSUMERS + w) * BOX, &map_g, &ifull[ib], col, q0 + 64 * w, b);
        }
        for (int t = 0; t < n_tiles; ++t) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], DQ_STAGE_BYTES);
          unsigned char* st = ring + stage * DQ_STAGE_BYTES;
          tma_load_3d(st, &map_k, &full[stage], col, t * DQ_KT, b);
          tma_load_3d(st + BOX, &map_k, &full[stage], col, t * DQ_KT + 64, b);
          tma_load_3d(st + 2 * BOX, &map_v, &full[stage], col, t * DQ_KT, b);
          tma_load_3d(st + 3 * BOX, &map_v, &full[stage], col, t * DQ_KT + 64, b);
          if (++stage == DQ_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r_lo = (wt >> 5) * 16 + (lane >> 2);  // this thread's rows r_lo, r_lo + 8
  const int D = H * DH;
  float* dw = dsh + wg * 64;
  if (wg == 1) named_barrier_arrive(3, 256);  // warpgroup 0 takes the first turn
  int stage = 0, qi = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
    const int b = it / (H * n_qb), h = (it / n_qb) % H;
    const int q0 = (it % n_qb) * BLOCK + wg * 64;  // this warpgroup's first query
    const size_t bh = static_cast<size_t>(b) * H + h;
    // D = rowsum(g * o) of the warpgroup's 64 rows: two threads per row,
    // 32 columns each, from the bf16 views in device memory
    {
      const int r = wt >> 1, half = wt & 1, row = q0 + r;
      float acc = 0.f;
      if (row < N) {
        const size_t tok = static_cast<size_t>(b) * N + row;
        const bf16* gr = g + tok * g_row + h * DH + half * 32;
        const bf16* orow = o + tok * o_row + h * DH + half * 32;
#pragma unroll
        for (int c = 0; c < 32; c += 8) {
          const uint4 gu = *reinterpret_cast<const uint4*>(gr + c);
          const uint4 ou = *reinterpret_cast<const uint4*>(orow + c);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gu);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ou);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(g2[e]);
            const float2 c2 = __bfloat1622float2(o2[e]);
            acc += a.x * c2.x + a.y * c2.y;
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (!half) {
        dw[r] = acc;
        if (row < N) delta[bh * N + row] = acc;
      }
    }
    named_barrier(1 + wg, 128);
    const int r0 = q0 + r_lo, r1 = r0 + 8;
    const float d0 = dw[r_lo], d1 = dw[r_lo + 8];
    const float nl0 = r0 < N ? -lse[bh * N + r0] * LOG2E : 0.f;
    const float nl1 = r1 < N ? -lse[bh * N + r1] * LOG2E : 0.f;
    named_barrier(1 + wg, 128);  // dw is read: the next item may write it

    const int ib = qi & 1;
    mbar_wait(&ifull[ib], (qi >> 1) & 1);
    const unsigned char* qw = ibuf + ib * DQ_ITEM_BYTES + wg * BOX;
    const unsigned char* gw = qw + CONSUMERS * BOX;

    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    fence_regs(acc);
    float s[64], dp[64];
    uint32_t f[8][4];
    int prev = 0;
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * DQ_STAGE_BYTES;
      named_barrier(3 + wg, 256);
      wgmma_fence();
      issue_abt128(s, qw, st);
      issue_abt128(dp, gw, st + 2 * BOX);
      wgmma_commit();
      if (t > 0) {
        wgmma_ab64_rs<8>(acc, f, ring + prev * DQ_STAGE_BYTES);  // dq += ds K of tile t - 1
        wgmma_commit();
        named_barrier_arrive(3 + (wg ^ 1), 256);
        wgmma_wait<1>();
      } else {
        named_barrier_arrive(3 + (wg ^ 1), 256);
        wgmma_wait<0>();
      }
      fence_regs(s);
      fence_regs(dp);
      // ds = p (dp - D) / 8, p = exp(s / 8 - lse): rows r_lo (e < 2), r_lo + 8
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = exp2_approx(fmaf(s[4 * j], C2, nl0));
        const float p1 = exp2_approx(fmaf(s[4 * j + 1], C2, nl0));
        const float p2 = exp2_approx(fmaf(s[4 * j + 2], C2, nl1));
        const float p3 = exp2_approx(fmaf(s[4 * j + 3], C2, nl1));
        s[4 * j] = p0 * (dp[4 * j] - d0) * SCALE;
        s[4 * j + 1] = p1 * (dp[4 * j + 1] - d0) * SCALE;
        s[4 * j + 2] = p2 * (dp[4 * j + 2] - d1) * SCALE;
        s[4 * j + 3] = p3 * (dp[4 * j + 3] - d1) * SCALE;
      }
      if ((t + 1) * DQ_KT > N) {  // the ragged last tile: keys past N add nothing
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (t * DQ_KT + 8 * j + 2 * t4 + (e & 1) >= N) s[4 * j + e] = 0.f;
      }
      if (t > 0) {
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(f);
        if (wt == 0) mbar_arrive(&empty[prev]);  // tile t - 1's products are done
      }
      pack_frags(f, s);
      prev = stage;
      if (++stage == DQ_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    named_barrier(3 + wg, 256);
    wgmma_fence();
    wgmma_ab64_rs<8>(acc, f, ring + prev * DQ_STAGE_BYTES);
    wgmma_commit();
    named_barrier_arrive(3 + (wg ^ 1), 256);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(f);
    if (wt == 0) {
      mbar_arrive(&empty[prev]);
      mbar_arrive(&iempty[ib]);  // every product that read this item's Q and g is done
    }
    store_acc64(dq, D, static_cast<size_t>(b) * N, r0, N, h * DH + 2 * t4, acc);
  }
  if (wg == 0) named_barrier(3, 256);  // the last pass of warpgroup 1
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_g, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int B, int N, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ibuf = smem;  // item buffer i: K (two boxes), then V
  unsigned char* ring = smem + 2 * KV_ITEM_BYTES;  // stage: Q, g, 64 lse, 64 D
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + KV_STAGES * KV_STAGE_BYTES);
  uint64_t* empty = full + KV_STAGES;
  uint64_t* ifull = empty + KV_STAGES;
  uint64_t* iempty = ifull + 2;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ifull[i], 1);
      mbar_init(&iempty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_kb = (N + BLOCK - 1) / BLOCK;
  const int items = B * H * n_kb;
  const int n_tiles = N / 64;

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0, ki = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++ki) {
        const int b = it / (H * n_kb), h = (it / n_kb) % H, k0 = (it % n_kb) * BLOCK;
        const int col = h * DH;
        const size_t stat = (static_cast<size_t>(b) * H + h) * N;
        const int ib = ki & 1;
        mbar_wait(&iempty[ib], ((ki >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&ifull[ib], KV_ITEM_BYTES);
        unsigned char* dst = ibuf + ib * KV_ITEM_BYTES;
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) {
          tma_load_3d(dst + w * BOX, &map_k, &ifull[ib], col, k0 + 64 * w, b);
          tma_load_3d(dst + (CONSUMERS + w) * BOX, &map_v, &ifull[ib], col, k0 + 64 * w, b);
        }
        for (int t = 0; t < n_tiles; ++t) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], 2 * BOX + 512);
          unsigned char* st = ring + stage * KV_STAGE_BYTES;
          tma_load_3d(st, &map_q, &full[stage], col, t * 64, b);
          tma_load_3d(st + BOX, &map_g, &full[stage], col, t * 64, b);
          bulk_load(st + 2 * BOX, lse + stat + t * 64, 256, &full[stage]);
          bulk_load(st + 2 * BOX + 256, delta + stat + t * 64, 256, &full[stage]);
          if (++stage == KV_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r_lo = (wt >> 5) * 16 + (lane >> 2);
  const int D = H * DH;
  if (wg == 1) named_barrier_arrive(3, 256);  // warpgroup 0 takes the first turn
  int stage = 0, ki = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++ki) {
    const int b = it / (H * n_kb), h = (it / n_kb) % H;
    const int k0 = (it % n_kb) * BLOCK + wg * 64;  // this warpgroup's first key
    const int ib = ki & 1;
    mbar_wait(&ifull[ib], (ki >> 1) & 1);
    const unsigned char* kw = ibuf + ib * KV_ITEM_BYTES + wg * BOX;
    // K and V of this warpgroup's keys as register A operands: the
    // products that read them stream only Q and g from shared memory
    uint32_t kf[4][4], vf[4][4];
    sw128_frags(kf, kw, wt >> 5, lane);
    sw128_frags(vf, kw + CONSUMERS * BOX, wt >> 5, lane);
    named_barrier(1 + wg, 128);
    if (wt == 0) mbar_arrive(&iempty[ib]);  // K and V are in the warpgroup's registers

    float dka[32], dva[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
    fence_regs(dka);
    fence_regs(dva);
    float sT[32], dpT[32];  // rows: this warpgroup's keys; columns: the stage's queries
    uint32_t pa[4][4], dsa[4][4];
    int prev = 0;
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * KV_STAGE_BYTES;
      named_barrier(3 + wg, 256);
      wgmma_fence();
      wgmma_abt64_rs(sT, kf, st);
      wgmma_abt64_rs(dpT, vf, st + BOX);
      wgmma_commit();
      if (t > 0) {
        // dv += p^T g, dk += ds^T Q of stage t - 1
        const unsigned char* sp = ring + prev * KV_STAGE_BYTES;
        wgmma_ab64_rs<4>(dva, pa, sp + BOX);
        wgmma_ab64_rs<4>(dka, dsa, sp);
        wgmma_commit();
        named_barrier_arrive(3 + (wg ^ 1), 256);
        wgmma_wait<1>();
      } else {
        named_barrier_arrive(3 + (wg ^ 1), 256);
        wgmma_wait<0>();
      }
      fence_regs(sT);
      fence_regs(dpT);
      const float* ls = reinterpret_cast<const float*>(st + 2 * BOX);
      const float* ds = ls + 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t4;  // columns qc, qc + 1
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float p =
              exp2_approx(fmaf(sT[4 * j + e], C2, -(odd ? l2.y : l2.x) * LOG2E));
          sT[4 * j + e] = p;
          dpT[4 * j + e] = p * (dpT[4 * j + e] - (odd ? d2.y : d2.x)) * SCALE;
        }
      }
      if (t > 0) {
        wgmma_wait<0>();
        fence_regs(dka);
        fence_regs(dva);
        fence_frags(pa);
        fence_frags(dsa);
        if (wt == 0) mbar_arrive(&empty[prev]);
      }
      pack_frags(pa, sT);
      pack_frags(dsa, dpT);
      prev = stage;
      if (++stage == KV_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    {
      const unsigned char* sp = ring + prev * KV_STAGE_BYTES;
      named_barrier(3 + wg, 256);
      wgmma_fence();
      wgmma_ab64_rs<4>(dva, pa, sp + BOX);
      wgmma_ab64_rs<4>(dka, dsa, sp);
      wgmma_commit();
      named_barrier_arrive(3 + (wg ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_frags(pa);
      fence_frags(dsa);
    }
    if (wt == 0) mbar_arrive(&empty[prev]);
    const size_t base = static_cast<size_t>(b) * N;
    store_acc64(dk, D, base, k0 + r_lo, N, h * DH + 2 * t4, dka);
    store_acc64(dv, D, base, k0 + r_lo, N, h * DH + 2 * t4, dva);
  }
  if (wg == 0) named_barrier(3, 256);  // the last pass of warpgroup 1
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

// a 3-D map over the (B, N, row) view: columns [0, D), N tokens, B images,
// 64 x 64 boxes, 128-byte swizzle
int view_map(CUtensorMap* map, const void* ptr, int B, int N, int D, int row) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(row) * 2,
                               static_cast<uint64_t>(N) * row * 2};
  const uint32_t box[3] = {DH, 64, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Maps {
  CUtensorMap q, k, v, g;
};

int make_maps(Maps* m, const void* q, const void* k, const void* v, const void* g, int B, int N,
              int H, int q_row, int k_row, int v_row, int g_row) {
  if (B < 1 || N < 64 || N % 64 || H < 1 || q_row % 8 || k_row % 8 || v_row % 8 || g_row % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = H * DH;
  if (int err = view_map(&m->q, q, B, N, D, q_row)) return err;
  if (int err = view_map(&m->k, k, B, N, D, k_row)) return err;
  if (int err = view_map(&m->v, v, B, N, D, v_row)) return err;
  return view_map(&m->g, g, B, N, D, g_row);
}

int grid_for(int items) {
  const int sms = sm_count();
  return items < sms ? items : sms;
}

}  // namespace

// q, k, v, o, g: (B*N, *) bf16 rows with row strides q_row, k_row, v_row,
// o_row, g_row elements, head h at columns h*64 (o the forward's output, g
// the gradient of o). lse: (B, n_heads, N) float32 from the forward. delta:
// (B, n_heads, N) float32, written here (rowsum(g * o)). dq: (B*N, D) bf16,
// D = n_heads * 64. Row strides are multiples of 8, the pointers 16-byte
// aligned (TMA), N % 64 == 0. Run it before ltd_flash_attention_bwd_dkv.
LTD_API int ltd_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                       const void* g, const float* lse, float* delta, void* dq,
                                       int B, int N, int n_heads, int q_row, int k_row, int v_row,
                                       int o_row, int g_row, void* stream) {
  Maps m;
  if (int err = make_maps(&m, q, k, v, g, B, N, n_heads, q_row, k_row, v_row, g_row)) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = B * n_heads * ((N + BLOCK - 1) / BLOCK);
  flash_bwd_dq_kernel<<<grid_for(items), THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m.q, m.k, m.v, m.g, static_cast<const bf16*>(o), static_cast<const bf16*>(g), lse, delta,
      static_cast<bf16*>(dq), B, N, n_heads, o_row, g_row);
  return static_cast<int>(cudaGetLastError());
}

// The same q, k, v, g, lse and the delta the dq kernel wrote (both 16-byte
// aligned); dk, dv: (B*N, D) bf16.
LTD_API int ltd_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* g, const float* lse, const float* delta,
                                        void* dk, void* dv, int B, int N, int n_heads, int q_row,
                                        int k_row, int v_row, int g_row, void* stream) {
  Maps m;
  if (int err = make_maps(&m, q, k, v, g, B, N, n_heads, q_row, k_row, v_row, g_row)) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = B * n_heads * ((N + BLOCK - 1) / BLOCK);
  flash_bwd_dkv_kernel<<<grid_for(items), THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m.q, m.k, m.v, m.g, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, N,
      n_heads);
  return static_cast<int>(cudaGetLastError());
}
