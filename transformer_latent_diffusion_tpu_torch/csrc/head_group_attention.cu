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
// What bounds it on the H100: device memory, as self_attention.cu. At batch
// 256, 256 tokens and 12 heads it must read qkv (302 MB) and read and write
// the float32 residual (403 MB): 0.210 ms at 3.35 TB/s, against 0.052 ms
// for its products at 989 TFLOP/s. The grouped modes' shared max costs a
// second Q K^T for G - 1 of a group's G heads (+0.024 ms of tensor time
// for packed) and a second read of their Q and K.
//
// What this design does about that (self_attention.cu's shape): a
// persistent grid (one block per SM) walks work items; one producer warp
// brings 64 x 64 boxes of Q, K and V by TMA through a 3-D tensor map over
// (B, N, 3D), 128-byte swizzled, into a ring of slots with full and empty
// `mbarrier`s (a slot is released by each of the 8 consumer warps once its
// last `wgmma` on it has completed); two consumer warpgroups (`setmaxnreg`
// 232, the producer's 40) run S = Q K^T (`wgmma` m64nNk16, N = the keys)
// and O = P V (`wgmma` m64n64k16, P in registers as the A operand, V the
// MN-major B operand), and add O into the float32 residual by a TMA
// reduce-add over a 3-D map on (B, N, D), so each element has one writer
// and one float32 add, and two runs give bit-equal residuals. The softmax
// is self_attention.cu's: float32 row max and sum over quad shuffles,
// log2(e) / 8 folded into one scale for `exp2f`, p = e * (1 / sum) rounded
// to bf16 (at most one float32 ulp from e / sum before the rounding). Keys
// past N enter as -inf; the map's middle dimension is N, so a ragged tile's
// rows past N arrive as zeros, and the reduce-add clips them.
//
// An item is (image, pair of query tiles), and for the grouped modes a
// group of G heads too: each warpgroup owns one query tile (a pair's second
// tile past N leaves its warpgroup idle), so the two items of an image run
// side by side on two SMs, share its K and V through L2, and each block
// keeps half an image's boxes in flight.
// - Grouped (SUMMED = false): pass 1 streams the pair's Q and the K of the
//   group's first G - 1 heads through the ring and keeps only the running
//   row max (two floats a thread); pass 2 streams each head's Q, K and V
//   from the last head back to the first (the last's own row max completes
//   the group's M, and the heads pass 1 read most recently are the
//   likeliest still in L2), recomputes S, and takes e = exp(s - M), the
//   head's own sum, p, O = P V and the reduce-add into the head's 64
//   columns. So a group costs 2G - 1 products Q K^T and 2G - 1 slots, and G
//   = 1 is self_attention.cu's arithmetic, bit for bit. Recomputing S costs
//   less than holding a group's scores (64 x 256 x 12 float32 a tile for
//   packed, which no SM holds). Shared memory at N = 256: a slot holds the
//   pair's two Q boxes and one head's K and V (10 boxes of 8 KB, 80 KB;
//   pass 1 fills 48 KB of it), two slots 160 KB, the warpgroups' O staging
//   2 x 16 KB: 192 KB plus alignment and barriers, of the 227 KB a block
//   may use (a third slot does not fit).
// - Summed (SUMMED = true): a warpgroup's tile's S summed over the heads in
//   one float32 accumulator (K at 256 x 768 bf16, 384 KB, fits no SM, so
//   the heads' 64-column chunks stream through the ring: a slot holds the
//   pair's two Q boxes and the head's K boxes, 6 x 8 KB = 48 KB at N =
//   256), then one softmax with P kept in registers while the heads' V
//   chunks stream through the same ring (NT boxes a slot), each chunk's P
//   V reduce-added into its 64 residual columns. Four slots (192 KB) and
//   the O staging (32 KB) fill the block.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;                    // head dim
constexpr int TILE = 64;                  // rows of a TMA box and of a query tile
constexpr int BOX_BYTES = TILE * DH * 2;  // one 64 x 64 bf16 box: 8 KB
constexpr int OUT_BYTES = TILE * DH * 4;  // one query tile's float32 O: two 64 x 32 boxes
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int ARRIVALS = CONSUMERS * 4;   // a slot is released by every consumer warp
constexpr int SMEM_LIMIT = 232448;        // shared memory a block may use
// log2(e) / sqrt(64): exp((s - m) / 8) = exp2(s * C - m * C)
constexpr float SCALE_LOG2 = 0.18033688011112042f;

// The ring for NT = ceil(N / 64) key boxes: its slots' bytes (two Q boxes,
// K, and V for the grouped modes), their number and the block's shared
// memory (slots, O staging, alignment, barriers)
template <int NT, bool SUMMED>
struct Ring {
  static constexpr int SLOT = (SUMMED ? 2 + NT : 2 + 2 * NT) * BOX_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - CONSUMERS * OUT_BYTES - 1024 - 64) / SLOT;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = STAGES * SLOT + CONSUMERS * OUT_BYTES + 1024 + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "the ring does not fit a block");
};

// s += Q K^T: Q one 64-row box, K NT boxes of keys, both K-major
template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT * 32], const unsigned char* q,
                                   const unsigned char* k) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint64_t da = sw128_desc(q + kk * 32, 16, 1024), db = sw128_desc(k + kk * 32, 16, 1024);
    if constexpr (NT == 1) wgmma_m64n64k16_ss<0, 0>(s, da, db);
    if constexpr (NT == 2) wgmma_m64n128k16_ss<0, 0>(s, da, db);
    if constexpr (NT == 3) wgmma_m64n192k16_ss<0, 0>(s, da, db);
    if constexpr (NT == 4) wgmma_m64n256k16_ss<0, 0>(s, da, db);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

template <int NT>
__device__ __forceinline__ void zero(float (&s)[NT * 32]) {
#pragma unroll
  for (int i = 0; i < NT * 32; ++i) s[i] = 0.f;
}

// keys past N to -inf; the max of this thread's rows r_lo and r_lo + 8
// (the 4 lanes of a quad hold a row)
template <int NT>
__device__ __forceinline__ void mask_max(float (&s)[NT * 32], int N, int t4, float& mx0,
                                         float& mx1) {
  // key 8 j + 2 t4 + e % 2 lies past N when 8 j + e % 2 >= lim: the left
  // side is an immediate, so no key index is held in a register
  const int lim = N - 2 * t4;
  mx0 = -INFINITY;
  mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT * 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + (e & 1) >= lim) s[4 * j + e] = -INFINITY;
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
}

// e = exp((s - m) / 8) with the rows' max m, the rows' float32 sums, and
// p = e / sum in bf16 in the A-operand layout of m64k16 (block kc holds
// keys 16 kc .. 16 kc + 15, accumulator blocks 2 kc and 2 kc + 1)
template <int NT>
__device__ __forceinline__ void softmax_p(float (&s)[NT * 32], float mx0, float mx1,
                                          uint32_t (&pa)[NT * 4][4]) {
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
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;  // a head underflowed: inf, and p NaN
#pragma unroll
  for (int kc = 0; kc < NT * 4; ++kc) {
    const float* s0 = s + 8 * kc;
    pa[kc][0] = pack_bf16x2(s0[0] * inv0, s0[1] * inv0);
    pa[kc][1] = pack_bf16x2(s0[2] * inv1, s0[3] * inv1);
    pa[kc][2] = pack_bf16x2(s0[4] * inv0, s0[5] * inv0);
    pa[kc][3] = pack_bf16x2(s0[6] * inv1, s0[7] * inv1);
  }
}

// O = P V (V: NT boxes of keys x 64, the MN-major B operand), staged in
// `obuf` as two 64 x 32 float32 boxes in the residual map's 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)) once the
// warpgroup's previous reduce has read it, then added into the residual's
// columns col .. col + 63 of query tile qt of image b
template <int NT>
__device__ __forceinline__ void pv_add(uint32_t (&pa)[NT * 4][4], const unsigned char* vs,
                                       unsigned char* obuf, const CUtensorMap* map_res, int col,
                                       int qt, int b, int wg, int wt, int r_lo, int t4) {
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
    tma_reduce_add_3d(map_res, obuf, col, qt * TILE, b);
    tma_reduce_add_3d(map_res, obuf + OUT_BYTES / 2, col + 32, qt * TILE, b);
    bulk_commit();
  }
}

// Items: p = (image * groups + group) * ceil(NT / 2) + pair of query
// tiles (summed: one group). Block x takes items x, x + gridDim.x, ...;
// producer and consumers walk the same sequence of ring slots (grouped:
// pass 1's Q, K for the first G - 1 heads, then pass 2's Q, K, V for every
// head from the last back; summed: Q, K per head, then V per head).
template <int NT, bool SUMMED>
__global__ void __launch_bounds__(THREADS, 1)
head_group_attention_kernel(const __grid_constant__ CUtensorMap map_qkv,
                            const __grid_constant__ CUtensorMap map_res, int items, int n_heads,
                            int group, int N, int D) {
  using R = Ring<NT, SUMMED>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::SLOT + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + R::STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ARRIVALS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  constexpr int PAIRS = (NT + 1) / 2;
  const int per_image = SUMMED ? PAIRS : n_heads / group * PAIRS;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&] {
    if (++stage == R::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (tid >= CONSUMERS * 128) {
    // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      // the next slot, once its consumers have released it, expecting `boxes` boxes
      auto fill = [&](int boxes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], boxes * BOX_BYTES);
        return smem + stage * R::SLOT;
      };
      auto load = [&](unsigned char* dst, int c0, int t, int b) {
        tma_load_3d(dst, &map_qkv, &full[stage], c0, t * TILE, b);
      };
      for (int p = blockIdx.x; p < items; p += gridDim.x) {
        const int b = p / per_image, w = p % per_image;
        const int qt0 = 2 * (w % PAIRS), nq = NT - qt0 < 2 ? NT - qt0 : 2;
        if constexpr (SUMMED) {
          for (int h = 0; h < n_heads; ++h) {
            unsigned char* dst = fill(nq + NT);
            for (int i = 0; i < nq; ++i) load(dst + i * BOX_BYTES, h * DH, qt0 + i, b);
#pragma unroll
            for (int t = 0; t < NT; ++t) load(dst + (2 + t) * BOX_BYTES, D + h * DH, t, b);
            advance();
          }
          for (int h = 0; h < n_heads; ++h) {
            unsigned char* dst = fill(NT);
#pragma unroll
            for (int t = 0; t < NT; ++t) load(dst + t * BOX_BYTES, 2 * D + h * DH, t, b);
            advance();
          }
        } else {
          const int h0 = w / PAIRS * group;
          for (int i = 0; i + 1 < group; ++i) {
            unsigned char* dst = fill(nq + NT);
            for (int j = 0; j < nq; ++j) load(dst + j * BOX_BYTES, (h0 + i) * DH, qt0 + j, b);
#pragma unroll
            for (int t = 0; t < NT; ++t) load(dst + (2 + t) * BOX_BYTES, D + (h0 + i) * DH, t, b);
            advance();
          }
          for (int h = h0 + group - 1; h >= h0; --h) {
            unsigned char* dst = fill(nq + 2 * NT);
            for (int j = 0; j < nq; ++j) load(dst + j * BOX_BYTES, h * DH, qt0 + j, b);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              load(dst + (2 + t) * BOX_BYTES, D + h * DH, t, b);
              load(dst + (2 + NT + t) * BOX_BYTES, 2 * D + h * DH, t, b);
            }
            advance();
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int r_lo = (wt >> 5) * 16 + (lane >> 2);  // this thread's rows r_lo and r_lo + 8 of a tile
    unsigned char* obuf = smem + R::STAGES * R::SLOT + wg * OUT_BYTES;
    auto take = [&] {
      mbar_wait(&full[stage], phase);
      return static_cast<const unsigned char*>(smem + stage * R::SLOT);
    };
    // every wgmma of this warp on the slot has completed
    auto release = [&] {
      if (lane == 0) mbar_arrive(&empty[stage]);
      advance();
    };
    for (int p = blockIdx.x; p < items; p += gridDim.x) {
      const int b = p / per_image, w = p % per_image;
      const int qt = 2 * (w % PAIRS) + wg;
      const bool active = qt < NT;  // the pair's second tile past N: this warpgroup idles
      if constexpr (SUMMED) {
        float s[NT * 32];
        zero<NT>(s);
        for (int h = 0; h < n_heads; ++h) {
          const unsigned char* src = take();
          if (active) qk<NT>(s, src + wg * BOX_BYTES, src + 2 * BOX_BYTES);
          release();
        }
        uint32_t pa[NT * 4][4];
        if (active) {
          float mx0, mx1;
          mask_max<NT>(s, N, t4, mx0, mx1);
          softmax_p<NT>(s, mx0, mx1, pa);
        }
        for (int h = 0; h < n_heads; ++h) {
          const unsigned char* src = take();
          if (active) pv_add<NT>(pa, src, obuf, &map_res, h * DH, qt, b, wg, wt, r_lo, t4);
          release();
        }
      } else {
        const int h0 = w / PAIRS * group;
        float gm0 = 0.f, gm1 = 0.f;  // the group's row max over the heads seen so far
        for (int i = 0; i + 1 < group; ++i) {
          const unsigned char* src = take();
          if (active) {
            float s[NT * 32], mx0, mx1;
            zero<NT>(s);
            qk<NT>(s, src + wg * BOX_BYTES, src + 2 * BOX_BYTES);
            mask_max<NT>(s, N, t4, mx0, mx1);
            gm0 = i ? fmaxf(gm0, mx0) : mx0;
            gm1 = i ? fmaxf(gm1, mx1) : mx1;
          }
          release();
        }
        for (int h = h0 + group - 1; h >= h0; --h) {
          const unsigned char* src = take();
          if (active) {
            float s[NT * 32], mx0, mx1;
            zero<NT>(s);
            qk<NT>(s, src + wg * BOX_BYTES, src + 2 * BOX_BYTES);
            mask_max<NT>(s, N, t4, mx0, mx1);
            if (group > 1) {
              gm0 = mx0 = fmaxf(mx0, gm0);
              gm1 = mx1 = fmaxf(mx1, gm1);
            }
            uint32_t pa[NT * 4][4];
            softmax_p<NT>(s, mx0, mx1, pa);
            pv_add<NT>(pa, src + (2 + NT) * BOX_BYTES, obuf, &map_res, h * DH, qt, b, wg, wt, r_lo,
                       t4);
          }
          release();
        }
      }
    }
    if (wt == 0) bulk_wait();
  }
}

template <int NT, bool SUMMED>
int launch(const void* qkv, float* resid, int B, int N, int D, int n_heads, int group,
           cudaStream_t s) {
  using R = Ring<NT, SUMMED>;
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
  auto kernel = head_group_attention_kernel<NT, SUMMED>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * (SUMMED ? 1 : n_heads / group) * ((NT + 1) / 2);
  kernel<<<items < sms ? items : sms, THREADS, R::SMEM, s>>>(map_qkv, map_res, items, n_heads,
                                                             group, N, D);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_mode(const void* qkv, float* resid, int B, int N, int D, int n_heads, int group,
                int summed, cudaStream_t s) {
  return summed ? launch<NT, true>(qkv, resid, B, N, D, n_heads, group, s)
                : launch<NT, false>(qkv, resid, B, N, D, n_heads, group, s);
}

}  // namespace

// qkv: (B*N, 3D) bf16, rows [q | k | v], head h at columns h*64 of each.
// resid: (B*N, D) float32, updated in place. summed != 0: one head as wide
// as D (group not read); else one row max per group of `group` heads, with
// n_heads % group == 0. Requires D == n_heads * 64, 1 <= N <= 256, both
// 16-byte aligned (TMA).
LTD_API int ltd_head_group_attention(const void* qkv, float* resid, int B, int N, int D,
                                     int n_heads, int group, int summed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || N > 256 || D != n_heads * DH) return static_cast<int>(cudaErrorInvalidValue);
  if (!summed && (group < 1 || n_heads % group)) return static_cast<int>(cudaErrorInvalidValue);
  switch ((N + TILE - 1) / TILE) {
    case 1: return launch_mode<1>(qkv, resid, B, N, D, n_heads, group, summed, s);
    case 2: return launch_mode<2>(qkv, resid, B, N, D, n_heads, group, summed, s);
    case 3: return launch_mode<3>(qkv, resid, B, N, D, n_heads, group, summed, s);
    default: return launch_mode<4>(qkv, resid, B, N, D, n_heads, group, summed, s);
  }
}
