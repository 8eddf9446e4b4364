// self_attention_f32: x += softmax(q k^T / sqrt(64)) v per head, float32 q, k,
// v and probabilities, into the float32 residual, at float32 accuracy on the
// tensor cores (3xTF32 wgmma): the float32 form of self_attention.cu.
//
// Replaces the self-attention of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (`_mha`, fused_stack.py:40-56 and :72) when the compute dtype `mxu` is
// float32 (the JAX package's default configuration), and the same stage of
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel.
// With mxu float32 the probabilities are not rounded before they weigh V
// (fused_block.py:105: `.astype(mxu_dtype)` is a no-op), and both products
// accumulate in float32.
//
// What bounds it on the H100: at batch 64 x 12 heads x N = 256 it does 12.9
// GFLOP of float32 products, which run as three TF32 products each
// (hopper.cuh: 495 TFLOP/s of TF32, so 0.078 ms), and moves 252 MB (qkv
// read, the residual read and written: 0.075 ms). The two meet.
//
// What this design does about that. A persistent grid (one block per SM)
// walks the work items, (batch, head, 64-query tile):
// - K and V stream through in chunks of 64 keys. One producer thread
//   brings each chunk (64 keys x 64 head columns, float32) with TMA through
//   a 3-D tensor map over (B, N, 3D), two 64 x 32 boxes, 128-byte swizzled,
//   into a ring of four raw slots (keys past N arrive as zeros). The
//   producer warpgroup's three other warps turn each raw chunk into its
//   TF32 parts (f32_chunk.cuh, shared with flash_attention_f32.cu) in a
//   ring of four split slots (hi and lo, 16 KB each): K as
//   it is (keys are the rows of the B operand, the head columns its K),
//   V transposed in 4 x 2 blocks, since the 32-bit wgmma forms take K-major
//   operands only and the keys are P V's K. A chunk's keys are written in
//   the order 0, 2, 4, 6, 1, 3, 5, 7 of each 8: that is the order in which
//   a thread's score accumulators (columns 2 (t % 4) and + 1 of each 8)
//   fall into the TF32 A fragment (columns t % 4 and + 4), so P feeds P V
//   from the registers that hold it, with no shuffle. A slot is released
//   to the splitters when both consumer warpgroups are done with it.
// - Two consumer warpgroups (`setmaxnreg`: 232 registers, the producer's
//   40) share the tile's 64 queries and split its keys: warpgroup 0 takes
//   the first half of the chunks, warpgroup 1 the rest, so a thread holds
//   64 scores (not 256, which with P V's registers spilled). A thread
//   loads its Q fragment (32 floats) from global memory one item ahead and
//   splits it per 8-wide step in registers; S = Q K^T is 3 x 8 `wgmma`
//   m64n64k8.tf32 per key chunk (A from registers, the small terms first:
//   lo K_hi, hi K_lo, hi K_hi).
// - The softmax is exact and in the plain version's order: s / 8, keys
//   past N at -inf, the row max over the thread's values, its quad of
//   lanes and the two warpgroups (through shared memory), e = expf(s -
//   max), the row sum the same way (the two halves added in one order),
//   p = e / sum (as q = e (1 / sum) and one FMA correction with the exact
//   remainder: Markstein's correctly rounded quotient, bit-equal to the
//   division in a third of its instructions). No running rescale and no
//   rounding of p, only its split.
// - O = P V per key chunk: P's fragments (from the score registers, split)
//   against V^T's parts, 3 x 8 `wgmma` m64n64k8.tf32 into a fresh 64 x 64
//   partial that is then added into O in float32 with ordinary rounding
//   (tensor cores may add with truncation: then one chain over 256 keys
//   would triple the error, to ~3e-6 relative;
//   tests/test_torch_port_tf32_split.py emulates it). Fragments are
//   double-buffered and waited for before they are rewritten.
// - Warpgroup 1 stages its O in shared memory in the residual map's
//   128-byte swizzle; warpgroup 0 adds its own, O_0 + O_1, and a TMA
//   reduce-add (`cp.reduce.async.bulk.tensor .add`, 3-D map over (B, N,
//   D)) adds it into the float32 residual, x + O: the residual is never
//   read into the SM, rows past N are clipped, and each element has one
//   writer and one add, so two launches are bit-equal.
// Shared memory: 4 x 16 KB raw slots, 4 x 32 KB split slots, 17 KB for
// the exchange and O, 210 KB: one block per SM.

#include "f32_chunk.cuh"

#include <math.h>

namespace {

using namespace f32chunk;

constexpr int RAW_SLOTS = 4, SPLIT_SLOTS = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
// + the tile's O staging (16 KB) and the softmax's row maxima and sums (1 KB)
constexpr int SMEM = 1024 + RAW_SLOTS * RAW_BYTES + SPLIT_SLOTS * SPLIT_BYTES + 2 * BOX_BYTES +
                     4 * 64 * 4 + 2 * (RAW_SLOTS + SPLIT_SLOTS) * 8;

// The consumer warpgroups' shared state: the ring of split chunks, the
// softmax's cross-warpgroup row maxima and sums, and warpgroup 1's O for
// warpgroup 0 to add
struct Consumers {
  const unsigned char* split;
  uint64_t* split_full;
  uint64_t* split_empty;
  float* red;   // [2 warpgroups][2: max, sum][64 rows]
  unsigned char* obuf;  // O of the tile, two 64 x 32 boxes in the residual map's swizzle
  const CUtensorMap* map_res;
};

// barrier over the two consumer warpgroups (id 1; the producer's warps never use it)
__device__ __forceinline__ void consumers_sync() { named_barrier(1, 2 * 128); }

// Consumer warpgroup W of a block: for each item (batch, head, 64-query
// tile) it computes the scores of its half of the keys (chunks [C0, C1)),
// the softmax with the other warpgroup's row maxima and sums, and P V over
// its half; warpgroup 1 hands its O to warpgroup 0, which adds both and
// sends O_0 + O_1 into the residual by a TMA reduce-add. Every chunk of
// the ring is waited for and released by both warpgroups, in order.
template <int NK, int W>
__device__ __forceinline__ void consume(const Consumers& cs, const float* __restrict__ qkv,
                                        int items, int n_heads, int N, int D, int wt) {
  constexpr int C0 = W == 0 ? 0 : (NK + 1) / 2, C1 = W == 0 ? (NK + 1) / 2 : NK;
  constexpr int NL = C1 - C0 > 0 ? C1 - C0 : 1;  // this warpgroup's chunks (none: NK = 1, W = 1)
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = (wt >> 5) * 16 + g;  // this thread's rows r and r + 8 of the tile
  int ss = 0;
  uint32_t sphase = 0;
  // the next split chunk: wait for it; release it when done
  auto next_chunk = [&]() -> const unsigned char* {
    mbar_wait(&cs.split_full[ss], sphase);
    return cs.split + ss * SPLIT_BYTES;
  };
  auto release = [&]() {
    if (wt == 0) mbar_arrive(&cs.split_empty[ss]);
    if (++ss == SPLIT_SLOTS) {
      ss = 0;
      sphase ^= 1;
    }
  };
  // Q fragments of an item: columns 8 kk + t4 and + 4 of its rows q0, q0 + 8
  // (zeros past N), loaded one item ahead
  float q[DH / 8][4];
  auto load_q = [&](int it) {
    const int p = it / NK, b = p / n_heads, col = (p % n_heads) * DH;
    const int q0 = (it % NK) * TILE + r;
    const float* row0 = qkv + (static_cast<size_t>(b) * N + q0) * 3 * D + col + t4;
    const float* row1 = row0 + static_cast<size_t>(8) * 3 * D;
    const bool in0 = C1 > C0 && it < items && q0 < N;
    const bool in1 = C1 > C0 && it < items && q0 + 8 < N;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      q[kk][0] = in0 ? row0[8 * kk] : 0.f;
      q[kk][1] = in1 ? row1[8 * kk] : 0.f;
      q[kk][2] = in0 ? row0[8 * kk + 4] : 0.f;
      q[kk][3] = in1 ? row1[8 * kk + 4] : 0.f;
    }
  };
  load_q(blockIdx.x);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int p = it / NK, b = p / n_heads, col = (p % n_heads) * DH;

    // S = Q K^T over this warpgroup's chunks: s[c - C0][4 j + e] is row
    // r + 8 (e / 2), key 64 c + 8 j + 2 t4 + e % 2
    float s[NL][32];
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const unsigned char* kc = next_chunk();
      if (c >= C0 && c < C1)
        chunk_products(s[c - C0], kc, kc + PART_BYTES, [&](int kk, float (&x)[4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = q[kk][i];
        });
      release();
    }
    load_q(it + gridDim.x);  // in flight through the softmax and P V

    // the exact float32 softmax of rows r and r + 8: s / 8, keys past N at
    // -inf; the row max over this thread's keys, its quad, then both
    // warpgroups; e = expf(s - max) and their sums the same way; p = e / sum
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (C1 > C0) {
#pragma unroll
      for (int c = C0; c < C1; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c * TILE + 8 * j + 2 * t4 + (e & 1);
            s[c - C0][4 * j + e] = key < N ? s[c - C0][4 * j + e] * 0.125f : -INFINITY;
          }
          mx0 = fmaxf(mx0, fmaxf(s[c - C0][4 * j], s[c - C0][4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[c - C0][4 * j + 2], s[c - C0][4 * j + 3]));
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float* red = cs.red;
    if (t4 == 0) {
      red[W * 128 + r] = mx0;
      red[W * 128 + r + 8] = mx1;
    }
    // the previous item's reduce-add has read obuf before warpgroup 1 refills it
    if (W == 0 && wt == 0) bulk_wait_read();
    consumers_sync();
    mx0 = fmaxf(mx0, red[(1 - W) * 128 + r]);
    mx1 = fmaxf(mx1, red[(1 - W) * 128 + r + 8]);
    float sum0 = 0.f, sum1 = 0.f;
    if (C1 > C0) {
#pragma unroll
      for (int c = 0; c < C1 - C0; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[c][4 * j] = expf(s[c][4 * j] - mx0);
          s[c][4 * j + 1] = expf(s[c][4 * j + 1] - mx0);
          s[c][4 * j + 2] = expf(s[c][4 * j + 2] - mx1);
          s[c][4 * j + 3] = expf(s[c][4 * j + 3] - mx1);
          sum0 += s[c][4 * j] + s[c][4 * j + 1];
          sum1 += s[c][4 * j + 2] + s[c][4 * j + 3];
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    if (t4 == 0) {
      red[W * 128 + 64 + r] = sum0;
      red[W * 128 + 64 + r + 8] = sum1;
    }
    consumers_sync();
    // both warpgroups add the halves in one order
    sum0 = red[64 + r] + red[128 + 64 + r];
    sum1 = red[64 + r + 8] + red[128 + 64 + r + 8];
    if (C1 > C0) {
      // e / sum rounded to nearest: q = e (1 / sum), then one FMA correction
      // with the exact remainder e - q sum (Markstein's theorem: the
      // correctly rounded quotient, a division's result in 3 instructions)
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
      auto div = [](float e, float sum, float inv) {
        const float q = e * inv;
        return fmaf(fmaf(-q, sum, e), inv, q);
      };
#pragma unroll
      for (int c = 0; c < C1 - C0; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[c][4 * j] = div(s[c][4 * j], sum0, inv0);
          s[c][4 * j + 1] = div(s[c][4 * j + 1], sum0, inv0);
          s[c][4 * j + 2] = div(s[c][4 * j + 2], sum1, inv1);
          s[c][4 * j + 3] = div(s[c][4 * j + 3], sum1, inv1);
        }
      }
    }

    // O = P V over this warpgroup's chunks: step kk takes the chunk's keys
    // 8 kk .. in the order of V^T's slots, so its fragment is P's
    // accumulators (row r, keys 2 t4 and + 1; row r + 8 the same) as they
    // are; each chunk's products in a fresh partial, added into O in float32
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const unsigned char* vc = next_chunk();
      if (c >= C0 && c < C1) {
        float part[32];  // the first product of the chunk overwrites it
        chunk_products(part, vc, vc + PART_BYTES, [&](int kk, float (&x)[4]) {
          x[0] = s[c - C0][4 * kk];
          x[1] = s[c - C0][4 * kk + 2];
          x[2] = s[c - C0][4 * kk + 1];
          x[3] = s[c - C0][4 * kk + 3];
        });
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] += part[i];
      }
      release();
    }

    // x += O_0 + O_1: warpgroup 1 stages its O in obuf (thread t holds
    // rows r, r + 8 and columns 8 j + 2 t4 (+1)); warpgroup 0's thread t,
    // which holds the same elements, adds its own and writes the sum back;
    // one TMA reduce-add per 32 columns adds it into the residual (x + O,
    // the rows past N clipped by the map)
    auto staged = [&](int j, int h) {
      return reinterpret_cast<float2*>(cs.obuf + sw_off(r + 8 * h, 8 * j + 2 * t4));
    };
    if (W == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) *staged(j, h) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
    consumers_sync();
    if (W == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = *staged(j, h);
          *staged(j, h) = make_float2(o[4 * j + 2 * h] + v.x, o[4 * j + 2 * h + 1] + v.y);
        }
      }
      fence_proxy_async();
      named_barrier(2, 128);
      if (wt == 0) {
        const int tile0 = (it % NK) * TILE;
        tma_reduce_add_3d(cs.map_res, cs.obuf, col, tile0, b);
        tma_reduce_add_3d(cs.map_res, cs.obuf + BOX_BYTES, col + 32, tile0, b);
        bulk_commit();
      }
    }
  }
  if (W == 0 && wt == 0) bulk_wait();
}

// NK = ceil(N / 64) (1..4): the keys of a (batch, head) fill NK chunks
template <int NK>
__global__ void __launch_bounds__(THREADS, 1)
self_attention_f32_kernel(const __grid_constant__ CUtensorMap map_qkv,
                          const __grid_constant__ CUtensorMap map_res,
                          const float* __restrict__ qkv, int items, int n_heads, int N, int D) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* raw = smem;
  unsigned char* split = raw + RAW_SLOTS * RAW_BYTES;
  unsigned char* obuf = split + SPLIT_SLOTS * SPLIT_BYTES;
  float* red = reinterpret_cast<float*>(obuf + 2 * BOX_BYTES);
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(red + 4 * 64);
  uint64_t* raw_empty = raw_full + RAW_SLOTS;
  uint64_t* split_full = raw_empty + RAW_SLOTS;
  uint64_t* split_empty = split_full + SPLIT_SLOTS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < RAW_SLOTS; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], SPLITTERS);
    }
    for (int s = 0; s < SPLIT_SLOTS; ++s) {
      mbar_init(&split_full[s], SPLITTERS);
      mbar_init(&split_empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    const int pt = tid - CONSUMERS * 128;
    if (pt == 0) {
      // one thread issues every copy: per item K's chunks, then V's
      int slot = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int p = it / NK, b = p / n_heads, col = (p % n_heads) * DH;
        for (int i = 0; i < 2 * NK; ++i) {
          const int c0 = (i < NK ? D : 2 * D) + col, key0 = (i % NK) * TILE;
          mbar_wait(&raw_empty[slot], phase ^ 1);
          mbar_arrive_expect_tx(&raw_full[slot], RAW_BYTES);
          unsigned char* dst = raw + slot * RAW_BYTES;
          tma_load_3d(dst, &map_qkv, &raw_full[slot], c0, key0, b);
          tma_load_3d(dst + BOX_BYTES, &map_qkv, &raw_full[slot], c0 + 32, key0, b);
          if (++slot == RAW_SLOTS) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    } else if (pt >= 32) {
      // the splitters: each raw chunk into its TF32 parts
      const int sid = pt - 32;
      int rs = 0, ss = 0;
      uint32_t rphase = 0, sphase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        for (int i = 0; i < 2 * NK; ++i) {
          mbar_wait(&raw_full[rs], rphase);
          mbar_wait(&split_empty[ss], sphase ^ 1);
          const unsigned char* src = raw + rs * RAW_BYTES;
          unsigned char* hi = split + ss * SPLIT_BYTES;
          unsigned char* lo = hi + PART_BYTES;
          split_chunk(src, hi, lo, i >= NK, sid);
          fence_proxy_async();  // the parts become visible to the wgmma reads
          mbar_arrive(&raw_empty[rs]);
          mbar_arrive(&split_full[ss]);
          if (++rs == RAW_SLOTS) {
            rs = 0;
            rphase ^= 1;
          }
          if (++ss == SPLIT_SLOTS) {
            ss = 0;
            sphase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const Consumers cs{split, split_full, split_empty, red, obuf, &map_res};
    if (tid < 128) {
      consume<NK, 0>(cs, qkv, items, n_heads, N, D, tid);
    } else {
      consume<NK, 1>(cs, qkv, items, n_heads, N, D, tid - 128);
    }
  }
}

template <int NK>
int launch(const float* qkv, float* resid, int B, int N, int D, int n_heads, cudaStream_t s) {
  // (B, N, 3D) and (B, N, D) float32, 64-row x 32-column boxes, 128-byte swizzled
  CUtensorMap map_qkv, map_res;
  const uint64_t qdims[3] = {static_cast<uint64_t>(3 * D), static_cast<uint64_t>(N),
                             static_cast<uint64_t>(B)};
  const uint64_t qstrides[2] = {static_cast<uint64_t>(3 * D) * 4,
                                static_cast<uint64_t>(N) * 3 * D * 4};
  const uint64_t rdims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                             static_cast<uint64_t>(B)};
  const uint64_t rstrides[2] = {static_cast<uint64_t>(D) * 4, static_cast<uint64_t>(N) * D * 4};
  const uint32_t box[3] = {32, TILE, 1};
  int err = encode_map(&map_qkv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, qkv, qdims, qstrides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_map(&map_res, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, resid, rdims, rstrides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(self_attention_f32_kernel<NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * n_heads * NK;
  self_attention_f32_kernel<NK><<<items < sms ? items : sms, THREADS, SMEM, s>>>(
      map_qkv, map_res, qkv, items, n_heads, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B*N, 3D) float32 rows [q | k | v], heads of 64 columns. resid:
// (B*N, D) float32, updated in place. Requires D == n_heads * 64,
// 1 <= N <= 256, pointers 16-byte aligned (TMA).
LTD_API int ltd_self_attention_f32(const float* qkv, float* resid, int B, int N, int D,
                                   int n_heads, void* stream) {
  if (B < 1 || N < 1 || N > 4 * TILE || n_heads < 1 || D != n_heads * DH)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + TILE - 1) / TILE) {
    case 1: return launch<1>(qkv, resid, B, N, D, n_heads, s);
    case 2: return launch<2>(qkv, resid, B, N, D, n_heads, s);
    case 3: return launch<3>(qkv, resid, B, N, D, n_heads, s);
    default: return launch<4>(qkv, resid, B, N, D, n_heads, s);
  }
}
