// flash_attention_bwd_f32: dq, dk, dv of o = softmax(q k^T / sqrt(64)) v per
// (image, head), float32 q, k, v, o and g, N tokens with N % 64 == 0, at
// float32 accuracy on the tensor cores (3xTF32 wgmma): the float32 form of
// flash_attention_bwd.cu.
//
// Replaces transformer_latent_diffusion_tpu/ops/attention.py::
// _pallas_attention_bwd (`_flash_bwd_kernel`, pallas_call at attention.py:247,
// K4a, 512 <= N <= 2048) and ::_pallas_attention_bwd_tiled
// (`_flash_bwd_tiled_kernel`, pallas_call at attention.py:313, K4b, N <= 8192)
// when their inputs are float32 (TrainConfig(compute_dtype="float32"), the
// JAX package's default, past 256 tokens: finetune_highres to 512 and 1024
// px, multires buckets). The TPU kernels compute in q's dtype: in float32 p
// and ds / sqrt(dh) are not rounded and every sum is float32.
//
// What bounds it on the H100: five products of 2 N^2 64 operations per
// (image, head), float32, each run as three TF32 products: at 512 px (B =
// 64, 12 heads, N = 1024) 515 GFLOP of float32 work, 3.12 ms at 495 / 3
// TFLOP/s; at 1024 px (B = 16, N = 4096) 2.06 TFLOP, 12.5 ms. The bytes
// (q, k, v, o, g in, dq, dk, dv out: 1.6 GB at 512 px) take 0.48 ms. This
// design recomputes q k^T and g v^T in both kernels (7 products, 4.4 ms of
// TF32 work at 512 px).
//
// What this design does about that. flash_attention_bwd.cu's split into two
// kernels (dq, which also writes D = rowsum(g o); then dk and dv, so every
// output element has one writer and every sum a fixed order: two launches
// are bit-equal), built on flash_attention_f32.cu's float32 machinery
// (f32_chunk.cuh):
// - A persistent grid (one block per SM) walks work items (image, head,
//   128-row block): query rows for dq, key rows for dk/dv; the blocks of a
//   head one after another, so the SMs that run at once share L2.
// - The item's two operands of 128 rows (Q and g for dq, K and V for dk/dv)
//   arrive by TMA, 128-byte swizzled, as they are stored, into one 64 KB
//   buffer. They are the A operands of the products whose rows they are:
//   each consumer thread splits its 4 values of a K step into TF32 parts
//   in registers as the step is issued (no parts kept: 128 registers of
//   them would not fit beside the accumulators).
// - The other side streams through in chunks of 64 rows (K and V for dq, Q
//   and g for dk/dv). One producer thread brings each chunk with TMA into
//   a ring of two raw slots; the producer warpgroup's three other warps
//   split it into a ring of four split slots (hi and lo parts, 32 KB):
//   as it is (the B operand of a product over the head columns: S = Q K^T,
//   dP = g V^T, S^T = K Q^T, dP^T = V g^T) and transposed, in the key
//   order of each 8 that puts the score accumulators straight into the A
//   fragments (the B operand of a product over the chunk's rows: dq += dS
//   K, dk += dS^T Q, dv += P^T g). dq splits a K chunk both ways and a V
//   chunk as it is (3 slots a chunk); dk/dv splits Q and g both ways (4).
// - Two consumer warpgroups (`setmaxnreg`: 232 registers, the producer's 40)
//   own 64 rows of the item each and share every split chunk, so a split
//   is paid once per 128 rows. Per chunk, each product is 8 K steps of 3
//   TF32 `wgmma` m64n64k8 (the small terms first) into a fresh 64 x 64
//   float32 tile; the tile is added into the running dq (or dk, dv) with
//   ordinary float32 rounding, since the tensor cores may add with
//   truncation and one chain over 4096 rows would drift past float32
//   accuracy. p = exp(s / 8 - lse) by `expf`, ds = p (dp - D) / 8, neither
//   rounded.
// - dk/dv reads the chunk's 64 lse and D values by a bulk copy into a ring
//   of two 512-byte slots.
// Rows of a ragged last 128-row block (N % 128 == 64) past N arrive as
// zeros: query rows past N add nothing to dk and dv in the dk/dv kernel
// (they are never streamed: chunks run to N) and are not stored by the dq
// kernel; keys past N are not stored.
// Shared memory: the 64 KB item, 4 x 32 KB split slots, 2 x 16 KB raw
// slots, 1 KB of row statistics: 226 KB, one block per SM.

#include "f32_chunk.cuh"

#include <math.h>

namespace {

using namespace f32chunk;

constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int BLOCK = CONSUMERS * TILE;               // rows of a work item
constexpr int ITEM_BYTES = 2 * CONSUMERS * RAW_BYTES;  // its two operands: 64 KB
constexpr int RAW_SLOTS = 2, SPLIT_SLOTS = 4, STAT_SLOTS = 2;
constexpr int STAT_BYTES = 2 * TILE * 4;  // lse, then D, of a chunk's 64 queries
constexpr float SCALE = 0.125f;           // 1 / sqrt(64)

// split slots a chunk takes: dq K (as it is, transposed) and V (as it is);
// dk/dv Q and g, each both ways
constexpr int DQ_SPLITS = 3, DKV_SPLITS = 4;

template <bool DKV>
constexpr int smem_bytes() {
  return 1024 + ITEM_BYTES + SPLIT_SLOTS * SPLIT_BYTES + RAW_SLOTS * RAW_BYTES +
         (DKV ? STAT_SLOTS * STAT_BYTES : CONSUMERS * TILE * 4) +
         8 * (2 + 2 * RAW_SLOTS + 2 * SPLIT_SLOTS + 2 * STAT_SLOTS);
}

// the work item `it`: image b, head h, the first row r0 of its block
struct Item {
  int b, h, r0;
  __device__ __forceinline__ Item(int it, int n_blk, int H)
      : b(it / (H * n_blk)), h((it / n_blk) % H), r0((it % n_blk) * BLOCK) {}
};

// The A fragment of K step kk from a raw 64 x 64 chunk as TMA stored it
// (two 64 x 32 boxes, 128-byte swizzled): rows r, r + 8, columns 8 kk + t4
// and + 4.
__device__ __forceinline__ void raw_frag(const unsigned char* a, int r, int col, float (&x)[4]) {
  x[0] = *reinterpret_cast<const float*>(a + sw_off(r, col));
  x[1] = *reinterpret_cast<const float*>(a + sw_off(r + 8, col));
  x[2] = *reinterpret_cast<const float*>(a + sw_off(r, col + 4));
  x[3] = *reinterpret_cast<const float*>(a + sw_off(r + 8, col + 4));
}

// The A fragment of K step kk from score-shaped accumulators (row r, chunk
// rows 8 kk + 2 t4 and + 1; the transposed split's order of each 8)
__device__ __forceinline__ void acc_frag(const float (&s)[32], int kk, float (&x)[4]) {
  x[0] = s[4 * kk];
  x[1] = s[4 * kk + 2];
  x[2] = s[4 * kk + 1];
  x[3] = s[4 * kk + 3];
}

// rows r, r + 8 of a 64 x 64 accumulator tile to (B*N, D) float32 rows,
// head columns at `col`; rows at or past `limit` skipped
__device__ __forceinline__ void store_rows(float* out, size_t row0, int r, int limit, int D,
                                           int col, const float (&acc)[32]) {
  float* o0 = out + (row0 + r) * D + col;
  float* o1 = o0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    if (r < limit) *reinterpret_cast<float2*>(o0 + 8 * d) = make_float2(acc[4 * d], acc[4 * d + 1]);
    if (r + 8 < limit)
      *reinterpret_cast<float2*>(o1 + 8 * d) = make_float2(acc[4 * d + 2], acc[4 * d + 3]);
  }
}

struct Ring {
  const unsigned char* split;
  uint64_t* full;
  uint64_t* empty;
  int wt;
  // split position p: its slot, once the splitters have filled it
  __device__ __forceinline__ const unsigned char* wait(int p) const {
    mbar_wait(&full[p % SPLIT_SLOTS], (p / SPLIT_SLOTS) & 1);
    return split + (p % SPLIT_SLOTS) * SPLIT_BYTES;
  }
  __device__ __forceinline__ void release(int p) const {
    if (wt == 0) mbar_arrive(&empty[p % SPLIT_SLOTS]);
  }
};

// dq of the warpgroup's 64 query rows of each item: D = rowsum(g o) first
// (written to `delta` for the dk/dv kernel), then per key chunk S = Q K^T,
// dP = g V^T, dS = P (dP - D) / 8, dq += dS K.
__device__ __forceinline__ void consume_dq(const unsigned char* item_buf, const Ring& ring,
                                           uint64_t* ifull, uint64_t* iempty, float* dsh,
                                           const float* __restrict__ o,
                                           const float* __restrict__ g,
                                           const float* __restrict__ lse,
                                           float* __restrict__ delta, float* __restrict__ dq,
                                           int B, int N, int H, int o_row, int g_row, int wg,
                                           int wt) {
  const int lane = wt & 31;
  const int t4 = lane & 3;
  const int r = (wt >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
  const int n_blk = (N + BLOCK - 1) / BLOCK;
  const int items = B * H * n_blk;
  const int n_chunks = N / TILE;
  const int D = H * DH;
  float* dw = dsh + wg * TILE;
  const unsigned char* qa = item_buf + wg * RAW_BYTES;
  const unsigned char* ga = item_buf + (CONSUMERS + wg) * RAW_BYTES;
  int qi = 0, p = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
    const Item item(it, n_blk, H);
    const int q0 = item.r0 + wg * TILE;  // this warpgroup's first query
    const size_t bh = static_cast<size_t>(item.b) * H + item.h;
    // D of the warpgroup's 64 rows: two threads a row, 32 columns each
    {
      const int rr = wt >> 1, half = wt & 1, row = q0 + rr;
      float acc = 0.f;
      if (row < N) {
        const size_t tok = static_cast<size_t>(item.b) * N + row;
        const float4* gr = reinterpret_cast<const float4*>(g + tok * g_row + item.h * DH + half * 32);
        const float4* orow =
            reinterpret_cast<const float4*>(o + tok * o_row + item.h * DH + half * 32);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 a = gr[c], b = orow[c];
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (!half) {
        dw[rr] = acc;
        if (row < N) delta[bh * N + row] = acc;
      }
    }
    named_barrier(1 + wg, 128);
    const int r0 = q0 + r, r1 = r0 + 8;
    const float d0 = dw[r], d1 = dw[r + 8];
    const float nl0 = r0 < N ? -lse[bh * N + r0] : 0.f;
    const float nl1 = r1 < N ? -lse[bh * N + r1] : 0.f;
    named_barrier(1 + wg, 128);  // dw is read: the next item may write it

    mbar_wait(ifull, qi & 1);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int c = 0; c < n_chunks; ++c, p += DQ_SPLITS) {
      float s[32], dp[32];
      const unsigned char* kc = ring.wait(p);
      chunk_products<true>(s, kc, kc + PART_BYTES,
                           [&](int kk, float (&x)[4]) { raw_frag(qa, r, 8 * kk + t4, x); });
      ring.release(p);
      const unsigned char* vc = ring.wait(p + 2);
      chunk_products<true>(dp, vc, vc + PART_BYTES,
                           [&](int kk, float (&x)[4]) { raw_frag(ga, r, 8 * kk + t4, x); });
      ring.release(p + 2);
      // ds = p (dp - D) / 8, p = exp(s / 8 - lse): s[4 j + e] is row r + 8 (e / 2)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float pr = expf(fmaf(s[4 * j + e], SCALE, lo ? nl0 : nl1));
          s[4 * j + e] = pr * (dp[4 * j + e] - (lo ? d0 : d1)) * SCALE;
        }
      }
      const unsigned char* ktc = ring.wait(p + 1);
      chunk_products<true>(dp, ktc, ktc + PART_BYTES,
                           [&](int kk, float (&x)[4]) { acc_frag(s, kk, x); });
      ring.release(p + 1);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += dp[e];
    }
    if (wt == 0) mbar_arrive(iempty);  // every product that read the item is done
    store_rows(dq, static_cast<size_t>(item.b) * N + q0, r, N - q0, D, item.h * DH + 2 * t4, acc);
  }
}

// dk and dv of the warpgroup's 64 keys of each item: per query chunk S^T =
// K Q^T, dP^T = V g^T, P^T = exp(S^T / 8 - lse), dS^T = P^T (dP^T - D) / 8,
// dk += dS^T Q, dv += P^T g.
__device__ __forceinline__ void consume_dkv(const unsigned char* item_buf, const Ring& ring,
                                            uint64_t* ifull, uint64_t* iempty,
                                            const unsigned char* stats, uint64_t* stat_full,
                                            uint64_t* stat_empty, float* __restrict__ dk,
                                            float* __restrict__ dv, int B, int N, int H, int wg,
                                            int wt) {
  const int lane = wt & 31;
  const int t4 = lane & 3;
  const int r = (wt >> 5) * 16 + (lane >> 2);
  const int n_blk = (N + BLOCK - 1) / BLOCK;
  const int items = B * H * n_blk;
  const int n_chunks = N / TILE;
  const int D = H * DH;
  const unsigned char* ka = item_buf + wg * RAW_BYTES;
  const unsigned char* va = item_buf + (CONSUMERS + wg) * RAW_BYTES;
  int qi = 0, p = 0, sp = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
    const Item item(it, n_blk, H);
    const int k0 = item.r0 + wg * TILE;  // this warpgroup's first key
    mbar_wait(ifull, qi & 1);
    float dka[32], dva[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
    for (int c = 0; c < n_chunks; ++c, p += DKV_SPLITS, ++sp) {
      // rows: this warpgroup's keys; columns: the chunk's queries
      float sT[32], dpT[32], part[32];
      const unsigned char* qc = ring.wait(p);
      chunk_products<true>(sT, qc, qc + PART_BYTES,
                           [&](int kk, float (&x)[4]) { raw_frag(ka, r, 8 * kk + t4, x); });
      ring.release(p);
      const unsigned char* gc = ring.wait(p + 2);
      chunk_products<true>(dpT, gc, gc + PART_BYTES,
                           [&](int kk, float (&x)[4]) { raw_frag(va, r, 8 * kk + t4, x); });
      ring.release(p + 2);
      const int st = sp % STAT_SLOTS;
      mbar_wait(&stat_full[st], (sp / STAT_SLOTS) & 1);
      const float* ls = reinterpret_cast<const float*>(stats + st * STAT_BYTES);
      const float* ds = ls + TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qcol = 8 * j + 2 * t4;  // columns qcol, qcol + 1
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qcol);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + qcol);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float pr = expf(fmaf(sT[4 * j + e], SCALE, -(odd ? l2.y : l2.x)));
          sT[4 * j + e] = pr;
          dpT[4 * j + e] = pr * (dpT[4 * j + e] - (odd ? d2.y : d2.x)) * SCALE;
        }
      }
      mbar_arrive(&stat_empty[st]);  // every consumer thread has read the slot
      const unsigned char* qtc = ring.wait(p + 1);
      chunk_products<true>(part, qtc, qtc + PART_BYTES,
                           [&](int kk, float (&x)[4]) { acc_frag(dpT, kk, x); });
      ring.release(p + 1);
#pragma unroll
      for (int e = 0; e < 32; ++e) dka[e] += part[e];
      const unsigned char* gtc = ring.wait(p + 3);
      chunk_products<true>(part, gtc, gtc + PART_BYTES,
                           [&](int kk, float (&x)[4]) { acc_frag(sT, kk, x); });
      ring.release(p + 3);
#pragma unroll
      for (int e = 0; e < 32; ++e) dva[e] += part[e];
    }
    if (wt == 0) mbar_arrive(iempty);
    const size_t row0 = static_cast<size_t>(item.b) * N + k0;
    store_rows(dk, row0, r, N - k0, D, item.h * DH + 2 * t4, dka);
    store_rows(dv, row0, r, N - k0, D, item.h * DH + 2 * t4, dva);
  }
}

// DKV = false: the dq kernel (item operands a0 = q, a1 = g; the stream r0 =
// k, r1 = v). DKV = true: the dk/dv kernel (items a0 = k, a1 = v; the
// stream r0 = q, r1 = g, with the chunk's lse and D).
template <bool DKV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap map_a0,
                     const __grid_constant__ CUtensorMap map_a1,
                     const __grid_constant__ CUtensorMap map_r0,
                     const __grid_constant__ CUtensorMap map_r1, const float* __restrict__ o,
                     const float* __restrict__ g, const float* __restrict__ lse,
                     float* __restrict__ delta, float* __restrict__ out0,
                     float* __restrict__ out1, int B, int N, int H, int o_row, int g_row) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* item_buf = smem;
  unsigned char* split = item_buf + ITEM_BYTES;
  unsigned char* raw = split + SPLIT_SLOTS * SPLIT_BYTES;
  unsigned char* extra = raw + RAW_SLOTS * RAW_BYTES;  // dq: D per row; dk/dv: the stat ring
  uint64_t* ifull = reinterpret_cast<uint64_t*>(
      extra + (DKV ? STAT_SLOTS * STAT_BYTES : CONSUMERS * TILE * 4));
  uint64_t* iempty = ifull + 1;
  uint64_t* raw_full = iempty + 1;
  uint64_t* raw_empty = raw_full + RAW_SLOTS;
  uint64_t* split_full = raw_empty + RAW_SLOTS;
  uint64_t* split_empty = split_full + SPLIT_SLOTS;
  uint64_t* stat_full = split_empty + SPLIT_SLOTS;
  uint64_t* stat_empty = stat_full + STAT_SLOTS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(ifull, 1);
    mbar_init(iempty, CONSUMERS);
    for (int s = 0; s < RAW_SLOTS; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], SPLITTERS);
    }
    for (int s = 0; s < SPLIT_SLOTS; ++s) {
      mbar_init(&split_full[s], SPLITTERS);
      mbar_init(&split_empty[s], CONSUMERS);
    }
    for (int s = 0; s < STAT_SLOTS; ++s) {
      mbar_init(&stat_full[s], 1);
      mbar_init(&stat_empty[s], CONSUMERS * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_blk = (N + BLOCK - 1) / BLOCK;
  const int items = B * H * n_blk;
  const int n_chunks = N / TILE;

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    const int pt = tid - CONSUMERS * 128;
    if (pt == 0) {
      // one thread starts every copy
      int qi = 0, rp = 0, sp = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
        const Item item(it, n_blk, H);
        const int col = item.h * DH;
        mbar_wait(iempty, (qi & 1) ^ 1);
        mbar_arrive_expect_tx(ifull, ITEM_BYTES);
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int off = w * RAW_BYTES + half * BOX_BYTES;
            tma_load_3d(item_buf + off, &map_a0, ifull, col + 32 * half, item.r0 + TILE * w,
                        item.b);
            tma_load_3d(item_buf + CONSUMERS * RAW_BYTES + off, &map_a1, ifull, col + 32 * half,
                        item.r0 + TILE * w, item.b);
          }
        }
        const size_t stat = (static_cast<size_t>(item.b) * H + item.h) * N;
        for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
          for (int op = 0; op < 2; ++op, ++rp) {
            const int slot = rp % RAW_SLOTS;
            mbar_wait(&raw_empty[slot], ((rp / RAW_SLOTS) & 1) ^ 1);
            mbar_arrive_expect_tx(&raw_full[slot], RAW_BYTES);
            unsigned char* dst = raw + slot * RAW_BYTES;
            const CUtensorMap* map = op ? &map_r1 : &map_r0;
            tma_load_3d(dst, map, &raw_full[slot], col, c * TILE, item.b);
            tma_load_3d(dst + BOX_BYTES, map, &raw_full[slot], col + 32, c * TILE, item.b);
          }
          if (DKV) {
            const int st = sp % STAT_SLOTS;
            mbar_wait(&stat_empty[st], ((sp / STAT_SLOTS) & 1) ^ 1);
            mbar_arrive_expect_tx(&stat_full[st], STAT_BYTES);
            unsigned char* dst = extra + st * STAT_BYTES;
            bulk_load(dst, lse + stat + c * TILE, TILE * 4, &stat_full[st]);
            bulk_load(dst + TILE * 4, delta + stat + c * TILE, TILE * 4, &stat_full[st]);
            ++sp;
          }
        }
      }
    } else if (pt >= 32) {
      // the splitters: each raw chunk as it is, then transposed (dq's V: as
      // it is only)
      const int sid = pt - 32;
      int rp = 0, p = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
          for (int op = 0; op < 2; ++op, ++rp) {
            const int slot = rp % RAW_SLOTS;
            mbar_wait(&raw_full[slot], (rp / RAW_SLOTS) & 1);
            const unsigned char* src = raw + slot * RAW_BYTES;
            const int outs = (DKV || op == 0) ? 2 : 1;
            for (int k = 0; k < outs; ++k, ++p) {
              const int ss = p % SPLIT_SLOTS;
              mbar_wait(&split_empty[ss], ((p / SPLIT_SLOTS) & 1) ^ 1);
              unsigned char* hi = split + ss * SPLIT_BYTES;
              split_chunk(src, hi, hi + PART_BYTES, k == 1, sid);
              fence_proxy_async();  // the parts become visible to the wgmma reads
              mbar_arrive(&split_full[ss]);
            }
            mbar_arrive(&raw_empty[slot]);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const Ring ring{split, split_full, split_empty, tid & 127};
    if (DKV) {
      consume_dkv(item_buf, ring, ifull, iempty, extra, stat_full, stat_empty, out0, out1, B, N,
                  H, tid >> 7, tid & 127);
    } else {
      consume_dq(item_buf, ring, ifull, iempty, reinterpret_cast<float*>(extra), o, g, lse, delta,
                 out0, B, N, H, o_row, g_row, tid >> 7, tid & 127);
    }
  }
}

// a 3-D map over the float32 (B, N, row) view: columns [0, D), N tokens, B
// images, 64-row x 32-column boxes, 128-byte swizzle
int view_map(CUtensorMap* map, const void* ptr, int B, int N, int D, int row) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(row) * 4,
                               static_cast<uint64_t>(N) * row * 4};
  const uint32_t box[3] = {32, TILE, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool DKV>
int launch(const void* a0, const void* a1, const void* r0, const void* r1, const float* o,
           const float* g, const float* lse, float* delta, float* out0, float* out1, int B, int N,
           int H, int a0_row, int a1_row, int r0_row, int r1_row, int o_row, int g_row,
           cudaStream_t stream) {
  if (B < 1 || N < TILE || N % TILE || H < 1 || a0_row % 4 || a1_row % 4 || r0_row % 4 ||
      r1_row % 4 || o_row % 4 || g_row % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = H * DH;
  CUtensorMap ma0, ma1, mr0, mr1;
  if (int err = view_map(&ma0, a0, B, N, D, a0_row)) return err;
  if (int err = view_map(&ma1, a1, B, N, D, a1_row)) return err;
  if (int err = view_map(&mr0, r0, B, N, D, r0_row)) return err;
  if (int err = view_map(&mr1, r1, B, N, D, r1_row)) return err;
  constexpr int smem = smem_bytes<DKV>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_f32_kernel<DKV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * H * ((N + BLOCK - 1) / BLOCK);
  flash_bwd_f32_kernel<DKV><<<items < sms ? items : sms, THREADS, smem, stream>>>(
      ma0, ma1, mr0, mr1, o, g, lse, delta, out0, out1, B, N, H, o_row, g_row);
  return static_cast<int>(cudaGetLastError());
}

static_assert(smem_bytes<true>() <= 232448 && smem_bytes<false>() <= 232448,
              "flash_attention_bwd_f32: shared memory past a block's 227 KB");

}  // namespace

// q, k, v, o, g: (B*N, *) float32 rows with row strides q_row, k_row, v_row,
// o_row, g_row elements (multiples of 4), head h at columns h*64 (o the
// forward's output, g the gradient of o), 16-byte aligned. lse: (B,
// n_heads, N) float32 from the forward. delta: (B, n_heads, N) float32,
// written here (rowsum(g * o)). dq: (B*N, D) float32, D = n_heads * 64. N %
// 64 == 0. Run it before ltd_flash_attention_bwd_f32_dkv.
LTD_API int ltd_flash_attention_bwd_f32_dq(const float* q, const float* k, const float* v,
                                           const float* o, const float* g, const float* lse,
                                           float* delta, float* dq, int B, int N, int n_heads,
                                           int q_row, int k_row, int v_row, int o_row, int g_row,
                                           void* stream) {
  return launch<false>(q, g, k, v, o, g, lse, delta, dq, nullptr, B, N, n_heads, q_row, g_row,
                       k_row, v_row, o_row, g_row, static_cast<cudaStream_t>(stream));
}

// The same q, k, v, g, lse and the delta the dq kernel wrote (both 16-byte
// aligned); dk, dv: (B*N, D) float32.
LTD_API int ltd_flash_attention_bwd_f32_dkv(const float* q, const float* k, const float* v,
                                            const float* g, const float* lse, const float* delta,
                                            float* dk, float* dv, int B, int N, int n_heads,
                                            int q_row, int k_row, int v_row, int g_row,
                                            void* stream) {
  return launch<true>(k, v, q, g, nullptr, g, lse, const_cast<float*>(delta), dk, dv, B, N,
                      n_heads, k_row, v_row, q_row, g_row, g_row, g_row,
                      static_cast<cudaStream_t>(stream));
}
