// flash_attention_bwd_f32: dq, dk, dv of o = softmax(q k^T / sqrt(64)) v per
// (image, head), float32 q, k, v and g (the gradient of o), at float32
// accuracy on the tensor cores (3xTF32 wgmma); and, on the same two
// kernels, self_attention_bwd_f32, the training layer's self-attention
// backward in float32.
//
// Replaces, when their inputs are float32 (TrainConfig(compute_dtype=
// "float32"), the JAX package's default):
// - transformer_latent_diffusion_tpu/ops/attention.py::_pallas_attention_bwd
//   (`_flash_bwd_kernel`, pallas_call at attention.py:247, K4a, 512 <= N <=
//   2048) and ::_pallas_attention_bwd_tiled (`_flash_bwd_tiled_kernel`,
//   pallas_call at attention.py:313, K4b, N <= 8192): finetune_highres to
//   512 and 1024 px, multires buckets;
// - the self-attention backward of transformer_latent_diffusion_tpu/ops/
//   fused_layer_vjp.py::_bwd_kernel (:221-236, pallas_call at :289; K2) and
//   of ops/fused_attn_vjp.py::_bwd_kernel (pallas_call at :276; K6), N <=
//   256, ragged N allowed.
// The TPU kernels compute in the weights' dtype: in float32 p and ds / 8
// are not rounded and every sum is float32.
//
// What bounds it on the H100: operations. The function needs five products
// of 2 N^2 64 operations per (image, head), each run as three TF32
// products: at 512 px (B = 64, 12 heads, N = 1024) 515 GFLOP of float32
// work, 3.12 ms at 495 / 3 TFLOP/s; at 1024 px (B = 16, N = 4096) 12.5 ms;
// in the 256 px layer (B = 128, N = 256) 0.39 ms. The bytes take less (q,
// k, v, o, g in, dq, dk, dv out: 1.6 GB at 512 px, 0.48 ms).
//
// What this design does about that. Two kernels, dq then dk/dv, so every
// output element has one writer and every sum a fixed order (two launches
// are bit-equal). They recompute S = Q K^T and dP = g V^T in both (7
// products; the flash route) and, in the self-attention mode, the dq
// kernel first makes each row's statistics itself in a pass of S and dP
// over the keys (the layer's recompute keeps neither o nor lse): 9
// products, 0.70 ms of 3xTF32 work at the 256 px layer's shapes.
// - A persistent grid (one block per SM) walks work items (image, head,
//   128-row block): query rows for dq, key rows for dk/dv.
// - The item's two operands of 128 rows (Q and g for dq, K and V for dk/dv)
//   arrive by TMA through 3-D maps over (B, N, columns), 128-byte swizzled,
//   as they are stored, into one 64 KB buffer: rows past N arrive as zeros,
//   never as the next image's rows. They are the A operands of the products
//   whose rows they are. The dq kernel splits its 64 query rows' fragments
//   into TF32 parts once an item and keeps them in 64 registers; the other
//   operand (and in dk/dv both) each consumer thread splits 4 values at a
//   time as a K step is issued, the next step's values read while the
//   tensor cores run this one. Every split is hopper.cuh's tf32_split_fast
//   (hi rounded to nearest by an integer add and mask, lo = x - hi left for
//   the tensor cores to read: 3 instructions a value where the cvt.rna form
//   takes 10).
// - The other side streams in chunks of 64 rows (K and V for dq, Q and g
//   for dk/dv). One producer thread brings each chunk by TMA into a ring of
//   two raw slots; the producer warpgroup's three other warps split it
//   (f32_chunk.cuh's split_chunk, its fast form) into a ring of four split
//   slots of 32 KB (hi and lo parts), as it is (the B operand of a product
//   over the head columns: S, dP, S^T = K Q^T, dP^T = V g^T) and
//   transposed, keys in the order of each 8 that puts the score
//   accumulators straight into A fragments (the B operand of a product over
//   the chunk's rows: dq += dS K, dk += dS^T Q, dv += P^T g). Per chunk dq
//   takes K, V, K^T; dk/dv Q, g, Q^T, g^T, in that order, so the slots a
//   chunk's first products wait for are those the previous chunk's first
//   products freed.
// - Two consumer warpgroups (`setmaxnreg`: 232 registers, the producer's 40)
//   own 64 rows of the item each and share every split chunk. A chunk is two
//   runs of wgmma per warpgroup: S and dP together (16 K steps of three
//   m64n64k8 TF32 wgmma, the small terms first, each product into a fresh
//   64 x 64 tile), then the products over the chunk's rows (dq: 8 steps; dk
//   and dv: 16). The warpgroups take the tensor cores in turns (two named
//   barriers, ping-pong): a warpgroup hands the turn over once its run's
//   last step is issued, then waits for its results and does its exponentials
//   (p = exp(s / 8 - lse) by `expf`, ds = p (dp - D) / 8, neither rounded)
//   while the other's run keeps the tensor cores busy. Each partial tile is
//   added into the running dq (or dk, dv) with ordinary float32 rounding,
//   since the tensor cores may add with truncation and one chain over 4096
//   rows would drift past float32 accuracy.
// - Flash route: the dq kernel writes D = rowsum(g o) for the dk/dv kernel,
//   which reads the chunk's 64 lse and D values by a bulk copy into a ring
//   of two 512-byte slots. Self-attention: the dq kernel's first pass over
//   the keys carries each thread's running max m, sum l of exp(s / 8 - m)
//   and sum t of exp(s / 8 - m) dp per row, merges them over the row's four
//   threads in a fixed order, and writes lse = m / 8 + log l and D = t / l,
//   rows past N (to the chunks' end) as lse = +inf and D = 0, so that those
//   query rows add nothing in the dk/dv kernel.
// Keys past N take p = 0 in the dq kernel; query rows past N are not
// stored, nor are keys past N by the dk/dv kernel.
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

// DQ: the flash route's dq kernel (lse given, D = rowsum(g o) written);
// DQ_STATS: the self-attention's (lse and D made from the keys, written);
// DKV: the dk/dv kernel of both
enum Mode { DQ, DQ_STATS, DKV };

template <int MODE>
constexpr int smem_bytes() {
  return 1024 + ITEM_BYTES + SPLIT_SLOTS * SPLIT_BYTES + RAW_SLOTS * RAW_BYTES +
         (MODE == DKV ? STAT_SLOTS * STAT_BYTES : CONSUMERS * TILE * 4) +
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

// rows r, r + 8 of a 64 x 64 accumulator tile to float32 rows `ld` elements
// apart, head columns at `col`; rows at or past `limit` skipped
__device__ __forceinline__ void store_rows(float* out, size_t row0, int r, int limit, int ld,
                                           int col, const float (&acc)[32]) {
  float* o0 = out + (row0 + r) * ld + col;
  float* o1 = o0 + static_cast<size_t>(8) * ld;
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

// One run of 3xTF32 wgmma: NP (1 or 2) products of one chunk, each 8 K steps
// into a fresh 64 x 64 tile: d0 = A0 B0, then d1 = A1 B1, B the split parts
// (hi, then lo) at b0 / b1, A's float32 values of step kk given by f0 /
// f1(kk, x) and split here, each step's three wgmma the small terms first.
// Two steps are in flight; the next step's values are read while the
// tensor cores run this one. The turn is passed on once the last step is
// issued; returns with every product done.
template <int NP, typename F0, typename F1>
__device__ __forceinline__ void products(float (&d0)[32], const unsigned char* b0, F0 f0,
                                         float (&d1)[32], const unsigned char* b1, F1 f1,
                                         const Turn& turn) {
  constexpr int STEPS = 8 * NP;
  uint32_t fh[2][4], fl[2][4];
  float x[4];
  f0(0, x);
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int b = i & 1, kk = i & 7;
    tf32_frag_fast(x, fh[b], fl[b]);
    if (i + 1 < 8) {
      f0(i + 1, x);
    } else if (i + 1 < STEPS) {
      f1(i - 7, x);
    }
    wgmma_fence();
    const unsigned char* part = i < 8 ? b0 : b1;
    float(&d)[32] = i < 8 ? d0 : d1;
    const uint64_t dh = part_desc(part, kk), dl = part_desc(part + PART_BYTES, kk);
    if (kk == 0) {
      wgmma_m64n64k8_tf32_rs_first(d, fl[b], dh);
    } else {
      wgmma_m64n64k8_tf32_rs(d, fl[b], dh, 1);
    }
    wgmma_m64n64k8_tf32_rs(d, fh[b], dl, 1);
    wgmma_m64n64k8_tf32_rs(d, fh[b], dh, 1);
    wgmma_commit();
    if (i == STEPS - 1) {
      turn.pass();
      wgmma_wait<0>();
    } else if (i > 0) {
      // the previous step's products are done: its fragments may be rewritten
      wgmma_wait<1>();
    }
  }
  fence_regs(d0);
  if (NP == 2) fence_regs(d1);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    fence_regs(fh[b]);
    fence_regs(fl[b]);
  }
}

// S and dP of a chunk as products<2> does them, S's A fragments given
// split (the dq kernel's query rows, split once an item and kept in 64
// registers): S's 24 wgmma go out at once, then dP's steps as products<2>
// issues them.
template <typename F1>
__device__ __forceinline__ void products_pre(float (&d0)[32], const unsigned char* b0,
                                             const uint32_t (&ah)[8][4],
                                             const uint32_t (&al)[8][4], float (&d1)[32],
                                             const unsigned char* b1, F1 f1, const Turn& turn) {
  uint32_t fh[2][4], fl[2][4];
  float x[4];
  f1(0, x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dh = part_desc(b0, kk), dl = part_desc(b0 + PART_BYTES, kk);
    if (kk == 0) {
      wgmma_m64n64k8_tf32_rs_first(d0, al[kk], dh);
    } else {
      wgmma_m64n64k8_tf32_rs(d0, al[kk], dh, 1);
    }
    wgmma_m64n64k8_tf32_rs(d0, ah[kk], dl, 1);
    wgmma_m64n64k8_tf32_rs(d0, ah[kk], dh, 1);
  }
  wgmma_commit();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = i & 1;
    tf32_frag_fast(x, fh[b], fl[b]);
    if (i + 1 < 8) f1(i + 1, x);
    wgmma_fence();
    const uint64_t dh = part_desc(b1, i), dl = part_desc(b1 + PART_BYTES, i);
    if (i == 0) {
      wgmma_m64n64k8_tf32_rs_first(d1, fl[b], dh);
    } else {
      wgmma_m64n64k8_tf32_rs(d1, fl[b], dh, 1);
    }
    wgmma_m64n64k8_tf32_rs(d1, fh[b], dl, 1);
    wgmma_m64n64k8_tf32_rs(d1, fh[b], dh, 1);
    wgmma_commit();
    if (i == 7) {
      turn.pass();
      wgmma_wait<0>();
    } else {
      wgmma_wait<1>();
    }
  }
  fence_regs(d0);
  fence_regs(d1);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    fence_regs(fh[b]);
    fence_regs(fl[b]);
  }
}

// The self-attention's first pass, one chunk: each of the thread's rows r
// (h = 0) and r + 8 (h = 1) over its 16 keys of the chunk (8 j + 2 t4 and
// + 1, from key k0; keys at or past N left out): the running max m of s,
// the sum l of exp(s / 8 - m / 8) and the sum t of exp(s / 8 - m / 8) dp,
// both rescaled when m grows.
__device__ __forceinline__ void stats_chunk(const float (&s)[32], const float (&dp)[32], int k0,
                                            int N, int t4, float (&m)[2], float (&l)[2],
                                            float (&t)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * j + 2 * t4 + e < N) mx = fmaxf(mx, s[4 * j + 2 * h + e]);
    if (mx == -INFINITY) continue;  // no key of this thread yet
    const float nm = -mx * SCALE;
    const float cf = expf(fmaf(m[h], SCALE, nm));  // 0 for the first keys, 1 if m holds
    float ls = 0.f, ts = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * j + 2 * t4 + e < N) {
          const float ex = expf(fmaf(s[4 * j + 2 * h + e], SCALE, nm));
          ls += ex;
          ts = fmaf(ex, dp[4 * j + 2 * h + e], ts);
        }
    l[h] = fmaf(l[h], cf, ls);
    t[h] = fmaf(t[h], cf, ts);
    m[h] = mx;
  }
}

// dq of the warpgroup's 64 query rows of each item. DQ: D = rowsum(g o)
// first (written to `delta` for the dk/dv kernel). DQ_STATS: a first pass
// of S and dP over the key chunks for lse and D (both written, rows past N
// padded). Then per key chunk S = Q K^T and dP = g V^T, dS = P (dP - D) / 8
// with P = exp(S / 8 - lse), dq += dS K.
template <int MODE>
__device__ __forceinline__ void consume_dq(const unsigned char* item_buf, const Ring& ring,
                                           const Turn& turn, uint64_t* ifull, uint64_t* iempty,
                                           float* dsh, const float* __restrict__ o,
                                           const float* __restrict__ g, float* __restrict__ lse,
                                           float* __restrict__ delta, float* __restrict__ dq,
                                           int B, int N, int H, int o_row, int g_row,
                                           int out_row, int wg, int wt) {
  const int lane = wt & 31;
  const int t4 = lane & 3;
  const int r = (wt >> 5) * 16 + (lane >> 2);  // this thread's rows r, r + 8 of the 64
  const int n_blk = (N + BLOCK - 1) / BLOCK;
  const int items = B * H * n_blk;
  const int n_chunks = (N + TILE - 1) / TILE;
  const int np = n_chunks * TILE;  // the statistics' row length
  float* dw = dsh + wg * TILE;
  const unsigned char* qa = item_buf + wg * RAW_BYTES;
  const unsigned char* ga = item_buf + (CONSUMERS + wg) * RAW_BYTES;
  auto fq = [&](int kk, float(&x)[4]) { raw_frag(qa, r, 8 * kk + t4, x); };
  auto fg = [&](int kk, float(&x)[4]) { raw_frag(ga, r, 8 * kk + t4, x); };
  int qi = 0, p = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
    const Item item(it, n_blk, H);
    const int q0 = item.r0 + wg * TILE;  // this warpgroup's first query
    const size_t bh = static_cast<size_t>(item.b) * H + item.h;
    const int r0 = q0 + r, r1 = r0 + 8;
    float d0, d1, nl0, nl1;  // D and -lse of rows r0, r1
    if constexpr (MODE == DQ) {
      // D of the warpgroup's 64 rows: two threads a row, 32 columns each
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
        if (row < N) delta[bh * np + row] = acc;
      }
      named_barrier(1 + wg, 128);
      d0 = dw[r];
      d1 = dw[r + 8];
      nl0 = r0 < N ? -lse[bh * np + r0] : 0.f;
      nl1 = r1 < N ? -lse[bh * np + r1] : 0.f;
      named_barrier(1 + wg, 128);  // dw is read: the next item may write it
    }
    mbar_wait(ifull, qi & 1);
    uint32_t qh[8][4], ql[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float x[4];
      fq(kk, x);
      tf32_frag_fast(x, qh[kk], ql[kk]);
    }
    if constexpr (MODE == DQ_STATS) {
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
      for (int c = 0; c < n_chunks; ++c, p += 2) {
        float s[32], dp[32];
        const unsigned char* kc = ring.wait(p);
        const unsigned char* vc = ring.wait(p + 1);
        turn.take();
        products_pre(s, kc, qh, ql, dp, vc, fg, turn);
        ring.release(p);
        ring.release(p + 1);
        stats_chunk(s, dp, c * TILE, N, t4, m, l, t);
      }
      // the row's four threads merged, in one order: lse = m / 8 + log l,
      // D = t / l
      float lse_r[2], d_r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mq = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
        const float cf = expf(fmaf(m[h], SCALE, -mq * SCALE));
        float lq = l[h] * cf, tq = t[h] * cf;
        lq += __shfl_xor_sync(0xffffffffu, lq, 1);
        tq += __shfl_xor_sync(0xffffffffu, tq, 1);
        lq += __shfl_xor_sync(0xffffffffu, lq, 2);
        tq += __shfl_xor_sync(0xffffffffu, tq, 2);
        lse_r[h] = fmaf(mq, SCALE, logf(lq));
        d_r[h] = tq / lq;
      }
      if (t4 == 0) {
        // rows to the chunks' end (a last item may run past it)
        if (r0 < np) {
          lse[bh * np + r0] = r0 < N ? lse_r[0] : INFINITY;
          delta[bh * np + r0] = r0 < N ? d_r[0] : 0.f;
        }
        if (r1 < np) {
          lse[bh * np + r1] = r1 < N ? lse_r[1] : INFINITY;
          delta[bh * np + r1] = r1 < N ? d_r[1] : 0.f;
        }
      }
      // rows past N are not stored: any finite values do
      nl0 = r0 < N ? -lse_r[0] : 0.f;
      nl1 = r1 < N ? -lse_r[1] : 0.f;
      d0 = r0 < N ? d_r[0] : 0.f;
      d1 = r1 < N ? d_r[1] : 0.f;
    }

    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int c = 0; c < n_chunks; ++c, p += 3) {
      float s[32], dp[32];
      const unsigned char* kc = ring.wait(p);
      const unsigned char* vc = ring.wait(p + 1);
      turn.take();
      products_pre(s, kc, qh, ql, dp, vc, fg, turn);
      ring.release(p);
      ring.release(p + 1);
      if (c == n_chunks - 1 && wt == 0) mbar_arrive(iempty);  // the item is read
      // ds = p (dp - D) / 8, p = exp(s / 8 - lse): s[4 j + e] is row r + 8 (e / 2),
      // key 8 j + 2 t4 + e % 2 of the chunk; keys past N take p = 0
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float pr = expf(fmaf(s[4 * j + e], SCALE, lo ? nl0 : nl1));
          const float ds = pr * (dp[4 * j + e] - (lo ? d0 : d1)) * SCALE;
          s[4 * j + e] = c * TILE + 8 * j + 2 * t4 + (e & 1) < N ? ds : 0.f;
        }
      }
      const unsigned char* ktc = ring.wait(p + 2);
      turn.take();
      products<1>(dp, ktc, [&](int kk, float(&x)[4]) { acc_frag(s, kk, x); }, dp, ktc, fq,
                  turn);
      ring.release(p + 2);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += dp[e];
    }
    store_rows(dq, static_cast<size_t>(item.b) * N + q0, r, N - q0, out_row, item.h * DH + 2 * t4,
               acc);
  }
}

// dk and dv of the warpgroup's 64 keys of each item: per query chunk S^T =
// K Q^T, dP^T = V g^T, P^T = exp(S^T / 8 - lse), dS^T = P^T (dP^T - D) / 8,
// dk += dS^T Q, dv += P^T g.
__device__ __forceinline__ void consume_dkv(const unsigned char* item_buf, const Ring& ring,
                                            const Turn& turn, uint64_t* ifull, uint64_t* iempty,
                                            const unsigned char* stats, uint64_t* stat_full,
                                            uint64_t* stat_empty, float* __restrict__ dk,
                                            float* __restrict__ dv, int B, int N, int H,
                                            int out_row, int wg, int wt) {
  const int lane = wt & 31;
  const int t4 = lane & 3;
  const int r = (wt >> 5) * 16 + (lane >> 2);
  const int n_blk = (N + BLOCK - 1) / BLOCK;
  const int items = B * H * n_blk;
  const int n_chunks = (N + TILE - 1) / TILE;
  const unsigned char* ka = item_buf + wg * RAW_BYTES;
  const unsigned char* va = item_buf + (CONSUMERS + wg) * RAW_BYTES;
  auto fk = [&](int kk, float(&x)[4]) { raw_frag(ka, r, 8 * kk + t4, x); };
  auto fv = [&](int kk, float(&x)[4]) { raw_frag(va, r, 8 * kk + t4, x); };
  int qi = 0, p = 0, sp = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
    const Item item(it, n_blk, H);
    const int k0 = item.r0 + wg * TILE;  // this warpgroup's first key
    mbar_wait(ifull, qi & 1);
    float dka[32], dva[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
    for (int c = 0; c < n_chunks; ++c, p += 4, ++sp) {
      // rows: this warpgroup's keys; columns: the chunk's queries
      float sT[32], dpT[32];
      const unsigned char* qc = ring.wait(p);
      const unsigned char* gc = ring.wait(p + 1);
      turn.take();
      products<2>(sT, qc, fk, dpT, gc, fv, turn);
      ring.release(p);
      ring.release(p + 1);
      if (c == n_chunks - 1 && wt == 0) mbar_arrive(iempty);  // the item is read
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
      float pk[32], pv[32];
      const unsigned char* qtc = ring.wait(p + 2);
      const unsigned char* gtc = ring.wait(p + 3);
      turn.take();
      products<2>(pk, qtc, [&](int kk, float(&x)[4]) { acc_frag(dpT, kk, x); }, pv, gtc,
                  [&](int kk, float(&x)[4]) { acc_frag(sT, kk, x); }, turn);
      ring.release(p + 2);
      ring.release(p + 3);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        dka[e] += pk[e];
        dva[e] += pv[e];
      }
    }
    const size_t row0 = static_cast<size_t>(item.b) * N + k0;
    store_rows(dk, row0, r, N - k0, out_row, item.h * DH + 2 * t4, dka);
    store_rows(dv, row0, r, N - k0, out_row, item.h * DH + 2 * t4, dva);
  }
}

// DQ, DQ_STATS: the dq kernel (item operands a0 = q, a1 = g; the stream r0
// = k, r1 = v; DQ_STATS streams them twice). DKV: the dk/dv kernel (items
// a0 = k, a1 = v; the stream r0 = q, r1 = g, with the chunk's lse and D).
// lse and D rows are N long rounded up to whole 64-row chunks.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap map_a0,
                     const __grid_constant__ CUtensorMap map_a1,
                     const __grid_constant__ CUtensorMap map_r0,
                     const __grid_constant__ CUtensorMap map_r1, const float* __restrict__ o,
                     const float* __restrict__ g, float* __restrict__ lse,
                     float* __restrict__ delta, float* __restrict__ out0,
                     float* __restrict__ out1, int B, int N, int H, int o_row, int g_row,
                     int out_row) {
  constexpr bool DKV_K = MODE == DKV;
  constexpr int PASSES = MODE == DQ_STATS ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* item_buf = smem;
  unsigned char* split = item_buf + ITEM_BYTES;
  unsigned char* raw = split + SPLIT_SLOTS * SPLIT_BYTES;
  unsigned char* extra = raw + RAW_SLOTS * RAW_BYTES;  // dq: D per row; dk/dv: the stat ring
  uint64_t* ifull = reinterpret_cast<uint64_t*>(
      extra + (DKV_K ? STAT_SLOTS * STAT_BYTES : CONSUMERS * TILE * 4));
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
  const int n_chunks = (N + TILE - 1) / TILE;

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
        const size_t stat = (static_cast<size_t>(item.b) * H + item.h) * n_chunks * TILE;
        for (int pass = 0; pass < PASSES; ++pass) {
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
            if (DKV_K) {
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
      }
    } else if (pt >= 32) {
      // the splitters, per chunk: r0 as it is, r1 as it is, then (but in
      // the statistics pass) r0 transposed, and for dk/dv r1 transposed
      const int sid = pt - 32;
      int rp = 0, p = 0;
      auto put = [&](const unsigned char* src, bool transposed) {
        const int ss = p % SPLIT_SLOTS;
        mbar_wait(&split_empty[ss], ((p / SPLIT_SLOTS) & 1) ^ 1);
        unsigned char* hi = split + ss * SPLIT_BYTES;
        split_chunk<true>(src, hi, hi + PART_BYTES, transposed, sid);
        fence_proxy_async();  // the parts become visible to the wgmma reads
        mbar_arrive(&split_full[ss]);
        ++p;
      };
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        for (int pass = 0; pass < PASSES; ++pass) {
          for (int c = 0; c < n_chunks; ++c, rp += 2) {
            const int s0 = rp % RAW_SLOTS, s1 = (rp + 1) % RAW_SLOTS;
            const unsigned char* src0 = raw + s0 * RAW_BYTES;
            const unsigned char* src1 = raw + s1 * RAW_BYTES;
            mbar_wait(&raw_full[s0], (rp / RAW_SLOTS) & 1);
            put(src0, false);
            mbar_wait(&raw_full[s1], ((rp + 1) / RAW_SLOTS) & 1);
            put(src1, false);
            if (pass == PASSES - 1) put(src0, true);
            mbar_arrive(&raw_empty[s0]);
            if (DKV_K) put(src1, true);
            mbar_arrive(&raw_empty[s1]);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const Ring ring{split, split_full, split_empty, tid & 127};
    const Turn turn{wg};
    if (wg == 1) turn.pass();  // warpgroup 0 runs first
    if constexpr (DKV_K) {
      consume_dkv(item_buf, ring, turn, ifull, iempty, extra, stat_full, stat_empty, out0, out1,
                  B, N, H, out_row, wg, tid & 127);
    } else {
      consume_dq<MODE>(item_buf, ring, turn, ifull, iempty, reinterpret_cast<float*>(extra), o, g,
                       lse, delta, out0, B, N, H, o_row, g_row, out_row, wg, tid & 127);
    }
    if (wg == 0) turn.take();  // warpgroup 1's last pass
  }
}

// a 3-D map over the float32 (B, N, row) view: columns [0, D), N tokens, B
// images, 64-row x 32-column boxes, 128-byte swizzle (rows past N read as
// zeros)
int view_map(CUtensorMap* map, const void* ptr, int B, int N, int D, int row) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(row) * 4,
                               static_cast<uint64_t>(N) * row * 4};
  const uint32_t box[3] = {32, TILE, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int MODE>
int launch(const float* a0, const float* a1, const float* r0, const float* r1, const float* o,
           const float* g, float* lse, float* delta, float* out0, float* out1, int B, int N,
           int H, int a0_row, int a1_row, int r0_row, int r1_row, int o_row, int g_row,
           int out_row, cudaStream_t stream) {
  if (B < 1 || N < 1 || H < 1 || a0_row % 4 || a1_row % 4 || r0_row % 4 || r1_row % 4 ||
      o_row % 4 || g_row % 4 || out_row % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = H * DH;
  CUtensorMap ma0, ma1, mr0, mr1;
  if (int err = view_map(&ma0, a0, B, N, D, a0_row)) return err;
  if (int err = view_map(&ma1, a1, B, N, D, a1_row)) return err;
  if (int err = view_map(&mr0, r0, B, N, D, r0_row)) return err;
  if (int err = view_map(&mr1, r1, B, N, D, r1_row)) return err;
  constexpr int smem = smem_bytes<MODE>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_f32_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * H * ((N + BLOCK - 1) / BLOCK);
  flash_bwd_f32_kernel<MODE><<<items < sms ? items : sms, THREADS, smem, stream>>>(
      ma0, ma1, mr0, mr1, o, g, lse, delta, out0, out1, B, N, H, o_row, g_row, out_row);
  return static_cast<int>(cudaGetLastError());
}

static_assert(smem_bytes<DKV>() <= 232448 && smem_bytes<DQ>() <= 232448,
              "flash_attention_bwd_f32: shared memory past a block's 227 KB");

constexpr int NMAX_SELF = 4 * TILE;  // the self-attention's tokens at most

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
  if (N % TILE) return static_cast<int>(cudaErrorInvalidValue);
  return launch<DQ>(q, g, k, v, o, g, const_cast<float*>(lse), delta, dq, nullptr, B, N,
                    n_heads, q_row, g_row, k_row, v_row, o_row, g_row, n_heads * DH,
                    static_cast<cudaStream_t>(stream));
}

// The same q, k, v, g, lse and the delta the dq kernel wrote (both 16-byte
// aligned); dk, dv: (B*N, D) float32.
LTD_API int ltd_flash_attention_bwd_f32_dkv(const float* q, const float* k, const float* v,
                                            const float* g, const float* lse, const float* delta,
                                            float* dk, float* dv, int B, int N, int n_heads,
                                            int q_row, int k_row, int v_row, int g_row,
                                            void* stream) {
  if (N % TILE) return static_cast<int>(cudaErrorInvalidValue);
  return launch<DKV>(k, v, q, g, nullptr, g, const_cast<float*>(lse), const_cast<float*>(delta),
                     dk, dv, B, N, n_heads, k_row, v_row, q_row, g_row, g_row, g_row,
                     n_heads * DH, static_cast<cudaStream_t>(stream));
}

// The self-attention backward, its dq kernel. qkv: (B*N, 3D) float32 rows
// [q | k | v] of the forward; dout: (B*N, D) float32, the gradient of the
// attention's output; stats: 2 B n_heads Np float32 (Np = N rounded up to
// a multiple of 64), written here (lse, then D, rows past N padded); dqkv:
// (B*N, 3D) float32, its dq columns written here. D = n_heads * 64, 1 <= N
// <= 256, all 16-byte aligned. Run it before ltd_self_attention_bwd_f32_dkv.
LTD_API int ltd_self_attention_bwd_f32_dq(const float* qkv, const float* dout, float* stats,
                                          float* dqkv, int B, int N, int n_heads, void* stream) {
  const int D = n_heads * DH;
  if (N > NMAX_SELF || n_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* delta = stats + static_cast<size_t>(B) * n_heads * ((N + TILE - 1) / TILE) * TILE;
  return launch<DQ_STATS>(qkv, dout, qkv + D, qkv + 2 * D, nullptr, dout, stats, delta, dqkv,
                          nullptr, B, N, n_heads, 3 * D, D, 3 * D, 3 * D, D, D, 3 * D,
                          static_cast<cudaStream_t>(stream));
}

// Its dk/dv kernel: the same qkv, dout and the stats the dq kernel wrote;
// the dk and dv columns of dqkv written here.
LTD_API int ltd_self_attention_bwd_f32_dkv(const float* qkv, const float* dout,
                                           const float* stats, float* dqkv, int B, int N,
                                           int n_heads, void* stream) {
  const int D = n_heads * DH;
  if (N > NMAX_SELF || n_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* lse = const_cast<float*>(stats);
  float* delta = lse + static_cast<size_t>(B) * n_heads * ((N + TILE - 1) / TILE) * TILE;
  return launch<DKV>(qkv + D, qkv + 2 * D, qkv, dout, nullptr, dout, lse, delta, dqkv + D,
                     dqkv + 2 * D, B, N, n_heads, 3 * D, 3 * D, 3 * D, D, D, D, 3 * D,
                     static_cast<cudaStream_t>(stream));
}
