// flash_attention_f32: o = softmax(q k^T / sqrt(64)) v per (image, head),
// float32 q, k, v and probabilities, any Nq, Nk >= 8, at float32 accuracy on
// the tensor cores (3xTF32 wgmma): the float32 form of flash_attention.cu.
//
// Replaces transformer_latent_diffusion_tpu/ops/attention.py::_pallas_attention
// (`_flash_kernel`, pallas_call at attention.py:99) when its inputs are
// float32 (the JAX package's default compute dtype on the linen path: 512
// and 1024 px deployments, the "mlp" and "moe" FFNs, a model sampled on
// another grid). The TPU kernel computes in the input dtype: the scores and
// P V accumulate in float32 and `p = (e / z).astype(v.dtype)` rounds
// nothing.
//
// What bounds it on the H100: operations. The function is 4 N^2 64
// operations per (image, head) (S = Q K^T and P V), every float32 product
// run as three TF32 products (hopper.cuh), so at a third of the card's 495
// TFLOP/s of TF32: at 512 px (B = 64, 12 heads, N = 1024) 206 GFLOP, 1.25
// ms, against 0.24 ms for its 805 MB of q, k, v and o; at 1024 px (B = 8,
// N = 4096) 412 GFLOP, 2.50 ms. The N^2 exponentials (0.8 G at 512 px) come
// next.
//
// What holds such a kernel back, and what this design does about it
// (scripts/flash_attention_f32_ab.py --variants times each lever).
// - Splitting K and V into their TF32 parts in shared memory is on the
//   critical path: rounding each value (3 instructions, 10 by cvt.rna) and
//   transposing V in units of 4 keys x 2 columns on three warps leaves the
//   tensor cores waiting. Here the high part is each value as it is stored
//   (the tensor cores read a 32-bit TF32 operand's top 19 bits, so it
//   counts as x truncated to TF32) and the low part lo = x - trunc(x) takes
//   two instructions; V is transposed in 4 x 4 blocks (16-byte reads and
//   writes, each quarter warp on 8 distinct bank groups); the whole
//   producer warpgroup splits.
// - The tensor cores idle while a warpgroup does its softmax if the two
//   consumer warpgroups run in lockstep. Here they take the tensor cores in
//   turns (hopper.cuh's Turn, named barriers 3 and 4): a warpgroup issues a
//   run of products, passes the turn on, and does its softmax (or adds its
//   P V partial) while the other warpgroup's run keeps the tensor cores
//   busy.
// - m64n64k8 TF32 wgmma fed one K step at a time, each step's A fragment
//   split while the previous step is waited for, is latency-bound (54.5% of
//   the TF32 rate, scripts/tf32_wgmma_rate.py; issued back to back, 98%).
//   Here every run is 24 wgmma issued back to back with one wait: S from
//   Q's parts, split once an item and held in 64 registers, and P V from
//   P's parts, all 64 split at once after the exponentials (registers: o
//   32, Q's parts 64, P's parts 64, the partial 32). Q and P split by
//   hopper.cuh's tf32_split_fast (hi rounded, lo = x - hi).
// - The exponentials are one FFMA and one MUFU.EX2 each: e = 2^(s C + nm),
//   C = log2(e) / 8, nm = -(m C) the row's offset rounded once, so the
//   rescale factor of the running sums is exactly 2^(nm_new - nm_old).
//
// The work. A persistent grid (one block per SM) walks the work items
// (image, head, 128-query tile), the query tiles of a head one after
// another, so the SMs that run at once read the same few heads' K and V
// and L2 serves them.
// - K and V stream through in chunks of 64 keys, K then V of each chunk.
//   The producer warpgroup's thread 0 brings each chunk with TMA (a 3-D map
//   over the (B, N, row) view, the column blocks of a fused QKV projection
//   read in place; two 64 x 32 float32 boxes, 128-byte swizzled; keys past
//   Nk arrive as zeros) into a ring of four raw slots, four chunks ahead of
//   the split; the warpgroup's 128 threads split each into its TF32 parts
//   in a ring of four split slots, K as it is and V transposed into the
//   slot order P's registers take (f32_chunk.cuh), then meet at a named
//   barrier, after which the raw slot takes the next copy. A split slot
//   goes back to the splitters when both consumer warpgroups are done with
//   it.
// - Two consumer warpgroups (`setmaxnreg`: 232 registers, the producer's
//   40) own 64 query rows each and share every split chunk: the splits are
//   paid once per 128 queries. A thread loads its Q fragments (rows r, r +
//   8; zeros past Nq) once per item. Per chunk, two runs: S = Q K^T as 3 x
//   8 wgmma m64n64k8.tf32 (A from registers, the small terms first: lo
//   B_hi, hi B_lo, hi B_hi), keys past Nk at -inf; the online softmax in
//   float32 (the row max over the thread's 16 scores of a row and its quad,
//   the offset nm, c = 2^(nm - nm_old) where nm moved, else 1, 0 at the
//   first chunk, e, the running sum l = l c + sum(e) per thread, P's
//   parts); then P V as 3 x 8 wgmma into a fresh 64 x 64 partial and O = O
//   c + partial in float32 with ordinary rounding (one FFMA per element:
//   the tensor cores may add with truncation, and one chain over 4096 keys
//   would drift past float32 accuracy; tests/test_torch_port_tf32_split.py
//   emulates this schedule). No probability is rounded.
// - After the last chunk the quad adds its sums, and each row's O is
//   divided by l and stored from the registers (rows past Nq skipped). Each
//   output element has one writer and every sum a fixed order: two
//   launches are bit-equal.
// - With `lse` (training: the backward, flash_attention_bwd_f32.cu, reads
//   it), the threads of t % 4 == 0 also write each row's float32
//   log-sum-exp log(l) - nm log(2); o is computed as without it.
// Shared memory: 4 x 16 KB raw slots and 4 x 32 KB split slots, 193 KB: one
// block per SM.

#include "f32_chunk.cuh"

#include <math.h>

namespace {

using namespace f32chunk;

constexpr int RAW_SLOTS = 4, SPLIT_SLOTS = 4;
constexpr int CONSUMERS = 2;
constexpr int QT = CONSUMERS * TILE;  // queries of a work item
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SPLIT_THREADS = 128;  // the producer warpgroup
constexpr int PRODUCER_BAR = 1;     // its named barrier (Turn takes 3 and 4)
constexpr int SMEM = 1024 + RAW_SLOTS * RAW_BYTES + SPLIT_SLOTS * SPLIT_BYTES +
                     (RAW_SLOTS + 2 * SPLIT_SLOTS) * 8;
constexpr float SCALE_LOG2E = 0.18033688011112042f;  // log2(e) / sqrt(64)
constexpr float LN2 = 0.69314718055994531f;

static_assert(SMEM <= 232448, "flash_attention_f32: shared memory past a block's 227 KB");

__device__ __forceinline__ float quad_max(float v) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2^x, the softmax's exponentials
__device__ __forceinline__ float softmax_exp2(float x) { return exp2_approx(x); }

// x's low TF32 part as the splitters make it: lo = x - trunc(x), exact, in
// two instructions; x itself is the high part, since the tensor cores read
// a 32-bit TF32 operand's top 19 bits (x truncated to TF32)
__device__ __forceinline__ uint32_t lo_part(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xFFFFE000u));
}

// Splitter `sid` (0..N-1) of the producer warps: its share of the
// raw chunk `src` into the parts hi (x as stored) and lo (lo_part), K as it
// is or (is_v) V^T in f32_chunk.cuh's slot order. V^T's unit is a 4 x 4
// block, keys 8 kg + 2 i + h (i = 0..3) of head columns 4 dq .. + 3: four
// 16-byte reads, then for each column j its 4 keys as the 16 bytes of V^T
// row 4 dq + j at slots 8 kg + 4 h ... Unit u takes dq % 8 = u % 8 and kb =
// 2 kg + h with kb % 8 = (u % 8) / 2 ^ (u / 8) % 8, so each quarter warp's
// reads and its writes fall in the 8 distinct 16-byte bank groups of a
// row (tests/test_torch_port_tf32_split.py checks the map).
template <int N>
__device__ __forceinline__ void split_as_stored(const unsigned char* src, unsigned char* hi,
                                                unsigned char* lo, bool is_v, int sid) {
  if (!is_v) {
    for (int e = sid; e < RAW_BYTES / 16; e += N) {
      const uint4 x = reinterpret_cast<const uint4*>(src)[e];
      reinterpret_cast<uint4*>(hi)[e] = x;
      reinterpret_cast<uint4*>(lo)[e] =
          make_uint4(lo_part(x.x), lo_part(x.y), lo_part(x.z), lo_part(x.w));
    }
    return;
  }
  for (int u = sid; u < TILE * DH / 16; u += N) {
    const int l3 = u & 7;
    const int dq = l3 | ((u >> 3) & 8);
    const int kb = (((l3 >> 1) ^ (u >> 3)) & 7) | ((u >> 4) & 8);
    const int kg = kb >> 1, h = kb & 1;
    uint4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const uint4*>(src + sw_off(8 * kg + 2 * i + h, 4 * dq));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 col = j == 0   ? make_uint4(x[0].x, x[1].x, x[2].x, x[3].x)
                        : j == 1 ? make_uint4(x[0].y, x[1].y, x[2].y, x[3].y)
                        : j == 2 ? make_uint4(x[0].z, x[1].z, x[2].z, x[3].z)
                                 : make_uint4(x[0].w, x[1].w, x[2].w, x[3].w);
      const int off = sw_off(4 * dq + j, 8 * kg + 4 * h);
      *reinterpret_cast<uint4*>(hi + off) = col;
      *reinterpret_cast<uint4*>(lo + off) =
          make_uint4(lo_part(col.x), lo_part(col.y), lo_part(col.z), lo_part(col.w));
    }
  }
}

// the work item `it`: image b, head h, the first query q0 of its tile
struct Item {
  int b, h, q0;
  __device__ __forceinline__ Item(int it, int n_qt, int H)
      : b(it / (H * n_qt)), h((it / n_qt) % H), q0((it % n_qt) * QT) {}
};

// One run in the warpgroup's turn: d = A B over a split chunk b (its hi
// part, then its lo part), A's TF32 parts ah, al (the fragments of 8 K
// steps) in registers; 24 wgmma issued back to back, the small terms of
// each step first, the turn passed on once the last is issued; returns
// with every product done.
__device__ __forceinline__ void run(float (&d)[32], const uint32_t (&ah)[8][4],
                                    const uint32_t (&al)[8][4], const unsigned char* b,
                                    const Turn& turn) {
  turn.take();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dh = part_desc(b, kk), dl = part_desc(b + PART_BYTES, kk);
    if (kk == 0) {
      wgmma_m64n64k8_tf32_rs_first(d, al[0], dh);
    } else {
      wgmma_m64n64k8_tf32_rs(d, al[kk], dh, 1);
    }
    wgmma_m64n64k8_tf32_rs(d, ah[kk], dl, 1);
    wgmma_m64n64k8_tf32_rs(d, ah[kk], dh, 1);
  }
  wgmma_commit();
  turn.pass();
  wgmma_wait<0>();
  fence_regs(d);
}

// Consumer warpgroup wg: for each item, its 64 query rows against every
// chunk of keys in the ring, in order, each chunk waited for and released.
__device__ __forceinline__ void consume(const unsigned char* split, uint64_t* split_full,
                                        uint64_t* split_empty, const Turn& turn,
                                        const float* __restrict__ q, float* __restrict__ out,
                                        float* __restrict__ lse, int B, int Nq, int Nk, int H,
                                        int q_row, int wg, int wt) {
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = (wt >> 5) * 16 + g;  // this thread's rows r and r + 8 of the 64
  const int n_qt = (Nq + QT - 1) / QT;
  const int items = B * H * n_qt;
  const int n_chunks = (Nk + TILE - 1) / TILE;
  const int D = H * DH;
  int ss = 0;
  uint32_t sphase = 0;
  auto next_chunk = [&]() -> const unsigned char* {
    mbar_wait(&split_full[ss], sphase);
    return split + ss * SPLIT_BYTES;
  };
  auto release = [&]() {
    if (wt == 0) mbar_arrive(&split_empty[ss]);
    if (++ss == SPLIT_SLOTS) {
      ss = 0;
      sphase ^= 1;
    }
  };
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item item(it, n_qt, H);
    const int r0 = item.q0 + wg * TILE + r, r1 = r0 + 8;
    // Q's TF32 parts: step kk holds columns 8 kk + t4 and + 4 of rows r0, r1
    uint32_t qh[DH / 8][4], ql[DH / 8][4];
    {
      const float* row0 = q + (static_cast<size_t>(item.b) * Nq + r0) * q_row + item.h * DH + t4;
      const float* row1 = row0 + static_cast<size_t>(8) * q_row;
      const bool in0 = r0 < Nq, in1 = r1 < Nq;
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const float x[4] = {in0 ? row0[8 * kk] : 0.f, in1 ? row1[8 * kk] : 0.f,
                            in0 ? row0[8 * kk + 4] : 0.f, in1 ? row1[8 * kk + 4] : 0.f};
        tf32_frag_fast(x, qh[kk], ql[kk]);
      }
    }
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // rows r0 and r1: the offsets nm = -(m C) of the running max m of the
    // raw scores (+inf before the first chunk), per-thread sums
    float nm0 = INFINITY, nm1 = INFINITY, l0 = 0.f, l1 = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      // S = Q K^T of the chunk: s[4 j + e] is row r + 8 (e / 2), key
      // 64 c + 8 j + 2 t4 + e % 2
      float s[32];
      run(s, qh, ql, next_chunk(), turn);
      release();

      if ((c + 1) * TILE > Nk) {  // the ragged last chunk: keys past Nk
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c * TILE + 8 * j + 2 * t4 + (e & 1) >= Nk) s[4 * j + e] = -INFINITY;
      }
      // the online softmax: every chunk holds a key below Nk, so the new
      // max is finite; c = 0 at the first chunk (nm_old = +inf)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float n0 = fminf(nm0, -(quad_max(mx0) * SCALE_LOG2E));
      const float n1 = fminf(nm1, -(quad_max(mx1) * SCALE_LOG2E));
      // 1 where the max holds, so that no error of ex2 at 0 adds up over the chunks
      const float c0 = n0 == nm0 ? 1.f : softmax_exp2(n0 - nm0);
      const float c1 = n1 == nm1 ? 1.f : softmax_exp2(n1 - nm1);
      nm0 = n0;
      nm1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = softmax_exp2(fmaf(s[4 * j], SCALE_LOG2E, n0));
        s[4 * j + 1] = softmax_exp2(fmaf(s[4 * j + 1], SCALE_LOG2E, n0));
        s[4 * j + 2] = softmax_exp2(fmaf(s[4 * j + 2], SCALE_LOG2E, n1));
        s[4 * j + 3] = softmax_exp2(fmaf(s[4 * j + 3], SCALE_LOG2E, n1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = fmaf(l0, c0, sum0);
      l1 = fmaf(l1, c1, sum1);
      // P's TF32 parts: step kk takes the chunk's keys 8 kk .. in V^T's slot
      // order, so its fragment is P's accumulators (row r, keys 2 t4 and +
      // 1; row r + 8 the same) as they are
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
        tf32_frag_fast(x, ph[kk], pl[kk]);
        // made before the run's wgmma.fence: ptxas would otherwise fence
        // each K step that reads a part made after it (C7519)
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }

      // P V of the chunk into a fresh partial, then O = O c + partial
      float part[32];
      run(part, ph, pl, next_chunk(), turn);
      release();
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        o[4 * d] = fmaf(o[4 * d], c0, part[4 * d]);
        o[4 * d + 1] = fmaf(o[4 * d + 1], c0, part[4 * d + 1]);
        o[4 * d + 2] = fmaf(o[4 * d + 2], c1, part[4 * d + 2]);
        o[4 * d + 3] = fmaf(o[4 * d + 3], c1, part[4 * d + 3]);
      }
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (lse != nullptr && t4 == 0) {
      float* lr = lse + (static_cast<size_t>(item.b) * H + item.h) * Nq;
      if (r0 < Nq) lr[r0] = fmaf(nm0, -LN2, logf(l0));
      if (r1 < Nq) lr[r1] = fmaf(nm1, -LN2, logf(l1));
    }
    float* o0 = out + (static_cast<size_t>(item.b) * Nq + r0) * D + item.h * DH + 2 * t4;
    float* o1 = o0 + static_cast<size_t>(8) * D;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (r0 < Nq)
        *reinterpret_cast<float2*>(o0 + 8 * d) = make_float2(o[4 * d] / l0, o[4 * d + 1] / l0);
      if (r1 < Nq)
        *reinterpret_cast<float2*>(o1 + 8 * d) =
            make_float2(o[4 * d + 2] / l1, o[4 * d + 3] / l1);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const float* __restrict__ q,
                           float* __restrict__ out, float* __restrict__ lse, int B, int Nq, int Nk,
                           int H, int q_row) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* split = smem;
  unsigned char* raw = split + SPLIT_SLOTS * SPLIT_BYTES;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(raw + RAW_SLOTS * RAW_BYTES);
  uint64_t* split_full = raw_full + RAW_SLOTS;
  uint64_t* split_empty = split_full + SPLIT_SLOTS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < RAW_SLOTS; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < SPLIT_SLOTS; ++s) {
      mbar_init(&split_full[s], SPLIT_THREADS);
      mbar_init(&split_empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_qt = (Nq + QT - 1) / QT;
  const int items = B * H * n_qt;
  // the ring's sequence per item: K of chunk 0, V of chunk 0, K of chunk 1, ...
  const int n_steps = 2 * ((Nk + TILE - 1) / TILE);

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    // The producer warpgroup: every thread splits each raw chunk into its
    // TF32 parts, position p of the block's sequence from raw slot p %
    // RAW_SLOTS into split slot p % SPLIT_SLOTS; thread 0 also starts the
    // copies, RAW_SLOTS positions ahead, each into the raw slot that all
    // splitters have just read.
    const int sid = tid - CONSUMERS * 128;
    const int total = (items - blockIdx.x + gridDim.x - 1) / gridDim.x * n_steps;
    auto load = [&](int p) {
      const Item item(blockIdx.x + p / n_steps * gridDim.x, n_qt, H);
      const int key0 = (p % n_steps >> 1) * TILE;
      const CUtensorMap* map = (p & 1) ? &map_v : &map_k;
      uint64_t* bar = &raw_full[p % RAW_SLOTS];
      unsigned char* dst = raw + p % RAW_SLOTS * RAW_BYTES;
      mbar_arrive_expect_tx(bar, RAW_BYTES);
      tma_load_3d(dst, map, bar, item.h * DH, key0, item.b);
      tma_load_3d(dst + BOX_BYTES, map, bar, item.h * DH + 32, key0, item.b);
    };
    if (sid == 0)
      for (int p = 0; p < RAW_SLOTS && p < total; ++p) load(p);
    for (int p = 0; p < total; ++p) {
      const int rs = p % RAW_SLOTS, ss = p % SPLIT_SLOTS;
      mbar_wait(&raw_full[rs], (p / RAW_SLOTS) & 1);
      mbar_wait(&split_empty[ss], ((p / SPLIT_SLOTS) & 1) ^ 1);
      unsigned char* hi = split + ss * SPLIT_BYTES;
      split_as_stored<SPLIT_THREADS>(raw + rs * RAW_BYTES, hi, hi + PART_BYTES, p & 1, sid);
      fence_proxy_async();  // the parts become visible to the wgmma reads
      mbar_arrive(&split_full[ss]);
      named_barrier(PRODUCER_BAR, SPLIT_THREADS);  // raw slot rs is read
      if (sid == 0 && p + RAW_SLOTS < total) load(p + RAW_SLOTS);
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const Turn turn{wg};
    if (wg == 1) turn.pass();  // warpgroup 0 runs first
    consume(split, split_full, split_empty, turn, q, out, lse, B, Nq, Nk, H, q_row, wg,
            tid & 127);
    if (wg == 0) turn.take();  // warpgroup 1's last pass
  }
}

// a 3-D map over the float32 (B, N, row) view: columns [0, D), N tokens, B images
int view_map(CUtensorMap* map, const void* ptr, int B, int N, int D, int row) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(row) * 4,
                               static_cast<uint64_t>(N) * row * 4};
  const uint32_t box[3] = {32, TILE, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// q: (B*Nq, *) float32 rows with row stride q_row elements, head h at
// columns h*64; k, v: (B*Nk, *) float32 rows with strides k_row, v_row.
// out: (B*Nq, D) float32, D = n_heads * 64. lse: null, or (B, n_heads, Nq)
// float32, each query row's log-sum-exp of its scaled scores. Row strides
// are multiples of 4 and k, v 16-byte aligned (TMA). Requires Nq, Nk >= 1
// (the wrapper asks for >= 8).
LTD_API int ltd_flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                    float* lse, int B, int Nq, int Nk, int n_heads, int q_row,
                                    int k_row, int v_row, void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || n_heads < 1 || q_row % 4 || k_row % 4 || v_row % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = n_heads * DH;
  CUtensorMap map_k, map_v;
  if (int err = view_map(&map_k, k, B, Nk, D, k_row)) return err;
  if (int err = view_map(&map_v, v, B, Nk, D, v_row)) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * n_heads * ((Nq + QT - 1) / QT);
  flash_attention_f32_kernel<<<items < sms ? items : sms, THREADS, SMEM,
                               static_cast<cudaStream_t>(stream)>>>(map_k, map_v, q, out, lse, B,
                                                                    Nq, Nk, n_heads, q_row);
  return static_cast<int>(cudaGetLastError());
}
