// The key/value chunks of the float32 attention bodies (self_attention_f32.cu,
// flash_attention_f32.cu; in flash_attention_bwd_f32.cu also the query and
// gradient chunks) and the 3xTF32 products over them.
//
// A chunk is 64 keys x 64 head columns of float32, loaded by TMA as two
// 64-row x 32-column boxes in the 128-byte swizzle (a "raw" chunk). The
// producer warps split it into its TF32 parts (hopper.cuh: hi = tf32(x),
// lo = tf32(x - hi)), each part the same two-box layout:
// - K as it is: keys are the rows of Q K^T's B operand, the head columns
//   its K;
// - V transposed, since the 32-bit `wgmma` forms take K-major operands only
//   and the keys are P V's K. A chunk's keys are written in the order 0, 2,
//   4, 6, 1, 3, 5, 7 of each 8: that is the order in which a thread's score
//   accumulators (columns 2 (t % 4) and + 1 of each 8) fall into the TF32 A
//   fragment (columns t % 4 and + 4), so P feeds P V from the registers
//   that hold it, with no shuffle.
#pragma once

#include "hopper.cuh"

namespace f32chunk {

constexpr int DH = 64;                       // head dim
constexpr int TILE = 64;                     // keys of a chunk, queries of a warpgroup
constexpr int BOX_BYTES = TILE * 128;        // 64 rows x 32 float32, 128-byte swizzled
constexpr int RAW_BYTES = 2 * BOX_BYTES;     // a chunk of K or V as it is loaded
constexpr int PART_BYTES = 2 * BOX_BYTES;    // one TF32 part of a split chunk
constexpr int SPLIT_BYTES = 2 * PART_BYTES;  // its hi and lo parts
constexpr int SPLITTERS = 96;                // warps 1-3 of the producer warpgroup

// byte offset of element (row, col) of a 64 x 64 float32 chunk held as two
// 64-row x 32-column boxes in the 128-byte swizzle (16-byte chunk c of row r
// at c ^ (r % 8))
__device__ __forceinline__ int sw_off(int row, int col) {
  return (col >> 5) * BOX_BYTES + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// the B-operand descriptor of K step kk (columns 8 kk ..) of a split chunk's part
__device__ __forceinline__ uint64_t part_desc(const unsigned char* part, int kk) {
  return sw128_desc(part + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024);
}

// x's TF32 parts: tf32_split's, or (FAST) tf32_split_fast's
template <bool FAST>
__device__ __forceinline__ void split_parts(float x, uint32_t& hi, uint32_t& lo) {
  if (FAST) {
    tf32_split_fast(x, hi, lo);
  } else {
    tf32_split(x, hi, lo);
  }
}

// Splitter `sid` (0..SPLITTERS-1) of the producer warps: its share of the
// raw chunk `src` into the parts hi and lo, K as it is or (is_v) V^T; FAST:
// the parts by tf32_split_fast (flash_attention_bwd_f32.cu).
template <bool FAST = false>
__device__ __forceinline__ void split_chunk(const unsigned char* src, unsigned char* hi,
                                            unsigned char* lo, bool is_v, int sid) {
  if (!is_v) {
    // K: the same layout, element by element
    for (int e = sid; e < RAW_BYTES / 16; e += SPLITTERS) {
      const float4 v = reinterpret_cast<const float4*>(src)[e];
      uint32_t h[4], l[4];
      split_parts<FAST>(v.x, h[0], l[0]);
      split_parts<FAST>(v.y, h[1], l[1]);
      split_parts<FAST>(v.z, h[2], l[2]);
      split_parts<FAST>(v.w, h[3], l[3]);
      reinterpret_cast<uint4*>(hi)[e] = make_uint4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<uint4*>(lo)[e] = make_uint4(l[0], l[1], l[2], l[3]);
    }
    return;
  }
  // V^T: a unit is 4 keys of one parity of an 8-key block (k = 8 kg + 2 i +
  // h, i = 0..3: slots 8 kg + 4 h + i, 16 contiguous bytes of a V^T row) x 2
  // head columns 4 dq + 2 e ..: four 8-byte reads, the 4 x 2 transposed, four
  // 16-byte writes (a 4 x 4 block would not fit the producer's 40
  // registers). A warp's lanes take dq % 8, h and e, so its reads hit each
  // bank twice for 256 bytes and its writes each bank group 4 times for 512:
  // no conflict beyond the minimum.
  for (int u = sid; u < 512; u += SPLITTERS) {
    const int l = u & 31, w = u >> 5;
    const int dq = (l & 7) | ((w & 1) << 3), h = (l >> 3) & 1, e = (l >> 4) & 1;
    const int kg = w >> 1, c = 4 * dq + 2 * e;
    float2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const float2*>(src + sw_off(8 * kg + 2 * i + h, c));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4 hv, lv;
      split_parts<FAST>(j ? v[0].y : v[0].x, hv.x, lv.x);
      split_parts<FAST>(j ? v[1].y : v[1].x, hv.y, lv.y);
      split_parts<FAST>(j ? v[2].y : v[2].x, hv.z, lv.z);
      split_parts<FAST>(j ? v[3].y : v[3].x, hv.w, lv.w);
      const int off = sw_off(c + j, 8 * kg + 4 * h);
      *reinterpret_cast<uint4*>(hi + off) = hv;
      *reinterpret_cast<uint4*>(lo + off) = lv;
    }
  }
}

// 8 TF32 steps of one 64-key chunk into a 64 x 64 product: d = A B, A's
// fragments made by frag(kk, x) (the 4 floats of step kk, split here), B
// the chunk's parts hi and lo, the small terms first (lo B_hi, hi B_lo,
// hi B_hi). The first product ignores d's old values; WRITE_ONLY: it does
// not take them as an input either (wgmma_m64n64k8_tf32_rs_first): the
// per-step variant of flash_attention_f32's P V in
// scripts/flash_attention_f32_ab.py takes that form; in self_attention_f32's
// 4-chunk body it cost a 4-byte spill, so that kernel keeps the read-write
// one.
// The fragments are double-buffered; returns with every product done.
template <bool WRITE_ONLY = false, typename Frag>
__device__ __forceinline__ void chunk_products(float (&d)[32], const unsigned char* hi,
                                               const unsigned char* lo, Frag frag) {
  uint32_t fh[2][4], fl[2][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int b = kk & 1;
    float x[4];
    frag(kk, x);
    tf32_frag(x, fh[b], fl[b]);
    wgmma_fence();
    const uint64_t dh = part_desc(hi, kk), dl = part_desc(lo, kk);
    if (WRITE_ONLY && kk == 0) {
      wgmma_m64n64k8_tf32_rs_first(d, fl[b], dh);
    } else {
      wgmma_m64n64k8_tf32_rs(d, fl[b], dh, kk > 0);
    }
    wgmma_m64n64k8_tf32_rs(d, fh[b], dl, 1);
    wgmma_m64n64k8_tf32_rs(d, fh[b], dh, 1);
    wgmma_commit();
    // the previous step's products are done: its fragments may be rewritten
    if (kk == 7) {
      wgmma_wait<0>();
    } else if (kk > 0) {
      wgmma_wait<1>();
    }
  }
  fence_regs(d);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    fence_regs(fh[b]);
    fence_regs(fl[b]);
  }
}

}  // namespace f32chunk
