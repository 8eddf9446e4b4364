// The transposed 128 x 32 float32 tiles of gemm_bwd_f32.cu's weight_grad_f32.
//
// The 32-bit `wgmma` forms take K-major operands only. A B operand stored
// N-major (X (M, K) of dW = dY^T X, whose reduction runs over the rows)
// lands by TMA as stored: one unswizzled box of 32 rows
// of K (the reduction) x 128 floats of N, 16 KB, in a raw slot. The
// producer warpgroup's three splitter warps then write it transposed into
// its two TF32 parts (hopper.cuh's tf32_split: hi = tf32(x), lo = tf32(x -
// hi)), each in the layout a 128-byte swizzled TMA box of a K-major
// operand has: two 64-row boxes of 32 floats, 16-byte chunk c of row r at
// c ^ (r % 8).
#pragma once

#include "hopper.cuh"

namespace f32tile {

constexpr int ROWS = 128;                 // the tile's N (the operand's rows once transposed)
constexpr int DEPTH = 32;                 // its K: one 128-byte swizzled row of float32
constexpr int BOX_BYTES = 64 * 128;       // one 64-row x 32-float swizzled box
constexpr int TILE_BYTES = 2 * BOX_BYTES;  // the raw tile, and each part
constexpr int SPLITTERS = 96;             // warps 1-3 of the producer warpgroup

// Splitter sid's share of the raw tile raw[k][n] (DEPTH rows of ROWS floats,
// as stored) into the K-major parts hi and lo: each 16-byte chunk of 4
// values of k gathered from 4 rows of the raw tile, consecutive threads on
// consecutive n (no bank conflict on the reads; the writes' chunks are
// swizzled across the banks).
__device__ __forceinline__ void split_transposed(const float* raw, unsigned char* hi,
                                                 unsigned char* lo, int sid) {
  for (int i = sid; i < TILE_BYTES / 16; i += SPLITTERS) {
    const int n = i & (ROWS - 1), c = i / ROWS;
    const int rr = n & 63;
    const int off = (n >> 6) * BOX_BYTES + rr * 128 + ((c ^ (rr & 7)) << 4);
    uint4 h, l;
    tf32_split(raw[(4 * c) * ROWS + n], h.x, l.x);
    tf32_split(raw[(4 * c + 1) * ROWS + n], h.y, l.y);
    tf32_split(raw[(4 * c + 2) * ROWS + n], h.z, l.z);
    tf32_split(raw[(4 * c + 3) * ROWS + n], h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// a float32 (rows, cols) row-major map of DEPTH-row x ROWS-column boxes as
// stored (no swizzle): the raw tiles
inline int encode_rows(CUtensorMap* map, const void* ptr, int cols, int rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(cols) * 4};
  const uint32_t box[2] = {ROWS, DEPTH};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, stride, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace f32tile
