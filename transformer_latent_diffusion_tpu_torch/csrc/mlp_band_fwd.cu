// mlp_band_fwd: a = bf16(GELU(3x3 depthwise(x W1^T + b1) + dwb)), the
// expand half of the hi-res sep-conv MLP's forward, in one launch.
//
// Replaces, with ln_gemm.cu's contract product after it, TPU kernel K5's
// forward: transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py::_fwd_kernel
// (:119-129, pallas_call `_pallas_fwd` :186), which keeps one image's
// float32 hidden state h and the convolution's output c in VMEM. A Hopper
// SM holds 227 KB, not one image's 12.6 MB of h (1024 x 3072 float32), so
// the port first wrote h to device memory and read it back (0.8 GB each
// way at batch 64). Here h and c never leave the chip.
//
// What it computes, in the TPU kernel's rounding points: h = x W1^T + b1 in
// float32 (bf16 products, float32 accumulation); c = the 3x3 depthwise
// correlation of h (zero padding) + dwb in float32, summed in the TPU
// kernel's order (row taps per column shift, then the three shifts, as
// dwconv_gelu.cu); a = the exact-erf GELU of c (`erff`), rounded to bf16
// once.
//
// What bounds it on the H100: the expand product, 2 M D C operations
// (0.31 ms at batch 64, hw = 32, D = 768, C = 3072, at 989 TFLOP/s),
// against bytes of x in and a out (0.5 GB, 0.15 ms). Per output element
// the epilogue issues ~45 instructions (taps, `erff`, the GELU, the
// store), which a block cannot overlap with its own products.
//
// What this design does about that (mlp_band.cuh has the tiling, the
// ring and the walks): a block owns (image, 128 tokens, 128 channels); the
// 8 (at hw = 32) tiles of an image and a chunk are one cluster. Its two
// warpgroups multiply the block's x rows by the W1 chunk from a 3-stage
// TMA ring (12 K steps of 64 at D = 768; thread 0 issues the loads
// between its products), stage h + b1 in float32 in the idle ring (128 x
// 136 floats, 68 KB), pass a cluster barrier, and walk their pixels: the
// taps reach into the neighbouring tiles through distributed shared
// memory (one 33-token halo above and below at hw = 32), so no product is
// computed twice and h makes no round trip through device memory. The
// second cluster barrier keeps each block's tile alive until its
// neighbours have read it.
// - Budget: shared memory 1 KB alignment + the 96 KB ring (the staged
//   tile inside it) + the zero row + 6 barriers = 98 KB and 256 threads
//   of at most 128 registers (64 accumulators, then the walk's 36 taps, 12
//   sliding sums and 4 biases), so two blocks fit an SM: one block's
//   walk can run beside the other's products.
// - L2: the grid runs tile, chunk, image from fastest to slowest, so the
//   clusters in flight share one image's x rows and all of W1 (4.7 MB)
//   stays in L2.
// - Measured on an H100 (PERF.md; scripts/band_phases.py stamps
//   each block's phases): a block spends about as long on its products as
//   on its walk, and the two blocks of an SM keep in step, so the two
//   seldom overlap. Three roles in one block (a producer, an MMA
//   warpgroup holding 128 accumulators, walker warpgroups) ran slower: at
//   512 threads a thread has 128 registers, and the MMA warpgroup spilled.
// - Each element of a has one writer: two launches give bit-equal results.

#include "mlp_band.cuh"

namespace {

using namespace band;

constexpr int THREADS = GROUP;
// the ring (the staged h inside it), the zero row, the barriers
constexpr int SMEM = 1024 + RING_BYTES + ZERO_BYTES + 2 * STAGES * 8;

// block (rank, chunk, image): tokens [128 rank, ...) of image blockIdx.z,
// channels [128 blockIdx.y, ...); nk = D / 64 K steps
__global__ void __launch_bounds__(THREADS, 2)
mlp_band_fwd_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w1, const float* __restrict__ b1,
                    const bf16* __restrict__ dw, const float* __restrict__ dwb,
                    bf16* __restrict__ a, int hw, int C, int nk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* tile = reinterpret_cast<float*>(smem);  // h, staged in the idle ring
  float* zero_row = reinterpret_cast<float*>(smem + RING_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_BYTES + ZERO_BYTES);
  uint64_t* empty = full + STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tiles = gridDim.x;  // one cluster spans the grid's x
  const int tid = threadIdx.x;
  const int n = hw * hw;
  const int c0 = blockIdx.y * NC, b = blockIdx.z;
  const int t0 = rank * TILE, t1 = min(t0 + TILE, n);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  if (tid < NC / 4) reinterpret_cast<float4*>(zero_row)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int wg = tid >> 7, wt = tid & 127;
  {
    Ring<false> ring{smem, full, empty, &map_x, &map_w1, &map_x, &map_w1, false, b * n + t0,
                     c0, nk, nk};
    if (tid == 0) ring.top_up(STAGES);
    float acc[64];
    ring.product<false>(acc, wg, wt, tid);
    named_barrier(1, THREADS);  // both warpgroups are done with the ring
    stage_acc(tile, acc, b1, c0, wg, wt);
  }
  cluster.sync();  // every tile of the cluster is staged

  const int warp = tid >> 5, lane = tid & 31;
  const Staged h = staged(tile, zero_row, rank, tiles);
  const int c = c0 + 4 * lane;
  float w[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t) load_taps(w[t], dw, t, C, c);
  float bias[4];
  to4(bias, *reinterpret_cast<const float4*>(dwb + c));
  bf16* out = a + static_cast<size_t>(b) * n * C + c;
  const Runs runs(t0, t1, hw);
  for (int it = warp; it < runs.items(); it += WARPS) {
    int i, j0, j1;
    if (!runs.item(it, i, j0, j1)) continue;
    const Run r = make_run(h, i, j0, j1, hw, lane);
    auto walk = [&](auto one) {
      constexpr bool ONE = decltype(one)::value;
      // z0 two and one columns back, z1 one back
      float z0a[4] = {}, z0b[4] = {}, z1b[4] = {};
      // unrolled, so the window slides by renaming registers
#pragma unroll
      for (int cc = 0; cc < TSEG + 2; ++cc) {
        if (j0 - 1 + cc > j1) break;  // grid columns j0 - 1 .. j1
        float z[3][4] = {};
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          float v[4];
          to4(v, load<ONE>(h, r, di, cc, hw, lane));
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int e = 0; e < 4; ++e) z[dj][e] += v[e] * w[di * 3 + dj][e];
        }
        if (cc >= 2) {  // pixel (i, j0 + cc - 2)
          float g[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) g[e] = gelu((z0a[e] + z1b[e] + z[2][e]) + bias[e]);
          store_bf16x4(out + static_cast<size_t>(i * hw + j0 + cc - 2) * C, g);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          z0a[e] = z0b[e];
          z0b[e] = z[0][e];
          z1b[e] = z[1][e];
        }
      }
    };
    if (r.one_tile)
      walk(std::true_type{});
    else
      walk(std::false_type{});
  }
  cluster.sync();  // the neighbours are done reading this block's tile
}

}  // namespace

// x: (B*hw*hw, D) bf16 token rows of B row-major hw x hw grids; w1: (C, D)
// bf16; b1, dwb: (C,) float32; dw: (9, C) bf16 taps, tap di*3+dj; a:
// (B*hw*hw, C) bf16 out. Requires 1 <= hw <= 32, D % 64 == 0, C % 128 ==
// 0 and 16-byte aligned x and w1 (TMA).
LTD_API int ltd_mlp_band_fwd(const void* x, const void* w1, const float* b1, const void* dw,
                             const float* dwb, void* a, int B, int hw, int D, int C,
                             void* stream) {
  const int tiles = tiles_of(hw);
  if (B < 1 || tiles == 0 || D < 64 || D % 64 || C < NC || C % NC)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w1;
  int err = encode_bf16_2d(&map_x, x, D, B * hw * hw);
  if (!err) err = encode_bf16_2d(&map_w1, w1, D, C);
  if (err) return err;
  int nk = D / BK;
  void* args[] = {&map_x, &map_w1, &b1, &dw, &dwb, &a, &hw, &C, &nk};
  return launch(reinterpret_cast<const void*>(mlp_band_fwd_kernel), THREADS,
                dim3(tiles, C / NC, B), tiles, SMEM, static_cast<cudaStream_t>(stream), args);
}
