// mlp_band_bwd: the middle of the hi-res sep-conv MLP's backward in one
// launch: from x, the upstream gradient g and the weights, the bf16 GELU
// output a (for dW2 = g^T a), the bf16 input gradient dh of the expanded
// hidden state (for dW1 = dh^T x and dx = dh W1), and the float32 sums of
// the 9 tap gradients, ddwb and db1.
//
// Replaces, with gemm_bwd.cu's weight_grad (dW2, dW1) and colsum (db2)
// and ln_gemm.cu's dx product around it, TPU kernel K5's backward:
// transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py::_bwd_kernel
// (:135-179, pallas_call `_pallas_bwd` :212), whose middle (:150-173)
// keeps h, c, a, da, dc and dh of one image in VMEM. The port's first
// design wrote the float32 h, c and da to device memory (0.8 GB each at
// batch 64, hw = 32) and read them back, ~8.3 GB a call in all.
//
// What it computes, per (image, 128 tokens, 128 channels), in the TPU
// kernel's rounding points:
// - h = x W1c^T + b1 (the forward recomputed) and da = g W2c (W2 (D, C)
//   read as stored, the MN-major operand), two K = D products of bf16
//   operands into float32 accumulators;
// - c = dw3x3(h) + dwb in float32 (the forward's sum order), a = GELU(c)
//   rounded to bf16 and written; dc = da GELU'(c) (Phi(c) + c phi(c),
//   `erff` and one MUFU.EX2), float32, kept on chip;
// - dh = the correlation of dc with the flipped taps (`_dw_input_grad`,
//   :95; the same order), rounded to bf16 once and written;
// - the tap gradients sum_p h[p + (di-1, dj-1)] dc[p] (`_dw_tap_grads`,
//   :100), ddwb = sum dc and db1 = sum dh before its rounding, float32.
//
// What bounds it on the H100: the two products, 4 M D C operations (0.62 ms
// at batch 64, hw = 32, D = 768, C = 3072), against x and g in and a and dh
// out (1.0 GB, 0.30 ms). The two walks issue ~90 instructions an element.
//
// What this design does about that (mlp_band.cuh: the tiling, the ring,
// the staging, the walks):
// - A producer warpgroup streams x with W1's chunk, then g with W2's chunk
//   (24 K steps at D = 768) through one 3-stage ring. The two other
//   warpgroups stage h + b1 in its own float32 tile as soon as the first
//   product is done (while the second one's operands arrive), then da into
//   the idle ring.
// - Cluster barrier 1: every tile's h is staged. Walk 1 takes c over the
//   h halo (the neighbours' tiles through distributed shared memory),
//   writes a, and turns the block's own da into dc in place.
// - Cluster barrier 2: every dc is staged. Walk 2 takes dh over the dc
//   halo, and each thread sums its pixels' 11 products (h from the h halo
//   times the centre dc) in walk order, in registers.
// - Sums without atomics, in a fixed order: the 8 walk warps' sums added
//   in warp order (through shared memory); after cluster barrier 3, rank 0
//   adds the cluster's tiles in rank order (distributed shared memory) into
//   the image's workspace row (image-major, (B, 11, C)); the rank 0 that
//   finds itself last of its channel chunk (a counter taken after a fence,
//   as csrc/dwconv_gelu_bwd.cu) adds the B rows in image order into the
//   (11, C) sums and sets the counter back to zero. So one launch gives
//   them, bit-equal from launch to launch.
// - Cluster barrier 4 keeps each block's tiles alive until the last read.
// - Budget: shared memory 1 KB alignment + the 96 KB ring (da, then dc,
//   inside it) + the 68 KB h tile + 44 KB for the warps' sums + 5.5 KB for
//   the block's + the zero row = 216 KB: one block of 384 threads an SM,
//   168 registers a thread (64 accumulators a product; walk 2 holds 36
//   taps, 44 sums and the sliding windows: dh sums, h columns, the centre
//   dc).
// - Measured on an H100 (PERF.md; scripts/band_phases.py stamps
//   each block's phases): a block's products take about as long as its
//   two walks, one after the other. A persistent cluster (no gaps while a
//   new cluster waits for 8 free SMs) and the producer warpgroup walking
//   too (12 warps, no `setmaxnreg`) both spilled and ran slower.
// Nothing of h, c, da or dc reaches device memory: it sees x, g, the
// weights, a, dh and the 11 sums' partial rows.

#include "mlp_band.cuh"

namespace {

using namespace band;

constexpr int THREADS = GROUP + 128;  // + the producer warpgroup
// one block an SM: 384 threads of 168 registers at launch; the producer
// warpgroup hands its registers to the others
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

constexpr int NSUM = 11;  // 9 taps, ddwb, db1
constexpr int RED_BYTES = WARPS * NSUM * NC * 4;
constexpr int PART_BYTES = NSUM * NC * 4;
// the ring (da, then dc, inside it), h, the warps' and the block's sums,
// the zero row, the barriers, a flag
constexpr int SMEM = 1024 + RING_BYTES + STAGED_BYTES + RED_BYTES + PART_BYTES + ZERO_BYTES +
                     2 * STAGES * 8 + 16;
constexpr int V4 = NSUM * NC / 4;  // float4 columns of a chunk's sums
constexpr int IN_FLIGHT = 16;      // workspace rows a thread loads at once

// GELU'(c) = Phi(c) + c phi(c) and GELU(c) = c Phi(c): the exact erf;
// exp(-c^2 / 2) as one MUFU.EX2. c Phi(c) rounds as the forward's GELU.
__device__ __forceinline__ void gelu_and_grad(float c, float& act, float& grad) {
  const float cdf = 0.5f * (1.f + erff(c * 0.70710678118654752f));
  const float pdf = exp2_approx(c * c * -0.72134752044448170f) * 0.39894228040143268f;
  act = c * cdf;
  grad = cdf + c * pdf;
}

// block (rank, chunk, image), as mlp_band_fwd_kernel; images = B
__global__ void __launch_bounds__(THREADS, 1)
mlp_band_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_w2, const float* __restrict__ b1,
                    const bf16* __restrict__ dw, const float* __restrict__ dwb,
                    bf16* __restrict__ a_out, bf16* __restrict__ dh_out, float* __restrict__ ws,
                    float* __restrict__ sums, int* __restrict__ counters, int hw, int C, int nk,
                    int images) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* dct = reinterpret_cast<float*>(smem);  // da, then dc, staged in the idle ring
  float* ht = reinterpret_cast<float*>(smem + RING_BYTES);
  float* red = reinterpret_cast<float*>(smem + RING_BYTES + STAGED_BYTES);  // [warp][NSUM][NC]
  float* part = red + WARPS * NSUM * NC;                                     // [NSUM][NC]
  float* zero_row = part + NSUM * NC;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero_row + NC);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tiles = gridDim.x;  // one cluster spans the grid's x
  const int tid = threadIdx.x;
  const int n = hw * hw;
  const int chunk = blockIdx.y, c0 = chunk * NC, b = blockIdx.z;
  const int t0 = rank * TILE, t1 = min(t0 + TILE, n);
  Ring<true> ring{smem, full, empty, &map_x, &map_w1, &map_g, &map_w2, true, b * n + t0, c0,
                  nk, 2 * nk};
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  if (tid < NC / 4) reinterpret_cast<float4*>(zero_row)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (tid >= GROUP) {
    // the producer warpgroup: its branch ends with the kernel, and its
    // registers go to the others
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == GROUP) ring.top_up(ring.total);
    __syncwarp();
    for (int i = 0; i < 4; ++i) cluster.sync();  // the four barriers of the others' branch
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = tid >> 7, wt = tid & 127;
  {
    float acc[64];
    ring.product<false>(acc, wg, wt, tid);  // h = x W1c^T
    stage_acc(ht, acc, b1, c0, wg, wt);
    ring.product<true>(acc, wg, wt, tid);  // da = g W2c
    named_barrier(1, GROUP);  // both warpgroups are done with the ring
    stage_acc(dct, acc, nullptr, c0, wg, wt);
  }
  cluster.sync();  // 1: every tile's h is staged, and this block's da

  const int warp = tid >> 5, lane = tid & 31;
  const int c = c0 + 4 * lane;
  const Runs runs(t0, t1, hw);
  const size_t img = static_cast<size_t>(b) * n;
  const Staged h = staged(ht, zero_row, rank, tiles);
  {
    // walk 1: c = dw3x3(h) + dwb, a = GELU(c) out, da -> dc in place
    float w[9][4];
#pragma unroll
    for (int t = 0; t < 9; ++t) load_taps(w[t], dw, t, C, c);
    float bias[4];
    to4(bias, *reinterpret_cast<const float4*>(dwb + c));
    for (int it = warp; it < runs.items(); it += WARPS) {
      int i, j0, j1;
      if (!runs.item(it, i, j0, j1)) continue;
      const Run r = make_run(h, i, j0, j1, hw, lane);
      auto walk = [&](auto one) {
        constexpr bool ONE = decltype(one)::value;
        float z0a[4] = {}, z0b[4] = {}, z1b[4] = {};
#pragma unroll
        for (int cc = 0; cc < TSEG + 2; ++cc) {
          if (j0 - 1 + cc > j1) break;
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
          if (cc >= 2) {  // pixel (i, j0 + cc - 2), token s of this tile
            const int s = i * hw + j0 + cc - 2 - t0;
            float4* dp = reinterpret_cast<float4*>(dct + s * HS + 4 * lane);
            float da[4], act[4], dc[4];
            to4(da, *dp);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float grad;
              gelu_and_grad((z0a[e] + z1b[e] + z[2][e]) + bias[e], act[e], grad);
              dc[e] = da[e] * grad;
            }
            *dp = make_float4(dc[0], dc[1], dc[2], dc[3]);
            store_bf16x4(a_out + (img + t0 + s) * C + c, act);
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
  }
  cluster.sync();  // 2: every tile's dc is staged

  {
    // walk 2: dh = the flipped-tap correlation of dc, out in bf16; the 11 sums
    const Staged d = staged(dct, zero_row, rank, tiles);
    float w[9][4];  // flipped: w[t] is tap 8 - t
#pragma unroll
    for (int t = 0; t < 9; ++t) load_taps(w[t], dw, 8 - t, C, c);
    float acc[NSUM][4];
#pragma unroll
    for (int q = 0; q < NSUM; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    for (int it = warp; it < runs.items(); it += WARPS) {
      int i, j0, j1;
      if (!runs.item(it, i, j0, j1)) continue;
      // the same rows of h and dc: the same offsets in other buffers
      const Run rd = make_run(d, i, j0, j1, hw, lane);
      const Run rh = make_run(h, i, j0, j1, hw, lane);
      auto walk = [&](auto one) {
        constexpr bool ONE = decltype(one)::value;
        // z0 two and one columns back, z1 one back; the h window's columns
        // two and one back (rows i - 1 .. i + 1); the centre dc one back
        float z0a[4] = {}, z0b[4] = {}, z1b[4] = {};
        float ha[3][4] = {}, hb[3][4] = {}, dcc[4] = {};
#pragma unroll
        for (int cc = 0; cc < TSEG + 2; ++cc) {
          if (j0 - 1 + cc > j1) break;
          float z[3][4] = {}, hn[3][4], mid[4];
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            float v[4];
            to4(v, load<ONE>(d, rd, di, cc, hw, lane));
            to4(hn[di], load<ONE>(h, rh, di, cc, hw, lane));
#pragma unroll
            for (int dj = 0; dj < 3; ++dj)
#pragma unroll
              for (int e = 0; e < 4; ++e) z[dj][e] += v[e] * w[di * 3 + dj][e];
            if (di == 1)
#pragma unroll
              for (int e = 0; e < 4; ++e) mid[e] = v[e];
          }
          if (cc >= 2) {  // pixel (i, j0 + cc - 2): its dc is the centre one column back
            float g[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              g[e] = (z0a[e] + z1b[e]) + z[2][e];
#pragma unroll
              for (int di = 0; di < 3; ++di) {
                acc[di * 3][e] += ha[di][e] * dcc[e];
                acc[di * 3 + 1][e] += hb[di][e] * dcc[e];
                acc[di * 3 + 2][e] += hn[di][e] * dcc[e];
              }
              acc[9][e] += dcc[e];
              acc[10][e] += g[e];
            }
            store_bf16x4(dh_out + (img + i * hw + j0 + cc - 2) * C + c, g);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            z0a[e] = z0b[e];
            z0b[e] = z[0][e];
            z1b[e] = z[1][e];
            dcc[e] = mid[e];
#pragma unroll
            for (int di = 0; di < 3; ++di) {
              ha[di][e] = hb[di][e];
              hb[di][e] = hn[di][e];
            }
          }
        }
      };
      if (rd.one_tile)
        walk(std::true_type{});
      else
        walk(std::false_type{});
    }
    // the block's sums: each warp's, then the warps' in warp order
#pragma unroll
    for (int q = 0; q < NSUM; ++q)
      *reinterpret_cast<float4*>(red + (warp * NSUM + q) * NC + 4 * lane) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    named_barrier(1, GROUP);
    for (int o = tid; o < NSUM * NC; o += GROUP) {
      float t = red[o];
#pragma unroll
      for (int wp = 1; wp < WARPS; ++wp) t += red[wp * NSUM * NC + o];
      part[o] = t;
    }
  }
  cluster.sync();  // 3: every tile's sums are in its `part`

  if (rank == 0) {
    // the cluster's tiles in rank order into the image's workspace row
    for (int o = tid; o < NSUM * NC; o += GROUP) {
      float t = part[o];
      for (int r = 1; r < tiles; ++r) t += ld_cluster_f32(cluster_addr(part + o, r));
      ws[(static_cast<size_t>(b) * NSUM + o / NC) * C + c0 + o % NC] = t;
    }
    named_barrier(1, GROUP);
    if (tid == 0) {  // release: the rows' stores, then the count
      __threadfence();
      *last = atomicAdd(&counters[chunk], 1) == images - 1;
    }
    named_barrier(1, GROUP);
    if (*last) {
      // the last image of this chunk: the B rows in image order
      __threadfence();
      const size_t stride = static_cast<size_t>(NSUM) * C / 4;  // float4s between rows
      for (int v = tid; v < V4; v += GROUP) {
        const float4* col =
            reinterpret_cast<const float4*>(ws + (v * 4 / NC) * C + c0 + (v * 4) % NC);
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        int r = 0;
        for (; r + IN_FLIGHT <= images; r += IN_FLIGHT) {
          float4 l[IN_FLIGHT];
#pragma unroll
          for (int q = 0; q < IN_FLIGHT; ++q) l[q] = __ldcg(col + (r + q) * stride);
#pragma unroll
          for (int q = 0; q < IN_FLIGHT; ++q) t.x += l[q].x, t.y += l[q].y, t.z += l[q].z, t.w += l[q].w;
        }
        for (; r < images; ++r) {
          const float4 l = __ldcg(col + r * stride);
          t.x += l.x, t.y += l.y, t.z += l.z, t.w += l.w;
        }
        *reinterpret_cast<float4*>(sums + (v * 4 / NC) * C + c0 + (v * 4) % NC) = t;
      }
      if (tid == 0) counters[chunk] = 0;  // as the next launch expects it
    }
  }
  cluster.sync();  // 4: the neighbours are done reading this block's tiles
}

}  // namespace

// x, g: (B*hw*hw, D) bf16 token rows of B row-major hw x hw grids (g the
// gradient of the MLP's output); w1: (C, D) bf16; w2: (D, C) bf16; b1,
// dwb: (C,) float32; dw: (9, C) bf16 taps, tap di*3+dj. Out: a, dh
// (B*hw*hw, C) bf16; sums (11, C) float32: the 9 tap gradients, ddwb,
// db1. ws: (B, 11, C) float32 workspace; counters: C / 128 int32, zero,
// and left zero. Requires 1 <= hw <= 32, D % 64 == 0, C % 128 == 0 and
// 16-byte aligned x, g, w1 and w2 (TMA).
LTD_API int ltd_mlp_band_bwd(const void* x, const void* g, const void* w1, const float* b1,
                             const void* dw, const float* dwb, const void* w2, void* a, void* dh,
                             float* ws, float* sums, int* counters, int B, int hw, int D, int C,
                             void* stream) {
  const int tiles = tiles_of(hw);
  if (B < 1 || tiles == 0 || D < 64 || D % 64 || C < NC || C % NC)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_g, map_w1, map_w2;
  int err = encode_bf16_2d(&map_x, x, D, B * hw * hw);
  if (!err) err = encode_bf16_2d(&map_g, g, D, B * hw * hw);
  if (!err) err = encode_bf16_2d(&map_w1, w1, D, C);
  if (!err) err = encode_bf16_2d(&map_w2, w2, C, D);
  if (err) return err;
  int nk = D / BK;
  void* args[] = {&map_x, &map_g, &map_w1, &map_w2, &b1, &dw, &dwb, &a, &dh, &ws, &sums,
                  &counters, &hw, &C, &nk, &B};
  return launch(reinterpret_cast<const void*>(mlp_band_bwd_kernel), THREADS,
                dim3(tiles, C / NC, B), tiles, SMEM, static_cast<cudaStream_t>(stream), args);
}
