// ln_gemm_f32: C = LN?(A) @ W^T at float32 accuracy on the tensor cores (3xTF32
// wgmma), with a bias / residual epilogue: the float32 form of ln_gemm.cu.
//
// Replaces the five matrix products of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (and the conditioning K/V product of
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel)
// when the compute dtype (`mxu`, the weights' dtype) is float32, the JAX
// package's default configuration: LN1 -> QKV, LN2 -> Q, the conditioning
// K/V, expand + b1 (from the float32 LN3 rows) and contract + b2 added into
// the residual. The TPU kernel's `_mm` takes float32 operands and
// accumulates in float32 (fused_block.py:65-78).
//
// What bounds it on the H100: operations. Hopper's tensor cores take
// float32 only as TF32 (a 10-bit mantissa), so each product runs as three
// TF32 products of the operands' parts (hopper.cuh: x = hi + lo, a b =
// a_lo b_hi + a_hi b_lo + a_hi b_hi): 495 TFLOP/s dense TF32 at 700 W is
// 165 TFLOP/s of float32-accurate work, against 67 for FFMA on the CUDA
// cores. At M = 16384 rows the five products do 232 GFLOP a layer (1.41 ms
// at that rate) against ~0.9 GB they must move (0.26 ms).
//
// What this design does about that. A 128 x 128 output tile, K in steps of
// 32 (one 128-byte swizzled row of float32):
// - The producer warpgroup: one thread issues TMA loads
//   (`cp.async.bulk.tensor`, 64-row x 32-float boxes, 128-byte swizzle) of
//   A's 128 x 32 and W's 128 x 32, both K-major as stored (the only layout
//   the 32-bit wgmma forms take), into a ring of four 48 KB stages with
//   full and empty `mbarrier`s. Its three other warps split each W tile in
//   shared memory as it lands: hi in place, lo into the stage's third 16 KB,
//   then a proxy fence and a `split` barrier release the stage. W is split
//   here, per call, and not once at packing: the split costs these warps
//   ~11 float4 a thread per stage while the tensor cores run ~1400 cycles
//   on it, no copy of the weights is kept (the packed hi/lo parts of the
//   float32 flagship would add ~0.4 GB), every caller's raw W (the card
//   tests, K7's conditioning K/V) takes the same route, and a captured
//   sampler graph has no split copy to rebuild when a parameter moves.
// - Two consumer warpgroups (`setmaxnreg`: 232 registers, the producer's
//   40) each take 64 rows of the tile. A thread reads its A fragment (4
//   floats per 8-wide K step) from the swizzled stage, normalises it in
//   LayerNorm mode, splits it in registers and issues `wgmma`
//   m64n128k8.tf32 with A from registers three times per step, the small
//   terms first: lo W_hi, hi W_lo, hi W_hi. The fragments are double-
//   buffered and a step's products are waited for before its buffer is
//   rewritten, so no instruction writes a register of a pending `wgmma`.
// - Float32 sums: tensor cores may add each product into the accumulator
//   with truncation (NVIDIA's up to the A100 do), which over K = 3072 (1152
//   adds) would bias the sum by ~3e-5 relative. So each 32-wide K step's
//   12 products go into a fresh 64 x 128 partial (scale_d = 0 on its
//   first), which is then added into the tile's float32 sum with ordinary
//   rounding (64 FADD a thread): the error stays at float32's (~3e-7;
//   tests/test_torch_port_tf32_split.py emulates both).
// - The training layer's float32 forms (TPU kernel K2,
//   transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
//   with float32 weights) add two modes, which run as a second kernel,
//   `ln_gemm_f32_parts_kernel`, on W given as its TF32 parts. `xn` (the
//   recompute's LN1 -> QKV and LN2 -> Q, which also return the float32
//   normalised rows the dW products read): a row pass (`ln_rows_kernel`,
//   one warp a row, the statistics as `row_stats` takes them, then each row
//   normalised and written once, float4 stores) writes xn, and the product
//   runs on xn as a plain A operand. W transposed (the input-gradient
//   products dX = dY W, W stored (out, in) = (K, N) of this product): the
//   32-bit `wgmma` forms take K-major operands only. In both modes a
//   pre-pass (`split_w_kernel`, 32 x 32 tiles through shared memory when
//   transposing) first writes W's, or W^T's, hi and lo parts (hopper.cuh's
//   tf32_split) as two (N, K) row-major arrays in a scratch of 2 |W|, which
//   the product takes by TMA with the 128-byte swizzle as it takes A: a
//   ring of four 48 KB stages (A, W_hi, W_lo), no splitter warp. The
//   scratch is allocated and freed on the call's stream inside the call
//   (`cudaMallocAsync` / `cudaFreeAsync`, stream-ordered, so a captured
//   graph holds it as an allocation node; the default pool keeps its
//   memory mapped between calls): no split copy of the weights outlives
//   the call, and training's changing weights need no rebuild. At
//   M = 32768 the row pass moves ~200 MB (~60 us) and the split 3 |W| (~9
//   us at 3072 x 768) against ~1 ms of products. The two consumer
//   warpgroups take the tensor cores in turns (hopper.cuh's Turn): each
//   reads and splits its four A fragments of a stage first (tf32_frag_int:
//   cvt.rna's bits in half its instructions), issues the stage's 12
//   `wgmma` in its turn, passes the turn, and then waits for them and adds
//   the fresh partial into its tile sum while the other warpgroup's 12
//   run, so the float32 flush is off the tensor cores' path. The parts, the
//   products and the order of the flushes are those of the forward modes'
//   loop, so the modes' results are theirs bit for bit. At the 256 px
//   training layer the dX products reach ~73-77% of their 3xTF32 bound and
//   the LayerNorm products with rows ~61-65% (the row pass ~0.09 ms a call
//   of it). What holds them is on the SM, not L2: a copy that skips W_lo's
//   loads is no faster, one without any product takes ~2/3 of the time
//   (scripts/ln_gemm_f32_ab.py --variants).
// - A persistent grid (one block per SM) walks the work: whole output tiles
//   with the column tile fastest, so the SMs that run at once share each A
//   row block in L2 and all of W (at most 9.4 MB; its parts 18.9 MB)
//   stays there.
// - LayerNorm mode (A the float32 residual): a unit of work is a row block
//   and its run of column tiles (split over more units when there are
//   fewer row blocks than SMs). Each consumer warp first takes the float32
//   statistics of its 16 rows (the mean, then the mean of squared
//   deviations, eps 1e-5: the plain version's two passes, four rows in
//   flight, from L2 after the first) and keeps those of its lanes' two rows
//   in registers; each A element is then normalised as it is read,
//   ((x - mean) * rstd) * scale + shift, the plain version's order. Any K.
// - The epilogue runs from the accumulators through shared memory: acc +
//   bias is staged in a 16 KB buffer per warpgroup in the output map's
//   128-byte swizzle and leaves by TMA, a store (float32 out) or a
//   reduce-add into the float32 residual (`cp.reduce.async.bulk.tensor
//   .add`: x + (acc + bias), the TPU kernel's order), in passes of 64
//   columns; rows past M and columns past N are clipped by the map, and K
//   past a multiple of 32 arrives as zeros. Each element has one writer and
//   its products are summed in one fixed order, so two launches give
//   bit-equal results.

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                 // output tile rows: two warpgroups of 64
constexpr int BN = 128;                 // output tile columns
constexpr int BK = 32;                  // K per stage: one 128-byte swizzled row of float32
constexpr int BOX_BYTES = 64 * 128;     // one 64-row x 32-float TMA box
constexpr int A_BYTES = 2 * BOX_BYTES;  // A's 128 x 32 of a stage
constexpr int W_BYTES = 2 * BOX_BYTES;  // W's 128 x 32: its hi part
constexpr int STAGE_BYTES = A_BYTES + 2 * W_BYTES;  // + W's lo part
constexpr int STAGES = 4;
constexpr int OUT_BYTES = 2 * BOX_BYTES;  // a warpgroup's output staging: 64 rows x 64 columns
constexpr int OUT_COLS = 64;
constexpr int CONSUMERS = 2;
constexpr int SPLITTERS = 96;  // warps 1-3 of the producer warpgroup
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + 3 * STAGES * 8;
constexpr float LN_EPS = 1e-5f;
constexpr int ROWS_PER_BLOCK = 8;  // the row pass: one warp a row
constexpr int SPLIT_TILE = 32;     // the split pre-pass: 32 x 32 tiles, 32 x 8 threads

// The float32 statistics of rows row0 .. row0 + 15 (a warp's): the mean,
// then the mean of squared deviations (eps 1e-5), four rows in flight;
// lane l keeps those of rows row0 + l / 4 (index 0) and + 8 (index 1).
// Rows past M get zeros (their outputs are never stored).
__device__ __forceinline__ void row_stats(const float* __restrict__ a, int row0, int M, int K,
                                          int lane, float (&mean)[2], float (&rstd)[2]) {
  const int chunks = K / 4;
  const int g = lane >> 2;
#pragma unroll
  for (int r0 = 0; r0 < 16; r0 += 4) {
    const float4* p[4];
    bool in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      in[i] = row0 + r0 + i < M;
      p[i] = reinterpret_cast<const float4*>(a + static_cast<size_t>(in[i] ? row0 + r0 + i : 0) * K);
    }
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < chunks; c += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = p[i][c];
        s[i] += (v.x + v.y) + (v.z + v.w);
      }
    }
    float mu[4], q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) mu[i] = warp_sum(s[i]) / K;
    for (int c = lane; c < chunks; c += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = p[i][c];
        const float d0 = v.x - mu[i], d1 = v.y - mu[i], d2 = v.z - mu[i], d3 = v.w - mu[i];
        q[i] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float rs = rsqrtf(warp_sum(q[i]) / K + LN_EPS);
      const int r = r0 + i;
      if ((r & 7) == g) {
        mean[r >> 3] = in[i] ? mu[i] : 0.f;
        rstd[r >> 3] = in[i] ? rs : 0.f;
      }
    }
  }
}

// The persistent walk: unit u is row block u / splits and the column tiles
// [(u % splits) * per, + per) (clipped to the tiles of N); the streaming
// mode has one tile per unit (splits = tiles of N, per = 1).
struct Walk {
  int splits, per, n_tiles, units;
  __device__ Walk(int M, int N, int splits_, int per_)
      : splits(splits_), per(per_), n_tiles((N + BN - 1) / BN), units(((M + BM - 1) / BM) * splits_) {}
  __device__ int m0(int u) const { return (u / splits) * BM; }
  __device__ int t0(int u) const { return (u % splits) * per; }
  __device__ int t1(int u) const { return min(t0(u) + per, n_tiles); }
};

// The epilogue of a warpgroup's 64 x BN tile: acc + bias staged in shared
// memory in the output map's 128-byte swizzle (16-byte chunk c of row rr at
// c ^ (rr % 8)), once the previous store has read the buffer, then one TMA
// store (or reduce-add into the residual) per 64 x 32 box; rows past M and
// columns past N are clipped by the map. Thread t holds rows r, r + 8 and
// columns 8 j + 2 t4 (+1) of the warpgroup's 64 x BN.
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], unsigned char* obuf,
                                           const CUtensorMap* map_o,
                                           const float* __restrict__ bias, int row0, int n0,
                                           int wg, int wt, int r, int t4, int M, int N,
                                           int resid) {
#pragma unroll
  for (int ps = 0; ps < BN / OUT_COLS; ++ps) {
    if (wt == 0) bulk_wait_read();
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < OUT_COLS / 8; ++jj) {
      const int j = ps * (OUT_COLS / 8) + jj;
      const int col = n0 + 8 * j + 2 * t4;
      const float2 b2 = bias != nullptr && col < N ? *reinterpret_cast<const float2*>(bias + col)
                                                   : make_float2(0.f, 0.f);
      const int cc = 8 * (jj & 3) + 2 * t4;  // column within the 32-wide box jj / 4
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        const int off =
            (jj >> 2) * BOX_BYTES + rr * 128 + (((cc >> 2) ^ (rr & 7)) << 4) + (cc & 3) * 4;
        *reinterpret_cast<float2*>(obuf + off) =
            make_float2(acc[4 * j + 2 * h] + b2.x, acc[4 * j + 2 * h + 1] + b2.y);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wt == 0 && row0 < M) {
#pragma unroll
      for (int i = 0; i < OUT_COLS / 32; ++i) {
        const int c = n0 + ps * OUT_COLS + 32 * i;
        if (c >= N) break;
        if (resid)
          tma_reduce_add_2d(map_o, obuf + i * BOX_BYTES, c, row0);
        else
          tma_store_2d(map_o, obuf + i * BOX_BYTES, c, row0);
      }
      bulk_commit();
    }
  }
}

// The forward modes: LN, the LayerNorm prologue; W (N, K) raw, split in
// shared memory by the splitters
template <bool LN>
__global__ void __launch_bounds__(THREADS, 1)
ln_gemm_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_o, const float* __restrict__ a,
                   const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                   const float* __restrict__ bias, int M, int N, int K, int resid, int splits,
                   int per) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* stage_out = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + CONSUMERS * OUT_BYTES);
  uint64_t* split = full + STAGES;
  uint64_t* empty = split + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&split[s], SPLITTERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int nk = (K + BK - 1) / BK;
  const Walk walk(M, N, splits, per);

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    const int pt = tid - CONSUMERS * 128;
    int stage = 0;
    uint32_t phase = 0;
    if (pt == 0) {
      // one thread issues every copy
      for (int u = blockIdx.x; u < walk.units; u += gridDim.x) {
        const int m0 = walk.m0(u);
        for (int t = walk.t0(u); t < walk.t1(u); ++t) {
          const int n0 = t * BN;
          for (int kc = 0; kc < nk; ++kc) {
            const int k0 = kc * BK;
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], A_BYTES + W_BYTES);
            unsigned char* st = ring + stage * STAGE_BYTES;
            tma_load_2d(st, &map_a, &full[stage], k0, m0);
            tma_load_2d(st + BOX_BYTES, &map_a, &full[stage], k0, m0 + 64);
            tma_load_2d(st + A_BYTES, &map_w, &full[stage], k0, n0);
            tma_load_2d(st + A_BYTES + BOX_BYTES, &map_w, &full[stage], k0, n0 + 64);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (pt >= 32) {
      // the splitters: each landed W tile into its TF32 parts, hi in place
      const int sid = pt - 32;
      int steps = 0;
      for (int u = blockIdx.x; u < walk.units; u += gridDim.x) steps += (walk.t1(u) - walk.t0(u)) * nk;
      for (int it = 0; it < steps; ++it) {
        mbar_wait(&full[stage], phase);
        float4* w = reinterpret_cast<float4*>(ring + stage * STAGE_BYTES + A_BYTES);
        float4* lo = w + W_BYTES / 16;
        for (int i = sid; i < W_BYTES / 16; i += SPLITTERS) {
          const float4 v = w[i];
          uint32_t h[4], l[4];
          tf32_split(v.x, h[0], l[0]);
          tf32_split(v.y, h[1], l[1]);
          tf32_split(v.z, h[2], l[2]);
          tf32_split(v.w, h[3], l[3]);
          w[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                             __uint_as_float(h[3]));
          lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                              __uint_as_float(l[3]));
        }
        fence_proxy_async();  // the parts become visible to the wgmma reads
        mbar_arrive(&split[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    // this thread's rows r and r + 8 of the warpgroup's 64 (r % 8 == g)
    const int r = (wt >> 5) * 16 + g;
    unsigned char* obuf = stage_out + wg * OUT_BYTES;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < walk.units; u += gridDim.x) {
      const int m0 = walk.m0(u);
      float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
      if (LN) row_stats(a, m0 + wg * 64 + (wt >> 5) * 16, M, K, lane, mean, rstd);
      for (int t = walk.t0(u); t < walk.t1(u); ++t) {
        const int n0 = t * BN;
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&full[stage], phase);   // A has landed
          mbar_wait(&split[stage], phase);  // W's parts are written
          const unsigned char* st = ring + stage * STAGE_BYTES;
          // row r of this warpgroup's 64 x 32 box of A (16-byte chunk c at c ^ g)
          const unsigned char* as = st + wg * BOX_BYTES + r * 128 + t4 * 4;
          const unsigned char* wh = st + A_BYTES;
          const unsigned char* wl = wh + W_BYTES;
          const int k0 = kc * BK;
          float part[BN / 2];  // the first product of the stage overwrites it
          uint32_t fh[2][4], fl[2][4];
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            const int b = kk & 1;
            // columns 8 kk + t4 (chunk 2 kk) and + 4 (chunk 2 kk + 1) of rows r, r + 8
            const unsigned char* p0 = as + (((2 * kk) ^ g) << 4);
            const unsigned char* p1 = as + (((2 * kk + 1) ^ g) << 4);
            float x[4] = {*reinterpret_cast<const float*>(p0),
                          *reinterpret_cast<const float*>(p0 + 1024),
                          *reinterpret_cast<const float*>(p1),
                          *reinterpret_cast<const float*>(p1 + 1024)};
            if (LN) {
              const int k = k0 + 8 * kk + t4;
              if (k < K) {  // K % 8 == 0: k + 4 < K too
                const float s0 = __ldg(ln_s + k), s1 = __ldg(ln_s + k + 4);
                const float b0 = __ldg(ln_b + k), b1 = __ldg(ln_b + k + 4);
                x[0] = ((x[0] - mean[0]) * rstd[0]) * s0 + b0;
                x[1] = ((x[1] - mean[1]) * rstd[1]) * s0 + b0;
                x[2] = ((x[2] - mean[0]) * rstd[0]) * s1 + b1;
                x[3] = ((x[3] - mean[1]) * rstd[1]) * s1 + b1;
              } else {
                x[0] = x[1] = x[2] = x[3] = 0.f;
              }
            }
            tf32_frag(x, fh[b], fl[b]);
            wgmma_fence();
            const uint64_t dh = sw128_desc(wh + kk * 32, 16, 1024);
            const uint64_t dl = sw128_desc(wl + kk * 32, 16, 1024);
            wgmma_m64n128k8_tf32_rs(part, fl[b], dh, kk > 0);
            wgmma_m64n128k8_tf32_rs(part, fh[b], dl, 1);
            wgmma_m64n128k8_tf32_rs(part, fh[b], dh, 1);
            wgmma_commit();
            // the previous step's products are done: its fragments may be rewritten
            if (kk == BK / 8 - 1) {
              wgmma_wait<0>();
            } else if (kk > 0) {
              wgmma_wait<1>();
            }
          }
          fence_regs(part);
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            fence_regs(fh[b]);
            fence_regs(fl[b]);
          }
          if (wt == 0) mbar_arrive(&empty[stage]);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        store_tile(acc, obuf, &map_o, bias, m0 + wg * 64, n0, wg, wt, r, t4, M, N, resid);
      }
    }
    if (wt == 0) bulk_wait();
  }
}

// The training modes' product: A (M, K) plain, W as its TF32 parts, two
// (N, K) arrays by TMA (split_w_kernel's); the streaming walk (one tile a
// unit, the column tile fastest); the consumer warpgroups in turns.
__global__ void __launch_bounds__(THREADS, 1)
ln_gemm_f32_parts_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_wh,
                         const __grid_constant__ CUtensorMap map_wl,
                         const __grid_constant__ CUtensorMap map_o,
                         const float* __restrict__ bias, int M, int N, int K, int resid) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* stage_out = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int nk = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN;
  const Walk walk(M, N, n_tiles, 1);

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      // one thread issues every copy
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < walk.units; u += gridDim.x) {
        const int m0 = walk.m0(u), n0 = walk.t0(u) * BN;
        for (int kc = 0; kc < nk; ++kc) {
          const int k0 = kc * BK;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* st = ring + stage * STAGE_BYTES;
          tma_load_2d(st, &map_a, &full[stage], k0, m0);
          tma_load_2d(st + BOX_BYTES, &map_a, &full[stage], k0, m0 + 64);
          tma_load_2d(st + A_BYTES, &map_wh, &full[stage], k0, n0);
          tma_load_2d(st + A_BYTES + BOX_BYTES, &map_wh, &full[stage], k0, n0 + 64);
          tma_load_2d(st + A_BYTES + W_BYTES, &map_wl, &full[stage], k0, n0);
          tma_load_2d(st + A_BYTES + W_BYTES + BOX_BYTES, &map_wl, &full[stage], k0, n0 + 64);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r = (wt >> 5) * 16 + g;  // this thread's rows r and r + 8 of the warpgroup's 64
    unsigned char* obuf = stage_out + wg * OUT_BYTES;
    const Turn turn{wg};
    if (wg == 1) turn.pass();  // warpgroup 0 runs first
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < walk.units; u += gridDim.x) {
      const int m0 = walk.m0(u), n0 = walk.t0(u) * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * STAGE_BYTES;
        // row r of this warpgroup's 64 x 32 box of A (16-byte chunk c at c ^ g):
        // the stage's four fragments, split before the turn
        const unsigned char* as = st + wg * BOX_BYTES + r * 128 + t4 * 4;
        uint32_t fh[BK / 8][4], fl[BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          // columns 8 kk + t4 (chunk 2 kk) and + 4 (chunk 2 kk + 1) of rows r, r + 8
          const unsigned char* p0 = as + (((2 * kk) ^ g) << 4);
          const unsigned char* p1 = as + (((2 * kk + 1) ^ g) << 4);
          const float x[4] = {*reinterpret_cast<const float*>(p0),
                              *reinterpret_cast<const float*>(p0 + 1024),
                              *reinterpret_cast<const float*>(p1),
                              *reinterpret_cast<const float*>(p1 + 1024)};
          tf32_frag_int(x, fh[kk], fl[kk]);
        }
        const unsigned char* wh = st + A_BYTES;
        const unsigned char* wl = wh + W_BYTES;
        float part[BN / 2];  // the first product of the stage overwrites it
        turn.take();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t dh = sw128_desc(wh + kk * 32, 16, 1024);
          const uint64_t dl = sw128_desc(wl + kk * 32, 16, 1024);
          wgmma_m64n128k8_tf32_rs(part, fl[kk], dh, kk > 0);
          wgmma_m64n128k8_tf32_rs(part, fh[kk], dl, 1);
          wgmma_m64n128k8_tf32_rs(part, fh[kk], dh, 1);
        }
        wgmma_commit();
        turn.pass();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          fence_regs(fh[kk]);
          fence_regs(fl[kk]);
        }
        if (wt == 0) mbar_arrive(&empty[stage]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      store_tile(acc, obuf, &map_o, bias, m0 + wg * 64, n0, wg, wt, r, t4, M, N, resid);
    }
    if (wg == 0) turn.take();  // warpgroup 1's last pass
    if (wt == 0) bulk_wait();
  }
}

// The row pass of the LayerNorm rows' mode: xn = ((a - mean) * rstd) *
// scale + shift per row, the statistics as row_stats takes them (the same
// sums in the same order); one warp a row, float4 loads and stores of the
// rows (K % 8 == 0)
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
ln_rows_kernel(const float* __restrict__ a, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, float* __restrict__ xn, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const int chunks = K / 4;
  const float4* p = reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * K);
  float s = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const float4 v = p[c];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / K;
  float q = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const float4 v = p[c];
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float rs = rsqrtf(warp_sum(q) / K + LN_EPS);
  float4* o = reinterpret_cast<float4*>(xn + static_cast<size_t>(row) * K);
  for (int c = lane; c < chunks; c += 32) {
    const float4 v = p[c];
    const float* sc = ln_s + 4 * c;
    const float* sh = ln_b + 4 * c;
    o[c] = make_float4(((v.x - mu) * rs) * __ldg(sc) + __ldg(sh),
                       ((v.y - mu) * rs) * __ldg(sc + 1) + __ldg(sh + 1),
                       ((v.z - mu) * rs) * __ldg(sc + 2) + __ldg(sh + 2),
                       ((v.w - mu) * rs) * __ldg(sc + 3) + __ldg(sh + 3));
  }
}

// The split pre-pass: hi and lo, (N, K) row-major, the TF32 parts of W (N,
// K), or of W^T for W stored (K, N) (transposed: a 32 x 32 tile read along
// N and written along K through shared memory)
__global__ void __launch_bounds__(SPLIT_TILE * 8)
split_w_kernel(const float* __restrict__ w, float* __restrict__ hi, float* __restrict__ lo, int N,
               int K, int transposed) {
  __shared__ float tile[SPLIT_TILE][SPLIT_TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * SPLIT_TILE, k0 = blockIdx.y * SPLIT_TILE;
  if (transposed) {
    for (int i = ty; i < SPLIT_TILE; i += 8) {
      const int k = k0 + i, n = n0 + tx;
      tile[i][tx] = k < K && n < N ? w[static_cast<size_t>(k) * N + n] : 0.f;
    }
    __syncthreads();
  }
  for (int i = ty; i < SPLIT_TILE; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n >= N || k >= K) continue;
    const size_t at = static_cast<size_t>(n) * K + k;
    uint32_t h, l;
    tf32_split(transposed ? tile[tx][i] : w[at], h, l);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
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

// the work split: LayerNorm mode keeps whole row blocks in a unit (their
// statistics taken once) and splits their column tiles over the SMs the
// row blocks leave idle
void plan(bool ln, int M, int N, int* splits, int* per, int* grid) {
  const int sms = sm_count();
  const int row_blocks = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  *splits = n_tiles;
  *per = 1;
  if (ln) {
    *splits = max(1, min(n_tiles, sms / row_blocks));
    *per = (n_tiles + *splits - 1) / *splits;
    *splits = (n_tiles + *per - 1) / *per;
  }
  *grid = min(row_blocks * *splits, sms);
}

// a float32 (rows, cols) row-major map of 64-row x 32-column boxes, 128-byte swizzled
int encode_f32(CUtensorMap* map, const void* ptr, int cols, int rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(cols) * 4};
  const uint32_t box[2] = {32, 64};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, stride, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The current device's default memory pool keeps at least `bytes` mapped
// across synchronisations (its release threshold is 0 unless raised: each
// synchronisation would hand the scratch back, and the next call would map
// it again)
void keep_in_pool(size_t bytes) {
  int dev = 0;
  cudaMemPool_t pool;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetDefaultMemPool(&pool, dev) != cudaSuccess)
    return;
  uint64_t held = 0;
  cudaMemPoolGetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &held);
  if (held < bytes) {
    uint64_t keep = bytes;
    cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  }
}

// The training modes: W's parts into a scratch of the call's own, the row
// pass (xn given), then the product on the parts
int launch_training(const float* a, const float* ln_s, const float* ln_b, const float* w,
                    const float* bias, float* out, float* xn, int resid, int M, int N, int K,
                    int w_transposed, cudaStream_t stream) {
  const size_t part = static_cast<size_t>(N) * K;
  keep_in_pool(2 * part * sizeof(float));
  float* parts = nullptr;
  cudaError_t e = cudaMallocAsync(reinterpret_cast<void**>(&parts), 2 * part * sizeof(float), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* a_op = xn != nullptr ? xn : a;
  CUtensorMap map_a, map_wh, map_wl, map_o;
  int err = encode_f32(&map_a, a_op, K, M);
  if (!err) err = encode_f32(&map_wh, parts, K, N);
  if (!err) err = encode_f32(&map_wl, parts + part, K, N);
  if (!err) err = encode_f32(&map_o, out, N, M);
  if (!err) {
    split_w_kernel<<<dim3((N + SPLIT_TILE - 1) / SPLIT_TILE, (K + SPLIT_TILE - 1) / SPLIT_TILE),
                     dim3(SPLIT_TILE, 8), 0, stream>>>(w, parts, parts + part, N, K, w_transposed);
    err = static_cast<int>(cudaGetLastError());
  }
  if (!err && xn != nullptr) {
    ln_rows_kernel<<<(M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 32 * ROWS_PER_BLOCK, 0, stream>>>(
        a, ln_s, ln_b, xn, M, K);
    err = static_cast<int>(cudaGetLastError());
  }
  if (!err) {
    const void* kernel = (const void*)ln_gemm_f32_parts_kernel;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    int splits, per, grid;
    plan(false, M, N, &splits, &per, &grid);
    void* args[] = {&map_a, &map_wh, &map_wl, &map_o, &bias, &M, &N, &K, &resid};
    if (e == cudaSuccess) e = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, SMEM, stream);
    err = static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  e = cudaFreeAsync(parts, stream);
  return err ? err : static_cast<int>(e);
}

}  // namespace

// a: (M, K) float32 (the residual when ln_s/ln_b are given: LayerNorm
// prologue). w: (N, K) float32, or (K, N) when w_transposed is non-zero
// (then out = a @ w; no LayerNorm). bias: (N,) float32 or null. out: (M, N)
// float32; with resid != 0 it is the float32 residual, updated in place
// (out += acc + bias). xn: null, or (M, K) float32 for the LayerNorm's
// rows (LayerNorm mode only). Requires N % 4 == 0, K % 8 == 0, any M >= 1,
// every pointer 16-byte aligned (TMA). The training modes (xn or
// w_transposed) launch the split pre-pass, the row pass (xn) and the
// product, in that order, on `stream`.
LTD_API int ltd_ln_gemm_f32(const float* a, const float* ln_s, const float* ln_b, const float* w,
                            const float* bias, float* out, float* xn, int resid, int M, int N,
                            int K, int w_transposed, void* stream) {
  const bool ln = ln_s != nullptr;
  if (M < 1 || N < 4 || N % 4 || K < 8 || K % 8 || out == nullptr || (xn != nullptr && !ln) ||
      (w_transposed && ln))
    return static_cast<int>(cudaErrorInvalidValue);
  if (xn != nullptr || w_transposed)
    return launch_training(a, ln_s, ln_b, w, bias, out, xn, resid, M, N, K, w_transposed,
                           static_cast<cudaStream_t>(stream));
  int splits, per, grid;
  plan(ln, M, N, &splits, &per, &grid);
  CUtensorMap map_a, map_w, map_o;
  int err = encode_f32(&map_a, a, K, M);
  if (!err) err = encode_f32(&map_w, w, K, N);
  if (!err) err = encode_f32(&map_o, out, N, M);
  if (err) return err;
  const void* kernel = ln ? (const void*)ln_gemm_f32_kernel<true>
                          : (const void*)ln_gemm_f32_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&map_a, &map_w, &map_o, &a, &ln_s, &ln_b, &bias, &M, &N, &K, &resid, &splits, &per};
  e = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, SMEM,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
