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
//   with float32 weights) add two modes. `xn` (LayerNorm mode): the
//   consumers of a row block's first column tile also store the float32
//   normalised values they split, the rows the backward's dW products
//   read. W transposed (the input-gradient products dX = dY W, W stored
//   (out, in) = (K, N) of this product): the 32-bit `wgmma` forms take
//   K-major operands only, so W's 32 x 128 tile lands by TMA as stored
//   (one unswizzled box, N-major) in a raw slot of its stage, and the
//   splitters transpose it as they split it, each 16-byte chunk of 4 K
//   values gathered from 4 rows of the raw tile (consecutive threads on
//   consecutive columns: no bank conflict) into the swizzled K-major hi and
//   lo parts the consumers read as in the other modes. The raw slot costs
//   16 KB a stage, so this mode's ring has 3 stages of 64 KB.
// - A persistent grid (one block per SM) walks the work: whole output tiles
//   with the column tile fastest, so the SMs that run at once share each A
//   row block in L2 and all of W (at most 9.4 MB) stays there.
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

#include "f32_tile.cuh"

namespace {

constexpr int BM = 128;                 // output tile rows: two warpgroups of 64
constexpr int BN = 128;                 // output tile columns
constexpr int BK = 32;                  // K per stage: one 128-byte swizzled row of float32
constexpr int BOX_BYTES = 64 * 128;     // one 64-row x 32-float TMA box
constexpr int A_BYTES = 2 * BOX_BYTES;  // A's 128 x 32 of a stage
constexpr int W_BYTES = 2 * BOX_BYTES;  // W's 128 x 32: its hi part after the split
constexpr int STAGE_BYTES = A_BYTES + 2 * W_BYTES;  // + W's lo part
constexpr int STAGES = 4;
// W transposed: W's raw tile beside its parts, in a ring of 3 stages
constexpr int T_STAGE_BYTES = STAGE_BYTES + W_BYTES;
constexpr int T_STAGES = 3;
static_assert(T_STAGES * T_STAGE_BYTES <= STAGES * STAGE_BYTES, "the rings share one budget");
static_assert(f32tile::TILE_BYTES == W_BYTES && f32tile::ROWS == BN && f32tile::DEPTH == BK,
              "W's transposed tile is f32_tile.cuh's");
constexpr int OUT_BYTES = 2 * BOX_BYTES;  // a warpgroup's output staging: 64 rows x 64 columns
constexpr int OUT_COLS = 64;
constexpr int CONSUMERS = 2;
constexpr int SPLITTERS = 96;  // warps 1-3 of the producer warpgroup
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + 3 * STAGES * 8;
constexpr float LN_EPS = 1e-5f;

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

// LN: the LayerNorm prologue; XN: also store its float32 rows into xn; WT:
// W stored transposed, (K, N)
template <bool LN, bool XN, bool WT>
__global__ void __launch_bounds__(THREADS, 1)
ln_gemm_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_o, const float* __restrict__ a,
                   const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                   const float* __restrict__ bias, float* __restrict__ xn, int M, int N, int K,
                   int resid, int splits, int per) {
  constexpr int NSTAGES = WT ? T_STAGES : STAGES;
  constexpr int SBYTES = WT ? T_STAGE_BYTES : STAGE_BYTES;
  constexpr int RAW = WT ? W_BYTES : 0;  // W's raw tile after A, before its parts
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* stage_out = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + CONSUMERS * OUT_BYTES);
  uint64_t* split = full + STAGES;
  uint64_t* empty = split + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NSTAGES; ++s) {
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
            unsigned char* st = ring + stage * SBYTES;
            tma_load_2d(st, &map_a, &full[stage], k0, m0);
            tma_load_2d(st + BOX_BYTES, &map_a, &full[stage], k0, m0 + 64);
            if (WT) {  // one 128 x 32 box of W (K, N) as stored, into the raw slot
              tma_load_2d(st + A_BYTES, &map_w, &full[stage], n0, k0);
            } else {
              tma_load_2d(st + A_BYTES, &map_w, &full[stage], k0, n0);
              tma_load_2d(st + A_BYTES + BOX_BYTES, &map_w, &full[stage], k0, n0 + 64);
            }
            if (++stage == NSTAGES) {
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
        float4* w = reinterpret_cast<float4*>(ring + stage * SBYTES + A_BYTES + RAW);
        float4* lo = w + W_BYTES / 16;
        if (WT) {
          f32tile::split_transposed(
              reinterpret_cast<const float*>(ring + stage * SBYTES + A_BYTES),
                           reinterpret_cast<unsigned char*>(w),
                           reinterpret_cast<unsigned char*>(lo), sid);
        } else {
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
        }
        fence_proxy_async();  // the parts become visible to the wgmma reads
        mbar_arrive(&split[stage]);
        if (++stage == NSTAGES) {
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
          const unsigned char* st = ring + stage * SBYTES;
          // row r of this warpgroup's 64 x 32 box of A (16-byte chunk c at c ^ g)
          const unsigned char* as = st + wg * BOX_BYTES + r * 128 + t4 * 4;
          const unsigned char* wh = st + A_BYTES + RAW;
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
              if (XN && t == 0 && k < K) {  // the row block's first tile stores its rows
                const int row = m0 + wg * 64 + r;
                if (row < M) {
                  xn[static_cast<size_t>(row) * K + k] = x[0];
                  xn[static_cast<size_t>(row) * K + k + 4] = x[2];
                }
                if (row + 8 < M) {
                  xn[static_cast<size_t>(row + 8) * K + k] = x[1];
                  xn[static_cast<size_t>(row + 8) * K + k + 4] = x[3];
                }
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
          if (++stage == NSTAGES) {
            stage = 0;
            phase ^= 1;
          }
        }

        // epilogue: acc + bias staged in shared memory in the output map's
        // 128-byte swizzle (16-byte chunk c of row rr at c ^ (rr % 8)), once
        // the previous store has read the buffer, then one TMA store (or
        // reduce-add into the residual) per 64 x 32 box; rows past M and
        // columns past N are clipped by the map. Thread t holds rows r,
        // r + 8 and columns 8 j + 2 t4 (+1) of the warpgroup's 64 x BN.
        const int row0 = m0 + wg * 64;
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
                tma_reduce_add_2d(&map_o, obuf + i * BOX_BYTES, c, row0);
              else
                tma_store_2d(&map_o, obuf + i * BOX_BYTES, c, row0);
            }
            bulk_commit();
          }
        }
      }
    }
    if (wt == 0) bulk_wait();
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

}  // namespace

// a: (M, K) float32 (the residual when ln_s/ln_b are given: LayerNorm
// prologue). w: (N, K) float32, or (K, N) when w_transposed is non-zero
// (then out = a @ w; no LayerNorm). bias: (N,) float32 or null. out: (M, N)
// float32; with resid != 0 it is the float32 residual, updated in place
// (out += acc + bias). xn: null, or (M, K) float32 for the LayerNorm's
// rows (LayerNorm mode only). Requires N % 4 == 0, K % 8 == 0, any M >= 1,
// every pointer 16-byte aligned (TMA).
LTD_API int ltd_ln_gemm_f32(const float* a, const float* ln_s, const float* ln_b, const float* w,
                            const float* bias, float* out, float* xn, int resid, int M, int N,
                            int K, int w_transposed, void* stream) {
  const bool ln = ln_s != nullptr;
  if (M < 1 || N < 4 || N % 4 || K < 8 || K % 8 || out == nullptr || (xn != nullptr && !ln) ||
      (w_transposed && ln))
    return static_cast<int>(cudaErrorInvalidValue);
  int splits, per, grid;
  plan(ln, M, N, &splits, &per, &grid);
  CUtensorMap map_a, map_w, map_o;
  int err = encode_f32(&map_a, a, K, M);
  if (!err) err = w_transposed ? f32tile::encode_rows(&map_w, w, N, K) : encode_f32(&map_w, w, K, N);
  if (!err) err = encode_f32(&map_o, out, N, M);
  if (err) return err;
  const void* kernel =
      ln ? (xn != nullptr ? (const void*)ln_gemm_f32_kernel<true, true, false>
                          : (const void*)ln_gemm_f32_kernel<true, false, false>)
         : (w_transposed ? (const void*)ln_gemm_f32_kernel<false, false, true>
                         : (const void*)ln_gemm_f32_kernel<false, false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&map_a, &map_w, &map_o, &a, &ln_s, &ln_b, &bias, &xn,
                  &M,     &N,     &K,     &resid, &splits, &per};
  e = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, SMEM,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
