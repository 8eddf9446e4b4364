// ln_gemm: C = LN?(A) @ W^T on the tensor cores, with a bias / residual epilogue.
//
// Replaces the five matrix products of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel:
// LN1 -> QKV (768 -> 2304), LN2 -> Q (768 -> 768), the conditioning K/V
// projection (2B rows, 768 -> 1536), expand + b1 (768 -> 3072, from the
// LN3 rows that cross_attention.cu writes in bf16) and contract + b2 added
// into the residual (3072 -> 768).
//
// What bounds it on the H100: at M = B*N = 16384 rows these products do
// ~150 to ~300 FLOP per byte they must move, so they are compute-bound on
// the tensor cores (989 TFLOP/s dense bf16 at 700 W), provided the operand
// copies run behind the multiplies and shared memory keeps up with them.
//
// What this design does about that. One kernel body and one main loop for
// both modes (template flags), a 128 x 256 output tile:
// - One producer thread issues TMA loads (`cp.async.bulk.tensor`, 64 x 64
//   bf16 boxes, 128-byte swizzle) into a ring of four 48 KB stages (A's
//   128 x 64 and W's 256 x 64) with full and empty `mbarrier`s. Two
//   consumer warpgroups (`setmaxnreg`: 232 registers, the producer's
//   warpgroup 40) each multiply 64 rows of the tile with `wgmma`
//   m64n256k16 from shared memory, float32 accumulators in registers, and
//   keep one stage of products in flight. 128 x 256 and not 128 x 128:
//   each A byte brought into shared memory feeds twice the products, and
//   the long-K products ran faster so on the card.
// - W is read by a 2-D tensor map as stored: (N, K), K-major, or with
//   `w_transposed` (K, N), the MN-major B operand (the backward's dX = dY W
//   products pass W as it is, no transposed copy). Columns of a 64-wide K
//   box past K (K % 64 == 32), rows past M and W rows past N (a ragged
//   last column tile, N % 256 != 0) arrive as zeros; the epilogue's TMA
//   stores clip the columns past N.
// - A persistent grid (one block per SM) walks the work: whole output
//   tiles in row-major order (column tile fastest), so the SMs that run at
//   once share each A row block and all of W (at most 4.7 MB here) stays
//   in L2 across the row blocks.
// - The epilogue runs from the accumulators through shared memory: acc
//   (+ bias) is written into a 16 KB staging buffer per warpgroup in the
//   output map's 128-byte swizzle and leaves by TMA, a store (bf16 or
//   float32 out) or a reduce-add into the float32 residual
//   (`cp.reduce.async.bulk.tensor .add`: x + (acc + bias), the TPU
//   kernel's order), in passes of 128 bf16 or 64 float32 columns. The
//   warpgroup goes on to the next tile's products while the copy runs;
//   rows past M are clipped by the map. Each element has one writer and
//   one float32 add, so two launches give bit-equal results.
// - LayerNorm mode (A the float32 residual): a unit of work is a row block
//   of 128 rows and its run of column tiles. The consumer warpgroups first
//   normalise the block's rows in float32 (mean, then variance over the
//   registers, eps 1e-5; each warp two rows at a time up to K = 1024, and
//   one row read three times from L2 beyond, in the same summation order)
//   and write them in bf16 to a 128-row region of this block in an
//   L2-resident scratch (25 MB at M = 16384), or straight to `xn_out` when
//   the caller asks for the rows and each row block is one unit; a
//   proxy fence and an `mbarrier` hand them to the producer, which then
//   streams them as A exactly as the streaming mode streams its bf16 A.
//   So every product runs the same 4-stage main loop. Rows resident in
//   shared memory instead (128 x 768 bf16 = 192 KB) leave room for two
//   16 KB W stages only, and a main loop that deep waits on every W load
//   from L2 (tried on the card; PERF.md, PR 9). The normalisation's
//   read (50 MB at M = 16384) comes before the unit's products: at M =
//   16384 each SM holds one unit and has nothing else to multiply. With
//   more units per SM (M = 32768 and up) the producer asks L2
//   (`cp.async.bulk.prefetch.L2`) for the next unit's float32 rows while
//   this unit multiplies. When there are fewer row blocks than SMs the
//   column tiles are split over more units (each with its own region).
//
// Rounding points are the TPU kernel's: float32 accumulation; the stored
// output is bf16(acc [+ bias]); the residual is x + (acc + bias) in float32.
//
// The training layer (ops/fused_layer_vjp.py, TPU kernel
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_fwd_kernel and
// the recompute of _bwd_kernel) uses the float32 output (the expanded
// hidden state h, which that kernel keeps float32, and the backward's
// dX = dY W with `w_transposed`) and `xn_out` (the xn1 / xn2 operands of
// the weight gradients).

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                  // output tile rows: two warpgroups of 64
constexpr int BN = 256;                  // output tile columns
constexpr int BK = 64;                   // K per stage (one 128-byte swizzled box row)
constexpr int BOX_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 TMA box (or 64 x 32 float32)
constexpr int A_BYTES = 2 * BOX_BYTES;   // A's 128 x 64 of a stage
constexpr int STAGE_BYTES = A_BYTES + BN / 64 * BOX_BYTES;  // + W's BN x 64
constexpr int STAGES = 4;
// a warpgroup's output staging (16 KB): passes of 64 rows x BF_COLS bf16
// or F32_COLS float32 columns
constexpr int OUT_BYTES = 64 * 64 * 4;
constexpr int BF_COLS = OUT_BYTES / 128;
constexpr int F32_COLS = OUT_BYTES / 256;
static_assert(BN % BF_COLS == 0 && BN % F32_COLS == 0, "whole staging passes");
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + (2 * STAGES + 1) * 8;
constexpr int MAX_LN_K = 1024;  // rows a warp normalises in registers; wider ones re-read
constexpr int LN_ROWS = 2;  // rows a warp normalises at once
constexpr float LN_EPS = 1e-5f;

enum Out { OUT_BF16 = 0, OUT_F32 = 1, OUT_RESIDUAL = 2 };

// This warp's LN_ROWS rows r0 .. of the row block at m0 (global rows
// m0 + r): float32 mean, then variance over the registers (eps 1e-5),
// scaled, shifted and rounded to bf16 into `rows` (row r at rows + r * K)
// and, if given, xn_out (global row m0 + r); rows past M are skipped (their
// outputs are never stored). The LN_ROWS rows' loads are in flight together.
// K <= MAX_LN_K: lane l holds the 8-column chunks l, l + 32, ...
__device__ __forceinline__ void normalise_rows(const float* __restrict__ a,
                                               const float* __restrict__ ln_s,
                                               const float* __restrict__ ln_b,
                                               bf16* __restrict__ rows, bf16* __restrict__ xn_out,
                                               int m0, int r0, int M, int K, int lane) {
  constexpr int J = MAX_LN_K / 256;  // 8-column chunks per lane
  const int chunks = K / 8;
  float4 v[LN_ROWS][J][2];
#pragma unroll
  for (int i = 0; i < LN_ROWS; ++i) {
    const int row = m0 + r0 + i;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (row < M && c < chunks) {
        const float4* p = reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * K + 8 * c);
        v[i][j][0] = p[0];
        v[i][j][1] = p[1];
      } else {
        v[i][j][0] = v[i][j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LN_ROWS; ++i) {
    const int r = r0 + i, row = m0 + r;
    if (row >= M) continue;  // warp-uniform
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) s += (v[i][j][h].x + v[i][j][h].y) + (v[i][j][h].z + v[i][j][h].w);
    const float mean = warp_sum(s) / K;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (lane + 32 * j < chunks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 = v[i][j][h].x - mean, d1 = v[i][j][h].y - mean;
          const float d2 = v[i][j][h].z - mean, d3 = v[i][j][h].w - mean;
          q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / K + LN_EPS);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (c >= chunks) continue;
      float y[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 s4 = reinterpret_cast<const float4*>(ln_s + 8 * c)[h];
        const float4 b4 = reinterpret_cast<const float4*>(ln_b + 8 * c)[h];
        y[4 * h] = (v[i][j][h].x - mean) * rstd * s4.x + b4.x;
        y[4 * h + 1] = (v[i][j][h].y - mean) * rstd * s4.y + b4.y;
        y[4 * h + 2] = (v[i][j][h].z - mean) * rstd * s4.z + b4.z;
        y[4 * h + 3] = (v[i][j][h].w - mean) * rstd * s4.w + b4.w;
      }
      const uint4 p = pack8_bf16(y);
      *reinterpret_cast<uint4*>(rows + static_cast<size_t>(r) * K + 8 * c) = p;
      if (xn_out != nullptr)
        *reinterpret_cast<uint4*>(xn_out + static_cast<size_t>(row) * K + 8 * c) = p;
    }
  }
}

// The same for one row of any K (K > MAX_LN_K): the row is read three
// times (mean, variance, output; from L2 after the first), each lane
// summing its chunks l, l + 32, ... in the order of the register path, so
// both give the same statistics.
__device__ __forceinline__ void normalise_row_wide(const float* __restrict__ a,
                                                   const float* __restrict__ ln_s,
                                                   const float* __restrict__ ln_b,
                                                   bf16* __restrict__ rows,
                                                   bf16* __restrict__ xn_out, int m0, int r, int M,
                                                   int K, int lane) {
  const int row = m0 + r;
  if (row >= M) return;  // warp-uniform
  const float4* p = reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * K);
  const int chunks = K / 8;
  float s = 0.f;
  for (int c = lane; c < chunks; c += 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = p[2 * c + h];
      s += (v.x + v.y) + (v.z + v.w);
    }
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int c = lane; c < chunks; c += 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = p[2 * c + h];
      const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
      q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / K + LN_EPS);
  for (int c = lane; c < chunks; c += 32) {
    float y[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = p[2 * c + h];
      const float4 s4 = reinterpret_cast<const float4*>(ln_s + 8 * c)[h];
      const float4 b4 = reinterpret_cast<const float4*>(ln_b + 8 * c)[h];
      y[4 * h] = (v.x - mean) * rstd * s4.x + b4.x;
      y[4 * h + 1] = (v.y - mean) * rstd * s4.y + b4.y;
      y[4 * h + 2] = (v.z - mean) * rstd * s4.z + b4.z;
      y[4 * h + 3] = (v.w - mean) * rstd * s4.w + b4.w;
    }
    const uint4 o = pack8_bf16(y);
    *reinterpret_cast<uint4*>(rows + static_cast<size_t>(r) * K + 8 * c) = o;
    if (xn_out != nullptr)
      *reinterpret_cast<uint4*>(xn_out + static_cast<size_t>(row) * K + 8 * c) = o;
  }
}

// Work units: unit u is row block u / splits and the column tiles
// [(u % splits) * per, + per) (clipped to N / BN); the streaming mode has
// one tile per unit (splits = N / BN, per = 1). LayerNorm mode: the unit's
// normalised rows go to `rows` (its row block's rows when rows_global,
// else the 128-row region of this block) and map_a reads them there;
// xn_extra (or null) also gets them, from the units of split 0.
template <bool LN, bool TW>
__global__ void __launch_bounds__(THREADS, 1)
ln_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_o, const float* __restrict__ a32,
               const float* __restrict__ ln_s, const float* __restrict__ ln_b,
               const float* __restrict__ bias, bf16* __restrict__ rows, int rows_global,
               bf16* __restrict__ xn_extra, int M, int N, int K, int mode, int splits, int per) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* stage_out = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* rows_ready = empty + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(rows_ready, CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();
  const int nk = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN;
  const int units = ((M + BM - 1) / BM) * splits;

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0, ln_phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u / splits) * BM;
        const int t0 = (u % splits) * per, t1 = min(t0 + per, n_tiles);
        int a_row = m0;
        if (LN) {
          // the next unit's float32 rows into L2 while this one multiplies
          const int nu = u + gridDim.x;
          if (nu < units && nu / splits != u / splits) {
            const int nm0 = (nu / splits) * BM;
            const size_t bytes = static_cast<size_t>(min(BM, M - nm0)) * K * 4;
            const unsigned char* p = reinterpret_cast<const unsigned char*>(a32) +
                                     static_cast<size_t>(nm0) * K * 4;
            for (size_t off = 0; off < bytes; off += 32768)
              prefetch_l2(p + off, static_cast<uint32_t>(bytes - off < 32768 ? bytes - off : 32768));
          }
          if (!rows_global) a_row = blockIdx.x * BM;
          mbar_wait(rows_ready, ln_phase);  // this unit's rows are normalised
          ln_phase ^= 1;
        }
        for (int t = t0; t < t1; ++t) {
          const int n0 = t * BN;
          for (int kc = 0; kc < nk; ++kc) {
            const int k0 = kc * BK;
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
            unsigned char* st = ring + stage * STAGE_BYTES;
            tma_load_2d(st, &map_a, &full[stage], k0, a_row);
            tma_load_2d(st + BOX_BYTES, &map_a, &full[stage], k0, a_row + 64);
            unsigned char* ws = st + A_BYTES;
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) {
              if (TW)  // (K, N): box j holds 64 K rows of columns n0 + 64 j ..
                tma_load_2d(ws + j * BOX_BYTES, &map_w, &full[stage], n0 + 64 * j, k0);
              else  // (N, K): box j holds rows n0 + 64 j .. of 64 K columns
                tma_load_2d(ws + j * BOX_BYTES, &map_w, &full[stage], k0, n0 + 64 * j);
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
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
    unsigned char* obuf = stage_out + wg * OUT_BYTES;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u / splits) * BM;
      const int t0 = (u % splits) * per, t1 = min(t0 + per, n_tiles);
      if (LN) {
        // this warpgroup's 64 rows, 16 per warp; the previous unit's loads
        // of the region have all landed (every stage was consumed)
        bf16* dst = rows + static_cast<size_t>(rows_global ? m0 : blockIdx.x * BM) * K;
        bf16* xo = u % splits == 0 ? xn_extra : nullptr;
        const int r0 = wg * 64 + (wt >> 5) * 16;
        if (K <= MAX_LN_K) {
          for (int r = 0; r < 16; r += LN_ROWS)
            normalise_rows(a32, ln_s, ln_b, dst, xo, m0, r0 + r, M, K, lane);
        } else {
          for (int r = 0; r < 16; ++r)
            normalise_row_wide(a32, ln_s, ln_b, dst, xo, m0, r0 + r, M, K, lane);
        }
        fence_proxy_async_global();  // the rows become visible to the TMA loads
        named_barrier(1 + wg, 128);
        if (wt == 0) mbar_arrive(rows_ready);
      }
      for (int t = t0; t < t1; ++t) {
        const int n0 = t * BN;
        float acc[BN / 2];  // the first product of the tile overwrites it
        int prev = 0;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&full[stage], phase);
          const unsigned char* a = ring + stage * STAGE_BYTES + wg * BOX_BYTES;
          const unsigned char* w = ring + stage * STAGE_BYTES + A_BYTES;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
            const uint32_t keep = kc > 0 || kk > 0;  // the first product overwrites acc
            // TW: 16 K rows of 128 bytes, the 64-column boxes BOX_BYTES apart
            const uint64_t dw = TW ? sw128_desc(w + kk * 2048, BOX_BYTES, 1024)
                                   : sw128_desc(w + kk * 32, 16, 1024);
            wgmma_m64n256k16_ss<0, TW ? 1 : 0>(acc, da, dw, keep);
          }
          wgmma_commit();
          // the previous stage's products are done: give its buffers back
          wgmma_wait<1>();
          if (kc > 0 && wt == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (wt == 0) mbar_arrive(&empty[prev]);

        // epilogue: acc (+ bias) staged in shared memory in the output
        // map's 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)),
        // once the previous store has read the buffer, then one TMA store
        // (or reduce-add into the residual) per box; rows past M and
        // columns past N are clipped by the map. Thread t holds rows r,
        // r + 8 and columns 8 j + 2 t4 (+1) of the warpgroup's 64 x BN,
        // staged in passes of BF_COLS bf16 (64 x 64 boxes) or F32_COLS
        // float32 (64 x 32 boxes) columns.
        const int r = (wt >> 5) * 16 + g;
        const int row0 = m0 + wg * 64;
        auto begin_pass = [&]() {
          if (wt == 0) bulk_wait_read();
          named_barrier(1 + wg, 128);
        };
        auto end_pass = [&](int c0, int boxes, int box_cols) {
          fence_proxy_async();
          named_barrier(1 + wg, 128);
          if (wt == 0 && row0 < M) {
            for (int i = 0; i < boxes; ++i) {
              const int c = c0 + box_cols * i;
              if (c >= N) break;
              if (mode == OUT_RESIDUAL)
                tma_reduce_add_2d(&map_o, obuf + i * BOX_BYTES, c, row0);
              else
                tma_store_2d(&map_o, obuf + i * BOX_BYTES, c, row0);
            }
            bulk_commit();
          }
        };
        auto bias2 = [&](int col) {
          return bias != nullptr && col < N ? *reinterpret_cast<const float2*>(bias + col)
                                            : make_float2(0.f, 0.f);
        };
        if (mode == OUT_BF16) {
#pragma unroll
          for (int ps = 0; ps < BN / BF_COLS; ++ps) {
            begin_pass();
#pragma unroll
            for (int jj = 0; jj < BF_COLS / 8; ++jj) {
              const int j = ps * (BF_COLS / 8) + jj;
              const float2 b2 = bias2(n0 + 8 * j + 2 * t4);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rr = r + 8 * h;
                const int off =
                    (jj >> 3) * BOX_BYTES + rr * 128 + (((jj & 7) ^ (rr & 7)) << 4) + t4 * 4;
                *reinterpret_cast<uint32_t*>(obuf + off) =
                    pack_bf16x2(acc[4 * j + 2 * h] + b2.x, acc[4 * j + 2 * h + 1] + b2.y);
              }
            }
            end_pass(n0 + ps * BF_COLS, BF_COLS / 64, 64);
          }
        } else {
#pragma unroll
          for (int ps = 0; ps < BN / F32_COLS; ++ps) {
            begin_pass();
#pragma unroll
            for (int jj = 0; jj < F32_COLS / 8; ++jj) {
              const int j = ps * (F32_COLS / 8) + jj;
              const float2 b2 = bias2(n0 + 8 * j + 2 * t4);
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
            end_pass(n0 + ps * F32_COLS, F32_COLS / 32, 32);
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

// the work split: LayerNorm mode keeps whole row blocks in a unit and
// splits their column tiles over the SMs the row blocks leave idle
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

int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int cols, int rows,
              int elem_bytes, int box_cols) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(cols) * elem_bytes};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), 64};
  return encode_map(map, type, 2, ptr, dims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// Rows of bf16 scratch (each K wide) that ltd_ln_gemm needs for the
// normalised rows of a LayerNorm product (0 without the prologue, or when
// xn_out is given and each row block has one unit: the rows go there).
LTD_API int ltd_ln_gemm_scratch_rows(int M, int N, int ln, int with_xn) {
  if (!ln || M < 1 || N < 1) return 0;
  int splits, per, grid;
  plan(true, M, N, &splits, &per, &grid);
  return with_xn && splits == 1 ? 0 : grid * BM;
}

// a: (M, K) float32 when ln_s/ln_b are given (LayerNorm prologue), else
// bf16. w: bf16 (N, K), or (K, N) when w_transposed is non-zero. N % 8 ==
// 0 (the maps' row strides; a ragged last column tile reads zeros and
// stores only its columns below N), K % 32 == 0, any M >= 1; every pointer
// 16-byte aligned (TMA). bias: (N,) float32 or null. Exactly one of out
// (M, N) and resid (M, N) float32 (updated in place: resid += acc + bias) is
// non-null; out is float32 when out_f32 is non-zero, else bf16. xn_out:
// (M, K) bf16 or null, the normalised rows (LayerNorm prologue only).
// scratch: ltd_ln_gemm_scratch_rows(M, N, 1, xn_out != null) rows of K
// bf16 (LayerNorm prologue only; else unused).
LTD_API int ltd_ln_gemm(const void* a, const float* ln_s, const float* ln_b, const void* w,
                        const float* bias, void* out, float* resid, void* xn_out, void* scratch,
                        int M, int N, int K, int out_f32, int w_transposed, void* stream) {
  const bool ln = ln_s != nullptr;
  if (M < 1 || N % 8 || N < 8 || K % 32 || K < 32 ||
      (!ln && xn_out != nullptr) || ((out == nullptr) == (resid == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int splits, per, grid;
  plan(ln, M, N, &splits, &per, &grid);
  // LayerNorm mode: where the normalised rows go and A is read from
  const bool rows_global = xn_out != nullptr && splits == 1;
  bf16* rows = static_cast<bf16*>(rows_global ? xn_out : scratch);
  if (ln && rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap map_a, map_w, map_o;
  int err = ln ? encode_2d(&map_a, BF, rows, K, rows_global ? M : grid * BM, 2, 64)
               : encode_2d(&map_a, BF, a, K, M, 2, 64);
  if (!err)
    err = w_transposed ? encode_2d(&map_w, BF, w, N, K, 2, 64) : encode_2d(&map_w, BF, w, K, N, 2, 64);
  int mode = resid != nullptr ? OUT_RESIDUAL : out_f32 ? OUT_F32 : OUT_BF16;
  if (!err)
    err = mode == OUT_BF16 ? encode_2d(&map_o, BF, out, N, M, 2, 64)
                           : encode_2d(&map_o, F32, resid != nullptr ? resid : out, N, M, 4, 32);
  if (err) return err;
  const void* kernel = ln ? (w_transposed ? (const void*)ln_gemm_kernel<true, true>
                                          : (const void*)ln_gemm_kernel<true, false>)
                          : (w_transposed ? (const void*)ln_gemm_kernel<false, true>
                                          : (const void*)ln_gemm_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* a32 = ln ? static_cast<const float*>(a) : nullptr;
  bf16* xn_extra = rows_global ? nullptr : static_cast<bf16*>(xn_out);
  int rg = rows_global ? 1 : 0;
  void* args[] = {&map_a, &map_w, &map_o, &a32, &ln_s, &ln_b, &bias, &rows, &rg,
                  &xn_extra, &M, &N, &K, &mode, &splits, &per};
  e = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, SMEM,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
