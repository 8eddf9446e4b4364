// gemm_i8: C = dequant(A_q @ W_q^T) on the int8 tensor cores, with a bf16,
// a float32 + bias, or an in-place residual epilogue.
//
// Replaces the four W8A8 products of
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel
// (`_qmm` = `_mm_i8` and its dequantization, :56-66): LN1 -> QKV (768 ->
// 2304) and LN2 -> Q (768 -> 768), both rounded to bf16 (:81, 86); LN3 ->
// expand (768 -> 3072) + b1, kept float32 (:92-93); GELU -> contract
// (3072 -> 768), added with b2 into the residual (:99-100). A_q and its
// per-row scales come from this kernel's LayerNorm prologue (the LN
// products, below) or from dwconv_gelu.cu's dwconv_gelu_q8 (the
// contract); W_q and its per-output-channel scales from
// ops/fused_stack_int8.py::pack_layer_stack_int8.
//
// What it computes: acc = sum_k A_q[m, k] * W_q[n, k] in int32 (exact),
// then deq = (float(acc) * rs[m]) * cs[n] with each product rounded
// (`__fmul_rn`), as the TPU kernel's `acc.astype(f32) * rs * cs`. Then one
// of: bf16(deq [+ bias]); float32 deq [+ bias]; or, in place,
// resid = (resid + deq) [+ bias] (`__fadd_rn`; the TPU kernel's
// `x + deq + b2`). No FMA contraction is possible in the epilogue, so on
// the same int8 operands the kernel gives the plain version's result
// (ops/fused_stack_int8.py::gemm_i8_plain) bit for bit, and each output
// element has one writer, so two launches are bit-equal.
//
// What bounds it on the H100: at M = B*N = 16384 rows these products do
// ~360 to ~650 operations per byte they must move, around the int8 ridge
// of ~590 (1979 TOPS dense at 700 W over 3.35 TB/s): the QKV product is
// bound by the tensor cores; the expand product's float32 output (201 MB)
// and the contract product's float32 residual (read and written) make the
// others bound by bytes. The four together: 0.149 ms of bytes, 0.117 ms of
// operations. So the operand loads must hide behind the multiplies, and
// the stores behind the next tile's multiplies.
//
// What this design does about that: ln_gemm.cu's pipeline with the 8-bit
// `wgmma` (wgmma.mma_async m64n256k32 .s32.s8.s8), a 128 x 256 output tile.
// - The 8-bit forms take K-major operands only, which is how both are
//   stored: the activations (M, K) and the packed weights (N, K). So
//   nothing is re-laid out. A k-tile row of 128 int8 is one 128-byte
//   swizzle atom: one producer thread issues TMA loads of 64-row x 128-byte
//   boxes (A's 128 rows, W's 256) into a ring of four 48 KB stages with
//   full and empty `mbarrier`s; each stage feeds four k32 products of each
//   of the two consumer warpgroups (64 rows each, int32 accumulators in
//   128 registers a thread; `setmaxnreg` 232, the producer's warpgroup 40),
//   which keep one stage of products in flight. Rows past M, W rows past N
//   (a ragged last column tile, N % 256 != 0, as at the widths 64 x
//   n_heads) and columns past K arrive as zeros and add nothing.
// - A persistent grid (one block per SM) walks the output tiles in
//   row-major order (column tile fastest): the SMs that run at once share
//   each A row block, and W (at most 2.4 MB) stays in L2.
// - The epilogue, a template flag per mode, scales the accumulators in
//   registers (deq = (float(acc) * rs) * cs) and leaves through a 16 KB
//   staging buffer per warpgroup in the output map's 128-byte swizzle:
//   bf16 or float32 outputs by TMA stores (the warpgroup goes on to its
//   next tile's products while they drain); the residual in passes of 32
//   columns through the buffer's two halves, each pass's residual box
//   brought in by TMA (the first two while the tile's products run, the
//   tile's rows also asked of L2 then, each later one as soon as the store
//   two passes back has read its half), added into in place by the thread
//   that owns the element, (resid + deq) + b2 in the TPU kernel's order (a
//   TMA reduce-add would compute resid + (deq + b2)), and stored by TMA.
//   One writer per element; no split-K. Rows past M and columns past N
//   are clipped by the maps. (An epilogue that loaded the residual into
//   registers, even batched and asked of L2 ahead, stalled each
//   warpgroup on the loads: on an H100 it was the contract product's
//   largest cost.)
//
// LayerNorm mode (`ltd_ln_gemm_i8`, the LN1 -> QKV, LN2 -> Q and LN3 ->
// expand products): A is the float32 residual, and the kernel takes LN1-3
// and their per-row quantization in a prologue, in place of a rowquant.cu
// launch. All 12 warps of every block first quantize rows of the whole
// batch, a row a warp at a time, rowquant.cu's arithmetic and summation
// order (quant_row.cuh: one warp a row, lane-strided float4s in
// registers), so the int8 rows and scales are rowquant's bit for bit, into
// an L2-resident scratch (12.6 MB at M = 16384, K = 768) and its scales;
// a grid-wide barrier (every block of the persistent grid is resident: one
// a SM) then lets the plain mode's persistent tile walk run unchanged on
// them. So the products keep the plain mode's tile order, in which the
// SMs that run at once share each A row block.
// What was tried first, after ln_gemm.cu's LayerNorm mode (on an H100,
// NVIDIA H100 80GB HBM3): a unit of a row block and all its column tiles,
// its rows quantized by the consumer warpgroups before its products. At
// one unit an SM the prologue was not overlapped (~50 us where its bytes
// take ~15), its registers made ptxas spill the products' (the consumers
// are compiled for the launch bounds' 168), and an SM walking one row
// block's 12 expand tiles took ~30 us longer than the plain tile order:
// 0.41-0.50 ms for the three products against 0.33-0.35 for rowquant and
// gemm_i8.

#include "hopper.cuh"
#include "quant_row.cuh"

namespace {

constexpr int BM = 128;                  // output tile rows: two warpgroups of 64
constexpr int BN = 256;                  // output tile columns
constexpr int BK = 128;                  // K per stage: one 128-byte swizzled row of int8
constexpr int BOX_BYTES = 64 * BK;       // one 64-row x 128-byte TMA box
constexpr int A_BYTES = 2 * BOX_BYTES;   // A's 128 x 128 of a stage
constexpr int STAGE_BYTES = A_BYTES + BN / 64 * BOX_BYTES;  // + W's 256 x 128
constexpr int STAGES = 4;
// a warpgroup's output staging (16 KB): passes of 64 rows x BF_COLS bf16
// or F32_COLS float32 columns, in the output map's 128-byte swizzle
constexpr int OUT_BYTES = 64 * 64 * 4;
constexpr int BF_COLS = OUT_BYTES / 128;
constexpr int F32_COLS = OUT_BYTES / 256;
constexpr int OUT_BOX = 64 * 128;  // one 64-row x 128-byte box of the staging
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int RES_COLS = 32;  // the residual mode's pass: one 64 x 32 float32 box, two in flight
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + (2 * STAGES + 4) * 8;
constexpr int LN_VEC = 8;  // float4s a lane holds of a LayerNorm row: K <= 1024 in registers

enum Out { OUT_BF16 = 0, OUT_F32 = 1, OUT_RESIDUAL = 2 };

// Every block of the grid waits here until all have arrived (the grid is
// resident at once: one block an SM, at most one per SM, launched
// cooperatively, so a grid that could not be resident is refused).
// sync[0] counts the arrivals, sync[1] the departures; the last to leave
// sets both back to zero, so the next launch on the stream finds them so.
// The writes before it (generic stores) are visible after it to every
// block, TMA loads (the async proxy) included.
__device__ __forceinline__ void grid_sync(unsigned* sync) {
  fence_proxy_async_global();
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&sync[0], 1u);
    while (atomicAdd(&sync[0], 0u) < gridDim.x) __nanosleep(100);
    __threadfence();
    if (atomicAdd(&sync[1], 1u) + 1 == gridDim.x) {
      atomicExch(&sync[0], 0u);
      atomicExch(&sync[1], 0u);
    }
  }
  __syncthreads();
  fence_proxy_async_global();
}

// The LayerNorm mode's prologue: LN(x) and the per-row quantization of
// rows of the whole batch by every warp of the grid (row w of each warp w
// of the grid's, then the grid's next rows), one row at a time, the warp's
// next row asked of L2 while this one is quantized; rowquant.cu's
// arithmetic and order (quant_row.cuh). Its own function, not inlined:
// ptxas compiles the kernel for the launch bounds' 168 registers, and
// inlined (one row or two a warp, the row held in 4 to 8 float4s) it made
// the bf16 product's registers spill. On an H100 at M = 16384, K = 768 it
// takes ~36 us (the inlined, spilling form ~27; two rows a warp at a time
// ~41).
__device__ __noinline__ void ln_prologue(const float* __restrict__ a32,
                                         const float* __restrict__ ln_s,
                                         const float* __restrict__ ln_b,
                                         int8_t* __restrict__ rows, float* rs_out, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (THREADS / 32);
  for (int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5); r < M; r += warps) {
    if (lane == 0 && r + warps < M)
      prefetch_l2(a32 + static_cast<size_t>(r + warps) * K, K * 4);
    uint32_t* q = reinterpret_cast<uint32_t*>(rows + static_cast<size_t>(r) * K);
    const float rs = qrow::quant_row<LN_VEC>(a32 + static_cast<size_t>(r) * K, ln_s, ln_b, q, K,
                                             lane);
    if (lane == 0) rs_out[r] = rs;
  }
}

// LN: a32 (M, K) float32 rows and the LayerNorm's ln_s, ln_b are quantized
// into `rows` (M, K) int8, which map_a reads, and rs_out (M,), which is
// rs; sync: two counters, zero.
template <int MODE, bool LN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_i8_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_o, const float* rs,
               const float* __restrict__ cs, const float* __restrict__ bias,
               float* __restrict__ resid, const float* __restrict__ a32,
               const float* __restrict__ ln_s, const float* __restrict__ ln_b,
               int8_t* __restrict__ rows, float* rs_out, unsigned* sync, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* stage_out = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* res_full = empty + STAGES;  // per warpgroup, per half of its staging
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int i = 0; i < 4; ++i) mbar_init(&res_full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if constexpr (LN) {
    ln_prologue(a32, ln_s, ln_b, rows, rs_out, M, K);
    grid_sync(sync);
  }
  const int nk = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN;
  const int units = ((M + BM - 1) / BM) * n_tiles;

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u / n_tiles) * BM, n0 = (u % n_tiles) * BN;
        for (int kc = 0; kc < nk; ++kc) {
          const int k0 = kc * BK;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* st = ring + stage * STAGE_BYTES;
          tma_load_2d(st, &map_a, &full[stage], k0, m0);
          tma_load_2d(st + BOX_BYTES, &map_a, &full[stage], k0, m0 + 64);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)  // box j: W rows n0 + 64 j ..
            tma_load_2d(st + A_BYTES + j * BOX_BYTES, &map_w, &full[stage], k0, n0 + 64 * j);
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
    unsigned char* obuf = stage_out + wg * OUT_BYTES;
    const int r = (wt >> 5) * 16 + g;  // this thread's rows r, r + 8 of the warpgroup's 64
    int stage = 0;
    uint32_t phase = 0, res_phase[2] = {0, 0};
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u / n_tiles) * BM, n0 = (u % n_tiles) * BN;
      const int row0 = m0 + wg * 64;
      // the residual mode's passes over this tile, and where its rows' staging is loaded
      const int res_passes = (min(BN, N - n0) + RES_COLS - 1) / RES_COLS;
      auto load_res = [&](int p) {  // pass p's residual box into half p % 2 of the staging
        uint64_t* bar = &res_full[2 * wg + (p & 1)];
        mbar_arrive_expect_tx(bar, OUT_BOX);
        tma_load_2d(obuf + (p & 1) * OUT_BOX, &map_o, bar, n0 + RES_COLS * p, row0);
      };
      if (MODE == OUT_RESIDUAL && row0 < M) {
        // the tile's residual rows into L2 while the products run (this
        // thread's two rows, 1 KB each), and its first two passes' boxes
        // into the staging, once the last tile's stores have read it
        if (t4 == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + r + 8 * h;
            if (row < M)
              prefetch_l2(resid + static_cast<size_t>(row) * N + n0, 4 * min(BN, N - n0));
          }
        }
        if (wt == 0) {
          bulk_wait_read();
          for (int p = 0; p < min(2, res_passes); ++p) load_res(p);
        }
      }
      int acc[BN / 2];  // the first product of the tile overwrites it
      int prev = 0;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a = ring + stage * STAGE_BYTES + wg * BOX_BYTES;
        const unsigned char* w = ring + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint32_t keep = kc > 0 || kk > 0;  // the first product overwrites acc
          wgmma_m64n256k32_s8(acc, sw128_desc(a + kk * 32, 16, 1024),
                              sw128_desc(w + kk * 32, 16, 1024), keep);
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

      // epilogue. Thread t holds rows r, r + 8 and columns 8 j + 2 t4 (+1)
      // of the warpgroup's 64 x BN, acc[4 j + 2 h + e]: deq = (float(acc)
      // * rs) * cs, each product rounded
      float rv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rv[h] = row0 + r + 8 * h < M ? rs[row0 + r + 8 * h] : 0.f;
      auto scale2 = [&](int col) {  // cs at col, col + 1 (zero past N)
        return col < N ? *reinterpret_cast<const float2*>(cs + col) : make_float2(0.f, 0.f);
      };
      auto bias2 = [&](int col) {
        return bias != nullptr && col < N ? *reinterpret_cast<const float2*>(bias + col)
                                          : make_float2(0.f, 0.f);
      };
      auto deq = [&](int j, int h, float2 c2) {
        return make_float2(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), rv[h]), c2.x),
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), rv[h]), c2.y));
      };
      if constexpr (MODE == OUT_RESIDUAL) {
        // resid = (resid + deq) + bias in passes of 32 columns through the
        // staging's two halves: pass p's box arrived by TMA (issued two
        // passes back, or before the products), each thread adds into its
        // own elements in place, the box leaves by a TMA store, and once
        // that store has read the half, pass p + 2's box is loaded into it
        if (row0 < M) {
#pragma unroll
          for (int p = 0; p < BN / RES_COLS; ++p) {
            if (p >= res_passes) break;
            unsigned char* half = obuf + (p & 1) * OUT_BOX;
            mbar_wait(&res_full[2 * wg + (p & 1)], res_phase[p & 1]);
            res_phase[p & 1] ^= 1;
#pragma unroll
            for (int jj = 0; jj < RES_COLS / 8; ++jj) {
              const int cc = 8 * jj + 2 * t4;  // column within the box
              const int col = n0 + RES_COLS * p + cc;
              const float2 c2 = scale2(col), b2 = bias2(col);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rr = r + 8 * h;
                const int off = rr * 128 + (((cc >> 2) ^ (rr & 7)) << 4) + (cc & 3) * 4;
                float2* at = reinterpret_cast<float2*>(half + off);
                const float2 v = deq((RES_COLS / 8) * p + jj, h, c2);
                float2 y = make_float2(__fadd_rn(at->x, v.x), __fadd_rn(at->y, v.y));
                if (bias != nullptr) y = make_float2(__fadd_rn(y.x, b2.x), __fadd_rn(y.y, b2.y));
                *at = y;
              }
            }
            fence_proxy_async();
            named_barrier(1 + wg, 128);
            if (wt == 0) {
              tma_store_2d(&map_o, half, n0 + RES_COLS * p, row0);
              bulk_commit();
              if (p + 2 < res_passes) {
                bulk_wait_read();
                load_res(p + 2);
              }
            }
          }
        }
      } else {
        // staged in shared memory in the output map's 128-byte swizzle
        // (16-byte chunk c of row rr at c ^ (rr % 8)), once the previous
        // store has read the buffer, then one TMA store per box; rows past
        // M and columns past N are clipped by the map
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
              tma_store_2d(&map_o, obuf + i * OUT_BOX, c, row0);
            }
            bulk_commit();
          }
        };
        auto value = [&](int j, int h) {  // deq (+ bias) at columns 8 j + 2 t4 (+1)
          const int col = n0 + 8 * j + 2 * t4;
          float2 v = deq(j, h, scale2(col));
          if (bias != nullptr) {
            const float2 b2 = bias2(col);
            v = make_float2(__fadd_rn(v.x, b2.x), __fadd_rn(v.y, b2.y));
          }
          return v;
        };
        if constexpr (MODE == OUT_BF16) {
#pragma unroll
          for (int ps = 0; ps < BN / BF_COLS; ++ps) {
            begin_pass();
#pragma unroll
            for (int jj = 0; jj < BF_COLS / 8; ++jj) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rr = r + 8 * h;
                const float2 v = value(ps * (BF_COLS / 8) + jj, h);
                const int off = (jj >> 3) * OUT_BOX + rr * 128 +
                                (((jj & 7) ^ (rr & 7)) << 4) + t4 * 4;
                *reinterpret_cast<uint32_t*>(obuf + off) = pack_bf16x2(v.x, v.y);
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
              const int cc = 8 * (jj & 3) + 2 * t4;  // column within the 32-wide box jj / 4
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rr = r + 8 * h;
                const float2 v = value(ps * (F32_COLS / 8) + jj, h);
                const int off = (jj >> 2) * OUT_BOX + rr * 128 +
                                (((cc >> 2) ^ (rr & 7)) << 4) + (cc & 3) * 4;
                *reinterpret_cast<float2*>(obuf + off) = v;
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

// a row-major (rows, cols) output of elem_bytes, 64-row boxes of
// box_cols (128 bytes), 128-byte swizzle
int encode_out(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int cols, int rows,
               int elem_bytes, int box_cols) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(cols) * elem_bytes};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), 64};
  return encode_map(map, type, 2, ptr, dims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

int encode_i8(CUtensorMap* map, const void* ptr, int cols, int rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(cols)};
  const uint32_t box[2] = {BK, 64};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims, stride, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The maps of a, w and the output, then the launch (LN: a is the scratch
// the prologue fills from a32)
int launch(const void* a, const float* rs, const void* w, const float* cs, const float* bias,
           void* out, float* resid, const float* a32, const float* ln_s, const float* ln_b,
           float* rs_out, unsigned* sync, int M, int N, int K, int out_f32, cudaStream_t stream) {
  const bool ln = a32 != nullptr;
  CUtensorMap map_a, map_w, map_o;
  const int mode = resid != nullptr ? OUT_RESIDUAL : out_f32 ? OUT_F32 : OUT_BF16;
  int err = encode_i8(&map_a, a, K, M);
  if (!err) err = encode_i8(&map_w, w, K, N);
  if (!err && mode == OUT_BF16)
    err = encode_out(&map_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N, M, 2, 64);
  else if (!err)  // float32 out, or the residual read and written through it
    err = encode_out(&map_o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, mode == OUT_F32 ? out : resid, N,
                     M, 4, 32);
  if (err) return err;
  const void* kernel =
      ln ? (mode == OUT_F32 ? (const void*)gemm_i8_kernel<OUT_F32, true>
                            : (const void*)gemm_i8_kernel<OUT_BF16, true>)
         : (mode == OUT_RESIDUAL ? (const void*)gemm_i8_kernel<OUT_RESIDUAL, false>
            : mode == OUT_F32    ? (const void*)gemm_i8_kernel<OUT_F32, false>
                                 : (const void*)gemm_i8_kernel<OUT_BF16, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int units = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = units < sm_count() ? units : sm_count();
  int8_t* rows = ln ? static_cast<int8_t*>(const_cast<void*>(a)) : nullptr;
  void* args[] = {&map_a, &map_w, &map_o, &rs, &cs, &bias, &resid, &a32, &ln_s, &ln_b,
                  &rows, &rs_out, &sync, &M, &N, &K};
  // the LayerNorm mode's grid_sync needs every block resident at once: a
  // cooperative launch refuses a grid that cannot be (an error, not a hang)
  e = ln ? cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), args, SMEM, stream)
         : cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, SMEM, stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// a: (M, K) int8 rows, rs: (M,) float32 row scales. w: (N, K) int8 (the
// (out, in) layout), cs: (N,) float32 per-output-channel scales. bias: (N,)
// float32 or null. Exactly one of out (M, N) and resid (M, N) float32
// (updated in place) is non-null; out is float32 when out_f32 is non-zero,
// else bf16. Requires N % 16 == 0 and K % 16 == 0 (the TMA maps' row
// strides), any M >= 1; a and w 16-byte aligned.
LTD_API int ltd_gemm_i8(const void* a, const float* rs, const void* w, const float* cs,
                        const float* bias, void* out, float* resid, int M, int N, int K,
                        int out_f32, void* stream) {
  if (M < 1 || N < 16 || K < 16 || N % 16 || K % 16 || (out == nullptr) == (resid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, rs, w, cs, bias, out, resid, nullptr, nullptr, nullptr, nullptr, nullptr, M,
                N, K, out_f32, static_cast<cudaStream_t>(stream));
}

// LN(x) quantized per row, then the int8 product, in one launch: what
// ltd_rowquant(x, ln_s, ln_b) then ltd_gemm_i8 on its rows give, bit for
// bit. x: (M, K) float32; ln_s, ln_b: (K,) float32. w, cs, bias, out and
// out_f32 as ltd_gemm_i8's (no residual). scratch: (M, K) int8 and rs:
// (M,) float32, the quantized rows and their scales (written). sync: two
// unsigned counters, zero (left zero). Requires N % 16 == 0 and K % 16 ==
// 0, any M >= 1; every pointer 16-byte aligned.
LTD_API int ltd_ln_gemm_i8(const float* x, const float* ln_s, const float* ln_b, const void* w,
                           const float* cs, const float* bias, void* out, void* scratch,
                           float* rs, unsigned* sync, int M, int N, int K, int out_f32,
                           void* stream) {
  if (M < 1 || N < 16 || K < 16 || N % 16 || K % 16 || x == nullptr || ln_s == nullptr ||
      ln_b == nullptr || out == nullptr || scratch == nullptr || rs == nullptr || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(scratch, rs, w, cs, bias, out, nullptr, x, ln_s, ln_b, rs, sync, M, N, K,
                out_f32, static_cast<cudaStream_t>(stream));
}
