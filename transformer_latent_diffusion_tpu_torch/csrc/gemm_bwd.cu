// weight_grad: dW = dY^T X (float32 out), and colsum: deterministic column sums.
//
// Replace the weight-gradient products and the bias/scale sums of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
// (:176-187 dw2, db2, dw1, db1; :211 dwq; :214 dwkv; :238 dwqkv; the
// partial sums of the LayerNorm, depthwise and bias gradients). The TPU
// kernel accumulates each weight gradient in VMEM across its sequential
// batch grid. CUDA blocks run in no order, so here the reduction over the
// B*N rows is split over blocks that each keep a float32 partial, and the
// partials of an output tile are summed in a fixed order: the result does
// not depend on the schedule, and no two writers add into one element.
//
// weight_grad. dW[n, k] = sum_m dY[m, n] X[m, k], dY (M, N) and X (M, K)
// bf16 row-major (the bf16 gradient and the bf16 forward operand, as the
// TPU kernel rounds both before its product), float32 accumulation. What
// bounds it on the H100: at M = 32768 rows it does 2*N*K*M FLOP on
// 2*M*(N+K) bytes, 400-800 FLOP per byte, so the tensor cores (989 TFLOP/s
// dense bf16 at 700 W): 0.470 ms for the five products of a flagship layer
// at batch 128.
//
// What this design does about that:
// - `wgmma` m64n256k16 (bf16 in, float32 accumulators in registers) on a
//   128 x 256 output tile: two consumer warpgroups of 64 x 256, given 232
//   registers each by `setmaxnreg`. Both operands are MN-major in shared
//   memory, as stored: A = dY^T read from [m][n] tiles and B = X from
//   [m][k] tiles (the wgmma transpose flags), so nothing is transposed in
//   device memory or through registers.
// - One producer thread issues TMA loads (`cp.async.bulk.tensor`, 2-D
//   maps over the real M rows, 64 x 64 boxes, 128-byte swizzle) into a
//   ring of 4 stages of 64 rows of M (48 KB each), with full and empty
//   `mbarrier`s; the consumers keep one stage of products in flight.
//   Rows past M (M = 16, 256 + ragged), columns of dY past N and columns
//   of X past K (a ragged last output tile: N % 128 or K % 256 != 0, as at
//   the widths 64 x n_heads) arrive as zeros, so nothing needs padding;
//   the epilogue writes only the rows below N and the columns below K.
// - A persistent grid of one block per SM walks a plan made on the host
//   (ops/fused_layer_vjp.py::weight_grad_plan): the (tile, stage) space is
//   cut into at most two M-splits of each tile and dealt out stream-K
//   fashion, so every SM gets the same number of 64-row stages to within
//   one (no tail wave), and the SMs that run at once read the same rows of
//   dY and X, so L2 serves the tiles that share them. With too few stages
//   to share (the cond rows' M = 256) it deals whole tiles instead.
// - A tile cut into several segments sums them deterministically: each
//   segment writes its float32 partial to a workspace slab and bumps the
//   tile's counter; the segment that finds itself last sums the slabs in
//   segment order into its registers (the counter orders, it adds no data;
//   each thread's loads of a slab are independent, so the sum costs about
//   one L2 round trip per segment) and writes the tile. A tile of one
//   segment is written straight from the registers.
//
// colsum. out[c] = sum_r x[r, c], float32, in one launch at any R. What
// bounds it: one read of x (0.030 ms for db2's 32768 x 768 at 3.35 TB/s).
// What this design does about that:
// - A block takes 128 columns (32 threads of a float4) of a slice of
//   `slice` rows (ops/fused_layer_vjp.py::colsum_slice_rows: about 384
//   blocks a call, one wave of 3 blocks an SM, slices of at least 64
//   rows); its 8 row lanes each keep 8 independent 16-byte loads in
//   flight, summed in row order, and the lanes add in lane order.
// - A slice's sums go to a workspace row; the block that finds itself last
//   of its column tile (a counter taken after a fence) sums the slices'
//   rows, 8 runs of consecutive slices, each in slice order, then the runs
//   in order. The order depends only on R and C: two launches on the same
//   input give the same bits, and no second launch is needed.
// C % 4 != 0 (rows not 16-byte aligned) takes 4-byte loads. x may be bf16
// (the sep-conv MLP's db2 from its bf16 upstream gradient, read as it
// arrives): widened to float32 as it is read, 8-byte loads of 4 columns
// (2-byte ones where C % 4 != 0); the sums are float32 as before.

#include "hopper.cuh"

namespace {

constexpr int BN = 128;                   // output tile rows (n): two warpgroups of 64
constexpr int BK = 256;                   // output tile columns (k)
constexpr int BM = 64;                    // rows of the reduction (m) per stage
constexpr int BOX_BYTES = 64 * 64 * 2;    // one 64 x 64 bf16 TMA box
constexpr int A_BYTES = BM * BN * 2;      // dY: two boxes
constexpr int STAGE_BYTES = A_BYTES + BM * BK * 2;  // + X: four boxes (48 KB)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8 + 16;
constexpr int TILE_FLOATS = BN * BK;
constexpr int REC = 8;  // ints per plan record

// plan: blocks + 1 offsets into the records, then the records, REC ints
// each: tile row, tile column, first stage, stages, first workspace slab
// of the tile (-1: the tile has one segment), this segment's index among
// the tile's segments, the tile's segments, the tile's counter
__global__ void __launch_bounds__(THREADS, 1)
weight_grad_kernel(const __grid_constant__ CUtensorMap map_dy,
                   const __grid_constant__ CUtensorMap map_x, const int* __restrict__ plan,
                   float* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                   int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  volatile int* last = reinterpret_cast<volatile int*>(empty + STAGES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int seg_begin = plan[blockIdx.x], seg_end = plan[blockIdx.x + 1];
  const int* recs = plan + gridDim.x + 1;

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int sg = seg_begin; sg < seg_end; ++sg) {
        const int* r = recs + sg * REC;
        const int n0 = r[0] * BN, k0 = r[1] * BK, st0 = r[2], ns = r[3];
        for (int i = 0; i < ns; ++i) {
          const int m0 = (st0 + i) * BM;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* a = smem + stage * STAGE_BYTES;
          tma_load_2d(a, &map_dy, &full[stage], n0, m0);
          tma_load_2d(a + BOX_BYTES, &map_dy, &full[stage], n0 + 64, m0);
#pragma unroll
          for (int j = 0; j < BK / 64; ++j)
            tma_load_2d(a + A_BYTES + j * BOX_BYTES, &map_x, &full[stage], k0 + 64 * j, m0);
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
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BK / 2];
    for (int sg = seg_begin; sg < seg_end; ++sg) {
      const int* r = recs + sg * REC;
      const int n0 = r[0] * BN, k0 = r[1] * BK, ns = r[3];
      const int slab0 = r[4], local = r[5], nseg = r[6], tile = r[7];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      int prev = 0;
      for (int i = 0; i < ns; ++i) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a = smem + stage * STAGE_BYTES + wg * BOX_BYTES;
        const unsigned char* b = smem + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)  // 16 rows of m = 2048 bytes of each operand
          wgmma_m64n256k16_ss<1, 1>(acc, sw128_desc(a + kk * 2048, BOX_BYTES, 1024),
                                    sw128_desc(b + kk * 2048, BOX_BYTES, 1024));
        wgmma_commit();
        // the previous stage's products are done: give its buffers back
        wgmma_wait<1>();
        if (i > 0 && (tid & 127) == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if ((tid & 127) == 0) mbar_arrive(&empty[prev]);

      if (nseg > 1) {
        // the partial in the accumulators' own order (float4 v of thread t
        // at v * 256 + t); the segment that arrives last sums all of them
        float4* slabs = reinterpret_cast<float4*>(ws + static_cast<size_t>(slab0) * TILE_FLOATS);
#pragma unroll
        for (int v = 0; v < BK / 8; ++v)
          slabs[local * (TILE_FLOATS / 4) + v * 256 + tid] =
              make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
        __threadfence();
        named_barrier(1, CONSUMERS * 128);
        if (tid == 0) *last = atomicAdd(&counters[tile], 1) == nseg - 1;
        named_barrier(1, CONSUMERS * 128);
        if (!*last) continue;
        __threadfence();
        // in segment order, whichever segment this is: ((0 + p0) + p1) + ...;
        // each slab's 32 loads of a thread are independent
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) acc[i] = 0.f;
        for (int q = 0; q < nseg; ++q) {
#pragma unroll
          for (int v = 0; v < BK / 8; ++v) {
            const float4 u = __ldcg(slabs + q * (TILE_FLOATS / 4) + v * 256 + tid);
            acc[4 * v] += u.x;
            acc[4 * v + 1] += u.y;
            acc[4 * v + 2] += u.z;
            acc[4 * v + 3] += u.w;
          }
        }
      }
      // this thread's output rows n and n + 8, columns k0 + 8j + 2 t4 (+1)
      const int n = n0 + wg * 64 + ((tid & 127) >> 5) * 16 + g;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int k = k0 + 8 * j + 2 * t4;  // K % 8 == 0: k + 1 < K too
        if (k < K) {
          if (n < N)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(n) * K + k) =
                make_float2(acc[4 * j], acc[4 * j + 1]);
          if (n + 8 < N)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(n + 8) * K + k) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

constexpr int CS_THREADS = 256;
constexpr int CS_VCOLS = 32;                      // float4 columns per block
constexpr int CS_LANES = CS_THREADS / CS_VCOLS;  // row lanes
constexpr int CS_DEPTH = 8;                       // loads in flight per lane

// one float32 of x: streamed from device memory (x, read once), or from L2
// (the slices' sums, which other blocks of this launch wrote)
template <bool FROM_L2>
__device__ __forceinline__ float cs_ld(const float* p) {
  return FROM_L2 ? __ldcg(p) : __ldcs(p);
}
template <bool FROM_L2>
__device__ __forceinline__ float4 cs_ld(const float4* p) {
  return FROM_L2 ? __ldcg(p) : __ldcs(p);
}

// x[r, c .. c + 3] as float32, zero past R or C
template <bool FROM_L2>
__device__ __forceinline__ float4 cs_load(const float* x, int r, int R, int c, int C, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= R) return v;
  const float* p = x + static_cast<size_t>(r) * C + c;
  if (vec) {
    if (c < C) v = cs_ld<FROM_L2>(reinterpret_cast<const float4*>(p));
  } else {
    if (c < C) v.x = cs_ld<FROM_L2>(p);
    if (c + 1 < C) v.y = cs_ld<FROM_L2>(p + 1);
    if (c + 2 < C) v.z = cs_ld<FROM_L2>(p + 2);
    if (c + 3 < C) v.w = cs_ld<FROM_L2>(p + 3);
  }
  return v;
}

// the same for bf16 rows (streamed from device memory), widened exactly
template <bool FROM_L2>
__device__ __forceinline__ float4 cs_load(const bf16* x, int r, int R, int c, int C, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= R) return v;
  const bf16* p = x + static_cast<size_t>(r) * C + c;
  if (vec) {
    if (c < C) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
      v = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    }
  } else {
    if (c < C) v.x = __bfloat162float(p[0]);
    if (c + 1 < C) v.y = __bfloat162float(p[1]);
    if (c + 2 < C) v.z = __bfloat162float(p[2]);
    if (c + 3 < C) v.w = __bfloat162float(p[3]);
  }
  return v;
}

__device__ __forceinline__ void cs_add(float4& s, const float4& v) {
  s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
}

__device__ __forceinline__ void cs_store(float* p, int c, int C, bool vec, const float4& v) {
  if (vec) {
    if (c < C) *reinterpret_cast<float4*>(p) = v;
  } else {
    if (c < C) p[0] = v.x;
    if (c + 1 < C) p[1] = v.y;
    if (c + 2 < C) p[2] = v.z;
    if (c + 3 < C) p[3] = v.w;
  }
}

// blockIdx.x: the column tile of 128 columns; blockIdx.y: the slice of
// rows; T: x's type (float32, or bf16)
template <typename T>
__global__ void __launch_bounds__(CS_THREADS)
colsum_kernel(const T* __restrict__ x, float* __restrict__ out, float* __restrict__ ws,
              int* __restrict__ counters, int R, int C, int slice, bool vec) {
  __shared__ float4 part[CS_LANES][CS_VCOLS];
  __shared__ int last;
  const int vc = threadIdx.x % CS_VCOLS, lane = threadIdx.x / CS_VCOLS;
  const int c = (blockIdx.x * CS_VCOLS + vc) * 4;
  const int slices = gridDim.y;
  const int r1 = min(R, static_cast<int>(blockIdx.y + 1) * slice);
  // rows r0 + lane, r0 + lane + 8, ... of the slice, in order
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.y * slice + lane; r < r1; r += CS_LANES * CS_DEPTH) {
    float4 v[CS_DEPTH];
#pragma unroll
    for (int i = 0; i < CS_DEPTH; ++i) v[i] = cs_load<false>(x, r + i * CS_LANES, r1, c, C, vec);
#pragma unroll
    for (int i = 0; i < CS_DEPTH; ++i) cs_add(s, v[i]);
  }
  part[lane][vc] = s;
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int l = 1; l < CS_LANES; ++l) cs_add(s, part[l][vc]);
    cs_store(ws + static_cast<size_t>(blockIdx.y) * C + c, c, C, vec, s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // lane l: slices [l * slices / 8, (l + 1) * slices / 8) in order, with
  // CS_DEPTH loads in flight
  s = make_float4(0.f, 0.f, 0.f, 0.f);
  const int q1 = (lane + 1) * slices / CS_LANES;
  for (int q = lane * slices / CS_LANES; q < q1; q += CS_DEPTH) {
    float4 v[CS_DEPTH];
#pragma unroll
    for (int i = 0; i < CS_DEPTH; ++i) v[i] = cs_load<true>(ws, q + i, q1, c, C, vec);
#pragma unroll
    for (int i = 0; i < CS_DEPTH; ++i) cs_add(s, v[i]);
  }
  part[lane][vc] = s;
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int l = 1; l < CS_LANES; ++l) cs_add(s, part[l][vc]);
    cs_store(out + c, c, C, vec, s);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // as the next launch expects it
}

}  // namespace

// dy: (M, N) bf16; x: (M, K) bf16; out: (N, K) float32. plan: the int32
// plan of `blocks` blocks (see weight_grad_kernel) in device memory; ws:
// float32 workspace of 128 x 256 floats per slab the plan names; counters:
// one int32 per output tile, zero. Requires N % 8 == 0 and K % 8 == 0
// (the maps' row strides) and 16-byte aligned dy and x (TMA).
LTD_API int ltd_weight_grad(const void* dy, const void* x, float* out, float* ws, int* counters,
                            const int* plan, int M, int N, int K, int blocks, void* stream) {
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_dy, map_x;
  const uint32_t box[2] = {64, BM};
  const uint64_t ddims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
  const uint64_t dstride[1] = {static_cast<uint64_t>(N) * 2};
  const uint64_t xdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t xstride[1] = {static_cast<uint64_t>(K) * 2};
  int err = encode_map(&map_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dy, ddims, dstride, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = encode_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  weight_grad_kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_dy, map_x, plan, out, ws, counters, N, K);
  return static_cast<int>(cudaGetLastError());
}

// x: (R, C) float32, or bf16 when x_bf16 is non-zero; out: (C,) float32,
// the column sums. slice: rows per block, a multiple of 8; ws: (ceil(R /
// slice), C) float32 workspace; counters: ceil(C / 128) int32, zero, and
// left zero.
LTD_API int ltd_colsum(const void* x, float* out, float* ws, int* counters, int R, int C,
                       int slice, int x_bf16, void* stream) {
  if (R < 1 || C < 1 || slice < CS_LANES || slice % CS_LANES || (R - 1) / slice >= 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + 4 * CS_VCOLS - 1) / (4 * CS_VCOLS), (R + slice - 1) / slice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    colsum_kernel<bf16><<<grid, CS_THREADS, 0, s>>>(static_cast<const bf16*>(x), out, ws,
                                                    counters, R, C, slice, C % 4 == 0);
  else
    colsum_kernel<float><<<grid, CS_THREADS, 0, s>>>(static_cast<const float*>(x), out, ws,
                                                     counters, R, C, slice, C % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}
