// weight_grad_f32: dW = dY^T X with float32 operands at float32 accuracy on
// the tensor cores (3xTF32 wgmma): the float32 form of gemm_bwd.cu's
// weight_grad.
//
// Replaces the weight-gradient products of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
// (:176-187 dw2, dw1; :211 dwq; :214 dwkv; :238 dwqkv) and of
// transformer_latent_diffusion_tpu/ops/fused_attn_vjp.py::_bwd_kernel when
// the weights, and so `mxu`, are float32 (TrainConfig(compute_dtype=
// "float32")): float32 dY and X, float32 accumulation.
//
// What bounds it on the H100: operations. At M = 32768 rows (B*N) it does
// 2 N K M FLOP on 4 M (N + K) bytes, 550-1100 FLOP per byte; three TF32
// products per float32 one (495 TFLOP/s dense TF32 at 700 W: 165 TFLOP/s
// of float32-accurate work), 1.40 ms for the five products of a flagship
// layer at batch 128.
//
// What this design does about that:
// - The output is cut into 128 x 128 tiles (rows n of dY's columns,
//   columns k of X's), the M rows into stages of 32. The reduction runs
//   over M, so both operands arrive M-major: one producer thread brings a
//   stage's 32 x 128 of dY and of X by TMA as stored (unswizzled boxes,
//   rows past M and columns past N or K as zeros) into a ring of 3 stages
//   of 64 KB. The splitter warps (warps 1-3 of the producer warpgroup)
//   write X's tile transposed into its TF32 hi and lo parts
//   (f32_tile.cuh), the K-major B operand; the two consumer warpgroups read
//   their A fragments (4 floats of dY^T per 8-wide step) straight from dY's
//   raw tile (4-way bank conflicts on 4 loads a step, cheap beside the
//   products) and split them in registers.
// - Each stage's 12 products (4 steps of lo B_hi, hi B_lo, hi B_hi
//   m64n128k8) go into a fresh partial that is added into the tile's
//   float32 sum with ordinary rounding, as ln_gemm_f32.cu does: a chain of
//   1024 tensor-core additions over M = 32768 would drift.
// - The walk is gemm_bwd.cu's: a persistent grid follows the plan made on
//   the host (ops/fused_layer_vjp.py::weight_grad_plan with this kernel's
//   tile and stage), stream-K over (tile, stage) in at most two M-splits
//   of a tile, or whole tiles where the stages are few (dWkv's M = 2B);
//   a tile of several segments writes each segment's float32 partial to a
//   workspace slab and the segment that arrives last sums the slabs in
//   segment order. Every sum runs in an order fixed by the shapes: two
//   launches are bit-equal.

#include "f32_tile.cuh"

namespace {

constexpr int BN = f32tile::ROWS;        // output tile rows (n): two warpgroups of 64
constexpr int BK = 128;                  // output tile columns (k)
constexpr int BM = f32tile::DEPTH;       // rows of the reduction (m) per stage
constexpr int TILE_BYTES = f32tile::TILE_BYTES;
// a stage: dY's raw tile, X's raw tile, X's hi and lo parts
constexpr int STAGE_BYTES = 4 * TILE_BYTES;
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8 + 16;
constexpr int TILE_FLOATS = BN * BK;
constexpr int REC = 8;  // ints per plan record (gemm_bwd.cu's)

__global__ void __launch_bounds__(THREADS, 1)
weight_grad_f32_kernel(const __grid_constant__ CUtensorMap map_dy,
                       const __grid_constant__ CUtensorMap map_x, const int* __restrict__ plan,
                       float* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ counters, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* split = full + STAGES;
  uint64_t* empty = split + STAGES;
  volatile int* last = reinterpret_cast<volatile int*>(empty + STAGES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&split[s], f32tile::SPLITTERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int seg_begin = plan[blockIdx.x], seg_end = plan[blockIdx.x + 1];
  const int* recs = plan + gridDim.x + 1;

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    const int pt = tid - CONSUMERS * 128;
    int stage = 0;
    uint32_t phase = 0;
    if (pt == 0) {
      for (int sg = seg_begin; sg < seg_end; ++sg) {
        const int* r = recs + sg * REC;
        const int n0 = r[0] * BN, k0 = r[1] * BK, st0 = r[2], ns = r[3];
        for (int i = 0; i < ns; ++i) {
          const int m0 = (st0 + i) * BM;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], 2 * TILE_BYTES);
          unsigned char* st = smem + stage * STAGE_BYTES;
          tma_load_2d(st, &map_dy, &full[stage], n0, m0);
          tma_load_2d(st + TILE_BYTES, &map_x, &full[stage], k0, m0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (pt >= 32) {
      const int sid = pt - 32;
      int steps = 0;
      for (int sg = seg_begin; sg < seg_end; ++sg) steps += recs[sg * REC + 3];
      for (int it = 0; it < steps; ++it) {
        mbar_wait(&full[stage], phase);
        unsigned char* st = smem + stage * STAGE_BYTES;
        f32tile::split_transposed(reinterpret_cast<const float*>(st + TILE_BYTES),
                                  st + 2 * TILE_BYTES, st + 3 * TILE_BYTES, sid);
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
    int stage = 0;
    uint32_t phase = 0;
    float acc[BK / 2];
    for (int sg = seg_begin; sg < seg_end; ++sg) {
      const int* rec = recs + sg * REC;
      const int n0 = rec[0] * BN, k0 = rec[1] * BK, ns = rec[3];
      const int slab0 = rec[4], local = rec[5], nseg = rec[6], tile = rec[7];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) acc[i] = 0.f;
      for (int i = 0; i < ns; ++i) {
        mbar_wait(&full[stage], phase);   // dY has landed
        mbar_wait(&split[stage], phase);  // X's parts are written
        const unsigned char* st = smem + stage * STAGE_BYTES;
        // dY^T's rows r, r + 8 of this warpgroup: column wg * 64 + r of dY's raw tile
        const float* a = reinterpret_cast<const float*>(st) + wg * 64 + r;
        const unsigned char* bh = st + 2 * TILE_BYTES;
        const unsigned char* bl = st + 3 * TILE_BYTES;
        float part[BK / 2];  // the first product of the stage overwrites it
        uint32_t fh[2][4], fl[2][4];
#pragma unroll
        for (int kk = 0; kk < BM / 8; ++kk) {
          const int b = kk & 1;
          // m = 8 kk + t4 and + 4 of rows r, r + 8
          const float* p0 = a + (8 * kk + t4) * BN;
          const float* p1 = p0 + 4 * BN;
          const float x[4] = {p0[0], p0[8], p1[0], p1[8]};
          tf32_frag(x, fh[b], fl[b]);
          wgmma_fence();
          const uint64_t dh = sw128_desc(bh + kk * 32, 16, 1024);
          const uint64_t dl = sw128_desc(bl + kk * 32, 16, 1024);
          wgmma_m64n128k8_tf32_rs(part, fl[b], dh, kk > 0);
          wgmma_m64n128k8_tf32_rs(part, fh[b], dl, 1);
          wgmma_m64n128k8_tf32_rs(part, fh[b], dh, 1);
          wgmma_commit();
          // the previous step's products are done: its fragments may be rewritten
          if (kk == BM / 8 - 1) {
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
        for (int j = 0; j < BK / 2; ++j) acc[j] += part[j];
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

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
        // in segment order, whichever segment this is: ((0 + p0) + p1) + ...
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) acc[j] = 0.f;
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
      const int n = n0 + wg * 64 + r;
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

}  // namespace

// dy: (M, N) float32; x: (M, K) float32; out: (N, K) float32. plan: the
// int32 plan of `blocks` blocks (gemm_bwd.cu's records) for 128 x 128
// tiles and stages of 32 rows, in device memory; ws: float32 workspace of
// 128 x 128 floats per slab the plan names; counters: one int32 per output
// tile, zero. Requires N % 8 == 0 and K % 8 == 0 and 16-byte aligned dy
// and x (TMA).
LTD_API int ltd_weight_grad_f32(const float* dy, const float* x, float* out, float* ws,
                                int* counters, const int* plan, int M, int N, int K, int blocks,
                                void* stream) {
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_dy, map_x;
  int err = f32tile::encode_rows(&map_dy, dy, N, M);
  if (!err) err = f32tile::encode_rows(&map_x, x, K, M);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(weight_grad_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  weight_grad_f32_kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_dy, map_x, plan, out, ws, counters, N, K);
  return static_cast<int>(cudaGetLastError());
}
