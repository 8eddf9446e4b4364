// flash_attention_bwd: dq, dk, dv of o = softmax(q k^T / sqrt(64)) v per
// (image, head), N tokens with N % 64 == 0.
//
// Replaces transformer_latent_diffusion_tpu/ops/attention.py::
// _pallas_attention_bwd (`_flash_bwd_kernel`, pallas_call at attention.py:247,
// K4a: one program per (batch*head) holding the whole N x N score set in
// VMEM, 512 <= N <= 2048) and ::_pallas_attention_bwd_tiled
// (`_flash_bwd_tiled_kernel`, pallas_call at attention.py:313, K4b: 512-query
// blocks with dk and dv summed in float32 VMEM scratch, N <= 8192). Both
// compute the same function; one design here serves both.
//
// What bounds it on the H100: five products of 2 N^2 64 operations per
// (image, head) (the recomputed q k^T, dp = g v^T, dq = ds k, dk = ds^T q,
// dv = p^T g) against 7 N 64 x 2 bytes (q, k, v, g in, dq, dk, dv out):
// 5 N / 7 operations per byte, 731 at N = 1024, far above the card's ~295
// balance point, so the tensor cores bound it (0.52 ms per layer at 512 px,
// batch 64; 2.08 ms at 1024 px, batch 16).
//
// What this design does about that: a Hopper SM cannot hold a head's N x N
// set (4 MB of float32 at 1024 tokens) nor its K and V (256 KB of bf16), so
// two kernels stream 64-row tiles through a 3-stage `cp.async` ring, as the
// forward (flash_attention.cu) does, with m16n8k16 bf16 `mma.sync`
// products and float32 accumulation:
//
//   dq kernel   one block per (64-query tile, head, image), four warps of 16
//               query rows; q and g of the tile sit in registers as A
//               fragments; per 64-key tile (in two halves of 32 keys, to
//               keep registers below the spill line) it recomputes
//               s = q k^T / 8 and dp = g v^T, p = exp(s - lse) in float32,
//               ds = p (dp - D) / 8 rounded to bf16, and adds ds k into the
//               tile's float32 dq.
//   dkv kernel  one block per (64-key tile, head, image), four warps of 16
//               keys; k and v of the tile in registers; per 64-query tile it
//               recomputes s^T = k q^T / 8 and dp^T = v g^T, p and ds as
//               above, and adds p^T g (p rounded to bf16) into dv and
//               ds^T q into dk, both float32 in registers.
//
// Each output tile is owned by one block, so no atomics and no order
// dependence (as `colsum` in gemm_bwd.cu); the cost is one extra recompute
// of q k^T and g v^T against a single kernel that adds dq with atomics
// (7 products instead of 5 per (image, head)).
//
// Row statistics: lse, each query row's log-sum-exp, comes from the forward
// (flash_attention.cu with `lse`). D = rowsum(p * dp) is computed as
// rowsum(g * o) = g . (p v), by the dq kernel's prologue (two threads per
// row) from the forward's bf16 output o, and written to `delta` for the dkv
// kernel, which runs after it on the same stream. The TPU kernel sums p * dp
// in float32; o here is rounded to bf16, so D differs by about one bf16
// step of o (held against the plain version at rel-L2 < 1e-2 per output).
// ds and p are rounded to bf16 before their products, as the TPU kernel
// rounds them (attention.py:226-227); every sum is float32.
//
// q, k, v, o and g are read by row stride: the wrapper passes the strided
// column blocks of the fused QKV rows without copies. dq, dk and dv are
// written as (B*N, D) rows, head h at columns h*64.
//
// Not yet: `wgmma`, TMA and warp specialisation (later PRs).

#include "common.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;
constexpr int LDH = DH + 8;  // bf16 row stride of the tiles in shared memory (144 bytes)
constexpr int T = 64;        // rows of a tile (queries or keys)
constexpr int STAGES = 3;    // streamed tiles in flight
constexpr int THREADS = 128;
constexpr float SCALE = 0.125f;  // 1 / sqrt(64)

// dq kernel: q and g tiles, lse and D of the tile's rows, then the K/V ring
constexpr size_t DQ_SMEM = static_cast<size_t>(2 * T * LDH + STAGES * 2 * T * LDH) * sizeof(bf16) +
                           2 * T * sizeof(float);
// dkv kernel: k and v tiles, then the ring of (q tile, g tile, lse, D)
constexpr size_t STAGE_BYTES = static_cast<size_t>(2 * T * LDH) * sizeof(bf16) + 2 * T * sizeof(float);
constexpr size_t DKV_SMEM = static_cast<size_t>(2 * T * LDH) * sizeof(bf16) + STAGES * STAGE_BYTES;

// rows r0..r0+63 of a (rows, *) bf16 matrix with row stride `row` into a tile
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int row, int tid) {
  for (int c = tid; c < T * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    cp_async16(&dst[r * LDH + col], src + static_cast<size_t>(r0 + r) * row + col, 16);
  }
}

// 64 floats
__device__ __forceinline__ void load_row_stats(float* dst, const float* src, int tid) {
  if (tid < T / 4) cp_async16(dst + tid * 4, src + tid * 4, 16);
}

// A fragments (16 rows x 64) of rows wr.. of a tile
__device__ __forceinline__ void load_a(uint32_t (&f)[DH / 16][4], const bf16* tile, int wr,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldmatrix_x4(f[kc], &tile[(wr + (lane & 15)) * LDH + kc * 16 + (lane >> 4) * 8]);
}

// (acc0, acc1) += the 16 x 16 block A tile^T: A (16 x 64) against rows
// row0..row0+15 of `tile`, columns row0..row0+7 into acc0, the next 8 into acc1
__device__ __forceinline__ void mma_nt(float (&acc0)[4], float (&acc1)[4],
                                       const uint32_t (&a)[DH / 16][4], const bf16* tile, int row0,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    uint32_t b[4];
    ldmatrix_x4(b, &tile[(row0 + (lane & 7) + ((lane >> 4) << 3)) * LDH + kc * 16 +
                         ((lane >> 3) & 1) * 8]);
    mma_bf16_16816(acc0, a[kc], b[0], b[1]);
    mma_bf16_16816(acc1, a[kc], b[2], b[3]);
  }
}

// acc (16 x 64) += A (16 x 16, bf16 fragment) times rows row0..row0+15 of `tile`
__device__ __forceinline__ void mma_nn(float (&acc)[DH / 8][4], const uint32_t (&a)[4],
                                       const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int d2 = 0; d2 < DH / 16; ++d2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, &tile[(row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + d2 * 16 +
                               (lane >> 4) * 8]);
    mma_bf16_16816(acc[2 * d2], a, b[0], b[1]);
    mma_bf16_16816(acc[2 * d2 + 1], a, b[2], b[3]);
  }
}

// the bf16 A fragment of columns 16c..16c+15 of a 16 x 32 accumulator
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[4][4], int c) {
  a[0] = pack_bf16x2(x[2 * c][0], x[2 * c][1]);
  a[1] = pack_bf16x2(x[2 * c][2], x[2 * c][3]);
  a[2] = pack_bf16x2(x[2 * c + 1][0], x[2 * c + 1][1]);
  a[3] = pack_bf16x2(x[2 * c + 1][2], x[2 * c + 1][3]);
}

__device__ __forceinline__ void store_rows(bf16* base, size_t r, int D, int col,
                                           const float (&acc)[DH / 8][4]) {
  bf16* o0 = base + r * D + col;
  bf16* o1 = o0 + static_cast<size_t>(8) * D;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    *reinterpret_cast<uint32_t*>(o0 + d * 8) = pack_bf16x2(acc[d][0], acc[d][1]);
    *reinterpret_cast<uint32_t*>(o1 + d * 8) = pack_bf16x2(acc[d][2], acc[d][3]);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int N, int D, int q_row,
                    int k_row, int v_row, int o_row, int g_row) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + T * LDH;
  bf16* KVs = Gs + T * LDH;  // stage s: K at KVs + s * 2 * T * LDH, V after it
  float* Ls = reinterpret_cast<float*>(KVs + STAGES * 2 * T * LDH);
  float* Ds = Ls + T;

  const int q0 = blockIdx.x * T;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const bf16* qb = q + b * N * q_row + h * DH;
  const bf16* kb = k + b * N * k_row + h * DH;
  const bf16* vb = v + b * N * v_row + h * DH;
  const bf16* ob = o + b * N * o_row + h * DH;
  const bf16* gb = g + b * N * g_row + h * DH;
  const size_t stat = (b * gridDim.y + h) * N;  // row statistics of (image, head)
  const int n_tiles = N / T;

  auto load_kv = [&](int tile) {
    bf16* Ks = KVs + (tile % STAGES) * 2 * T * LDH;
    load_tile(Ks, kb, tile * T, k_row, tid);
    load_tile(Ks + T * LDH, vb, tile * T, v_row, tid);
  };
  load_tile(Qs, qb, q0, q_row, tid);
  load_tile(Gs, gb, q0, g_row, tid);
  load_row_stats(Ls, lse + stat + q0, tid);
  load_kv(0);
  cp_async_commit();  // group 0: q, g, lse and K/V tile 0
#pragma unroll
  for (int t = 1; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();  // group t (empty past the end, so the count stays uniform)
  }

  // D = rowsum(g * o): two threads per row, 32 columns each
  {
    const int r = tid >> 1, half = tid & 1;
    const bf16* gr = gb + static_cast<size_t>(q0 + r) * g_row + half * 32;
    const bf16* orow = ob + static_cast<size_t>(q0 + r) * o_row + half * 32;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      const uint4 gu = *reinterpret_cast<const uint4*>(gr + c);
      const uint4 ou = *reinterpret_cast<const uint4*>(orow + c);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gu);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ou);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(g2[e]);
        const float2 c2 = __bfloat1622float2(o2[e]);
        acc += a.x * c2.x + a.y * c2.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (!half) {
      Ds[r] = acc;
      delta[stat + q0 + r] = acc;
    }
  }

  const int wr = warp * 16;
  uint32_t qf[DH / 16][4], gf[DH / 16][4];
  float dqa[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[d][e] = 0.f;
  float lse0 = 0.f, lse1 = 0.f, d0 = 0.f, d1 = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this tile's group has landed
    __syncthreads();              // ... for every thread; and the stage refilled below is free
    if (tile + STAGES - 1 < n_tiles) load_kv(tile + STAGES - 1);
    cp_async_commit();
    if (tile == 0) {
      load_a(qf, Qs, wr, lane);
      load_a(gf, Gs, wr, lane);
      lse0 = Ls[wr + gq], lse1 = Ls[wr + gq + 8];
      d0 = Ds[wr + gq], d1 = Ds[wr + gq + 8];
    }
    const bf16* Ks = KVs + (tile % STAGES) * 2 * T * LDH;
    const bf16* Vs = Ks + T * LDH;

#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {  // 32 keys at a time
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        mma_nt(s[2 * j2], s[2 * j2 + 1], qf, Ks, jh * 32 + j2 * 16, lane);
        mma_nt(dp[2 * j2], dp[2 * j2 + 1], gf, Vs, jh * 32 + j2 * 16, lane);
      }
      // ds = p (dp - D) / 8, p = exp(s / 8 - lse); rows gq (e < 2) and gq + 8
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] * SCALE - (e < 2 ? lse0 : lse1));
          s[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * SCALE;
        }
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // dq += ds k over 16 keys
        uint32_t a[4];
        pack_a(a, s, c);
        mma_nn(dqa, a, Ks, jh * 32 + c * 16, lane);
      }
    }
  }
  cp_async_wait<0>();
  store_rows(dq, b * N + q0 + wr + gq, D, h * DH + 2 * t4, dqa);
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int D, int q_row,
                     int k_row, int v_row, int g_row) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T * LDH;
  unsigned char* ring = smem + 2 * T * LDH * sizeof(bf16);
  // stage s: q tile, g tile, lse and D of its 64 queries

  const int k0 = blockIdx.x * T;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const bf16* qb = q + b * N * q_row + h * DH;
  const bf16* kb = k + b * N * k_row + h * DH;
  const bf16* vb = v + b * N * v_row + h * DH;
  const bf16* gb = g + b * N * g_row + h * DH;
  const size_t stat = (b * gridDim.y + h) * N;
  const int n_tiles = N / T;

  auto stage = [&](int tile) { return ring + (tile % STAGES) * STAGE_BYTES; };
  auto load_q = [&](int tile) {
    bf16* Qs = reinterpret_cast<bf16*>(stage(tile));
    float* Ls = reinterpret_cast<float*>(Qs + 2 * T * LDH);
    load_tile(Qs, qb, tile * T, q_row, tid);
    load_tile(Qs + T * LDH, gb, tile * T, g_row, tid);
    load_row_stats(Ls, lse + stat + tile * T, tid);
    load_row_stats(Ls + T, delta + stat + tile * T, tid);
  };
  load_tile(Ks, kb, k0, k_row, tid);
  load_tile(Vs, vb, k0, v_row, tid);
  load_q(0);
  cp_async_commit();  // group 0: k, v and query tile 0
#pragma unroll
  for (int t = 1; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_q(t);
    cp_async_commit();
  }

  const int wr = warp * 16;
  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (tile + STAGES - 1 < n_tiles) load_q(tile + STAGES - 1);
    cp_async_commit();
    if (tile == 0) {
      load_a(kf, Ks, wr, lane);
      load_a(vf, Vs, wr, lane);
    }
    const bf16* Qs = reinterpret_cast<const bf16*>(stage(tile));
    const bf16* Gs = Qs + T * LDH;
    const float* Ls = reinterpret_cast<const float*>(Gs + T * LDH);
    const float* Ds = Ls + T;

#pragma unroll
    for (int qh = 0; qh < 2; ++qh) {  // 32 queries at a time
      float p[4][4], ds[4][4];        // s^T and dp^T first: rows are keys, columns queries
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        mma_nt(p[2 * j2], p[2 * j2 + 1], kf, Qs, qh * 32 + j2 * 16, lane);
        mma_nt(ds[2 * j2], ds[2 * j2 + 1], vf, Gs, qh * 32 + j2 * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qh * 32 + 8 * j + 2 * t4 + (e & 1);
          p[j][e] = expf(p[j][e] * SCALE - Ls[qi]);
          ds[j][e] = p[j][e] * (ds[j][e] - Ds[qi]) * SCALE;
        }
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // dv += p^T g, dk += ds^T q over 16 queries
        uint32_t a[4];
        pack_a(a, p, c);
        mma_nn(dva, a, Gs, qh * 32 + c * 16, lane);
        pack_a(a, ds, c);
        mma_nn(dka, a, Qs, qh * 32 + c * 16, lane);
      }
    }
  }
  cp_async_wait<0>();
  const size_t r = b * N + k0 + wr + gq;
  store_rows(dk, r, D, h * DH + 2 * t4, dka);
  store_rows(dv, r, D, h * DH + 2 * t4, dva);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// q, k, v, o, g: (B*N, *) bf16 rows with row strides q_row, k_row, v_row,
// o_row, g_row elements, head h at columns h*64 (o the forward's output, g
// the gradient of o). lse: (B, n_heads, N) float32 from the forward. delta:
// (B, n_heads, N) float32, written here (rowsum(g * o)). dq: (B*N, D) bf16,
// D = n_heads * 64. Row strides are multiples of 8, the pointers 16-byte
// aligned, N % 64 == 0. Run it before ltd_flash_attention_bwd_dkv.
LTD_API int ltd_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                       const void* g, const float* lse, float* delta, void* dq,
                                       int B, int N, int n_heads, int q_row, int k_row, int v_row,
                                       int o_row, int g_row, void* stream) {
  if (N < T || N % T) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(flash_bwd_dq_kernel, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<dim3(N / T, n_heads, B), THREADS, DQ_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), lse, delta,
      static_cast<bf16*>(dq), N, n_heads * DH, q_row, k_row, v_row, o_row, g_row);
  return static_cast<int>(cudaGetLastError());
}

// The same q, k, v, g, lse and the delta the dq kernel wrote; dk, dv:
// (B*N, D) bf16.
LTD_API int ltd_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* g, const float* lse, const float* delta,
                                        void* dk, void* dv, int B, int N, int n_heads, int q_row,
                                        int k_row, int v_row, int g_row, void* stream) {
  if (N < T || N % T) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(flash_bwd_dkv_kernel, DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<dim3(N / T, n_heads, B), THREADS, DKV_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N,
      n_heads * DH, q_row, k_row, v_row, g_row);
  return static_cast<int>(cudaGetLastError());
}
