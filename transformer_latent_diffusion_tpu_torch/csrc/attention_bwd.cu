// attention_bwd: the backward of the layer's two attentions.
//
// Replaces the attention backward of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel:
// the self-attention (:221-236) and the 2-key cross-attention (:194-209).
// With p the float32 softmax recomputed from q and k, dO the upstream
// gradient of a head's output rounded to bf16, dp = dO v^T and
// ds = p (dp - sum_j dp p) / sqrt(64) rounded to bf16, they give
// dq = ds k, dk = ds^T q and dv = bf16(p)^T dO, each accumulated in
// float32 and rounded to bf16 once (the bf16 dqkv / dqc / dkv operands of
// the weight-gradient products), exactly where the TPU kernel rounds.
//
// Self-attention, what bounds it on the H100: per (batch, head) at N = 256
// it reads q, k, v and dO (4 x 32 KB of bf16) and does five 256 x 256 x 64
// products (84 MFLOP), ~600 FLOP per byte: the tensor cores, if the
// products overlap the softmax work. The TPU kernel keeps one batch
// element's whole N x N probabilities of every head in VMEM; an SM holds
// 227 KB. So the work is split FlashAttention-2 style into two kernels
// that never store p:
//   self_attention_bwd_dq: one block per (batch, head, 64-query tile),
//     K and V of all tokens in shared memory, four warps of 16 query rows
//     that keep their score rows in registers (as the forward kernel
//     does): softmax, then delta = sum_j dp p over 16-key chunks of
//     dp = dO V^T, then dq = ds K, recomputing each dp chunk. It stores
//     each row's max, sum and delta (12 bytes a row).
//   self_attention_bwd_dkv: one block per (batch, head, 64-key tile), Q and
//     dO of all tokens in shared memory, four warps of 16 key rows that
//     walk over 16-query chunks: p^T = exp(s^T - max) / sum from the stored
//     statistics, dv += bf16(p)^T dO, dp^T = V dO^T, ds^T, dk += ds^T Q,
//     the dk and dv tiles staying in registers.
// Both multiply with m16n8k16 bf16 `mma.sync`, operands from shared memory
// through `ldmatrix` (transposed where the product reads a row-major
// operand along its rows); each output element has one writer. Any
// N <= 256 is taken: both kernels work on N rounded up to a multiple of 64
// (their template) with the rows of the ragged last tile past N
// zero-filled in shared memory and never read from device memory; key
// columns past N enter the softmax as -inf (before the row max), query
// rows past N get p = 0 (their stored row max is +inf), and no row of dq,
// dk or dv past N is written.
//
// Cross-attention: per token two 64-wide dot products per head: 4
// multiply-adds per byte read, memory-bound. One block per (batch, head),
// a warp per token (a lane holds 2 of the head's 64 columns; dot products
// are warp-shuffle sums), dqc written per token, dk and dv of the two
// conditioning tokens summed over the batch element's tokens in registers
// and then over the 8 warps in a fixed order in shared memory.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int DH = 64;
constexpr int LDH = DH + 8;  // bf16 row stride in shared memory (144 bytes)
constexpr int QT = 64;       // rows per block of the two self-attention kernels
constexpr int THREADS = 128;
constexpr float SCALE = 0.125f;  // 1 / sqrt(64)

// `rows` rows of one head's upstream gradient (float32, row stride D) into
// shared memory as bf16; rows from `valid` on are zeros, not read
__device__ __forceinline__ void load_do(bf16* dst, const float* __restrict__ src, int rows,
                                        int valid, int D, int tid) {
  for (int c = tid; c < rows * (DH / 4); c += THREADS) {
    const int r = c / (DH / 4), col = (c % (DH / 4)) * 4;
    const float4 v = r < valid
                         ? *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * D + col)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    uint2 p;
    p.x = pack_bf16x2(v.x, v.y);
    p.y = pack_bf16x2(v.z, v.w);
    *reinterpret_cast<uint2*>(dst + r * LDH + col) = p;
  }
}

// 64 bf16 columns of `rows` rows (row stride `stride`) into shared memory;
// rows from `valid` on are zero-filled (src-size 0: nothing is read)
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows, int valid,
                                          size_t stride, int tid) {
  for (int c = tid; c < rows * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int ok = r < valid ? 16 : 0;
    cp_async16(dst + r * LDH + col, src + (ok ? r : 0) * stride + col, ok);
  }
}

// the A fragments (16 rows from `row0`, all 64 columns) of a [row][64] tile
__device__ __forceinline__ void load_a(uint32_t (&f)[DH / 16][4], const bf16* tile, int row0,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldmatrix_x4(f[kc], tile + (row0 + (lane & 15)) * LDH + kc * 16 + (lane >> 4) * 8);
}

// acc (16 x 16, two n8 tiles) += A (16 x 64) B^T, B = 16 rows from `row0` of a [row][64] tile
__device__ __forceinline__ void mma_abt(float (&acc)[2][4], const uint32_t (&a)[DH / 16][4],
                                        const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    uint32_t b[4];
    ldmatrix_x4(b, tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * LDH + kc * 16 +
                       ((lane >> 3) & 1) * 8);
    mma_bf16_16816(acc[0], a[kc], b[0], b[1]);
    mma_bf16_16816(acc[1], a[kc], b[2], b[3]);
  }
}

// out (16 x 64) += P (16 x 16, as an A fragment) B, B = 16 rows from `row0` of a [row][64] tile
__device__ __forceinline__ void mma_pb(float (&out)[DH / 8][4], const uint32_t (&pa)[4],
                                       const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int d2 = 0; d2 < DH / 16; ++d2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + d2 * 16 +
                             (lane >> 4) * 8);
    mma_bf16_16816(out[2 * d2], pa, b[0], b[1]);
    mma_bf16_16816(out[2 * d2 + 1], pa, b[2], b[3]);
  }
}

// an accumulator pair of n8 tiles (16 x 16) as the bf16 A fragment of the next product
__device__ __forceinline__ void to_a(uint32_t (&pa)[4], const float (&t0)[4], const float (&t1)[4]) {
  pa[0] = pack_bf16x2(t0[0], t0[1]);
  pa[1] = pack_bf16x2(t0[2], t0[3]);
  pa[2] = pack_bf16x2(t1[0], t1[1]);
  pa[3] = pack_bf16x2(t1[2], t1[3]);
}

// 16 x 64 float32 accumulators -> bf16 at columns col0.. of rows row0 + g,
// row0 + g + 8; only rows below row0 + valid are written
__device__ __forceinline__ void store_rows(bf16* out, size_t stride, size_t row0, int valid,
                                           int col0, const float (&acc)[DH / 8][4], int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  bf16* r0 = out + (row0 + g) * stride + col0 + 2 * t4;
  bf16* r1 = r0 + 8 * stride;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    if (g < valid) *reinterpret_cast<uint32_t*>(r0 + d * 8) = pack_bf16x2(acc[d][0], acc[d][1]);
    if (g + 8 < valid)
      *reinterpret_cast<uint32_t*>(r1 + d * 8) = pack_bf16x2(acc[d][2], acc[d][3]);
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
self_attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const float* __restrict__ dout,
                             bf16* __restrict__ dqkv, float* __restrict__ stats, int N, int D) {
  constexpr int NP = NT * 64;  // N padded to whole tiles
  constexpr int NK8 = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * LDH;
  bf16* Qs = Vs + NP * LDH;
  bf16* Os = Qs + QT * LDH;

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * N * stride + h * DH;

  load_rows(Ks, base + D, NP, N, stride, tid);
  load_rows(Vs, base + 2 * D, NP, N, stride, tid);
  load_rows(Qs, base + q0 * stride, QT, N - q0, stride, tid);
  cp_async_commit();
  load_do(Os, dout + (static_cast<size_t>(b) * N + q0) * D + h * DH, QT, N - q0, D, tid);
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  float s[NK8][4];
  {
    uint32_t qf[DH / 16][4];
    load_a(qf, Qs, wr, lane);
#pragma unroll
    for (int j = 0; j < NK8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NK8 / 2; ++j2) {
      float t[2][4] = {};
      mma_abt(t, qf, Ks, j2 * 16, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * j2][e] = t[0][e];
        s[2 * j2 + 1][e] = t[1][e];
      }
    }
  }
  // the forward's float32 softmax: rows g and g + 8 of the warp's 16; keys
  // past N are -inf
  float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < NK8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = 8 * j + 2 * t4 + (e & 1) < N ? s[j][e] * SCALE : -INFINITY;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NK8; ++j) {
    s[j][0] = expf(s[j][0] - mx0);
    s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1);
    s[j][3] = expf(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
#pragma unroll
  for (int j = 0; j < NK8; ++j) {
    s[j][0] /= sum0;
    s[j][1] /= sum0;
    s[j][2] /= sum1;
    s[j][3] /= sum1;
  }

  uint32_t of[DH / 16][4];
  load_a(of, Os, wr, lane);
  // delta = sum_j dp p, dp = dO V^T in 16-key chunks
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < NK8 / 2; ++j2) {
    float dp[2][4] = {};
    mma_abt(dp, of, Vs, j2 * 16, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dl0 += dp[u][0] * s[2 * j2 + u][0] + dp[u][1] * s[2 * j2 + u][1];
      dl1 += dp[u][2] * s[2 * j2 + u][2] + dp[u][3] * s[2 * j2 + u][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, o);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, o);
  }

  float dq[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
#pragma unroll
  for (int j2 = 0; j2 < NK8 / 2; ++j2) {
    float dp[2][4] = {};
    mma_abt(dp, of, Vs, j2 * 16, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dp[u][0] = s[2 * j2 + u][0] * (dp[u][0] - dl0) * SCALE;
      dp[u][1] = s[2 * j2 + u][1] * (dp[u][1] - dl0) * SCALE;
      dp[u][2] = s[2 * j2 + u][2] * (dp[u][2] - dl1) * SCALE;
      dp[u][3] = s[2 * j2 + u][3] * (dp[u][3] - dl1) * SCALE;
    }
    uint32_t pa[4];
    to_a(pa, dp[0], dp[1]);
    mma_pb(dq, pa, Ks, j2 * 16, lane);
  }
  const size_t row = static_cast<size_t>(b) * N + q0 + wr;
  store_rows(dqkv, stride, row, N - q0 - wr, h * DH, dq, lane);
  if (t4 == 0) {
    float* st = stats + ((static_cast<size_t>(b) * H + h) * N + q0 + wr + g) * 3;
    if (q0 + wr + g < N) st[0] = mx0, st[1] = sum0, st[2] = dl0;
    if (q0 + wr + g + 8 < N) st[24] = mx1, st[25] = sum1, st[26] = dl1;  // row g + 8
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
self_attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ dout,
                              bf16* __restrict__ dqkv, const float* __restrict__ stats, int N,
                              int D) {
  constexpr int NP = NT * 64;  // N padded to whole tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + NP * LDH;
  bf16* Ks = Os + NP * LDH;
  bf16* Vs = Ks + QT * LDH;
  float* st = reinterpret_cast<float*>(Vs + QT * LDH);  // [NP][3]

  const int k0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const size_t stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * N * stride + h * DH;

  load_rows(Qs, base, NP, N, stride, tid);
  load_rows(Ks, base + k0 * stride + D, QT, N - k0, stride, tid);
  load_rows(Vs, base + k0 * stride + 2 * D, QT, N - k0, stride, tid);
  cp_async_commit();
  load_do(Os, dout + static_cast<size_t>(b) * N * D + h * DH, NP, N, D, tid);
  // a query row past N: max +inf, so its p is exp(-inf) = 0
  const float* sg = stats + (static_cast<size_t>(b) * H + h) * N * 3;
  for (int i = tid; i < NP * 3; i += THREADS)
    st[i] = i < N * 3 ? sg[i] : (i % 3 == 0 ? INFINITY : (i % 3 == 1 ? 1.f : 0.f));
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;
  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  load_a(kf, Ks, wr, lane);
  load_a(vf, Vs, wr, lane);
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int qc = 0; qc < NP / 16; ++qc) {
    // s^T: rows = this warp's keys, columns = queries qc*16 + u*8 + 2*t4 + (e & 1)
    float p[2][4] = {};
    mma_abt(p, kf, Qs, qc * 16, lane);
    float dp[2][4] = {};
    mma_abt(dp, vf, Os, qc * 16, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* sq = st + (qc * 16 + u * 8 + 2 * t4 + (e & 1)) * 3;
        p[u][e] = expf(p[u][e] * SCALE - sq[0]) / sq[1];
        dp[u][e] = p[u][e] * (dp[u][e] - sq[2]) * SCALE;
      }
    uint32_t pa[4];
    to_a(pa, p[0], p[1]);
    mma_pb(dv, pa, Os, qc * 16, lane);
    to_a(pa, dp[0], dp[1]);
    mma_pb(dk, pa, Qs, qc * 16, lane);
  }
  const size_t row = static_cast<size_t>(b) * N + k0 + wr;
  store_rows(dqkv, stride, row, N - k0 - wr, D + h * DH, dk, lane);
  store_rows(dqkv, stride, row, N - k0 - wr, 2 * D + h * DH, dv, lane);
}

constexpr int CA_WARPS = 8;
constexpr int MAX_HEADS = 12;

__global__ void __launch_bounds__(CA_WARPS * 32)
cross_attention_bwd_kernel(const bf16* __restrict__ qc, const bf16* __restrict__ kv,
                           const float* __restrict__ dout, bf16* __restrict__ dqc,
                           bf16* __restrict__ dkv, int N, int D) {
  __shared__ float red[CA_WARPS][4][DH];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = h * 32 + lane;  // bf16 pair index within a row
  const __nv_bfloat162* kv2 = reinterpret_cast<const __nv_bfloat162*>(kv + static_cast<size_t>(b) * 4 * D);
  const float2 k0 = __bfloat1622float2(kv2[c]);
  const float2 v0 = __bfloat1622float2(kv2[D / 2 + c]);
  const float2 k1 = __bfloat1622float2(kv2[D + c]);
  const float2 v1 = __bfloat1622float2(kv2[3 * D / 2 + c]);
  float2 dk0 = make_float2(0.f, 0.f), dk1 = dk0, dv0 = dk0, dv1 = dk0;

  for (int n = warp; n < N; n += CA_WARPS) {
    const size_t row = static_cast<size_t>(b) * N + n;
    const float2 q = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qc + row * D)[c]);
    const float2 gf = reinterpret_cast<const float2*>(dout + row * D)[c];
    const float2 gh = __bfloat1622float2(__floats2bfloat162_rn(gf.x, gf.y));
    const float s0 = warp_sum(q.x * k0.x + q.y * k0.y) * SCALE;
    const float s1 = warp_sum(q.x * k1.x + q.y * k1.y) * SCALE;
    const float m = fmaxf(s0, s1);
    const float e0 = expf(s0 - m), e1 = expf(s1 - m);
    const float den = e0 + e1;
    const float p0 = e0 / den, p1 = e1 / den;
    const float dp0 = warp_sum(gh.x * v0.x + gh.y * v0.y);
    const float dp1 = warp_sum(gh.x * v1.x + gh.y * v1.y);
    const float dl = dp0 * p0 + dp1 * p1;
    const float ds0 = __bfloat162float(__float2bfloat16_rn(p0 * (dp0 - dl) * SCALE));
    const float ds1 = __bfloat162float(__float2bfloat16_rn(p1 * (dp1 - dl) * SCALE));
    reinterpret_cast<uint32_t*>(dqc + row * D)[c] =
        pack_bf16x2(ds0 * k0.x + ds1 * k1.x, ds0 * k0.y + ds1 * k1.y);
    const float pl0 = __bfloat162float(__float2bfloat16_rn(p0));
    const float pl1 = __bfloat162float(__float2bfloat16_rn(p1));
    dk0.x += ds0 * q.x, dk0.y += ds0 * q.y;
    dk1.x += ds1 * q.x, dk1.y += ds1 * q.y;
    dv0.x += pl0 * gh.x, dv0.y += pl0 * gh.y;
    dv1.x += pl1 * gh.x, dv1.y += pl1 * gh.y;
  }
  const float2 parts[4] = {dk0, dv0, dk1, dv1};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[warp][j][2 * lane] = parts[j].x;
    red[warp][j][2 * lane + 1] = parts[j].y;
  }
  __syncthreads();
  // thread t: part j = t / 64 (dk0, dv0, dk1, dv1), column d = t % 64
  const int j = threadIdx.x / DH, d = threadIdx.x % DH;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < CA_WARPS; ++w) t += red[w][j][d];
  const size_t out_row = static_cast<size_t>(2 * b + (j >> 1)) * 2 * D;
  dkv[out_row + (j & 1) * D + h * DH + d] = __float2bfloat16_rn(t);
}

// one of the two self-attention kernels: the dq kernel (dkv false) or the
// dk/dv kernel (dkv true)
template <int NT>
int launch_self(bool dkv, const bf16* qkv, const float* dout, bf16* dqkv, float* stats, int B,
                int N, int D, int H, cudaStream_t s) {
  constexpr int NP = NT * 64;
  const size_t smem_dq = static_cast<size_t>(2 * NP * LDH + 2 * QT * LDH) * sizeof(bf16);
  const dim3 grid(NP / QT, H, B);
  cudaError_t err;
  if (dkv) {
    const size_t smem = smem_dq + static_cast<size_t>(NP) * 3 * sizeof(float);
    err = cudaFuncSetAttribute(self_attention_bwd_dkv_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    self_attention_bwd_dkv_kernel<NT><<<grid, THREADS, smem, s>>>(qkv, dout, dqkv, stats, N, D);
  } else {
    err = cudaFuncSetAttribute(self_attention_bwd_dq_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_dq));
    if (err != cudaSuccess) return static_cast<int>(err);
    self_attention_bwd_dq_kernel<NT><<<grid, THREADS, smem_dq, s>>>(qkv, dout, dqkv, stats, N,
                                                                    D);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_self_n(bool dkv, const void* qkv, const float* dout, void* dqkv, float* stats, int B,
                  int N, int D, int H, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != H * DH || N < 1 || N > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch ((N + 63) / 64) {
    case 1: return launch_self<1>(dkv, q, dout, dq, stats, B, N, D, H, s);
    case 2: return launch_self<2>(dkv, q, dout, dq, stats, B, N, D, H, s);
    case 3: return launch_self<3>(dkv, q, dout, dq, stats, B, N, D, H, s);
    default: return launch_self<4>(dkv, q, dout, dq, stats, B, N, D, H, s);
  }
}

}  // namespace

// qkv: (B*N, 3D) bf16 rows [q | k | v] of the forward; dout: (B*N, D)
// float32, the gradient of the attention's output (rounded to bf16 here);
// dqkv: (B*N, 3D) bf16 rows [dq | dk | dv]; stats: (B, H, N, 3) float32.
// The dq kernel writes the dq columns and each row's statistics; the dk/dv
// kernel, launched after it on the same stream, reads the statistics and
// writes the dk and dv columns. Requires D == H * 64 and 1 <= N <= 256.
LTD_API int ltd_self_attention_bwd_dq(const void* qkv, const float* dout, void* dqkv,
                                      float* stats, int B, int N, int D, int H, void* stream) {
  return launch_self_n(false, qkv, dout, dqkv, stats, B, N, D, H, stream);
}

LTD_API int ltd_self_attention_bwd_dkv(const void* qkv, const float* dout, void* dqkv,
                                       float* stats, int B, int N, int D, int H, void* stream) {
  return launch_self_n(true, qkv, dout, dqkv, stats, B, N, D, H, stream);
}

// qc: (B*N, D) bf16 queries; kv: (B*2, 2D) bf16, row 2b+j = [k | v] of
// conditioning token j; dout: (B*N, D) float32, the gradient of the
// attention's output (rounded to bf16 here); dqc: (B*N, D) bf16; dkv:
// (B*2, 2D) bf16 in kv's layout. Requires D == H * 64 and H <= 12.
LTD_API int ltd_cross_attention_bwd(const void* qc, const void* kv, const float* dout, void* dqc,
                                    void* dkv, int B, int N, int D, int H, void* stream) {
  if (D != H * DH || H > MAX_HEADS) return static_cast<int>(cudaErrorInvalidValue);
  cross_attention_bwd_kernel<<<dim3(H, B), CA_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qc), static_cast<const bf16*>(kv), dout, static_cast<bf16*>(dqc),
      static_cast<bf16*>(dkv), N, D);
  return static_cast<int>(cudaGetLastError());
}
