// cross_attention: x += softmax over 2 keys of (q . k_j / sqrt(64)) v_j, per token and
// head, then xn = bf16(LN3(x)) of the updated row.
//
// Replaces the cross-attention of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (`_mha` of the LN2 -> Q projection against the 2-token conditioning K/V,
// fused_stack.py:75-78) and the LayerNorm that follows it (:81).
//
// What bounds it on the H100: 4 multiply-adds per byte at most; it reads
// the bf16 queries (2 bytes per element), reads and writes the float32
// residual (8 bytes per element) and writes the bf16 normalised row (2
// bytes), so it is memory-bound (3.35 TB/s).
//
// What this design does about that: it touches each element exactly once,
// with 4-byte (2-element) accesses so that a warp covers one head's 64
// columns in one 128-byte transaction. One warp per token, 8 tokens per
// block; the batch's 2 x 2D conditioning K/V are staged once per block in
// shared memory (8 bytes per channel; above 48 KB, D > 6144, the kernel
// asks for the larger dynamic shared memory). The two dot products per
// head are warp-shuffle sums in
// float32, the 2-way softmax is float32, the two probabilities are rounded
// to bf16 before they weigh V (as the TPU kernel rounds P before its P.V
// product), and the result is added into the residual in float32. Because
// the warp then holds the whole updated row in registers (up to 12 heads;
// the heads past 12 it reads back from the row it has just written, in
// the same order, so any number of heads sums alike), it also takes
// the row's float32 LayerNorm statistics (two passes, eps 1e-5) and writes
// the normalised, scaled, shifted row rounded to bf16: the A operand of the
// expand product, which can then stream bf16 rows instead of normalising
// float32 ones per output tile.
//
// The W8A8 engine (TPU kernel
// transformer_latent_diffusion_tpu/ops/fused_stack_int8.py, :91) quantizes
// LN3's float32 output, which rowquant.cu takes from the updated residual:
// there xn is null and the kernel stops after the residual add.
//
// SUMMED (a template flag; the main path's instantiation is the other) is
// the cross-attention of the probe scripts/microbench_layer.py's "onehead"
// variant (`_attn_onehead`, pallas_call at :252): one head as wide as D,
// scale still 1/sqrt(D / heads) = 1/8, so each of the 2 scores is the sum of
// the per-head dot products over all heads, and one pair of probabilities
// (rounded to bf16) weighs every column of V. The lanes accumulate their
// products over the heads first and reduce once.
//
// T (a template parameter) is the compute dtype of qc, kv and xn: bf16, or
// float32 when the weights are float32 (the JAX package's default
// configuration, `mxu` float32: ltd_cross_attention_f32). The float32 form
// reads 4 bytes per query element and writes 4 per LN3 element, keeps the
// probabilities unrounded, and is otherwise the same walk: still
// memory-bound, one warp per token.

#include "common.cuh"

namespace {

constexpr int TOKENS_PER_BLOCK = 8;
constexpr int THREADS = 32 * TOKENS_PER_BLOCK;
constexpr int MAX_HEADS = 12;  // heads whose updated row a lane keeps in registers
constexpr float LN_EPS = 1e-5f;

// Two adjacent elements of a row (pair index c) widened to float32.
__device__ __forceinline__ float2 pair(const bf16* p, int c) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[c]);
}
__device__ __forceinline__ float2 pair(const float* p, int c) {
  return reinterpret_cast<const float2*>(p)[c];
}
// A probability as the compute dtype holds it: rounded to bf16, or kept.
__device__ __forceinline__ float as_t(float p, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}
__device__ __forceinline__ float as_t(float p, const float*) { return p; }
__device__ __forceinline__ void put_pair(bf16* p, int c, float x, float y) {
  reinterpret_cast<uint32_t*>(p)[c] = pack_bf16x2(x, y);
}
__device__ __forceinline__ void put_pair(float* p, int c, float x, float y) {
  reinterpret_cast<float2*>(p)[c] = make_float2(x, y);
}

// T: the compute dtype of qc, kv and xn (bf16, or float32: then the
// probabilities are not rounded, as the TPU kernel's `.astype(mxu)` is a
// no-op for a float32 mxu).
template <typename T, bool SUMMED>
__global__ void __launch_bounds__(THREADS)
cross_attention_kernel(const T* __restrict__ qc, const T* __restrict__ kv,
                       float* __restrict__ resid, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_b, T* __restrict__ xn, int N, int D,
                       int n_heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* kvs = reinterpret_cast<T*>(smem);  // (2, 2D): [k | v] of cond tokens 0 and 1
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const T* kvb = kv + static_cast<size_t>(b) * 4 * D;
  const int chunks = 4 * D * static_cast<int>(sizeof(T)) / 8;  // 8-byte chunks of 4D elements
  for (int c = tid; c < chunks; c += THREADS)
    reinterpret_cast<uint2*>(kvs)[c] = reinterpret_cast<const uint2*>(kvb)[c];
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n = blockIdx.x * TOKENS_PER_BLOCK + warp;
  if (n >= N) return;
  const size_t row = static_cast<size_t>(b) * N + n;
  const T* q2 = qc + row * D;
  float2* x2 = reinterpret_cast<float2*>(resid + row * D);
  const T* k0 = kvs;
  const T* v0 = kvs + D;
  const T* k1 = kvs + 2 * D;
  const T* v1 = kvs + 3 * D;

  // 2-way float32 softmax of the scores s0, s1; probabilities in T
  auto probs = [&](float s0, float s1, float& p0, float& p1) {
    const float m = fmaxf(s0, s1);
    const float e0 = expf(s0 - m), e1 = expf(s1 - m);
    const float den = e0 + e1;
    p0 = as_t(e0 / den, qc);
    p1 = as_t(e1 / den, qc);
  };
  float p0_all = 0.f, p1_all = 0.f;  // SUMMED: one pair for every head
  if constexpr (SUMMED) {
    float a0s = 0.f, a1s = 0.f;
    for (int h = 0; h < n_heads; ++h) {
      const int c = h * 32 + lane;
      const float2 q = pair(q2, c);
      const float2 a0 = pair(k0, c);
      const float2 a1 = pair(k1, c);
      a0s += q.x * a0.x + q.y * a0.y;
      a1s += q.x * a1.x + q.y * a1.y;
    }
    probs(warp_sum(a0s) * scale, warp_sum(a1s) * scale, p0_all, p1_all);
  }

  // heads' updated pairs: in registers up to MAX_HEADS; past them, read back
  float2 xr[MAX_HEADS];
  auto updated = [&](int h) { return x2[h * 32 + lane]; };
  float sum = 0.f;
  auto attend = [&](int h) {
    const int c = h * 32 + lane;  // pair index within the row
    float p0 = p0_all, p1 = p1_all;
    if constexpr (!SUMMED) {
      const float2 q = pair(q2, c);
      const float2 a0 = pair(k0, c);
      const float2 a1 = pair(k1, c);
      probs(warp_sum(q.x * a0.x + q.y * a0.y) * scale, warp_sum(q.x * a1.x + q.y * a1.y) * scale,
            p0, p1);
    }
    const float2 b0 = pair(v0, c);
    const float2 b1 = pair(v1, c);
    float2 x = x2[c];
    x.x += p0 * b0.x + p1 * b1.x;
    x.y += p0 * b0.y + p1 * b1.y;
    x2[c] = x;
    sum += x.x + x.y;
    return x;
  };
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
    if (h < n_heads) xr[h] = attend(h);
  for (int h = MAX_HEADS; h < n_heads; ++h) attend(h);

  if (xn == nullptr) return;
  // LN3 of the updated row: float32 mean, then mean of squared deviations
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h) {
    if (h < n_heads) {
      const float d0 = xr[h].x - mean, d1 = xr[h].y - mean;
      sq += d0 * d0 + d1 * d1;
    }
  }
  for (int h = MAX_HEADS; h < n_heads; ++h) {
    const float2 x = updated(h);
    const float d0 = x.x - mean, d1 = x.y - mean;
    sq += d0 * d0 + d1 * d1;
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + LN_EPS);
  T* xn2 = xn + row * D;
  auto normalise = [&](int h, float2 x) {
    const int c = h * 32 + lane;
    const float2 sc = reinterpret_cast<const float2*>(ln_s)[c];
    const float2 sh = reinterpret_cast<const float2*>(ln_b)[c];
    put_pair(xn2, c, (x.x - mean) * rstd * sc.x + sh.x, (x.y - mean) * rstd * sc.y + sh.y);
  };
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
    if (h < n_heads) normalise(h, xr[h]);
  for (int h = MAX_HEADS; h < n_heads; ++h) normalise(h, updated(h));
}

}  // namespace

// qc: (B*N, D) bf16 queries. kv: (B*2, 2D) bf16, row 2b+j = [k | v] of
// conditioning token j of batch element b. resid: (B*N, D) float32, updated
// in place. ln_s, ln_b: (D,) float32, the LayerNorm after the residual add;
// xn: (B*N, D) bf16, the normalised rows, or null (then ln_s and ln_b are
// not read). summed != 0: one head as wide as D (see the header). Requires
// D == n_heads * 64 (any n_heads >= 1 whose 8 D bytes of K/V fit a block's
// shared memory: D <= 29056).
namespace {

template <typename T, bool SUMMED>
int launch(const void* qc, const void* kv, float* resid, const float* ln_s, const float* ln_b,
           void* xn, int B, int N, int D, int n_heads, cudaStream_t stream) {
  dim3 grid((N + TOKENS_PER_BLOCK - 1) / TOKENS_PER_BLOCK, B);
  const size_t smem = static_cast<size_t>(4) * D * sizeof(T);
  auto kernel = cross_attention_kernel<T, SUMMED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(qc), static_cast<const T*>(kv),
                                          resid, ln_s, ln_b, static_cast<T*>(xn), N, D, n_heads,
                                          0.125f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LTD_API int ltd_cross_attention(const void* qc, const void* kv, float* resid, const float* ln_s,
                                const float* ln_b, void* xn, int B, int N, int D, int n_heads,
                                int summed, void* stream) {
  if (n_heads < 1 || D != n_heads * 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return summed ? launch<bf16, true>(qc, kv, resid, ln_s, ln_b, xn, B, N, D, n_heads, s)
                : launch<bf16, false>(qc, kv, resid, ln_s, ln_b, xn, B, N, D, n_heads, s);
}

// The float32 form (compute dtype float32: the JAX package's default
// configuration): qc (B*N, D), kv (B*2, 2D) and xn (B*N, D) float32, the
// probabilities not rounded; otherwise as ltd_cross_attention without
// `summed`. D <= 14528 (16 D bytes of K/V in a block's shared memory).
LTD_API int ltd_cross_attention_f32(const float* qc, const float* kv, float* resid,
                                    const float* ln_s, const float* ln_b, float* xn, int B, int N,
                                    int D, int n_heads, void* stream) {
  if (n_heads < 1 || D != n_heads * 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, false>(qc, kv, resid, ln_s, ln_b, xn, B, N, D, n_heads,
                              static_cast<cudaStream_t>(stream));
}
