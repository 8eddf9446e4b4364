// attn_pair: the products of the bf16 attention pair of the training step,
// with the LayerNorms, the 2-key cross-attention and the LayerNorm
// backwards in their prologues and epilogues.
//
// With self_attention.cu's X1 body, and ln_gemm.cu (the conditioning K/V
// and dcond products), gemm_bwd.cu (weight_grad, colsum) and
// attention_bwd.cu (self_attention_bwd), these kernels port the TPU kernel
// K6:
// transformer_latent_diffusion_tpu/ops/fused_attn_vjp.py::_fwd_kernel
// (pallas_call at :255) and ::_bwd_kernel (:276), in bf16. That kernel
// keeps one batch element's rows, the residuals x1 and x2, the queries qc
// and the LayerNorm gradients in VMEM; a Hopper SM cannot hold one
// element's 256 rows with the weights, so the pair is cut into products
// whose prologues and epilogues keep those intermediates on chip instead.
//
// What bounds it on the H100 (B = 128, N = 256, D = 768): the products,
// 0.18 TFLOP forward and 0.56 with the backward's recompute, at the bf16
// tensor peak (989 TFLOP/s at 700 W): 0.18 and 0.56 ms. What held the
// composite of K1's and K2's kernels at a fifth of that was the float32
// traffic between its launches: a float32 copy of x, x1 read and written
// three times, dxn1 and dxn2 written in float32 and read back by the
// LayerNorm backwards, casts of g, x2, dx and dcond.
//
// One kernel body, `pair_gemm_kernel<MODE>`, the main loop of ln_gemm.cu
// (a 128-row tile, one producer thread issuing TMA loads of 64 x 64 bf16
// boxes, 128-byte swizzled, into a ring of stages with full and empty
// `mbarrier`s, two consumer warpgroups multiplying 64 rows each with
// `wgmma` from shared memory, float32 accumulators, a persistent grid),
// with the pair's prologues and epilogues:
// - QKV: LN1 -> QKV from x's bf16 rows. The consumer warps take each
//   row's float32 statistics and write the normalised row in bf16 to an
//   L2-resident scratch (or to xn1, which the backward's dWqkv reads),
//   which the producer then streams as A; no float32 copy of x exists.
//   The recompute also writes (mean, rstd) per row for LN1's backward.
//   128 x 256 tiles, four 48 KB stages.
// - CROSS_FWD: LN2 -> Q from the float32 x1 with the 2-key
//   cross-attention in the epilogue. A 128-column tile holds two whole
//   heads of qc, so qc is rounded to bf16 in registers, its two scores
//   per head are quad-shuffle sums, the 2-way softmax is float32, p is
//   rounded to bf16 before it weighs V (as cross_attention.cu), x2 = x1 +
//   CA is formed in registers and leaves in bf16 by TMA: qc never reaches
//   device memory. A row tile may span two batch elements (N = 144,
//   200): each row takes its own element's K/V.
// - CROSS_BWD: the same product in the recompute, writing xn2 and LN2's
//   statistics, with the cross-attention's backward in the epilogue: dqc
//   (rounded to bf16, stored for dWq and the dxn2 product) is local to a
//   row; dkc and dvc sum over each element's rows: a tile's sums (in a
//   fixed tree of lane shuffles, then over its warps in order) go to a
//   partial per (row tile, element), which `pair_dkv_kernel` adds in
//   row-tile order into dkv (bf16).
// - LNB_X1 / LNB_X: the dX products dxn = dY W (W read as stored, the
//   MN-major operand) with the LayerNorm backward in the epilogue, so dxn
//   never crosses device memory. A row's two sums (of dxhat and dxhat
//   xhat) span all D columns, ceil(D / 192) tiles of 128 x 192 (96
//   accumulators a thread leave the epilogue its registers): their blocks
//   form a thread-block cluster that walks the row tiles together; each
//   pushes its per-row partial sums into every block's shared memory
//   (`st.shared::cluster`) and arrives on its `mbarrier` (release at
//   cluster scope), and every block adds the ranks' sums in rank order, so
//   all of a row's tiles use the same sums. dscale and dbias are summed
//   per row tile (fixed order) into partials that one `colsum` adds.
//   LNB_X1 is LN2's (x1 float32, upstream g bf16, dx1 out float32), LNB_X
//   LN1's (x bf16, upstream dx1, dx out bf16, x's dtype). Three 48 KB
//   stages, each a K step (40 KB) or an epilogue chunk.
//
// The epilogues' operands arrive behind the products: x1 (CROSS_FWD), g
// (CROSS_BWD), and x and the upstream gradient (LNB) come through the TMA
// ring as extra stages after a tile's K steps (LNB's in 128 x 64 chunks,
// once for each of its two passes) and are read from shared memory; the
// element's K/V (CROSS) are loaded into registers before the tile's
// products.
//
// Rounding points are the TPU kernel's (ops/fused_attn_vjp.py:103-243):
// qkv, qc, dqc, ds and dkv rounded to bf16, p rounded before it weighs V
// or g, every sum float32, dx in x's dtype. Every sum runs in an order
// fixed by the shapes, with no atomics: two launches are bit-equal.

#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int BM = 128;                  // output tile rows: two warpgroups of 64
constexpr int BK = 64;                   // K per stage (one 128-byte swizzled box row)
constexpr int BOX_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 TMA box
constexpr int A_BYTES = 2 * BOX_BYTES;   // A's 128 x 64 of a stage
constexpr int OUT_BYTES = 64 * 64 * 4;   // a warpgroup's output staging
constexpr int BF_COLS = OUT_BYTES / 128;
constexpr int F32_COLS = OUT_BYTES / 256;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int MAX_LN_K = 1024;           // the widest row a warp normalises in registers
constexpr int LN_ROWS = 2;  // rows a warp normalises at once, their loads in flight together
constexpr float LN_EPS = 1e-5f;
constexpr int LNB_BN = 192;              // LN backward tile columns: 96 accumulators a thread
constexpr int MAX_RANKS = 6;             // LN backward clusters: D <= 1024 at 192 columns a rank
constexpr int ALL_CONSUMERS = 3;         // named barrier over both consumer warpgroups
constexpr float SCALE = 0.125f;          // 1 / sqrt(64), the head dim's

enum Mode { QKV = 0, CROSS_FWD = 1, CROSS_BWD = 2, LNB_X1 = 3, LNB_X = 4 };

template <int MODE>
struct Cfg {
  static constexpr bool CROSS = MODE == CROSS_FWD || MODE == CROSS_BWD;
  static constexpr bool LNB = MODE == LNB_X1 || MODE == LNB_X;
  static constexpr bool LN = !LNB;
  static constexpr int BN = CROSS ? 128 : LNB ? LNB_BN : 256;
  static constexpr int STAGES = LNB ? 3 : 4;
  // a K step's bytes: A's 128 x 64 and W's BN x 64
  static constexpr int K_BYTES = A_BYTES + BN / 64 * BOX_BYTES;
  // LNB's stages also hold an epilogue chunk: 128 x 64 of float32 and bf16
  static constexpr int STAGE_BYTES = LNB ? 3 * A_BYTES : K_BYTES;
  // the warps' column sums: CROSS_BWD dk0, dk1, dv0, dv1; LNB dscale, dbias
  static constexpr int RED_FLOATS = MODE == CROSS_BWD ? 8 * 4 * BN : LNB ? 8 * 2 * BN : 0;
  // LNB: each rank's per-row (sum dxhat, sum dxhat xhat), two buffers
  static constexpr int XCH_BYTES = LNB ? 2 * MAX_RANKS * 64 * 16 : 0;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int BARS = 2 * STAGES + 3;
  static constexpr int SMEM =
      1024 + RING + CONSUMERS * OUT_BYTES + RED_FLOATS * 4 + XCH_BYTES + BARS * 8;
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  CUtensorMap map_a, map_w, map_o;
  CUtensorMap map_x, map_u;  // the epilogue's: x1 or g (CROSS); x and the upstream (LNB)
  const void* rows_in;  // LN modes: (M, K) rows to normalise, bf16 (QKV) or float32
  const float* ln_s;
  const float* ln_b;
  bf16* rows;           // where the normalised rows go (xn or scratch)
  int rows_global;      // rows holds every row (xn), else a 128-row region per block
  bf16* xn_extra;       // xn when rows is the scratch (or null)
  float2* stats;        // (M,) (mean, rstd): LN modes write it (or null), LNB reads it
  const bf16* kv;       // CROSS: (2B, 2D) conditioning [k | v] rows
  float* part;          // CROSS_BWD: dkv partials; LNB: dscale | dbias partials
  int part_ld;          // LNB: the partials' row stride (floats)
  const void* x;        // LNB: the LayerNorm's input rows (M, N)
  const float* gamma;   // LNB: the LayerNorm scale (N,)
  const void* up;       // LNB: the upstream gradient (M, N)
  int M, N, K, splits, per, n_tok, slots, ranks;
};

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// 8 consecutive elements of a row as loaded (32 bytes of float32, or 16 of
// bf16 kept packed until used: half the registers), widened to float32 by get
template <typename T>
struct Row8;
template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float (&y)[8]) const {
    y[0] = a.x; y[1] = a.y; y[2] = a.z; y[3] = a.w;
    y[4] = b.x; y[5] = b.y; y[6] = b.z; y[7] = b.w;
  }
};
template <>
struct Row8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&y)[8]) const {
    const float2 a = unpack2(u.x), b = unpack2(u.y), c = unpack2(u.z), d = unpack2(u.w);
    y[0] = a.x; y[1] = a.y; y[2] = b.x; y[3] = b.y;
    y[4] = c.x; y[5] = c.y; y[6] = d.x; y[7] = d.y;
  }
};

// The sum over the 8 lanes of a quad column (the lanes with the same
// lane % 4) of v[i], for 8 values at once: after three halving steps lane l
// holds the sum of index (l / 4). 7 shuffles for 8 sums, in a fixed tree.
__device__ __forceinline__ float reduce8_rows(float (&v)[8], int lane) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int o = 16 >> s, half = 4 >> s;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float recv = __shfl_xor_sync(0xffffffffu, send, o);
      v[i] = (up ? v[i + half] : v[i]) + recv;
    }
  }
  return v[0];
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// LNB's epilogue chunks: 128 rows x 64 columns of a row-major (M, N) tensor,
// staged by TMA as 64-row boxes, 128-byte swizzled (16-byte chunk c of a
// box row r at c ^ (r % 8)): float32 in boxes of 32 columns (row half h,
// column half b at box 2 h + b), bf16 in boxes of 64. Two adjacent
// elements at row rr of row half h and column cc of the chunk.
__device__ __forceinline__ float2 chunk2(const unsigned char* st, const float*, int h, int rr,
                                         int cc) {
  const int c = cc & 31;
  const int off = (2 * h + (cc >> 5)) * BOX_BYTES + rr * 128 + (((c >> 2) ^ (rr & 7)) << 4) +
                  (c & 3) * 4;
  return *reinterpret_cast<const float2*>(st + off);
}
__device__ __forceinline__ float2 chunk2(const unsigned char* st, const bf16*, int h, int rr,
                                         int cc) {
  const int off = h * BOX_BYTES + rr * 128 + (((cc >> 3) ^ (rr & 7)) << 4) + (cc & 7) * 2;
  return unpack2(*reinterpret_cast<const uint32_t*>(st + off));
}

// ------------------------- distributed shared memory -------------------------

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the address of this block's shared `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// arrive on a barrier of another block of the cluster; this thread's
// earlier writes become visible to the threads that wait on it
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// ------------------------------ LayerNorm rows ------------------------------

// This warp's LN_ROWS rows r0 .. of the row block at m0: float32 mean, then
// variance over the registers (eps 1e-5), scaled, shifted, rounded to bf16
// into `rows` (row r at rows + r * K) and xn_out (global row m0 + r) if
// given, and (mean, rstd) into stats if given; rows past M are skipped.
// The summation order is ln_gemm.cu's. K <= MAX_LN_K, K % 8 == 0.
template <typename TA>
__device__ __forceinline__ void normalise_rows(const TA* __restrict__ a, const float* __restrict__ ln_s,
                                               const float* __restrict__ ln_b, bf16* __restrict__ rows,
                                               bf16* __restrict__ xn_out, float2* __restrict__ stats,
                                               int m0, int r0, int M, int K, int lane) {
  constexpr int J = MAX_LN_K / 256;
  const int chunks = K / 8;
  Row8<TA> v[LN_ROWS][J];
#pragma unroll
  for (int i = 0; i < LN_ROWS; ++i) {
    const int row = m0 + r0 + i;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (row < M && c < chunks)
        v[i][j].load(a + static_cast<size_t>(row) * K + 8 * c);
      else
        v[i][j].zero();
    }
  }
#pragma unroll
  for (int i = 0; i < LN_ROWS; ++i) {
    const int r = r0 + i, row = m0 + r;
    if (row >= M) continue;  // warp-uniform
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float y[8];
      v[i][j].get(y);
      s += (y[0] + y[1]) + (y[2] + y[3]);
      s += (y[4] + y[5]) + (y[6] + y[7]);
    }
    const float mean = warp_sum(s) / K;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (lane + 32 * j < chunks) {
        float y[8];
        v[i][j].get(y);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 = y[4 * h] - mean, d1 = y[4 * h + 1] - mean;
          const float d2 = y[4 * h + 2] - mean, d3 = y[4 * h + 3] - mean;
          q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / K + LN_EPS);
    if (stats != nullptr && lane == 0) stats[row] = make_float2(mean, rstd);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (c >= chunks) continue;
      float x[8], y[8];
      v[i][j].get(x);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 s4 = reinterpret_cast<const float4*>(ln_s + 8 * c)[h];
        const float4 b4 = reinterpret_cast<const float4*>(ln_b + 8 * c)[h];
        y[4 * h] = (x[4 * h] - mean) * rstd * s4.x + b4.x;
        y[4 * h + 1] = (x[4 * h + 1] - mean) * rstd * s4.y + b4.y;
        y[4 * h + 2] = (x[4 * h + 2] - mean) * rstd * s4.z + b4.z;
        y[4 * h + 3] = (x[4 * h + 3] - mean) * rstd * s4.w + b4.w;
      }
      const uint4 o = pack8_bf16(y);
      *reinterpret_cast<uint4*>(rows + static_cast<size_t>(r) * K + 8 * c) = o;
      if (xn_out != nullptr)
        *reinterpret_cast<uint4*>(xn_out + static_cast<size_t>(row) * K + 8 * c) = o;
    }
  }
}

// ---------------------------------- the kernel ----------------------------------

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) pair_gemm_kernel(const __grid_constant__ Params p) {
  using C = Cfg<MODE>;
  constexpr int BN = C::BN;
  constexpr int STAGES = C::STAGES;
  constexpr bool TW = C::LNB;  // W (K, N) as stored: the dX products
  using TA = typename std::conditional<MODE == QKV, bf16, float>::type;
  using TX = typename std::conditional<MODE == LNB_X, bf16, float>::type;
  using TU = typename std::conditional<MODE == LNB_X1, bf16, float>::type;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  unsigned char* stage_out = smem + C::RING;
  float* red = reinterpret_cast<float*>(stage_out + CONSUMERS * OUT_BYTES);
  float4* xch = reinterpret_cast<float4*>(red + C::RED_FLOATS);  // [2][MAX_RANKS][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(xch) + C::XCH_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* rows_ready = empty + STAGES;
  uint64_t* xbar = rows_ready + 1;  // [2]
  const int tid = threadIdx.x;
  const int M = p.M, N = p.N, K = p.K;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(rows_ready, CONSUMERS);
    // LNB: the row sums of all ranks' 64 quads
    mbar_init(&xbar[0], 64 * p.ranks);
    mbar_init(&xbar[1], 64 * p.ranks);
    mbar_fence_init();
  }
  if constexpr (C::LNB) {
    cluster_sync_all();  // every rank's barriers are initialised before any remote arrive
  } else {
    __syncthreads();
  }
  const int nk = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN;
  const int row_blocks = (M + BM - 1) / BM;
  // units: LN modes a row block and a run of its column tiles; LNB a row
  // block, whose column tile is the block's rank in its cluster
  const int rank = C::LNB ? static_cast<int>(cluster_rank()) : 0;
  const int u0 = C::LNB ? blockIdx.x / p.ranks : blockIdx.x;
  const int ustep = C::LNB ? gridDim.x / p.ranks : gridDim.x;
  const int units = C::LNB ? row_blocks : row_blocks * p.splits;
  auto unit_m0 = [&](int u) { return C::LNB ? u * BM : (u / p.splits) * BM; };
  auto unit_t0 = [&](int u) { return C::LNB ? rank : (u % p.splits) * p.per; };
  auto unit_t1 = [&](int u) { return C::LNB ? rank + 1 : min((u % p.splits) * p.per + p.per, n_tiles); };

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0, ln_phase = 0;
      for (int u = u0; u < units; u += ustep) {
        const int m0 = unit_m0(u);
        int a_row = m0;
        if constexpr (C::LN) {
          // the next unit's input rows into L2 while this one multiplies
          const int nu = u + ustep;
          if (nu < units && nu / p.splits != u / p.splits) {
            const int nm0 = unit_m0(nu);
            const size_t bytes = static_cast<size_t>(min(BM, M - nm0)) * K * sizeof(TA);
            const unsigned char* src = reinterpret_cast<const unsigned char*>(p.rows_in) +
                                       static_cast<size_t>(nm0) * K * sizeof(TA);
            for (size_t off = 0; off < bytes; off += 32768)
              prefetch_l2(src + off, static_cast<uint32_t>(bytes - off < 32768 ? bytes - off : 32768));
          }
          if (!p.rows_global) a_row = blockIdx.x * BM;
          mbar_wait(rows_ready, ln_phase);  // this unit's rows are normalised
          ln_phase ^= 1;
        }
        for (int t = unit_t0(u); t < unit_t1(u); ++t) {
          const int n0 = t * BN;
          for (int kc = 0; kc < nk; ++kc) {
            const int k0 = kc * BK;
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], C::K_BYTES);
            unsigned char* st = ring + stage * C::STAGE_BYTES;
            tma_load_2d(st, &p.map_a, &full[stage], k0, a_row);
            tma_load_2d(st + BOX_BYTES, &p.map_a, &full[stage], k0, a_row + 64);
            unsigned char* ws = st + A_BYTES;
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) {
              if (TW)
                tma_load_2d(ws + j * BOX_BYTES, &p.map_w, &full[stage], n0 + 64 * j, k0);
              else
                tma_load_2d(ws + j * BOX_BYTES, &p.map_w, &full[stage], k0, n0 + 64 * j);
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
          // CROSS: the epilogue's x1 (forward: one stage a head, 128 x 64
          // float32) or g (backward: one stage, 128 x 128 bf16)
          if constexpr (MODE == CROSS_FWD) {
            for (int c0 = n0; c0 < min(n0 + BN, N); c0 += 64) {
              mbar_wait(&empty[stage], phase ^ 1);
              mbar_arrive_expect_tx(&full[stage], 4 * BOX_BYTES);
              unsigned char* st = ring + stage * C::STAGE_BYTES;
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int b = 0; b < 2; ++b)
                  tma_load_2d(st + (2 * h + b) * BOX_BYTES, &p.map_x, &full[stage], c0 + 32 * b,
                              m0 + 64 * h);
              if (++stage == STAGES) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
          if constexpr (MODE == CROSS_BWD) {
            const int heads = (min(n0 + BN, N) - n0) / 64;
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], 2 * heads * BOX_BYTES);
            unsigned char* st = ring + stage * C::STAGE_BYTES;
            for (int hh = 0; hh < heads; ++hh)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                tma_load_2d(st + (2 * hh + h) * BOX_BYTES, &p.map_x, &full[stage], n0 + 64 * hh,
                            m0 + 64 * h);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
          // LNB: the epilogue's x and upstream chunks (64 columns each)
          // through the same ring, once for each of its two passes
          if constexpr (C::LNB) {
            for (int pass = 0; pass < 2; ++pass) {
              for (int c0 = n0; c0 < min(n0 + BN, N); c0 += 64) {
                mbar_wait(&empty[stage], phase ^ 1);
                mbar_arrive_expect_tx(&full[stage], C::STAGE_BYTES);
                unsigned char* st = ring + stage * C::STAGE_BYTES;
                constexpr int XB = sizeof(TX) == 4 ? 2 : 1;  // boxes a 64-row half of x
                constexpr int UB = sizeof(TU) == 4 ? 2 : 1;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
#pragma unroll
                  for (int b = 0; b < XB; ++b)
                    tma_load_2d(st + (XB * h + b) * BOX_BYTES, &p.map_x, &full[stage],
                                c0 + 32 * b, m0 + 64 * h);
#pragma unroll
                  for (int b = 0; b < UB; ++b)
                    tma_load_2d(st + (2 * XB + UB * h + b) * BOX_BYTES, &p.map_u, &full[stage],
                                c0 + 32 * b, m0 + 64 * h);
                }
                if (++stage == STAGES) {
                  stage = 0;
                  phase ^= 1;
                }
              }
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int warp8 = tid >> 5;  // the block's consumer warp, in row order
    unsigned char* obuf = stage_out + wg * OUT_BYTES;
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (int u = u0; u < units; u += ustep, ++it) {
      const int m0 = unit_m0(u);
      if constexpr (C::LN) {
        const bool first = u % p.splits == 0;
        bf16* dst = p.rows + static_cast<size_t>(p.rows_global ? m0 : blockIdx.x * BM) * K;
        const int r0 = wg * 64 + (wt >> 5) * 16;
        for (int r = 0; r < 16; r += LN_ROWS)
          normalise_rows<TA>(static_cast<const TA*>(p.rows_in), p.ln_s, p.ln_b, dst,
                             first ? p.xn_extra : nullptr, first ? p.stats : nullptr, m0, r0 + r,
                             M, K, lane);
        fence_proxy_async_global();  // the rows become visible to the TMA loads
        named_barrier(1 + wg, 128);
        if (wt == 0) mbar_arrive(rows_ready);
      }
      for (int t = unit_t0(u); t < unit_t1(u); ++t) {
        const int n0 = t * BN;
        // thread (wg, wt) holds rows r, r + 8 of the warpgroup's 64 and
        // columns n0 + 8 j + 2 t4 (+1): acc[4 j + 2 h + e]
        const int r = (wt >> 5) * 16 + g;
        const int row0 = m0 + wg * 64;
        const int R[2] = {row0 + r, row0 + r + 8};
        // CROSS_FWD: the first element's K/V at this thread's columns
        // (kvp[head][k0, v0, k1, v1]), loaded into registers before the
        // tile's products so that they arrive behind them (CROSS_BWD,
        // whose epilogue holds more, loads each head's in its epilogue)
        constexpr int HT = C::CROSS ? BN / 64 : 1;  // heads of a tile
        uint32_t kvp[MODE == CROSS_FWD ? HT : 1][4][8];
        if constexpr (MODE == CROSS_FWD) {
          const bf16* kv0 = p.kv + static_cast<size_t>(2 * (m0 / p.n_tok)) * 2 * N;
#pragma unroll
          for (int hh = 0; hh < HT; ++hh) {
            const int cb = n0 + 64 * hh;
            const bool c_ok = cb < N;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = c_ok ? cb + 8 * i + 2 * t4 : 0;
#pragma unroll
              for (int k = 0; k < 4; ++k) kvp[hh][k][i] = c_ok ? ldg_u32(kv0 + k * N + col) : 0u;
            }
          }
        }
        float acc[BN / 2];
        if constexpr (BN != 256) {  // the n128 and n192 products always accumulate
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
          fence_regs(acc);
        }
        int prev = 0;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&full[stage], phase);
          const unsigned char* a = ring + stage * C::STAGE_BYTES + wg * BOX_BYTES;
          const unsigned char* w = ring + stage * C::STAGE_BYTES + A_BYTES;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
            const uint64_t dw = TW ? sw128_desc(w + kk * 2048, BOX_BYTES, 1024)
                                   : sw128_desc(w + kk * 32, 16, 1024);
            if constexpr (BN == 256)
              wgmma_m64n256k16_ss<0, TW ? 1 : 0>(acc, da, dw, kc > 0 || kk > 0);
            else if constexpr (BN == 192)
              wgmma_m64n192k16_ss<0, TW ? 1 : 0>(acc, da, dw);
            else
              wgmma_m64n128k16_ss<0, TW ? 1 : 0>(acc, da, dw);
          }
          wgmma_commit();
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

        if constexpr (C::CROSS) {
          const int D = N;
          const int e_first = m0 / p.n_tok;
          const int e_last = (min(m0 + BM, M) - 1) / p.n_tok;
          // the producer's x1 chunks (a stage a head) or g stage
          const int heads = (min(n0 + BN, N) - n0) / 64;
          const unsigned char* ch[HT];
#pragma unroll
          for (int hh = 0; hh < HT; ++hh) {
            if (hh > 0 && (MODE == CROSS_BWD || hh >= heads)) {
              ch[hh] = ch[0] + 2 * hh * BOX_BYTES;
              continue;
            }
            mbar_wait(&full[stage], phase);
            ch[hh] = ring + stage * C::STAGE_BYTES;
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
          const int taken = MODE == CROSS_BWD ? 1 : heads;
          for (int E = e_first; E <= e_last; ++E) {
            bool in[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) in[h] = R[h] < M && R[h] / p.n_tok == E;
            const bf16* kvE = p.kv + static_cast<size_t>(2 * E) * 2 * D;
            // CROSS_FWD: a tile's later elements (a 128-row tile spans two
            // at N = 144, 200) load their K/V here
            if constexpr (MODE == CROSS_FWD) {
              if (E != e_first) {
#pragma unroll
                for (int hh = 0; hh < HT; ++hh)
#pragma unroll
                  for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                      kvp[hh][k][i] =
                          n0 + 64 * hh < D ? ldg_u32(kvE + k * D + n0 + 64 * hh + 8 * i + 2 * t4) : 0u;
              }
            }
#pragma unroll
            for (int hh = 0; hh < HT; ++hh) {
              if (n0 + 64 * hh >= D) break;
              uint32_t kv4[4][8];  // the head's K/V: preloaded, or (CROSS_BWD) loaded here
#pragma unroll
              for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  if constexpr (MODE == CROSS_FWD)
                    kv4[k][i] = kvp[hh][k][i];
                  else
                    kv4[k][i] = ldg_u32(kvE + k * D + n0 + 64 * hh + 8 * i + 2 * t4);
                }
              const uint32_t(&kp0)[8] = kv4[0];
              const uint32_t(&vp0)[8] = kv4[1];
              const uint32_t(&kp1)[8] = kv4[2];
              const uint32_t(&vp1)[8] = kv4[3];
              if constexpr (MODE == CROSS_FWD) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float d0 = 0.f, d1 = 0.f;
#pragma unroll
                  for (int i = 0; i < 8; ++i) {
                    const float q0 = bf16r(acc[4 * (8 * hh + i) + 2 * h]);
                    const float q1 = bf16r(acc[4 * (8 * hh + i) + 2 * h + 1]);
                    const float2 a0 = unpack2(kp0[i]), a1 = unpack2(kp1[i]);
                    d0 += q0 * a0.x + q1 * a0.y;
                    d1 += q0 * a1.x + q1 * a1.y;
                  }
                  const float s0 = quad_sum(d0) * SCALE, s1 = quad_sum(d1) * SCALE;
                  const float mx = fmaxf(s0, s1);
                  const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
                  const float den = e0 + e1;
                  const float pl0 = bf16r(e0 / den), pl1 = bf16r(e1 / den);
                  if (in[h]) {
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                      const float2 b0 = unpack2(vp0[i]), b1 = unpack2(vp1[i]);
                      const float2 xv = chunk2(ch[hh], static_cast<const float*>(nullptr), wg,
                                               r + 8 * h, 8 * i + 2 * t4);
                      acc[4 * (8 * hh + i) + 2 * h] = xv.x + (pl0 * b0.x + pl1 * b1.x);
                      acc[4 * (8 * hh + i) + 2 * h + 1] = xv.y + (pl0 * b0.y + pl1 * b1.y);
                    }
                  }
                }
              } else {
                uint32_t gp[2][8];
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int i = 0; i < 8; ++i)
                    gp[h][i] = *reinterpret_cast<const uint32_t*>(
                        ch[hh] + wg * BOX_BYTES + (r + 8 * h) * 128 +
                        (((i ^ ((r + 8 * h) & 7))) << 4) + t4 * 4);
                // each row's probabilities and rounded ds of the head's two keys
                float pl[2][2], ds[2][2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float d0 = 0.f, d1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll
                  for (int i = 0; i < 8; ++i) {
                    const float q0 = bf16r(acc[4 * (8 * hh + i) + 2 * h]);
                    const float q1 = bf16r(acc[4 * (8 * hh + i) + 2 * h + 1]);
                    const float2 a0 = unpack2(kp0[i]), a1 = unpack2(kp1[i]);
                    const float2 b0 = unpack2(vp0[i]), b1 = unpack2(vp1[i]);
                    const float2 gv = unpack2(gp[h][i]);
                    d0 += q0 * a0.x + q1 * a0.y;
                    d1 += q0 * a1.x + q1 * a1.y;
                    dp0 += gv.x * b0.x + gv.y * b0.y;
                    dp1 += gv.x * b1.x + gv.y * b1.y;
                  }
                  const float s0 = quad_sum(d0) * SCALE, s1 = quad_sum(d1) * SCALE;
                  dp0 = quad_sum(dp0);
                  dp1 = quad_sum(dp1);
                  const float mx = fmaxf(s0, s1);
                  const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
                  const float den = e0 + e1;
                  const float p0 = e0 / den, p1 = e1 / den;
                  const float dsum = dp0 * p0 + dp1 * p1;
                  // rows outside E add nothing to its sums
                  pl[h][0] = in[h] ? bf16r(p0) : 0.f;
                  pl[h][1] = in[h] ? bf16r(p1) : 0.f;
                  ds[h][0] = in[h] ? bf16r(p0 * (dp0 - dsum) * SCALE) : 0.f;
                  ds[h][1] = in[h] ? bf16r(p1 * (dp1 - dsum) * SCALE) : 0.f;
                }
                // per pair of columns: the two rows' dk0, dk1, dv0, dv1
                // (8 values) summed over the quad column's 8 lanes, then
                // dqc in place of qc
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  float v8[8];
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    float k0 = 0.f, k1 = 0.f, w0 = 0.f, w1 = 0.f;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                      const float q = bf16r(acc[4 * (8 * hh + i) + 2 * h + e]);
                      const float2 gv = unpack2(gp[h][i]);
                      const float gg = e ? gv.y : gv.x;
                      k0 += ds[h][0] * q;
                      k1 += ds[h][1] * q;
                      w0 += pl[h][0] * gg;
                      w1 += pl[h][1] * gg;
                    }
                    v8[4 * e] = k0;
                    v8[4 * e + 1] = k1;
                    v8[4 * e + 2] = w0;
                    v8[4 * e + 3] = w1;
                  }
                  const float sv = reduce8_rows(v8, lane);
                  // lane g holds index g: column e = g / 4, kind k = g % 4
                  const int col = 64 * hh + 8 * i + 2 * t4 + (g >> 2);
                  red[(warp8 * 4 + (g & 3)) * BN + col] = sv;
                  const float2 a0 = unpack2(kp0[i]), a1 = unpack2(kp1[i]);
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    if (!in[h]) continue;
                    acc[4 * (8 * hh + i) + 2 * h] = ds[h][0] * a0.x + ds[h][1] * a1.x;
                    acc[4 * (8 * hh + i) + 2 * h + 1] = ds[h][0] * a0.y + ds[h][1] * a1.y;
                  }
                }
              }
            }
            if constexpr (MODE == CROSS_BWD) {
              // the tile's sums over its rows of element E, warps in row order
              named_barrier(ALL_CONSUMERS, 256);
              float* part = p.part + static_cast<size_t>((m0 / BM) * p.slots + (E - e_first)) * 2 * 2 * D;
              for (int i = tid; i < 4 * BN; i += 256) {
                const int k = i / BN, col = i % BN;
                float sum = 0.f;
#pragma unroll
                for (int w = 0; w < 8; ++w) sum += red[(w * 4 + k) * BN + col];
                if (n0 + col < D) part[(k & 1) * 2 * D + (k >> 1) * D + n0 + col] = sum;
              }
              named_barrier(ALL_CONSUMERS, 256);
            }
          }
          // the chunks back to the producer (the stages taken, in order)
          named_barrier(1 + wg, 128);
          if (wt == 0)
            for (int i = 0; i < taken; ++i) mbar_arrive(&empty[(stage + STAGES - taken + i) % STAGES]);
        }

        if constexpr (C::LNB) {
          float mean[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 st = R[h] < M ? p.stats[R[h]] : make_float2(0.f, 0.f);
            mean[h] = st.x;
            rstd[h] = st.y;
          }
          // the producer's chunks of x (then the upstream gradient) at
          // X_CHUNK (bytes of x in a chunk), in ring order
          constexpr int X_CHUNK = BM * 64 * static_cast<int>(sizeof(TX));
          const int chunks = (min(n0 + BN, N) - n0 + 63) / 64;
          auto take = [&]() {  // the next chunk, once it has landed
            mbar_wait(&full[stage], phase);
            return ring + stage * C::STAGE_BYTES;
          };
          auto give = [&]() {  // this warpgroup is done with the chunk
            named_barrier(1 + wg, 128);
            if (wt == 0) mbar_arrive(&empty[stage]);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          };
          // pass 1: the rows' sums, the tile's column sums of dxn xhat and dxn
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) {
            if (c >= chunks) break;
            const unsigned char* st = take();
#pragma unroll
            for (int jj = 0; jj < 8; jj += 2) {
              float cv8[8];
#pragma unroll
              for (int js = 0; js < 2; ++js) {
                const int j = 8 * c + jj + js, cc = 8 * (jj + js) + 2 * t4;
                const float2 gm = load2(p.gamma + n0 + 8 * j + 2 * t4);
                float cg0 = 0.f, cg1 = 0.f, cb0 = 0.f, cb1 = 0.f;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  // rows past M: x and dY arrive as zeros (the maps end at
                  // M) and their statistics are 0, so xhat and dxn are 0
                  const float2 xv = chunk2(st, static_cast<const TX*>(nullptr), wg, r + 8 * h, cc);
                  const float xh0 = (xv.x - mean[h]) * rstd[h];
                  const float xh1 = (xv.y - mean[h]) * rstd[h];
                  const float d0 = acc[4 * j + 2 * h];
                  const float d1 = acc[4 * j + 2 * h + 1];
                  const float dh0 = d0 * gm.x, dh1 = d1 * gm.y;
                  s1[h] += dh0 + dh1;
                  s2[h] += dh0 * xh0 + dh1 * xh1;
                  cg0 += d0 * xh0;
                  cg1 += d1 * xh1;
                  cb0 += d0;
                  cb1 += d1;
                }
                cv8[4 * js] = cg0;
                cv8[4 * js + 1] = cg1;
                cv8[4 * js + 2] = cb0;
                cv8[4 * js + 3] = cb1;
              }
              const float sv = reduce8_rows(cv8, lane);
              const int js = g >> 2, k = g & 3;
              red[(warp8 * 2 + (k >> 1)) * BN + 8 * (8 * c + jj + js) + 2 * t4 + (k & 1)] = sv;
            }
            give();
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s1[h] = quad_sum(s1[h]);
            s2[h] = quad_sum(s2[h]);
          }
          // every rank's row sums, into every rank's buffer `par`
          const int par = it & 1;
          const int qd = warp8 * 8 + g;
          if (t4 == 0) {
            const float4 v = make_float4(s1[0], s2[0], s1[1], s2[1]);
            const uint32_t slot = smem_u32(&xch[(par * MAX_RANKS + rank) * 64 + qd]);
            const uint32_t bar = smem_u32(&xbar[par]);
            for (int d = 0; d < p.ranks; ++d) {
              st_cluster(mapa(slot, d), v);
              mbar_arrive_cluster(mapa(bar, d));
            }
          }
          // the tile's column sums, warps in row order, while the sums travel
          named_barrier(ALL_CONSUMERS, 256);
          float* part = p.part + static_cast<size_t>(m0 / BM) * p.part_ld;
          for (int i = tid; i < 2 * BN; i += 256) {
            const int k = i / BN, col = i % BN;
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < 8; ++w) sum += red[(w * 2 + k) * BN + col];
            if (n0 + col < N) part[k * N + n0 + col] = sum;
          }
          named_barrier(ALL_CONSUMERS, 256);
          mbar_wait_cluster(&xbar[par], (it >> 1) & 1);
          float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
          for (int d = 0; d < p.ranks; ++d) {
            const float4 v = xch[(par * MAX_RANKS + d) * 64 + qd];
            t1[0] += v.x;
            t2[0] += v.y;
            t1[1] += v.z;
            t2[1] += v.w;
          }
          float m1[2], m2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            m1[h] = t1[h] / N;
            m2[h] = t2[h] / N;
          }
          // pass 2: dx = upstream + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) {
            if (c >= chunks) break;
            const unsigned char* st = take();
#pragma unroll
            for (int jc = 0; jc < 8; ++jc) {
              const int j = 8 * c + jc, cc = 8 * jc + 2 * t4;
              const float2 gm = load2(p.gamma + n0 + 8 * j + 2 * t4);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 xv = chunk2(st, static_cast<const TX*>(nullptr), wg, r + 8 * h, cc);
                const float2 uv = chunk2(st + X_CHUNK, static_cast<const TU*>(nullptr), wg, r + 8 * h, cc);
                const float xh0 = (xv.x - mean[h]) * rstd[h], xh1 = (xv.y - mean[h]) * rstd[h];
                const float dh0 = acc[4 * j + 2 * h] * gm.x, dh1 = acc[4 * j + 2 * h + 1] * gm.y;
                acc[4 * j + 2 * h] = uv.x + rstd[h] * ((dh0 - m1[h]) - xh0 * m2[h]);
                acc[4 * j + 2 * h + 1] = uv.y + rstd[h] * ((dh1 - m1[h]) - xh1 * m2[h]);
              }
            }
            give();
          }
        }

        // the output: staged in the output map's 128-byte swizzle, one TMA
        // store per box (rows past M, columns past N clipped by the map)
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
              tma_store_2d(&p.map_o, obuf + i * BOX_BYTES, c, row0);
            }
            bulk_commit();
          }
        };
        if constexpr (MODE != LNB_X1) {
#pragma unroll
          for (int ps = 0; ps < (BN + BF_COLS - 1) / BF_COLS; ++ps) {
            // BF_COLS columns a pass; BN = 192's second pass has 64
            const int cols = BN - ps * BF_COLS < BF_COLS ? BN - ps * BF_COLS : BF_COLS;
            begin_pass();
#pragma unroll
            for (int jj = 0; jj < BF_COLS / 8; ++jj) {
              const int j = ps * (BF_COLS / 8) + jj;
              if (j >= BN / 8) break;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rr = r + 8 * h;
                const int off = (jj >> 3) * BOX_BYTES + rr * 128 + (((jj & 7) ^ (rr & 7)) << 4) + t4 * 4;
                *reinterpret_cast<uint32_t*>(obuf + off) =
                    pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              }
            }
            end_pass(n0 + ps * BF_COLS, cols / 64, 64);
          }
        } else {
#pragma unroll
          for (int ps = 0; ps < BN / F32_COLS; ++ps) {
            begin_pass();
#pragma unroll
            for (int jj = 0; jj < F32_COLS / 8; ++jj) {
              const int j = ps * (F32_COLS / 8) + jj;
              const int cc = 8 * (jj & 3) + 2 * t4;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rr = r + 8 * h;
                const int off = (jj >> 2) * BOX_BYTES + rr * 128 + (((cc >> 2) ^ (rr & 7)) << 4) + (cc & 3) * 4;
                *reinterpret_cast<float2*>(obuf + off) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              }
            }
            end_pass(n0 + ps * F32_COLS, F32_COLS / 32, 32);
          }
        }
      }
    }
    if (wt == 0) bulk_wait();
  }
  __syncwarp();
  if constexpr (C::LNB) cluster_sync_all();  // no rank leaves while another may write to it
}

// dkv (2B, 2D) bf16 from the CROSS_BWD partials: element b's rows 2b + j
// are the sum over the row tiles that hold its tokens, in row-tile order.
__global__ void __launch_bounds__(256) pair_dkv_kernel(const float* __restrict__ part,
                                                       bf16* __restrict__ dkv, int n_tok, int D,
                                                       int slots) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * 256 + threadIdx.x;  // column of the element's (2, 2D) block
  if (c >= 4 * D) return;
  const int j = c / (2 * D), cc = c % (2 * D);
  const int first = b * n_tok, last = first + n_tok - 1;
  float s = 0.f;
  for (int rb = first / BM; rb <= last / BM; ++rb) {
    const int e0 = rb * BM / n_tok;
    s += part[(static_cast<size_t>(rb * slots + (b - e0)) * 2 + j) * 2 * D + cc];
  }
  dkv[static_cast<size_t>(2 * b + j) * 2 * D + cc] = __float2bfloat16_rn(s);
}

// ------------------------------------ host ------------------------------------

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// LN modes: whole row blocks in a unit, their column tiles split over the
// SMs that the row blocks leave idle (ln_gemm.cu's plan)
void plan(int bn, int M, int N, int* splits, int* per, int* grid) {
  const int sms = sm_count();
  const int row_blocks = (M + BM - 1) / BM, n_tiles = (N + bn - 1) / bn;
  *splits = max(1, min(n_tiles, sms / row_blocks));
  *per = (n_tiles + *splits - 1) / *splits;
  *splits = (n_tiles + *per - 1) / *per;
  *grid = min(row_blocks * *splits, sms);
}

int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int cols, int rows,
              int elem_bytes, int box_cols) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(cols) * elem_bytes};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), 64};
  return encode_map(map, type, 2, ptr, dims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

template <int MODE>
int launch(Params& p, int grid, int ranks, cudaStream_t s) {
  const void* kernel = (const void*)pair_gemm_kernel<MODE>;
  const int smem = Cfg<MODE>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (Cfg<MODE>::LNB) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // one cluster per row block, at most as many as the card holds at once
    static int held[MAX_RANKS + 1] = {};
    if (held[ranks] == 0) {
      cfg.gridDim = dim3(ranks);
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1)
        n = max(1, sm_count() / ranks);
      held[ranks] = n;
    }
    grid = min(grid, held[ranks]) * ranks;
  }
  cfg.gridDim = dim3(grid);
  void* args[] = {&p};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

int ln_maps(Params& p, int bn, const void* w, void* out, bool out_f32, void* xn, void* scratch,
            int* grid) {
  plan(bn, p.M, p.N, &p.splits, &p.per, grid);
  p.rows_global = xn != nullptr && p.splits == 1;
  p.rows = static_cast<bf16*>(p.rows_global ? xn : scratch);
  p.xn_extra = p.rows_global ? nullptr : static_cast<bf16*>(xn);
  if (p.rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int err = encode_2d(&p.map_a, BF, p.rows, p.K, p.rows_global ? p.M : *grid * BM, 2, 64);
  if (!err) err = encode_2d(&p.map_w, BF, w, p.K, p.N, 2, 64);
  if (!err) err = out_f32 ? encode_2d(&p.map_o, F32, out, p.N, p.M, 4, 32)
                          : encode_2d(&p.map_o, BF, out, p.N, p.M, 2, 64);
  return err;
}

bool ln_shape_ok(int M, int N, int K) {
  return M >= 1 && N >= 8 && N % 8 == 0 && K >= 64 && K % 64 == 0 && K <= MAX_LN_K;
}

}  // namespace

// Rows of bf16 scratch (each D wide) for a LayerNorm product's normalised
// rows: 0 when xn is given and each row block is one unit (the rows go
// there). cross: the LN2 -> Q product (128-column tiles), else LN1 -> QKV.
LTD_API int ltd_pair_scratch_rows(int M, int N, int cross, int with_xn) {
  if (M < 1 || N < 1) return 0;
  int splits, per, grid;
  plan(cross ? 128 : 256, M, N, &splits, &per, &grid);
  return with_xn && splits == 1 ? 0 : grid * BM;
}

// qkv (M, 3D) bf16 = bf16(LN1(x) Wqkv^T): x (M, D) bf16, Wqkv (3D, D) bf16,
// ln_s / ln_b (D,) float32. xn (M, D) bf16 and stats (M,) float2 (mean,
// rstd) are written when not null. D % 64 == 0, D <= 1024.
LTD_API int ltd_pair_qkv(const void* x, const float* ln_s, const float* ln_b, const void* w,
                         void* qkv, void* xn, float* stats, void* scratch, int M, int D,
                         void* stream) {
  Params p = {};
  p.M = M;
  p.N = 3 * D;
  p.K = D;
  if (!ln_shape_ok(M, p.N, D)) return static_cast<int>(cudaErrorInvalidValue);
  p.rows_in = x;
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.stats = reinterpret_cast<float2*>(stats);
  p.ranks = 1;
  int grid = 0;
  const int err = ln_maps(p, 256, w, qkv, false, xn, scratch, &grid);
  if (err) return err;
  return launch<QKV>(p, grid, 1, static_cast<cudaStream_t>(stream));
}

// x2 (M, D) bf16 = x1 + CA(bf16(LN2(x1) Wq^T), kv): x1 (M, D) float32,
// rows of n_tok tokens per batch element, kv (2B, 2D) bf16 (rows 2b, 2b + 1:
// [k | v] of element b's two conditioning tokens), head dim 64.
LTD_API int ltd_pair_cross_fwd(const float* x1, const float* ln_s, const float* ln_b,
                               const void* wq, const void* kv, void* x2, void* scratch, int M,
                               int D, int n_tok, void* stream) {
  Params p = {};
  p.M = M;
  p.N = D;
  p.K = D;
  if (!ln_shape_ok(M, D, D) || n_tok < 1 || M % n_tok) return static_cast<int>(cudaErrorInvalidValue);
  p.rows_in = x1;
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.kv = static_cast<const bf16*>(kv);
  p.n_tok = n_tok;
  p.ranks = 1;
  int grid = 0;
  int err = ln_maps(p, 128, wq, x2, false, nullptr, scratch, &grid);
  if (!err) err = encode_2d(&p.map_x, F32, x1, D, M, 4, 32);  // the epilogue's x1 chunks
  if (err) return err;
  return launch<CROSS_FWD>(p, grid, 1, static_cast<cudaStream_t>(stream));
}

// The recompute's LN2 -> Q with the cross-attention backward: dqc (M, D)
// bf16, xn2 (M, D) bf16, stats (M,) float2, and part ((M + 127) / 128 *
// slots * 2, 2D) float32, the tiles' dkv sums per element (slots: the most
// elements a 128-row tile spans); then dkv (2B, 2D) bf16 by pair_dkv_kernel.
// g (M, D) bf16, the upstream gradient at x2.
LTD_API int ltd_pair_cross_bwd(const float* x1, const float* ln_s, const float* ln_b,
                               const void* wq, const void* kv, const void* g, void* dqc, void* xn2,
                               float* stats, float* part, void* dkv, void* scratch, int M, int D,
                               int n_tok, int slots, void* stream) {
  Params p = {};
  p.M = M;
  p.N = D;
  p.K = D;
  if (!ln_shape_ok(M, D, D) || n_tok < 1 || M % n_tok || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rows_in = x1;
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.stats = reinterpret_cast<float2*>(stats);
  p.kv = static_cast<const bf16*>(kv);
  p.part = part;
  p.n_tok = n_tok;
  p.slots = slots;
  p.ranks = 1;
  int grid = 0;
  int err = ln_maps(p, 128, wq, dqc, false, xn2, scratch, &grid);
  if (!err) err = encode_2d(&p.map_x, BF, g, D, M, 2, 64);  // the epilogue's g
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch<CROSS_BWD>(p, grid, 1, s);
  if (err) return err;
  const int B = M / n_tok;
  pair_dkv_kernel<<<dim3((4 * D + 255) / 256, B), 256, 0, s>>>(part, static_cast<bf16*>(dkv),
                                                                n_tok, D, slots);
  return static_cast<int>(cudaGetLastError());
}

// out = upstream + LayerNorm backward of dxn = dy W: dy (M, K) bf16, w (K, N)
// bf16 as stored (the forward's (out, in) weight), x (M, N) the
// LayerNorm's input with its stats (M,) float2, gamma (N,) float32. ln2
// non-zero: x float32, upstream bf16, out float32 (LN2's: dx1); else x
// bf16, upstream float32, out bf16 (LN1's: dx). part: the row tiles'
// column sums, part[t * part_ld + c] of dscale, + N of dbias. N % 64 == 0,
// N <= 1024, K % 64 == 0.
LTD_API int ltd_pair_ln_bwd(const void* dy, const void* w, const void* x, const float* stats,
                            const float* gamma, const void* up, void* out, float* part,
                            int part_ld, int M, int N, int K, int ln2, void* stream) {
  if (M < 1 || N < 64 || N % 64 || N > 1024 || K < 64 || K % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.M = M;
  p.N = N;
  p.K = K;
  p.x = x;
  p.stats = reinterpret_cast<float2*>(const_cast<float*>(stats));
  p.gamma = gamma;
  p.up = up;
  p.part = part;
  p.part_ld = part_ld;
  p.ranks = (N + LNB_BN - 1) / LNB_BN;
  int err = encode_2d(&p.map_a, BF, dy, K, M, 2, 64);
  if (!err) err = encode_2d(&p.map_w, BF, w, N, K, 2, 64);
  // the epilogue's chunks: x float32 (ln2) or bf16, the upstream the other
  if (!err) err = ln2 ? encode_2d(&p.map_x, F32, x, N, M, 4, 32) : encode_2d(&p.map_x, BF, x, N, M, 2, 64);
  if (!err) err = ln2 ? encode_2d(&p.map_u, BF, up, N, M, 2, 64) : encode_2d(&p.map_u, F32, up, N, M, 4, 32);
  if (!err) err = ln2 ? encode_2d(&p.map_o, F32, out, N, M, 4, 32)
                      : encode_2d(&p.map_o, BF, out, N, M, 2, 64);
  if (err) return err;
  const int row_blocks = (M + BM - 1) / BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ln2 ? launch<LNB_X1>(p, row_blocks, p.ranks, s) : launch<LNB_X>(p, row_blocks, p.ranks, s);
}
