// flash_attention: o = softmax(q k^T / sqrt(64)) v per (image, head), any Nq, Nk >= 8.
//
// Replaces transformer_latent_diffusion_tpu/ops/attention.py::_pallas_attention
// (`_flash_kernel`, pallas_call at attention.py:99): one program per
// (batch*head, 256-query block) holding the head's whole K and V in VMEM.
//
// What bounds it on the H100: 4 * N^2 * 64 operations per (image, head)
// against 4 * N * 64 * 2 bytes of q, k, v and o, i.e. N / 2 operations per
// byte: at N = 1024 that is 512, above the card's ~295 balance point, so the
// tensor cores bound it (0.21 ms for 64 images x 12 heads at 989 TFLOP/s),
// and more so at 4096 tokens. At head dim 64 the exponentials come close:
// N^2 of them per (image, head) at 16 a clock per SM (MUFU) take about as
// long as the products, so the design overlaps the two.
//
// What this design does about that. A Hopper SM has 227 KB of shared
// memory, and one head's K and V are already 256 KB of bf16 at 1024
// tokens, so unlike the TPU kernel (and the <= 256-token self_attention.cu)
// it never holds a whole score row: K and V stream past the queries.
// - A persistent grid (one block per SM) walks the work items (image,
//   head, 192-query tile), the query tiles of a head one after another, so
//   the SMs that run at once read the same few heads' K and V and L2
//   serves them.
// - One producer thread brings each item's Q (three 64 x 64 boxes, into
//   one of two buffers, so the next item's Q arrives during this one) and
//   its K and V in 128-key tiles through a ring of four 32 KB stages with
//   full and empty `mbarrier`s, all by TMA (`cp.async.bulk.tensor`,
//   128-byte swizzle) over 3-D tensor maps (columns, tokens, images) of the
//   q, k and v views with their row strides: the column blocks of a fused
//   QKV projection are read in place. Rows past N of the ragged last tile
//   arrive as zeros, never as the next image's rows.
// - Three consumer warpgroups (`setmaxnreg`: 160 registers, the producer's
//   warpgroup 32) own 64 query rows each. Per key tile: S = Q K^T with
//   `wgmma` m64n128k16 from shared memory (float32 accumulators, the first
//   product write-only so the softmax's in-place writes do not serialise
//   the next one); keys past Nk set to -inf before the row max; the
//   online softmax in base 2, log2 e folded into the 1/8 scale (one FFMA
//   and one MUFU.EX2 per score), the sum kept per thread (its quad
//   reduction once, at the end);
//   P rounded to bf16 in registers as the A operand of O += P V (`wgmma`
//   m64n64k16, V the MN-major B operand).
// - Step j issues S of tile j, then P V of tile j - 1, waits for S only
//   and runs the exponentials of tile j while P V runs; then O is
//   rescaled and P packed. The
//   warpgroups take turns at the tensor cores (named barriers in a ring),
//   so one warpgroup's exponentials run while another's products do. A
//   warpgroup whose rows all lie past Nq (the ragged last query tile) only
//   keeps the ring's and the turns' counts.
// - After the last tile each row takes one reciprocal of its sum; O is
//   rounded to bf16 and stored from the registers, rows past Nq skipped.
//   Each output element has one writer: two launches are bit-equal.
//
// Softmax forms (template flags; K3 is <EXP2 = true, PREDIV = false>, the
// probe scripts/probe_attn_softmax.py's `attn` (pallas_call at :55) runs
// all four):
// - EXP2: exp(x) as one MUFU.EX2 (`ex2.approx.ftz`) of x log2 e; else
//   expf (without fast math, four FFMAs of range reduction around each
//   MUFU.EX2, PERF.md).
// - PREDIV: p normalised in float32 before it is rounded to bf16 (the TPU
//   K3's and the probe's "prediv" rounding): pass 1 streams K only and
//   takes the row max m and sum l; pass 2 streams K and V again,
//   p = exp(s - m) / l (a float32 division per score), no rescaling, O
//   stored undivided. Both passes are one ring sequence of 2 x n_tiles
//   steps, so pass 2's first tiles load while pass 1 ends. PREDIV runs
//   two consumer warpgroups (128-query items; with three, its division and
//   its second pass do not fit the registers); a row's arithmetic does
//   not depend on the count. Without PREDIV ("postdiv") e = exp(s -
//   m_running) is rounded and O / l taken at the end.
//
// Rounding differs from the TPU kernel, which normalises p in float32 and
// then rounds it to bf16 before P V (PREDIV); K3 rounds exp2(s - m) with
// the running max and divides by the float32 sum at the end. Both round p
// once with a float32 softmax; they differ by about one bf16 step of p.
//
// For training, the wrapper also passes `lse`, and the kernel writes each
// query row's float32 log-sum-exp of the scaled scores there in natural-log
// units, (B, H, Nq) row-major: with the base-2 running max m2 = m * log2(e)
// / 8 it is (m2 + log2 l) * ln 2. The backward (flash_attention_bwd.cu,
// TPU kernel K4) reads it to recompute p = exp(s - lse). Serving passes
// null and writes nothing more.

#include "hopper.cuh"

#include <math.h>


namespace {

constexpr int DH = 64;
constexpr int KT = 128;                   // keys per ring stage
constexpr int BOX_BYTES = 64 * 64 * 2;    // one 64 x 64 bf16 TMA box
constexpr int KV_BYTES = 2 * BOX_BYTES;   // K or V of one key tile
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int STAGES = 4;

// NC consumer warpgroups of 64 query rows each, and a producer warpgroup
template <int NC>
struct Shape {
  static constexpr int QT = 64 * NC;            // queries per work item
  static constexpr int Q_BYTES = NC * BOX_BYTES;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 4) * 8;
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// EXP2: one MUFU.EX2 (`ex2.approx.ftz`; -inf gives 0); else expf
template <bool EXP2>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (EXP2) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  } else {
    return expf(x);
  }
}

__device__ __forceinline__ float quad_max(float v) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// S = Q K^T of 64 query rows and a 128-key tile, both K-major (issued, not waited for)
__device__ __forceinline__ void issue_scores(float (&s)[64], const unsigned char* q,
                                             const unsigned char* k) {
  wgmma_fence();
  wgmma_m64n128k16_ss_first(s, sw128_desc(q, 16, 1024), sw128_desc(k, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < DH / 16; ++kk)
    wgmma_m64n128k16_ss<0, 0>(s, sw128_desc(q + kk * 32, 16, 1024),
                              sw128_desc(k + kk * 32, 16, 1024));
  wgmma_commit();
}

// O += P V for a 128-key tile: P in registers (block kc: keys 16 kc ..),
// V (keys x 64) the MN-major B operand (issued, not waited for)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[KT / 16][4],
                                         const unsigned char* v) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KT / 16; ++kc)
    wgmma_m64n64k16_rs<1>(o, p[kc], sw128_desc(v + kc * 2048, BOX_BYTES, 1024));
  wgmma_commit();
}

template <bool EXP2, bool PREDIV, int NC>
__global__ void __launch_bounds__(Shape<NC>::THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                       float* __restrict__ lse, int B, int Nq, int Nk, int H) {
  using S = Shape<NC>;
  // scores in the exponent's base: s * C - m * C
  constexpr float C = EXP2 ? 0.125f * LOG2E : 0.125f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qbuf = smem;
  unsigned char* ring = smem + 2 * S::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 2;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NC);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_qt = (Nq + S::QT - 1) / S::QT;
  const int items = B * H * n_qt;
  const int n_tiles = (Nk + KT - 1) / KT;
  // PREDIV reads the key tiles twice: steps [0, n_tiles) are pass 1 (K only)
  const int n_steps = PREDIV ? 2 * n_tiles : n_tiles;

  if (tid >= NC * 128) {
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    else setmaxnreg_dec<32>();
    if (tid == NC * 128) {
      int stage = 0, qi = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
        const int b = it / (H * n_qt), col = ((it / n_qt) % H) * DH, q0 = (it % n_qt) * S::QT;
        const int qs = qi & 1;
        mbar_wait(&qempty[qs], ((qi >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&qfull[qs], S::Q_BYTES);
#pragma unroll
        for (int w = 0; w < NC; ++w)
          tma_load_3d(qbuf + qs * S::Q_BYTES + w * BOX_BYTES, &map_q, &qfull[qs], col, q0 + 64 * w, b);
        for (int step = 0; step < n_steps; ++step) {
          const int key0 = (PREDIV ? step % n_tiles : step) * KT;
          const bool with_v = !PREDIV || step >= n_tiles;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], with_v ? STAGE_BYTES : KV_BYTES);
          unsigned char* st = ring + stage * STAGE_BYTES;
          tma_load_3d(st, &map_k, &full[stage], col, key0, b);
          tma_load_3d(st + BOX_BYTES, &map_k, &full[stage], col, key0 + 64, b);
          if (with_v) {
            tma_load_3d(st + KV_BYTES, &map_v, &full[stage], col, key0, b);
            tma_load_3d(st + KV_BYTES + BOX_BYTES, &map_v, &full[stage], col, key0 + 64, b);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    if constexpr (NC == 2) setmaxnreg_inc<232>();
    else setmaxnreg_inc<160>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    // The warpgroups take turns at the tensor cores, in a ring: each issues
    // its products when the one before it has issued its own (named
    // barrier 1 + wg: its 128 threads wait, the previous warpgroup's 128
    // arrive), so one warpgroup's exponentials run while another's
    // products do.
    auto turn = [&]() { named_barrier(1 + wg, 256); };
    auto pass_turn = [&]() { named_barrier_arrive(1 + (wg + 1) % NC, 256); };
    if (wg == NC - 1) named_barrier_arrive(1, 256);  // warpgroup 0 takes the first turn
    int stage = 0, qi = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++qi) {
      const int b = it / (H * n_qt), h = (it / n_qt) % H, q0 = (it % n_qt) * S::QT;
      const int qs = qi & 1;
      mbar_wait(&qfull[qs], (qi >> 1) & 1);
      if (q0 + wg * 64 >= Nq) {
        // this warpgroup's 64 rows all lie past Nq (the ragged last query
        // tile): it multiplies nothing, only takes its turns and frees each
        // stage once the next has arrived, as the other warpgroups do
        for (int step = 0; step < n_steps; ++step) {
          mbar_wait(&full[stage], phase);
          turn();
          pass_turn();
          if (step > 0 && wt == 0) mbar_arrive(&empty[stage == 0 ? STAGES - 1 : stage - 1]);
          advance();
        }
        turn();
        pass_turn();
        if (wt == 0) {
          mbar_arrive(&empty[stage == 0 ? STAGES - 1 : stage - 1]);
          mbar_arrive(&qempty[qs]);
        }
        continue;
      }
      const unsigned char* qw = qbuf + qs * S::Q_BYTES + wg * BOX_BYTES;

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float s[64];
      uint32_t p[KT / 16][4];
      // rows r_lo and r_lo + 8: running max (raw scores), per-thread sums
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      float c0 = 1.f, c1 = 1.f;  // O's rescale factors

      // the softmax of step `step` on s, in place: the row max, s = the
      // exponentials (pass 2 of PREDIV: divided by the final sum; pass 1:
      // m and l only) and the rescale factors c
      auto softmax = [&](int step) {
        const int tile = PREDIV ? step % n_tiles : step;
        if ((tile + 1) * KT > Nk) {  // the ragged last tile: keys past Nk
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (tile * KT + 8 * j + 2 * t4 + (e & 1) >= Nk) s[4 * j + e] = -INFINITY;
        }
        if (PREDIV && step >= n_tiles) {  // pass 2: p = exp(s - m) / l, final m and l
          if (step == n_tiles) {
            l0 = quad_sum(l0);
            l1 = quad_sum(l1);
          }
          const float off0 = -m0 * C, off1 = -m1 * C;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            s[4 * j] = exp_of<EXP2>(fmaf(s[4 * j], C, off0)) / l0;
            s[4 * j + 1] = exp_of<EXP2>(fmaf(s[4 * j + 1], C, off0)) / l0;
            s[4 * j + 2] = exp_of<EXP2>(fmaf(s[4 * j + 2], C, off1)) / l1;
            s[4 * j + 3] = exp_of<EXP2>(fmaf(s[4 * j + 3], C, off1)) / l1;
          }
          return;
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        // every tile holds at least one key, so the new max is finite
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float off0 = -mx0 * C, off1 = -mx1 * C;
        c0 = exp_of<EXP2>(fmaf(m0, C, off0));  // O's rescale, once its last P V is done
        c1 = exp_of<EXP2>(fmaf(m1, C, off1));
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          s[4 * j] = exp_of<EXP2>(fmaf(s[4 * j], C, off0));
          s[4 * j + 1] = exp_of<EXP2>(fmaf(s[4 * j + 1], C, off0));
          s[4 * j + 2] = exp_of<EXP2>(fmaf(s[4 * j + 2], C, off1));
          s[4 * j + 3] = exp_of<EXP2>(fmaf(s[4 * j + 3], C, off1));
          sum0 += s[4 * j] + s[4 * j + 1];
          sum1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * c0 + sum0;
        l1 = l1 * c1 + sum1;
      };
      // P = bf16(s), in the A-operand layout of m64k16: block kc holds keys
      // 16 kc .. 16 kc + 15, i.e. accumulator blocks 2 kc and 2 kc + 1
      auto pack = [&]() {
#pragma unroll
        for (int kc = 0; kc < KT / 16; ++kc) {
          const float* s0 = s + 8 * kc;
          p[kc][0] = pack_bf16x2(s0[0], s0[1]);
          p[kc][1] = pack_bf16x2(s0[2], s0[3]);
          p[kc][2] = pack_bf16x2(s0[4], s0[5]);
          p[kc][3] = pack_bf16x2(s0[6], s0[7]);
        }
      };
      // O *= c: the max moved. Done between a P V's wait and the next
      // issue, never while a product is in flight: a register that a
      // pending wgmma accumulates into must not be written by other
      // instructions, or ptxas serialises every wgmma of the kernel.
      auto rescale = [&]() {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          o[4 * d] *= c0;
          o[4 * d + 1] *= c0;
          o[4 * d + 2] *= c1;
          o[4 * d + 3] *= c1;
        }
      };

      // Step j issues S of tile j and then P V of tile j - 1 (its P packed
      // and O rescaled at the end of step j - 1), waits for S only, and
      // runs the exponentials of tile j while P V runs; O is rescaled and P
      // packed once P V is done.
      mbar_wait(&full[stage], phase);
      turn();
      issue_scores(s, qw, ring + stage * STAGE_BYTES);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      if (!PREDIV) pack();
      int cur = stage;
      advance();
      for (int step = 1; step < n_steps; ++step) {
        mbar_wait(&full[stage], phase);
        turn();
        issue_scores(s, qw, ring + stage * STAGE_BYTES);
        const bool pv = !PREDIV || step - 1 >= n_tiles;  // step - 1 multiplies V
        if (pv) issue_pv(o, p, ring + cur * STAGE_BYTES + KV_BYTES);
        pass_turn();
        if (pv)
          wgmma_wait<1>();  // S of this step; P V of the last one may run on
        else
          wgmma_wait<0>();
        fence_regs(s);
        softmax(step);
        if (pv) {
          wgmma_wait<0>();
          fence_regs(o);
#pragma unroll
          for (int kc = 0; kc < KT / 16; ++kc) fence_regs(p[kc]);
        }
        if (wt == 0) mbar_arrive(&empty[cur]);  // the products of step - 1 are done
        // (no row of the warp moved its max: nothing to rescale)
        if (!PREDIV) rescale();
        if (!PREDIV || step >= n_tiles) pack();
        cur = stage;
        advance();
      }
      turn();
      issue_pv(o, p, ring + cur * STAGE_BYTES + KV_BYTES);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc) fence_regs(p[kc]);
      if (wt == 0) {
        mbar_arrive(&empty[cur]);
        mbar_arrive(&qempty[qs]);  // every product that read this Q is done
      }

      if (!PREDIV) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
      // PREDIV's P was normalised already
      const float inv0 = PREDIV ? 1.f : 1.f / l0, inv1 = PREDIV ? 1.f : 1.f / l1;
      const int D = H * DH;
      const int r0 = q0 + wg * 64 + (wt >> 5) * 16 + g, r1 = r0 + 8;
      bf16* o0 = out + (static_cast<size_t>(b) * Nq + r0) * D + h * DH + 2 * t4;
      bf16* o1 = o0 + static_cast<size_t>(8) * D;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        if (r0 < Nq)
          *reinterpret_cast<uint32_t*>(o0 + 8 * d) = pack_bf16x2(o[4 * d] * inv0, o[4 * d + 1] * inv0);
        if (r1 < Nq)
          *reinterpret_cast<uint32_t*>(o1 + 8 * d) =
              pack_bf16x2(o[4 * d + 2] * inv1, o[4 * d + 3] * inv1);
      }
      if (lse != nullptr && t4 == 0) {  // the 4 lanes of a quad hold the same m and l
        float* lb = lse + (static_cast<size_t>(b) * H + h) * Nq;
        if (r0 < Nq) lb[r0] = EXP2 ? (m0 * C + log2f(l0)) * LN2 : m0 * C + logf(l0);
        if (r1 < Nq) lb[r1] = EXP2 ? (m1 * C + log2f(l1)) * LN2 : m1 * C + logf(l1);
      }
    }
    if (wg == 0) named_barrier(1, 256);  // the last warpgroup's last pass of the turn
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

// a 3-D map over the (B, N, row) view: columns [0, D), N tokens, B images
int view_map(CUtensorMap* map, const void* ptr, int B, int N, int D, int row) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(row) * 2,
                               static_cast<uint64_t>(N) * row * 2};
  const uint32_t box[3] = {DH, 64, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool EXP2, bool PREDIV, int NC>
int launch_nc(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out,
              float* lse, int B, int Nq, int Nk, int n_heads, cudaStream_t stream) {
  using S = Shape<NC>;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<EXP2, PREDIV, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = B * n_heads * ((Nq + S::QT - 1) / S::QT);
  const int sms = sm_count();
  flash_attention_kernel<EXP2, PREDIV, NC><<<items < sms ? items : sms, S::THREADS, S::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, B, Nq, Nk, n_heads);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXP2, bool PREDIV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Nq,
           int Nk, int n_heads, int q_row, int k_row, int v_row, void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || n_heads < 1 || q_row % 8 || k_row % 8 || v_row % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = n_heads * DH;
  CUtensorMap map_q, map_k, map_v;
  if (int err = view_map(&map_q, q, B, Nq, D, q_row)) return err;
  if (int err = view_map(&map_k, k, B, Nk, D, k_row)) return err;
  if (int err = view_map(&map_v, v, B, Nk, D, v_row)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // PREDIV's two passes take two consumer warpgroups (with three, its
  // division and second pass do not fit the registers); each query row's
  // arithmetic is the same either way
  if constexpr (PREDIV)
    return launch_nc<EXP2, PREDIV, 2>(map_q, map_k, map_v, out, lse, B, Nq, Nk, n_heads, s);
  else
    return launch_nc<EXP2, PREDIV, 3>(map_q, map_k, map_v, out, lse, B, Nq, Nk, n_heads, s);
}

}  // namespace

// q: (B*Nq, *) bf16 rows with row stride q_row elements, head h at columns
// h*64; k, v: (B*Nk, *) bf16 rows with strides k_row, v_row. out: (B*Nq, D)
// bf16, D = n_heads * 64. lse: null, or (B, n_heads, Nq) float32 for each
// row's log-sum-exp. Row strides are multiples of 8 and the pointers
// 16-byte aligned (TMA). Requires Nq, Nk >= 1 (the wrapper asks for >= 8).
LTD_API int ltd_flash_attention(const void* q, const void* k, const void* v, void* out,
                                float* lse, int B, int Nq, int Nk, int n_heads, int q_row,
                                int k_row, int v_row, void* stream) {
  return launch<true, false>(q, k, v, out, lse, B, Nq, Nk, n_heads, q_row, k_row, v_row,
                             stream);
}

// The softmax forms of the probe (see the header), with the operands of
// ltd_flash_attention and no lse: use_exp2 and prediv select the form.
LTD_API int ltd_flash_attention_variant(const void* q, const void* k, const void* v, void* out,
                                        int B, int Nq, int Nk, int n_heads, int q_row,
                                        int k_row, int v_row, int use_exp2, int prediv,
                                        void* stream) {
  if (use_exp2)
    return prediv ? launch<true, true>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                       v_row, stream)
                  : launch<true, false>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                        v_row, stream);
  return prediv ? launch<false, true>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                      v_row, stream)
                : launch<false, false>(q, k, v, out, nullptr, B, Nq, Nk, n_heads, q_row, k_row,
                                       v_row, stream);
}
