// flash_attention_f32: o = softmax(q k^T / sqrt(64)) v per (image, head),
// float32 q, k, v and probabilities, any Nq, Nk >= 8, at float32 accuracy on
// the tensor cores (3xTF32 wgmma): the float32 form of flash_attention.cu.
//
// Replaces transformer_latent_diffusion_tpu/ops/attention.py::_pallas_attention
// (`_flash_kernel`, pallas_call at attention.py:99) when its inputs are
// float32 (the JAX package's default compute dtype on the linen path: 512
// and 1024 px deployments, the "mlp" and "moe" FFNs, a model sampled on
// another grid). The TPU kernel computes in the input dtype: the scores and
// P V accumulate in float32 and `p = (e / z).astype(v.dtype)` rounds
// nothing.
//
// What bounds it on the H100: 4 * N^2 * 64 operations per (image, head) of
// float32 products, which run as three TF32 products each (hopper.cuh): at
// 512 px (B = 64, 12 heads, N = 1024) 206 GFLOP at 495 / 3 TFLOP/s, 1.25
// ms, against 0.24 ms for its 805 MB of q, k, v and o; at 1024 px (B = 8,
// N = 4096) 412 GFLOP, 2.50 ms. The products bound it; the N^2 exponentials
// (0.8 G at 512 px) come next.
//
// What this design does about that. flash_attention.cu's streaming
// skeleton on self_attention_f32.cu's float32 machinery (f32_chunk.cuh):
// - A persistent grid (one block per SM) walks the work items (image, head,
//   128-query tile), the query tiles of a head one after another, so the
//   SMs that run at once read the same few heads' K and V and L2 serves
//   them.
// - K and V stream through in chunks of 64 keys, K then V of each chunk.
//   One producer thread brings each chunk with TMA (a 3-D map over the
//   (B, N, row) view, the column blocks of a fused QKV projection read in
//   place; two 64 x 32 float32 boxes, 128-byte swizzled; keys past Nk
//   arrive as zeros) into a ring of four raw slots; the producer
//   warpgroup's three other warps split each into its TF32 parts in a
//   ring of four split slots, K as it is and V transposed into the slot
//   order P's registers take (f32_chunk.cuh). A slot goes back to the
//   splitters when both consumer warpgroups are done with it.
// - Two consumer warpgroups (`setmaxnreg`: 232 registers, the producer's
//   40) own 64 query rows each, so both read every split chunk: the splits
//   are paid once per 128 queries. A thread loads its Q fragments (rows r,
//   r + 8; zeros past Nq) once per item and keeps their TF32 parts in
//   registers. Per chunk: S = Q K^T as 3 x 8 `wgmma` m64n64k8.tf32 (A from
//   registers, the small terms first), keys past Nk at -inf; the online
//   softmax in float32: the row max over the thread's 16 scores of a row and
//   its quad, c = exp((m_old - m) / 8) (0 at the first chunk), e =
//   exp(s / 8 - m / 8) by `expf` (s / 8 and m / 8 exact), the running sum
//   l = l c + sum(e) per thread; then P V as 3 x 8 `wgmma` into a fresh 64 x
//   64 partial, P's fragments split from the score registers as they are,
//   and O = O c + partial in float32 with ordinary rounding (one FFMA per
//   element: the tensor cores may add with truncation, and one chain over
//   4096 keys would drift past float32 accuracy;
//   tests/test_torch_port_tf32_split.py emulates this schedule). No
//   probability is rounded.
// - After the last chunk the quad adds its sums, and each row's O is
//   divided by l and stored from the registers (rows past Nq skipped). Each
//   output element has one writer and every sum a fixed order: two
//   launches are bit-equal.
// - With `lse` (training: the backward, flash_attention_bwd_f32.cu, reads
//   it), the threads of t % 4 == 0 also write each row's float32
//   log-sum-exp m / 8 + log(l); o is computed as without it.
// Shared memory: 4 x 16 KB raw slots and 4 x 32 KB split slots, 193 KB: one
// block per SM.

#include "f32_chunk.cuh"

#include <math.h>

namespace {

using namespace f32chunk;

constexpr int RAW_SLOTS = 4, SPLIT_SLOTS = 4;
constexpr int CONSUMERS = 2;
constexpr int QT = CONSUMERS * TILE;  // queries of a work item
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SMEM = 1024 + RAW_SLOTS * RAW_BYTES + SPLIT_SLOTS * SPLIT_BYTES +
                     2 * (RAW_SLOTS + SPLIT_SLOTS) * 8;

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

// the work item `it`: image b, head h, the first query q0 of its tile
struct Item {
  int b, h, q0;
  __device__ __forceinline__ Item(int it, int n_qt, int H)
      : b(it / (H * n_qt)), h((it / n_qt) % H), q0((it % n_qt) * QT) {}
};

// Consumer warpgroup wg: for each item, its 64 query rows against every
// chunk of keys in the ring, in order, each chunk waited for and released.
__device__ __forceinline__ void consume(const unsigned char* split, uint64_t* split_full,
                                        uint64_t* split_empty, const float* __restrict__ q,
                                        float* __restrict__ out, float* __restrict__ lse, int B,
                                        int Nq, int Nk, int H, int q_row, int wg, int wt) {
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = (wt >> 5) * 16 + g;  // this thread's rows r and r + 8 of the 64
  const int n_qt = (Nq + QT - 1) / QT;
  const int items = B * H * n_qt;
  const int n_chunks = (Nk + TILE - 1) / TILE;
  const int D = H * DH;
  int ss = 0;
  uint32_t sphase = 0;
  auto next_chunk = [&]() -> const unsigned char* {
    mbar_wait(&split_full[ss], sphase);
    return split + ss * SPLIT_BYTES;
  };
  auto release = [&]() {
    if (wt == 0) mbar_arrive(&split_empty[ss]);
    if (++ss == SPLIT_SLOTS) {
      ss = 0;
      sphase ^= 1;
    }
  };
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item item(it, n_qt, H);
    const int r0 = item.q0 + wg * TILE + r, r1 = r0 + 8;
    // Q's TF32 parts: step kk holds columns 8 kk + t4 and + 4 of rows r0, r1
    uint32_t qh[DH / 8][4], ql[DH / 8][4];
    {
      const float* row0 = q + (static_cast<size_t>(item.b) * Nq + r0) * q_row + item.h * DH + t4;
      const float* row1 = row0 + static_cast<size_t>(8) * q_row;
      const bool in0 = r0 < Nq, in1 = r1 < Nq;
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const float x[4] = {in0 ? row0[8 * kk] : 0.f, in1 ? row1[8 * kk] : 0.f,
                            in0 ? row0[8 * kk + 4] : 0.f, in1 ? row1[8 * kk + 4] : 0.f};
        tf32_frag(x, qh[kk], ql[kk]);
      }
    }
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // rows r0 and r1: running max of the raw scores, per-thread sums
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      // S = Q K^T of the chunk: s[4 j + e] is row r + 8 (e / 2), key
      // 64 c + 8 j + 2 t4 + e % 2
      float s[32];
      const unsigned char* kc = next_chunk();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint64_t dh = part_desc(kc, kk), dl = part_desc(kc + PART_BYTES, kk);
        if (kk == 0) {
          wgmma_m64n64k8_tf32_rs_first(s, ql[0], dh);
        } else {
          wgmma_m64n64k8_tf32_rs(s, ql[kk], dh, 1);
        }
        wgmma_m64n64k8_tf32_rs(s, qh[kk], dl, 1);
        wgmma_m64n64k8_tf32_rs(s, qh[kk], dh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release();

      if ((c + 1) * TILE > Nk) {  // the ragged last chunk: keys past Nk
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c * TILE + 8 * j + 2 * t4 + (e & 1) >= Nk) s[4 * j + e] = -INFINITY;
      }
      // the online softmax: every chunk holds a key below Nk, so the new
      // max is finite; c = 0 at the first chunk (m = -inf)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = expf((m0 - mx0) * 0.125f), c1 = expf((m1 - mx1) * 0.125f);
      m0 = mx0;
      m1 = mx1;
      const float off0 = -mx0 * 0.125f, off1 = -mx1 * 0.125f;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = expf(fmaf(s[4 * j], 0.125f, off0));
        s[4 * j + 1] = expf(fmaf(s[4 * j + 1], 0.125f, off0));
        s[4 * j + 2] = expf(fmaf(s[4 * j + 2], 0.125f, off1));
        s[4 * j + 3] = expf(fmaf(s[4 * j + 3], 0.125f, off1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = fmaf(l0, c0, sum0);
      l1 = fmaf(l1, c1, sum1);

      // P V of the chunk into a fresh partial: step kk takes the chunk's
      // keys 8 kk .. in V^T's slot order, so its fragment is P's
      // accumulators (row r, keys 2 t4 and + 1; row r + 8 the same) as
      // they are; then O = O c + partial
      const unsigned char* vc = next_chunk();
      float part[32];
      chunk_products<true>(part, vc, vc + PART_BYTES, [&](int kk, float (&x)[4]) {
        x[0] = s[4 * kk];
        x[1] = s[4 * kk + 2];
        x[2] = s[4 * kk + 1];
        x[3] = s[4 * kk + 3];
      });
      release();
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        o[4 * d] = fmaf(o[4 * d], c0, part[4 * d]);
        o[4 * d + 1] = fmaf(o[4 * d + 1], c0, part[4 * d + 1]);
        o[4 * d + 2] = fmaf(o[4 * d + 2], c1, part[4 * d + 2]);
        o[4 * d + 3] = fmaf(o[4 * d + 3], c1, part[4 * d + 3]);
      }
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (lse != nullptr && t4 == 0) {
      float* lr = lse + (static_cast<size_t>(item.b) * H + item.h) * Nq;
      if (r0 < Nq) lr[r0] = fmaf(m0, 0.125f, logf(l0));
      if (r1 < Nq) lr[r1] = fmaf(m1, 0.125f, logf(l1));
    }
    float* o0 = out + (static_cast<size_t>(item.b) * Nq + r0) * D + item.h * DH + 2 * t4;
    float* o1 = o0 + static_cast<size_t>(8) * D;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (r0 < Nq)
        *reinterpret_cast<float2*>(o0 + 8 * d) = make_float2(o[4 * d] / l0, o[4 * d + 1] / l0);
      if (r1 < Nq)
        *reinterpret_cast<float2*>(o1 + 8 * d) =
            make_float2(o[4 * d + 2] / l1, o[4 * d + 3] / l1);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const float* __restrict__ q,
                           float* __restrict__ out, float* __restrict__ lse, int B, int Nq, int Nk,
                           int H, int q_row) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* raw = smem;
  unsigned char* split = raw + RAW_SLOTS * RAW_BYTES;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(split + SPLIT_SLOTS * SPLIT_BYTES);
  uint64_t* raw_empty = raw_full + RAW_SLOTS;
  uint64_t* split_full = raw_empty + RAW_SLOTS;
  uint64_t* split_empty = split_full + SPLIT_SLOTS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < RAW_SLOTS; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], SPLITTERS);
    }
    for (int s = 0; s < SPLIT_SLOTS; ++s) {
      mbar_init(&split_full[s], SPLITTERS);
      mbar_init(&split_empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_qt = (Nq + QT - 1) / QT;
  const int items = B * H * n_qt;
  // the ring's sequence per item: K of chunk 0, V of chunk 0, K of chunk 1, ...
  const int n_steps = 2 * ((Nk + TILE - 1) / TILE);

  if (tid >= CONSUMERS * 128) {
    setmaxnreg_dec<40>();
    const int pt = tid - CONSUMERS * 128;
    if (pt == 0) {
      // one thread starts every copy
      int slot = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item item(it, n_qt, H);
        for (int i = 0; i < n_steps; ++i) {
          const CUtensorMap* map = (i & 1) ? &map_v : &map_k;
          const int key0 = (i >> 1) * TILE;
          mbar_wait(&raw_empty[slot], phase ^ 1);
          mbar_arrive_expect_tx(&raw_full[slot], RAW_BYTES);
          unsigned char* dst = raw + slot * RAW_BYTES;
          tma_load_3d(dst, map, &raw_full[slot], item.h * DH, key0, item.b);
          tma_load_3d(dst + BOX_BYTES, map, &raw_full[slot], item.h * DH + 32, key0, item.b);
          if (++slot == RAW_SLOTS) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    } else if (pt >= 32) {
      // the splitters: each raw chunk into its TF32 parts
      const int sid = pt - 32;
      int rs = 0, ss = 0;
      uint32_t rphase = 0, sphase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        for (int i = 0; i < n_steps; ++i) {
          mbar_wait(&raw_full[rs], rphase);
          mbar_wait(&split_empty[ss], sphase ^ 1);
          unsigned char* hi = split + ss * SPLIT_BYTES;
          split_chunk(raw + rs * RAW_BYTES, hi, hi + PART_BYTES, i & 1, sid);
          fence_proxy_async();  // the parts become visible to the wgmma reads
          mbar_arrive(&raw_empty[rs]);
          mbar_arrive(&split_full[ss]);
          if (++rs == RAW_SLOTS) {
            rs = 0;
            rphase ^= 1;
          }
          if (++ss == SPLIT_SLOTS) {
            ss = 0;
            sphase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume(split, split_full, split_empty, q, out, lse, B, Nq, Nk, H, q_row, tid >> 7,
            tid & 127);
  }
}

// a 3-D map over the float32 (B, N, row) view: columns [0, D), N tokens, B images
int view_map(CUtensorMap* map, const void* ptr, int B, int N, int D, int row) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(N),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(row) * 4,
                               static_cast<uint64_t>(N) * row * 4};
  const uint32_t box[3] = {32, TILE, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// q: (B*Nq, *) float32 rows with row stride q_row elements, head h at
// columns h*64; k, v: (B*Nk, *) float32 rows with strides k_row, v_row.
// out: (B*Nq, D) float32, D = n_heads * 64. lse: null, or (B, n_heads, Nq)
// float32, each query row's log-sum-exp of its scaled scores. Row strides
// are multiples of 4 and k, v 16-byte aligned (TMA). Requires Nq, Nk >= 1
// (the wrapper asks for >= 8).
LTD_API int ltd_flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                    float* lse, int B, int Nq, int Nk, int n_heads, int q_row,
                                    int k_row, int v_row, void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || n_heads < 1 || q_row % 4 || k_row % 4 || v_row % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = n_heads * DH;
  CUtensorMap map_k, map_v;
  if (int err = view_map(&map_k, k, B, Nk, D, k_row)) return err;
  if (int err = view_map(&map_v, v, B, Nk, D, v_row)) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * n_heads * ((Nq + QT - 1) / QT);
  flash_attention_f32_kernel<<<items < sms ? items : sms, THREADS, SMEM,
                               static_cast<cudaStream_t>(stream)>>>(map_k, map_v, q, out, lse, B,
                                                                    Nq, Nk, n_heads, q_row);
  return static_cast<int>(cudaGetLastError());
}
