// dwconv_gelu: act = bf16(GELU(3x3 depthwise(h) + dwb)) on the token grid.
//
// Replaces the depthwise convolution and GELU of
// transformer_latent_diffusion_tpu/ops/fused_stack.py::_layer_stack_kernel
// (fused_stack.py:84-88: `_dw_fwd` from ops/fused_mlp_vjp.py:68 and
// `_gelu_exact` from ops/fused_block.py:60). The same body serves three
// more TPU kernels: the training layer's forward
// (transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_mlp_fwd,
// :99-112), which keeps the expanded hidden state h and the convolution's
// output c in float32 (float32 input; c stored as well, for GELU'(c) in the
// backward); the hi-res sep-conv MLP's forward
// (transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py::_pallas_fwd,
// :182-205, float32 h at hw = 32); and the W8A8 layer
// (transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel,
// :92-99), which quantizes the GELU output in float32 over each pixel's
// channels: `out_f32` stores it as float32, unrounded, and the quantizing
// body below (dwconv_gelu_q8_kernel, the layer's route) quantizes it on
// chip instead, with this body's walk and arithmetic.
//
// What it computes: everything in float32 in the TPU kernel's summation
// order (row taps per column shift first, then the three column shifts),
// + dwb, then the exact erf GELU (`erff`; the TPU kernel's polynomial only
// stood in for a missing erf), rounded to the output type once.
//
// What bounds it on the H100: 9 multiply-adds and one erf per element
// against 4 bytes moved (bf16 in, bf16 out; 8 for float32 in, 12 with
// float32 out or c) make it memory-bound on paper (3.35 TB/s), but the
// instructions it issues per element (the taps, the bf16 widening,
// `erff`, which computes both of its polynomials and selects, the GELU)
// take longer than the bytes: at batch 64 and 3072 channels, 50M elements
// against 0.060 ms of bytes. So the slab's copy has to overlap the
// arithmetic, and the arithmetic has to be lean.
//
// The float32 compute dtype (the JAX package's default configuration: the
// TPU kernel's `dw` in float32) takes float32 taps (template parameter WT)
// with a float32 h and output: the same body, its taps loaded as 16-byte
// float32 groups instead of widened from bf16, the same float32 sums.
//
// What this design does about that (dwconv_gelu_kernel):
// - A unit of work is (image, 64 channels) for the whole-grid body, or
//   (image, band of `band` grid rows, 64 channels) for the row-band body.
//   Its slab, the unit's rows with a one-row halo above and below and a
//   one-column halo left and right, (rows + 2) x (hw + 2) x 64, arrives
//   by one TMA copy through a rank-4 tensor map over (B, hw, hw, C), a box
//   at (r0 - 1, -1, c0): TMA fills the halo outside the grid with zeros,
//   so the padding ring costs no instruction, and the copy needs no
//   address arithmetic or bounds test per element.
// - A persistent grid (as many blocks as fit on the SMs) walks the units;
//   the slabs sit in a two-stage `mbarrier` ring, so the next unit's slab
//   arrives while this one is computed. Where two slabs do not fit the 227
//   KB of a block (bf16 past hw = 28, float32 past hw = 19 with the whole
//   grid), the ring has one stage and a unit's copy waits for the last.
// - The slab is walked commuted: a thread owns 4 channels of a run of 16
//   pixels of a row, slides along it and takes each padded column's three
//   row taps z_dj once (3 slab reads per column instead of 9 per pixel);
//   pixel j then sums z0 (column j), z1 (j + 1) and z2 (j + 2), which is
//   the same float32 sum, in the same order, as the 9-tap walk. Taps and
//   bias sit in registers (117-123 a thread: two blocks of 8 warps per
//   SM), bf16 is widened by a shift and a mask, and the column loop is
//   unrolled so the sliding window costs no moves.
// - Outputs leave as 8-byte (bf16) or 16-byte (float32) stores, the 16
//   threads of a pixel writing its 64 channels' contiguous bytes.
// Each halo row of the row-band body is read by two units, so device
// memory sees (band + 2) / band reads per input element there. The
// wrapper (ops/fused_stack.py::dwconv_gelu_body) takes the whole grid where
// one slab fits (bf16 up to hw = 40, float32 up to hw = 28) and bands of 8
// rows beyond (float32 up to hw = 88, bf16 up to hw = 179).
//
// Which mode runs where (the wrapper's routing is
// ops/fused_stack.py::dwconv_gelu_route):
// - base, and the probes' "commuted" (scripts/microbench_layer.py's
//   `_dw_fwd_commuted`, `_mlp_tail`, pallas_call at :252: row taps first,
//   then the column shifts, which is the walk above in the same float32
//   order, so its output is base's bit for bit): the TMA body, whole grid
//   or row bands. Its template parameter CT is the type of the stored
//   pre-GELU c: float32 for the training forward, bf16 for the "bf16res"
//   backward of scripts/probe_train_bwd_stage.py (pallas_call at :259),
//   which keeps its residuals in bf16 (bf16 h; 8-byte stores like the bf16
//   output's).
// - "none" (the probe's "nodw": c = h + dwb, no convolution, float32 h)
//   reads no slab: dwconv_gelu_pointwise_kernel, an elementwise pass over
//   the rows with 16-byte loads and stores on a persistent grid, each
//   element read once, the same `erff` GELU and rounding.

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "quant_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 64;  // channels per unit of the TMA body
enum { DW_BASE = 0, DW_NONE = 1, DW_COMMUTED = 2 };

template <typename T>
inline size_t smem_bytes(int rows, int hw) {
  return static_cast<size_t>(rows + 2) * (hw + 2) * CHUNK * sizeof(T);
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

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// ------------------- dw_mode "none" (dwconv_gelu_pointwise_kernel) -------------------

// act = GELU(h + dwb) and c = h + dwb over the (M, C) float32 rows, in
// 16-byte chunks of 4 channels (n4 = M * C / 4 of them). A block's step
// covers 2 x THREADS consecutive chunks, a thread its chunks tid and
// THREADS + tid, so each thread has two loads in flight.
__global__ void __launch_bounds__(THREADS)
dwconv_gelu_pointwise_kernel(const float4* __restrict__ h, const float4* __restrict__ dwb,
                             void* __restrict__ out, float4* __restrict__ c_out, size_t n4,
                             int C, bool out_f32) {
  const int c4s = C / 4;
  const size_t step = static_cast<size_t>(gridDim.x) * 2 * THREADS;
  const int half = THREADS % c4s, stride = static_cast<int>(step % c4s);
  size_t i = static_cast<size_t>(blockIdx.x) * 2 * THREADS + threadIdx.x;
  int ca = static_cast<int>(i % c4s);  // chunk i's channel / 4, carried along
  auto finish = [&](size_t k, int ck, const float4& v) {
    const float4 b4 = dwb[ck];
    const float4 x = make_float4(v.x + b4.x, v.y + b4.y, v.z + b4.z, v.w + b4.w);
    const float4 g = make_float4(gelu(x.x), gelu(x.y), gelu(x.z), gelu(x.w));
    if (out_f32)
      static_cast<float4*>(out)[k] = g;
    else
      static_cast<uint2*>(out)[k] = make_uint2(pack_bf16x2(g.x, g.y), pack_bf16x2(g.z, g.w));
    if (c_out != nullptr) c_out[k] = x;
  };
  for (; i < n4; i += step) {
    const size_t j = i + THREADS;
    const int cb = ca + half < c4s ? ca + half : ca + half - c4s;
    const float4 va = h[i];
    const float4 vb = j < n4 ? h[j] : va;
    finish(i, ca, va);
    if (j < n4) finish(j, cb, vb);
    ca += stride;
    if (ca >= c4s) ca -= c4s;
  }
}

int launch_pointwise(const void* h, const float* dwb, void* out, void* c_out, size_t m, int C,
                     bool out_f32, cudaStream_t s) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dwconv_gelu_pointwise_kernel, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n4 = m * C / 4;
  const size_t fit = static_cast<size_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  const size_t need = (n4 + 2 * THREADS - 1) / (2 * THREADS);
  dwconv_gelu_pointwise_kernel<<<static_cast<unsigned>(need < fit ? need : fit), THREADS, 0, s>>>(
      static_cast<const float4*>(h), reinterpret_cast<const float4*>(dwb), out,
      static_cast<float4*>(c_out), n4, C, out_f32);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------ the TMA body (dwconv_gelu_kernel) ------------------------

// a block's shared memory, less the alignment and the barriers
constexpr int SMEM_LIMIT = 232448 - 128 - 16;
constexpr int MAX_STAGES = 2;
// The TMA body's thread owns 4 channels (16 threads cover a pixel's 64)
// of a run of 16 pixels of a row. Chosen on an H100 among 8 or 4 channels
// and runs of 4, 8 or 16 pixels: 8 channels hold 72 taps in registers and
// leave one block of 8 warps per SM, too few to hide the latencies; 4
// channels take 117-123 registers, two blocks; runs of 16 walk 18 padded
// columns for 16 pixels instead of 10 for 8.
constexpr int TV = 4;
constexpr int TG = CHUNK / TV;  // threads of one pixel's 64 channels
constexpr int TSEG = 16;

// TV channels of one pixel as the slab stores them
template <typename T>
struct Lanes;
template <>
struct Lanes<bf16> {
  uint2 u;
};
template <>
struct Lanes<float> {
  float4 a;
};

// bf16 widened to float32 by a shift and a mask (low half first)
__device__ __forceinline__ void to_float(const Lanes<bf16>& v, float* f) {
  f[0] = __uint_as_float(v.u.x << 16), f[1] = __uint_as_float(v.u.x & 0xffff0000u);
  f[2] = __uint_as_float(v.u.y << 16), f[3] = __uint_as_float(v.u.y & 0xffff0000u);
}
__device__ __forceinline__ void to_float(const Lanes<float>& v, float* f) {
  f[0] = v.a.x, f[1] = v.a.y, f[2] = v.a.z, f[3] = v.a.w;
}

// Units: u = (b * bands + band) * chunks + chunk; slab s of the ring holds
// unit blockIdx.x + k * gridDim.x for k % stages == s. Thread t owns the
// channels c0 + TV (t % TG) .. + TV - 1 of runs of TSEG pixels of a row.
// CT: the type of the stored c (float32, or bf16). WT: the taps' type
// (bf16, or float32 for a float32 compute dtype).
template <typename T, bool BAND, typename CT, typename WT>
__global__ void __launch_bounds__(THREADS, 2)
dwconv_gelu_kernel(const __grid_constant__ CUtensorMap map_h, const WT* __restrict__ dw,
                   const float* __restrict__ dwb, void* __restrict__ out,
                   CT* __restrict__ c_out, int B, int hw, int C, int band, int stages,
                   int slab_bytes, bool out_f32) {
  extern __shared__ unsigned char smem_raw[];
  // TMA writes an unswizzled box to a 128-byte aligned address
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * static_cast<size_t>(slab_bytes));
  const int tid = threadIdx.x;
  const int pw = hw + 2;
  const int chunks = C / CHUNK;
  const int bands = BAND ? (hw + band - 1) / band : 1;
  const int units = B * bands * chunks;
  // the unit's first grid row, image and first channel
  auto where = [&](int u, int& r0, int& b, int& c0) {
    c0 = (u % chunks) * CHUNK;
    r0 = BAND ? ((u / chunks) % bands) * band : 0;
    b = u / (chunks * bands);
  };
  auto issue = [&](int s, int u) {
    int r0, b, c0;
    where(u, r0, b, c0);
    mbar_arrive_expect_tx(&full[s], slab_bytes);
    tma_load_4d(ring + s * static_cast<size_t>(slab_bytes), &map_h, &full[s], c0, -1, r0 - 1, b);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int s = 0; s < stages; ++s)
      if (blockIdx.x + s * gridDim.x < units) issue(s, blockIdx.x + s * gridDim.x);
  }
  __syncthreads();

  const int grp = tid % TG;
  const int segs = (hw + TSEG - 1) / TSEG;
  for (int k = 0, u = blockIdx.x; u < units; ++k, u += gridDim.x) {
    int r0, b, c0;
    where(u, r0, b, c0);
    const int rows = BAND ? min(band, hw - r0) : hw;
    const int c = c0 + grp * TV;
    float w[9][TV];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if constexpr (sizeof(WT) == 2)
        to_float(Lanes<bf16>{*reinterpret_cast<const uint2*>(dw + t * C + c)}, w[t]);
      else
        to_float(Lanes<float>{*reinterpret_cast<const float4*>(dw + t * C + c)}, w[t]);
    }
    const float4 b4 = *reinterpret_cast<const float4*>(dwb + c);
    const float bias[TV] = {b4.x, b4.y, b4.z, b4.w};
    const int s = k % stages;
    mbar_wait(&full[s], (k / stages) & 1);
    const Lanes<T>* tile =
        reinterpret_cast<const Lanes<T>*>(ring + s * static_cast<size_t>(slab_bytes));
    const size_t img = static_cast<size_t>(b) * hw * hw;
    for (int item = tid / TG; item < rows * segs; item += THREADS / TG) {
      const int i = item / segs, j0 = (item % segs) * TSEG, j1 = min(j0 + TSEG, hw);
      float z0a[TV] = {}, z0b[TV] = {}, z1b[TV] = {};  // z0 two and one columns back, z1 one back
      // unrolled, so the window slides by renaming registers
#pragma unroll
      for (int cc = 0; cc < TSEG + 2; ++cc) {
        const int col = j0 + cc;
        if (col >= j1 + 2) break;
        float z[3][TV];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int e = 0; e < TV; ++e) z[dj][e] = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          float v[TV];
          to_float(tile[((i + di) * pw + col) * TG + grp], v);
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int e = 0; e < TV; ++e) z[dj][e] += v[e] * w[di * 3 + dj][e];
        }
        if (cc >= 2) {
          // pixel (r0 + i, col - 2): + dwb, exact GELU, one 16-byte (float32)
          // or 8-byte (bf16) store
          float x[TV], g[TV];
#pragma unroll
          for (int e = 0; e < TV; ++e) {
            x[e] = (z0a[e] + z1b[e] + z[2][e]) + bias[e];
            g[e] = gelu(x[e]);
          }
          const size_t at = (img + static_cast<size_t>(r0 + i) * hw + col - 2) * C + c;
          if (out_f32)
            *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
                make_float4(g[0], g[1], g[2], g[3]);
          else
            *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + at) =
                make_uint2(pack_bf16x2(g[0], g[1]), pack_bf16x2(g[2], g[3]));
          if (c_out != nullptr) {
            if constexpr (sizeof(CT) == 2)
              *reinterpret_cast<uint2*>(c_out + at) =
                  make_uint2(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]));
            else
              *reinterpret_cast<float4*>(c_out + at) = make_float4(x[0], x[1], x[2], x[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < TV; ++e) {
          z0a[e] = z0b[e];
          z0b[e] = z[0][e];
          z1b[e] = z[1][e];
        }
      }
    }
    __syncthreads();  // every thread is done with slab s: refill it
    if (tid == 0 && u + stages * gridDim.x < units) issue(s, u + stages * gridDim.x);
  }
}

template <typename T, bool BAND, typename CT, typename WT = bf16>
int launch_tma(const void* h, const void* dw, const float* dwb, void* out, void* c_out, int B,
               int hw, int C, int band, bool out_f32, cudaStream_t s) {
  const int rows = BAND ? band : hw;
  const int slab = static_cast<int>(smem_bytes<T>(rows, hw));
  const int stages = 2 * slab <= SMEM_LIMIT ? 2 : 1;
  if (slab > SMEM_LIMIT || hw + 2 > 256 || rows + 2 > 256)  // a TMA box dimension is <= 256
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 128 + stages * slab + MAX_STAGES * 8;  // the barriers after the slabs
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(hw),
                            static_cast<uint64_t>(hw), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(C) * sizeof(T),
                               static_cast<uint64_t>(hw) * C * sizeof(T),
                               static_cast<uint64_t>(hw) * hw * C * sizeof(T)};
  const uint32_t box[4] = {CHUNK, static_cast<uint32_t>(hw + 2), static_cast<uint32_t>(rows + 2),
                           1};
  CUtensorMap map;
  const int err = encode_map(&map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             4, h, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  auto kernel = dwconv_gelu_kernel<T, BAND, CT, WT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bands = BAND ? (hw + band - 1) / band : 1;
  const int units = B * bands * (C / CHUNK);
  const int fit = sm_count() * (per_sm > 0 ? per_sm : 1);
  kernel<<<units < fit ? units : fit, THREADS, smem, s>>>(
      map, static_cast<const WT*>(dw), dwb, out, static_cast<CT*>(c_out), B, hw, C, band,
      stages, slab, out_f32);
  return static_cast<int>(cudaGetLastError());
}

// ----------------- the quantizing body (dwconv_gelu_q8_kernel) -----------------
//
// Replaces the W8A8 layer's GELU row and its quantization
// (transformer_latent_diffusion_tpu/ops/fused_stack_int8.py::_layer_stack_int8_kernel,
// :94-99: `_dw_fwd` + dwb, `_gelu_exact`, then `_qmm`'s `_rowquant` of
// the 3072-wide GELU row), which the TPU kernel keeps in VMEM: int8 rows
// and their float32 scales out, the same values as rowquant.cu on this
// file's float32 GELU output, without that output. What bounds it on the
// H100: the bytes (float32 h in, int8 out: 251 MB at batch 64, 0.075 ms)
// less than the walk's instruction issue (nine FMAs and an `erff` a value,
// as for the other bodies) and a pixel's maximum over all its channels,
// which no one block holds: the design below spreads a pixel's channels
// over a cluster and exchanges only per-pixel maxima.

constexpr int Q8_THREADS = 384;
constexpr int Q8_MAX_RANKS = 8;  // the portable cluster size
constexpr int Q8_MAX_SLOTS = 5;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// shared memory of a block with `slots` grid rows in its ring, less the
// alignment: the ring, three buffers of the warps' per-pixel maxima, the
// barriers
inline size_t q8_smem_bytes(int hw, int slice, int slots, int tseg) {
  const int segs = (hw + tseg - 1) / tseg;
  return static_cast<size_t>(slots) * (hw + 2) * slice * sizeof(float) +
         3 * segs * (slice / 128) * tseg * sizeof(float) + slots * 8 + 8;
}

// Block (rank, piece) of a cluster of `gridDim.x` ranks: the piece's run
// of `piece_rows` consecutive grid rows of the batch (global row G = b hw +
// r, from blockIdx.y * piece_rows; a run may cross from one image into the
// next), channels [rank * slice, + slice); the cluster's ranks cover all C
// channels of the piece's pixels. The launch makes one piece for each
// cluster the card holds at once, so the work is one even wave. A thread
// owns 4 channels (group g = tid % (slice / 4)) of a run of TSEG pixels
// (tid / (slice / 4)) of each row; a warp's 32 lanes share their pixels
// (slice % 128 == 0).
// - The grid rows G0 - 1 .. G0 + rows of the run arrive one by one (TMA,
//   one box per 64 channels, (hw + 2) x 64 float32 with the halo columns
//   zero-filled, and rows before the batch or past it zero-filled) into a
//   ring of `slots` rows, slots - 3 rows ahead of the one being walked. A
//   row's neighbour in another image is loaded but skipped: the taps of an
//   image's first row above it and of its last row below it add nothing,
//   as the TMA body's zero halo rows add nothing.
// - Row i: each thread walks its run, the TMA body's commuted walk with
//   its arithmetic (the same taps, sums and `erff`), and keeps the GELU
//   values in registers (the float32 GELU output never leaves the chip);
//   each pixel's |max| over the warp's lanes (`redux.sync` on the float's
//   bits: |x| >= 0 orders as its bits) goes to the warp's slot of one of
//   three buffers; then the thread arrives at the cluster barrier and
//   goes on to row i + 1.
// - After row i + 1 it waits for that barrier (every rank's maxima of row
//   i are in; every warp of the cluster is done with row i's walk, so
//   thread 0 refills the ring's free slot), and each warp on its own reads
//   its pixels' maxima from every rank's warps through distributed shared
//   memory (a lane per pixel and rank), takes the scale and 1 / scale as
//   quant_row.cuh does, and quantizes and stores row i from its registers
//   (rank 0 stores the scales). No block-wide barrier: the cluster
//   barrier's latency hides behind a row's walk, and a buffer of maxima is
//   written again three rows on, when every rank has read it.
template <typename WT, int TSEG>
__global__ void __launch_bounds__(Q8_THREADS, 1)
dwconv_gelu_q8_kernel(const __grid_constant__ CUtensorMap map_h, const WT* __restrict__ dw,
                      const float* __restrict__ dwb, int8_t* __restrict__ q,
                      float* __restrict__ rscale, int hw, int C, int total_rows,
                      int piece_rows, int slots) {
  extern __shared__ unsigned char smem_raw[];
  // TMA writes an unswizzled box to a 128-byte aligned address
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = gridDim.x;  // one cluster spans the grid's x
  const int slice = C / ranks;
  const int tid = threadIdx.x, lane = tid & 31;
  const int boxes = slice / CHUNK;
  const int box_bytes = (hw + 2) * CHUNK * static_cast<int>(sizeof(float));
  const int slot_bytes = boxes * box_bytes;
  const int g0 = blockIdx.y * piece_rows;
  const int rows = min(piece_rows, total_rows - g0);
  const int loads = rows + 2;  // global rows g0 - 1 .. g0 + rows
  const int c_lo = rank * slice;
  const int groups = slice / TV, wps = groups / 32;  // 4-channel groups, warps a run
  const int segs = (hw + TSEG - 1) / TSEG;
  // pmax[buffer][run][warp of the run][pixel of the run]: float bits
  unsigned* pmax = reinterpret_cast<unsigned*>(ring + static_cast<size_t>(slots) * slot_bytes);
  const int buf_len = segs * wps * TSEG;
  uint64_t* full = reinterpret_cast<uint64_t*>(pmax + 3 * buf_len + (3 * buf_len & 1));
  auto issue = [&](int j) {  // global row g0 - 1 + j into slot j % slots
    const int g = g0 - 1 + j;
    const int b = g < 0 ? -1 : g / hw;  // -1 and B: outside the batch, zero-filled
    unsigned char* dst = ring + static_cast<size_t>(j % slots) * slot_bytes;
    mbar_arrive_expect_tx(&full[j % slots], slot_bytes);
    for (int k = 0; k < boxes; ++k)
      tma_load_4d(dst + k * box_bytes, &map_h, &full[j % slots], c_lo + k * CHUNK, -1,
                  g - b * hw, b);
  };
  auto arrived = [&](int j) { mbar_wait(&full[j % slots], (j / slots) & 1); };
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int j = 0; j < min(slots, loads); ++j) issue(j);
  }
  __syncthreads();

  const int gch = tid % groups, seg = tid / groups;
  const int j0 = seg * TSEG, j1 = min(j0 + TSEG, hw);
  const bool active = j0 < hw;  // warp-uniform: groups % 32 == 0
  const int c = c_lo + gch * TV;
  const int grp = gch % TG;
  unsigned* my_max = pmax + (seg * wps + gch / 32) * TSEG;  // this warp's slot in a buffer
  float w[9][TV];
  float bias[TV];
  if (active) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if constexpr (sizeof(WT) == 2)
        to_float(Lanes<bf16>{*reinterpret_cast<const uint2*>(dw + t * C + c)}, w[t]);
      else
        to_float(Lanes<float>{*reinterpret_cast<const float4*>(dw + t * C + c)}, w[t]);
    }
    const float4 b4 = *reinterpret_cast<const float4*>(dwb + c);
    bias[0] = b4.x, bias[1] = b4.y, bias[2] = b4.z, bias[3] = b4.w;
  }

  // row i's GELU values of this thread's run into g, the warp's maxima of
  // its pixels into buffer i % 3
  auto walk = [&](int i, float (&g)[TSEG][TV]) {
    const int r = (g0 + i) % hw;  // the row's neighbours above and below, if in its image
    const bool above = r > 0, below = r < hw - 1;
    const Lanes<float>* tile[3];
#pragma unroll
    for (int di = 0; di < 3; ++di)
      tile[di] = reinterpret_cast<const Lanes<float>*>(
          ring + static_cast<size_t>((i + di) % slots) * slot_bytes + (gch / TG) * box_bytes);
    float z0a[TV] = {}, z0b[TV] = {}, z1b[TV] = {};  // z0 two and one columns back, z1 one back
#pragma unroll
    for (int cc = 0; cc < TSEG + 2; ++cc) {
      const int col = j0 + cc;
      if (col >= j1 + 2) break;
      float z[3][TV];
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int e = 0; e < TV; ++e) z[dj][e] = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        if ((di == 0 && !above) || (di == 2 && !below)) continue;  // block-uniform
        float v[TV];
        to_float(tile[di][col * TG + grp], v);
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int e = 0; e < TV; ++e) z[dj][e] += v[e] * w[di * 3 + dj][e];
      }
      if (cc >= 2) {
        // pixel (g0 + i, col - 2): + dwb, exact GELU
#pragma unroll
        for (int e = 0; e < TV; ++e) g[cc - 2][e] = gelu((z0a[e] + z1b[e] + z[2][e]) + bias[e]);
      }
#pragma unroll
      for (int e = 0; e < TV; ++e) {
        z0a[e] = z0b[e];
        z0b[e] = z[0][e];
        z1b[e] = z[1][e];
      }
    }
    unsigned* pm = my_max + (i % 3) * buf_len;
#pragma unroll
    for (int p = 0; p < TSEG; ++p) {
      if (j0 + p >= hw) break;  // warp-uniform
      const float m = qrow::amax4(make_float4(g[p][0], g[p][1], g[p][2], g[p][3]));
      const unsigned mw = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
      if (lane == 0) pm[p] = mw;
    }
  };

  float ga[TSEG][TV], gb[TSEG][TV];  // the row being quantized, the row being walked
  if (active) {
    for (int j = 0; j < 3; ++j) arrived(j);
    walk(0, ga);
  }
  cluster_arrive();
  for (int i = 1; i <= rows; ++i) {
    if (i < rows && active) {
      arrived(i + 2);
      walk(i, gb);
    }
    cluster_wait();  // every rank's maxima of row i - 1 are in
    // every warp of the cluster is past row i - 1's walk: its first slab
    // row's slot is free
    if (tid == 0 && i - 1 + slots < loads) {
      fence_proxy_async();
      issue(i - 1 + slots);
    }
    if (active) {
      // lane l: pixel l / 8 (+ 4 h) of the run, rank l % 8; the max over
      // that rank's warps, then over the 8 lanes of the pixel (every lane
      // of the group gets it), its scale and 1 / scale
      const size_t row_pix = static_cast<size_t>(g0 + i - 1) * hw + j0;
      float inv[(TSEG + 3) / 4];
#pragma unroll
      for (int h = 0; h < (TSEG + 3) / 4; ++h) {
        const int p = 4 * h + lane / 8, qr = lane % 8;
        float m = 0.f;
        if (qr < ranks && p < TSEG && j0 + p < hw) {
          const unsigned* src = cluster.map_shared_rank(
              pmax + ((i - 1) % 3) * buf_len + (seg * wps) * TSEG + p, qr);
          for (int k = 0; k < wps; ++k) m = fmaxf(m, __uint_as_float(src[k * TSEG]));
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float rs = qrow::row_scale(m);
        inv[h] = __fdiv_rn(1.0f, rs);
        if (rank == 0 && gch < 32 && qr == 0 && p < TSEG && j0 + p < hw) rscale[row_pix + p] = rs;
      }
#pragma unroll
      for (int p = 0; p < TSEG; ++p) {
        const float ip = __shfl_sync(0xffffffffu, inv[p / 4], (p % 4) * 8);
        if (j0 + p >= hw) break;
        const float4 v = make_float4(ga[p][0], ga[p][1], ga[p][2], ga[p][3]);
        reinterpret_cast<uint32_t*>(q + (row_pix + p) * C + c_lo)[gch] = qrow::quant4(v, ip);
      }
    }
    if (i < rows) cluster_arrive();
#pragma unroll
    for (int p = 0; p < TSEG; ++p)
#pragma unroll
      for (int e = 0; e < TV; ++e) ga[p][e] = gb[p][e];
  }
  cluster_arrive();  // no rank leaves while another reads its maxima
  cluster_wait();
}

template <typename WT, int TSEG>
int launch_q8_body(const CUtensorMap& map, const void* dw, const float* dwb, void* q,
                   float* rscale, int B, int hw, int C, int ranks, cudaStream_t s) {
  const int slice = C / ranks;
  int slots = Q8_MAX_SLOTS;
  while (slots > 3 && 128 + q8_smem_bytes(hw, slice, slots, TSEG) > 232448) --slots;
  const size_t smem = 128 + q8_smem_bytes(hw, slice, slots, TSEG);
  if (slots < 4 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = (const void*)dwconv_gelu_q8_kernel<WT, TSEG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(Q8_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one piece of rows for each cluster the card holds at once (asked once
  // for each cluster size and shared memory)
  static int held[Q8_MAX_RANKS + 1] = {}, held_smem[Q8_MAX_RANKS + 1] = {};
  if (held_smem[ranks] != static_cast<int>(smem)) {
    cfg.gridDim = dim3(ranks, 1);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1)
      n = max(1, sm_count() / ranks);
    held[ranks] = n;
    held_smem[ranks] = static_cast<int>(smem);
  }
  int total_rows = B * hw;
  int piece_rows = (total_rows + held[ranks] - 1) / held[ranks];
  cfg.gridDim = dim3(ranks, (total_rows + piece_rows - 1) / piece_rows);
  const WT* dwt = static_cast<const WT*>(dw);
  int8_t* qt = static_cast<int8_t*>(q);
  void* args[] = {const_cast<CUtensorMap*>(&map), &dwt, &dwb, &qt, &rscale, &hw, &C,
                  &total_rows, &piece_rows, &slots};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename WT>
int launch_q8(const void* h, const void* dw, const float* dwb, void* q, float* rscale, int B,
              int hw, int C, int ranks, int tseg, cudaStream_t s) {
  if (ranks < 1 || ranks > Q8_MAX_RANKS || C % (ranks * 128) || hw < 1 || hw + 2 > 256 ||
      (tseg != 4 && tseg != 8) || (C / ranks / TV) * ((hw + tseg - 1) / tseg) > Q8_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(hw),
                            static_cast<uint64_t>(hw), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(C) * sizeof(float),
                               static_cast<uint64_t>(hw) * C * sizeof(float),
                               static_cast<uint64_t>(hw) * hw * C * sizeof(float)};
  const uint32_t box[4] = {CHUNK, static_cast<uint32_t>(hw + 2), 1, 1};
  CUtensorMap map;
  const int err = encode_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, h, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  return tseg == 4 ? launch_q8_body<WT, 4>(map, dw, dwb, q, rscale, B, hw, C, ranks, s)
                   : launch_q8_body<WT, 8>(map, dw, dwb, q, rscale, B, hw, C, ranks, s);
}

}  // namespace

// h: (B*hw*hw, C) token rows of a row-major hw x hw grid, float32 when
// h_f32 is non-zero, else bf16. out: the same rows, float32 when out_f32
// is non-zero, else bf16. c_out: null, or (B*hw*hw, C) for the pre-GELU
// values, bf16 when c_bf16 is non-zero, else float32. dw: (9, C) bf16
// taps, tap di*3+dj. dwb: (C,) float32. band: 0 for the whole-grid body,
// else the grid rows of each block of the row-band body. dw_mode: 0 base,
// 1 none, 2 commuted (the TMA body, as base). Requires C % 64 == 0; the
// TMA body its slab within 227 KB (see the header); dw_mode 1 float32 h
// and c (band not read); c_bf16 bf16 h. dw_f32 != 0: float32 taps (the
// float32 compute dtype), with float32 h, dw_mode base or commuted, and c
// (the training layer's float32 form) float32 or none.
LTD_API int ltd_dwconv_gelu(const void* h, const void* dw, const float* dwb, void* out,
                            void* c_out, int B, int hw, int C, int h_f32, int out_f32,
                            int band, int c_bf16, int dw_mode, int dw_f32, void* stream) {
  if (C % CHUNK || band < 0 || dw_mode < DW_BASE || dw_mode > DW_COMMUTED)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool of = out_f32 != 0;
  if (dw_f32) {
    if (!h_f32 || c_bf16 || dw_mode == DW_NONE) return static_cast<int>(cudaErrorInvalidValue);
    return band > 0
               ? launch_tma<float, true, float, float>(h, dw, dwb, out, c_out, B, hw, C, band,
                                                       of, s)
               : launch_tma<float, false, float, float>(h, dw, dwb, out, c_out, B, hw, C, 0, of,
                                                        s);
  }
  if (dw_mode == DW_NONE)
    return h_f32 && !c_bf16 ? launch_pointwise(h, dwb, out, c_out,
                                               static_cast<size_t>(B) * hw * hw, C, of, s)
                            : static_cast<int>(cudaErrorInvalidValue);
  if (c_bf16) {
    if (h_f32) return static_cast<int>(cudaErrorInvalidValue);
    return band > 0 ? launch_tma<bf16, true, bf16>(h, dw, dwb, out, c_out, B, hw, C, band, of, s)
                    : launch_tma<bf16, false, bf16>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s);
  }
  if (band > 0)
    return h_f32 ? launch_tma<float, true, float>(h, dw, dwb, out, c_out, B, hw, C, band, of, s)
                 : launch_tma<bf16, true, float>(h, dw, dwb, out, c_out, B, hw, C, band, of, s);
  return h_f32 ? launch_tma<float, false, float>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s)
               : launch_tma<bf16, false, float>(h, dw, dwb, out, c_out, B, hw, C, 0, of, s);
}

// The GELU row quantized per pixel, in one launch: what
// ltd_rowquant(ltd_dwconv_gelu(h, out float32), no LayerNorm) gives, bit
// for bit, without the float32 GELU output. h: (B*hw*hw, C) float32. dw:
// (9, C) bf16 taps, or float32 when dw_f32 is non-zero. dwb: (C,) float32.
// q: (B*hw*hw, C) int8 out; rscale: (B*hw*hw,) float32 out. ranks: the
// blocks of a cluster, which split the channels (C % (128 ranks) == 0, at
// most 8); tseg: the pixels of a row a thread walks, 4 or 8, with
// (C / ranks / 4) * ceil(hw / tseg) <= 384 threads. Requires a ring of at
// least 4 grid rows within a block's 227 KB of shared memory
// (q8_smem_bytes).
LTD_API int ltd_dwconv_gelu_q8(const void* h, const void* dw, const float* dwb, void* q,
                               float* rscale, int B, int hw, int C, int ranks, int tseg,
                               int dw_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dw_f32 ? launch_q8<float>(h, dw, dwb, q, rscale, B, hw, C, ranks, tseg, s)
                : launch_q8<bf16>(h, dw, dwb, q, rscale, B, hw, C, ranks, tseg, s);
}
