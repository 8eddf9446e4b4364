// dwconv_gelu_bwd: backward of GELU(3x3 depthwise(h) + dwb) on the token grid.
//
// Replaces the depthwise and GELU backward of
// transformer_latent_diffusion_tpu/ops/fused_layer_vjp.py::_bwd_kernel
// (:179-187): dc = da * GELU'(c); ddwb = sum dc; the 9 tap gradients
// sum h[p + (di-1, dj-1)] dc[p] (`_dw_tap_grads`, ops/fused_mlp_vjp.py:100);
// the input gradient dhid = the 3x3 correlation of dc with the flipped taps
// (`_dw_input_grad`, :95); db1 = sum dhid (float32, before the bf16
// rounding that the weight-gradient products see). The same body serves
// the backward of the hi-res sep-conv MLP
// (transformer_latent_diffusion_tpu/ops/fused_mlp_vjp.py::_pallas_bwd,
// `_bwd_kernel` :135-179, at hw = 32) and the "bf16res" backward of the
// probe scripts/probe_train_bwd_stage.py (`pallas_bwd_variant`,
// pallas_call at :259), which keeps c and h in bf16 (widened to float32
// as they are read; the arithmetic is the same). With float32 taps (the
// training layer's float32 compute dtype: the TPU kernel's `dw` and `mxu`
// float32) it reads float32 taps and writes dhid in float32, unrounded; the
// sums and their order are the same.
//
// What it computes: dc with the exact GELU' (Phi(c) + c phi(c), `erff`
// and `expf`); dhid in the TPU kernel's order (row taps per column shift,
// then the three shifts), rounded to bf16 once; the 11 sums (9 taps, ddwb,
// db1) in float32, in a fixed order that does not depend on the schedule.
//
// What bounds it on the H100: per element it reads da, c and h (float32,
// 12 bytes; 8 with bf16 c and h) and writes dhid (bf16, 2 bytes): 1.41 GB,
// 0.42 ms at 3.35 TB/s at batch 128 and hw = 16. Its ~75 instructions an
// element (erf, exp, 18 multiply-adds, the shared-memory loads) would issue
// in ~0.26 ms on 132 SMs at full rate, so the bytes bound it if the copy
// overlaps the arithmetic. (It does not all overlap: a stage's cycle is
// its refill's latency, the dc pass and the walk; PERF.md, section 6.)
//
// What this design does about that:
// - A unit of work is (image, band of `band` grid rows, 32 channels); the
//   whole grid is one band. Its slabs of da, c and h, the band's rows with
//   a one-row halo above and below and a one-column halo left and right,
//   (band + 2) x (hw + 2) x 32, arrive by TMA through rank-4 tensor maps
//   over (B, hw, hw, C), each a box at (r0 - 1, -1, c0): TMA fills the
//   halo outside the grid with zeros (so dc = 0 x GELU'(0) = 0 there, and
//   h = 0), and the copy costs no address arithmetic or bounds test.
// - A persistent grid, one block of 16 warps per SM, walks the units
//   through a two-stage `mbarrier` ring, so the next unit's slabs arrive
//   while this one is computed.
// - The shared memory decides the staging. Three float32 slabs of 32
//   channels at hw = 16 are 3 x 41.5 KB a stage, and two such stages do
//   not fit 227 KB. So dc is computed into the landed da slab in place,
//   once per element, the halo's included, and a stage of the ring holds
//   dc + h: 2 x (41.5 + 41.5) KB. c has one buffer of its own (41.5 KB),
//   refilled with the next unit's c as soon as dc is computed: 208 KB at
//   hw = 16 (bf16 c and h: 145 KB). The wrapper
//   (ops/fused_layer_vjp.py::dwconv_gelu_bwd_body) takes the whole grid
//   where this fits (float32 up to hw = 17, bf16 up to 20) and otherwise
//   the most rows a band can have, up to 8 (8 at hw = 32: 218 KB). A halo
//   row inside the grid is read and its dc computed by both bands beside
//   it. (16-channel units in a four-stage ring, and bands of 8 rows at hw
//   = 16 in a three- or four-stage one, were slower on an H100.)
// - Two warp groups work on consecutive units at once: 8 warps compute dc
//   of unit k + 1 (2 channels a thread, `erff` and one MUFU.EX2 a value)
//   while the other 8 walk unit k, each group's handoff an `mbarrier`
//   (dc_ready; the ring's full barriers bring the copies). `setmaxnreg`
//   gives the walk 216 registers a thread and the dc group 40.
// - The walk is commuted, as dwconv_gelu.cu's forward: a thread owns 4
//   channels of a run of 8 pixels of a row and slides along it. At each
//   padded column it reads that column's three dc and three h values once
//   (6 shared loads a pixel where a 9-tap walk takes 18), takes the column's
//   three row taps z_dj for the input gradient (pixel j sums z0 (column
//   j), z1 (j + 1) and z2 (j + 2): the 9-tap walk's float32 sum in its
//   order), and multiplies the centre dc into a sliding window of three h
//   columns for the tap sums. Taps, sums and window sit in registers.
// - Sums without atomics, in a fixed order: a thread sums its pixels in
//   walk order; the four threads of a warp that share 4 channels add by a
//   butterfly; the 8 walk warps add in warp order (through the stage's
//   first 11 KB, once its slabs are read). Each unit writes its 11 x 32
//   partial to a workspace row (image-major: row b * bands + band); the
//   unit that finds itself last of its channel chunk (a counter taken by
//   one thread after the group's barrier and a fence, as CUTLASS releases
//   its semaphores) sums the chunk's rows in row order, as two runs (the
//   first and the second half of the rows) added at the end, writes the
//   (11, C) sums and sets the counter back to zero. So no second launch
//   follows, and the result does not depend on the grid.

#include "hopper.cuh"

namespace {

constexpr int CHUNK = 32;                // channels per unit
constexpr int GROUP = 256;               // threads of each of the two warp groups
constexpr int THREADS = 2 * GROUP;       // the dc group, then the walk group
constexpr int DV = 2;                    // channels per dc-group thread
constexpr int DTG = CHUNK / DV;          // dc-group threads of one pixel
constexpr int DLANES = GROUP / DTG;      // pixels the dc group takes at once
constexpr int TV = 4;                    // channels per walk-group thread
constexpr int TG = CHUNK / TV;           // walk-group threads of one pixel
constexpr int LANES = GROUP / TG;        // runs the walk group takes at once
constexpr int WALK_WARPS = GROUP / 32;
constexpr int DC_REGS = 40, WALK_REGS = 216;  // setmaxnreg: 256 x (40 + 216) = 64K
constexpr int TSEG = 8;                  // pixels of a row per run
constexpr int NSUM = 11;                 // 9 taps, ddwb, db1
constexpr int STAGES = 2;
constexpr int RED_BYTES = WALK_WARPS * NSUM * CHUNK * 4;  // the walk warps' sums
constexpr int NBAR = 2 * STAGES + 1;     // full and dc_ready per stage, c's
constexpr int SMEM_MAX = 232448;
enum { DC_BAR = 1, WALK_BAR = 2 };       // the groups' named barriers

__host__ __device__ inline int round128(size_t bytes) {
  return static_cast<int>((bytes + 127) / 128 * 128);
}

// a ring stage: the dc and h slabs, or the sum exchange where that is larger
__host__ __device__ inline int stage_bytes(int dc_stride, int in_stride) {
  return dc_stride + in_stride > RED_BYTES ? dc_stride + in_stride : RED_BYTES;
}

// the dynamic shared memory of a unit of `band` rows: the alignment slack,
// the ring's stages, the c buffer, the barriers and a flag
// (ops/fused_layer_vjp.py::dwconv_gelu_bwd_smem)
inline int smem_bytes(int band, int hw, int in_size) {
  const size_t box = static_cast<size_t>(band + 2) * (hw + 2) * CHUNK;
  return 128 + STAGES * stage_bytes(round128(box * 4), round128(box * in_size)) +
         round128(box * in_size) + NBAR * 8 + 8;
}

// GELU'(c) = Phi(c) + c phi(c): the exact erf; exp(-c^2 / 2) as one MUFU.EX2
__device__ __forceinline__ float gelu_grad(float c) {
  const float cdf = 0.5f * (1.f + erff(c * 0.70710678118654752f));
  const float pdf = exp2_approx(c * c * -0.72134752044448170f) * 0.39894228040143268f;
  return cdf + c * pdf;
}

// N channels of one pixel as a slab stores them
template <typename T, int N>
struct Lanes;
template <>
struct Lanes<bf16, 2> {
  uint32_t u;
};
template <>
struct Lanes<bf16, 4> {
  uint2 u;
};
template <>
struct Lanes<float, 2> {
  float2 a;
};
template <>
struct Lanes<float, 4> {
  float4 a;
};

// bf16 widened to float32 by a shift and a mask (low half first)
__device__ __forceinline__ void to_float(const Lanes<bf16, 2>& v, float* f) {
  f[0] = __uint_as_float(v.u << 16), f[1] = __uint_as_float(v.u & 0xffff0000u);
}
__device__ __forceinline__ void to_float(const Lanes<bf16, 4>& v, float* f) {
  f[0] = __uint_as_float(v.u.x << 16), f[1] = __uint_as_float(v.u.x & 0xffff0000u);
  f[2] = __uint_as_float(v.u.y << 16), f[3] = __uint_as_float(v.u.y & 0xffff0000u);
}
__device__ __forceinline__ void to_float(const Lanes<float, 2>& v, float* f) {
  f[0] = v.a.x, f[1] = v.a.y;
}
__device__ __forceinline__ void to_float(const Lanes<float, 4>& v, float* f) {
  f[0] = v.a.x, f[1] = v.a.y, f[2] = v.a.z, f[3] = v.a.w;
}

// The last unit of a chunk, by the walk group (wt its thread): the chunk's
// `rows` partial rows (ws rows of 11 x C) summed in row order by float4
// columns, as two runs (the first and the second half of the rows) added at
// the end, into sums (11, C). fred: 2 x 88 float4 of shared memory.
__device__ __forceinline__ void sum_chunk(const float* ws, float* sums, float4* fred, int rows,
                                          int C, int c0, int wt) {
  constexpr int V4 = NSUM * CHUNK / 4;  // float4 columns of a chunk's partial
  const int half = (rows + 1) / 2;
  if (wt < 2 * V4) {
    const int v = wt % V4, h = wt / V4;
    const float4* col =
        reinterpret_cast<const float4*>(ws + (v * 4 / CHUNK) * C + c0 + (v * 4) % CHUNK);
    const size_t stride = static_cast<size_t>(NSUM) * C / 4;  // float4s between rows
    const int r1 = h ? rows : half;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    int r = h ? half : 0;
    for (; r + 8 <= r1; r += 8) {  // 8 loads in flight, added in row order
      float4 l[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) l[q] = __ldcg(col + (r + q) * stride);
#pragma unroll
      for (int q = 0; q < 8; ++q) t.x += l[q].x, t.y += l[q].y, t.z += l[q].z, t.w += l[q].w;
    }
    for (; r < r1; ++r) {
      const float4 l = __ldcg(col + r * stride);
      t.x += l.x, t.y += l.y, t.z += l.z, t.w += l.w;
    }
    fred[h * V4 + v] = t;
  }
  named_barrier(WALK_BAR, GROUP);
  if (wt < V4) {
    const float4 a = fred[wt], b = fred[V4 + wt];
    *reinterpret_cast<float4*>(sums + (wt * 4 / CHUNK) * C + c0 + (wt * 4) % CHUNK) =
        make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

// Units: u = (b * bands + band) * chunks + chunk; block p walks units p,
// p + gridDim.x, ..., unit k of its walk in ring stage k % 2. Two warp
// groups work on consecutive units at once: the dc group (threads 0 ..
// 255) computes dc of unit k + 1 in place while the walk group (256 ..
// 511) walks unit k. A thread owns the channels c0 + TV (t % TG) .. + TV -
// 1 of a pixel (dc group) or of runs of TSEG pixels of a row (walk group).
// IT: the type of c and h; WT: the taps' and dhid's (bf16, or float32)
template <typename IT, typename WT>
__global__ void __launch_bounds__(THREADS, 1)
dwconv_gelu_bwd_kernel(const __grid_constant__ CUtensorMap map_da,
                       const __grid_constant__ CUtensorMap map_c,
                       const __grid_constant__ CUtensorMap map_h, const WT* __restrict__ dw,
                       WT* __restrict__ dhid, float* __restrict__ ws, float* __restrict__ sums,
                       int* __restrict__ counters, int B, int hw, int C, int band) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int pw = hw + 2;
  const size_t box = static_cast<size_t>(band + 2) * pw * CHUNK;
  const uint32_t dc_bytes = static_cast<uint32_t>(box * 4), in_bytes = box * sizeof(IT);
  const int dc_stride = round128(dc_bytes), in_stride = round128(in_bytes);
  const int stage_stride = stage_bytes(dc_stride, in_stride);
  unsigned char* cbuf = base + STAGES * stage_stride;
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + in_stride);  // da and h of a stage
  uint64_t* dc_ready = full + STAGES;                              // dc of a stage computed
  uint64_t* cfull = dc_ready + STAGES;
  int* last = reinterpret_cast<int*>(cfull + 1);

  const int tid = threadIdx.x;
  const int chunks = C / CHUNK;
  const int bands = (hw + band - 1) / band;
  const int rows_total = B * bands;  // partial rows of a chunk
  const int units = rows_total * chunks;
  // the unit's partial row (image-major), first grid row, image and first channel
  auto where = [&](int u, int& row, int& r0, int& b, int& c0) {
    c0 = (u % chunks) * CHUNK;
    row = u / chunks;
    r0 = (row % bands) * band;
    b = row / bands;
  };
  auto issue_dh = [&](int s, int u) {  // da and h into stage s
    int row, r0, b, c0;
    where(u, row, r0, b, c0);
    unsigned char* st = base + s * stage_stride;
    mbar_arrive_expect_tx(&full[s], dc_bytes + in_bytes);
    tma_load_4d(st, &map_da, &full[s], c0, -1, r0 - 1, b);
    tma_load_4d(st + dc_stride, &map_h, &full[s], c0, -1, r0 - 1, b);
  };
  auto issue_c = [&](int u) {
    int row, r0, b, c0;
    where(u, row, r0, b, c0);
    mbar_arrive_expect_tx(cfull, in_bytes);
    tma_load_4d(cbuf, &map_c, cfull, c0, -1, r0 - 1, b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&dc_ready[s], GROUP);
    }
    mbar_init(cfull, 1);
    mbar_fence_init();
    for (int s = 0; s < STAGES; ++s)
      if (blockIdx.x + s * gridDim.x < units) issue_dh(s, blockIdx.x + s * gridDim.x);
    if (blockIdx.x < units) issue_c(blockIdx.x);
  }
  __syncthreads();

  if (tid < GROUP) {
    // the dc group: dc = da GELU'(c) in place, at every slab position
    // inside the grid (the halo columns and rows outside it hold zeros)
    setmaxnreg_dec<DC_REGS>();
    const int grp = tid % DTG;
    for (int k = 0, u = blockIdx.x; u < units; ++k, u += gridDim.x) {
      int row, r0, b, c0;
      where(u, row, r0, b, c0);
      const int s = k % STAGES;
      Lanes<float, DV>* dcs = reinterpret_cast<Lanes<float, DV>*>(base + s * stage_stride);
      const Lanes<IT, DV>* cs = reinterpret_cast<const Lanes<IT, DV>*>(cbuf);
      mbar_wait(&full[s], (k / STAGES) & 1);
      mbar_wait(cfull, k & 1);
      int r = (tid / DTG) / hw, j = (tid / DTG) % hw;
      for (int idx = tid; idx < (band + 2) * hw * DTG; idx += GROUP) {
        const int gi = r0 - 1 + r;
        if (gi >= 0 && gi < hw) {
          const int at = (r * pw + j + 1) * DTG + grp;
          float cv[DV], a[DV];
          to_float(cs[at], cv);
          to_float(dcs[at], a);
          dcs[at].a = make_float2(a[0] * gelu_grad(cv[0]), a[1] * gelu_grad(cv[1]));
        }
        for (j += DLANES; j >= hw; j -= hw) ++r;
      }
      fence_proxy_async();  // these generic writes before TMA refills the stage
      named_barrier(DC_BAR, GROUP);  // c is read: bring the next unit's c
      if (tid == 0 && u + gridDim.x < units) issue_c(u + gridDim.x);
      mbar_arrive(&dc_ready[s]);
    }
    return;
  }

  // the walk group
  setmaxnreg_inc<WALK_REGS>();
  const int wt = tid - GROUP, grp = wt % TG;
  const int segs = (hw + TSEG - 1) / TSEG;
  for (int k = 0, u = blockIdx.x; u < units; ++k, u += gridDim.x) {
    int row, r0, b, c0;
    where(u, row, r0, b, c0);
    const int rows = min(band, hw - r0);
    const int c = c0 + grp * TV;
    float w[9][TV];  // flipped: w[t] is tap 8 - t
#pragma unroll
    for (int t = 0; t < 9; ++t)
      to_float(*reinterpret_cast<const Lanes<WT, TV>*>(dw + (8 - t) * C + c), w[t]);
    const int s = k % STAGES;
    const Lanes<float, TV>* dcs =
        reinterpret_cast<const Lanes<float, TV>*>(base + s * stage_stride);
    const Lanes<IT, TV>* hs =
        reinterpret_cast<const Lanes<IT, TV>*>(base + s * stage_stride + dc_stride);
    mbar_wait(&dc_ready[s], (k / STAGES) & 1);
    mbar_wait(&full[s], (k / STAGES) & 1);  // h has landed (complete already)

    float acc[NSUM][TV];
#pragma unroll
    for (int q = 0; q < NSUM; ++q)
#pragma unroll
      for (int e = 0; e < TV; ++e) acc[q][e] = 0.f;
    const size_t img = static_cast<size_t>(b) * hw * hw;
    for (int item = wt / TG; item < rows * segs; item += LANES) {
      const int i = item / segs, j0 = (item % segs) * TSEG, j1 = min(j0 + TSEG, hw);
      // z0 two and one columns back, z1 one back; the h window's columns
      // two and one back (rows i .. i + 2); the centre dc one column back
      float z0a[TV] = {}, z0b[TV] = {}, z1b[TV] = {};
      float ha[3][TV] = {}, hb[3][TV] = {}, dcc[TV] = {};
      // unrolled, so the windows slide by renaming registers
#pragma unroll
      for (int cc = 0; cc < TSEG + 2; ++cc) {
        const int col = j0 + cc;
        if (col >= j1 + 2) break;
        float z[3][TV], hn[3][TV], mid[TV];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int e = 0; e < TV; ++e) z[dj][e] = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const int at = ((i + di) * pw + col) * TG + grp;
          float v[TV];
          to_float(dcs[at], v);
          to_float(hs[at], hn[di]);
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int e = 0; e < TV; ++e) z[dj][e] += v[e] * w[di * 3 + dj][e];
          if (di == 1)
#pragma unroll
            for (int e = 0; e < TV; ++e) mid[e] = v[e];
        }
        if (cc >= 2) {
          // pixel (r0 + i, col - 2): centre dc at padded column col - 1
          float g[TV];
#pragma unroll
          for (int e = 0; e < TV; ++e) {
            g[e] = (z0a[e] + z1b[e]) + z[2][e];
#pragma unroll
            for (int di = 0; di < 3; ++di) {
              acc[di * 3][e] += ha[di][e] * dcc[e];
              acc[di * 3 + 1][e] += hb[di][e] * dcc[e];
              acc[di * 3 + 2][e] += hn[di][e] * dcc[e];
            }
            acc[9][e] += dcc[e];
            acc[10][e] += g[e];
          }
          const size_t at = (img + static_cast<size_t>(r0 + i) * hw + col - 2) * C + c;
          if constexpr (sizeof(WT) == 2)
            *reinterpret_cast<uint2*>(dhid + at) =
                make_uint2(pack_bf16x2(g[0], g[1]), pack_bf16x2(g[2], g[3]));
          else
            *reinterpret_cast<float4*>(dhid + at) = make_float4(g[0], g[1], g[2], g[3]);
        }
#pragma unroll
        for (int e = 0; e < TV; ++e) {
          z0a[e] = z0b[e];
          z0b[e] = z[0][e];
          z1b[e] = z[1][e];
          dcc[e] = mid[e];
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            ha[di][e] = hb[di][e];
            hb[di][e] = hn[di][e];
          }
        }
      }
    }

    // the four threads of a warp that own these channels add by a
    // butterfly; lanes 0 .. TG - 1 hold the warp's sums, which go to the
    // exchange at the stage's start (the walk group is done with its slabs)
#pragma unroll
    for (int q = 0; q < NSUM; ++q)
#pragma unroll
      for (int e = 0; e < TV; ++e)
#pragma unroll
        for (int o = TG; o < 32; o *= 2) acc[q][e] += __shfl_xor_sync(0xffffffffu, acc[q][e], o);
    float* red = reinterpret_cast<float*>(base + s * stage_stride);  // [WALK_WARPS][NSUM][CHUNK]
    named_barrier(WALK_BAR, GROUP);
    const int warp = wt / 32;
    if ((wt & 31) < TG)
#pragma unroll
      for (int q = 0; q < NSUM; ++q)
        *reinterpret_cast<float4*>(red + (warp * NSUM + q) * CHUNK + grp * TV) =
            make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    named_barrier(WALK_BAR, GROUP);
    // the unit's partial row: the warps' sums in warp order
    float* part = ws + static_cast<size_t>(row) * NSUM * C + c0;
    for (int o = wt; o < NSUM * CHUNK; o += GROUP) {
      float t = red[o];
#pragma unroll
      for (int wp = 1; wp < WALK_WARPS; ++wp) t += red[wp * NSUM * CHUNK + o];
      part[(o / CHUNK) * C + o % CHUNK] = t;
    }
    named_barrier(WALK_BAR, GROUP);
    if (wt == 0) {  // release: the group's partial stores, then the count
      __threadfence();
      *last = atomicAdd(&counters[c0 / CHUNK], 1) == rows_total - 1;
    }
    named_barrier(WALK_BAR, GROUP);
    if (*last) {
      // the last unit of this chunk: the chunk's rows in row order, as two
      // runs (the first and the second half of the rows), then added
      __threadfence();
      sum_chunk(ws, sums, reinterpret_cast<float4*>(red), rows_total, C, c0, wt);
      if (wt == 0) counters[c0 / CHUNK] = 0;  // as the next launch expects it
    }
    fence_proxy_async();  // the stage's generic writes before TMA refills it
    named_barrier(WALK_BAR, GROUP);  // the walk group is done with stage s: refill it
    if (wt == 0 && u + STAGES * gridDim.x < units) issue_dh(s, u + STAGES * gridDim.x);
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

int encode(CUtensorMap* map, const void* ptr, int item, int B, int hw, int C, int band) {
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(hw),
                            static_cast<uint64_t>(hw), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(C) * item,
                               static_cast<uint64_t>(hw) * C * item,
                               static_cast<uint64_t>(hw) * hw * C * item};
  const uint32_t box[4] = {CHUNK, static_cast<uint32_t>(hw + 2), static_cast<uint32_t>(band + 2),
                           1};
  return encode_map(map, item == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    4, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename IT, typename WT = bf16>
int launch(const float* da, const void* c, const void* h, const void* dw, void* dhid, float* ws,
           float* sums, int* counters, int B, int hw, int C, int band, cudaStream_t s) {
  const int smem = smem_bytes(band, hw, sizeof(IT));
  if (smem > SMEM_MAX || hw + 2 > 256 || band + 2 > 256)  // a TMA box dimension is <= 256
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_da, map_c, map_h;
  int err = encode(&map_da, da, 4, B, hw, C, band);
  if (!err) err = encode(&map_c, c, sizeof(IT), B, hw, C, band);
  if (!err) err = encode(&map_h, h, sizeof(IT), B, hw, C, band);
  if (err) return err;
  auto kernel = dwconv_gelu_bwd_kernel<IT, WT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int units = B * ((hw + band - 1) / band) * (C / CHUNK);
  const int grid = units < sm_count() ? units : sm_count();
  kernel<<<grid, THREADS, smem, s>>>(map_da, map_c, map_h, static_cast<const WT*>(dw),
                                     static_cast<WT*>(dhid), ws, sums, counters, B, hw, C,
                                     band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// da: (B*hw*hw, C) float32 token rows of a row-major hw x hw grid (the
// upstream gradient of the GELU output); c, h: the same rows of the
// pre-GELU values and the convolution's input, float32, or bf16 when
// in_bf16 is non-zero. dw: (9, C) bf16 taps, tap di*3+dj, or float32 when
// dw_f32 is non-zero (with float32 c and h). dhid: (B*hw*hw, C) in dw's
// type. band: grid rows per unit (hw: the whole grid). ws: (B *
// ceil(hw / band), 11, C) float32 workspace; sums: (11, C) float32 out,
// the 9 tap gradients, ddwb and db1; counters: C / 32 int32, zero, and
// left zero.
// Requires C % 32 == 0, 16-byte aligned da, c and h (TMA) and the slabs
// within a block's shared memory (ops/fused_layer_vjp.py::dwconv_gelu_bwd_body).
LTD_API int ltd_dwconv_gelu_bwd(const float* da, const void* c, const void* h, const void* dw,
                                void* dhid, float* ws, float* sums, int* counters, int B, int hw,
                                int C, int band, int in_bf16, int dw_f32, void* stream) {
  if (C % CHUNK || B < 1 || hw < 1 || band < 1 || band > hw || (dw_f32 && in_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dw_f32)
    return launch<float, float>(da, c, h, dw, dhid, ws, sums, counters, B, hw, C, band, s);
  return in_bf16 ? launch<bf16>(da, c, h, dw, dhid, ws, sums, counters, B, hw, C, band, s)
                 : launch<float>(da, c, h, dw, dhid, ws, sums, counters, B, hw, C, band, s);
}
