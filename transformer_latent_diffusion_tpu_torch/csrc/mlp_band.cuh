// Shared pieces of the sep-conv MLP's band kernels (mlp_band_fwd.cu,
// mlp_band_bwd.cu): the tiling, the products from a TMA ring, the float32
// staging of a product's tile in shared memory, and the walks that read a
// staged tile at any grid position, through distributed shared memory
// where a neighbouring block of the cluster holds it.
//
// The tiling. A block owns one unit: (image b, tile of TILE = 128
// consecutive tokens of that image, chunk of NC = 128 hidden channels).
// The T = ceil(hw^2 / 128) tiles of one image and one chunk form one
// thread-block cluster (T <= 8: hw <= 32), rank r owning tokens
// [128 r, 128 r + 128). A 3x3 tap reaches at most hw + 1 <= 33 tokens
// away, so a tile's halo lies in the tiles of ranks r - 1 and r + 1
// only; positions outside the hw x hw grid read as zero (the TPU kernel's
// zero padding). The grid is (T, C / 128, B), one unit a block; the
// blocks of a cluster read each other's staged tiles after a cluster
// barrier and keep their shared memory until a last one.
//
// The products. Two warpgroups each multiply 64 of the tile's rows with
// `wgmma` m64n128k16 into 64 float32 accumulators a thread, from a ring of
// STAGES stages of 32 KB (A's 128 x 64 and W's 128 x 64 bf16, two 64 x 64
// boxes each, 128-byte swizzle) with full and empty mbarriers, as
// csrc/ln_gemm.cu's main loop. The loads come from a producer warpgroup
// (the backward) or from thread 0 between its products (the forward): the
// first STAGES at once, then each stage again as soon as both warpgroups
// are done with it. A product's tile (+ bias) is staged in shared memory
// in float32, row stride HS = 136 floats (the 8-float pad keeps the
// accumulators' stores at two wavefronts a warp). (W multicast to the
// cluster, which reads it once a cluster, ran slower on an H100: every
// step then waits for the cluster's slowest block.)
//
// The walks. A warp takes runs of up to TSEG consecutive pixels of one
// grid row of its tile; lane l owns channels 4 l .. 4 l + 3 of the chunk
// (one 16-byte read of a staged row per lane: a warp reads a row's 512
// bytes at once). A run is walked commuted, as csrc/dwconv_gelu.cu walks
// its slab: at each grid column the three row taps z_dj, then pixel j
// sums z0 (column j - 1), z1 (j) and z2 (j + 1), the float32 sum of the
// TPU kernel's order (ops/fused_mlp_vjp.py::_dw_fwd). The run's items are
// dealt to the 8 warps in order (item i to warp i % 8). Reads are
// `ld.shared::cluster` at 32-bit cluster addresses: each of a run's three
// source rows lies in one tile (its address computed once a run; a row
// that a tile boundary cuts, which a grid of hw not dividing 128 has, is
// read position by position), and a position outside the grid reads a
// zeroed row of the block's own shared memory, so no read is branched.
#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "hopper.cuh"

namespace band {

namespace cg = cooperative_groups;

constexpr int NC = 128;                  // hidden channels of a unit
constexpr int BK = 64;                   // K per stage
constexpr int BOX = 64 * 64 * 2;         // one 64 x 64 bf16 TMA box
constexpr int W_BYTES = 2 * BOX;         // W's 128 x 64 of a stage
constexpr int STAGES = 3;
constexpr int HS = NC + 8;               // row stride of a staged float32 tile
constexpr int ROW_BYTES = HS * 4;
constexpr int ZERO_BYTES = NC * 4;       // the zero row
constexpr int TSEG = 8;                  // pixels of a run
constexpr int MAX_TILES = 8;             // the portable cluster size: hw <= 32
static_assert(NC == 32 * 4, "a warp's lanes cover the chunk, 4 channels each");

constexpr int TILE = 128;                // tokens of a unit: two warpgroups of 64 rows
constexpr int CONSUMERS = TILE / 64;
constexpr int GROUP = CONSUMERS * 128;   // the threads of the products and the walks
constexpr int WARPS = CONSUMERS * 4;     // the walkers
constexpr int STAGE_BYTES = CONSUMERS * BOX + W_BYTES;  // A 128 x 64 + W 128 x 64
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int STAGED_BYTES = TILE * ROW_BYTES;
static_assert(STAGED_BYTES <= RING_BYTES, "a staged tile fits the idle ring");

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// d (64 x 128, float32) += A (64 x 16) B (16 x 128), both bf16 in shared
// memory; TB = 1: B is MN-major; scale_d = 0: d = A B, d's old values ignored
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// ------------------------- distributed shared memory -------------------------

// the 32-bit shared::cluster address of p's offset in the block of `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// ------------------------------- the products -------------------------------

// The ring and its load sequence: K steps 0 .. nk - 1 of product 0 (A =
// a0, W = w0), then of product 1 (a1, w1). W is (N, K), K-major, or for
// the second product of the backward (K, N), the MN-major operand read as
// stored (mn1). `q` counts the steps consumed, `issued` the steps loaded
// (by the producer thread, or thread 0 without a producer warpgroup).
template <bool PRODUCER>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  const CUtensorMap *a0, *w0, *a1, *w1;
  bool mn1;
  int a_row, n0, nk, total;
  int stage = 0, q = 0, issued = 0, istage = 0;
  uint32_t phase = 0, iphase = 0;

  // load the steps up to `upto` (exclusive), each into a stage that every
  // consumer has released
  __device__ __forceinline__ void top_up(int upto) {
    for (; issued < min(upto, total); ++issued) {
      const bool second = issued >= nk, mn = second && mn1;
      const CUtensorMap* ma = second ? a1 : a0;
      const CUtensorMap* mw = second ? w1 : w0;
      const int k0 = (second ? issued - nk : issued) * BK;
      mbar_wait(&empty[istage], iphase ^ 1);
      mbar_arrive_expect_tx(&full[istage], STAGE_BYTES);
      unsigned char* st = base + istage * STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < CONSUMERS; ++i)
        tma_load_2d(st + i * BOX, ma, &full[istage], k0, a_row + 64 * i);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // box j: 64 K rows of columns n0 + 64 j .. (MN-major), or rows
        // n0 + 64 j .. of 64 K columns
        tma_load_2d(st + CONSUMERS * BOX + j * BOX, mw, &full[istage],
                    mn ? n0 + 64 * j : k0, mn ? k0 : n0 + 64 * j);
      }
      if (++istage == STAGES) {
        istage = 0;
        iphase ^= 1;
      }
    }
  }

  // A warpgroup's 64 rows of the next product: acc = its rows of the tile
  // times W's 128 columns over nk steps (the first step overwrites acc).
  // One step of products stays in flight.
  template <bool TB>
  __device__ __forceinline__ void product(float (&acc)[64], int wg, int wt, int tid) {
    int prev = 0;
    for (int kc = 0; kc < nk; ++kc, ++q) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = base + stage * STAGE_BYTES + wg * BOX;
      const unsigned char* w = base + stage * STAGE_BYTES + CONSUMERS * BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
        // TB: 16 K rows of 128 bytes, the two 64-column boxes BOX apart
        const uint64_t dw =
            TB ? sw128_desc(w + kk * 2048, BOX, 1024) : sw128_desc(w + kk * 32, 16, 1024);
        wgmma_n128<TB ? 1 : 0>(acc, da, dw, kc > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kc > 0) {  // the previous step's products are done
        if (wt == 0) mbar_arrive(&empty[prev]);
        if (!PRODUCER && tid == 0) top_up(q + STAGES);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (wt == 0) mbar_arrive(&empty[prev]);
    if (!PRODUCER && tid == 0) top_up(q + STAGES);
  }
};

// acc (+ bias[c0 + column], if given) into the warpgroup's 64 rows of a
// staged float32 tile. Thread t holds rows 16 (t / 32) + (t % 32) / 4 (+ 8)
// and columns 8 j + 2 (t % 4) (+ 1) of its warpgroup's 64 x 128.
__device__ __forceinline__ void stage_acc(float* tile, const float (&acc)[64],
                                          const float* __restrict__ bias, int c0, int wg, int wt) {
  const int r = wg * 64 + (wt >> 5) * 16 + ((wt & 31) >> 2);
  const int t4 = wt & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 b2 = bias != nullptr ? *reinterpret_cast<const float2*>(bias + c0 + col)
                                      : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r + 8 * h) * HS + col) =
          make_float2(acc[4 * j + 2 * h] + b2.x, acc[4 * j + 2 * h + 1] + b2.y);
  }
}

// --------------------------------- the walks ---------------------------------

// The cluster addresses of a staged tile (the same offset in every block)
// and of this block's zero row.
struct Staged {
  uint32_t own, prev, next, zero;
  int t0;  // the own tile's first token
};

__device__ __forceinline__ Staged staged(const void* tile, const void* zero_row, int rank,
                                         int tiles) {
  Staged s;
  s.own = cluster_addr(tile, rank);
  s.prev = rank > 0 ? cluster_addr(tile, rank - 1) : 0;
  s.next = rank + 1 < tiles ? cluster_addr(tile, rank + 1) : 0;
  s.zero = cluster_addr(zero_row, rank);
  s.t0 = rank * TILE;
  return s;
}

// The byte address, lane's 16 bytes, of grid position (i, j): the zero row
// outside the hw x hw grid, else the row of the tile that owns token i hw + j
__device__ __forceinline__ uint32_t at(const Staged& st, int i, int j, int hw, int lane) {
  if (i < 0 || i >= hw || j < 0 || j >= hw) return st.zero + 16 * lane;
  const int s = i * hw + j - st.t0;
  const uint32_t row = s < 0 ? st.prev + (s + TILE) * ROW_BYTES
                     : s >= TILE ? st.next + (s - TILE) * ROW_BYTES
                                 : st.own + s * ROW_BYTES;
  return row + 16 * lane;
}

// A run: pixels (i, j0 .. j1 - 1) of one grid row. Its three source rows i
// - 1 .. i + 1 at grid columns j0 - 1 .. j1: `row[di]` is the address of
// row i + di - 1 at column j0 - 1 (lane's bytes), a column step ROW_BYTES
// on, when the row lies in one tile (`one_tile`); rows outside the grid
// read the zero row (`in_grid`); the columns -1 and hw read it too.
struct Run {
  int i, j0, j1;
  uint32_t row[3];
  bool in_grid[3], one_tile;
  bool left, right;  // columns j0 - 1 and j1 inside the grid
};

__device__ __forceinline__ Run make_run(const Staged& st, int i, int j0, int j1, int hw,
                                        int lane) {
  Run r;
  r.i = i, r.j0 = j0, r.j1 = j1;
  r.left = j0 > 0, r.right = j1 < hw;
  r.one_tile = true;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int ii = i + di - 1;
    r.in_grid[di] = ii >= 0 && ii < hw;
    const int s0 = ii * hw - st.t0;  // the row's column 0, tile-relative
    const uint32_t base = s0 + hw <= 0 ? st.prev + (s0 + TILE) * ROW_BYTES
                        : s0 >= TILE ? st.next + (s0 - TILE) * ROW_BYTES
                                     : st.own + s0 * ROW_BYTES;
    if (r.in_grid[di] && ((s0 < 0 && s0 + hw > 0) || (s0 < TILE && s0 + hw > TILE)))
      r.one_tile = false;  // a tile boundary cuts this row
    r.row[di] = base + (j0 - 1) * ROW_BYTES + 16 * lane;
  }
  return r;
}

// lane's 4 channels of source row di at step cc of the run (grid column j0
// - 1 + cc); ONE: every source row lies in one tile
template <bool ONE>
__device__ __forceinline__ float4 load(const Staged& st, const Run& r, int di, int cc, int hw,
                                       int lane) {
  if (ONE) {
    const bool edge = (cc == 0 && !r.left) || (r.j0 + cc - 1 == r.j1 && !r.right);
    return ld_cluster(r.in_grid[di] && !edge ? r.row[di] + cc * ROW_BYTES
                                              : st.zero + 16 * lane);
  }
  return ld_cluster(at(st, r.i + di - 1, r.j0 - 1 + cc, hw, lane));
}

// The runs of a tile of tokens [t0, t1) of an hw-wide grid: row t0 / hw +
// k, its columns from ja (the tile's first column in that row) in segments
// of TSEG, up to jb. item -> (row, j0, j1); false where the item is empty.
struct Runs {
  int t0, t1, hw, row0, rows, segs;
  __device__ __forceinline__ Runs(int t0_, int t1_, int hw_) : t0(t0_), t1(t1_), hw(hw_) {
    row0 = t0 / hw;
    rows = (t1 - 1) / hw - row0 + 1;
    segs = (hw + TSEG - 1) / TSEG;
  }
  __device__ __forceinline__ int items() const { return rows * segs; }
  __device__ __forceinline__ bool item(int it, int& i, int& j0, int& j1) const {
    i = row0 + it / segs;
    const int ja = max(t0 - i * hw, 0), jb = min(t1 - i * hw, hw);
    j0 = ja + (it % segs) * TSEG;
    j1 = min(j0 + TSEG, jb);
    return j0 < j1;
  }
};

// 4 bf16 taps (channels c .. c + 3) of tap row t of dw (9, C)
__device__ __forceinline__ void load_taps(float* w, const bf16* __restrict__ dw, int t, int C,
                                          int c) {
  const uint2 u = *reinterpret_cast<const uint2*>(dw + static_cast<size_t>(t) * C + c);
  w[0] = __uint_as_float(u.x << 16), w[1] = __uint_as_float(u.x & 0xffff0000u);
  w[2] = __uint_as_float(u.y << 16), w[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void store_bf16x4(bf16* out, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

__device__ __forceinline__ void to4(float (&v)[4], const float4& f) {
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

// ----------------------------------- host -----------------------------------

// A 2-D tensor map over a row-major (rows, cols) bf16 matrix, 64 x 64
// boxes, 128-byte swizzle (the wgmma operands' layout)
inline int encode_bf16_2d(CUtensorMap* map, const void* ptr, int cols, int rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t stride[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {64, 64};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, stride, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launch `kernel` on `grid` in clusters of `tiles` blocks along x, its
// arguments' addresses in `args`; its launch error, or the first error
// after it.
inline int launch(const void* kernel, int threads, dim3 grid, int tiles, int smem,
                  cudaStream_t s, void** args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// the tiles (cluster size) of an hw x hw grid, 0 where it takes none
inline int tiles_of(int hw) {
  const int t = (hw * hw + TILE - 1) / TILE;
  return hw >= 1 && t <= MAX_TILES ? t : 0;
}

}  // namespace band
