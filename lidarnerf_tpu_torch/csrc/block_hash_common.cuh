// Block-hash grid indexing and per-query arithmetic shared by every
// block-hash kernel (forward B1 block_hash_fwd.cu, backward B2
// block_hash_bwd.cu, and their run-collapsing variants B3a/B3b
// block_hash_seg_*.cu, B4a/B4b block_hash_win_*.cu), so all pick the same
// cell, block row and trilinear weights for a query, and the forwards sum a
// cell's corners in one order. The plain PyTorch version of the same
// indexing is lidarnerf_tpu_torch/ops/block_hash.py::level_indices_and_weights.
// The backwards' shared parts are in block_hash_scatter.cuh.
//
// The tile layout of B1 and B2 (and of B3a, B4a and B3b, B4b, which compute
// their functions). Both replace TPU kernels whose cost on this
// card is not arithmetic but where the lanes of a warp go: with one thread
// per (query, level), level fastest, a warp's 32 lanes would sit on 16
// levels of 2 queries and touch 32 rows in 16 level sub-tables, although at
// the coarse levels one row serves 5-300 consecutive queries (the samples
// of a ray are consecutive). So a block owns a tile of consecutive queries and
// walks all L levels of it, its points loaded once into shared memory, not
// once per level; per level a warp takes a group of 32 consecutive
// queries, query-major: lane k holds query k of the group, the neighbouring
// samples of one ray sit in neighbouring lanes, and at levels 0-9 a warp's
// lanes read or add to one or a few rows. What the tile shares:
//  - B1: a tile of one group (32 queries) whose warps split the levels
//    (warp w: levels w, w + WARPS, ...); its [32, L] float2 features are
//    written into shared memory and then stored to `out`, where the
//    group's rows are contiguous, as 16-byte stores;
//  - B2: a tile of TILE = THREADS queries (8 groups) whose warps each walk
//    some levels over all 8 groups in order; the tile's points [TILE, 3]
//    and feature gradients [TILE, L] float2 are staged once with coalesced
//    loads, and each warp keeps its sums for one block row (64 float2),
//    carried from group to group.
//  - B3a and B4a: B1's tile widened to a few groups (SEG_GROUPS,
//    WIN_GROUPS), its warps walking each level over the groups in order,
//    each warp with a ring of table rows in shared memory that a run (B3a)
//    or a uniform window (B4a) loads once and that the next group may reuse;
//  - B3b and B4b: B2's tile; B3b's warps carry a ring of row sums, one per
//    run of equal rows open at a group's end, where B2 carries one.
// The [*, L] float2 tiles keep their rows tile_stride(L) = L | 1 float2s
// apart: with an odd stride the 16 lanes of a half-warp, on 16 consecutive
// queries of one level, fall in 16 different bank pairs. Tiles start at
// multiples of 32 queries, so the TPU kernels' 4096-query chunks, which no
// run or window crosses, hold whole tiles, and windows are aligned slices of
// a group.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32
#define THREADS 256
#define WARPS (THREADS / 32)
#define FULL_MASK 0xffffffffu
#define TILE THREADS         // queries of a B2 block (a B1 block takes one group of 32)
#define GROUPS (TILE / 32)   // 32-query groups of a B2 tile

__host__ __device__ __forceinline__ int tile_stride(int L) { return L | 1; }

// Query j's float2 of a [*, L] tile stored row by row, rows `stride` apart:
// the float2 that lies at flat index j when the rows are packed.
__device__ __forceinline__ int tile_slot(int j, int L, int stride) {
  const int r = j / L;
  return r * stride + (j - r * L);
}

// Lets `kernel` take `bytes` of dynamic shared memory, which above 48 KB
// needs an explicit opt-in. Returns the CUDA error of the set-up (0 on success).
template <typename Kernel>
static inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

#define NO_ROW 0xffffffffu  // no table row: a warp's ring holds no open run or window

struct Levels {
  float scale[MAX_LEVELS];
  int max_cell[MAX_LEVELS];
  int blocks_axis[MAX_LEVELS];
  int dense[MAX_LEVELS];
  int runs[MAX_LEVELS];  // seg: 1 if the level walks runs; win: its window size
};

// Copies the host's per-level arrays into the by-value kernel argument;
// `runs` may be null (B1, B2). Returns false on a level count the kernels
// do not take.
static inline bool fill_levels(Levels* lv, int L, const float* scale, const int* max_cell,
                               const int* blocks_axis, const int* dense,
                               const int* runs = nullptr) {
  if (L < 1 || L > MAX_LEVELS) return false;
  for (int l = 0; l < L; ++l) {
    lv->scale[l] = scale[l];
    lv->max_cell[l] = max_cell[l];
    lv->blocks_axis[l] = blocks_axis[l];
    lv->dense[l] = dense[l];
    lv->runs[l] = runs ? runs[l] : 0;
  }
  return true;
}

// A query's place at one level: the flat index of its first corner float2
// in the table (row * 64 + the cell's corner offset within the block row)
// and the per-axis weights of the cell's two corners. The offset is below
// 64, so corner0 >> 6 is the table row and corner0 & 63 the offset.
struct Cell {
  size_t corner0;  // ((l * B + row) * 64 + (loc_x * 4 + loc_y) * 4 + loc_z)
  float wx[2], wy[2], wz[2];
};

__device__ __forceinline__ bool outside_unit_cube(const float p[3]) {
  return p[0] < 0.f || p[0] > 1.f || p[1] < 0.f || p[1] > 1.f || p[2] < 0.f || p[2] > 1.f;
}

// The position scale and the cell offset use __fmul_rn/__fadd_rn so the cell
// choice rounds exactly like the plain version's separate multiply and add.
__device__ __forceinline__ Cell locate(const float p[3], int l, uint32_t B, const Levels& lv) {
  const float s = lv.scale[l];
  const int max_cell = lv.max_cell[l];
  int blk[3], loc[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(__fmul_rn(p[a], s), 0.5f);
    const float cell = floorf(pos);
    frac[a] = pos - cell;
    const int c = min(max((int)cell, 0), max_cell);
    blk[a] = c / 3;
    loc[a] = c - 3 * blk[a];
  }
  uint32_t idx;
  if (lv.dense[l]) {
    const int nb = lv.blocks_axis[l];
    idx = (uint32_t)((blk[0] * nb + blk[1]) * nb + blk[2]);
  } else {
    idx = (uint32_t)blk[0] ^ ((uint32_t)blk[1] * 2654435761u) ^ ((uint32_t)blk[2] * 805459861u);
  }
  idx %= B;
  Cell c;
  c.corner0 = ((size_t)l * B + idx) * 64 + (loc[0] * 4 + loc[1]) * 4 + loc[2];
  c.wx[0] = 1.f - frac[0];
  c.wx[1] = frac[0];
  c.wy[0] = 1.f - frac[1];
  c.wy[1] = frac[1];
  c.wz[0] = 1.f - frac[2];
  c.wz[1] = frac[2];
  return c;
}

// Offset of corner (dx, dy, dz) of the cell from its first corner, in float2s.
__device__ __forceinline__ int corner_offset(int dx, int dy, int dz) {
  return (dx * 4 + dy) * 4 + dz;
}

__device__ __forceinline__ void load_point(const float* __restrict__ x, long long q, float p[3]) {
  p[0] = __ldg(x + 3 * q);
  p[1] = __ldg(x + 3 * q + 1);
  p[2] = __ldg(x + 3 * q + 2);
}

// The two features of a query: the trilinear sum of its cell's 8 corner
// float2s, corner(k) returning the corner at offset k from the first. Every
// forward kernel sums in this one order with explicit fmas, so they agree
// bit for bit wherever the corners are read from.
template <typename Corner>
__device__ __forceinline__ float2 trilerp(const Cell& c, Corner corner) {
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = __fmul_rn(c.wx[dx], c.wy[dy]);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(wxy, c.wz[dz]);
        const float2 v = corner(corner_offset(dx, dy, dz));
        acc.x = __fmaf_rn(w, v.x, acc.x);
        acc.y = __fmaf_rn(w, v.y, acc.y);
      }
    }
  }
  return acc;
}

// Corner i = (dx * 2 + dy) * 2 + dz of a cell sits corner_offset(dx, dy, dz)
// float2s after its first corner; trilerp asks for corners by that offset.
__device__ __forceinline__ int offset_of_corner(int i) {
  return corner_offset(i >> 2, (i >> 1) & 1, i & 1);
}
__device__ __forceinline__ int corner_of_offset(int k) {
  return ((k >> 4) * 2 + ((k >> 2) & 1)) * 2 + (k & 1);
}

// An 8 x 8 transpose within each octet of lanes: lane k of an octet holds
// v[r] = corner k of the octet's query r; afterwards lane r holds v[k] =
// corner k of its own query (B1's loads), and the same call turns a lane's
// own 8 corners into corner k of the octet's 8 queries (B2's adds).
// Three butterfly stages of 4 float2 swaps.
__device__ __forceinline__ void transpose_octet(float2 v[8], int k) {
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1) {
    const bool upper = k & m;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e & m) continue;  // the pair (e, e | m)
      const float2 send = upper ? v[e] : v[e | m];
      const float2 got = make_float2(__shfl_xor_sync(FULL_MASK, send.x, m),
                                     __shfl_xor_sync(FULL_MASK, send.y, m));
      if (upper) {
        v[e] = got;
      } else {
        v[e | m] = got;
      }
    }
  }
}

#define FEW_ROWS 8  // at most this many runs of rows in a warp: each lane reads its own corners

// B1's corner loads of one (group, level): v[i] = corner i of the lane's
// cell, `local` its first corner within the level's float2s `level`, and
// `heads` the lanes whose row differs from the previous lane's. Where the
// warp's cells lie in at most FEW_ROWS runs of rows each lane reads its own
// corners (mostly broadcasts of a few lines); elsewhere the 8 lanes of an
// octet read one query's 8 corners per load, 8 lines per instruction
// instead of 32, and an octet transpose hands each lane its own. Only the
// lanes of `want` get their corners (B4a's lanes outside a uniform window);
// every lane must call it.
__device__ __forceinline__ void load_corners(const float2* __restrict__ level, uint32_t local,
                                             unsigned heads, int lane, float2 v[8],
                                             unsigned want = FULL_MASK) {
  if (__popc(heads) <= FEW_ROWS) {
    if ((want >> lane) & 1u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __ldg(level + local + offset_of_corner(i));
    }
  } else {
    const int octet = lane & ~7, k8 = lane & 7;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t at = __shfl_sync(FULL_MASK, local, octet + r);
      v[r] = ((want >> (octet + r)) & 1u) ? __ldg(level + at + offset_of_corner(k8))
                                          : make_float2(0.f, 0.f);
    }
    transpose_octet(v, k8);
  }
}
