// Block-hash grid indexing and per-query arithmetic shared by every
// block-hash kernel (forward B1 block_hash_fwd.cu, backward B2
// block_hash_bwd.cu, and their run-collapsing variants B3a/B3b
// block_hash_seg_*.cu, B4a/B4b block_hash_win_*.cu), so all pick the same
// cell, block row and trilinear weights for a query, and the forwards sum a
// cell's corners in one order. The plain PyTorch version of the same
// indexing is lidarnerf_tpu_torch/ops/block_hash.py::level_indices_and_weights.
//
// The tile layout of B1 and B2. Both replace TPU kernels whose cost on this
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
// The [*, L] float2 tiles keep their rows tile_stride(L) = L | 1 float2s
// apart: with an odd stride the 16 lanes of a half-warp, on 16 consecutive
// queries of one level, fall in 16 different bank pairs.
// B3a/B3b and B4a/B4b keep the one-thread-per-query layout of their
// (level, 4096-query chunk) blocks and B2's per-query scatter_query.
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

// the run structure of the seg and win kernels (ops/block_hash.py CHUNK, NSEG_DIV)
#define CHUNK 4096
#define NSEG_DIV 5

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

// One (query, level) of the per-query paths of B3a and B4a (B1's work
// before its tile layout): the features read from the table in device
// memory; zero outside [0, 1]^3.
__device__ __forceinline__ float2 encode_query(const float p[3], int l, uint32_t B,
                                               const Levels& lv,
                                               const float2* __restrict__ table) {
  if (outside_unit_cube(p)) return make_float2(0.f, 0.f);
  const Cell c = locate(p, l, B, lv);
  const float2* corner = table + c.corner0;
  return trilerp(c, [&](int k) { return __ldg(corner + k); });
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
// own 8 corners into corner k of the octet's 8 queries (B2's atomics).
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

// The per-query path of B3b and B4b (and of B2 before its tile layout) for
// one (query, level) inside [0, 1]^3: one float2 atomicAdd of w * g to each
// of the cell's 8 corners.
__device__ __forceinline__ void scatter_query(const Cell& c, float2 gv, float2* __restrict__ grad) {
  float2* corner = grad + c.corner0;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = __fmul_rn(c.wx[dx], c.wy[dy]);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(wxy, c.wz[dz]);
        atomicAdd(corner + corner_offset(dx, dy, dz),
                  make_float2(__fmul_rn(w, gv.x), __fmul_rn(w, gv.y)));
      }
    }
  }
}

// The run-collapsing backwards (B3b, B4b) sum the terms of a group of
// queries that share one block row before they add them to the table. A
// query travels between the lanes of its group as its cell's corner offset
// in the row (`off`, from Cell::corner0 & 63), the fractions of its
// position (Cell::wx[1], wy[1], wz[1]) and its feature grads.
struct Term {
  int off;
  float fx, fy, fz;
  float2 g;
};

__device__ __forceinline__ Term shfl_term(unsigned mask, const Term& t, int src) {
  Term r;
  r.off = __shfl_sync(mask, t.off, src);
  r.fx = __shfl_sync(mask, t.fx, src);
  r.fy = __shfl_sync(mask, t.fy, src);
  r.fz = __shfl_sync(mask, t.fz, src);
  r.g.x = __shfl_sync(mask, t.g.x, src);
  r.g.y = __shfl_sync(mask, t.g.y, src);
  return r;
}

// Adds a query's term at corner float2 `s` of its row (0 <= s < 64) to
// `acc`: w * g with w its trilinear weight there, the same products as
// scatter_query, or nothing if s is not a corner of its cell.
__device__ __forceinline__ void add_corner_term(float2& acc, int s, const Term& t) {
  const int dx = (s >> 4) - (t.off >> 4);
  const int dy = ((s >> 2) & 3) - ((t.off >> 2) & 3);
  const int dz = (s & 3) - (t.off & 3);
  if ((unsigned)dx > 1u || (unsigned)dy > 1u || (unsigned)dz > 1u) return;
  const float wx = dx ? t.fx : 1.f - t.fx;
  const float wy = dy ? t.fy : 1.f - t.fy;
  const float wz = dz ? t.fz : 1.f - t.fz;
  const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, t.g.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, t.g.y));
}

// The term of query q at level l: zero grads outside [0, 1]^3 (the JAX
// package zeroes those grads before its backward) and for a lane with no
// query (valid false).
__device__ __forceinline__ Term make_term(const Cell& c, bool inside, const float2* __restrict__ g,
                                          long long q, int L, int l) {
  Term t;
  t.off = (int)(c.corner0 & 63);
  t.fx = c.wx[1];
  t.fy = c.wy[1];
  t.fz = c.wz[1];
  t.g = inside ? __ldg(g + q * L + l) : make_float2(0.f, 0.f);
  return t;
}

// Adds a group's summed corner float2s to the table, one atomicAdd each;
// a float2 that no query touched (or whose terms cancel to zero) is skipped.
__device__ __forceinline__ void flush_corner(float2* __restrict__ row, int s, float2 acc) {
  if (acc.x != 0.f || acc.y != 0.f) atomicAdd(row + s, acc);
}
