// Block-hash grid indexing shared by the forward (block_hash_fwd.cu) and
// backward (block_hash_bwd.cu) kernels, so both pick the same cell, block
// row and trilinear weights for a query. The plain PyTorch version of the
// same indexing is lidarnerf_tpu_torch/ops/block_hash.py::level_indices_and_weights.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32
#define THREADS 256

struct Levels {
  float scale[MAX_LEVELS];
  int max_cell[MAX_LEVELS];
  int blocks_axis[MAX_LEVELS];
  int dense[MAX_LEVELS];
};

// Copies the host's per-level arrays into the by-value kernel argument.
// Returns false on a level count the kernels do not take.
static inline bool fill_levels(Levels* lv, int L, const float* scale, const int* max_cell,
                               const int* blocks_axis, const int* dense) {
  if (L < 1 || L > MAX_LEVELS) return false;
  for (int l = 0; l < L; ++l) {
    lv->scale[l] = scale[l];
    lv->max_cell[l] = max_cell[l];
    lv->blocks_axis[l] = blocks_axis[l];
    lv->dense[l] = dense[l];
  }
  return true;
}

// A query's place at one level: the flat index of its first corner float2
// in the table (row * 64 + the cell's corner offset within the block row)
// and the per-axis weights of the cell's two corners.
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
