// Block-hash grid encoder, forward by runs of equal rows (B3a), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_fwd_seg_from_prep
// (B3a), with its XLA-side prep (_prep_inputs, seg_next) fused in. It
// computes B1's function (block_hash_fwd.cu): per query and level, the
// trilinear interpolation of the cell's 8 corners inside one 128-float
// block row, zero outside [0, 1]^3. Consecutive queries are consecutive
// samples along a ray, so at the coarse levels long runs of them fall in
// one block row; this kernel loads such a run's row once. Its output equals
// B1's bit for bit (the same cell, weights and fma order, from
// block_hash_common.cuh). The plain PyTorch version of the same function is
// lidarnerf_tpu_torch/ops/block_hash.py::encode_plain.
//
// Bound: the same as B1's, device memory. The function must read 12 bytes
// of position and write 8*L bytes of features per query, plus the table
// rows it touches, at 3.35 TB/s; its ~60 flops per query-level are far below
// the fp32 rate. What a kernel meets first is where the lanes of a warp go:
// with one thread per (level, query), every feature store out[q * L + l]
// lies 128 bytes from its lane neighbour's (32 lines per instruction). The
// design keeps the TPU kernel's mechanism, one row load per run, in B1's
// tile layout (block_hash_common.cuh):
//  - a block owns a tile of 32 * SEG_GROUPS consecutive queries whose
//    points it stages once in shared memory; its warps split the levels
//    (warp w: levels w, w + WARPS, ...) and walk each over the tile's
//    32-query groups in order; lane k holds query k of a group;
//  - on a level of scale <= SEG_SCALE_MAX (the host's `runs` array), a
//    shuffle and a ballot find the group's runs of equal rows; a group of
//    at most SEG_SLOTS runs loads each run's 512-byte row once, one float4
//    per lane (one coalesced load per run), into the warp's ring of
//    SEG_SLOTS rows in shared memory, where a run that goes on from the
//    warp's previous group finds its row already: a 300-query run at
//    level 0 costs one row load per tile, not one per group;
//  - every lane then interpolates its own query from there with locate +
//    trilerp, the cell choice and fma order of B1, so the features are
//    B1's bit for bit;
//  - a group of more runs, and every other level, takes B1's corner loads
//    (load_corners: each lane its own corners, or octets);
//  - the tile's [32 * SEG_GROUPS, L] features are written into shared
//    memory and stored to `out`, where they are contiguous, as coalesced
//    16-byte stores.
// The TPU kernel's devices (SMEM scalar streams, the per-chunk run limit
// CHUNK / NSEG_DIV, the split-bf16 MXU lane reduction) have no place here:
// the run limit chose between the TPU's two paths, and here the choice is
// made per group, where it costs nothing.

#include "block_hash_common.cuh"

#ifndef SEG_GROUPS
#define SEG_GROUPS 2  // 32-query groups per tile (64 timed best of 32-256)
#endif
#define SEG_SLOTS 4  // table rows a warp holds in shared memory (a power of 2)
#define SEG_TILE (32 * SEG_GROUPS)

__global__ void __launch_bounds__(THREADS)
block_hash_seg_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                          float2* __restrict__ out, long long Q, int L, uint32_t B,
                          const Levels lv) {
  extern __shared__ float4 shared[];
  const int stride = tile_stride(L);
  float4* slots = shared;                                                    // [WARPS][SEG_SLOTS][32]
  float2* features = reinterpret_cast<float2*>(slots + WARPS * SEG_SLOTS * 32);  // [SEG_TILE][stride]
  float* pts = reinterpret_cast<float*>(features + SEG_TILE * stride);          // [SEG_TILE][3]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)blockIdx.x * SEG_TILE;
  const int n = (int)min((long long)SEG_TILE, Q - q0);
  for (int i = threadIdx.x; i < 3 * n; i += THREADS) pts[i] = __ldg(x + 3 * q0 + i);
  __syncthreads();

  const float4* table4 = reinterpret_cast<const float4*>(table);
  float4* ring = slots + warp * SEG_SLOTS * 32;
  for (int l = warp; l < L; l += WARPS) {
    const size_t level0 = (size_t)l * B * 64;  // the level's first float2
    const float2* level = reinterpret_cast<const float2*>(table) + level0;
    uint32_t carried = NO_ROW;  // the row in slot `last`
    int last = SEG_SLOTS - 1;
    for (int k = 0; k < SEG_GROUPS && 32 * k < n; ++k) {
      const int i = 32 * k + lane;
      const int s = min(i, n - 1);  // a lane past the end repeats the last query, never stored
      const float p[3] = {pts[3 * s], pts[3 * s + 1], pts[3 * s + 2]};
      const bool inside = !outside_unit_cube(p);
      const Cell c = locate(p, l, B, lv);
      const uint32_t local = (uint32_t)(c.corner0 - level0);
      const uint32_t row = local >> 6;
      const uint32_t prev = __shfl_up_sync(FULL_MASK, row, 1);
      const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || row != prev);
      const int nruns = __popc(heads);
      float2 o;
      if (lv.runs[l] && nruns <= SEG_SLOTS) {
        // run u's row goes to slot (first + u) % SEG_SLOTS; a first run that
        // goes on from the previous group is already in slot `last`
        const bool goes_on = __shfl_sync(FULL_MASK, row, 0) == carried;
        const int first = goes_on ? last : (last + 1) % SEG_SLOTS;
        unsigned todo = goes_on ? heads & (heads - 1) : heads;
        for (int u = goes_on; todo; ++u, todo &= todo - 1) {
          const uint32_t r = __shfl_sync(FULL_MASK, row, __ffs(todo) - 1);
          ring[((first + u) % SEG_SLOTS) * 32 + lane] = __ldg(table4 + ((size_t)l * B + r) * 32 + lane);
        }
        __syncwarp();
        const int run = __popc(heads & (FULL_MASK >> (31 - lane))) - 1;
        const float2* corners = reinterpret_cast<const float2*>(ring + ((first + run) % SEG_SLOTS) * 32);
        const int off = (int)(c.corner0 & 63);
        o = inside ? trilerp(c, [&](int kk) { return corners[off + kk]; }) : make_float2(0.f, 0.f);
        __syncwarp();  // the rows are read before the next group's loads
        carried = __shfl_sync(FULL_MASK, row, 31);
        last = (first + nruns - 1) % SEG_SLOTS;
      } else {
        float2 v[8];
        load_corners(level, local, heads, lane, v);
        o = inside ? trilerp(c, [&](int kk) { return v[corner_of_offset(kk)]; })
                   : make_float2(0.f, 0.f);
        carried = NO_ROW;
      }
      features[i * stride + l] = o;
    }
  }
  __syncthreads();

  // out[q0 : q0 + n] is n * L contiguous float2s, 16-byte aligned (q0 is a
  // multiple of 32 and out is 16-byte aligned)
  const int m = n * L;
  float2* dst = out + q0 * L;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int k = threadIdx.x; k < m / 2; k += THREADS) {
    const float2 a = features[tile_slot(2 * k, L, stride)];
    const float2 b = features[tile_slot(2 * k + 1, L, stride)];
    dst4[k] = make_float4(a.x, a.y, b.x, b.y);
  }
  if ((m & 1) && threadIdx.x == 0) dst[m - 1] = features[tile_slot(m - 1, L, stride)];
}

// Plain C entry point, as block_hash_fwd's, plus `runs` [L] (host): 1 where
// the level walks runs. The table and `out` must be 16-byte aligned.
// Returns the first CUDA error of the set-up or the launch (0 on success).
extern "C" int block_hash_seg_fwd(const float* x, const float* table, float* out,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || (long long)B * 64 > 0xffffffffLL || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs) ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(table) % 16)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const long long blocks = (Q + SEG_TILE - 1) / SEG_TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * SEG_SLOTS * 512 +
                      (size_t)SEG_TILE * tile_stride(L) * sizeof(float2) +
                      SEG_TILE * 3 * sizeof(float);
  const cudaError_t err = allow_shared(block_hash_seg_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  block_hash_seg_fwd_kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, table, reinterpret_cast<float2*>(out), Q, L, (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
