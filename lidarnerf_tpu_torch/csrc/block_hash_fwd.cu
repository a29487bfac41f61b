// Block-hash grid encoder, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_fwd_from_prep
// (B1), with its XLA-side prep _prep_inputs fused in. For each query q and
// level l: scale the point into the level's cell grid, find the 4x4x4-corner
// block that holds its cell (dense index at coarse levels, uint32 prime-XOR
// hash modulo the level's block budget at fine ones), interpolate the cell's
// 8 corners trilinearly and write the 2 features to out[q, 2l : 2l+2].
// Queries outside [0, 1]^3 get zeros. The plain PyTorch version of the same
// function is lidarnerf_tpu_torch/ops/block_hash.py::encode_plain.
//
// Bound: device memory. Per query the function must read 12 bytes of position
// and write 8*L bytes of features, plus the table rows it touches (at most the
// 64 MiB table), at 3.35 TB/s: 0.1446 ms for the main path's coarse call
// (Q = 3,145,728, L = 16). Its arithmetic (some 60 flops per query-level) is
// far below the card's fp32 rate. What a kernel meets first is the cache:
// each corner load instruction costs the L1 about one cycle per distinct
// 128-byte line that its 32 lanes touch, and each (query, level) needs 4
// sectors (the cell's dx = 0 and 1 lines, two dy sectors each) that at the
// fine levels come from L2. With one thread per (query, level), level
// fastest, a warp would cover 2 queries x 16 levels and every load touch
// some 24-32 lines, although at the coarse levels one row serves 5-300
// consecutive queries. The design, in the tile layout of
// block_hash_common.cuh:
//  - a block owns 32 consecutive queries, loads their points once into
//    shared memory, and its warps split the levels (warp w: levels w,
//    w + WARPS, ...); per level a warp's lane k holds query k, so the
//    neighbouring samples of a ray sit in neighbouring lanes;
//  - where the warp's 32 cells lie in at most FEW_ROWS runs of rows (levels
//    0-9 of a ray chunk) each lane reads its own 8 corners: mostly
//    broadcasts of one or a few lines;
//  - elsewhere (the fine levels, uniform points) the 8 lanes of an octet
//    read one query's 8 corners per load, 8 lines per instruction instead
//    of 32, and an octet transpose (24 shuffles) hands each lane its own
//    query's corners;
//  - every lane then interpolates with locate + trilerp, the cell choice and
//    fma order of B3a/B4a, so the features are theirs bit for bit;
//  - the block's [32, L] features are written into shared memory (rows
//    L | 1 float2s apart: no bank conflicts) and stored to `out`, where
//    they are 32 * L contiguous float2s, as coalesced 16-byte stores.
// What is left: at the fine levels each query still reads its own 4 sectors
// from L2 (about 2.2 GB per coarse call), which the cache bandwidth bounds.

#include "block_hash_common.cuh"

__global__ void __launch_bounds__(THREADS)
block_hash_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                      float2* __restrict__ out, long long Q, int L, uint32_t B,
                      const Levels lv) {
  __shared__ float2 features[32 * (MAX_LEVELS + 1)];  // [32][tile_stride(L)]
  __shared__ float points[32 * 3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)blockIdx.x * 32;
  const int n = (int)min(32LL, Q - q0);
  if ((int)threadIdx.x < 3 * n) points[threadIdx.x] = __ldg(x + 3 * q0 + threadIdx.x);
  __syncthreads();

  const int stride = tile_stride(L);
  const int s = min(lane, n - 1);  // a lane past the end repeats the last query, never stored
  const float p[3] = {points[3 * s], points[3 * s + 1], points[3 * s + 2]};
  const bool inside = !outside_unit_cube(p);
  for (int l = warp; l < L; l += WARPS) {
    const Cell c = locate(p, l, B, lv);
    const size_t level0 = (size_t)l * B * 64;  // the level's first float2
    const float2* level = reinterpret_cast<const float2*>(table) + level0;
    const uint32_t local = (uint32_t)(c.corner0 - level0);
    const uint32_t row = local >> 6;
    const uint32_t prev = __shfl_up_sync(FULL_MASK, row, 1);
    const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || row != prev);
    float2 v[8];
    load_corners(level, local, heads, lane, v);
    features[lane * stride + l] =
        inside ? trilerp(c, [&](int k) { return v[corner_of_offset(k)]; }) : make_float2(0.f, 0.f);
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

// Plain C entry point: per-level parameters come as host arrays and travel
// by value in the kernel's arguments. `out` must be 16-byte aligned, and a
// level's B * 64 float2s indexable in 32 bits. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int block_hash_fwd(const float* x, const float* table, float* out,
                              long long Q, int L, int B, const float* scale,
                              const int* max_cell, const int* blocks_axis,
                              const int* dense, void* stream) {
  Levels lv;
  if (B < 1 || (long long)B * 64 > 0xffffffffLL || Q < 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const long long blocks = (Q + 31) / 32;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_hash_fwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, table, reinterpret_cast<float2*>(out), Q, L, (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
