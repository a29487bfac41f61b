// Block-hash grid encoder, table gradient by uniform windows (B4b), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_bwd_win_from_prep
// (B4b). It computes B2's function (block_hash_bwd.cu): for each query
// inside [0, 1]^3 and level l, w * (g[q, 2l], g[q, 2l+1]) added to each of
// the cell's 8 corner float2s, w the corner's trilinear weight, duplicates
// summed, into the [L*B, 128] float32 table gradient. Level l cuts the
// query stream into fixed windows of W = 8, 4, 2 or 1 consecutive queries
// (the host's `runs` array, block_hash.py::win_of_level); a window whose W
// queries share one block row ("uniform") sums its terms first and adds
// them as one set, where B2's plain path adds 8 corners per query. The
// plain PyTorch version with the same window rules is
// lidarnerf_tpu_torch/ops/block_hash.py::encode_bwd_win_plain.
//
// Bound: the same as B2's, device memory. The function must read 12 bytes
// of position and 8*L bytes of feature gradient per query and write the
// 64 MiB gradient table once, at 3.35 TB/s; its ~80 flops per query-level
// are far below the fp32 rate. What a kernel meets first is where the
// lanes of a warp go: with one thread per (level, query) in a block per
// (level, 4096-query chunk), every load of g[q * L + l] lies 128 bytes from
// its lane neighbour's (32 lines per instruction). The design keeps the TPU
// kernel's mechanism, one set of adds per uniform window, in B2's tile
// layout (block_hash_common.cuh):
//  - a block owns a tile of TILE consecutive queries whose points and g are
//    staged in shared memory with coalesced loads; warp w walks levels w,
//    w + WARPS, ... over the tile's 32-query groups in order; windows are
//    aligned W-lane slices of a group (the tile and the chunks start at
//    multiples of 32);
//  - per group, a shuffle of each window's first row and a ballot mark the
//    uniform windows, and a second shuffle and ballot the cell changes;
//  - where every window is uniform and lies in one cell (the coarse levels
//    along a ray), a reduce-scatter over each window's W lanes leaves each
//    lane the window's sums of 8 / W corners, which it adds: the window's 8
//    corners in one round, spread over its lanes;
//  - where only some windows are, a segmented scan sums each cell's lanes
//    within its uniform window, and each sum's last lane adds 8 corners;
//  - other windows, and every W = 1 level, take B2's octet scatter;
//  - every add goes through the order-free fixed-point accumulator of
//    block_hash_scatter.cuh, so the table is the same bit for bit from run
//    to run.
// The TPU kernel's devices (SMEM flag streams, tile reductions, 8 VMEM
// accumulator copies, the MXU one-hot scatter of the dense pair) have no
// place here, nor does B2's carried row: a uniform window adds its sums at
// once.

#include "block_hash_common.cuh"
#include "block_hash_scatter.cuh"

// The first lanes of the W-lane windows of a warp.
template <int W>
__device__ __forceinline__ unsigned window_starts() {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 32; i += W) m |= 1u << i;
  return m;
}

// One group of a level with windows of W > 1: t holds each lane's 8
// corner terms (zero for a lane with no query), `valid` whether it has one.
template <int W>
__device__ __forceinline__ void win_group(const FixedAcc& a, const Cell& c, float t[16],
                                          bool valid, size_t level0, int lane) {
  const unsigned long long key = c.corner0;  // the cell
  const uint32_t row = (uint32_t)(key >> 6);
  const uint32_t local = (uint32_t)(key - level0);
  const int lead = lane & ~(W - 1);  // the window's first lane
  const uint32_t lead_row = __shfl_sync(FULL_MASK, row, lead);
  const unsigned same = __ballot_sync(FULL_MASK, valid && row == lead_row);
  const unsigned window = ((1u << W) - 1u) << lead;
  const bool uniform = (same & window) == window;
  const unsigned long long prev = __shfl_up_sync(FULL_MASK, key, 1);
  const unsigned heads = __ballot_sync(FULL_MASK, !uniform || lane == lead || key != prev);
  if (heads == window_starts<W>()) {  // every window uniform, in one cell
    reduce_scatter<W>(t, lane);
    const int k0 = (lane - lead) * (8 / W);  // this lane's first corner
#pragma unroll
    for (int j = 0; j < 8 / W; ++j)
      add_pair(a, level0 + local + offset_of_corner(k0 + j), make_float2(t[2 * j], t[2 * j + 1]));
    return;
  }
  if (heads != FULL_MASK) {  // a cell's lanes in a uniform window: its last lane adds their sums
    run_sums16(t, heads, lane);
    const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (!last) {
#pragma unroll
      for (int j = 0; j < 16; ++j) t[j] = 0.f;
    }
  }
  scatter_octets(a, level0, local, t, lane);
}

// Warp task: level l over groups k0 ... k0 + per - 1 of the tile.
template <int W>
__device__ __forceinline__ void win_walk(const FixedAcc& a, const float* pts, const float2* gt,
                                         int stride, int n, int l, int k0, int per, uint32_t B,
                                         const Levels& lv, int lane) {
  const size_t level0 = (size_t)l * B * 64;  // the level's first float2
  for (int k = k0; k < k0 + per && 32 * k < n; ++k) {
    const int i = 32 * k + lane;
    const int s = min(i, n - 1);  // a lane past the end repeats the last query, with no term
    const float p[3] = {pts[3 * s], pts[3 * s + 1], pts[3 * s + 2]};
    const Cell c = locate(p, l, B, lv);
    const float2 gv = (i < n && !outside_unit_cube(p)) ? gt[s * stride + l] : make_float2(0.f, 0.f);
    check_finite(a, c.corner0, gv);
    float t[16];
    corner_terms(c, gv, t);
    if constexpr (W == 1) {
      scatter_octets(a, level0, (uint32_t)(c.corner0 - level0), t, lane);
    } else {
      win_group<W>(a, c, t, i < n, level0, lane);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
block_hash_win_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                          unsigned long long* __restrict__ sums, float* __restrict__ grad,
                          const unsigned* __restrict__ max_bits, long long Q, int L, uint32_t B,
                          const Levels lv, int split) {
  extern __shared__ float4 shared[];
  const int stride = tile_stride(L);
  float2* gt = reinterpret_cast<float2*>(shared);             // [TILE][stride] the tile's g
  float* pts = reinterpret_cast<float*>(gt + TILE * stride);  // [TILE][3] the tile's points
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, Q - q0);
  const FixedAcc a = fixed_acc(sums, grad, max_bits, Q);
  stage_tile(x, g, q0, n, L, stride, pts, gt);
  __syncthreads();

  const int per = GROUPS / split;  // groups per task
  for (int task = warp; task < L * split; task += WARPS) {
    const int l = task / split, k0 = (task % split) * per;
    switch (lv.runs[l]) {
      case 8:
        win_walk<8>(a, pts, gt, stride, n, l, k0, per, B, lv, lane);
        break;
      case 4:
        win_walk<4>(a, pts, gt, stride, n, l, k0, per, B, lv, lane);
        break;
      case 2:
        win_walk<2>(a, pts, gt, stride, n, l, k0, per, B, lv, lane);
        break;
      default:
        win_walk<1>(a, pts, gt, stride, n, l, k0, per, B, lv, lane);
    }
  }
}

// Plain C entry point, as block_hash_bwd's, plus `runs` [L] (host): each
// level's window size, 8, 4, 2 or 1. Returns the first CUDA error (0 on
// success).
extern "C" int block_hash_win_bwd(const float* x, const float* g, float* grad, void* scratch,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || (long long)B * 64 > 0xffffffffLL || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs) ||
      reinterpret_cast<uintptr_t>(grad) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    const int w = lv.runs[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (Q + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(L, 0);
  const cudaError_t err = allow_shared(block_hash_win_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int split = tile_split(L);
  const cudaStream_t s = (cudaStream_t)stream;
  return run_fixed(g, grad, scratch, Q, L, (uint32_t)B, s,
                   [&](unsigned long long* sums, const unsigned* max_bits) {
                     block_hash_win_bwd_kernel<<<(unsigned int)blocks, THREADS, smem, s>>>(
                         x, reinterpret_cast<const float2*>(g), sums, grad, max_bits, Q, L,
                         (uint32_t)B, lv, split);
                     return cudaGetLastError();
                   });
}
