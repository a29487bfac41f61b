// Block-hash grid encoder, table gradient by runs of equal rows (B3b), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_bwd_seg_from_prep
// (B3b). It computes B2's function (block_hash_bwd.cu): for each query
// inside [0, 1]^3 and level l, w * (g[q, 2l], g[q, 2l+1]) added to each of
// the cell's 8 corner float2s, w the corner's trilinear weight, duplicates
// summed, into the [L*B, 128] float32 table gradient. On a level of scale
// <= SEG_SCALE_MAX (the host's `runs` array) a run of equal consecutive
// rows sums its terms first and adds its row once, where B2's plain path
// adds 8 corners per query. The plain PyTorch version with the TPU kernel's
// run rules is lidarnerf_tpu_torch/ops/block_hash.py::encode_bwd_seg_plain.
//
// Bound: the same as B2's, device memory. The function must read 12 bytes
// of position and 8*L bytes of feature gradient per query and write the
// 64 MiB gradient table once, at 3.35 TB/s: 0.1515 ms for the main path's
// coarse call; its ~80 flops per query-level are far below the fp32 rate.
// What a kernel loses against it is where the lanes of a warp go (with one
// thread per (level, query), every load of g[q * L + l] lies 128 bytes from
// its lane neighbour's) and the count of the accumulator's int64 atomics.
// The design keeps the TPU kernel's mechanism, one set of adds per run, in
// B2's tile layout (block_hash_common.cuh):
//  - a block owns a tile of TILE consecutive queries whose points and g are
//    staged in shared memory with coalesced loads; warp w walks levels w,
//    w + WARPS, ... (or a part of the tile's groups when L < WARPS) over
//    the tile's 32-query groups in order;
//  - on a run level, a shuffle and a ballot find the group's runs of equal
//    rows and its runs of equal cells; each cell's 16 terms are summed in
//    registers (a reduce-scatter for one cell in the whole group, else a
//    segmented scan) and its last lane adds them into its run's 64-float2
//    row sums in shared memory. The warp keeps a ring of SEG_SLOTS such row
//    sums: a run that ends inside the group adds its row to the table at
//    once, the run open at the group's end is carried to the next group,
//    so a 300-query run at level 0 adds its row once per tile, not once per
//    group. Runs never cross a tile, hence never a 4096-query chunk;
//  - a group of more than SEG_SLOTS runs (the TPU kernel's choice between
//    its two paths, here made per group), or whose cells do not each form
//    one run of lanes, and every other level take B2's octet scatter, of
//    each cell's run sums where the cells form runs, else of each query's
//    8 corners;
//  - every add goes through the order-free fixed-point accumulator of
//    block_hash_scatter.cuh, so the table is the same bit for bit from run
//    to run, and a NaN or Inf in g gives the plain version's non-finite
//    entries.
// A wider ring sends fewer groups to the octet scatter (its 64 KiB at 16
// slots leaves 2 blocks an SM); with it the coarse levels cost less than
// B2's, which carries one row. What still holds it back is B2's: the fine
// levels' octet scatter (16 int64 atomics per query-level to rows that
// rarely repeat) and the accumulator's passes (a read of g, a zeroed
// 128 MiB scratch, the finish).
// The TPU kernel's devices (SMEM scalar streams, 8 VMEM accumulator copies,
// the MXU one-hot scatter of the dense pair, the split-bf16 lane broadcast)
// have no place here.

#include "block_hash_common.cuh"
#include "block_hash_scatter.cuh"

#ifndef SEG_SLOTS
#define SEG_SLOTS 16  // row sums a warp carries in shared memory (a power of 2; 16 timed best of 2-32)
#endif

__global__ void __launch_bounds__(THREADS)
block_hash_seg_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                          unsigned long long* __restrict__ sums, float* __restrict__ grad,
                          const unsigned* __restrict__ max_bits, long long Q, int L, uint32_t B,
                          const Levels lv, int split) {
  extern __shared__ float4 shared[];
  const int stride = tile_stride(L);
  float2* rows = reinterpret_cast<float2*>(shared);           // [WARPS][SEG_SLOTS][64] row sums
  float2* gt = rows + WARPS * SEG_SLOTS * 64;                 // [TILE][stride] the tile's g
  float* pts = reinterpret_cast<float*>(gt + TILE * stride);  // [TILE][3] the tile's points
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, Q - q0);
  const FixedAcc a = fixed_acc(sums, grad, max_bits, Q);

  stage_tile(x, g, q0, n, L, stride, pts, gt);
  float2* ring = rows + warp * SEG_SLOTS * 64;
  for (int j = lane; j < SEG_SLOTS * 32; j += 32)
    reinterpret_cast<float4*>(ring)[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int per = GROUPS / split;  // groups per task
  for (int task = warp; task < L * split; task += WARPS) {
    const int l = task / split, k0 = (task % split) * per;
    const size_t level0 = (size_t)l * B * 64;  // the level's first float2
    // Only slot `last` may hold sums when a group starts: those of the run
    // of table row `carried` that was open at the previous group's end.
    uint32_t carried = NO_ROW;
    int last = SEG_SLOTS - 1;
    for (int k = k0; k < k0 + per && 32 * k < n; ++k) {
      const int i = 32 * k + lane;
      const int s = min(i, n - 1);  // a lane past the end repeats the last query, with no term
      const float p[3] = {pts[3 * s], pts[3 * s + 1], pts[3 * s + 2]};
      const Cell c = locate(p, l, B, lv);
      const float2 gv = (i < n && !outside_unit_cube(p)) ? gt[s * stride + l] : make_float2(0.f, 0.f);
      check_finite(a, c.corner0, gv);
      float t[16];
      corner_terms(c, gv, t);
      const uint32_t local = (uint32_t)(c.corner0 - level0);
      if (!lv.runs[l]) {
        scatter_octets(a, level0, local, t, lane);
        continue;
      }

      const unsigned long long key = c.corner0;  // the cell
      const uint32_t row = (uint32_t)(key >> 6);  // the table row
      const unsigned long long prev_key = __shfl_up_sync(FULL_MASK, key, 1);
      const uint32_t prev_row = __shfl_up_sync(FULL_MASK, row, 1);
      const unsigned cell_heads = __ballot_sync(FULL_MASK, lane == 0 || key != prev_key);
      const unsigned row_heads = __ballot_sync(FULL_MASK, lane == 0 || row != prev_row);
      bool cell_runs = cell_heads != FULL_MASK;
      if (cell_runs && cell_heads != 1u) {  // each cell one run of lanes?
        const unsigned same = __match_any_sync(FULL_MASK, key);
        cell_runs = __popc(__ballot_sync(FULL_MASK, __ffs(same) - 1 == lane)) == __popc(cell_heads);
      }
      const bool last_of_cell = lane == 31 || ((cell_heads >> (lane + 1)) & 1u);
      const int nruns = __popc(row_heads);
      if (!cell_runs || nruns > SEG_SLOTS) {  // B2's octet scatter
        if (cell_runs) {  // of each cell's sums, from its last lane
          run_sums16(t, cell_heads, lane);
          if (!last_of_cell) {
#pragma unroll
            for (int j = 0; j < 16; ++j) t[j] = 0.f;
          }
        }
        scatter_octets(a, level0, local, t, lane);
        continue;
      }

      // run u of the group sums into slot (first + u) % SEG_SLOTS; a first
      // run that goes on from the previous group finds its sums in `last`
      const bool goes_on = __shfl_sync(FULL_MASK, row, 0) == carried;
      if (!goes_on && carried != NO_ROW) flush_row(a, ring + last * 64, carried, lane);
      const int first = goes_on ? last : (last + 1) & (SEG_SLOTS - 1);
      const int run = __popc(row_heads & (FULL_MASK >> (31 - lane))) - 1;
      float2* acc = ring + ((first + run) & (SEG_SLOTS - 1)) * 64;
      const int off = (int)(c.corner0 & 63);
      if (cell_heads == 1u) {  // one cell (so one run)
        reduce_scatter<32>(t, lane);
        if (!(lane & 1)) {
          const int m2 = lane >> 1, k2 = m2 >> 1;  // term m2: corner k2, channel m2 & 1
          reinterpret_cast<float*>(acc)[2 * (off + offset_of_corner(k2)) + (m2 & 1)] += t[0];
        }
      } else {
        run_sums16(t, cell_heads, lane);
        // the cells of a run are distinct cells of its row: in each round
        // the last lanes of one run add to distinct float2s
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2) {
          if (last_of_cell) {
            float2& r = acc[off + offset_of_corner(k2)];
            r.x += t[2 * k2];
            r.y += t[2 * k2 + 1];
          }
          __syncwarp();
        }
      }
      // the runs that ended inside the group add their rows; the last stays open
      unsigned ended = row_heads;
      for (int u = 0; u < nruns - 1; ++u, ended &= ended - 1) {
        const uint32_t r = __shfl_sync(FULL_MASK, row, __ffs(ended) - 1);
        flush_row(a, ring + ((first + u) & (SEG_SLOTS - 1)) * 64, r, lane);
      }
      last = (first + nruns - 1) & (SEG_SLOTS - 1);
      carried = __shfl_sync(FULL_MASK, row, 31);
      __syncwarp();
    }
    if (carried != NO_ROW) flush_row(a, ring + last * 64, carried, lane);
  }
}

// Plain C entry point, as block_hash_bwd's, plus `runs` [L] (host): 1 where
// the level walks runs. Returns the first CUDA error (0 on success).
extern "C" int block_hash_seg_bwd(const float* x, const float* g, float* grad, void* scratch,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || (long long)B * 64 > 0xffffffffLL || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs) ||
      reinterpret_cast<uintptr_t>(grad) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (Q + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(L, SEG_SLOTS);
  const cudaError_t err = allow_shared(block_hash_seg_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int split = tile_split(L);
  const cudaStream_t s = (cudaStream_t)stream;
  return run_fixed(g, grad, scratch, Q, L, (uint32_t)B, s,
                   [&](unsigned long long* sums, const unsigned* max_bits) {
                     block_hash_seg_bwd_kernel<<<(unsigned int)blocks, THREADS, smem, s>>>(
                         x, reinterpret_cast<const float2*>(g), sums, grad, max_bits, Q, L,
                         (uint32_t)B, lv, split);
                     return cudaGetLastError();
                   });
}
