// Block-hash grid encoder, table gradient (backward), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_bwd_from_prep
// (B2; body _make_bwd_kernel). For each query q inside [0, 1]^3 and level l
// it finds the same cell and block row as the forward kernel
// (block_hash_common.cuh) and adds w * (g[q, 2l], g[q, 2l+1]) to each of the
// cell's 8 corner float2 pairs of the gradient table, w being the corner's
// trilinear weight. Duplicate rows are summed. The result is the [L*B, 128]
// float32 table gradient, bitwise the same from run to run (the JAX
// package's is: tests/test_determinism.py). The plain PyTorch version of the
// same function is lidarnerf_tpu_torch/ops/block_hash.py::encode_bwd_plain.
//
// Bound: device memory. The function must read 12 bytes of position and
// 8*L bytes of feature gradient per query and write the 64 MiB gradient
// table once, at 3.35 TB/s: 0.1515 ms for the main path's coarse call
// (Q = 3,145,728, L = 16). Its arithmetic (some 80 flops per query-level)
// is far below the card's fp32 rate. What keeps a kernel from that bound is
// atomics to one address: the L2 serialises them, and at levels 0-10 the
// consecutive samples of a ray share a row for 3-300 queries: with 8 corner
// atomics per (query, level), one thread each, a 300-query run at level 0
// would send 2,400 atomics to the same 8-20 addresses from some 150 warps.
// The design, in the tile layout of block_hash_common.cuh:
//  - stages the tile's points and g ([TILE, L] float2) in shared memory
//    with coalesced loads; warp w walks levels w, w + WARPS, ... (or a part
//    of the tile's groups when L < WARPS), each over the tile's 32-query
//    groups in order;
//  - per group, a shuffle and a ballot mark the lanes whose cell differs
//    from the previous lane's. If all 32 do (levels 11-15, and uniform
//    points), the group takes the plain path: each query's 8 corner terms,
//    added by octets (scatter_octets: lane k of an octet adds corner k of
//    the octet's queries, 8 lines per instruction instead of 32), with no
//    run finding;
//  - else, if each cell forms one run of lanes (__match_any_sync counts as
//    many distinct cells as runs; a query order without runs fails this and
//    takes the plain path, so the result holds for any order), the runs'
//    terms are summed in registers: one cell for the whole warp by a
//    reduce-scatter of its 16 terms (16 shuffles), several by a segmented
//    scan (16 shuffles per step, as many steps as the longest run needs);
//  - when the group lies in one row, the sums go into the warp's 64-float2
//    copy of that row in shared memory, which the warp carries to its next
//    group while the row stays the same, and adds to the table when the row
//    changes or the walk ends: a 300-query run at level 0 costs about one
//    row's adds per tile instead of 2,400. A group over several rows adds
//    its runs' sums by octets as the plain path;
//  - every sum leaves through the order-free fixed-point accumulator of
//    block_hash_scatter.cuh (an int64 atomic per nonzero float), so the
//    table is the same bit for bit from run to run, and a NaN or Inf in g
//    still gives a non-finite entry wherever the plain version has one.
// What the atomics still cost: the plain path's at the fine levels (about
// 3M x 5 levels x 16 int64 atomics per coarse call, to rows that rarely
// repeat), and one row flush per (tile, level) at the coarse ones; the
// accumulator adds a read of g, a zeroed 128 MiB scratch and a finish pass.
// The TPU kernel's devices (8 interleaved VMEM accumulator copies, an MXU
// one-hot matmul for the dense levels, the split-bf16 lane broadcast) have
// no place here.

#include "block_hash_common.cuh"
#include "block_hash_scatter.cuh"

__global__ void __launch_bounds__(THREADS)
block_hash_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                      unsigned long long* __restrict__ sums, float* __restrict__ grad,
                      const unsigned* __restrict__ max_bits, long long Q, int L, uint32_t B,
                      const Levels lv, int split) {
  extern __shared__ float4 shared[];
  const int stride = tile_stride(L);
  float2* rows = reinterpret_cast<float2*>(shared);           // [WARPS][64] carried row sums
  float2* gt = rows + WARPS * 64;                             // [TILE][stride] the tile's g
  float* pts = reinterpret_cast<float*>(gt + TILE * stride);  // [TILE][3] the tile's points
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, Q - q0);
  const FixedAcc a = fixed_acc(sums, grad, max_bits, Q);

  stage_tile(x, g, q0, n, L, stride, pts, gt);
  float2* acc = rows + warp * 64;
  reinterpret_cast<float4*>(acc)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int per = GROUPS / split;  // groups per task
  for (int task = warp; task < L * split; task += WARPS) {
    const int l = task / split, k0 = (task % split) * per;
    bool carrying = false;
    uint32_t carried = 0;  // the table row of acc while carrying
    for (int k = k0; k < k0 + per && 32 * k < n; ++k) {
      const int i = 32 * k + lane;
      const int s = min(i, n - 1);  // a lane past the end repeats the last query, with no term
      const float p[3] = {pts[3 * s], pts[3 * s + 1], pts[3 * s + 2]};
      const Cell c = locate(p, l, B, lv);
      const float2 gv = (i < n && !outside_unit_cube(p)) ? gt[s * stride + l] : make_float2(0.f, 0.f);
      check_finite(a, c.corner0, gv);
      float t[16];
      corner_terms(c, gv, t);

      const unsigned long long key = c.corner0;  // the cell
      const unsigned long long prev = __shfl_up_sync(FULL_MASK, key, 1);
      const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || key != prev);
      bool runs = heads != FULL_MASK;
      if (runs) {  // each cell one run of lanes?
        const unsigned same = __match_any_sync(FULL_MASK, key);
        runs = __popc(__ballot_sync(FULL_MASK, __ffs(same) - 1 == lane)) == __popc(heads);
      }
      const size_t level0 = (size_t)l * B * 64;  // the level's first float2
      const uint32_t local = (uint32_t)(c.corner0 - level0);
      if (!runs) {  // the plain path
        scatter_octets(a, level0, local, t, lane);
        continue;
      }

      const uint32_t row = (uint32_t)(c.corner0 >> 6);
      const uint32_t row0 = __shfl_sync(FULL_MASK, row, 0);
      const bool one_row = __all_sync(FULL_MASK, row == row0);
      if (one_row) {
        if (carrying && carried != row0) flush_row(a, acc, carried, lane);
        carrying = true;
        carried = row0;
      }
      const int off = (int)(c.corner0 & 63);
      if (heads == 1u) {  // one cell (so one row)
        reduce_scatter<32>(t, lane);
        if (!(lane & 1)) {
          const int m2 = lane >> 1, k2 = m2 >> 1;  // term m2: corner k2, channel m2 & 1
          const int slot = off + offset_of_corner(k2);
          reinterpret_cast<float*>(acc)[2 * slot + (m2 & 1)] += t[0];
        }
        __syncwarp();
        continue;
      }
      run_sums16(t, heads, lane);
      const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
      if (!one_row) {  // each run's last lane adds the run's sums
        if (!last) {
#pragma unroll
          for (int j = 0; j < 16; ++j) t[j] = 0.f;
        }
        scatter_octets(a, level0, local, t, lane);
        continue;
      }
      // the runs' cells are distinct cells of one row: in each round the
      // last lanes add to distinct float2s
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) {
        if (last) {
          float2& r = acc[off + offset_of_corner(k2)];
          r.x += t[2 * k2];
          r.y += t[2 * k2 + 1];
        }
        __syncwarp();
      }
    }
    if (carrying) flush_row(a, acc, carried, lane);
  }
}

// Plain C entry point, as block_hash_fwd's, plus `scratch`: a 16-byte
// aligned buffer of fixed_scratch_bytes(L, B) bytes for the accumulator.
// `grad` ([L*B, 128] float32) must be 16-byte aligned; the call zeroes it
// and the scratch first, on `stream`. A level's B * 64 float2s must be
// indexable in 32 bits. Returns the first CUDA error of the set-up or the
// launches (0 on success).
extern "C" int block_hash_bwd(const float* x, const float* g, float* grad, void* scratch,
                              long long Q, int L, int B, const float* scale,
                              const int* max_cell, const int* blocks_axis,
                              const int* dense, void* stream) {
  Levels lv;
  if (B < 1 || (long long)B * 64 > 0xffffffffLL || Q < 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense) ||
      reinterpret_cast<uintptr_t>(grad) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (Q + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(L, 1);
  const cudaError_t err = allow_shared(block_hash_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int split = tile_split(L);
  const cudaStream_t s = (cudaStream_t)stream;
  return run_fixed(g, grad, scratch, Q, L, (uint32_t)B, s,
                   [&](unsigned long long* sums, const unsigned* max_bits) {
                     block_hash_bwd_kernel<<<(unsigned int)blocks, THREADS, smem, s>>>(
                         x, reinterpret_cast<const float2*>(g), sums, grad, max_bits, Q, L,
                         (uint32_t)B, lv, split);
                     return cudaGetLastError();
                   });
}
