// Run finding shared by the segmented block-hash kernels, forward B3a
// (block_hash_seg_fwd.cu) and backward B3b (block_hash_seg_bwd.cu).
//
// Both run one thread block per (level, 4096-query chunk), blockIdx.x =
// chunk * L + level, so the L blocks of a chunk are scheduled together and
// their strided feature stores (or gradient reads) meet in L2. A block
// computes its chunk's block rows itself, into shared memory, and marks a
// run wherever the row changes: the counterpart of the TPU kernels'
// XLA-side prep `seg_next` (block_hash_pallas.py:446), whose [L*Qp] rows,
// next and nseg arrays never go through device memory here. The plain
// PyTorch version of the same run structure is
// lidarnerf_tpu_torch/ops/block_hash.py::seg_next.
#pragma once

#include "block_hash_common.cuh"

#define MAX_RUNS (CHUNK / NSEG_DIV)  // a chunk with more runs takes the per-query path

struct SegScratch {
  uint32_t rows[CHUNK];     // the chunk's table rows at this level
  int starts[MAX_RUNS + 1];  // run s is [starts[s], starts[s + 1])
  int warp_count[WARPS];
};

// Finds the runs of equal consecutive rows among the chunk's n queries
// (chunk0 ... chunk0 + n - 1) at level l. Every thread of the block calls it
// and gets the same answer: the number of runs, with their starts in
// sc.starts and their rows in sc.rows[start], or -1 when the chunk has more
// than MAX_RUNS runs (block_hash_pallas.py:522,542: the per-chunk fallback).
__device__ __forceinline__ int find_runs(const float* __restrict__ x, long long chunk0, int n,
                                         int l, uint32_t B, const Levels& lv, SegScratch& sc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += THREADS) {
    float p[3];
    load_point(x, chunk0 + i, p);
    sc.rows[i] = (uint32_t)(locate(p, l, B, lv).corner0 >> 6);
  }
  __syncthreads();

  // warp w counts the run starts among queries [w * 512, (w + 1) * 512)
  constexpr int PER_WARP = CHUNK / WARPS;
  const int i0 = warp * PER_WARP;
  int count = 0;
  for (int k = 0; k < PER_WARP; k += 32) {
    const int i = i0 + k + lane;
    const bool start = i < n && (i == 0 || sc.rows[i] != sc.rows[i - 1]);
    count += __popc(__ballot_sync(FULL_MASK, start));
  }
  if (lane == 0) sc.warp_count[warp] = count;
  __syncthreads();
  int nseg = 0, base = 0;
  for (int w = 0; w < WARPS; ++w) {
    base += w < warp ? sc.warp_count[w] : 0;
    nseg += sc.warp_count[w];
  }
  if (nseg > MAX_RUNS) return -1;

  // second pass: each start goes to its rank among the chunk's starts
  for (int k = 0; k < PER_WARP; k += 32) {
    const int i = i0 + k + lane;
    const bool start = i < n && (i == 0 || sc.rows[i] != sc.rows[i - 1]);
    const unsigned ballot = __ballot_sync(FULL_MASK, start);
    if (start) sc.starts[base + __popc(ballot & ((1u << lane) - 1u))] = i;
    base += __popc(ballot);
  }
  if (tid == 0) sc.starts[nseg] = n;
  __syncthreads();
  return nseg;
}
