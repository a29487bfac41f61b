// Block-hash grid encoder, table gradient by uniform windows (B4b), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_bwd_win_from_prep
// (B4b). It computes B2's function (block_hash_bwd.cu): for each query
// inside [0, 1]^3 and level l, w * (g[q, 2l], g[q, 2l+1]) added to each of
// the cell's 8 corner float2s, w the corner's trilinear weight, duplicates
// summed, into a zeroed [L*B, 128] float32 table. Level l cuts the query
// stream into fixed windows of W = 8, 4, 2 or 1 consecutive queries (the
// host's `runs` array, block_hash.py::win_of_level); a window whose W
// queries share one block row sums its terms first and adds them with one
// atomic per touched corner float2 of the row, where B2 issues 8 per query.
// The plain PyTorch version with the same window rules is
// lidarnerf_tpu_torch/ops/block_hash.py::encode_bwd_win_plain.
//
// Bound: the same as B2's, device memory. The function must read 12 bytes
// of position and 8*L bytes of feature gradient per query and write the
// 64 MiB gradient table once, at 3.35 TB/s; its ~80 flops per query-level
// are far below the fp32 rate. What B2 loses against it is same-address
// atomics on the coarse levels' long runs. The design:
//  - one thread block per (level, 4096-query chunk), level fastest, one
//    thread per query, so a window is W neighbouring lanes of a warp;
//  - the window's flag is computed in registers (a shuffle of the first
//    lane's row and a ballot), not read from a [L*Qp] flag array;
//  - in a uniform window lane r owns the row's corner float2s r, r + W, ...
//    (64 / W of them, in registers); the W queries pass through the window
//    by shuffles, each lane adds their terms at the float2s it owns, then
//    adds its nonzero sums to the table: at most 64 atomics per window;
//  - any other window, and every W = 1 level, takes the per-query path of
//    B2's design before its tile layout (scatter_query: 8 float2
//    atomicAdds).
// The TPU kernel's devices (SMEM flag streams, tile reductions, 8 VMEM
// accumulator copies, the MXU one-hot scatter of the dense pair) have no
// place here. fp32 atomics add in an order that changes from run to run, so
// the result is not bitwise reproducible.

#include "block_hash_common.cuh"

template <int W>
__device__ __forceinline__ void win_bwd_chunk(const float* __restrict__ x,
                                              const float2* __restrict__ g,
                                              float2* __restrict__ grad, long long chunk0, int n,
                                              int L, int l, uint32_t B, const Levels& lv) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int lead = lane & ~(W - 1), r = lane - lead;
  const unsigned window_mask = ((1u << W) - 1u) << lead;
  // every thread runs the same number of rounds (see block_hash_win_fwd.cu)
  for (int i0 = 0; i0 < n; i0 += THREADS) {
    const bool valid = i0 + tid < n;
    const long long q = chunk0 + i0 + tid;
    float p[3] = {0.f, 0.f, 0.f};
    if (valid) load_point(x, q, p);
    const bool inside = valid && !outside_unit_cube(p);
    const Cell c = locate(p, l, B, lv);
    const uint32_t row = (uint32_t)(c.corner0 >> 6);
    const uint32_t lead_row = __shfl_sync(FULL_MASK, row, lead);
    const unsigned same = __ballot_sync(FULL_MASK, valid && row == lead_row);
    if ((same & window_mask) == window_mask) {
      const Term t = make_term(c, inside, g, q, L, l);
      float2 acc[64 / W];
#pragma unroll
      for (int k = 0; k < 64 / W; ++k) acc[k] = make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const Term tu = shfl_term(window_mask, t, lead + u);
#pragma unroll
        for (int k = 0; k < 64 / W; ++k) add_corner_term(acc[k], r + k * W, tu);
      }
      float2* row_grad = grad + (size_t)row * 64;
#pragma unroll
      for (int k = 0; k < 64 / W; ++k) flush_corner(row_grad, r + k * W, acc[k]);
    } else if (inside) {
      scatter_query(c, __ldg(g + q * L + l), grad);  // the per-query path
    }
  }
}

__global__ void __launch_bounds__(THREADS)
block_hash_win_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                          float2* __restrict__ grad, long long Q, int L, uint32_t B,
                          const Levels lv) {
  const int l = (int)(blockIdx.x % L);
  const long long chunk0 = (long long)(blockIdx.x / L) * CHUNK;
  const int n = (int)min((long long)CHUNK, Q - chunk0);
  switch (lv.runs[l]) {
    case 8:
      win_bwd_chunk<8>(x, g, grad, chunk0, n, L, l, B, lv);
      break;
    case 4:
      win_bwd_chunk<4>(x, g, grad, chunk0, n, L, l, B, lv);
      break;
    case 2:
      win_bwd_chunk<2>(x, g, grad, chunk0, n, L, l, B, lv);
      break;
    default:  // w = 1: the per-query path
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const long long q = chunk0 + i;
        float p[3];
        load_point(x, q, p);
        if (!outside_unit_cube(p)) scatter_query(locate(p, l, B, lv), __ldg(g + q * L + l), grad);
      }
  }
}

// Plain C entry point, as block_hash_bwd's, plus `runs` [L] (host): each
// level's window size, 8, 4, 2 or 1. `grad` must hold L*B*128 zeros.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int block_hash_win_bwd(const float* x, const float* g, float* grad,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    const int w = lv.runs[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
  }
  if (Q == 0) return 0;
  const long long blocks = (Q + CHUNK - 1) / CHUNK * L;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_hash_win_bwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, reinterpret_cast<const float2*>(g), reinterpret_cast<float2*>(grad), Q, L,
      (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
