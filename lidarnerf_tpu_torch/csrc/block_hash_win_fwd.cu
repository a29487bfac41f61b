// Block-hash grid encoder, forward by uniform windows (B4a), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_fwd_win_from_prep
// (B4a), with its XLA-side prep (_prep_inputs, pack_win_flags) fused in. It
// computes B1's function (block_hash_fwd.cu): per query and level, the
// trilinear interpolation of the cell's 8 corners inside one 128-float
// block row, zero outside [0, 1]^3. Level l cuts the query stream into
// fixed windows of w = 8, 4, 2 or 1 consecutive queries (the host's `runs`
// array, block_hash.py::win_of_level); a window whose w queries share one
// block row ("uniform", pack_win_flags' bit for w) loads that row once. Its
// output equals B1's bit for bit (the same cell, weights and fma order,
// from block_hash_common.cuh). The plain PyTorch version of the same
// function is lidarnerf_tpu_torch/ops/block_hash.py::encode_plain.
//
// Bound: the same as B1's, device memory. The function must read 12 bytes
// of position and write 8*L bytes of features per query, plus the table
// rows it touches, at 3.35 TB/s; its ~60 flops per query-level are far below
// the fp32 rate. The design:
//  - one thread block per (level, 4096-query chunk), level fastest, one
//    thread per query, so a window is w neighbouring lanes of a warp;
//  - the window's flag is computed in registers, not read from a [L*Qp]
//    flag array: each lane computes its row, the window's first lane's row
//    is shuffled to the others, and a ballot says whether all w agree;
//  - a uniform window's w lanes load its 512-byte row together, coalesced
//    float4s, into a 512-byte shared-memory slot of the window, and each
//    lane interpolates its query from there;
//  - any other window, and every w = 1 level, takes the per-query path of
//    B1's design before its tile layout (encode_query: 8 corner float2
//    reads from the table).
// Shared memory: THREADS / w_min slots of 512 bytes, w_min the smallest
// window above 1 among the levels (64 KiB at w = 2). The TPU kernel's
// devices (SMEM flag streams, broadcast tile stores, the split-bf16 MXU
// lane reduction) have no place here.

#include "block_hash_common.cuh"

__global__ void __launch_bounds__(THREADS)
block_hash_win_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                          float2* __restrict__ out, long long Q, int L, uint32_t B,
                          const Levels lv) {
  extern __shared__ float4 window_rows[];  // [THREADS / w_min][32]
  const int l = (int)(blockIdx.x % L);
  const long long chunk0 = (long long)(blockIdx.x / L) * CHUNK;
  const int n = (int)min((long long)CHUNK, Q - chunk0);
  const int w = lv.runs[l];
  const int tid = threadIdx.x, lane = tid & 31;
  const int lead = lane & ~(w - 1);  // the window's first lane
  const unsigned window_mask = ((1u << w) - 1u) << lead;
  const float2* table2 = reinterpret_cast<const float2*>(table);
  const float4* table4 = reinterpret_cast<const float4*>(table);

  // every thread runs the same number of rounds, so the warp-wide shuffle
  // and ballot see all 32 lanes; a lane past the chunk's end has no query
  for (int i0 = 0; i0 < n; i0 += THREADS) {
    const bool valid = i0 + tid < n;
    const long long q = chunk0 + i0 + tid;
    float p[3] = {0.f, 0.f, 0.f};
    if (valid) load_point(x, q, p);
    if (w > 1) {
      const Cell c = locate(p, l, B, lv);
      const uint32_t row = (uint32_t)(c.corner0 >> 6);
      const uint32_t lead_row = __shfl_sync(FULL_MASK, row, lead);
      const unsigned same = __ballot_sync(FULL_MASK, valid && row == lead_row);
      if ((same & window_mask) == window_mask) {
        float4* slot = window_rows + (tid / w) * 32;
        for (int k = lane - lead; k < 32; k += w) slot[k] = __ldg(table4 + (size_t)row * 32 + k);
        __syncwarp(window_mask);
        const float2* corners = reinterpret_cast<const float2*>(slot);
        const int off = (int)(c.corner0 & 63);
        out[q * L + l] = outside_unit_cube(p)
                             ? make_float2(0.f, 0.f)
                             : trilerp(c, [&](int k) { return corners[off + k]; });
        __syncwarp(window_mask);  // the slot is read before the next round refills it
        continue;
      }
    }
    if (valid) out[q * L + l] = encode_query(p, l, B, lv, table2);  // the per-query path
  }
}

// Plain C entry point, as block_hash_fwd's, plus `runs` [L] (host): each
// level's window size, 8, 4, 2 or 1. The table must be 16-byte aligned.
// Returns the first CUDA error of the set-up or the launch (0 on success).
extern "C" int block_hash_win_fwd(const float* x, const float* table, float* out,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs))
    return (int)cudaErrorInvalidValue;
  int w_min = 0;
  for (int l = 0; l < L; ++l) {
    const int w = lv.runs[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    if (w > 1 && (w_min == 0 || w < w_min)) w_min = w;
  }
  if (Q == 0) return 0;
  const long long blocks = (Q + CHUNK - 1) / CHUNK * L;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = w_min ? THREADS / w_min * 512 : 0;
  cudaError_t err = cudaFuncSetAttribute(block_hash_win_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  block_hash_win_fwd_kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, table, reinterpret_cast<float2*>(out), Q, L, (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
