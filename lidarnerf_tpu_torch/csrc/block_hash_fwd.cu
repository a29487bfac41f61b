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
// 64 MiB table), at 3.35 TB/s; its arithmetic (some 60 flops per query-level)
// is far below the card's fp32 rate. Against that bound the design
//  - runs one thread per (query, level) with the level fastest, so at L = 16
//    a warp covers 2 queries and its feature stores are one contiguous
//    256-byte run;
//  - computes the cell, block index, hash and weights in registers
//    (block_hash_common.cuh, shared with B2-B4), so none of the TPU
//    kernel's [L, 4, Q] prep arrays go through memory;
//  - reads only the 8 corner float2 pairs it needs (64 bytes) instead of the
//    whole 512-byte row. Consecutive queries along a ray fall in the same
//    block at the coarse levels, so those reads mostly hit L1/L2.

#include "block_hash_common.cuh"

__global__ void __launch_bounds__(THREADS)
block_hash_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                      float2* __restrict__ out, long long n, int L, uint32_t B,
                      const Levels lv) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long q = t / L;
  const int l = (int)(t - q * L);

  float p[3];
  load_point(x, q, p);
  const float2 acc = encode_query(p, l, B, lv, reinterpret_cast<const float2*>(table));
  out[t] = acc;  // out[q, 2l : 2l+2], t = q * L + l
}

// Plain C entry point: per-level parameters come as host arrays and travel
// by value in the kernel's arguments. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int block_hash_fwd(const float* x, const float* table, float* out,
                              long long Q, int L, int B, const float* scale,
                              const int* max_cell, const int* blocks_axis,
                              const int* dense, void* stream) {
  Levels lv;
  if (B < 1 || Q < 0 || !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense))
    return (int)cudaErrorInvalidValue;
  const long long n = Q * L;
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_hash_fwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, table, reinterpret_cast<float2*>(out), n, L, (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
