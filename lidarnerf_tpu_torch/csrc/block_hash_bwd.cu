// Block-hash grid encoder, table gradient (backward), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_bwd_from_prep
// (B2; body _make_bwd_kernel). For each query q inside [0, 1]^3 and level l
// it finds the same cell and block row as the forward kernel
// (block_hash_common.cuh) and adds w * (g[q, 2l], g[q, 2l+1]) to each of the
// cell's 8 corner float2 pairs of the gradient table, w being the corner's
// trilinear weight. Duplicate rows are summed. The caller passes a zeroed
// [L*B, 128] float32 output. The plain PyTorch version of the same function
// is lidarnerf_tpu_torch/ops/block_hash.py::encode_bwd_plain.
//
// Bound: device memory. The function must read 12 bytes of position and
// 8*L bytes of feature gradient per query and write the 64 MiB gradient
// table once, at 3.35 TB/s; its arithmetic (some 80 flops per query-level)
// is far below the card's fp32 rate. Against that bound the design
//  - runs one thread per (query, level), level fastest, as the forward: a
//    warp reads g as 32 contiguous float2s, and its 32 threads write into
//    16 different level sub-tables, so a warp never collides with itself;
//  - recomputes the cell, block, hash and weights in registers instead of
//    reading the TPU kernel's [L, 4, Q] prep arrays;
//  - adds each of the 8 corner contributions with one float2 atomicAdd to
//    global memory (sm_90), so the scatter needs no sort and no scratch.
// The TPU kernel's devices (8 interleaved VMEM accumulator copies, an MXU
// one-hot matmul for the dense levels, the split-bf16 lane broadcast) have
// no place here. What this design leaves on the table: ray-coherent queries
// hit the same rows at the coarse levels, and same-address atomics
// serialise there; the seg and win variants (block_hash_seg_bwd.cu,
// block_hash_win_bwd.cu) sum a run's terms before the atomic. fp32 atomics
// add in an order that changes from run to run, so the result is not
// bitwise reproducible.

#include "block_hash_common.cuh"

__global__ void __launch_bounds__(THREADS)
block_hash_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                      float2* __restrict__ grad, long long n, int L, uint32_t B,
                      const Levels lv) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long q = t / L;
  const int l = (int)(t - q * L);

  float p[3];
  load_point(x, q, p);
  if (outside_unit_cube(p)) return;
  scatter_query(locate(p, l, B, lv), __ldg(g + t), grad);  // g[q, 2l : 2l+2], t = q * L + l
}

// Plain C entry point, as block_hash_fwd's. `grad` must hold L*B*128 zeros.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int block_hash_bwd(const float* x, const float* g, float* grad,
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
  block_hash_bwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, reinterpret_cast<const float2*>(g), reinterpret_cast<float2*>(grad), n, L,
      (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
