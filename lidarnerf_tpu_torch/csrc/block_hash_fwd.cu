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
//  - computes the cell, block index, hash and weights in registers, so none
//    of the TPU kernel's [L, 4, Q] prep arrays go through memory;
//  - reads only the 8 corner float2 pairs it needs (64 bytes) instead of the
//    whole 512-byte row. Consecutive queries along a ray fall in the same
//    block at the coarse levels, so those reads mostly hit L1/L2.
// The position scale and the cell offset use __fmul_rn/__fadd_rn so the cell
// choice rounds exactly like the plain version's separate multiply and add.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32
#define THREADS 256

struct Levels {
  float scale[MAX_LEVELS];
  int max_cell[MAX_LEVELS];
  int blocks_axis[MAX_LEVELS];
  int dense[MAX_LEVELS];
};

__global__ void __launch_bounds__(THREADS)
block_hash_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                      float2* __restrict__ out, long long n, int L, uint32_t B,
                      const Levels lv) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long q = t / L;
  const int l = (int)(t - q * L);

  const float p[3] = {__ldg(x + 3 * q), __ldg(x + 3 * q + 1), __ldg(x + 3 * q + 2)};
  float2 acc = make_float2(0.f, 0.f);
  const bool outside = p[0] < 0.f || p[0] > 1.f || p[1] < 0.f || p[1] > 1.f ||
                       p[2] < 0.f || p[2] > 1.f;
  if (!outside) {
    const float s = lv.scale[l];
    const int max_cell = lv.max_cell[l];
    int blk[3], loc[3];
    float frac[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = __fadd_rn(__fmul_rn(p[a], s), 0.5f);
      const float cell = floorf(pos);
      frac[a] = pos - cell;
      const int c = min(max((int)cell, 0), max_cell);
      blk[a] = c / 3;
      loc[a] = c - 3 * blk[a];
    }
    uint32_t idx;
    if (lv.dense[l]) {
      const int nb = lv.blocks_axis[l];
      idx = (uint32_t)((blk[0] * nb + blk[1]) * nb + blk[2]);
    } else {
      idx = (uint32_t)blk[0] ^ ((uint32_t)blk[1] * 2654435761u) ^
            ((uint32_t)blk[2] * 805459861u);
    }
    idx %= B;
    const float2* row =
        reinterpret_cast<const float2*>(table) + ((size_t)l * B + idx) * 64;

    const float wx[2] = {1.f - frac[0], frac[0]};
    const float wy[2] = {1.f - frac[1], frac[1]};
    const float wz[2] = {1.f - frac[2], frac[2]};
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wxy = __fmul_rn(wx[dx], wy[dy]);
        const int base = ((loc[0] + dx) * 4 + loc[1] + dy) * 4 + loc[2];
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const float w = __fmul_rn(wxy, wz[dz]);
          const float2 v = __ldg(row + base + dz);
          acc.x += w * v.x;
          acc.y += w * v.y;
        }
      }
    }
  }
  out[t] = acc;  // out[q, 2l : 2l+2], t = q * L + l
}

// Plain C entry point: per-level parameters come as host arrays and travel
// by value in the kernel's arguments. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int block_hash_fwd(const float* x, const float* table, float* out,
                              long long Q, int L, int B, const float* scale,
                              const int* max_cell, const int* blocks_axis,
                              const int* dense, void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 1 || Q < 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.scale[l] = scale[l];
    lv.max_cell[l] = max_cell[l];
    lv.blocks_axis[l] = blocks_axis[l];
    lv.dense[l] = dense[l];
  }
  const long long n = Q * L;
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_hash_fwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, table, reinterpret_cast<float2*>(out), n, L, (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
