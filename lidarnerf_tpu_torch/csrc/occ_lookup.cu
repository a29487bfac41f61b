// Occupancy bin lookup for Hopper (sm_90a): out[q] = grid[idx[q]].
//
// Replaces the TPU kernel tools/exp_occ_lookup.py::lookup_pallas (P12, body
// `kernel`), the `--fast` sampler's [4096, 128] take of bin cells from the
// 128^3 occupied volume (lidarnerf_tpu_torch/models/occupancy.py::occ_bin_pdf).
// The TPU kernel fetches the 128-lane row idx >> 7 into vector registers and
// extracts lane idx & 127 with masked vector ops; a GPU thread reads the one
// word it needs, so the row/lane split has no counterpart here. The plain
// PyTorch version of the same function is
// lidarnerf_tpu_torch/ops/occ_lookup.py::occ_lookup_plain, with jnp.take's
// semantics: an index in [-n, 0) wraps to i + n, any other index outside
// [0, n) gives NaN and reads nothing. Values are copied as they are, so the
// result is bit-exact.
//
// Bound: device memory, and at the tool's and the step's R = 524,288 the
// launch. The function reads 4 B of index and writes 4 B of value per
// lookup, and reads each distinct 32-byte sector of the grid it touches
// once; there is no arithmetic. The design keeps every one of those accesses
// as cheap as the card allows:
//  - a grid-stride loop over the lookups;
//  - four indices per thread in one 16-byte int4 load and four values in one
//    float4 store where the index and output pointers are 16-byte aligned
//    (the wrapper's output always is; a view of the index at an odd offset
//    takes the scalar loop), so a warp moves 512 contiguous bytes each way;
//    a scalar loop takes the last R mod 4;
//  - the grid read through the read-only path (__ldg). The 8 MiB volume
//    fits the H100's 50 MB L2, and the bins of one ray fall in neighbouring
//    cells, so most reads hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_BLOCKS (132 * 16)  // 16 blocks of 256 threads on each of the 132 SMs

__device__ __forceinline__ float lookup(const float* __restrict__ grid, int i, int n) {
  const int j = i + n * (i < 0);  // [-n, 0) wraps as jnp.take does
  return (unsigned)j < (unsigned)n ? __ldg(grid + j) : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(THREADS)
occ_lookup_kernel(const int* __restrict__ idx, const float* __restrict__ grid,
                  float* __restrict__ out, long long R, int n, int vec) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long R4 = R >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long k = t; k < R4; k += stride) {
      const int4 i = idx4[k];
      out4[k] = make_float4(lookup(grid, i.x, n), lookup(grid, i.y, n), lookup(grid, i.z, n),
                            lookup(grid, i.w, n));
    }
    done = R4 << 2;
  }
  for (long long k = done + t; k < R; k += stride) out[k] = lookup(grid, idx[k], n);
}

// Plain C entry point. idx [R] int32, grid [n] float32 and out [R] float32,
// contiguous on the current device. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a size it does not take.
extern "C" int occ_lookup(const int* idx, const float* grid, float* out, long long R, long long n,
                          void* stream) {
  if (R < 0 || n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int vec = ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vec ? (R >> 2) + (R & 3) : R;
  const long long blocks = (work + THREADS - 1) / THREADS;
  occ_lookup_kernel<<<(unsigned int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS), THREADS, 0,
                      (cudaStream_t)stream>>>(idx, grid, out, R, (int)n, vec);
  return (int)cudaGetLastError();
}
