// Per-ray permutation gather and its transpose, for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/perm_gather_pallas.py::_apply
// (B6, body _kernel), the sort-merge reorder of [N, S, C] per-sample rows:
//   forward   (transpose = 0): out[n, inv[n, i], :] = vals[n, i, :]
//             (= vals[n, order[n, j], :] with inv = argsort(order))
//   backward  (transpose = 1): out[n, i, :] = g[n, inv[n, i], :]
// both from inv_order alone. The TPU kernel moves each float32 through the
// bf16 MXU as four 8-bit planes of a one-hot matmul; here the 4-byte words
// are moved as they are (as unsigned ints), so the result is bit-exact by
// construction. The plain PyTorch versions of the same functions are
// lidarnerf_tpu_torch/ops/perm_gather.py::scatter_by_inverse and
// ::gather_by_inverse.
//
// Bound: device memory. The function reads N*S*C words and the N*S indices
// once and writes N*S*C words once: at the training chunk's [4096, 832, 17]
// that is 477 MB, 0.142 ms at 3.35 TB/s; there is no arithmetic. The design
// makes every device access coalesced and leaves the permutation to shared
// memory, the same way in both directions:
//  - one block per ray turns the ray's S indices into src_row[j], the source
//    row of output row j (forward: src_row[inv[i]] = i; backward:
//    src_row[i] = inv[i]), in shared memory;
//  - it copies the ray's whole [S, C] row block (56.6 KB at S = 832,
//    C = 17) into shared memory as one contiguous run, a plain copy loop
//    that keeps many loads in flight (scattering each word to its slot as
//    it arrives measured half as fast on the H100);
//  - it stores output word (j, c) from row src_row[j], again as one
//    contiguous run;
//  - a row index outside [0, S) is never followed, so a malformed
//    permutation cannot read outside the block's shared memory (its output
//    is then undefined).

#include <cuda_runtime.h>

#define THREADS 256
#define SMEM_LIMIT 232448  // 227 KB, the most a block may use on sm_90

__global__ void __launch_bounds__(THREADS)
perm_gather_kernel(const unsigned int* __restrict__ src, const int* __restrict__ inv,
                   unsigned int* __restrict__ dst, int S, int C, int transpose) {
  extern __shared__ __align__(16) unsigned int smem[];
  int* src_row = reinterpret_cast<int*>(smem);  // [S]
  unsigned int* rows = smem + S;                // [S, C]
  const long long ray = blockIdx.x;
  const unsigned int* s = src + ray * S * C;
  unsigned int* d = dst + ray * S * C;
  const int* v = inv + ray * S;
  const int SC = S * C;

  for (int i = threadIdx.x; i < S; i += THREADS) {
    const int j = v[i];
    if (transpose)
      src_row[i] = j;
    else if ((unsigned)j < (unsigned)S)
      src_row[j] = i;
  }
  for (int e = threadIdx.x; e < SC; e += THREADS) rows[e] = s[e];
  __syncthreads();
  for (int e = threadIdx.x; e < SC; e += THREADS) {
    const int j = e / C, c = e - j * C;
    const int k = src_row[j];
    d[e] = (unsigned)k < (unsigned)S ? rows[k * C + c] : 0u;
  }
}

// Plain C entry point. src, dst [N, S, C] float32 and inv [N, S] int32, all
// contiguous on the current device. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int perm_gather(const float* src, const int* inv, float* dst, long long N, int S,
                           int C, int transpose, void* stream) {
  if (N < 0 || N > 0x7fffffffLL || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * S * (1 + (long long)C);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(perm_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  perm_gather_kernel<<<(unsigned int)N, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned int*>(src), inv, reinterpret_cast<unsigned int*>(dst), S, C,
      transpose);
  return (int)cudaGetLastError();
}
