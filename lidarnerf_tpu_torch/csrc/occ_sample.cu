// The `--fast` sampler for Hopper (sm_90a), fused into one kernel: per ray,
// the bin cells, the occupancy lookup, the bin pdf and the stratified inverse
// CDF, z = occ_z_vals(occ_bin_pdf(...)).
//
// Replaces the TPU kernel tools/exp_occ_lookup.py::lookup_pallas (P12), the
// [4096, 128] take of bin cells from the occupied volume, fused with the
// sampler around it (lidarnerf_tpu_torch/models/occupancy.py: bin_cells,
// occ_bin_pdf, occ_z_vals). P12's own counterpart, csrc/occ_lookup.cu, stays
// for the port's lookup tool. The plain PyTorch version of this function is
// lidarnerf_tpu_torch/ops/occ_sample.py::occ_sample_plain; on the card the two
// agree bit for bit:
//  - every product and sum is rounded on its own (__fmul_rn, __fadd_rn), as
//    torch's elementwise kernels round them, never contracted into an FMA;
//  - a division by the Python ints K and T is a product with the float32
//    reciprocal, as torch's CUDA division by a CPU scalar computes it; the
//    other scalars are float32 casts of torch's Python doubles (the wrapper
//    computes them);
//  - the cell index is torch's floor, int64 cast and clamp;
//  - the normalising sum and the cdf are taken from counts of occupied bins.
//    Each weight is 1 or 1e-8f (0/1 occupancy + 1e-8), so each pdf entry is
//    p_hi (occupied) or p_lo (empty). The sum is c + (K - c) * 1e-8f and the
//    cdf after bin k is n p_hi + (k + 1 - n) p_lo, n the occupied bins up to
//    k: in float64, two products (exact below 2^29 bins) and one add, each
//    rounded on its own (__dmul_rn, __dadd_rn), then rounded once to float32.
//    That is one fixed sequence of roundings with no order of adds in it, the
//    same as the plain version's (models/occupancy.py: volume_bin_pdf,
//    occ_cdf), so the two agree at every floor in [0, 1] and every bin count.
//    From a floor of 2^-29 x bins every entry lies on the 2^-52 grid and the
//    cdf is exact: the float64 cumsum of the pdf, rounded once. Where p_hi ==
//    p_lo every bin counts as occupied, as the plain version's p == max(p)
//    counts it. The cdf is searched in float32 as torch's
//    searchsorted(right=True) does (the count of cdf[1:] <= u, clipped to
//    K - 1).
//
// Bound: device memory, and at the `--fast` step's N = 4096 rays the launch.
// Per ray the function reads 32 B of ray, 4T B of draws (perturb only), and
// the distinct 32-byte sectors of the occupied volume that its bins touch,
// and writes 4T B of depths (and 4K B of pdf when asked): about 6.4 MB, 1.9 us
// at 3.35 TB/s. The plain composition runs some 50 kernels over [N, K] and
// [N, T] tensors, each a round trip through device memory; this one kernel
// keeps every intermediate on chip up to SMEM_BINS bins:
//  - one warp a ray, up to 8 rays a block; the ray's cdf (K + 1 floats)
//    lives in shared memory. A block takes as many rays as fit in 48 KB (8 up
//    to K = 1535, one from K = 6144); from K = 12288 one ray needs more, and
//    the launch opts in to up to 128 KB at SMEM_BINS (Hopper allows 227 KB a
//    block). Past SMEM_BINS the cdf lives in a workspace in device memory
//    ([N, K + 1] floats, allocated by the wrapper), so any bin count that the
//    plain version can hold runs;
//  - lane l takes bins l, l + 32, ...: one load instruction reads 32
//    consecutive bins of a ray, which fall in few cells, so few sectors; the
//    volume (8 MiB at G = 128) is read through the read-only path (__ldg) and
//    stays in the 50 MB L2; four loads are in flight before any is used;
//  - the pdf and the cdf take 32 consecutive bins a step: a ballot of their
//    occupancy and a popcount give each lane its n, and the pdf is written
//    coalesced;
//  - lane l takes samples l, l + 32, ...: coalesced draws and depths, each a
//    binary search of the ray's cdf.
// It launches on the caller's stream and reads nothing back, so a CUDA graph
// captures it.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_WARPS 8  // rays a block
#define SMEM_DEFAULT 49152  // bytes of shared memory a block takes without opting in
#define SMEM_BINS 32768  // one ray's cdf in shared memory up to here (128 KB); past it, the workspace
#define MAX_BINS 2147483392  // 2^31 - 256: the cdf and the bin loops' strides past K stay in int
#define INFLIGHT 4  // lookups a lane issues before it uses them
#define FULL_MASK 0xffffffffu

// The grid cell of one bin's midpoint (models/occupancy.py::bin_cells).
__device__ __forceinline__ int bin_cell(float o, float d, float z, float bound, float scale,
                                        int G) {
  const float x = __fadd_rn(o, __fmul_rn(d, z));
  long long g = (long long)floorf(__fmul_rn(__fadd_rn(x, bound), scale));
  g = g < 0 ? 0 : (g > G - 1 ? G - 1 : g);
  return (int)g;
}

// IN_SMEM: the cdfs in shared memory (work unused), else in the workspace;
// an instance of each, so that the shared one addresses shared memory alone
template <bool IN_SMEM>
__global__ void __launch_bounds__(MAX_WARPS * 32)
occ_sample_kernel(const float* __restrict__ occ3, int G, const float* __restrict__ rays_o,
                  const float* __restrict__ rays_d, const float* __restrict__ nears,
                  const float* __restrict__ fars, const float* __restrict__ xi,
                  const float* __restrict__ u_row, float* __restrict__ z,
                  float* __restrict__ pdf_out, float* __restrict__ work, int N, int K, int T,
                  float bound, float scale, float keep, float floor_k, float eps, float inv_k,
                  float inv_t) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;  // the whole warp leaves: no block-wide barrier follows
  // cdf[0] = 0, cdf[1 + k] after bin k; it first holds bin k's weight
  float* cdf = IN_SMEM ? smem + warp * (K + 1) : work + n * (K + 1LL);

  const float ox = rays_o[3 * n], oy = rays_o[3 * n + 1], oz = rays_o[3 * n + 2];
  const float dx = rays_d[3 * n], dy = rays_d[3 * n + 1], dz = rays_d[3 * n + 2];
  const float near = nears[n], far = fars[n];
  const float span = __fsub_rn(far, near);

  // 1. weights w = occ3[cell] + 1e-8 of bins lane, lane + 32, ...; the count
  // of occupied bins (w == 1)
  int occupied = 0;
  for (int k0 = lane; k0 < K; k0 += 32 * INFLIGHT) {
    float occ[INFLIGHT];
#pragma unroll
    for (int j = 0; j < INFLIGHT; ++j) {
      const int k = k0 + 32 * j;
      occ[j] = 0.0f;
      if (k < K) {
        const float t = __fmul_rn(__fadd_rn((float)k, 0.5f), inv_k);
        const float zk = __fadd_rn(near, __fmul_rn(span, t));
        const int gx = bin_cell(ox, dx, zk, bound, scale, G);
        const int gy = bin_cell(oy, dy, zk, bound, scale, G);
        const int gz = bin_cell(oz, dz, zk, bound, scale, G);
        occ[j] = __ldg(occ3 + ((long long)(gx * G + gy) * G + gz));
      }
    }
#pragma unroll
    for (int j = 0; j < INFLIGHT; ++j) {
      const int k = k0 + 32 * j;
      if (k < K) {
        const float w = __fadd_rn(occ[j], 1e-8f);
        cdf[1 + k] = w;
        occupied += w == 1.0f;
      }
    }
  }
  occupied = __reduce_add_sync(FULL_MASK, occupied);
  // the sum c + (K - c) * 1e-8f in float64, rounded once; the pdf's two values
  const float total = __double2float_rn(
      __dadd_rn((double)occupied, __dmul_rn((double)(K - occupied), (double)1e-8f)));
  const float p_hi = __fadd_rn(__fmul_rn(keep, __fdiv_rn(1.0f, total)), floor_k);
  const float p_lo = __fadd_rn(__fmul_rn(keep, __fdiv_rn(1e-8f, total)), floor_k);
  const bool one_value = p_hi == p_lo;
  const double d_hi = (double)p_hi, d_lo = (double)p_lo;
  __syncwarp();

  // 2. 32 consecutive bins a step: the pdf, and cdf[1 + k] = n p_hi + (k + 1 -
  // n) p_lo in float64, n the bins up to k that hold p_hi, rounded once
  int run = 0;  // bins before this step that hold p_hi
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < K;
    const bool occ = in && cdf[1 + k] == 1.0f;
    const unsigned hi = __ballot_sync(FULL_MASK, in && (occ || one_value));
    if (in) {
      const int n1 = run + __popc(hi & (FULL_MASK >> (31 - lane)));
      if (pdf_out) pdf_out[n * K + k] = occ ? p_hi : p_lo;
      cdf[1 + k] = __double2float_rn(
          __dadd_rn(__dmul_rn((double)n1, d_hi), __dmul_rn((double)(k + 1 - n1), d_lo)));
    }
    run += __popc(hi);
  }
  if (lane == 0) cdf[0] = 0.0f;
  __syncwarp();

  // 3. samples lane, lane + 32, ...: stratified inverse CDF
  const float bin_w = __fmul_rn(span, inv_k);
  for (int s = lane; s < T; s += 32) {
    const float u = xi ? __fmul_rn(__fadd_rn((float)s, xi[n * T + s]), inv_t) : u_row[s];
    int lo = 0, hi = K;  // the count of cdf[1:] <= u, as torch's upper bound
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(cdf[1 + mid] > u)) lo = mid + 1; else hi = mid;
    }
    const int below = min(lo, K - 1);
    const float cdf_b = cdf[below], cdf_a = cdf[below + 1];
    const float edge = __fadd_rn(near, __fmul_rn(bin_w, (float)below));
    const float diff = __fsub_rn(cdf_a, cdf_b);
    float frac = __fdiv_rn(__fsub_rn(u, cdf_b), diff < eps ? 1.0f : diff);
    if (frac == frac) frac = fminf(fmaxf(frac, 0.0f), 1.0f);  // torch's clamp keeps a NaN
    z[n * T + s] = __fadd_rn(edge, __fmul_rn(frac, bin_w));
  }
}

// Plain C entry point. occ3 [G, G, G], rays_o and rays_d [N, 3], nears and
// fars [N, 1], xi [N, T] (perturb) or u_row [T] (not: exactly one of the
// two), z [N, T] and pdf [N, K] (or null), and past SMEM_BINS bins the
// workspace work [N, K + 1] (else null): float32, contiguous, on the current
// device. The scalars are float32 as torch casts them: bound, G / (2 bound),
// 1 - floor, floor / K, 1e-12, 1 / K and 1 / T. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a size, a
// floor or a workspace it does not take.
extern "C" int occ_sample(const float* occ3, int G, const float* rays_o, const float* rays_d,
                          const float* nears, const float* fars, const float* xi,
                          const float* u_row, float* z, float* pdf, float* work, long long N,
                          int K, int T, float bound, float scale, float keep, float floor_k,
                          float eps, float inv_k, float inv_t, void* stream) {
  if (N < 0 || N > 0x7fffffffLL || G < 1 || (long long)G * G * G > 0x7fffffffLL || K < 1 ||
      K > MAX_BINS || T < 1 || !(floor_k >= 0.0f) || !(keep >= 0.0f) ||
      (xi == nullptr) == (u_row == nullptr) || (K > SMEM_BINS) != (work != nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (work) {
    occ_sample_kernel<false><<<(unsigned int)((N + MAX_WARPS - 1) / MAX_WARPS), MAX_WARPS * 32, 0,
                               (cudaStream_t)stream>>>(occ3, G, rays_o, rays_d, nears, fars, xi,
                                                       u_row, z, pdf, work, (int)N, K, T, bound,
                                                       scale, keep, floor_k, eps, inv_k, inv_t);
    return (int)cudaGetLastError();
  }
  const int ray_smem = (K + 1) * (int)sizeof(float);
  int warps = SMEM_DEFAULT / ray_smem;
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  const int smem = warps * ray_smem;
  if (smem > SMEM_DEFAULT) {  // one ray past 48 KB: opt in (no stream work, so a graph captures it)
    const cudaError_t err = cudaFuncSetAttribute(
        occ_sample_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  occ_sample_kernel<true><<<(unsigned int)((N + warps - 1) / warps), warps * 32, smem,
                            (cudaStream_t)stream>>>(occ3, G, rays_o, rays_d, nears, fars, xi,
                                                    u_row, z, pdf, nullptr, (int)N, K, T, bound,
                                                    scale, keep, floor_k, eps, inv_k, inv_t);
  return (int)cudaGetLastError();
}
