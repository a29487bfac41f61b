// Merged compositing of two per-ray sorted sample lists for Hopper (sm_90a),
// forward and backward: the weights of ops/compositing.py::merged_composite_weights
// and the gradients of a loss with respect to both lists' densities.
//
// Replaces no TPU kernel: the JAX package composes in XLA
// (lidarnerf_tpu/ops/compositing.py::merged_composite_weights), and its
// order-free form builds [N, TA, TB] masks (compares, wheres, a min and two
// masked sums). The port's plain version of that form,
// lidarnerf_tpu_torch/ops/compositing.py::merged_composite_weights_plain, runs
// on CPU tensors and is what this kernel is held to.
//
// The function, per ray: merge A = (zA, sigA) [TA] and B = (zB, sigB) [TB],
// both sorted by depth, with A[i] before B[j] iff zA[i] <= zB[j]; a sample's
// delta is its merge successor's depth minus its own (sample_dist for the
// last); x = delta * density_scale * sigma, l = logaddexp(-x, log 1e-15), and
// w = (1 - exp(-x)) * exp(the sum of l over the earlier samples). The
// successor's depth is the same float as the order-free form's min over both
// lists, so deltas and x are bit for bit the plain version's; the sums differ
// only in their order and precision.
//
// Bound: device memory. The forward reads z and sigma of both lists (8 B a
// sample) and sample_dist, and writes w (4 B a sample): 40.9 MB at 4096 x
// (768 + 64), 12.2 us at 3.35 TB/s. The backward reads those and the two
// upstream gradients (12 B a sample) and writes two density gradients (4 B):
// 54.5 MB, 16.3 us. The order-free form moves some 600 times those bytes
// through its masks; this kernel keeps the merge on chip:
//  - one warp a ray, up to MAX_WARPS rays a block. The warp stages its ray's
//    rows in shared memory by asynchronous copies (cp.async: 16 bytes where
//    every row is 16-byte aligned, else 4, coalesced either way), all in
//    flight before the first is awaited;
//  - a merge-path co-rank search gives lane l the contiguous span [l s,
//    (l + 1) s) of the merged order, s = ceil((TA + TB) / 32), so the span
//    follows TA + TB from the input shapes (26 at 768 + 64, 8 at 192 + 64);
//  - each lane walks its span and peeks at the merge's next head for the
//    successor; nothing of size [TA, TB] or [TA + TB] is built;
//  - the lanes' sums of l meet in a warp scan in float64, and the lane walks
//    its span again with its float64 prefix, so every sum is float64;
//  - each weight goes to its sample's own slot in shared memory (in place of
//    its sigma, which only this lane reads), and the warp stores the rows
//    coalesced.
// The backward recomputes the deltas, x and the prefix the same way and saves
// nothing but the inputs. With T_k = exp(prefix_k) and R_k the sum of g_m w_m
// over the samples after k (in merged order; a float64 warp scan from the end
// and a running sum within the span):
//   dL/dx_k = g_k exp(-x_k) T_k + l'(x_k) R_k,  l'(x) = -exp(-x - l(x)),
//   dL/dsigma_k = dL/dx_k * (delta_k * density_scale).
// No atomics: a ray is one warp's own, and every sum has one fixed order, so
// both directions repeat bit for bit. Both launch on the caller's stream and
// read nothing back, so a CUDA graph captures them.

#include <cuda_runtime.h>

#define MAX_WARPS 4  // rays a block
#define SMEM_DEFAULT 49152  // bytes of shared memory a block takes without opting in
#define MAX_SAMPLES 16384  // TA + TB: one ray's backward rows fit in 192 KB of shared memory
#define FULL_MASK 0xffffffffu
#define LOG_EPS -34.538776394910684f  // log(1e-15), the transmittance floor

// torch's logaddexp(-x, LOG_EPS) in float32 (its CUDA kernel's formula)
__device__ __forceinline__ float log_trans(float x) {
  const float a = -x;
  const float m = fmaxf(a, LOG_EPS);
  return m + log1pf(expf(-fabsf(a - LOG_EPS)));
}

// Asynchronous copies from device memory to shared memory (cp.async): a
// lane issues all of its copies of a ray before it waits for any, so the
// ray's rows take one round trip to device memory.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// the lane's copies done; the warp's visible to it after a __syncwarp()
__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// n floats from device memory to shared memory by the warp, coalesced
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n, bool vec,
                                      int lane) {
  if (vec) {
    for (int k = 4 * lane; k < n; k += 128) copy16(dst + k, src + k);
  } else {
    for (int k = lane; k < n; k += 32) copy4(dst + k, src + k);
  }
}

__device__ __forceinline__ void unstage(float* __restrict__ dst, const float* src, int n, bool vec,
                                        int lane) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = lane; k < n / 4; k += 32) d4[k] = s4[k];
  } else {
    for (int k = lane; k < n; k += 32) dst[k] = src[k];
  }
}

// One lane's walk over its span of the merged order. zs holds the ray's
// depths, A at [0, TA) and B at [TA, TA + TB). step(k, x, delta) is called
// for each sample in merged order: k its slot in zs (its own list's index,
// B's offset by TA).
struct Walk {
  const float* zs;
  int TA, TB, M;
  int d0, d1;  // the span [d0, d1) of merged positions
  int i0;      // A samples before d0 (the co-rank)

  __device__ Walk(const float* zs_, int TA_, int TB_, int lane, int span)
      : zs(zs_), TA(TA_), TB(TB_), M(TA_ + TB_) {
    d0 = min(lane * span, M);
    d1 = min(d0 + span, M);
    // the least i in [max(0, d0 - TB), min(d0, TA)] with A[i] after B[d0 - 1 - i]
    int lo = max(0, d0 - TB), hi = min(d0, TA);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (zs[mid] > zs[TA + d0 - 1 - mid])
        hi = mid;
      else
        lo = mid + 1;
    }
    i0 = lo;
  }

  template <typename F>
  __device__ __forceinline__ void run(float sample_dist, float ds, const float* ss, F step) const {
    int i = i0, j = d0 - i0;
    float za = i < TA ? zs[i] : 0.0f;
    float zb = j < TB ? zs[TA + j] : 0.0f;
    for (int p = d0; p < d1; ++p) {
      const bool a = i < TA && (j >= TB || za <= zb);
      const float z = a ? za : zb;
      const int k = a ? i : TA + j;
      // advance, and reload the head of the list taken from
      i += a;
      j += !a;
      const bool more = a ? i < TA : j < TB;
      const float nz = more ? zs[a ? i : TA + j] : 0.0f;
      za = a ? nz : za;
      zb = a ? zb : nz;
      // the successor: the merge's next head
      const bool na = i < TA && (j >= TB || za <= zb);
      const float delta = p + 1 < M ? (na ? za : zb) - z : sample_dist;
      const float x = delta * ds * ss[k];
      step(k, x, delta);
    }
  }
};

__device__ __forceinline__ double warp_exclusive_sum(double v, int lane) {
  double incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += t;
  }
  const double excl = __shfl_up_sync(FULL_MASK, incl, 1);
  return lane == 0 ? 0.0 : excl;
}

// the sum over the lanes after this one
__device__ __forceinline__ double warp_suffix_after(double v, int lane) {
  double incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_down_sync(FULL_MASK, incl, o);
    if (lane + o < 32) incl += t;
  }
  const double after = __shfl_down_sync(FULL_MASK, incl, 1);
  return lane == 31 ? 0.0 : after;
}

// the ray's floats a buffer takes in shared memory (16-byte multiples)
__host__ __device__ __forceinline__ int row_floats(int M) { return (M + 3) & ~3; }

__global__ void merged_composite_fwd_kernel(const float* __restrict__ zA,
                                            const float* __restrict__ sA,
                                            const float* __restrict__ zB,
                                            const float* __restrict__ sB,
                                            const float* __restrict__ dist, float* __restrict__ wA,
                                            float* __restrict__ wB, int N, int TA, int TB, float ds,
                                            bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= N) return;  // the whole warp: nothing below syncs the block
  const int M = TA + TB, R = row_floats(M);
  float* zs = smem + (size_t)warp * 2 * R;
  float* ss = zs + R;
  stage(zs, zA + ray * TA, TA, vec, lane);
  stage(zs + TA, zB + ray * TB, TB, vec, lane);
  stage(ss, sA + ray * TA, TA, vec, lane);
  stage(ss + TA, sB + ray * TB, TB, vec, lane);
  const float sample_dist = dist[ray];
  copies_done();
  __syncwarp();

  const Walk walk(zs, TA, TB, lane, (M + 31) / 32);
  double lsum = 0.0;
  walk.run(sample_dist, ds, ss, [&](int, float x, float) { lsum += (double)log_trans(x); });
  double prefix = warp_exclusive_sum(lsum, lane);
  walk.run(sample_dist, ds, ss, [&](int k, float x, float) {
    const float w = (1.0f - expf(-x)) * expf((float)prefix);
    prefix += (double)log_trans(x);
    ss[k] = w;  // sample k's sigma is read by this lane alone, and already read
  });
  __syncwarp();
  unstage(wA + ray * TA, ss, TA, vec, lane);
  unstage(wB + ray * TB, ss + TA, TB, vec, lane);
}

__global__ void merged_composite_bwd_kernel(
    const float* __restrict__ zA, const float* __restrict__ sA, const float* __restrict__ zB,
    const float* __restrict__ sB, const float* __restrict__ dist, const float* __restrict__ gA,
    const float* __restrict__ gB, float* __restrict__ dA, float* __restrict__ dB, int N, int TA,
    int TB, float ds, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= N) return;
  const int M = TA + TB, R = row_floats(M);
  float* zs = smem + (size_t)warp * 3 * R;
  float* ss = zs + R;
  float* gs = ss + R;
  stage(zs, zA + ray * TA, TA, vec, lane);
  stage(zs + TA, zB + ray * TB, TB, vec, lane);
  stage(ss, sA + ray * TA, TA, vec, lane);
  stage(ss + TA, sB + ray * TB, TB, vec, lane);
  stage(gs, gA + ray * TA, TA, vec, lane);
  stage(gs + TA, gB + ray * TB, TB, vec, lane);
  const float sample_dist = dist[ray];
  copies_done();
  __syncwarp();

  const Walk walk(zs, TA, TB, lane, (M + 31) / 32);
  double lsum = 0.0;
  walk.run(sample_dist, ds, ss, [&](int, float x, float) { lsum += (double)log_trans(x); });
  const double start = warp_exclusive_sum(lsum, lane);
  // the lane's sum of g w, then R at the span's first sample
  double prefix = start, gw = 0.0;
  walk.run(sample_dist, ds, ss, [&](int k, float x, float) {
    const float w = (1.0f - expf(-x)) * expf((float)prefix);
    prefix += (double)log_trans(x);
    gw += (double)(gs[k] * w);
  });
  const double rest = gw + warp_suffix_after(gw, lane);  // sum of g w from the span's start on
  prefix = start;
  double upto = 0.0;  // sum of g w over the span's samples up to and including k
  walk.run(sample_dist, ds, ss, [&](int k, float x, float delta) {
    const float l = log_trans(x);
    const float e = expf(-x);
    const float T = expf((float)prefix);
    const float g = gs[k];
    prefix += (double)l;
    upto += (double)(g * ((1.0f - e) * T));
    const float after = (float)(rest - upto);  // R_k
    const float dx = g * e * T - expf(-x - l) * after;
    gs[k] = dx * (delta * ds);  // g_k is read by this lane alone, and already read
  });
  __syncwarp();
  unstage(dA + ray * TA, gs, TA, vec, lane);
  unstage(dB + ray * TB, gs + TA, TB, vec, lane);
}

// Rays a block and its shared memory for `bufs` row buffers of M samples;
// opts in past 48 KB (no stream work, so a graph captures it).
template <typename K>
static cudaError_t plan(K kernel, int M, int bufs, int* warps, int* smem) {
  const int ray_smem = bufs * row_floats(M) * (int)sizeof(float);
  int w = SMEM_DEFAULT / ray_smem;
  w = w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
  *warps = w;
  *smem = w * ray_smem;
  if (*smem > SMEM_DEFAULT)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  return cudaSuccess;
}

static bool aligned(const void* p) { return ((unsigned long long)p & 15) == 0; }

static bool valid(long long N, int TA, int TB) {
  return N >= 0 && N <= 0x7fffffffLL && TA >= 1 && TB >= 1 && TA + TB <= MAX_SAMPLES;
}

// Plain C entry points. zA, sA, wA, gA, dA [N, TA]; zB, sB, wB, gB, dB [N,
// TB]; dist [N, 1]; all float32, contiguous, on the current device. Return
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape they do not take.
extern "C" int merged_composite_fwd(const float* zA, const float* sA, const float* zB,
                                    const float* sB, const float* dist, float* wA, float* wB,
                                    long long N, int TA, int TB, float ds, void* stream) {
  if (!valid(N, TA, TB)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const bool vec = TA % 4 == 0 && TB % 4 == 0 && aligned(zA) && aligned(sA) && aligned(zB) &&
                   aligned(sB) && aligned(wA) && aligned(wB);
  int warps, smem;
  const cudaError_t err = plan(merged_composite_fwd_kernel, TA + TB, 2, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  merged_composite_fwd_kernel<<<(unsigned int)((N + warps - 1) / warps), warps * 32, smem,
                                (cudaStream_t)stream>>>(zA, sA, zB, sB, dist, wA, wB, (int)N, TA,
                                                        TB, ds, vec);
  return (int)cudaGetLastError();
}

extern "C" int merged_composite_bwd(const float* zA, const float* sA, const float* zB,
                                    const float* sB, const float* dist, const float* gA,
                                    const float* gB, float* dA, float* dB, long long N, int TA,
                                    int TB, float ds, void* stream) {
  if (!valid(N, TA, TB)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const bool vec = TA % 4 == 0 && TB % 4 == 0 && aligned(zA) && aligned(sA) && aligned(zB) &&
                   aligned(sB) && aligned(gA) && aligned(gB) && aligned(dA) && aligned(dB);
  int warps, smem;
  const cudaError_t err = plan(merged_composite_bwd_kernel, TA + TB, 3, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  merged_composite_bwd_kernel<<<(unsigned int)((N + warps - 1) / warps), warps * 32, smem,
                                (cudaStream_t)stream>>>(zA, sA, zB, sB, dist, gA, gB, dA, dB,
                                                        (int)N, TA, TB, ds, vec);
  return (int)cudaGetLastError();
}
