// What the block-hash backward kernels share (B2 block_hash_bwd.cu, B3b
// block_hash_seg_bwd.cu, B4b block_hash_win_bwd.cu): the order-free
// accumulator that makes their table gradient bitwise reproducible, and
// B2's tile helpers, which the tile layouts of B3b and B4b use too.
//
// The order-free accumulator. A kernel sums terms in registers and shared
// memory in an order fixed by its inputs (shuffles, ballots, scans), and
// adds the resulting partial sums to the table from many warps at once: an
// fp32 atomicAdd would add them in an order that changes from run to run,
// and fp32 addition is not associative. So every partial is rounded once
// to a fixed point, p * 2^k to the nearest int64, and added with an integer
// atomic, whose sum does not depend on the order. k comes from the call's
// inputs on the device, with no host read: M = max |g| over the finite
// entries of g (max_abs_finite_kernel) and the query count Q. An entry sums
// at most Q terms |w g| <= M (w <= 1), so with Q < 2^qb and M < 2^(e+1),
// k = 60 - e - qb keeps every sum below 2^61 (a factor 2 for the fp32
// rounding of the partials) and resolves 2^-k ~ M 2^-38 at the coarse
// call's Q = 3,145,728: far inside the 1e-5 S + 1e-7 slack against the
// plain version. One pass then writes the fp32 table (fixed_finish_kernel).
// A non-finite partial (a NaN or an Inf in g) cannot be rounded to an
// integer: it is added with an fp32 atomicAdd to the zeroed output table
// instead, and the finish pass adds the fixed-point sum to it. A sum of
// non-finite values alone does not depend on the order either (any NaN
// gives NaN, +Inf and -Inf give NaN, else the one infinity), so an entry is
// non-finite exactly where one of its terms is; poison_row adds the rest of
// the plain version's non-finite entries.
// The cost: an int64 scratch twice the table's size (zeroed per call), a
// read of g, the finish pass, and two 8-byte atomics where one float2
// atomic went before.
#pragma once

#include "block_hash_common.cuh"

// The call's fixed-point scale: scratch holds the [L*B*128] int64 sums and,
// after them, the float bits of M and a flag set when g holds a NaN or an
// Inf (then, and only then, the kernels test each value for finiteness).
struct FixedAcc {
  unsigned long long* __restrict__ sums;  // [L*B*128] rounded partials, two's complement
  float* __restrict__ grad;               // [L*B*128] the output, zeroed: non-finite partials
  float scale;                            // 2^k
  bool non_finite;                        // g holds a NaN or an Inf
};

// k for the largest finite |g|'s bits `max_bits` and Q queries, within the
// normal floats' exponents, so 2^k and 2^-k are exact floats.
__device__ __forceinline__ int fixed_exponent(unsigned max_bits, long long Q) {
  const int e = (int)(max_bits >> 23) - 127;  // M < 2^(e+1); M = 0 or subnormal: e = -127
  const int qb = 64 - __clzll(Q);             // Q < 2^qb
  return min(max(60 - e - qb, -126), 126);
}

__device__ __forceinline__ float exp2_exact(int k) { return __int_as_float((127 + k) << 23); }

__device__ __forceinline__ FixedAcc fixed_acc(unsigned long long* sums, float* grad,
                                              const unsigned* max_bits, long long Q) {
  FixedAcc a;
  a.sums = sums;
  a.grad = grad;
  a.scale = exp2_exact(fixed_exponent(max_bits[0], Q));
  a.non_finite = max_bits[1] != 0;
  return a;
}

// Adds partial v to float i of the table; zeros are skipped.
__device__ __forceinline__ void add_value(const FixedAcc& a, size_t i, float v) {
  if (v == 0.f) return;
  if (!a.non_finite || isfinite(v)) {
    atomicAdd(a.sums + i, (unsigned long long)__float2ll_rn(v * a.scale));
  } else {
    atomicAdd(a.grad + i, v);
  }
}

// Adds the float2 v to float2 s of the table (both channels).
__device__ __forceinline__ void add_pair(const FixedAcc& a, size_t s, float2 v) {
  add_value(a, 2 * s, v.x);
  add_value(a, 2 * s + 1, v.y);
}

// The plain version multiplies a query's g by the weights of all 64 corners
// of its row, zero off its cell, and 0 * NaN = 0 * Inf = NaN: a non-finite
// g makes the whole row's channel non-finite there. The kernels' terms
// cover the cell's 8 corners; for a query whose g is not finite (rare: the
// step is then skipped) this adds NaN to the other 56 corners of each
// non-finite channel, so the non-finite entries are the plain version's.
// `corner0` is the cell's first corner float2 (Cell::corner0).
__device__ __noinline__ void poison_row(const FixedAcc& a, size_t corner0, float2 gv) {
  const size_t row0 = corner0 & ~(size_t)63;
  const int off = (int)(corner0 & 63);
  const float nan = __int_as_float(0x7fffffff);
  for (int s = 0; s < 64; ++s) {
    const int dx = (s >> 4) - (off >> 4);
    const int dy = ((s >> 2) & 3) - ((off >> 2) & 3);
    const int dz = (s & 3) - (off & 3);
    if ((unsigned)dx <= 1u && (unsigned)dy <= 1u && (unsigned)dz <= 1u) continue;  // a corner
    if (!isfinite(gv.x)) atomicAdd(a.grad + 2 * (row0 + s), nan);
    if (!isfinite(gv.y)) atomicAdd(a.grad + 2 * (row0 + s) + 1, nan);
  }
}

// poison_row where g is not finite.
__device__ __forceinline__ void check_finite(const FixedAcc& a, size_t corner0, float2 gv) {
  if (a.non_finite && (!isfinite(gv.x) || !isfinite(gv.y))) poison_row(a, corner0, gv);
}

// M: the largest |g| over g's finite entries, as float bits (non-negative
// floats order as their bits), into max_bits[0], and whether g holds a NaN
// or an Inf into max_bits[1] (both zeroed). Reads g [n2] float2.
__global__ void __launch_bounds__(THREADS)
max_abs_finite_kernel(const float2* __restrict__ g, long long n2, unsigned* max_bits) {
  unsigned m = 0, bad = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n2;
       i += (long long)gridDim.x * THREADS) {
    const float2 v = __ldg(g + i);
    const unsigned x = __float_as_uint(fabsf(v.x)), y = __float_as_uint(fabsf(v.y));
    const bool fx = isfinite(v.x), fy = isfinite(v.y);
    m = max(m, max(fx ? x : 0u, fy ? y : 0u));
    bad |= !(fx && fy);
  }
  m = __reduce_max_sync(FULL_MASK, m);
  bad = __reduce_or_sync(FULL_MASK, bad);
  if ((threadIdx.x & 31) == 0) {
    if (m) atomicMax(max_bits, m);
    if (bad) atomicOr(max_bits + 1, 1u);
  }
}

// grad[i] += sums[i] * 2^-k for the table's n4 float4s.
__global__ void __launch_bounds__(THREADS)
fixed_finish_kernel(const longlong2* __restrict__ sums, float4* __restrict__ grad, long long n4,
                    const unsigned* max_bits, long long Q) {
  const float inv = exp2_exact(-fixed_exponent(max_bits[0], Q));
  const bool non_finite = max_bits[1] != 0;  // else grad holds zeros: no need to read it
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const longlong2 a = sums[2 * i], b = sums[2 * i + 1];
    float4 o = non_finite ? grad[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    o.x += __ll2float_rn(a.x) * inv;
    o.y += __ll2float_rn(a.y) * inv;
    o.z += __ll2float_rn(b.x) * inv;
    o.w += __ll2float_rn(b.y) * inv;
    grad[i] = o;
  }
}

// Bytes of the scratch a backward entry point takes: the int64 sums, M and
// the non-finite flag.
static inline size_t fixed_scratch_bytes(int L, uint32_t B) {
  return (size_t)L * B * 128 * sizeof(long long) + 16;
}

// Runs a backward kernel through the accumulator on `stream`: zeroes the
// output and the scratch (fixed_scratch_bytes), finds M, calls
// launch(sums, max_bits), which launches the kernel and returns its
// cudaGetLastError(), and converts the sums into `grad`. Returns the first
// CUDA error (0 on success).
template <typename Launch>
static inline int run_fixed(const float* g, float* grad, void* scratch, long long Q, int L,
                            uint32_t B, cudaStream_t stream, Launch launch) {
  const size_t n = (size_t)L * B * 128;
  unsigned long long* sums = reinterpret_cast<unsigned long long*>(scratch);
  unsigned* max_bits = reinterpret_cast<unsigned*>(sums + n);
  cudaError_t err = cudaMemsetAsync(grad, 0, n * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(scratch, 0, fixed_scratch_bytes(L, B), stream);
  if (err != cudaSuccess || Q == 0) return (int)err;
  const long long n2 = Q * L;  // g's float2s
  const int grid = (int)min((n2 + THREADS - 1) / THREADS, 132LL * 16);
  max_abs_finite_kernel<<<grid, THREADS, 0, stream>>>(reinterpret_cast<const float2*>(g), n2,
                                                        max_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch(sums, max_bits);
  if (err != cudaSuccess) return (int)err;
  fixed_finish_kernel<<<132 * 16, THREADS, 0, stream>>>(
      reinterpret_cast<const longlong2*>(sums), reinterpret_cast<float4*>(grad), (long long)(n / 4),
      max_bits, Q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- B2's tile

// Stages a tile's points [n, 3] and feature gradients [n, L] float2 (rows
// `stride` float2s apart) in shared memory with coalesced loads.
__device__ __forceinline__ void stage_tile(const float* __restrict__ x, const float2* __restrict__ g,
                                           long long q0, int n, int L, int stride, float* pts,
                                           float2* gt) {
  for (int i = threadIdx.x; i < 3 * n; i += THREADS) pts[i] = __ldg(x + 3 * q0 + i);
  const float2* gsrc = g + q0 * L;  // the tile's n * L contiguous float2s
  const int m = n * L;
  if (reinterpret_cast<uintptr_t>(gsrc) % 16 == 0) {
    const float4* g4 = reinterpret_cast<const float4*>(gsrc);
    for (int k = threadIdx.x; k < m / 2; k += THREADS) {
      const float4 v = __ldg(g4 + k);
      gt[tile_slot(2 * k, L, stride)] = make_float2(v.x, v.y);
      gt[tile_slot(2 * k + 1, L, stride)] = make_float2(v.z, v.w);
    }
    if ((m & 1) && threadIdx.x == 0) gt[tile_slot(m - 1, L, stride)] = __ldg(gsrc + m - 1);
  } else {
    for (int k = threadIdx.x; k < m; k += THREADS) gt[tile_slot(k, L, stride)] = __ldg(gsrc + k);
  }
}

// Shared memory of a B2-layout block: `rows` 64-float2 row copies per warp,
// the tile's g and its points.
static inline size_t tile_smem(int L, int rows) {
  return (size_t)WARPS * rows * 64 * sizeof(float2) +
         (size_t)TILE * tile_stride(L) * sizeof(float2) + TILE * 3 * sizeof(float);
}

// Tasks per level: every warp gets one when L < WARPS.
static inline int tile_split(int L) {
  int split = 1;
  while (split < GROUPS && 2 * split * L <= WARPS) split *= 2;
  return split;
}

// The 8 corner terms of one (query, level), t[2k + ch] for corner
// k = (dx * 2 + dy) * 2 + dz and channel ch: w_k * g.ch.
__device__ __forceinline__ void corner_terms(const Cell& c, float2 gv, float t[16]) {
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = __fmul_rn(c.wx[dx], c.wy[dy]);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(wxy, c.wz[dz]);
        const int k = (dx * 2 + dy) * 2 + dz;
        t[2 * k] = __fmul_rn(w, gv.x);
        t[2 * k + 1] = __fmul_rn(w, gv.y);
      }
    }
  }
}

// Adds a warp's row sums `acc` (64 float2 = 128 floats of table row `row`;
// lane k adds floats k, k + 32, k + 64, k + 96) to the table, and zeroes
// them.
__device__ __forceinline__ void flush_row(const FixedAcc& a, float2* acc, uint32_t row, int lane) {
  __syncwarp();
  float* f = reinterpret_cast<float*>(acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    add_value(a, (size_t)row * 128 + 32 * j + lane, f[32 * j + lane]);
    f[32 * j + lane] = 0.f;
  }
  __syncwarp();
}

// Adds each lane's 8 corner terms t to the table, zeros skipped. `level0`
// is the level's first float2 and `local` the lane's cell's first corner
// within it. An octet transpose first hands lane k of each octet corner k
// of the octet's 8 queries, so that each atomic instruction adds one
// query's 8 corners per octet: 8 lines per instruction instead of 32.
__device__ __forceinline__ void scatter_octets(const FixedAcc& a, size_t level0, uint32_t local,
                                               const float t[16], int lane) {
  float2 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = make_float2(t[2 * i], t[2 * i + 1]);
  const int octet = lane & ~7, k8 = lane & 7;
  transpose_octet(v, k8);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint32_t at = __shfl_sync(FULL_MASK, local, octet + r);
    add_pair(a, level0 + at + offset_of_corner(k8), v[r]);
  }
}

// Inclusive sums of the 16 terms over each run of lanes (a run starts at a
// set bit of `heads`; bit 0 is set), in as many doubling steps as the
// longest run needs: a run's last lane then holds the run's sums.
__device__ __forceinline__ void run_sums16(float t[16], unsigned heads, int lane) {
  const unsigned upto = FULL_MASK >> (31 - lane);  // lanes 0 ... lane
  const int start = 31 - __clz(heads & upto);      // the first lane of this lane's run
  const unsigned later = heads & ~upto;
  const int next = later ? __ffs(later) - 1 : 32;  // the first lane of the next run
  const int longest = (int)__reduce_max_sync(FULL_MASK, (unsigned)(next - start));
  for (int d = 1; d < longest; d <<= 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float up = __shfl_up_sync(FULL_MASK, t[j], d);
      if (lane - d >= start) t[j] += up;
    }
  }
}

// One step of a reduce-scatter of N values per lane between lanes `m`
// apart: the lane with bit m set keeps the upper half, its partner the
// lower, each plus the other's copy of it.
template <int N>
__device__ __forceinline__ void reduce_scatter_step(float t[16], int lane, int m) {
  const bool upper = lane & m;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float keep = upper ? t[j + N / 2] : t[j];
    const float send = upper ? t[j] : t[j + N / 2];
    t[j] = keep + __shfl_xor_sync(FULL_MASK, send, m);
  }
}

// The sums of the 16 terms over each aligned window of W = 2, 4 or 8
// lanes, or over the whole warp (W = 32), scattered: afterwards lane r of a
// window holds in t[0 .. 16 / W) the window's sums of t[r * 16 / W ...];
// for W = 32, lanes 2m and 2m + 1 both hold the sum of term m in t[0].
template <int W>
__device__ __forceinline__ void reduce_scatter(float t[16], int lane) {
  if constexpr (W == 32) {
    reduce_scatter_step<16>(t, lane, 16);
    reduce_scatter_step<8>(t, lane, 8);
    reduce_scatter_step<4>(t, lane, 4);
    reduce_scatter_step<2>(t, lane, 2);
    t[0] += __shfl_xor_sync(FULL_MASK, t[0], 1);
  } else if constexpr (W == 8) {
    reduce_scatter_step<16>(t, lane, 4);
    reduce_scatter_step<8>(t, lane, 2);
    reduce_scatter_step<4>(t, lane, 1);
  } else if constexpr (W == 4) {
    reduce_scatter_step<16>(t, lane, 2);
    reduce_scatter_step<8>(t, lane, 1);
  } else {
    static_assert(W == 2, "windows of 2, 4, 8 or 32 lanes");
    reduce_scatter_step<16>(t, lane, 1);
  }
}
