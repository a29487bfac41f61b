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
// table once, at 3.35 TB/s: 0.1515 ms for the main path's coarse call
// (Q = 3,145,728, L = 16). Its arithmetic (some 80 flops per query-level)
// is far below the card's fp32 rate. What keeps a kernel from that bound is
// atomics to one address: the L2 serialises them, and at levels 0-10 the
// consecutive samples of a ray share a row for 3-300 queries: with 8 float2
// atomics per (query, level), one thread each, a 300-query run at level 0
// would send 2,400 atomics to the same 8-20 addresses from some 150 warps.
// The design, in the tile layout of block_hash_common.cuh:
//  - stages the tile's points and g ([TILE, L] float2) in shared memory
//    with coalesced loads; warp w walks levels w, w + WARPS, ... (or a part
//    of the tile's groups when L < WARPS), each over the tile's 32-query
//    groups in order;
//  - per group, a shuffle and a ballot mark the lanes whose cell differs
//    from the previous lane's. If all 32 do (levels 11-15, and uniform
//    points), the group takes the plain path: 8 float2 atomics per query,
//    issued by octets (scatter_octets: lane k of an octet adds corner k of
//    the octet's queries, 8 lines per instruction instead of 32), with no
//    run finding;
//  - else, if each cell forms one run of lanes (__match_any_sync counts as
//    many distinct cells as runs; a query order without runs fails this and
//    takes the plain path, so the result holds for any order), the runs'
//    terms are summed in registers: one cell for the whole warp by a
//    reduce-scatter of its 16 terms (16 shuffles), several by a segmented
//    scan (16 shuffles per step, as many steps as the longest run needs);
//  - when the group lies in one row, the sums go into the warp's 64-float2
//    copy of that row in shared memory, which the warp carries to its next
//    group while the row stays the same, and adds to the table with one
//    16-byte atomic per touched corner pair when the row changes or the
//    walk ends: a 300-query run at level 0 costs about one row's atomics
//    per tile instead of 2,400. A group over several rows adds its runs'
//    sums with one set of 8 atomics per run, by octets as the plain path.
// What the atomics still cost: the plain path's at the fine levels (about
// 3M x 5 levels x 8 float2 atomics per coarse call, to rows that rarely
// repeat), and one row flush per (tile, level) at the coarse ones. fp32
// atomics add in an order that changes from run to run, so the result is
// not bitwise reproducible. The TPU kernel's devices (8 interleaved VMEM
// accumulator copies, an MXU one-hot matmul for the dense levels, the
// split-bf16 lane broadcast) have no place here.

#include "block_hash_common.cuh"

// The 8 corner terms of one (query, level), t[2k + ch] for corner
// k = (dx * 2 + dy) * 2 + dz and channel ch: w_k * g.ch, the products of
// scatter_query.
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

// Adds each lane's 8 corner terms t to the table, zeros skipped. `level`
// is the level's first float2 and `local` the lane's cell's first corner
// within it. An octet transpose first hands lane k of each octet corner k
// of the octet's 8 queries, so that each atomic instruction adds one
// query's 8 corners per octet: 8 lines per instruction instead of 32.
__device__ __forceinline__ void scatter_octets(float2* __restrict__ level, uint32_t local,
                                               const float t[16], int lane) {
  float2 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = make_float2(t[2 * i], t[2 * i + 1]);
  const int octet = lane & ~7, k8 = lane & 7;
  transpose_octet(v, k8);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint32_t at = __shfl_sync(FULL_MASK, local, octet + r);
    if (v[r].x != 0.f || v[r].y != 0.f) atomicAdd(level + at + offset_of_corner(k8), v[r]);
  }
}

// The whole warp on one cell: the sum over the 32 lanes of each of the 16
// terms, by a reduce-scatter. Lanes 2m and 2m + 1 return the sum of t[m].
__device__ __forceinline__ float reduce_scatter16(const float t[16], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
  float a[8], b[4], c[2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a[j] = (h16 ? t[j + 8] : t[j]) + __shfl_xor_sync(FULL_MASK, h16 ? t[j] : t[j + 8], 16);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = (h8 ? a[j + 4] : a[j]) + __shfl_xor_sync(FULL_MASK, h8 ? a[j] : a[j + 4], 8);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    c[j] = (h4 ? b[j + 2] : b[j]) + __shfl_xor_sync(FULL_MASK, h4 ? b[j] : b[j + 2], 4);
  const float d = (h2 ? c[1] : c[0]) + __shfl_xor_sync(FULL_MASK, h2 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(FULL_MASK, d, 1);
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

// Adds the warp's carried row sums `acc` (64 float2, lane k owning float2s
// 2k and 2k + 1) to table row `row` with one 16-byte atomic per nonzero
// pair, and zeroes them.
__device__ __forceinline__ void flush_row(float2* acc, float2* __restrict__ row, int lane) {
  __syncwarp();
  float4* mine = reinterpret_cast<float4*>(acc) + lane;
  const float4 v = *mine;
  *mine = make_float4(0.f, 0.f, 0.f, 0.f);
  if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
    atomicAdd(reinterpret_cast<float4*>(row) + lane, v);
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
block_hash_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                      float2* __restrict__ grad, long long Q, int L, uint32_t B,
                      const Levels lv, int split) {
  extern __shared__ float4 shared[];
  const int stride = tile_stride(L);
  float2* rows = reinterpret_cast<float2*>(shared);           // [WARPS][64] carried row sums
  float2* gt = rows + WARPS * 64;                             // [TILE][stride] the tile's g
  float* pts = reinterpret_cast<float*>(gt + TILE * stride);  // [TILE][3] the tile's points
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, Q - q0);

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
  float2* acc = rows + warp * 64;
  reinterpret_cast<float4*>(acc)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int per = GROUPS / split;  // groups per task
  for (int task = warp; task < L * split; task += WARPS) {
    const int l = task / split, k0 = (task % split) * per;
    bool carrying = false;
    uint32_t carried = 0;  // the table row of acc while carrying
    for (int k = k0; k < k0 + per && 32 * k < n; ++k) {
      const int i = 32 * k + lane;
      const int s = min(i, n - 1);  // a lane past the end repeats the last query, with no term
      const float p[3] = {pts[3 * s], pts[3 * s + 1], pts[3 * s + 2]};
      const Cell c = locate(p, l, B, lv);
      const float2 gv = (i < n && !outside_unit_cube(p)) ? gt[s * stride + l] : make_float2(0.f, 0.f);
      float t[16];
      corner_terms(c, gv, t);

      const unsigned long long key = c.corner0;  // the cell
      const unsigned long long prev = __shfl_up_sync(FULL_MASK, key, 1);
      const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || key != prev);
      bool runs = heads != FULL_MASK;
      if (runs) {  // each cell one run of lanes?
        const unsigned same = __match_any_sync(FULL_MASK, key);
        runs = __popc(__ballot_sync(FULL_MASK, __ffs(same) - 1 == lane)) == __popc(heads);
      }
      const size_t level0 = (size_t)l * B * 64;  // the level's first float2
      const uint32_t local = (uint32_t)(c.corner0 - level0);
      if (!runs) {  // the plain path
        scatter_octets(grad + level0, local, t, lane);
        continue;
      }

      const uint32_t row = (uint32_t)(c.corner0 >> 6);
      const uint32_t row0 = __shfl_sync(FULL_MASK, row, 0);
      const bool one_row = __all_sync(FULL_MASK, row == row0);
      if (one_row) {
        if (carrying && carried != row0) flush_row(acc, grad + (size_t)carried * 64, lane);
        carrying = true;
        carried = row0;
      }
      const int off = (int)(c.corner0 & 63);
      if (heads == 1u) {  // one cell (so one row)
        const float sum = reduce_scatter16(t, lane);
        if (!(lane & 1)) {
          const int m2 = lane >> 1, k2 = m2 >> 1;  // term m2: corner k2, channel m2 & 1
          const int slot = off + offset_of_corner(k2);
          reinterpret_cast<float*>(acc)[2 * slot + (m2 & 1)] += sum;
        }
        __syncwarp();
        continue;
      }
      run_sums16(t, heads, lane);
      const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
      if (!one_row) {  // each run's last lane adds the run's sums
        if (!last) {
#pragma unroll
          for (int j = 0; j < 16; ++j) t[j] = 0.f;
        }
        scatter_octets(grad + level0, local, t, lane);
        continue;
      }
      // the runs' cells are distinct cells of one row: in each round the
      // last lanes add to distinct float2s
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) {
        if (last) {
          float2& a = acc[off + offset_of_corner(k2)];
          a.x += t[2 * k2];
          a.y += t[2 * k2 + 1];
        }
        __syncwarp();
      }
    }
    if (carrying) flush_row(acc, grad + (size_t)carried * 64, lane);
  }
}

// Plain C entry point, as block_hash_fwd's. `grad` must hold L*B*128 zeros
// and be 16-byte aligned, and a level's B * 64 float2s indexable in 32
// bits. Returns the first CUDA error of the set-up or the launch (0 on
// success).
extern "C" int block_hash_bwd(const float* x, const float* g, float* grad,
                              long long Q, int L, int B, const float* scale,
                              const int* max_cell, const int* blocks_axis,
                              const int* dense, void* stream) {
  Levels lv;
  if (B < 1 || (long long)B * 64 > 0xffffffffLL || Q < 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense) ||
      reinterpret_cast<uintptr_t>(grad) % 16)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const long long blocks = (Q + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int split = 1;  // tasks per level: every warp gets one when L < WARPS
  while (split < GROUPS && 2 * split * L <= WARPS) split *= 2;
  const size_t smem = WARPS * 64 * sizeof(float2) + (size_t)TILE * tile_stride(L) * sizeof(float2) +
                      TILE * 3 * sizeof(float);
  const cudaError_t err = allow_shared(block_hash_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  block_hash_bwd_kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, reinterpret_cast<const float2*>(g), reinterpret_cast<float2*>(grad), Q, L,
      (uint32_t)B, lv, split);
  return (int)cudaGetLastError();
}
