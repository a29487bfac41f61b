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
// rows it touches, at 3.35 TB/s: 0.1446 ms for the main path's coarse call;
// its ~60 flops per query-level are far below the fp32 rate. What a kernel
// meets first is where the lanes of a warp go: with one thread per (level,
// query), every feature store out[q * L + l] lies 128 bytes from its lane
// neighbour's (32 lines per instruction). The design keeps the TPU kernel's
// mechanism, one row load per uniform window, in B1's tile layout
// (block_hash_common.cuh), as B3a does for runs:
//  - a block owns a tile of 32 * WIN_GROUPS consecutive queries whose
//    points it stages once in shared memory; its warps split the levels
//    (warp w: levels w, w + WARPS, ...) and walk each over the tile's
//    32-query groups in order; lane k holds query k of a group, so a window
//    is an aligned slice of w lanes (tiles start at multiples of 32);
//  - per group, the ballot of B1's row changes marks the uniform windows
//    (no change inside) by bit arithmetic, with no shuffle; consecutive
//    uniform windows of one row form a segment. A group of at most
//    WIN_SLOTS segments loads each segment's 512-byte row once, one float4
//    per lane (one coalesced load), into the warp's ring of WIN_SLOTS rows
//    in shared memory, where a segment that goes on from the warp's
//    previous group finds its row already;
//  - the lanes of a uniform window interpolate their own query from there
//    with locate + trilerp, the cell choice and fma order of B1, so the
//    features are B1's bit for bit; the other lanes, every lane of a group
//    of more segments, and every w = 1 level take B1's corner loads
//    (load_corners: each lane its own corners, or octets);
//  - the tile's [32 * WIN_GROUPS, L] features are written into shared
//    memory and stored to `out`, where they are contiguous, as coalesced
//    16-byte stores.
// What holds it back (about 1.5x B1 on a ray chunk, B1's time on uniform
// points): a ring row costs more than B1's broadcast corner loads, which
// the L1 serves; a group whose windows are only partly uniform (a row
// change inside a window: most groups at levels 5-10 along a ray) pays for
// the ring and for B1's loads; and the two kept live at once take 64
// registers a thread (B1 40), so 4 blocks fit on an SM where B1 has 6.
// Capping the registers spills and is slower. The w = 1 levels 11-15 read 4
// sectors per query from L2, as B1's do. The TPU kernel's devices (SMEM
// flag streams, broadcast tile stores, the split-bf16 MXU lane reduction)
// have no place here.

#include "block_hash_common.cuh"

#ifndef WIN_GROUPS
#define WIN_GROUPS 4  // 32-query groups per tile (128 queries timed best of 32-128)
#endif
#ifndef WIN_SLOTS
#define WIN_SLOTS 4  // table rows a warp holds in shared memory (a power of 2; 4 timed best of 2-8)
#endif
#define WIN_TILE (32 * WIN_GROUPS)

__global__ void __launch_bounds__(THREADS)
block_hash_win_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                          float2* __restrict__ out, long long Q, int L, uint32_t B,
                          const Levels lv) {
  extern __shared__ float4 shared[];
  const int stride = tile_stride(L);
  float4* slots = shared;                                                       // [WARPS][WIN_SLOTS][32]
  float2* features = reinterpret_cast<float2*>(slots + WARPS * WIN_SLOTS * 32);  // [WIN_TILE][stride]
  float* pts = reinterpret_cast<float*>(features + WIN_TILE * stride);          // [WIN_TILE][3]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q0 = (long long)blockIdx.x * WIN_TILE;
  const int n = (int)min((long long)WIN_TILE, Q - q0);
  for (int i = threadIdx.x; i < 3 * n; i += THREADS) pts[i] = __ldg(x + 3 * q0 + i);
  __syncthreads();

  const float4* table4 = reinterpret_cast<const float4*>(table);
  float4* ring = slots + warp * WIN_SLOTS * 32;
  const unsigned upto = FULL_MASK >> (31 - lane);  // lanes 0 ... lane
  for (int l = warp; l < L; l += WARPS) {
    const int w = lv.runs[l];
    const size_t level0 = (size_t)l * B * 64;  // the level's first float2
    const float2* level = reinterpret_cast<const float2*>(table) + level0;
    uint32_t carried = NO_ROW;  // the row in slot `last`
    int last = WIN_SLOTS - 1;
    for (int k = 0; k < WIN_GROUPS && 32 * k < n; ++k) {
      const int i = 32 * k + lane;
      const int s = min(i, n - 1);  // a lane past the end repeats the last query, never stored
      const float p[3] = {pts[3 * s], pts[3 * s + 1], pts[3 * s + 2]};
      const bool inside = !outside_unit_cube(p);
      const Cell c = locate(p, l, B, lv);
      const uint32_t local = (uint32_t)(c.corner0 - level0);
      const uint32_t row = local >> 6;
      const uint32_t prev = __shfl_up_sync(FULL_MASK, row, 1);
      const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || row != prev);
      // From the row changes alone: the lanes of uniform windows (no change
      // inside the window), the first lanes of their segments (a uniform
      // window whose first lane is no change goes on from the uniform
      // window before it), and the lanes that read their row from the ring.
      unsigned uniform = 0u, starts = 0u, ring_lanes = 0u;
      if (w > 1) {
        const unsigned firsts = FULL_MASK / ((1u << w) - 1u);  // each window's first lane
        unsigned split = heads & ~firsts;
        for (int d = 1; d < w; d <<= 1) split |= split >> d;  // at a first lane: a change inside
        const unsigned first_uniform = firsts & ~split;
        starts = first_uniform & ~((first_uniform << w) & ~heads);
        uniform = first_uniform;
        for (int d = 1; d < w; d <<= 1) uniform |= uniform << d;
        if (__popc(starts) <= WIN_SLOTS) ring_lanes = uniform;
      }
      const bool mine = (ring_lanes >> lane) & 1u;
      const int nseg = __popc(starts);
      float2 v[8];  // B1's loads for the other lanes, in flight while the ring fills
      if (ring_lanes != FULL_MASK) load_corners(level, local, heads, lane, v, ~ring_lanes);
      float2 o;
      if (ring_lanes) {
        // segment u's row goes to slot (first + u) % WIN_SLOTS; a first
        // segment that goes on from the previous group is already in `last`
        const uint32_t row0 = __shfl_sync(FULL_MASK, row, 0);
        const bool goes_on = (uniform & 1u) && row0 == carried;
        const int first = goes_on ? last : (last + 1) & (WIN_SLOTS - 1);
        unsigned todo = goes_on ? starts & (starts - 1) : starts;
        for (int u = goes_on; todo; ++u, todo &= todo - 1) {
          const uint32_t r = __shfl_sync(FULL_MASK, row, __ffs(todo) - 1);
          ring[((first + u) & (WIN_SLOTS - 1)) * 32 + lane] = __ldg(table4 + ((size_t)l * B + r) * 32 + lane);
        }
        __syncwarp();
        const int seg = __popc(starts & upto) - 1;
        if (mine) {
          const float2* corners =
              reinterpret_cast<const float2*>(ring + ((first + seg) & (WIN_SLOTS - 1)) * 32);
          const int off = (int)(c.corner0 & 63);
          o = trilerp(c, [&](int kk) { return corners[off + kk]; });
        }
        __syncwarp();  // the rows are read before the next group's loads
        last = (first + nseg - 1) & (WIN_SLOTS - 1);
        carried = __shfl_sync(FULL_MASK, row, 31 - __clz(starts));
      }
      if (!mine) o = trilerp(c, [&](int kk) { return v[corner_of_offset(kk)]; });
      features[i * stride + l] = inside ? o : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();

  // out[q0 : q0 + n] is n * L contiguous float2s, 16-byte aligned (q0 is a
  // multiple of 32 and out is 16-byte aligned)
  const int m = n * L;
  float2* dst = out + q0 * L;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int k = threadIdx.x; k < m / 2; k += THREADS) {
    const float2 a = features[tile_slot(2 * k, L, stride)];
    const float2 b = features[tile_slot(2 * k + 1, L, stride)];
    dst4[k] = make_float4(a.x, a.y, b.x, b.y);
  }
  if ((m & 1) && threadIdx.x == 0) dst[m - 1] = features[tile_slot(m - 1, L, stride)];
}

// Plain C entry point, as block_hash_fwd's, plus `runs` [L] (host): each
// level's window size, 8, 4, 2 or 1. The table and `out` must be 16-byte
// aligned. Returns the first CUDA error of the set-up or the launch (0 on
// success).
extern "C" int block_hash_win_fwd(const float* x, const float* table, float* out,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || (long long)B * 64 > 0xffffffffLL || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs) ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(table) % 16)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    const int w = lv.runs[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
  }
  if (Q == 0) return 0;
  const long long blocks = (Q + WIN_TILE - 1) / WIN_TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * WIN_SLOTS * 512 +
                      (size_t)WIN_TILE * tile_stride(L) * sizeof(float2) +
                      WIN_TILE * 3 * sizeof(float);
  const cudaError_t err = allow_shared(block_hash_win_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  block_hash_win_fwd_kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, table, reinterpret_cast<float2*>(out), Q, L, (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
