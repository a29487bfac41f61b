// Block-hash grid encoder, table gradient by runs of equal rows (B3b), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_bwd_seg_from_prep
// (B3b). It computes B2's function (block_hash_bwd.cu): for each query
// inside [0, 1]^3 and level l, w * (g[q, 2l], g[q, 2l+1]) added to each of
// the cell's 8 corner float2s, w the corner's trilinear weight, duplicates
// summed, into a zeroed [L*B, 128] float32 table. A run of equal consecutive
// rows sums its terms first and adds them with one atomic per touched corner
// float2 of the row, where B2 issues 8 atomics per query. The plain PyTorch
// version with the same run rules is
// lidarnerf_tpu_torch/ops/block_hash.py::encode_bwd_seg_plain.
//
// Bound: the same as B2's, device memory. The function must read 12 bytes
// of position and 8*L bytes of feature gradient per query and write the
// 64 MiB gradient table once, at 3.35 TB/s; its ~80 flops per query-level
// are far below the fp32 rate. What B2 loses against it is same-address
// atomics on the coarse levels' long runs. The design:
//  - one thread block per (level, 4096-query chunk), level fastest; a level
//    of scale <= SEG_SCALE_MAX finds the chunk's runs in shared memory
//    (block_hash_seg.cuh) from rows it computes itself;
//  - a chunk of at most CHUNK / NSEG_DIV runs hands each run to one warp:
//    lane k owns corner float2s k and k + 32 of the row, the run's queries
//    pass through the warp 32 at a time by shuffles, and each lane adds
//    their terms at its two float2s in registers, in query order, with no
//    atomic. Then each lane adds its nonzero sums to the table: at most 64
//    atomics per run, none of them contended within the run;
//  - a chunk with more runs, and every level above SEG_SCALE_MAX, takes
//    the per-query path of B2's design before its tile layout
//    (scatter_query: 8 float2 atomicAdds, one thread per query).
// The TPU kernel's devices (SMEM scalar streams, 8 VMEM accumulator copies,
// the MXU one-hot scatter of the dense pair, the split-bf16 lane broadcast)
// have no place here. fp32 atomics add in an order that changes from run to
// run, so the result is not bitwise reproducible.

#include "block_hash_seg.cuh"

__global__ void __launch_bounds__(THREADS)
block_hash_seg_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                          float2* __restrict__ grad, long long Q, int L, uint32_t B,
                          const Levels lv) {
  __shared__ SegScratch sc;
  const int l = (int)(blockIdx.x % L);
  const long long chunk0 = (long long)(blockIdx.x / L) * CHUNK;
  const int n = (int)min((long long)CHUNK, Q - chunk0);

  const int nseg = lv.runs[l] ? find_runs(x, chunk0, n, l, B, lv, sc) : -1;
  if (nseg < 0) {  // the per-query path
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const long long q = chunk0 + i;
      float p[3];
      load_point(x, q, p);
      if (!outside_unit_cube(p)) scatter_query(locate(p, l, B, lv), __ldg(g + q * L + l), grad);
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < nseg; s += WARPS) {
    const int a = sc.starts[s], e = sc.starts[s + 1];
    float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);  // float2s lane, lane + 32
    for (int base = a; base < e; base += 32) {
      Term t = {0, 0.f, 0.f, 0.f, make_float2(0.f, 0.f)};
      if (base + lane < e) {
        const long long q = chunk0 + base + lane;
        float p[3];
        load_point(x, q, p);
        t = make_term(locate(p, l, B, lv), !outside_unit_cube(p), g, q, L, l);
      }
      const int count = min(32, e - base);
      for (int u = 0; u < count; ++u) {
        const Term tu = shfl_term(FULL_MASK, t, u);
        add_corner_term(lo, lane, tu);
        add_corner_term(hi, lane + 32, tu);
      }
    }
    float2* row = grad + (size_t)sc.rows[a] * 64;
    flush_corner(row, lane, lo);
    flush_corner(row, lane + 32, hi);
  }
}

// Plain C entry point, as block_hash_bwd's, plus `runs` [L] (host): 1 where
// the level walks runs. `grad` must hold L*B*128 zeros. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int block_hash_seg_bwd(const float* x, const float* g, float* grad,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const long long blocks = (Q + CHUNK - 1) / CHUNK * L;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_hash_seg_bwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, reinterpret_cast<const float2*>(g), reinterpret_cast<float2*>(grad), Q, L,
      (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
