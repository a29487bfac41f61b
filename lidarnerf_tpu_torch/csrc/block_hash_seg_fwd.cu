// Block-hash grid encoder, forward by runs of equal rows (B3a), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_fwd_seg_from_prep
// (B3a), with its XLA-side prep (_prep_inputs, seg_next) fused in. It
// computes B1's function (block_hash_fwd.cu): per query and level, the
// trilinear interpolation of the cell's 8 corners inside one 128-float
// block row, zero outside [0, 1]^3. Consecutive queries are consecutive
// samples along a ray, so at the coarse levels long runs of them fall in
// one block row; this kernel loads such a run's row once. Its output equals
// B1's bit for bit (the same cell, weights and fma order, from
// block_hash_common.cuh). The plain PyTorch version of the same function is
// lidarnerf_tpu_torch/ops/block_hash.py::encode_plain.
//
// Bound: the same as B1's, device memory. The function must read 12 bytes
// of position and write 8*L bytes of features per query, plus the table
// rows it touches, at 3.35 TB/s; its ~60 flops per query-level are far below
// the fp32 rate. The design:
//  - one thread block per (level, 4096-query chunk), level fastest; a level
//    of scale <= SEG_SCALE_MAX (the host's `runs` array) finds the chunk's
//    runs in shared memory (block_hash_seg.cuh) from rows it computes itself;
//  - a chunk of at most CHUNK / NSEG_DIV runs hands each run to one warp,
//    which loads the run's 512-byte row once, one float4 per lane,
//    coalesced, into shared memory; every query of the run interpolates from
//    there;
//  - a chunk with more runs, and every level above SEG_SCALE_MAX, takes
//    the per-query path of B1's design before its tile layout
//    (encode_query: 8 corner float2 reads from the table);
//  - a block writes one level's feature pair per query, a 128-byte stride at
//    L = 16: the chunk's L blocks run together, so L2 merges the stores.
// The TPU kernel's devices (SMEM scalar streams, the split-bf16 MXU lane
// reduction) have no place here.

#include "block_hash_seg.cuh"

__global__ void __launch_bounds__(THREADS)
block_hash_seg_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                          float2* __restrict__ out, long long Q, int L, uint32_t B,
                          const Levels lv) {
  __shared__ SegScratch sc;
  __shared__ float4 row_buf[WARPS][32];  // one 512-byte table row per warp
  const int l = (int)(blockIdx.x % L);
  const long long chunk0 = (long long)(blockIdx.x / L) * CHUNK;
  const int n = (int)min((long long)CHUNK, Q - chunk0);
  const float2* table2 = reinterpret_cast<const float2*>(table);

  const int nseg = lv.runs[l] ? find_runs(x, chunk0, n, l, B, lv, sc) : -1;
  if (nseg < 0) {  // the per-query path
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const long long q = chunk0 + i;
      float p[3];
      load_point(x, q, p);
      out[q * L + l] = encode_query(p, l, B, lv, table2);
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float2* row = reinterpret_cast<const float2*>(row_buf[warp]);
  for (int s = warp; s < nseg; s += WARPS) {
    const int a = sc.starts[s], e = sc.starts[s + 1];
    row_buf[warp][lane] = __ldg(reinterpret_cast<const float4*>(table) + (size_t)sc.rows[a] * 32 + lane);
    __syncwarp();
    for (int i = a + lane; i < e; i += 32) {
      const long long q = chunk0 + i;
      float p[3];
      load_point(x, q, p);
      float2 o = make_float2(0.f, 0.f);
      if (!outside_unit_cube(p)) {
        const Cell c = locate(p, l, B, lv);
        const int off = (int)(c.corner0 & 63);
        o = trilerp(c, [&](int k) { return row[off + k]; });
      }
      out[q * L + l] = o;
    }
    __syncwarp();  // the row is read before the warp's next run replaces it
  }
}

// Plain C entry point, as block_hash_fwd's, plus `runs` [L] (host): 1 where
// the level walks runs. The table must be 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int block_hash_seg_fwd(const float* x, const float* table, float* out,
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
  block_hash_seg_fwd_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, table, reinterpret_cast<float2*>(out), Q, L, (uint32_t)B, lv);
  return (int)cudaGetLastError();
}
