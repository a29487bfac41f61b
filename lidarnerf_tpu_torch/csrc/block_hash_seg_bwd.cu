// Block-hash grid encoder, table gradient by runs of equal rows (B3b), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_bwd_seg_from_prep
// (B3b). It computes B2's function (block_hash_bwd.cu): for each query
// inside [0, 1]^3 and level l, w * (g[q, 2l], g[q, 2l+1]) added to each of
// the cell's 8 corner float2s, w the corner's trilinear weight, duplicates
// summed, into the [L*B, 128] float32 table gradient. A run of equal
// consecutive rows sums its terms first and adds them once per touched
// corner float2 of the row, where B2's plain path adds 8 per query. The
// plain PyTorch version with the same run rules is
// lidarnerf_tpu_torch/ops/block_hash.py::encode_bwd_seg_plain.
//
// Bound: the same as B2's, device memory. The function must read 12 bytes
// of position and 8*L bytes of feature gradient per query and write the
// 64 MiB gradient table once, at 3.35 TB/s; its ~80 flops per query-level
// are far below the fp32 rate. What a kernel loses against it is
// same-address atomics on the coarse levels' long runs. The design:
//  - one thread block per (level, 4096-query chunk), level fastest; a level
//    of scale <= SEG_SCALE_MAX finds the chunk's runs in shared memory
//    (find_runs) from rows it computes itself: the counterpart of the TPU
//    kernels' XLA-side prep `seg_next` (block_hash_pallas.py:446), whose
//    [L*Qp] rows, next and nseg arrays never go through device memory here;
//  - a chunk of at most CHUNK / NSEG_DIV runs hands each run to one warp:
//    lane k owns corner float2s k and k + 32 of the row, the run's queries
//    pass through the warp 32 at a time by shuffles, and each lane adds
//    their terms at its two float2s in registers, in query order. Then each
//    lane adds its nonzero sums to the table: at most 64 float2s per run,
//    none of them contended within the run;
//  - a chunk with more runs, and every level above SEG_SCALE_MAX, takes a
//    per-query path, one thread per query (scatter_query: its 8 corners);
//  - every add goes through the order-free fixed-point accumulator of
//    block_hash_scatter.cuh, so the table is the same bit for bit from run
//    to run.
// The TPU kernel's devices (SMEM scalar streams, 8 VMEM accumulator copies,
// the MXU one-hot scatter of the dense pair, the split-bf16 lane broadcast)
// have no place here.

#include "block_hash_common.cuh"
#include "block_hash_scatter.cuh"

#define MAX_RUNS (CHUNK / NSEG_DIV)  // a chunk with more runs takes the per-query path

struct SegScratch {
  uint32_t rows[CHUNK];     // the chunk's table rows at this level
  int starts[MAX_RUNS + 1];  // run s is [starts[s], starts[s + 1])
  int warp_count[WARPS];
};

// Finds the runs of equal consecutive rows among the chunk's n queries
// (chunk0 ... chunk0 + n - 1) at level l. Every thread of the block calls it
// and gets the same answer: the number of runs, with their starts in
// sc.starts and their rows in sc.rows[start], or -1 when the chunk has more
// than MAX_RUNS runs (block_hash_pallas.py:522,542: the per-chunk fallback).
// The plain PyTorch version of the run structure is
// lidarnerf_tpu_torch/ops/block_hash.py::seg_next.
__device__ __forceinline__ int find_runs(const float* __restrict__ x, long long chunk0, int n,
                                         int l, uint32_t B, const Levels& lv, SegScratch& sc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += THREADS) {
    float p[3];
    load_point(x, chunk0 + i, p);
    sc.rows[i] = (uint32_t)(locate(p, l, B, lv).corner0 >> 6);
  }
  __syncthreads();

  // warp w counts the run starts among queries [w * 512, (w + 1) * 512)
  constexpr int PER_WARP = CHUNK / WARPS;
  const int i0 = warp * PER_WARP;
  int count = 0;
  for (int k = 0; k < PER_WARP; k += 32) {
    const int i = i0 + k + lane;
    const bool start = i < n && (i == 0 || sc.rows[i] != sc.rows[i - 1]);
    count += __popc(__ballot_sync(FULL_MASK, start));
  }
  if (lane == 0) sc.warp_count[warp] = count;
  __syncthreads();
  int nseg = 0, base = 0;
  for (int w = 0; w < WARPS; ++w) {
    base += w < warp ? sc.warp_count[w] : 0;
    nseg += sc.warp_count[w];
  }
  if (nseg > MAX_RUNS) return -1;

  // second pass: each start goes to its rank among the chunk's starts
  for (int k = 0; k < PER_WARP; k += 32) {
    const int i = i0 + k + lane;
    const bool start = i < n && (i == 0 || sc.rows[i] != sc.rows[i - 1]);
    const unsigned ballot = __ballot_sync(FULL_MASK, start);
    if (start) sc.starts[base + __popc(ballot & ((1u << lane) - 1u))] = i;
    base += __popc(ballot);
  }
  if (tid == 0) sc.starts[nseg] = n;
  __syncthreads();
  return nseg;
}

// The per-query path for one (query, level) inside [0, 1]^3: w * g added
// to each of the cell's 8 corners.
__device__ __forceinline__ void scatter_query(const FixedAcc& a, const Cell& c, float2 gv) {
  check_finite(a, c.corner0, gv);
  float t[16];
  corner_terms(c, gv, t);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    add_pair(a, c.corner0 + offset_of_corner(k), make_float2(t[2 * k], t[2 * k + 1]));
}

// A query travels between the lanes of a run as its cell's corner offset
// in the row (`off`, from Cell::corner0 & 63), the fractions of its
// position (Cell::wx[1], wy[1], wz[1]) and its feature grads.
struct Term {
  int off;
  float fx, fy, fz;
  float2 g;
};

__device__ __forceinline__ Term shfl_term(const Term& t, int src) {
  Term r;
  r.off = __shfl_sync(FULL_MASK, t.off, src);
  r.fx = __shfl_sync(FULL_MASK, t.fx, src);
  r.fy = __shfl_sync(FULL_MASK, t.fy, src);
  r.fz = __shfl_sync(FULL_MASK, t.fz, src);
  r.g.x = __shfl_sync(FULL_MASK, t.g.x, src);
  r.g.y = __shfl_sync(FULL_MASK, t.g.y, src);
  return r;
}

// Adds a query's term at corner float2 `s` of its row (0 <= s < 64) to
// `acc`: w * g with w its trilinear weight there, the products of
// corner_terms, or nothing if s is not a corner of its cell.
__device__ __forceinline__ void add_corner_term(float2& acc, int s, const Term& t) {
  const int dx = (s >> 4) - (t.off >> 4);
  const int dy = ((s >> 2) & 3) - ((t.off >> 2) & 3);
  const int dz = (s & 3) - (t.off & 3);
  if ((unsigned)dx > 1u || (unsigned)dy > 1u || (unsigned)dz > 1u) return;
  const float wx = dx ? t.fx : 1.f - t.fx;
  const float wy = dy ? t.fy : 1.f - t.fy;
  const float wz = dz ? t.fz : 1.f - t.fz;
  const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, t.g.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, t.g.y));
}

// The term of query q at level l: zero grads outside [0, 1]^3 (the JAX
// package zeroes those grads before its backward).
__device__ __forceinline__ Term make_term(const Cell& c, bool inside, const float2* __restrict__ g,
                                          long long q, int L, int l) {
  Term t;
  t.off = (int)(c.corner0 & 63);
  t.fx = c.wx[1];
  t.fy = c.wy[1];
  t.fz = c.wz[1];
  t.g = inside ? __ldg(g + q * L + l) : make_float2(0.f, 0.f);
  return t;
}

__global__ void __launch_bounds__(THREADS)
block_hash_seg_bwd_kernel(const float* __restrict__ x, const float2* __restrict__ g,
                          unsigned long long* __restrict__ sums, float* __restrict__ grad,
                          const unsigned* __restrict__ max_bits, long long Q, int L, uint32_t B,
                          const Levels lv) {
  __shared__ SegScratch sc;
  const int l = (int)(blockIdx.x % L);
  const long long chunk0 = (long long)(blockIdx.x / L) * CHUNK;
  const int n = (int)min((long long)CHUNK, Q - chunk0);
  const FixedAcc a = fixed_acc(sums, grad, max_bits, Q);

  const int nseg = lv.runs[l] ? find_runs(x, chunk0, n, l, B, lv, sc) : -1;
  if (nseg < 0) {  // the per-query path
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const long long q = chunk0 + i;
      float p[3];
      load_point(x, q, p);
      if (!outside_unit_cube(p)) scatter_query(a, locate(p, l, B, lv), __ldg(g + q * L + l));
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < nseg; s += WARPS) {
    const int a0 = sc.starts[s], e = sc.starts[s + 1];
    float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);  // float2s lane, lane + 32
    for (int base = a0; base < e; base += 32) {
      Term t = {0, 0.f, 0.f, 0.f, make_float2(0.f, 0.f)};
      if (base + lane < e) {
        const long long q = chunk0 + base + lane;
        float p[3];
        load_point(x, q, p);
        const Cell c = locate(p, l, B, lv);
        t = make_term(c, !outside_unit_cube(p), g, q, L, l);
        check_finite(a, c.corner0, t.g);
      }
      const int count = min(32, e - base);
      for (int u = 0; u < count; ++u) {
        const Term tu = shfl_term(t, u);
        add_corner_term(lo, lane, tu);
        add_corner_term(hi, lane + 32, tu);
      }
    }
    const size_t row0 = (size_t)sc.rows[a0] * 64;  // the row's first float2
    add_pair(a, row0 + lane, lo);
    add_pair(a, row0 + lane + 32, hi);
  }
}

// Plain C entry point, as block_hash_bwd's, plus `runs` [L] (host): 1 where
// the level walks runs. Returns the first CUDA error (0 on success).
extern "C" int block_hash_seg_bwd(const float* x, const float* g, float* grad, void* scratch,
                                  long long Q, int L, int B, const float* scale,
                                  const int* max_cell, const int* blocks_axis,
                                  const int* dense, const int* runs, void* stream) {
  Levels lv;
  if (B < 1 || Q < 0 || L % 2 != 0 ||
      !fill_levels(&lv, L, scale, max_cell, blocks_axis, dense, runs) ||
      reinterpret_cast<uintptr_t>(grad) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (Q + CHUNK - 1) / CHUNK * L;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return run_fixed(g, grad, scratch, Q, L, (uint32_t)B, s,
                   [&](unsigned long long* sums, const unsigned* max_bits) {
                     block_hash_seg_bwd_kernel<<<(unsigned int)blocks, THREADS, 0, s>>>(
                         x, reinterpret_cast<const float2*>(g), sums, grad, max_bits, Q, L,
                         (uint32_t)B, lv);
                     return cudaGetLastError();
                   });
}
