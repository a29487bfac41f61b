// Fused bias-free ReLU MLP (inference), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/fused_mlp.py::fused_mlp_inference
// (B5, body _make_kernel): h = relu(h.astype(w.dtype) @ w) layer by layer
// with float32 sums, then the final activation (none / relu / sigmoid) and a
// float32 store. With bfloat16 weights each layer's input is rounded to
// bfloat16 (to nearest even, after the ReLU) and the products of two
// bfloat16 values are exact in float32, as `preferred_element_type=
// jnp.float32` computes them. The plain PyTorch version of the same function
// is lidarnerf_tpu_torch/ops/fused_mlp.py::mlp_reference. The ReLU keeps a
// NaN, as torch.relu and jnp.maximum do.
//
// Bound: bytes, on tensor cores. The sigma net (32 -> 64 -> 16) at
// Q = 3,145,728 rows moves 192 B a row (604 MB, 0.180 ms at 3.35 TB/s) and
// does 19.3 GFLOP: 0.020 ms on bf16 tensor cores, 0.288 ms on the float32
// CUDA cores; the LiDAR head (90 -> 64 -> 64 -> 2) at Q = 3,407,872 moves
// 1.25 GB (0.374 ms) and does 68.1 GFLOP (0.069 ms bf16, 1.016 ms float32).
//
// bfloat16 weights: tensor cores (mma.sync m16n8k16, bf16 in, float32 sums).
//  - A persistent grid: every block stages each layer's weights once, as
//    bf16 B fragments (K padded to 16 and N to 8 with zeros), in the order in
//    which a lane reads its fragment of one (k-step, n-tile) with one
//    conflict-free 8-byte load.
//  - Each warp walks its own tiles of TILE_ROWS = 16 rows (one m16 tile, one
//    contiguous run of x) through its own ring of 2 to TC_STAGES slots (as
//    many as keep two blocks an SM resident), filled with 16-byte cp.async.cg copies
//    (zero-filled past the end of x, never beyond it) while it computes the
//    tile before: no block-wide barrier after the weights. x must be 16-byte
//    aligned for the copies: the wrapper copies an x that is not (a view
//    such as x[1:]) once, and the C entry point refuses it.
//  - Layer 0 reads its A fragments from the slot as float2 and rounds them to
//    bf16 in registers; the K padding reads as zero whatever the slot holds
//    there (packed rows put the next row's input in those columns, and zero
//    weights would not make an Inf or a NaN harmless).
//  - A hidden layer at most REG_WIDTH wide keeps its output in registers: the
//    16 x 8 float32 accumulators of two adjacent n-tiles are, after the ReLU
//    and a bf16 rounding of each pair (cvt.rn.bf16x2), exactly the next
//    layer's A fragment for one k-step. A wider hidden layer writes its
//    rounded output to a per-warp bf16 buffer, 64 columns at a time, which
//    the next layer reads back with ldmatrix; two wide layers in a row take
//    turns with two buffers. The routes are chosen per layer by width.
//  - The last layer applies the final activation in registers and stores
//    from the fragments (float2 per lane where the width is even), only the
//    first dL columns and only rows < Q.
//  - The model's two nets (sigma net, LiDAR head) run instances compiled for
//    their padded widths and activation (FixedChain): every loop unrolls and
//    no width is tested in a branch. Any other chain runs GenericChain,
//    whose widths are known at run time.
//  Measured at the model's shapes on an H100 (tools/torch_fused_mlp_designs.py):
//  the sigma net 0.24 ms, the LiDAR head 0.47 ms, about 75% and 80% of the
//  bytes bound; the head's input loads alone took 0.45 ms of it (PERF.md).
//
// float32 weights: CUDA cores, since a TF32 product would not keep float32's
// precision. A block walks tiles of ROWS rows with every layer's weights
// staged once as float32 (padded to 4 columns: float4 reads), activations in
// two shared-memory buffers at an odd stride, and an RT x 4 register tile of
// one fma per product for each thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_mlp_plan.cuh"

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

struct Net {
  const void* w[MAX_LAYERS];  // layer i: [dims[i], dims[i+1]] row-major, float or bfloat16
  int dims[MAX_LAYERS + 1];
  int n_layers;
};

__device__ __forceinline__ float relu(float h) { return h < 0.f ? 0.f : h; }  // keeps a NaN

template <int ACT>
__device__ __forceinline__ float activate(float h) {
  if (ACT == ACT_RELU) return relu(h);
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-h));
  return h;
}

__device__ __forceinline__ float activate(float h, int act) {
  if (act == ACT_RELU) return relu(h);
  if (act == ACT_SIGMOID) return 1.f / (1.f + expf(-h));
  return h;
}

// ---------------------------------------------------------------------------
// float32 weights: CUDA cores

__device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// One layer on a tile: o = in @ w, in [ROWS, din] at stride S, w [din, dpad].
// Hidden layers store relu(sum) at stride S; the last layer stores
// activate(sum) compact, at stride dout.
template <int RT>
__device__ __forceinline__ void layer_f32(const float* __restrict__ in, float* __restrict__ o,
                                          const float* __restrict__ w, int din, int dout, int S,
                                          bool last, int act) {
  constexpr int NRT = ROWS / RT;  // row tiles; a thread's rows are rt, rt + NRT, ...
  const int dpad = pad4(dout);
  const int tiles = NRT * (dpad / 4);
  for (int t = threadIdx.x; t < tiles; t += THREADS) {
    const int rt = t % NRT, ct = t / NRT;
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    const float* a_col = in + rt * S;
    const float* b_row = w + 4 * ct;
    for (int k = 0; k < din; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(b_row + k * dpad);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float a = a_col[r * NRT * S + k];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = rt + r * NRT;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * ct + c;
        if (j >= dout) continue;
        if (last)
          o[row * dout + j] = activate(acc[r][c], act);
        else
          o[row * S + j] = relu(acc[r][c]);
      }
    }
  }
}

__device__ __forceinline__ void run_layer_f32(const float* in, float* o, const float* w, int din,
                                              int dout, int S, bool last, int act) {
  // the largest row tile that still gives every thread a tile of the layer
  const int nct = pad4(dout) / 4;
  if ((ROWS / 4) * nct >= THREADS)
    layer_f32<4>(in, o, w, din, dout, S, last, act);
  else if ((ROWS / 2) * nct >= THREADS)
    layer_f32<2>(in, o, w, din, dout, S, last, act);
  else
    layer_f32<1>(in, o, w, din, dout, S, last, act);
}

__global__ void __launch_bounds__(THREADS)
fused_mlp_f32_kernel(const float* __restrict__ x, float* __restrict__ out, long long Q,
                     const Net net, int S, int act) {
  extern __shared__ __align__(16) float smem[];
  const int L = net.n_layers;

  // every layer's weights, once per block: layer i as [din, pad4(dout)], in order
  int total = 0;
  for (int i = 0; i < L; ++i) {
    const int din = net.dims[i], dout = net.dims[i + 1], dpad = pad4(dout);
    const float* w = static_cast<const float*>(net.w[i]);
    for (int e = threadIdx.x; e < din * dpad; e += THREADS) {
      const int k = e / dpad, j = e - k * dpad;
      smem[total + e] = j < dout ? w[k * dout + j] : 0.f;
    }
    total += din * dpad;
  }
  float* buf0 = smem + total;  // total is a multiple of 4: float4-aligned
  float* buf1 = buf0 + ROWS * S;
  const int d0 = net.dims[0], dl = net.dims[L];

  const long long n_tiles = (Q + ROWS - 1) / ROWS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * ROWS;
    const int n_in = (int)min((long long)ROWS, Q - row0) * d0;
    __syncthreads();  // weights staged; the previous tile's output stored
    // the tile's rows are one contiguous run of x: coalesced loads
    const float* xt = x + row0 * d0;
    for (int e = threadIdx.x; e < ROWS * d0; e += THREADS) {
      const int r = e / d0, k = e - r * d0;
      buf0[r * S + k] = e < n_in ? xt[e] : 0.f;
    }
    __syncthreads();
    float* in = buf0;
    float* o = buf1;
    const float* w = smem;
    for (int i = 0; i < L; ++i) {
      run_layer_f32(in, o, w, net.dims[i], net.dims[i + 1], S, i == L - 1, act);
      w += net.dims[i] * pad4(net.dims[i + 1]);
      __syncthreads();
      float* t = in;
      in = o;
      o = t;
    }
    // `in` holds the tile's output compact, [rows, dl]: one contiguous store
    float* ot = out + row0 * dl;
    const int n_out = n_in / d0 * dl;
    for (int e = threadIdx.x; e < n_out; e += THREADS) ot[e] = in[e];
  }
}

// ---------------------------------------------------------------------------
// bfloat16 weights: tensor cores

constexpr int SRC_STAGE = -1;  // layer 0's input: the ring slot

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, of which the first `bytes` are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (< TC_STAGES) of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  static_assert(TC_STAGES >= 2 && TC_STAGES <= 6, "a ring of 2 to 6 slots: the cases below");
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<0>();
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32; lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16 x 16, row) x b (16 x 8, col): bf16 products, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Copy tile `tile` of x (TILE_ROWS rows, fewer at the end) into a ring slot
// at row stride S, then commit the group; a tile past the end commits an
// empty group, so that a lane's count of pending groups keeps its meaning.
__device__ __forceinline__ void issue_tile(float* slot, const float* __restrict__ x,
                                           long long tile, long long n_tiles, long long Q, int d0,
                                           int S, int lane) {
  if (tile < n_tiles) {
    const long long row0 = tile * TILE_ROWS;
    const int n = (int)min((long long)TILE_ROWS, Q - row0) * d0;  // floats of the tile
    const float* src = x + row0 * d0;  // 16-byte aligned: a tile is 64 * d0 bytes
    for (int e = 4 * lane; e < n; e += 128) {
      // with S != d0, d0 is a multiple of 4 and a copy stays in one row
      float* dst = slot + e;
      if (S != d0) {
        const int r = e / d0;
        dst = slot + r * S + (e - r * d0);
      }
      cp_async16(dst, src + e, min(16, 4 * (n - e)));
    }
  }
  cp_async_commit();
}

// columns c, c + 1 of a staged row as float2; columns >= d0 (K's padding)
// read as zero, whatever the slot holds there
__device__ __forceinline__ float2 stage_pair(const float* row, int c, int d0) {
  if ((d0 & 1) == 0)  // S is even, c even: one aligned float2
    return c < d0 ? *reinterpret_cast<const float2*>(row + c) : make_float2(0.f, 0.f);
  return make_float2(c < d0 ? row[c] : 0.f, c + 1 < d0 ? row[c + 1] : 0.f);
}

// A fragment of k-step k0 from the ring slot: rows g, g + 8, columns
// k0 + 2t, +1, +8, +9, rounded to bf16
__device__ __forceinline__ void stage_frags(uint32_t (&af)[4], const float* slot, int S, int d0,
                                            int k0, int lane) {
  const int c = k0 + 2 * (lane & 3);
  const float* r0 = slot + (lane >> 2) * S;
  const float* r1 = r0 + 8 * S;
  float2 v = stage_pair(r0, c, d0);
  af[0] = pack_bf16(v.x, v.y);
  v = stage_pair(r1, c, d0);
  af[1] = pack_bf16(v.x, v.y);
  v = stage_pair(r0, c + 8, d0);
  af[2] = pack_bf16(v.x, v.y);
  v = stage_pair(r1, c + 8, d0);
  af[3] = pack_bf16(v.x, v.y);
}

// A fragment of k-step k0 from a wide buffer: lanes 0-15 address rows 0-15
// at column k0, lanes 16-31 the same rows at k0 + 8
__device__ __forceinline__ void buf_frags(uint32_t (&af)[4], const __nv_bfloat16* buf, int BS,
                                          int k0, int lane) {
  ldmatrix_x4(af, buf + (lane & 15) * BS + k0 + (lane >> 4) * 8);
}

// acc[j] += A x B(j) for the n-tiles j < nc (nc = NT where the widths are
// compile-time); wf: the first of their fragments at this k-step
template <int NT>
__device__ __forceinline__ void mma_kstep(float (&acc)[NT][4], const uint32_t (&af)[4],
                                          const uint2* __restrict__ wf, int nc, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nc) mma_bf16(acc[j], af, wf[j * 32 + lane]);
}

// A hidden layer's output into registers as the next layer's A fragments:
// n-tiles 2k and 2k + 1 make k-step k. The ReLU, then one bf16 rounding;
// columns >= dout (K's padding for the next layer) are zero.
template <int NT>
__device__ __forceinline__ void to_regs(uint32_t (&a)[4][4], const float (&acc)[NT][4], int dout,
                                        int lane) {
  static_assert(NT <= 8, "a layer's output in registers is at most 8 n-tiles");
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT + (NT & 1); ++j) {  // an odd NT leaves the k-step's second half zero
    const float* v = acc[j < NT ? j : 0];
    const bool in0 = j < NT && 8 * j + c < dout, in1 = j < NT && 8 * j + c + 1 < dout;
    a[j >> 1][(j & 1) * 2] = pack_bf16(in0 ? relu(v[0]) : 0.f, in1 ? relu(v[1]) : 0.f);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(in0 ? relu(v[2]) : 0.f, in1 ? relu(v[3]) : 0.f);
  }
}

// A wide hidden layer's chunk of n-tiles n0.. into a bf16 buffer, as to_regs
// rounds it, with the columns up to the next layer's padded K
__device__ __forceinline__ void to_buf(__nv_bfloat16* buf, int BS, const float (&acc)[8][4],
                                       int n0, int dout, int lane) {
  const int c = 2 * (lane & 3), kpad = fused_mlp_pad(dout, 16);
  __nv_bfloat16* r0 = buf + (lane >> 2) * BS;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * (n0 + j) + c;
    if (8 * (n0 + j) < kpad) {
      const bool in0 = col < dout, in1 = col + 1 < dout;
      *reinterpret_cast<uint32_t*>(r0 + col) =
          pack_bf16(in0 ? relu(acc[j][0]) : 0.f, in1 ? relu(acc[j][1]) : 0.f);
      *reinterpret_cast<uint32_t*>(r0 + 8 * BS + col) =
          pack_bf16(in0 ? relu(acc[j][2]) : 0.f, in1 ? relu(acc[j][3]) : 0.f);
    }
  }
}

// The last layer's n-tiles n0..n0 + NT - 1: the final activation, then the
// first dl columns of the rows < Q
template <int NT, int ACT>
__device__ __forceinline__ void to_out(float* __restrict__ out, long long row0, long long Q, int dl,
                                       const float (&acc)[NT][4], int n0, int lane) {
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + (lane >> 2) + 8 * h;
    if (r >= Q) continue;
    float* o = out + r * dl;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * (n0 + j) + c;
      if (col >= dl) continue;
      const float v0 = activate<ACT>(acc[j][2 * h]);
      if ((dl & 1) == 0) {  // col even: an aligned float2
        *reinterpret_cast<float2*>(o + col) = make_float2(v0, activate<ACT>(acc[j][2 * h + 1]));
      } else {
        o[col] = v0;
        if (col + 1 < dl) o[col + 1] = activate<ACT>(acc[j][2 * h + 1]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void store_out(float* __restrict__ out, long long row0, long long Q,
                                          int dl, const float (&acc)[NT][4], int n0, int act,
                                          int lane) {
  if (act == ACT_SIGMOID)
    to_out<NT, ACT_SIGMOID>(out, row0, Q, dl, acc, n0, lane);
  else if (act == ACT_RELU)
    to_out<NT, ACT_RELU>(out, row0, Q, dl, acc, n0, lane);
  else
    to_out<NT, ACT_NONE>(out, row0, Q, dl, acc, n0, lane);
}

// Any chain: widths known at run time. Hidden layers at most REG_WIDTH wide
// keep their output in registers, wider ones in a wide buffer; each layer is
// computed 8 n-tiles (64 columns) at a time.
struct GenericChain {
  __device__ static __forceinline__ void run(const float* slot, __nv_bfloat16* buf0,
                                             __nv_bfloat16* buf1, const uint2* wfrag,
                                             const Net& net, const TcPlan& p,
                                             float* __restrict__ out, long long row0, long long Q,
                                             int act, int lane) {
    uint32_t a[4][4];  // a layer's input in registers: K <= 64
    int src = SRC_STAGE;
    for (int i = 0; i < net.n_layers; ++i) {
      const int KS = p.ks[i], NT = p.nt[i], dst = p.route[i], dout = net.dims[i + 1];
      const uint2* wl = wfrag + p.wofs[i] * 32;
      const __nv_bfloat16* bin = src == OUT_BUF1 ? buf1 : buf0;
      __nv_bfloat16* bout = dst == OUT_BUF1 ? buf1 : buf0;
      if (dst == OUT_BUF0 || dst == OUT_BUF1) __syncwarp();  // the buffer's last reads are done
      for (int n0 = 0; n0 < NT; n0 += 8) {
        const int nc = min(8, NT - n0);
        float acc[8][4] = {};
        if (src == OUT_REGS) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (ks < KS) mma_kstep<8>(acc, a[ks], wl + (ks * NT + n0) * 32, nc, lane);
        } else {
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t af[4];
            if (src == SRC_STAGE)
              stage_frags(af, slot, p.S, net.dims[0], 16 * ks, lane);
            else
              buf_frags(af, bin, p.BS, 16 * ks, lane);
            mma_kstep<8>(acc, af, wl + (ks * NT + n0) * 32, nc, lane);
          }
        }
        if (dst == OUT_GLOBAL)
          store_out<8>(out, row0, Q, dout, acc, n0, act, lane);
        else if (dst == OUT_REGS)
          to_regs<8>(a, acc, dout, lane);  // NT <= 8: one chunk, and `a` is read no more
        else
          to_buf(bout, p.BS, acc, n0, dout, lane);
      }
      if (dst == OUT_BUF0 || dst == OUT_BUF1) __syncwarp();  // the buffer's writes before ldmatrix
      src = dst;
    }
  }
};

// Layer I.. of a FixedChain, input in registers: KS k-steps, NT n-tiles,
// REST the n-tiles of the layers after it
template <int ACT, int I, int KS, int NT, int... REST>
__device__ __forceinline__ void fixed_layers(uint32_t (&a)[4][4], const uint2* wfrag,
                                             const Net& net, const TcPlan& p,
                                             float* __restrict__ out, long long row0, long long Q,
                                             int lane) {
  float acc[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    mma_kstep<NT>(acc, a[ks], wfrag + (p.wofs[I] + ks * NT) * 32, NT, lane);
  if constexpr (sizeof...(REST) == 0) {
    to_out<NT, ACT>(out, row0, Q, net.dims[I + 1], acc, 0, lane);
  } else {
    to_regs<NT>(a, acc, net.dims[I + 1], lane);
    fixed_layers<ACT, I + 1, (NT + 1) / 2, REST...>(a, wfrag, net, p, out, row0, Q, lane);
  }
}

// A chain whose padded widths and final activation are compile-time (the
// register route templated on them): layer 0 has KS0 k-steps and NT n-tiles,
// REST the later layers' n-tiles, every hidden layer at most 8 n-tiles.
// Fragment arrays have fixed sizes and every loop unrolls with no test of a
// width; the exact widths still mask the padding at run time.
template <int ACT, int KS0, int NT, int... REST>
struct FixedChain {
  __device__ static __forceinline__ void run(const float* slot, __nv_bfloat16*, __nv_bfloat16*,
                                             const uint2* wfrag, const Net& net, const TcPlan& p,
                                             float* __restrict__ out, long long row0, long long Q,
                                             int act, int lane) {
    float acc[NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS0; ++ks) {
      uint32_t af[4];
      stage_frags(af, slot, p.S, net.dims[0], 16 * ks, lane);
      mma_kstep<NT>(acc, af, wfrag + ks * NT * 32, NT, lane);
    }
    if constexpr (sizeof...(REST) == 0) {
      to_out<NT, ACT>(out, row0, Q, net.dims[1], acc, 0, lane);
    } else {
      uint32_t a[4][4];
      to_regs<NT>(a, acc, net.dims[1], lane);
      fixed_layers<ACT, 1, (NT + 1) / 2, REST...>(a, wfrag, net, p, out, row0, Q, lane);
    }
  }
};

// the model's nets by final activation, k-steps and n-tiles: the sigma net
// (32 -> 64 -> 16, none) and the LiDAR head (90 -> 64 -> 64 -> 2, sigmoid)
using SigmaChain = FixedChain<ACT_NONE, 2, 8, 2>;
using HeadChain = FixedChain<ACT_SIGMOID, 6, 8, 8, 1>;

template <class Chain>
__global__ void __launch_bounds__(TC_WARPS * 32)
fused_mlp_tc_kernel(const float* __restrict__ x, float* __restrict__ out, long long Q,
                    const Net net, const TcPlan p, int act) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  uint2* wfrag = reinterpret_cast<uint2*>(smem_tc);

  // every layer's B fragments, once per block: fragment f = (k-step f / nt,
  // n-tile f % nt) of layer i, lane l's 8 bytes at 32 f + l: rows k = 2t, 2t + 1
  // (b0) and 2t + 8, 2t + 9 (b1) of its k-step, column g of its n-tile
  for (int i = 0; i < net.n_layers; ++i) {
    const int din = net.dims[i], dout = net.dims[i + 1], NT = p.nt[i];
    const unsigned short* w = static_cast<const unsigned short*>(net.w[i]);
    for (int e = threadIdx.x; e < p.ks[i] * NT * 32; e += blockDim.x) {
      const int f = e >> 5, l = e & 31;
      const int k = 16 * (f / NT) + 2 * (l & 3), n = 8 * (f % NT) + (l >> 2);
      auto at = [&](int kk) -> uint32_t {
        return kk < din && n < dout ? (uint32_t)w[kk * dout + n] : 0u;
      };
      wfrag[p.wofs[i] * 32 + e] = make_uint2(at(k) | at(k + 1) << 16, at(k + 8) | at(k + 9) << 16);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = smem_tc + p.wbytes + warp * p.warp_bytes;
  float* ring = reinterpret_cast<float*>(mine);
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(mine + 4 * p.stages * TILE_ROWS * p.S);
  __nv_bfloat16* buf1 = buf0 + TILE_ROWS * p.BS;
  const int d0 = net.dims[0], slot_floats = TILE_ROWS * p.S;
  const long long n_tiles = (Q + TILE_ROWS - 1) / TILE_ROWS;
  const long long first = (long long)blockIdx.x * p.warps + warp;
  const long long step = (long long)gridDim.x * p.warps;

  // this warp's tiles are first, first + step, ...; the ring runs p.stages - 1 ahead
  for (int s = 0; s < p.stages - 1; ++s)
    issue_tile(ring + s * slot_floats, x, first + s * step, n_tiles, Q, d0, p.S, lane);
  int slot = 0;
  for (long long tile = first; tile < n_tiles; tile += step) {
    const int ahead = slot == 0 ? p.stages - 1 : slot - 1;  // the slot computed last time
    issue_tile(ring + ahead * slot_floats, x, tile + (p.stages - 1) * step, n_tiles, Q, d0, p.S,
               lane);
    cp_async_wait_pending(p.stages - 1);  // this tile's group has landed
    __syncwarp();
    Chain::run(ring + slot * slot_floats, buf0, buf1, wfrag, net, p, out, tile * TILE_ROWS, Q,
               act, lane);
    __syncwarp();  // every lane is done with the slot before it is filled again
    slot = slot + 1 == p.stages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// The instance for a plan: a FixedChain where the padded widths and the
// activation are one, else the generic chain
static const void* tc_kernel(const TcPlan& p, int L, int act) {
  if (act == ACT_NONE && L == 2 && p.ks[0] == 2 && p.nt[0] == 8 && p.nt[1] == 2)
    return (const void*)fused_mlp_tc_kernel<SigmaChain>;
  if (act == ACT_SIGMOID && L == 3 && p.ks[0] == 6 && p.nt[0] == 8 && p.nt[1] == 8 &&
      p.nt[2] == 1)
    return (const void*)fused_mlp_tc_kernel<HeadChain>;
  return (const void*)fused_mlp_tc_kernel<GenericChain>;
}

// ---------------------------------------------------------------------------
// host side

static int max_blocks(const void* kernel, int threads, int smem, int* per_sm, int* sms) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// Checks the shape and fills `net`; returns 0 or cudaErrorInvalidValue.
static int make_net(const void* const* w, const int* dims, int L, Net* net) {
  if (L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= L; ++i) {
    if (dims[i] < 1 || dims[i] > MAX_WIDTH) return (int)cudaErrorInvalidValue;
    net->dims[i] = dims[i];
  }
  for (int i = 0; i < L; ++i) net->w[i] = w ? w[i] : nullptr;
  net->n_layers = L;
  return 0;
}

// A launch of a chain: its kernel, threads and shared memory per block, and
// the plan of its route
struct Launch {
  const void* kernel;
  int threads;
  long long smem;
  int S;      // float32 route: the activation buffers' row stride
  TcPlan p;   // tensor-core route
};

// Fills `l` for `dims`; cudaErrorInvalidValue for a chain the kernels do not take.
static int plan_launch(const int* dims, int L, int bf16, int act, Net* net,
                       const void* const* w, Launch* l) {
  if (make_net(w, dims, L, net)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    l->smem = fused_mlp_tc_smem(dims, L, &l->p);
    l->kernel = tc_kernel(l->p, L, act);
    l->threads = 32 * l->p.warps;
  } else {
    l->smem = fused_mlp_f32_smem(dims, L, &l->S);
    l->kernel = (const void*)fused_mlp_f32_kernel;
    l->threads = THREADS;
  }
  return l->smem > SMEM_LIMIT ? (int)cudaErrorInvalidValue : 0;
}

// Plain C entry point. x [Q, dims[0]] float32, out [Q, dims[L]] float32, w[i]
// [dims[i], dims[i+1]] row-major float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// all contiguous on the current device; with bf16 = 1, x 16-byte and out
// 8-byte aligned. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for a shape or alignment it does not take.
extern "C" int fused_mlp(const float* x, float* out, long long Q, const void* const* w,
                         const int* dims, int L, int bf16, int act, void* stream) {
  Net net;
  Launch l;
  if (plan_launch(dims, L, bf16, act, &net, w, &l) || Q < 0 || act < ACT_NONE ||
      act > ACT_SIGMOID)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  if (bf16 && ((uintptr_t)x % 16 || (uintptr_t)out % 8)) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0, err = 0;
  if ((err = max_blocks(l.kernel, l.threads, (int)l.smem, &per_sm, &sms))) return err;
  const long long rows = bf16 ? TILE_ROWS * l.p.warps : ROWS;  // a block's rows at once
  const long long blocks = (Q + rows - 1) / rows, most = (long long)per_sm * sms;
  void* tc_args[] = {&x, &out, &Q, &net, &l.p, &act};
  void* f32_args[] = {&x, &out, &Q, &net, &l.S, &act};
  if ((err = (int)cudaLaunchKernel(l.kernel, dim3((unsigned)(blocks < most ? blocks : most)),
                                   dim3(l.threads), bf16 ? tc_args : f32_args, (size_t)l.smem,
                                   (cudaStream_t)stream)))
    return err;
  return (int)cudaGetLastError();
}

// What a launch of `dims` with final activation `act` gets: info = {registers per thread, local bytes per
// thread (stack frame and spills), threads per block, shared bytes per block,
// blocks per SM}.
extern "C" int fused_mlp_occupancy(const int* dims, int L, int bf16, int act, int* info) {
  Net net;
  Launch l;
  int per_sm = 0, sms = 0, err = 0;
  if ((err = plan_launch(dims, L, bf16, act, &net, nullptr, &l))) return err;
  cudaFuncAttributes attr;
  if ((err = (int)cudaFuncGetAttributes(&attr, l.kernel))) return err;
  if ((err = max_blocks(l.kernel, l.threads, (int)l.smem, &per_sm, &sms))) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = l.threads;
  info[3] = (int)l.smem;
  info[4] = per_sm;
  return 0;
}
