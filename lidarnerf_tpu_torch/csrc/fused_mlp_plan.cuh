// Launch plans of the fused-MLP kernel (csrc/fused_mlp.cu, B5): the limits,
// the shared memory of each route and the tensor-core route's layout, worked
// out on the host. Plain C++ (the one helper the kernels share is marked for
// the device only under nvcc), so that it also builds for a host without a
// GPU (tests/test_torch_fused_mlp.py). The wrapper's shared-memory check
// (ops/fused_mlp_cuda.py::smem_bytes) asks `fused_mlp_smem` below: there is
// one copy of the plan.
#pragma once

#define MAX_LAYERS 8
#define MAX_WIDTH 256
#define SMEM_LIMIT 232448  // 227 KB, the most a block may use on sm_90

// float32 weights, on the CUDA cores
#define ROWS 64
#define THREADS 256

// bfloat16 weights, on the tensor cores
#define TC_WARPS 8     // the most warps a block has
#define TC_STAGES 6    // the most slots of a warp's input ring
#define TILE_ROWS 16   // rows of a warp's tile: one m16 tile of the mma
#define REG_WIDTH 64   // a hidden layer at most this wide keeps its output in registers
#define SM_SMEM 233472       // 228 KB: the shared memory of an SM
#define BLOCK_RESERVED 1024  // shared memory the system keeps for each block

// Where a layer's output goes on the tensor-core route. OUT_BUF0 and OUT_BUF1
// are a warp's two bf16 buffers for wider hidden layers; their values count
// the buffers a plan needs.
enum { OUT_REGS = 0, OUT_BUF0 = 1, OUT_BUF1 = 2, OUT_GLOBAL = 3 };

struct TcPlan {
  int ks[MAX_LAYERS];     // k-steps of 16 of layer i's input
  int nt[MAX_LAYERS];     // n-tiles of 8 of layer i's output
  int wofs[MAX_LAYERS];   // layer i's first weight fragment (256 B each) in shared memory
  int route[MAX_LAYERS];  // OUT_* of layer i
  int S;                  // row stride of the input ring, floats
  int BS;                 // row stride of the wide buffers, bf16
  int nbuf;               // wide buffers a warp needs: 0, 1 or 2
  int stages;             // slots of a warp's input ring
  int warps;              // warps of a block
  int wbytes;             // bytes of the weight fragments
  int warp_bytes;         // bytes of one warp's ring and buffers
};

#ifdef __CUDACC__
#define FUSED_MLP_HD __host__ __device__
#else
#define FUSED_MLP_HD
#endif

FUSED_MLP_HD inline int fused_mlp_pad(int v, int m) { return (v + m - 1) / m * m; }

// A row stride for the input ring. Rows of a width that is a multiple of 4
// are placed at a stride = 8 (mod 16) floats, so that the 8 rows x 4 lanes of
// an A-fragment read (float2 per lane) fall in distinct banks; other widths
// stay packed, the tile being one contiguous run of x copied 16 bytes at a
// time, whose copies would cross rows.
static inline int fused_mlp_stage_stride(int d0) {
  return d0 % 4 ? d0 : d0 + (24 - d0 % 16) % 16;
}

// Float32 route: the padded weights and two [ROWS, S] activation buffers, S
// the widest layer rounded up to an odd number.
static inline long long fused_mlp_f32_smem(const int* dims, int L, int* S) {
  int widest = 0;
  long long w = 0;
  for (int i = 0; i <= L; ++i) widest = dims[i] > widest ? dims[i] : widest;
  for (int i = 0; i < L; ++i) w += (long long)dims[i] * fused_mlp_pad(dims[i + 1], 4);
  *S = widest | 1;
  return 4 * (w + 2LL * ROWS * *S);
}

// Tensor-core route: every layer's bf16 weight fragments, once per block,
// and for each warp a ring of input tiles ([TILE_ROWS, S] float32) and its
// wide buffers ([TILE_ROWS, BS] bf16). The ring has the most slots, from
// TC_STAGES down to 2, with which two blocks of TC_WARPS warps still fit in
// an SM: resident warps first (they hide the math's latency), then loads in
// flight. A block takes as many warps as fit, up to TC_WARPS, and at least
// one: a figure above SMEM_LIMIT means the net does not fit.
static inline long long fused_mlp_tc_smem(const int* dims, int L, TcPlan* p) {
  int frags = 0, wide = 0;
  p->nbuf = 0;
  for (int i = 0; i < L; ++i) {
    p->ks[i] = (dims[i] + 15) / 16;
    p->nt[i] = (dims[i + 1] + 7) / 8;
    p->wofs[i] = frags;
    frags += p->ks[i] * p->nt[i];
    if (i == L - 1) {
      p->route[i] = OUT_GLOBAL;
    } else if (dims[i + 1] <= REG_WIDTH) {
      p->route[i] = OUT_REGS;
    } else {  // two wide layers in a row take turns with the buffers
      p->route[i] = i > 0 && p->route[i - 1] == OUT_BUF0 ? OUT_BUF1 : OUT_BUF0;
      p->nbuf = p->route[i] > p->nbuf ? p->route[i] : p->nbuf;
      wide = dims[i + 1] > wide ? dims[i + 1] : wide;
    }
  }
  p->S = fused_mlp_stage_stride(dims[0]);
  p->BS = wide ? fused_mlp_pad(wide, 16) + 8 : 0;  // 8 more: ldmatrix's 8 rows in distinct banks
  p->wbytes = 256 * frags;
  const long long slot = 4LL * TILE_ROWS * p->S, bufs = 2LL * p->nbuf * TILE_ROWS * p->BS;
  p->stages = TC_STAGES;
  while (p->stages > 2 &&
         2 * (p->wbytes + TC_WARPS * (p->stages * slot + bufs) + BLOCK_RESERVED) > SM_SMEM)
    --p->stages;
  p->warp_bytes = (int)(p->stages * slot + bufs);
  const long long fit = (SMEM_LIMIT - (long long)p->wbytes) / p->warp_bytes;
  p->warps = fit < 1 ? 1 : fit > TC_WARPS ? TC_WARPS : (int)fit;
  return p->wbytes + (long long)p->warps * p->warp_bytes;
}

// The shared memory a block of the chain `dims` (L layers, widths 1 to
// MAX_WIDTH) takes on the route of its weights: bf16 = 1 the tensor cores,
// else the CUDA cores. Above SMEM_LIMIT the chain does not fit. Host only.
extern "C" long long fused_mlp_smem(const int* dims, int L, int bf16) {
  TcPlan p;
  int S;
  return bf16 ? fused_mlp_tc_smem(dims, L, &p) : fused_mlp_f32_smem(dims, L, &S);
}
