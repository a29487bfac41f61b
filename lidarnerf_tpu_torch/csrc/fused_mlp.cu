// Fused bias-free ReLU MLP (inference), for Hopper (sm_90a).
//
// Replaces the TPU kernel lidarnerf_tpu/ops/fused_mlp.py::fused_mlp_inference
// (B5, body _make_kernel): h = relu(h.astype(w.dtype) @ w) layer by layer
// with float32 sums, then the final activation (none / relu / sigmoid) and a
// float32 store. With bfloat16 weights each layer's input is rounded to
// bfloat16 and the products of two bfloat16 values are exact in float32, as
// `preferred_element_type=jnp.float32` computes them. The plain PyTorch
// version of the same function is
// lidarnerf_tpu_torch/ops/fused_mlp.py::mlp_reference.
//
// Bound: at the model's shapes it is bytes-bound only on tensor cores. The
// sigma net (32 -> 64 -> 16) at Q = 3,145,728 rows moves 192 B a row
// (604 MB, 0.180 ms at 3.35 TB/s) and does 19.3 GFLOP: 0.020 ms on bf16
// tensor cores, 0.288 ms on the float32 CUDA cores this kernel uses; the
// LiDAR head (90 -> 64 -> 64 -> 2) at Q = 3,407,872 moves 1.25 GB (0.374 ms)
// and does 68.1 GFLOP (0.069 ms bf16, 1.016 ms float32). So this route is
// operations-bound. The design keeps everything but the input and the
// output out of device memory:
//  - a persistent grid (as many blocks as fit on the card) stages every
//    layer's weights once per block in shared memory, as float32 (bfloat16
//    widens exactly), each layer padded to a multiple of 4 columns so a
//    thread reads 4 weights as one float4;
//  - a block walks tiles of 64 rows: the tile's input is one contiguous
//    run of x, read coalesced into shared memory; activations stay there
//    between layers (two buffers, rows at an odd stride so the 32 rows a
//    warp reads at one depth fall in 32 banks);
//  - a thread computes an RT x 4 register tile of a layer's output (RT = 4,
//    2 or 1, the largest that still gives every thread a tile) with one
//    float32 fma per product, in order of depth;
//  - the last layer writes its tile compact in shared memory, and the block
//    stores it to `out` as one contiguous, coalesced run.
// mma.sync / wgmma on bfloat16 (the bytes bound) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ROWS 64
#define THREADS 256
#define MAX_LAYERS 8
#define MAX_WIDTH 256
#define SMEM_LIMIT 232448  // 227 KB, the most a block may use on sm_90

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

struct Net {
  const void* w[MAX_LAYERS];  // layer i: [dims[i], dims[i+1]] row-major, float or bfloat16
  int dims[MAX_LAYERS + 1];
  int n_layers;
};

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

template <bool BF16>
__device__ __forceinline__ float to_input(float v) {
  // a layer's input is rounded to the weights' type (h.astype(w.dtype))
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16>
__device__ __forceinline__ float load_weight(const void* w, int i) {
  return BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
              : static_cast<const float*>(w)[i];
}

__device__ __forceinline__ float activate(float h, int act) {
  if (act == ACT_RELU) return fmaxf(h, 0.f);
  if (act == ACT_SIGMOID) return 1.f / (1.f + expf(-h));
  return h;
}

// One layer on a tile: o = in @ w, in [ROWS, din] at stride S, w [din, dpad].
// Hidden layers store to_input(relu(sum)) at stride S; the last layer stores
// activate(sum) compact, at stride dout.
template <int RT, bool BF16>
__device__ __forceinline__ void layer(const float* __restrict__ in, float* __restrict__ o,
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
          o[row * S + j] = to_input<BF16>(fmaxf(acc[r][c], 0.f));
      }
    }
  }
}

template <bool BF16>
__device__ __forceinline__ void run_layer(const float* in, float* o, const float* w, int din,
                                          int dout, int S, bool last, int act) {
  // the largest row tile that still gives every thread a tile of the layer
  const int nct = pad4(dout) / 4;
  if ((ROWS / 4) * nct >= THREADS)
    layer<4, BF16>(in, o, w, din, dout, S, last, act);
  else if ((ROWS / 2) * nct >= THREADS)
    layer<2, BF16>(in, o, w, din, dout, S, last, act);
  else
    layer<1, BF16>(in, o, w, din, dout, S, last, act);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, long long Q,
                 const Net net, int S, int act) {
  extern __shared__ __align__(16) float smem[];
  const int L = net.n_layers;

  // every layer's weights, once per block: layer i as [din, pad4(dout)], in order
  int total = 0;
  for (int i = 0; i < L; ++i) {
    const int din = net.dims[i], dout = net.dims[i + 1], dpad = pad4(dout);
    for (int e = threadIdx.x; e < din * dpad; e += THREADS) {
      const int k = e / dpad, j = e - k * dpad;
      smem[total + e] = j < dout ? load_weight<BF16>(net.w[i], k * dout + j) : 0.f;
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
      buf0[r * S + k] = e < n_in ? to_input<BF16>(xt[e]) : 0.f;
    }
    __syncthreads();
    float* in = buf0;
    float* o = buf1;
    const float* w = smem;
    for (int i = 0; i < L; ++i) {
      run_layer<BF16>(in, o, w, net.dims[i], net.dims[i + 1], S, i == L - 1, act);
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

// Shared memory of a launch: the padded weights and two [ROWS, S] activation
// buffers, S the widest layer rounded up to an odd number.
static long long smem_bytes(const int* dims, int L, int* S) {
  int widest = 0;
  long long w = 0;
  for (int i = 0; i <= L; ++i) widest = dims[i] > widest ? dims[i] : widest;
  for (int i = 0; i < L; ++i) w += (long long)dims[i] * pad4(dims[i + 1]);
  *S = widest | 1;
  return 4 * (w + 2LL * ROWS * *S);
}

template <bool BF16>
static int launch(const float* x, float* out, long long Q, const Net& net, int S, int act,
                  int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_kernel<BF16>,
                                                           THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (Q + ROWS - 1) / ROWS;
  const long long most = (long long)per_sm * sms;
  const int grid = (int)(n_tiles < most ? n_tiles : most);
  fused_mlp_kernel<BF16><<<grid, THREADS, smem, stream>>>(x, out, Q, net, S, act);
  return (int)cudaGetLastError();
}

// Plain C entry point. x [Q, dims[0]] float32, out [Q, dims[L]] float32, w[i]
// [dims[i], dims[i+1]] row-major float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// all contiguous on the current device. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int fused_mlp(const float* x, float* out, long long Q, const void* const* w,
                         const int* dims, int L, int bf16, int act, void* stream) {
  if (L < 1 || L > MAX_LAYERS || Q < 0 || act < ACT_NONE || act > ACT_SIGMOID)
    return (int)cudaErrorInvalidValue;
  Net net;
  for (int i = 0; i <= L; ++i) {
    if (dims[i] < 1 || dims[i] > MAX_WIDTH) return (int)cudaErrorInvalidValue;
    net.dims[i] = dims[i];
  }
  for (int i = 0; i < L; ++i) net.w[i] = w[i];
  net.n_layers = L;
  int S = 0;
  const long long smem = smem_bytes(dims, L, &S);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  return bf16 ? launch<true>(x, out, Q, net, S, act, (int)smem, (cudaStream_t)stream)
              : launch<false>(x, out, Q, net, S, act, (int)smem, (cudaStream_t)stream);
}
