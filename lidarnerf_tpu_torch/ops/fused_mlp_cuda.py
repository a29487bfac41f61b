"""Wrapper of the fused-MLP kernel (`csrc/fused_mlp.cu`, B5).

Replaces lidarnerf_tpu/ops/fused_mlp.py::fused_mlp_inference; its plain
PyTorch version is `ops/fused_mlp.py::mlp_reference`. The wrapper launches
the kernel or raises: it never falls back to the plain version. `launches`
counts its launches (`launch_counts()` reads it by kernel name);
`device_counts` counts them on the card, graph replays included.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib, device_counts

SOURCE = "fused_mlp.cu"
PLAN = "fused_mlp_plan.cuh"  # the limits and shared-memory plans of both routes
# csrc/fused_mlp_plan.cuh
MAX_LAYERS = 8
MAX_WIDTH = 256
SMEM_LIMIT = 232448
ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2}

launches = 0
_fn = None  # the bound C entry point, loaded (and built) at first launch
_smem_fn = None  # the bound plan query, loaded at its first use


def launch_counts() -> dict:
    return {"fused_mlp": launches}


def reset_counts():
    global launches
    launches = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_lib.load(SOURCE).fused_mlp
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # x [Q, dims[0]] f32
            ctypes.c_void_p,  # out [Q, dims[L]] f32
            ctypes.c_longlong,  # Q
            ctypes.POINTER(ctypes.c_void_p),  # weight pointers [L] (host)
            ctypes.POINTER(ctypes.c_int),  # dims [L + 1] (host)
            ctypes.c_int,  # L
            ctypes.c_int,  # bf16 weights
            ctypes.c_int,  # final activation
            ctypes.c_void_p,  # cudaStream_t
        ]
        _fn = fn
    return _fn


def smem_bytes(dims, dtype=torch.float32) -> int:
    """Shared memory a block of the chain `dims` takes with weights of `dtype`
    (float32: the CUDA-core route, bfloat16: the tensor-core route), as the
    kernel's launch plan computes it (csrc/fused_mlp_plan.cuh::fused_mlp_smem,
    the one copy of the plan); above SMEM_LIMIT the chain does not fit.
    Loads the library (built first if needed) once: each launch asks."""
    global _smem_fn
    if _smem_fn is None:
        fn = cuda_lib.load(SOURCE).fused_mlp_smem
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
        _smem_fn = fn
    return _smem_fn((ctypes.c_int * len(dims))(*dims), len(dims) - 1, int(dtype == torch.bfloat16))


def occupancy(dims, dtype, final_activation="none") -> dict:
    """What a launch of the chain `dims` gets on the current device: registers
    and local bytes (stack frame and spills; ptxas reports the spills apart)
    per thread, threads and shared bytes per block, blocks per SM."""
    fn = cuda_lib.load(SOURCE).fused_mlp_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 5)()
    err = fn((ctypes.c_int * len(dims))(*dims), len(dims) - 1, int(dtype == torch.bfloat16),
             ACTIVATIONS[final_activation], info)
    if err != 0:
        raise RuntimeError(f"fused_mlp_occupancy failed: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "threads", "smem_bytes", "blocks_per_sm"), info))


def fused_mlp_fwd(x: torch.Tensor, weights, final_activation: str = "none") -> torch.Tensor:
    """B5: [Q, d0] float32 rows through the bias-free ReLU chain -> [Q, dL] float32.

    weights: [d_i, d_{i+1}] matrices (the JAX layout), all float32 or all
    bfloat16, contiguous, on x's device. Launches on the current stream.
    """
    global launches
    weights = list(weights)
    if final_activation not in ACTIVATIONS:
        raise ValueError(f"final_activation must be one of {sorted(ACTIVATIONS)}")
    if not (x.is_cuda and all(w.is_cuda and w.device == x.device for w in weights)):
        raise ValueError("fused_mlp_fwd takes CUDA tensors on one device")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 [Q, d], got {x.dtype} {tuple(x.shape)}")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"1 to {MAX_LAYERS} layers, got {len(weights)}")
    dtype = weights[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(w.dtype != dtype for w in weights):
        raise TypeError("the weights must be all float32 or all bfloat16")
    dims = [x.shape[1]]
    for w in weights:
        if w.dim() != 2 or w.shape[0] != dims[-1] or not w.is_contiguous():
            raise ValueError(f"weight {tuple(w.shape)} does not continue the chain {dims}")
        dims.append(w.shape[1])
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"widths up to {MAX_WIDTH}, got {dims}")
    smem = smem_bytes(dims, dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"widths {dims} need {smem} B of shared memory (at most {SMEM_LIMIT})")
    if dtype == torch.bfloat16 and x.data_ptr() % 16:
        # the tensor-core route streams x with 16-byte copies: a view that
        # starts off a 16-byte boundary (such as x[1:]) is copied once
        x = x.clone()
    Q = x.shape[0]
    out = torch.empty((Q, dims[-1]), dtype=torch.float32, device=x.device)
    if Q == 0:
        return out
    L = len(weights)
    ptrs = (ctypes.c_void_p * L)(*[w.data_ptr() for w in weights])
    c_dims = (ctypes.c_int * (L + 1))(*dims)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), out.data_ptr(), Q, ptrs, c_dims, L,
                        int(dtype == torch.bfloat16), ACTIVATIONS[final_activation], stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp launch failed: cudaError {err}")
    device_counts.add("fused_mlp", x.device)
    launches += 1
    return out
