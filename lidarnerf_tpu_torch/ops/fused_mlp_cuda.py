"""Wrapper of the fused-MLP kernel (`csrc/fused_mlp.cu`, B5).

Replaces lidarnerf_tpu/ops/fused_mlp.py::fused_mlp_inference; its plain
PyTorch version is `ops/fused_mlp.py::mlp_reference`. The wrapper launches
the kernel or raises: it never falls back to the plain version. `launches`
counts its launches (`launch_counts()` reads it by kernel name).
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib

SOURCE = "fused_mlp.cu"
# csrc/fused_mlp.cu: ROWS, MAX_LAYERS, MAX_WIDTH, SMEM_LIMIT
ROWS = 64
MAX_LAYERS = 8
MAX_WIDTH = 256
SMEM_LIMIT = 232448
ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2}

launches = 0
_fn = None  # the bound C entry point, loaded (and built) at first launch


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


def smem_bytes(dims) -> int:
    """Shared memory of a launch: float32 weights padded to 4 columns and two
    [ROWS, S] activation buffers, S the widest layer rounded up to odd."""
    weights = sum(a * ((b + 3) // 4 * 4) for a, b in zip(dims[:-1], dims[1:]))
    return 4 * (weights + 2 * ROWS * (max(dims) | 1))


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
    if smem_bytes(dims) > SMEM_LIMIT:
        raise ValueError(f"widths {dims} need {smem_bytes(dims)} B of shared memory "
                         f"(at most {SMEM_LIMIT})")
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
    launches += 1
    return out
