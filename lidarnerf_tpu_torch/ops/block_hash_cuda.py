"""Wrappers of the block-hash kernels (`csrc/block_hash_fwd.cu`, `csrc/block_hash_bwd.cu`).

`block_hash_fwd` replaces the TPU kernel
lidarnerf_tpu/ops/block_hash_pallas.py::_fwd_from_prep (B1) together with its
prep `_prep_inputs`; `block_hash_bwd` replaces `_bwd_from_prep` (B2). Their
plain PyTorch versions are `block_hash.encode_plain` and
`block_hash.encode_bwd_plain`; these wrappers never fall back to them: they
launch the kernel or raise.

`launches` and `bwd_launches` count each kernel's launches, so a run can show
that its main path went through the kernels.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib

SOURCE = "block_hash_fwd.cu"
BWD_SOURCE = "block_hash_bwd.cu"
SOURCES = (SOURCE, BWD_SOURCE)
HEADER = "block_hash_common.cuh"
MAX_LEVELS = 32  # csrc/block_hash_common.cuh MAX_LEVELS

launches = 0  # block_hash_fwd
bwd_launches = 0  # block_hash_bwd

_fns = {}  # C entry point name -> bound function, loaded (and built) at first launch
_c_levels = {}  # spec -> ctypes per-level arrays, kept alive while in use


def _kernel(source, name):
    if name in _fns:
        return _fns[name]
    fn = getattr(cuda_lib.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x [Q, 3] f32
        ctypes.c_void_p,  # fwd: table [L*B, 128] f32; bwd: g [Q, 2L] f32
        ctypes.c_void_p,  # fwd: out [Q, 2L] f32; bwd: grad [L*B, 128] f32, zeroed
        ctypes.c_longlong,  # Q
        ctypes.c_int,  # L
        ctypes.c_int,  # B, blocks per level
        ctypes.POINTER(ctypes.c_float),  # scale [L] (host)
        ctypes.POINTER(ctypes.c_int),  # max_cell [L] (host)
        ctypes.POINTER(ctypes.c_int),  # blocks_axis [L] (host)
        ctypes.POINTER(ctypes.c_int),  # dense [L] (host)
        ctypes.c_void_p,  # cudaStream_t
    ]
    _fns[name] = fn
    return fn


def _level_arrays(spec):
    if spec not in _c_levels:
        L = spec.num_levels
        _c_levels[spec] = (
            (ctypes.c_float * L)(*[lv.scale for lv in spec.levels]),
            (ctypes.c_int * L)(*[lv.max_cell for lv in spec.levels]),
            (ctypes.c_int * L)(*[lv.blocks_axis for lv in spec.levels]),
            (ctypes.c_int * L)(*[int(lv.dense) for lv in spec.levels]),
        )
    return _c_levels[spec]


def _check(name, x, other, other_name, other_shape, spec):
    """The checks both wrappers share: device, dtype, shape, contiguity, levels."""
    if not (x.is_cuda and other.is_cuda and x.device == other.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 (got {x.dtype}, {other.dtype})")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [Q, 3], got {tuple(x.shape)}")
    if tuple(other.shape) != other_shape:
        raise ValueError(f"{other_name} must be {list(other_shape)}, got {tuple(other.shape)}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if spec.num_levels > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {spec.num_levels}")


def _launch(fn, name, x, a, b, spec):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), x.shape[0], spec.num_levels,
                 spec.blocks_per_level, *_level_arrays(spec), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def block_hash_fwd(x: torch.Tensor, table: torch.Tensor, spec) -> torch.Tensor:
    """[Q, 3] float32 points, [L*B, 128] float32 table -> [Q, 2L] float32 features.

    Points outside [0, 1]^3 give zero features. Launches on the current stream.
    """
    global launches
    _check("block_hash_fwd", x, table, "table", (spec.table_rows, 128), spec)
    out = torch.empty((x.shape[0], spec.output_dim), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    _launch(_kernel(SOURCE, "block_hash_fwd"), "block_hash_fwd", x, table, out, spec)
    launches += 1
    return out


def block_hash_bwd(x: torch.Tensor, g: torch.Tensor, spec) -> torch.Tensor:
    """[Q, 3] float32 points, [Q, 2L] float32 feature grads -> [L*B, 128] table gradient.

    Points outside [0, 1]^3 contribute nothing. The output's zero fill is
    part of the call. Launches on the current stream.
    """
    global bwd_launches
    _check("block_hash_bwd", x, g, "g", (x.shape[0], spec.output_dim), spec)
    grad = torch.zeros((spec.table_rows, 128), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return grad
    _launch(_kernel(BWD_SOURCE, "block_hash_bwd"), "block_hash_bwd", x, g, grad, spec)
    bwd_launches += 1
    return grad
