"""Wrapper of the block-hash forward kernel (`csrc/block_hash_fwd.cu`).

Replaces the TPU kernel lidarnerf_tpu/ops/block_hash_pallas.py::_fwd_from_prep
(B1) together with its prep `_prep_inputs`. The plain PyTorch version of the
same function is `block_hash.encode_plain`; this wrapper never falls back to
it: it launches the kernel or raises.

`launches` counts the kernel's launches, so a run can show that its main path
went through the kernel.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib

SOURCE = "block_hash_fwd.cu"
MAX_LEVELS = 32  # csrc/block_hash_fwd.cu MAX_LEVELS

launches = 0

_fn = None  # the bound C entry point, loaded (and built) at first launch
_c_levels = {}  # spec -> ctypes per-level arrays, kept alive while in use


def _kernel():
    global _fn
    if _fn is not None:
        return _fn
    fn = cuda_lib.load(SOURCE).block_hash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x [Q, 3] f32
        ctypes.c_void_p,  # table [L*B, 128] f32
        ctypes.c_void_p,  # out [Q, 2L] f32
        ctypes.c_longlong,  # Q
        ctypes.c_int,  # L
        ctypes.c_int,  # B, blocks per level
        ctypes.POINTER(ctypes.c_float),  # scale [L] (host)
        ctypes.POINTER(ctypes.c_int),  # max_cell [L] (host)
        ctypes.POINTER(ctypes.c_int),  # blocks_axis [L] (host)
        ctypes.POINTER(ctypes.c_int),  # dense [L] (host)
        ctypes.c_void_p,  # cudaStream_t
    ]
    _fn = fn
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


def block_hash_fwd(x: torch.Tensor, table: torch.Tensor, spec) -> torch.Tensor:
    """[Q, 3] float32 points, [L*B, 128] float32 table -> [Q, 2L] float32 features.

    Points outside [0, 1]^3 give zero features. Launches on the current stream.
    """
    global launches
    L, B = spec.num_levels, spec.blocks_per_level
    if not (x.is_cuda and table.is_cuda and x.device == table.device):
        raise ValueError("block_hash_fwd takes CUDA tensors on one device")
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"block_hash_fwd takes float32 (got {x.dtype}, {table.dtype})")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [Q, 3], got {tuple(x.shape)}")
    if tuple(table.shape) != (L * B, 128):
        raise ValueError(f"table must be [{L * B}, 128], got {tuple(table.shape)}")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError("block_hash_fwd takes contiguous tensors")
    if L > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {L}")

    Q = x.shape[0]
    out = torch.empty((Q, 2 * L), dtype=torch.float32, device=x.device)
    if Q == 0:
        return out
    fn = _kernel()
    scale, max_cell, blocks_axis, dense = _level_arrays(spec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), table.data_ptr(), out.data_ptr(), Q, L, B,
            scale, max_cell, blocks_axis, dense, stream,
        )
    if err != 0:
        raise RuntimeError(f"block_hash_fwd launch failed: cudaError {err}")
    launches += 1
    return out
