"""Wrapper of the occupancy bin lookup kernel (`csrc/occ_lookup.cu`, P12).

Replaces tools/exp_occ_lookup.py::lookup_pallas; its plain PyTorch version
is `ops/occ_lookup.py::occ_lookup_plain`. The wrapper launches the kernel
or raises: it never falls back to the plain version or to `torch.take`.
`launches` counts its launches (`launch_counts()` reads it);
`device_counts` counts them on the card, graph replays included.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib, device_counts

SOURCE = "occ_lookup.cu"

launches = 0  # occ_lookup (P12)
_fn = None  # the bound C entry point, loaded (and built) at first launch


def launch_counts() -> dict:
    return {"occ_lookup": launches}


def reset_counts():
    global launches
    launches = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_lib.load(SOURCE).occ_lookup
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # idx [R] int32
            ctypes.c_void_p,  # grid [n] f32
            ctypes.c_void_p,  # out [R] f32
            ctypes.c_longlong,  # R
            ctypes.c_longlong,  # n
            ctypes.c_void_p,  # cudaStream_t
        ]
        _fn = fn
    return _fn


def occ_lookup(idx: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """P12: out = grid.reshape(-1)[idx] with jnp.take's semantics, bit for bit.

    idx int32 of any shape, grid float32 of any shape (the [G, G, G] volume,
    its [G*G, G] rows or flat), both contiguous on one CUDA device. An index
    in [-n, 0) wraps, any other outside [0, n) gives NaN. Returns float32 of
    idx's shape; launches on the current stream.
    """
    global launches
    if not (idx.is_cuda and grid.is_cuda and idx.device == grid.device):
        raise ValueError("occ_lookup takes CUDA tensors on one device")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"occ_lookup takes contiguous int32 indices, got {idx.dtype}"
                         f"{'' if idx.is_contiguous() else ' (not contiguous)'}")
    if grid.dtype != torch.float32 or not grid.is_contiguous() or grid.numel() == 0:
        raise ValueError(f"occ_lookup takes a contiguous non-empty float32 grid, got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    if grid.numel() > 2**31 - 1:
        raise ValueError(f"occ_lookup takes int32 indices into at most 2^31 - 1 cells, got "
                         f"{grid.numel()}")
    if idx.numel() == 0:
        return torch.empty_like(idx, dtype=torch.float32)
    fn = _kernel()
    out = torch.empty_like(idx, dtype=torch.float32)  # contiguous, as idx is
    err = cuda_lib.launch(fn, idx.device, idx.data_ptr(), grid.data_ptr(), out.data_ptr(),
                          idx.numel(), grid.numel())
    if err != 0:
        raise RuntimeError(f"occ_lookup launch failed: cudaError {err}")
    device_counts.add("occ_lookup", idx.device)
    launches += 1
    return out
