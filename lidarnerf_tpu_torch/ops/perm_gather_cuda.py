"""Wrappers of the permutation-gather kernel (`csrc/perm_gather.cu`, B6).

Replace lidarnerf_tpu/ops/perm_gather_pallas.py::_apply in its two
directions; their plain PyTorch versions are `ops/perm_gather.py::
scatter_by_inverse` (forward) and `gather_by_inverse` (backward). The
wrappers launch the kernel or raise: they never fall back to the plain
versions or to `torch.gather`. Each direction has its own launch count
(`fwd_launches`, `bwd_launches`; `launch_counts()` reads both);
`device_counts` counts them on the card, graph replays included.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib, device_counts

SOURCE = "perm_gather.cu"
SMEM_LIMIT = 232448  # csrc/perm_gather.cu

fwd_launches = 0  # perm_gather_fwd (B6, forward)
bwd_launches = 0  # perm_gather_bwd (B6, backward)
_fn = None  # the bound C entry point, loaded (and built) at first launch


def launch_counts() -> dict:
    return {"perm_gather_fwd": fwd_launches, "perm_gather_bwd": bwd_launches}


def reset_counts():
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_lib.load(SOURCE).perm_gather
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # src [N, S, C] f32
            ctypes.c_void_p,  # inv [N, S] int32
            ctypes.c_void_p,  # dst [N, S, C] f32
            ctypes.c_longlong,  # N
            ctypes.c_int,  # S
            ctypes.c_int,  # C
            ctypes.c_int,  # transpose
            ctypes.c_void_p,  # cudaStream_t
        ]
        _fn = fn
    return _fn


def _launch(name, src, inv_order, transpose):
    if not (src.is_cuda and inv_order.is_cuda and src.device == inv_order.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if src.dtype != torch.float32 or src.dim() != 3 or not src.is_contiguous():
        raise ValueError(f"{name} takes a contiguous float32 [N, S, C], got {src.dtype} "
                         f"{tuple(src.shape)}")
    N, S, C = src.shape
    if (inv_order.dtype != torch.int32 or tuple(inv_order.shape) != (N, S)
            or not inv_order.is_contiguous()):
        raise ValueError(f"inv_order must be a contiguous int32 [{N}, {S}], got "
                         f"{inv_order.dtype} {tuple(inv_order.shape)}")
    if 4 * S * (C + 1) > SMEM_LIMIT:
        raise ValueError(f"{name} stages a ray's [S, C] rows in shared memory: S * (C + 1) "
                         f"* 4 = {4 * S * (C + 1)} B exceeds {SMEM_LIMIT}")
    out = torch.empty_like(src)
    if N == 0 or S == 0 or C == 0:
        return out, False
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(src.data_ptr(), inv_order.data_ptr(), out.data_ptr(), N, S, C,
                        int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    device_counts.add(name, src.device)
    return out, True


def perm_gather_fwd(vals: torch.Tensor, inv_order: torch.Tensor) -> torch.Tensor:
    """B6 forward: out[n, inv_order[n, i]] = vals[n, i], bit for bit.

    vals [N, S, C] float32, inv_order [N, S] int32 (a permutation of each
    row). Launches on the current stream.
    """
    global fwd_launches
    out, launched = _launch("perm_gather_fwd", vals, inv_order, False)
    fwd_launches += launched
    return out


def perm_gather_bwd(g: torch.Tensor, inv_order: torch.Tensor) -> torch.Tensor:
    """B6 backward: out[n, i] = g[n, inv_order[n, i]], bit for bit."""
    global bwd_launches
    out, launched = _launch("perm_gather_bwd", g, inv_order, True)
    bwd_launches += launched
    return out
