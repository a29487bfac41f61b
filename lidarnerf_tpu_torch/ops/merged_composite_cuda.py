"""Wrapper of the merged-compositing kernel pair (`csrc/merged_composite.cu`).

Replaces no TPU kernel: the JAX package's `merged_composite_weights` is XLA.
Its plain PyTorch version is
`ops/compositing.py::merged_composite_weights_plain`. The wrapper launches
the kernels or raises: it never falls back to the plain version. `launches`
and `bwd_launches` count its launches (`launch_counts()` reads them);
`device_counts` counts them on the card, graph replays included.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib, device_counts

SOURCE = "merged_composite.cu"
MAX_SAMPLES = 16384  # csrc/merged_composite.cu MAX_SAMPLES: TA + TB at most

launches = 0  # merged_composite_fwd
bwd_launches = 0  # merged_composite_bwd
_fns = {}  # entry name -> the bound C entry point, loaded (and built) at first launch


def launch_counts() -> dict:
    return {"merged_composite_fwd": launches, "merged_composite_bwd": bwd_launches}


def reset_counts():
    global launches, bwd_launches
    launches = bwd_launches = 0


def _kernel(name, pointers):
    if name not in _fns:
        fn = getattr(cuda_lib.load(SOURCE), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [*[ctypes.c_void_p] * pointers,  # the tensors, in the call's order
                       ctypes.c_longlong,  # N
                       ctypes.c_int,  # TA
                       ctypes.c_int,  # TB
                       ctypes.c_float,  # density_scale
                       ctypes.c_void_p]  # cudaStream_t
        _fns[name] = fn
    return _fns[name]


def check_args(zA, sigA, zB, sigB, sample_dist):
    """(N, TA, TB) of arguments the kernels take, or a ValueError: zA, sigA
    [N, TA], zB, sigB [N, TB], sample_dist [N, 1], all contiguous float32 on
    one device, 1 <= TA, TB and TA + TB <= MAX_SAMPLES, and no gradient wanted
    for the depths or sample_dist (the backward gives the densities' alone).
    Needs no card: the launch checks that the device is CUDA."""
    if zA.dim() != 2 or zB.dim() != 2:
        raise ValueError(f"merged_composite takes zA [N, TA] and zB [N, TB], got "
                         f"{tuple(zA.shape)} and {tuple(zB.shape)}")
    (N, TA), TB = zA.shape, zB.shape[1]
    if not (TA >= 1 and TB >= 1 and TA + TB <= MAX_SAMPLES):
        raise ValueError(f"merged_composite takes 1 <= TA, TB and TA + TB <= {MAX_SAMPLES}, "
                         f"got {TA} + {TB}")
    if N >= 2**31:
        raise ValueError(f"merged_composite takes at most 2^31 - 1 rays, got {N}")
    for name, t, shape in (("zA", zA, (N, TA)), ("sigA", sigA, (N, TA)), ("zB", zB, (N, TB)),
                           ("sigB", sigB, (N, TB)), ("sample_dist", sample_dist, (N, 1))):
        if t.device != zA.device:
            raise ValueError("merged_composite takes tensors on one device")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}{'' if t.is_contiguous() else ' (not contiguous)'}")
    for name, t in (("zA", zA), ("zB", zB), ("sample_dist", sample_dist)):
        if t.requires_grad:
            raise ValueError(f"merged_composite gives no gradient for {name}: pass it detached")
    return N, TA, TB


def _launch(name, tensors, N, TA, TB, density_scale):
    device = tensors[0].device
    if not tensors[0].is_cuda:
        raise ValueError("merged_composite takes CUDA tensors")
    err = cuda_lib.launch(_kernel(name, len(tensors)), device, *[t.data_ptr() for t in tensors],
                          N, TA, TB, density_scale)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    device_counts.add(name, device)


def merged_composite_fwd(zA, sigA, zB, sigB, sample_dist, density_scale: float):
    """(wA [N, TA], wB [N, TB]): the plain version's weights on the card, the
    same deltas and x bit for bit and the transmittance sums in float64.
    Launches on the current stream; allocates the outputs."""
    global launches
    N, TA, TB = check_args(zA, sigA, zB, sigB, sample_dist)
    wA, wB = torch.empty_like(sigA), torch.empty_like(sigB)
    if N:
        _launch("merged_composite_fwd", (zA, sigA, zB, sigB, sample_dist, wA, wB), N, TA, TB,
                density_scale)
        launches += 1
    return wA, wB


def merged_composite_bwd(zA, sigA, zB, sigB, sample_dist, density_scale: float, gA, gB):
    """(dL/dsigA, dL/dsigB) from the upstream gradients gA [N, TA], gB [N, TB]
    (contiguous float32), recomputing the forward from its inputs."""
    global bwd_launches
    N, TA, TB = check_args(zA, sigA, zB, sigB, sample_dist)
    for name, g, like in (("gA", gA, sigA), ("gB", gB, sigB)):
        if (g.device != like.device or g.dtype != torch.float32 or g.shape != like.shape
                or not g.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {list(like.shape)} on the "
                             f"inputs' device, got {g.dtype} {tuple(g.shape)} on {g.device}")
    dA, dB = torch.empty_like(sigA), torch.empty_like(sigB)
    if N:
        _launch("merged_composite_bwd", (zA, sigA, zB, sigB, sample_dist, gA, gB, dA, dB), N,
                TA, TB, density_scale)
        bwd_launches += 1
    return dA, dB
