"""Wrapper of the fused `--fast` sampler kernel (`csrc/occ_sample.cu`).

Replaces tools/exp_occ_lookup.py::lookup_pallas (P12) fused with the
sampler around it; its plain PyTorch version is
`ops/occ_sample.py::occ_sample_plain`. The wrapper launches the kernel or
raises: it never falls back to the plain version. `launches` counts its
launches (`launch_counts()` reads it); `device_counts` counts them on the
card, graph replays included.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import cuda_lib, device_counts

SOURCE = "occ_sample.cu"
# csrc/occ_sample.cu SMEM_BINS: up to here one ray's cdf lives in shared
# memory; past it in a workspace of [N, bins + 1] floats that the wrapper allocates
SMEM_BINS = 32768
MAX_BINS = 2**31 - 256  # csrc/occ_sample.cu MAX_BINS: the kernel indexes bins by int

launches = 0  # occ_sample
_fn = None  # the bound C entry point, loaded (and built) at first launch


def launch_counts() -> dict:
    return {"occ_sample": launches}


def reset_counts():
    global launches
    launches = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_lib.load(SOURCE).occ_sample
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # occ3 [G, G, G] f32
            ctypes.c_int,  # G
            ctypes.c_void_p,  # rays_o [N, 3] f32
            ctypes.c_void_p,  # rays_d [N, 3] f32
            ctypes.c_void_p,  # nears [N, 1] f32
            ctypes.c_void_p,  # fars [N, 1] f32
            ctypes.c_void_p,  # xi [N, T] f32 or null
            ctypes.c_void_p,  # u_row [T] f32 or null
            ctypes.c_void_p,  # z [N, T] f32
            ctypes.c_void_p,  # pdf [N, K] f32 or null
            ctypes.c_void_p,  # work [N, K + 1] f32 past SMEM_BINS, else null
            ctypes.c_longlong,  # N
            ctypes.c_int,  # K
            ctypes.c_int,  # T
            *[ctypes.c_float] * 7,  # bound, G / (2 bound), 1 - floor, floor / K, 1e-12, 1 / K, 1 / T
            ctypes.c_void_p,  # cudaStream_t
        ]
        _fn = fn
    return _fn


def _check(name, t, shape, device):
    if not (t.is_cuda and t.device == device):
        raise ValueError("occ_sample takes CUDA tensors on one device")
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {list(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}{'' if t.is_contiguous() else ' (not contiguous)'}")


def occ_sample(occ3, rays_o, rays_d, nears, fars, bins: int, num_steps: int, bound: float,
               floor: float, xi=None, u_row=None, want_pdf=False):
    """The fused sampler: (z [N, num_steps], pdf [N, bins] or None), bit for bit
    occ_z_vals(nears, fars, occ_bin_pdf(...), num_steps, ...) on the card.

    occ3 [G, G, G] holds 0s and 1s (`occupied_volume`); rays_o, rays_d [N, 3],
    nears, fars [N, 1]; with perturb, xi [N, num_steps] (the stratified
    draws), else u_row [num_steps] (torch.linspace(0, 1, num_steps)): exactly
    one of the two. All float32, contiguous, on one CUDA device. Any floor
    in [0, 1] and 1 to MAX_BINS bins: the sum and the cdf are taken from
    counts of occupied bins in one fixed sequence of float64 roundings, the
    plain version's (`models/occupancy.py::occ_cdf`). The scalars reach the
    kernel as float32, rounded from the Python doubles as torch rounds a
    scalar operand, and 1 / bins, 1 / num_steps as torch's CUDA division by
    a Python int takes them. Launches on the current stream; allocates the
    outputs and, past SMEM_BINS bins, the workspace of the rays' cdfs.
    """
    global launches
    device = occ3.device
    if not occ3.is_cuda:
        raise ValueError("occ_sample takes CUDA tensors on one device")
    G = occ3.shape[0]
    N = rays_o.shape[0]
    _check("occ3", occ3, (G, G, G), device)
    if G**3 > 2**31 - 1:
        raise ValueError(f"occ_sample takes at most 2^31 - 1 cells, got {G}^3")
    for name, t, shape in (("rays_o", rays_o, (N, 3)), ("rays_d", rays_d, (N, 3)),
                           ("nears", nears, (N, 1)), ("fars", fars, (N, 1))):
        _check(name, t, shape, device)
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"occ_sample takes 1 to {MAX_BINS} bins, got {bins}")
    if not 0.0 <= floor <= 1.0:
        raise ValueError(f"occ_sample takes a floor from 0 to 1, got {floor}")
    if not 1 <= num_steps < 2**31:
        raise ValueError(f"occ_sample takes 1 to 2^31 - 1 samples, got {num_steps}")
    if N >= 2**31:
        raise ValueError(f"occ_sample takes at most 2^31 - 1 rays, got {N}")
    if (xi is None) == (u_row is None):
        raise ValueError("occ_sample takes xi (perturb) or u_row (not), exactly one")
    if xi is not None:
        _check("xi", xi, (N, num_steps), device)
    else:
        _check("u_row", u_row, (num_steps,), device)
    if N == 0:
        return (torch.empty((0, num_steps), dtype=torch.float32, device=device),
                torch.empty((0, bins), dtype=torch.float32, device=device) if want_pdf else None)
    fn = _kernel()
    z = torch.empty((N, num_steps), dtype=torch.float32, device=device)
    pdf = torch.empty((N, bins), dtype=torch.float32, device=device) if want_pdf else None
    work = (torch.empty((N, bins + 1), dtype=torch.float32, device=device)
            if bins > SMEM_BINS else None)
    err = cuda_lib.launch(
        fn, device, occ3.data_ptr(), G, rays_o.data_ptr(), rays_d.data_ptr(), nears.data_ptr(),
        fars.data_ptr(), None if xi is None else xi.data_ptr(),
        None if u_row is None else u_row.data_ptr(), z.data_ptr(),
        None if pdf is None else pdf.data_ptr(), None if work is None else work.data_ptr(),
        N, bins, num_steps,
        bound, G / (2.0 * bound), 1.0 - floor, floor / bins, 1e-12, 1.0 / bins, 1.0 / num_steps)
    if err != 0:
        raise RuntimeError(f"occ_sample launch failed: cudaError {err}")
    device_counts.add("occ_sample", device)
    launches += 1
    return z, pdf
