"""The `--fast` occupancy bin lookup: out[q] = grid.reshape(-1)[idx[q]].

Counterpart of tools/exp_occ_lookup.py::lookup_pallas (P12), the TPU kernel
of the [4096, 128] take inside occ_bin_pdf (lidarnerf_tpu/models/
occupancy.py:108, `jnp.take(occ3.reshape(-1), flat)`). A CUDA tensor takes
the hand-written kernel (`ops/occ_lookup_cuda.py`, `csrc/occ_lookup.cu`), a
CPU tensor the plain version below. Both follow jnp.take: an index in
[-n, 0) wraps to i + n, any other index outside [0, n) gives NaN. The TPU
kernel needs a multiple of 4096 indices (its grid of chunks); that is a
precondition of its launch, not part of the function, and here any count R
works, R = 0 included. No gradient: the occupancy is not differentiated.
On the model paths the `--fast` sampler does this lookup inside its own
fused kernel (`ops/occ_sample.py`); this entry serves the port's lookup
tool (`tools/exp_occ_lookup.py`).
"""

import torch

from lidarnerf_tpu_torch.ops import dispatch, occ_lookup_cuda


def occ_lookup_plain(idx: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: float32 of idx's shape."""
    flat = grid.detach().reshape(-1)
    n = flat.numel()
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    vals = flat[torch.where(inside, i, 0)]
    return torch.where(inside, vals, torch.full_like(vals, float("nan")))


def occ_lookup(idx: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """P12: grid (float32, [G, G, G], [G*G, G] or flat) at int32 cell
    indices idx of any shape; the kernel on CUDA tensors."""
    if dispatch.uses_kernel(idx) or dispatch.uses_kernel(grid):
        return occ_lookup_cuda.occ_lookup(idx.contiguous(), grid.contiguous())
    return occ_lookup_plain(idx, grid)
