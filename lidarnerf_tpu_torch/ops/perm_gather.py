"""Per-ray permutation gather from the inverse permutation (counterpart of
lidarnerf_tpu/ops/perm_gather_pallas.py).

`mxu_permutation_gather(vals, inv_order)` computes
`out[n, j] = vals[n, order[n, j]]` with `inv_order = argsort(order)`, bit for
bit, and its gradient is the gather by `inv_order`. The name is the JAX
package's; on Hopper there is no matrix-unit trick: kernel B6
(`csrc/perm_gather.cu`) moves the 4-byte words themselves. A CUDA tensor
runs B6 in both directions, a CPU tensor the plain versions below.
"""

import torch

from lidarnerf_tpu_torch.ops import dispatch


def _rows_index(inv_order, like):
    return inv_order.long()[..., None].expand_as(like)


def scatter_by_inverse(vals, inv_order):
    """B6 forward's plain version: out[n, inv_order[n, i]] = vals[n, i] ([N, S, C])."""
    return torch.empty_like(vals).scatter_(1, _rows_index(inv_order, vals), vals)


def gather_by_inverse(g, inv_order):
    """B6 backward's plain version: out[n, i] = g[n, inv_order[n, i]] ([N, S, C])."""
    return torch.gather(g, 1, _rows_index(inv_order, g))


class PermutationGather(torch.autograd.Function):
    """[N, S, C] float32 rows reordered by a per-ray permutation given as its inverse."""

    @staticmethod
    def forward(ctx, vals, inv_order):
        ctx.save_for_backward(inv_order)
        if dispatch.uses_kernel(vals):
            from lidarnerf_tpu_torch.ops import perm_gather_cuda

            return perm_gather_cuda.perm_gather_fwd(vals.contiguous(), inv_order)
        return scatter_by_inverse(vals, inv_order)

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        if dispatch.uses_kernel(g):
            from lidarnerf_tpu_torch.ops import perm_gather_cuda

            return perm_gather_cuda.perm_gather_bwd(g.contiguous(), inv_order), None
        return gather_by_inverse(g, inv_order), None


def mxu_permutation_gather(vals, inv_order):
    """take_along_axis(vals, order, axis=1) from inv_order = argsort(order) alone.

    vals [N, S, C] float32, inv_order [N, S] integer; differentiable in vals.
    """
    if dispatch.uses_kernel(vals):
        inv_order = inv_order.to(torch.int32).contiguous()  # the kernel's index type
    return PermutationGather.apply(vals, inv_order)
