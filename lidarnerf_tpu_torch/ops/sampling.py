"""Static-shape ray sampling (counterpart of lidarnerf_tpu/ops/sampling.py).

Every ray carries exactly num_steps stratified samples plus upsample_steps
inverse-CDF samples. Randomness is explicit: the perturb noise and the `u` of
`sample_pdf` are passed in, or drawn from a given `torch.Generator`.
`sort_merge_z` merges and sorts two sample lists with their per-sample
values; the renderer composites the lists order-free instead and does not
call it.
"""

import torch

from lidarnerf_tpu_torch.ops import dispatch
from lidarnerf_tpu_torch.ops.perm_gather import mxu_permutation_gather


def stratified_z_vals(nears, fars, num_steps: int, perturb: bool = False,
                      noise=None, generator=None):
    """Uniform depth samples in [near, far], optionally jittered.

    Args:
        nears, fars: [N, 1] per-ray bounds.
        num_steps: sample count T.
        perturb: add +/- half a bin of uniform noise (not clamped, like the
            reference).
        noise: optional [N, T] uniform [0, 1) draws for the jitter; drawn
            from `generator` when not given.

    Returns:
        z_vals: [N, T]
    """
    N = nears.shape[0]
    t = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=nears.device)
    z_vals = nears + (fars - nears) * t[None, :]
    if perturb:
        if noise is None:
            noise = torch.rand((N, num_steps), generator=generator,
                               dtype=torch.float32, device=nears.device)
        sample_dist = (fars - nears) / num_steps
        z_vals = z_vals + (noise - 0.5) * sample_dist
    return z_vals


def sample_pdf(bins, weights, n_samples: int, det: bool = True, u=None, generator=None):
    """Inverse-CDF sampling of new depths from bin weights.

    Args:
        bins: [B, T] bin centers (old z_vals midpoints).
        weights: [B, T-1] bin weights.
        n_samples: number of new samples per ray.
        det: midpoint linspace `u` instead of uniform draws.
        u: optional [B, n_samples] uniform draws (det=False); drawn from
            `generator` when not given.

    Returns:
        samples: [B, n_samples]
    """
    B = bins.shape[0]
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [B, T]

    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=torch.float32, device=bins.device)
        u = u.expand(B, n_samples).contiguous()
    elif u is None:
        u = torch.rand((B, n_samples), generator=generator, dtype=torch.float32,
                       device=bins.device)

    # searchsorted(right) selects the same entries as the JAX package's
    # masked max/min: cdf and bins are sorted, and cdf[0] = 0 <= u
    T = cdf.shape[-1]
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=T - 1)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, 1.0, denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def _take_along(vals, idx):
    return torch.gather(vals, 1, idx if vals.dim() == 2 else idx[..., None].expand_as(vals))


class _PermutationGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, order, inv_order):
        ctx.save_for_backward(inv_order)
        return _take_along(vals, order)

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        return _take_along(g, inv_order), None, None


def permutation_gather(vals, order, inv_order):
    """take_along_axis(vals, order, axis=1) for a per-row permutation `order`.

    The gradient is the gather by the inverse permutation, as the JAX
    package's custom VJP gives it (sampling.py:94-120).

    Args:
        vals: [N, S] or [N, S, C]; order, inv_order: [N, S] int64 with
        inv_order = argsort(order).
    """
    return _PermutationGather.apply(vals, order, inv_order)


def inverse_permutation(order):
    """argsort(order) of a per-row permutation [N, S], as one scatter."""
    inv = torch.empty_like(order)
    return inv.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))


def sort_merge_z(z_coarse, z_fine, *extras):
    """Merge coarse and fine depth samples, sorting each ray (sampling.py:123-175).

    z and every extra are fused into one [N, S, 1 + sum(C_i)] tensor and
    reordered once: by kernel B6 on a CUDA tensor (`mxu_permutation_gather`),
    by `permutation_gather` on the CPU. The sort is stable, as `jnp.argsort`
    is, so a fine sample equal to a coarse one keeps its place after it.

    Args:
        z_coarse: [N, T], z_fine: [N, t].
        extras: (coarse, fine) pairs of per-sample arrays [N, T(, C)] /
            [N, t(, C)] to reorder alongside z.

    Returns:
        (z_sorted [N, T+t], order [N, T+t] int64, *reordered_extras)
    """
    z_all = torch.cat([z_coarse, z_fine], dim=1)
    order = torch.argsort(z_all, dim=1, stable=True)
    inv_order = inverse_permutation(order)

    chans = [z_all[..., None]]
    for coarse, fine in extras:
        merged = torch.cat([coarse, fine], dim=1)
        chans.append(merged[..., None] if merged.dim() == 2 else merged)
    fused = torch.cat(chans, dim=-1)  # [N, S, 1 + sum(C_i)]
    if dispatch.uses_kernel(fused):
        sorted_fused = mxu_permutation_gather(fused, inv_order)
    else:
        sorted_fused = permutation_gather(fused, order, inv_order)

    outs = []
    off = 1
    for (coarse, _), part in zip(extras, chans[1:]):
        c = part.shape[-1]
        piece = sorted_fused[..., off: off + c]
        outs.append(piece[..., 0] if coarse.dim() == 2 else piece)
        off += c
    return (sorted_fused[..., 0], order, *outs)
