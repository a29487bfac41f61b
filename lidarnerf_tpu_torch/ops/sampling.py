"""Static-shape ray sampling (counterpart of lidarnerf_tpu/ops/sampling.py:18-91).

Every ray carries exactly num_steps stratified samples plus upsample_steps
inverse-CDF samples. Randomness is explicit: the perturb noise and the `u` of
`sample_pdf` are passed in, or drawn from a given `torch.Generator`.
"""

import torch


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
