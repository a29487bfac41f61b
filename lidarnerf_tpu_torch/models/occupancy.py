"""Occupancy-prior ray sampling, the `--fast` path (counterpart of
lidarnerf_tpu/models/occupancy.py).

A [G, G, G] grid keeps an EMA-max of the field's density, refreshed from the
live weights every `update_interval` training steps. It reweights each ray's
coarse-sample CDF instead of compacting samples: every ray still carries
exactly `num_steps` coarse samples, drawn by stratified inverse CDF from a
piecewise-constant PDF over `bins` depth bins that puts (1 - floor) of the
mass on bins whose (dilated) cell is occupied. A zero grid gives the uniform
PDF, so a cold start samples as the stratified sampler does.

Plain PyTorch: the JAX module has no Pallas kernel. The grid refresh runs
the field through the block-hash forward (kernel B1 on CUDA) at G^3 points
spread over the whole volume. The bin lookup of `occ_bin_pdf` stays a plain
index, as the JAX module keeps XLA's take; tools/exp_occ_lookup.py's TPU
kernel for it (P12) has its counterpart in `ops/occ_lookup.py`.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class OccConfig:
    grid_size: int = 128
    decay: float = 0.95  # torch-ngp update_extra_state decay law
    update_interval: int = 16  # steps between grid refreshes
    density_thresh: float = 10.0  # reference --density_thresh default
    floor: float = 0.05  # uniform mixture fraction of the sampling PDF
    bins: int = 128  # per-ray CDF bins
    dilate: int = 1  # binary-occupancy dilation radius (cells)


def occ_config_from_opt(opt):
    """The OccConfig of a CLI options object (lidarnerf_tpu/nerf/trainer.py:124-137),
    or None when `opt.occ_sampling` is not set."""
    if not getattr(opt, "occ_sampling", False):
        return None
    return OccConfig(
        grid_size=getattr(opt, "occ_grid_size", 128),
        update_interval=getattr(opt, "occ_update_interval", 16),
        density_thresh=getattr(opt, "density_thresh", 10.0),
        floor=getattr(opt, "occ_floor", 0.05),
        bins=getattr(opt, "occ_bins", 128),
        dilate=getattr(opt, "occ_dilate", 1),
    )


def init_occ_grid(cfg: OccConfig, device=None) -> torch.Tensor:
    return torch.zeros((cfg.grid_size,) * 3, dtype=torch.float32, device=device)


@torch.no_grad()
def update_occ_grid(network, grid, cfg: OccConfig, bound: float, generator=None, jitter=None):
    """EMA-max refresh from the current field: max(grid * decay, sigma(jittered cell point)).

    Queries `network.density` (the model's own precision policy) at one
    uniformly jittered point per cell. `jitter` [G, G, G, 3] in [0, 1) may be
    injected; it is drawn from `generator` otherwise.
    """
    G = cfg.grid_size
    dev = grid.device
    idx = torch.arange(G, dtype=torch.float32, device=dev)
    cell = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1)  # [G, G, G, 3]
    if jitter is None:
        jitter = torch.rand((G, G, G, 3), generator=generator, dtype=torch.float32, device=dev)
    x = -bound + (cell + jitter) * (2.0 * bound / G)
    sigma, _ = network.density(x.reshape(-1, 3))
    return torch.maximum(grid * cfg.decay, sigma.reshape(G, G, G).float())


def occupied_volume(grid, cfg: OccConfig):
    """[G, G, G] 0/1: cells within `dilate` cells of one above min(mean(grid), density_thresh).

    The dilation is a 3-D max-pool: torch pads it with -inf where XLA's
    "SAME" reduce_window pads with its init 0, which cannot win a max over
    values of 0 and 1.
    """
    occ3 = (grid > torch.clamp(grid.mean(), max=cfg.density_thresh)).float()
    if cfg.dilate > 0:
        k = 2 * cfg.dilate + 1
        occ3 = F.max_pool3d(occ3[None, None], k, stride=1, padding=cfg.dilate)[0, 0]
    return occ3


def bin_cells(rays_o, rays_d, nears, fars, cfg: OccConfig, bound: float):
    """[N, bins] int64: the flat index of the grid cell nearest each bin's midpoint."""
    G, K = cfg.grid_size, cfg.bins
    t = (torch.arange(K, dtype=torch.float32, device=rays_o.device) + 0.5) / K
    z = nears + (fars - nears) * t[None, :]  # [N, K] bin midpoints
    x = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    gi = torch.clamp(torch.floor((x + bound) * (G / (2.0 * bound))).long(), 0, G - 1)
    return (gi[..., 0] * G + gi[..., 1]) * G + gi[..., 2]


def occ_bin_pdf(grid, rays_o, rays_d, nears, fars, cfg: OccConfig, bound: float):
    """[N, bins] piecewise-constant sampling PDF along each ray.

    A bin counts as occupied when the nearest grid cell of its midpoint is
    in `occupied_volume`. The lookup is a plain index on both devices (the
    hand-written P12 kernel, `ops/occ_lookup.py`, computes the same values).
    """
    K = cfg.bins
    flat = bin_cells(rays_o, rays_d, nears, fars, cfg, bound)  # [N, K]
    w = occupied_volume(grid, cfg).reshape(-1)[flat] + 1e-8  # all-empty rays degrade to uniform
    # summed in float64 and rounded once, so the sum does not depend on the
    # order a device reduces in (the GPU's and the CPU's pdfs agree bit for bit)
    pdf = w / w.double().sum(dim=-1, keepdim=True).float()
    return (1.0 - cfg.floor) * pdf + cfg.floor / K


def occ_z_vals(nears, fars, pdf, num_steps: int, perturb: bool, xi=None, generator=None):
    """Sorted depths [N, num_steps] from the per-ray bin PDF by stratified inverse CDF.

    With `perturb`, u = (j + xi) / num_steps, one draw per stratum; `xi`
    [N, num_steps] uniform [0, 1) may be injected (the JAX renderer draws it
    with the stratified jitter's key and shape) and is drawn from `generator`
    otherwise. Without it u is the inclusive linspace, which inverts a
    uniform PDF to the stratified sampler's depths.
    """
    N, K = pdf.shape
    dev = pdf.device
    if perturb:
        if xi is None:
            xi = torch.rand((N, num_steps), generator=generator, dtype=torch.float32, device=dev)
        u = (torch.arange(num_steps, dtype=torch.float32, device=dev)[None, :] + xi) / num_steps
    else:
        u = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=dev)
        u = u.expand(N, num_steps).contiguous()

    # float32 terms of at least floor / K sum exactly in float64, whatever the
    # order: the cdf is the correctly rounded one on every device
    cdf = torch.cumsum(pdf.double(), dim=-1).float()
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [N, K+1]
    # the floor keeps every pdf entry positive, so cdf rises strictly and the
    # bin below u is the count of cdf[1:] <= u (clipped), the one above the
    # next: the same entries the JAX package's masked max/min select
    below = torch.clamp(torch.searchsorted(cdf[:, 1:].contiguous(), u, right=True), max=K - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, below + 1)
    bin_w = (fars - nears) / K
    edge_b = nears + bin_w * below.float()
    denom = torch.where(cdf_a - cdf_b < 1e-12, 1.0, cdf_a - cdf_b)
    frac = torch.clamp((u - cdf_b) / denom, 0.0, 1.0)
    return edge_b + frac * bin_w
