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
spread over the whole volume. The functions here stay plain on both devices
and are the reference: the renderer samples through `ops/occ_sample.py`,
whose kernel fuses `volume_bin_pdf` and `occ_z_vals` on CUDA (P12's bin
lookup, tools/exp_occ_lookup.py, with the sampler around it).
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

W_EMPTY = torch.tensor(1e-8, dtype=torch.float32).item()  # an empty bin's weight, 1e-8f, as a double


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
    in `occupied_volume`.
    """
    return volume_bin_pdf(occupied_volume(grid, cfg), rays_o, rays_d, nears, fars, cfg, bound)


def volume_bin_pdf(occ3, rays_o, rays_d, nears, fars, cfg: OccConfig, bound: float):
    """`occ_bin_pdf` from the occupied volume occ3 ([G, G, G] 0/1). The lookup
    is a plain index (P12's kernel, `ops/occ_lookup.py`, computes the same
    values)."""
    K = cfg.bins
    flat = bin_cells(rays_o, rays_d, nears, fars, cfg, bound)  # [N, K]
    w = occ3.reshape(-1)[flat] + 1e-8  # all-empty rays degrade to uniform
    # each weight is 1 or 1e-8f, so the float64 sum is taken from the count of
    # occupied bins, c + (K - c) * 1e-8f: exact products, one add, rounded
    # once; no order enters, so every device gives the same float32 (equal to
    # the float32 of the exact sum, tests/test_torch_occ_sample.py)
    c = (w == 1.0).sum(dim=-1, keepdim=True).double()
    pdf = w / (c + (K - c) * W_EMPTY).float()
    return (1.0 - cfg.floor) * pdf + cfg.floor / K


def occ_draws(N, num_steps: int, perturb: bool, dev, xi=None, generator=None):
    """(xi, u_row) of `occ_z_vals`: with `perturb` the stratified draws xi
    [N, num_steps] (drawn from `generator` unless given) and no row; without
    it no draws and u_row [num_steps], the inclusive linspace."""
    if perturb:
        if xi is None:
            xi = torch.rand((N, num_steps), generator=generator, dtype=torch.float32, device=dev)
        return xi, None
    return None, torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=dev)


def occ_cdf(pdf):
    """[N, K+1] float32: 0, then the cdf after each bin, of a pdf [N, K] whose
    rows hold two values at most (`volume_bin_pdf`'s: p_hi on occupied bins,
    p_lo on empty ones).

    The cdf after bin k is n p_hi + (k + 1 - n) p_lo, n the bins up to k that
    hold p_hi, in float64: exact products, one add, then rounded to float32.
    No order of adds enters, so every device and the kernel
    (`csrc/occ_sample.cu`) give the same bits at any floor. From a floor of
    2^-29 x bins every entry lies on the 2^-52 grid, the sum is exact, and
    this is the float64 cumsum rounded once. Below it (floor 0) the float32
    cdf has plateaus where the JAX package's float32 cumsum has others.
    """
    K = pdf.shape[-1]
    p_hi = pdf.amax(dim=-1, keepdim=True)
    n = torch.cumsum(pdf == p_hi, dim=-1)  # int64; rows of one value: all p_hi
    k = torch.arange(1, K + 1, device=pdf.device)
    cdf = (n.double() * p_hi.double() + (k - n).double() * pdf.amin(dim=-1, keepdim=True).double())
    return torch.cat([torch.zeros_like(pdf[:, :1]), cdf.float()], dim=-1)


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
    xi, u_row = occ_draws(N, num_steps, perturb, dev, xi, generator)
    if perturb:
        u = (torch.arange(num_steps, dtype=torch.float32, device=dev)[None, :] + xi) / num_steps
    else:
        u = u_row.expand(N, num_steps).contiguous()

    cdf = occ_cdf(pdf)  # [N, K+1]
    # the cdf never falls, so the bin below u is the count of cdf[1:] <= u
    # (clipped), the one above the next: the same entries the JAX package's
    # masked max/min select
    below = torch.clamp(torch.searchsorted(cdf[:, 1:].contiguous(), u, right=True), max=K - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, below + 1)
    bin_w = (fars - nears) / K
    edge_b = nears + bin_w * below.float()
    denom = torch.where(cdf_a - cdf_b < 1e-12, 1.0, cdf_a - cdf_b)
    frac = torch.clamp((u - cdf_b) / denom, 0.0, 1.0)
    return edge_b + frac * bin_w
