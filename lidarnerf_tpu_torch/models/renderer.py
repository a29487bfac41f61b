"""LiDAR volume renderer (counterpart of lidarnerf_tpu/models/renderer.py:34-220).

- LiDAR rays: near = min_near_lidar, far = far_mult * min_near_lidar;
- num_steps stratified samples, jittered when training, or, with
  `RenderConfig.occ` and an occupancy grid (`--fast`), num_steps samples
  drawn from the grid's per-ray PDF (models/occupancy.py); xyz clipped to
  the AABB;
- one round of inverse-CDF upsampling on the detached coarse weights,
  deterministic at inference, with uniform draws when training;
- order-free merged compositing of the coarse and fine lists;
- depth = sum(w * z), image = sum(w * color), colors zeroed where w <= 1e-4.

`render_rays` with `train=True` is the training render; its randomness (the
stratified jitter and the `u` of the inverse CDF) is injected or drawn from
a `torch.Generator`, so tests can feed the JAX package's draws.
`render_rays_staged` renders a full pano in fixed `chunk`-ray blocks, for
inference only. RGB mode and the background sphere are not ported yet.
"""

from dataclasses import dataclass

import torch

from lidarnerf_tpu_torch.models.occupancy import OccConfig, occ_bin_pdf, occ_z_vals
from lidarnerf_tpu_torch.ops.compositing import merged_composite_weights, composite_weights
from lidarnerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals


@dataclass(frozen=True)
class RenderConfig:
    num_steps: int = 768
    upsample_steps: int = 64
    min_near_lidar: float = 0.01
    min_near: float = 0.2
    density_scale: float = 1.0
    bound: float = 1.0
    cal_lidar_color: bool = True
    weight_mask_thresh: float = 1e-4
    far_mult: float = 81.0  # the reference's hard-coded far = 81 * min_near_lidar
    bg_radius: float = -1.0
    # occupancy-prior sampling (--fast): with an occ_grid passed to
    # render_rays, the coarse samples come from the grid's per-ray PDF
    occ: OccConfig = None


def near_far_from_aabb(rays_o, rays_d, aabb_min, aabb_max, min_near):
    """Slab test -> (near [N, 1], far [N, 1])."""
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-15, 1e-15, rays_d)
    t0 = (aabb_min - rays_o) * inv_d
    t1 = (aabb_max - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    near = torch.clamp(near, min=min_near)
    far = torch.maximum(far, near + 1e-6)
    return near[..., None], far[..., None]


def render_rays(network, rays_o, rays_d, cfg: RenderConfig, train=False, generator=None,
                noise=None, u=None, occ_grid=None):
    """Render a flat batch of LiDAR rays.

    Args:
        network: NeRFNetwork on the rays' device.
        rays_o, rays_d: [N, 3] float32.
        train: jitter the stratified samples and draw the inverse-CDF `u`
            uniformly (`perturb=train`, `det=not train` in the JAX package).
        generator: the `torch.Generator` the training draws come from.
        noise: optional [N, num_steps] uniform [0, 1) jitter draws; under
            occupancy sampling the per-stratum `xi` of `occ_z_vals` (the JAX
            renderer draws both from one key at one shape).
        u: optional [N, upsample_steps] uniform [0, 1) inverse-CDF draws.
        occ_grid: optional [G, G, G] occupancy grid; with `cfg.occ` set, the
            coarse samples are drawn from its per-ray PDF.

    Returns:
        dict(depth [N], image [N, 2] = (raydrop, intensity), weights_sum [N])
    """
    if not cfg.cal_lidar_color or cfg.bg_radius > 0:
        raise NotImplementedError("RGB rendering and the background sphere are not ported yet")
    N = rays_o.shape[0]
    dev = rays_o.device
    rays_o = rays_o.float()
    rays_d = rays_d.float()
    aabb_min = torch.full((3,), -cfg.bound, dtype=torch.float32, device=dev)
    aabb_max = torch.full((3,), cfg.bound, dtype=torch.float32, device=dev)

    nears = torch.full((N, 1), cfg.min_near_lidar, dtype=torch.float32, device=dev)
    fars = torch.full((N, 1), cfg.min_near_lidar * cfg.far_mult, dtype=torch.float32, device=dev)
    if cfg.occ is not None and occ_grid is not None:
        pdf = occ_bin_pdf(occ_grid, rays_o, rays_d, nears, fars, cfg.occ, cfg.bound)
        z_vals = occ_z_vals(nears, fars, pdf, cfg.num_steps, perturb=train, xi=noise,
                            generator=generator)
    else:
        z_vals = stratified_z_vals(nears, fars, cfg.num_steps, perturb=train, noise=noise,
                                   generator=generator)
    sample_dist = (fars - nears) / cfg.num_steps  # [N, 1]

    def query_density(z):
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        xyz = torch.clamp(xyz, aabb_min, aabb_max)
        return network.density(xyz)

    sigmas, geo_feats = query_density(z_vals)  # [N, T], [N, T, G]
    d_enc = network.encode_dir(rays_d)  # [N, E], once per ray

    def colors(geo, weights):
        d_enc_b = d_enc[:, None, :].expand(*geo.shape[:-1], d_enc.shape[-1])
        rgbs = network.color_from_enc(d_enc_b, geo)  # [N, S, 2]
        return torch.where((weights > cfg.weight_mask_thresh)[..., None], rgbs, 0.0)

    if cfg.upsample_steps > 0:
        w_coarse = composite_weights(sigmas.detach(), z_vals, sample_dist, cfg.density_scale)
        z_mid = z_vals[..., :-1] + 0.5 * (z_vals[..., 1:] - z_vals[..., :-1])  # [N, T-1]
        new_z = sample_pdf(z_mid, w_coarse[:, 1:-1], cfg.upsample_steps, det=not train, u=u,
                           generator=generator)
        new_z = torch.sort(new_z.detach(), dim=-1).values
        new_sigmas, new_geo = query_density(new_z)

        weights, new_weights = merged_composite_weights(
            z_vals, sigmas, new_z, new_sigmas, sample_dist, cfg.density_scale
        )
        weights_sum = weights.sum(-1) + new_weights.sum(-1)
        depth = (weights * z_vals).sum(-1) + (new_weights * new_z).sum(-1)
        image = (weights[..., None] * colors(geo_feats, weights)).sum(-2) + (
            new_weights[..., None] * colors(new_geo, new_weights)
        ).sum(-2)
    else:
        weights = composite_weights(sigmas, z_vals, sample_dist, cfg.density_scale)
        weights_sum = weights.sum(-1)
        depth = (weights * z_vals).sum(-1)
        image = (weights[..., None] * colors(geo_feats, weights)).sum(-2)

    return {"depth": depth, "image": image, "weights_sum": weights_sum}


@torch.no_grad()
def render_rays_staged(network, rays_o, rays_d, cfg: RenderConfig, chunk: int = 4096,
                       occ_grid=None):
    """Full-pano inference in fixed `chunk`-ray blocks.

    rays_o/rays_d: [N, 3]; N is padded up to a multiple of `chunk`, padded
    rays get rays_d = 1 (no zero direction), and the blocks run in order.
    occ_grid: as for `render_rays`.
    """
    N = rays_o.shape[0]
    pad = (-N) % chunk
    ro = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
    rd = torch.cat([rays_d, rays_d.new_ones((pad, 3))])
    outs = [
        render_rays(network, ro[i : i + chunk], rd[i : i + chunk], cfg, occ_grid=occ_grid)
        for i in range(0, N + pad, chunk)
    ]
    return {k: torch.cat([o[k] for o in outs])[:N] for k in ("depth", "image", "weights_sum")}
