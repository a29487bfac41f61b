"""LiDAR volume renderer for inference (counterpart of lidarnerf_tpu/models/renderer.py:34-220).

- LiDAR rays: near = min_near_lidar, far = far_mult * min_near_lidar;
- num_steps stratified samples, no perturb; xyz clipped to the AABB;
- one round of deterministic inverse-CDF upsampling on the coarse weights;
- order-free merged compositing of the coarse and fine lists;
- depth = sum(w * z), image = sum(w * color), colors zeroed where w <= 1e-4.

`render_rays_staged` renders a full pano in fixed `chunk`-ray blocks. Both
entry points are inference (`train=False` in the JAX package): no
randomness, so the port agrees with the JAX package value for value on the
same parameters. RGB mode and the background sphere are not ported yet.
"""

from dataclasses import dataclass

import torch

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


def render_rays(network, rays_o, rays_d, cfg: RenderConfig):
    """Render a flat batch of LiDAR rays.

    Args:
        network: NeRFNetwork on the rays' device.
        rays_o, rays_d: [N, 3] float32.

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
    z_vals = stratified_z_vals(nears, fars, cfg.num_steps)
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
        new_z = sample_pdf(z_mid, w_coarse[:, 1:-1], cfg.upsample_steps, det=True)
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
def render_rays_staged(network, rays_o, rays_d, cfg: RenderConfig, chunk: int = 4096):
    """Full-pano inference in fixed `chunk`-ray blocks.

    rays_o/rays_d: [N, 3]; N is padded up to a multiple of `chunk`, padded
    rays get rays_d = 1 (no zero direction), and the blocks run in order.
    """
    N = rays_o.shape[0]
    pad = (-N) % chunk
    ro = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
    rd = torch.cat([rays_d, rays_d.new_ones((pad, 3))])
    outs = [
        render_rays(network, ro[i : i + chunk], rd[i : i + chunk], cfg)
        for i in range(0, N + pad, chunk)
    ]
    return {k: torch.cat([o[k] for o in outs])[:N] for k in ("depth", "image", "weights_sum")}
