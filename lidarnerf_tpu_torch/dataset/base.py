"""LiDAR pano ray generation (counterpart of lidarnerf_tpu/dataset/base.py:22-42,72-114).

All trig runs in float32, as the reference pins ray generation to fp32.
"""

import math

import torch


def _pixel_dirs(i, j, intrinsics, H, W):
    """Spherical pano direction for (float) pixel coords i (col), j (row)."""
    fov_up, fov = intrinsics
    beta = -(i - W / 2) / W * 2 * math.pi
    alpha = (fov_up - j / H * fov) / 180 * math.pi
    return torch.stack(
        [
            torch.cos(alpha) * torch.cos(beta),
            torch.cos(alpha) * torch.sin(beta),
            torch.sin(alpha),
        ],
        dim=-1,
    )


def lidar_ray_dirs(H, W, intrinsics, device=None):
    """[H*W, 3] sensor-frame ray directions of the full pano grid, row-major."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return _pixel_dirs(i.reshape(-1), j.reshape(-1), intrinsics, H, W)


def rays_from_indices(pose, inds, H, W, intrinsics):
    """World-frame rays for flat pixel indices under a lidar2world pose.

    Args:
        pose: [4, 4] float32 lidar2world.
        inds: [N] integer flat pixel indices.

    Returns:
        (rays_o [N, 3], rays_d [N, 3])
    """
    i = (inds % W).float()
    j = torch.div(inds, W, rounding_mode="floor").float()
    rays_d = _pixel_dirs(i, j, intrinsics, H, W) @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d)
    return rays_o, rays_d


def get_lidar_rays(poses, intrinsics, H, W, N=-1):
    """All H*W rays of each pose, row-major.

    Args:
        poses: [B, 4, 4] lidar2world (tensor; its device is the rays' device).
        N: must be -1 (every pixel); random ray sampling comes with training.

    Returns:
        dict(rays_o [B, N, 3], rays_d [B, N, 3], inds [B, N])
    """
    if N > 0:
        raise NotImplementedError("random ray sampling comes with the training slice")
    poses = poses.float()
    inds = torch.arange(H * W, device=poses.device)
    ro, rd = zip(*(rays_from_indices(p, inds, H, W, intrinsics) for p in poses))
    B = poses.shape[0]
    return {
        "rays_o": torch.stack(ro),
        "rays_d": torch.stack(rd),
        "inds": inds.expand(B, H * W),
    }
