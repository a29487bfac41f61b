"""Ray generation and training pixel sampling (counterpart of
lidarnerf_tpu/dataset/base.py:22-154): LiDAR pano rays and pinhole camera
rays, and the instant-ngp pose permutation.

All trig runs in float32, as the reference pins ray generation to fp32.
Random draws come from an explicit `torch.Generator`, or are injected.
"""

import math

import numpy as np
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


def patch_dims(patch_size):
    if isinstance(patch_size, int):
        return patch_size, patch_size
    if len(patch_size) == 1:
        return patch_size[0], patch_size[0]
    return tuple(patch_size)


def sample_ray_indices(H, W, N, patch_size, generator=None, device=None, corners=None):
    """Flat pixel indices for one training step, [N] int64.

    With a patch (px, py) > 1: N // (px*py) random top-left corners in
    [0, H - px) x [0, W - py), each expanded to a px x py block in the JAX
    package's order (row offset slowest); otherwise N independent random
    pixels (duplicates allowed).

    Args:
        generator: the `torch.Generator` the draws come from.
        corners: optional (ix, iy) [N // (px*py)] injected corner draws.
    """
    px, py = patch_dims(patch_size)
    if px > 1 or py > 1:
        num_patch = N // (px * py)
        if corners is None:
            ix = torch.randint(0, H - px, (num_patch,), generator=generator, device=device)
            iy = torch.randint(0, W - py, (num_patch,), generator=generator, device=device)
        else:
            ix, iy = (torch.as_tensor(c, device=device).long() for c in corners)
        pi, pj = torch.meshgrid(torch.arange(px, device=ix.device),
                                torch.arange(py, device=ix.device), indexing="ij")
        rows = (ix[:, None] + pi.reshape(1, -1)).reshape(-1)
        cols = (iy[:, None] + pj.reshape(1, -1)).reshape(-1)
        return rows * W + cols
    return torch.randint(0, H * W, (N,), generator=generator, device=device)


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


def get_lidar_rays(poses, intrinsics, H, W, N=-1, patch_size=1, generator=None):
    """Rays of each pose: all H*W row-major (N = -1), or N sampled pixels.

    Args:
        poses: [B, 4, 4] lidar2world (tensor; its device is the rays' device).
        N: rays per pose, -1 for every pixel; the sampled pixels
            (`sample_ray_indices`, one draw shared by all poses) otherwise.
        generator: the `torch.Generator` the sampled pixels come from.

    Returns:
        dict(rays_o [B, N, 3], rays_d [B, N, 3], inds [B, N])
    """
    poses = poses.float()
    if N > 0:
        inds = sample_ray_indices(H, W, min(N, H * W), patch_size, generator, poses.device)
    else:
        inds = torch.arange(H * W, device=poses.device)
    ro, rd = zip(*(rays_from_indices(p, inds, H, W, intrinsics) for p in poses))
    B = poses.shape[0]
    return {
        "rays_o": torch.stack(ro),
        "rays_d": torch.stack(rd),
        "inds": inds.expand(B, inds.shape[0]),
    }


def get_rays(poses, intrinsics, H, W, N=-1, patch_size=1, generator=None, inds=None):
    """Pinhole-camera rays of each pose: all H*W row-major (N = -1), or N
    sampled pixels (`sample_ray_indices`, one draw shared by all poses).

    Args:
        poses: [B, 4, 4] camera2world (tensor; its device is the rays' device).
        intrinsics: (fx, fy, cx, cy); a pixel's ray passes through its centre.
        generator: the `torch.Generator` the sampled pixels come from.
        inds: optional [N] injected flat pixel indices (N is then not read).

    Returns:
        dict(rays_o [B, N, 3], rays_d [B, N, 3] unit, inds [B, N])
    """
    poses = poses.float()
    fx, fy, cx, cy = intrinsics
    if inds is not None:
        inds = torch.as_tensor(inds, device=poses.device).long()
    elif N > 0:
        inds = sample_ray_indices(H, W, min(N, H * W), patch_size, generator, poses.device)
    else:
        inds = torch.arange(H * W, device=poses.device)
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = torch.einsum("nc,brc->bnr", dirs, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand_as(rays_d)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds.expand(poses.shape[0], inds.shape[0])}


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """Axis permutation to instant-ngp convention (base_dataset.py:186-197):
    a float32 [4, 4] numpy array from a [4, 4] numpy pose."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )
