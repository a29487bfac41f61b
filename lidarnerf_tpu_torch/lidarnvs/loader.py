"""Frame extraction for the classical baselines (counterpart of
lidarnerf_tpu/lidarnvs/loader.py).

The frame dict holds numpy arrays, with the JAX package's keys, dtypes and
values; the rays come from the port's `get_lidar_rays`, on the CPU.
"""

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar_with_intensities


def homo_project(points, mat):
    """Apply a 4x4 transform to (N, 3) points."""
    h = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)
    return (h @ np.asarray(mat).T)[:, :3]


def extract_dataset_frame(dataset, frame_idx, rm_pano_mask=True, verbose=False):
    """Unpack one dataset frame into a pano/points/rays dict of numpy arrays."""
    lidar_pose = np.asarray(dataset.poses_lidar[frame_idx])
    pano = np.array(dataset.images_lidar[frame_idx][:, :, 2])
    intensities = np.array(dataset.images_lidar[frame_idx][:, :, 1])
    lidar_K = dataset.intrinsics_lidar
    lidar_H = dataset.H_lidar
    lidar_W = dataset.W_lidar

    pano_mask = pano != -1
    if rm_pano_mask:
        pano[pano == -1] = 0

    ray_dict = get_lidar_rays(torch.from_numpy(lidar_pose[None]), lidar_K, lidar_H, lidar_W)
    rays_o = ray_dict["rays_o"][0].numpy()
    rays_d = ray_dict["rays_d"][0].numpy()
    rays = np.concatenate([rays_o, rays_d], axis=-1)

    pts_i = pano_to_lidar_with_intensities(pano, intensities, lidar_K)
    local_points = pts_i[:, :3]
    local_point_intensities = pts_i[:, 3]
    points = homo_project(local_points, lidar_pose)

    return {
        "rays": rays,
        "lidar_pose": lidar_pose,
        "lidar_K": lidar_K,
        "lidar_H": lidar_H,
        "lidar_W": lidar_W,
        "pano": pano,
        "pano_mask": pano_mask,
        "intensities": intensities,
        "local_points": local_points,
        "local_point_intensities": local_point_intensities,
        "points": points,
        "point_intensities": local_point_intensities,
    }
