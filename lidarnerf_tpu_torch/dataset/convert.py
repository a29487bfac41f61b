"""Pano <-> point-cloud conversion, numpy (copy of lidarnerf_tpu/dataset/convert.py:111-147)."""

import numpy as np


def pano_dirs(lidar_H, lidar_W, lidar_K, dtype=np.float32):
    """[H, W, 3] unit ray directions of the pano grid."""
    fov_up, fov = lidar_K
    i, j = np.meshgrid(
        np.arange(lidar_W, dtype=dtype), np.arange(lidar_H, dtype=dtype), indexing="xy"
    )
    beta = -(i - lidar_W / 2) / lidar_W * 2 * np.pi
    alpha = (fov_up - j / lidar_H * fov) / 180 * np.pi
    return np.stack(
        [
            np.cos(alpha) * np.cos(beta),
            np.cos(alpha) * np.sin(beta),
            np.sin(alpha),
        ],
        axis=-1,
    )


def pano_to_lidar_with_intensities(pano, intensities, lidar_K):
    """pano [H, W] -> (N, 4) points with intensities, dropping zero-depth pixels."""
    pano = np.asarray(pano)
    H, W = pano.shape
    dirs = pano_dirs(H, W, lidar_K, dtype=np.float32)
    local_points = dirs * pano.reshape(H, W, 1)
    pts = np.concatenate(
        [local_points, np.asarray(intensities).reshape(H, W, 1)], axis=2
    )
    return pts[pano != 0.0]


def pano_to_lidar(pano, lidar_K):
    """pano [H, W] -> (N, 3) points, dropping zero-depth pixels."""
    return pano_to_lidar_with_intensities(
        pano, np.zeros_like(np.asarray(pano)), lidar_K
    )[:, :3]
