"""Pano (range image) <-> point cloud conversion, numpy (copy of
lidarnerf_tpu/dataset/convert.py).

Projection: each local point goes to the pixel of its azimuth and elevation;
the closest point wins a pixel (a scatter-min), and the bbox-mask variant
leaves -1 outside the projected rectangle of an object's OBB (the NeRF-MVL
panos). `pano_to_lidar*` turn a depth pano back into points along the
pano's ray directions (`pano_dirs`).

Spherical projection convention:
    beta  = pi - atan2(y, x)                      (azimuth -> column)
    alpha = atan2(z, sqrt(x^2+y^2)) + fov_down    (elevation -> row)
    c = round(beta / (2 pi / W)),  r = round(H - alpha / (fov/180*pi / H))
"""

import numpy as np


def _project_rc(points, lidar_H, lidar_W, lidar_K):
    """Row/col pixel indices for local points; returns (r, c, dists)."""
    fov_up, fov = lidar_K
    fov_down = fov - fov_up
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dists = np.linalg.norm(points, axis=1)
    beta = np.pi - np.arctan2(y, x)
    alpha = np.arctan2(z, np.sqrt(x**2 + y**2)) + fov_down / 180 * np.pi
    c = np.round(beta / (2 * np.pi / lidar_W)).astype(np.int64)
    r = np.round(lidar_H - alpha / (fov / 180 * np.pi / lidar_H)).astype(np.int64)
    return r, c, dists


def lidar_to_pano_with_intensities(
    local_points_with_intensities, lidar_H, lidar_W, lidar_K, max_depth=80
):
    """Project local LiDAR points to a (depth, intensity) pano; closest wins.

    For each pixel the point with the least range sets both depth and
    intensity (a scatter-min).

    Returns:
        pano: (H, W) float64 depths (0 where no point).
        intensities: (H, W) float64.
    """
    pts = np.asarray(local_points_with_intensities)
    local_points = pts[:, :3]
    intensities = pts[:, 3]
    r, c, dists = _project_rc(local_points, lidar_H, lidar_W, lidar_K)

    valid = (
        (dists < max_depth) & (r >= 0) & (r < lidar_H) & (c >= 0) & (c < lidar_W)
    )
    r, c, dists, intensities = r[valid], c[valid], dists[valid], intensities[valid]

    flat = r * lidar_W + c
    # scatter-min depth per pixel
    pano = np.full(lidar_H * lidar_W, np.inf)
    np.minimum.at(pano, flat, dists)
    # winner's intensity: a point wins iff its dist equals the pixel min;
    # ties broken by later-index-wins is unobservable (equal dists).
    inten = np.zeros(lidar_H * lidar_W)
    winner = dists <= pano[flat]
    inten[flat[winner]] = intensities[winner]
    pano[~np.isfinite(pano)] = 0.0
    return pano.reshape(lidar_H, lidar_W), inten.reshape(lidar_H, lidar_W)


def lidar_to_pano(local_points, lidar_H, lidar_W, lidar_K, max_depth=80):
    """Local points [N, 3] -> (H, W) depth pano, closest point wins."""
    pts = np.concatenate(
        [local_points, np.zeros((local_points.shape[0], 1))], axis=1
    )
    pano, _ = lidar_to_pano_with_intensities(pts, lidar_H, lidar_W, lidar_K, max_depth)
    return pano


def lidar_to_pano_with_intensities_with_bbox_mask(
    local_points_with_intensities,
    lidar_H,
    lidar_W,
    lidar_K,
    bbox_local,
    max_depth=80,
    max_intensity=255.0,
):
    """Project onto a pano that is -1 outside the projected bbox rectangle.

    The 8 bbox corners project to pixel coords; the [r_min:r_max, c_min:c_max]
    rectangle is unmasked (0), points scatter in as usual, everything else
    stays -1. Intensities are normalized by max_intensity.
    """
    pano, inten = lidar_to_pano_with_intensities(
        local_points_with_intensities, lidar_H, lidar_W, lidar_K, max_depth
    )
    inten = inten / max_intensity

    bbox = np.asarray(bbox_local)[:, :3]
    r, c, _ = _project_rc(bbox, lidar_H, lidar_W, lidar_K)
    inb = (r >= 0) & (r < lidar_H) & (c >= 0) & (c < lidar_W)
    mask = np.full((lidar_H, lidar_W), -1.0)
    if inb.any():
        r_min, r_max = r[inb].min(), r[inb].max()
        c_min, c_max = c[inb].min(), c[inb].max()
        mask[r_min:r_max, c_min:c_max] = 0.0
    # outside the rect, pixels stay -1 even if a point projects there (the
    # scatter never overwrites a -1 pixel)
    out_pano = np.where(mask == 0.0, pano, -1.0)
    out_inten = np.where((mask == 0.0) & (pano > 0), inten, 0.0)
    return out_pano, out_inten


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


def pano_to_lidar_padded(pano, lidar_K):
    """Fixed-shape variant: ([H*W, 3] points, [H*W] bool mask of the nonzero depths)."""
    pano = np.asarray(pano)
    H, W = pano.shape
    dirs = pano_dirs(H, W, lidar_K, dtype=np.float32)
    pts = (dirs * pano.reshape(H, W, 1)).reshape(-1, 3)
    return pts, (pano != 0.0).reshape(-1)


def lidar_to_pano_with_intensities_fpa(
    local_points_with_intensities,
    lidar_H,
    lidar_W,
    lidar_K,
    max_depth=80,
    z_buffer_len=10,
    threshold=0.2,
):
    """Fixed-point-averaging raycast, vectorized.

    Per pixel: keep the z_buffer_len closest points, then inverse-distance
    weighted average of those within `threshold` of the closest. The
    original incremental ring buffer keeps the z_buffer_len *first* points
    (resorting on overflow); keeping the closest is its stated intent and
    differs only on pixels hit by more than z_buffer_len points.
    """
    pts = np.asarray(local_points_with_intensities)
    r, c, dists = _project_rc(pts[:, :3], lidar_H, lidar_W, lidar_K)
    inten = pts[:, 3]
    valid = (
        (dists < max_depth) & (r >= 0) & (r < lidar_H) & (c >= 0) & (c < lidar_W)
    )
    r, c, dists, inten = r[valid], c[valid], dists[valid], inten[valid]
    flat = r * lidar_W + c

    # per-pixel top-k by distance via lexsort then rank
    order = np.lexsort((dists, flat))
    flat_s, dists_s, inten_s = flat[order], dists[order], inten[order]
    first_idx = np.r_[True, flat_s[1:] != flat_s[:-1]]
    group_start = np.maximum.accumulate(np.where(first_idx, np.arange(len(flat_s)), 0))
    rank = np.arange(len(flat_s)) - group_start
    keep = rank < z_buffer_len
    flat_s, dists_s, inten_s, rank = (
        flat_s[keep],
        dists_s[keep],
        inten_s[keep],
        rank[keep],
    )

    depth_buf = np.zeros((lidar_H * lidar_W, z_buffer_len))
    inten_buf = np.zeros((lidar_H * lidar_W, z_buffer_len))
    count = np.zeros(lidar_H * lidar_W, np.int64)
    depth_buf[flat_s, rank] = dists_s
    inten_buf[flat_s, rank] = inten_s
    np.add.at(count, flat_s, 1)

    pano = np.zeros(lidar_H * lidar_W)
    pano_i = np.zeros(lidar_H * lidar_W)
    hit = count > 0
    closest = np.where(
        hit, depth_buf.min(axis=1, where=depth_buf > 0, initial=np.inf), 0.0
    )
    sel = (depth_buf > 0) & (depth_buf <= (closest[:, None] + threshold))
    w = np.where(sel, 1.0 / np.where(depth_buf > 0, depth_buf, 1.0), 0.0)
    wsum = w.sum(axis=1)
    good = wsum > 0
    pano[good] = (w * depth_buf).sum(axis=1)[good] / wsum[good]
    pano_i[good] = (w * inten_buf).sum(axis=1)[good] / wsum[good]
    return pano.reshape(lidar_H, lidar_W), pano_i.reshape(lidar_H, lidar_W)
