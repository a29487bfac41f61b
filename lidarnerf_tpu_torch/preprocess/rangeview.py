"""Offline range-view generation: raw LiDAR -> pano npy/npz training data
(copy of lidarnerf_tpu/preprocess/rangeview.py).

KITTI-360: frames [seq_start, seq_start+63], H=66 x W=1030, intrinsics
(2.0, 26.9) -> `<frame>.npy` [H, W, 3] with ch1=intensity, ch2=depth. The
projection is the host C++ library's (`native/`) where it builds, else the
numpy scatter-min of `dataset/convert.py`; `native.route()` says which.

NeRF-MVL: per-class PCA oriented bounding box, H=256 x W=1800, intrinsics
(15, 40), bbox-masked panos -> `<frame>.npz{data}`. The OBB's eigenvectors
come from numpy on the host (`np.linalg.eig`), so that their signs and order,
and with them `dataset_bbox_7k.npy`, are the JAX package's bit for bit.
"""

import os
import shutil
from pathlib import Path

import numpy as np

from lidarnerf_tpu_torch import native
from lidarnerf_tpu_torch.dataset.convert import (
    lidar_to_pano_with_intensities,
    lidar_to_pano_with_intensities_with_bbox_mask,
)

ALL_MVL_CLASSES = [
    "water_safety_barrier",
    "tire",
    "pier",
    "plant",
    "warning_sign",
    "traffic_cone",
    "bollard",
    "pedestrian",
    "car",
]

KITTI_RANGEVIEW = dict(H=66, W=1030, intrinsics=(2.0, 26.9))
MVL_RANGEVIEW = dict(H=256, W=1800, intrinsics=(15, 40))


def oriented_bounding_box_xy(data_xy, offset=0.03):
    """PCA-aligned 2-D OBB corners."""
    mean = data_xy.mean(axis=0)
    norm = data_xy - mean
    C = np.cov(norm, rowvar=False)
    vals, vecs = np.linalg.eig(C)
    vecs = vecs[:, np.argsort(-vals)]
    Y = norm @ vecs
    xmin, xmax = Y[:, 0].min() - offset, Y[:, 0].max() + offset
    ymin, ymax = Y[:, 1].min() - offset, Y[:, 1].max() + offset
    corners = np.array([[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax]])
    return corners @ vecs.T + mean


def compute_dataset_bbox(class_names, dataset_root, out_dir):
    """Per-class world-frame OBB (top 4 + bottom 4 corners) -> dataset_bbox_7k.npy."""
    object_bbox = {}
    for class_name in class_names:
        lidar_path = os.path.join(dataset_root, class_name)
        filenames = sorted(
            (f for f in os.listdir(lidar_path) if f != "lidar2world.txt"),
            key=lambda x: int(x.split(".")[0]),
        )
        lidar2world = np.loadtxt(os.path.join(lidar_path, "lidar2world.txt"))
        pts_w = []
        for i, fn in enumerate(filenames):
            pc = np.load(os.path.join(lidar_path, fn))
            pc = pc.copy()
            pc[:, -1] = 1
            pts_w.append((pc @ lidar2world[i].reshape(4, 4).T)[:, :3])
        pcd = np.concatenate(pts_w)
        obb_xy = oriented_bounding_box_xy(pcd[:, :2])
        z_min, z_max = pcd[:, 2].min(), pcd[:, 2].max()
        top = np.concatenate([obb_xy, np.full((4, 1), z_max)], axis=1)
        bottom = np.concatenate([obb_xy, np.full((4, 1), z_min)], axis=1)
        object_bbox[class_name] = np.concatenate([top, bottom])
    np.save(os.path.join(out_dir, "dataset_bbox_7k.npy"), object_bbox)
    return object_bbox


def lidar_to_rangeview_kitti(points, H=66, W=1030, intrinsics=(2.0, 26.9), max_depth=80.0):
    """(N,4) points -> [H, W, 3] range view, ch1=intensity ch2=depth.

    Uses the native C++ projection when its library builds (`native/`),
    else the numpy scatter-min.
    """
    if native.available():
        pano, intensities = native.lidar_to_pano_with_intensities(
            points, H, W, intrinsics, max_depth
        )
    else:
        pano, intensities = lidar_to_pano_with_intensities(
            points, H, W, intrinsics, max_depth
        )
    rv = np.zeros((H, W, 3))
    rv[:, :, 1] = intensities
    rv[:, :, 2] = pano
    return rv


def lidar_to_rangeview_mvl(points, OBB_local, H=256, W=1800, intrinsics=(15, 40), max_depth=80.0):
    pano, intensities = lidar_to_pano_with_intensities_with_bbox_mask(
        points, H, W, intrinsics, OBB_local, max_depth
    )
    rv = np.zeros((H, W, 3))
    rv[:, :, 1] = intensities
    rv[:, :, 2] = pano
    return rv


def generate_kitti_rangeviews(lidar_paths, out_dir, points_dim=4, **rv_kwargs):
    """.bin files -> pano .npy files."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for lidar_path in lidar_paths:
        pc = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, points_dim)
        rv = lidar_to_rangeview_kitti(pc, **rv_kwargs)
        frame_name = os.path.basename(str(lidar_path)).rsplit(".", 1)[0] + ".npy"
        np.save(out_dir / frame_name, rv)


def generate_mvl_rangeviews(class_names, dataset_bbox, nerf_mvl_parent_dir, out_dir):
    """Per-class masked panos -> .npz."""
    for class_name in class_names:
        OBB = dataset_bbox[class_name]
        lidar_path = os.path.join(nerf_mvl_parent_dir, "nerf_mvl_7k", class_name)
        filenames = sorted(
            (f for f in os.listdir(lidar_path) if f != "lidar2world.txt"),
            key=lambda x: int(x.split(".")[0]),
        )
        save_path = os.path.join(out_dir, class_name)
        os.makedirs(save_path, exist_ok=True)
        shutil.copy(
            os.path.join(lidar_path, "lidar2world.txt"),
            os.path.join(save_path, "lidar2world.txt"),
        )
        lidar2world = np.loadtxt(os.path.join(lidar_path, "lidar2world.txt"))
        for idx, fn in enumerate(filenames):
            pcd = np.load(os.path.join(lidar_path, fn))
            OBB_local = (
                np.concatenate([OBB, np.ones((8, 1))], axis=1)
                @ np.linalg.inv(lidar2world[idx].reshape(4, 4)).T
            )
            rv = lidar_to_rangeview_mvl(pcd, OBB_local, **MVL_RANGEVIEW)
            np.savez_compressed(
                os.path.join(save_path, "{:010d}.npz".format(idx)), data=rv
            )

