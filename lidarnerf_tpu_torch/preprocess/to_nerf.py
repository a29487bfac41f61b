"""transforms_*.json writers for KITTI-360 and NeRF-MVL (copy of
lidarnerf_tpu/preprocess/to_nerf.py).

Emits the json schema the datasets consume:
{w, h, w_lidar, h_lidar, fl_x, fl_y, cx, cy, aabb_scale,
 frames: [{file_path, transform_matrix, lidar_file_path, lidar2world}]}.
The camera image's size comes from its PNG header (`utils/image_io.png_size`),
not from OpenCV, which the port does not need.
"""

import json
import os
from pathlib import Path

import numpy as np

from lidarnerf_tpu_torch.preprocess.kitti360_loader import KITTI360Loader
from lidarnerf_tpu_torch.utils.image_io import png_size

# per-sequence frame windows and fixed val frames
KITTI_SEQUENCES = {
    "1538": dict(start=1538, end=1601, val=[1551, 1564, 1577, 1590]),
    "1728": dict(start=1728, end=1791, val=[1741, 1754, 1767, 1780]),
    "1908": dict(start=1908, end=1971, val=[1921, 1934, 1947, 1960]),
    "3353": dict(start=3353, end=3416, val=[3366, 3379, 3392, 3405]),
}

# per-class train sampling stride
MVL_TRAIN_SPLIT = {
    "water_safety_barrier": 2,
    "tire": 2,
    "pier": 2,
    "plant": 2,
    "warning_sign": 2,
    "bollard": 2,
    "pedestrian": 3,
    "car": 3,
    "traffic_cone": 3,
}


def T_to_pose(T):
    """world->cam T to cam->world pose."""
    return np.linalg.inv(T)


def write_kitti360_transforms(
    kitti_360_root,
    out_dir,
    sequence_id="1908",
    sequence_name="2013_05_28_drive_0000",
    rangeview_dir=None,
):
    """Write transforms_{seq}_{train,val,test}.json."""
    seq = KITTI_SEQUENCES[sequence_id]
    frame_ids = list(range(seq["start"], seq["end"] + 1))
    val_ids = seq["val"]
    test_ids = val_ids
    train_ids = [f for f in frame_ids if f not in val_ids]

    k3 = KITTI360Loader(kitti_360_root)
    Ks, Ts = k3.load_cameras("cam_00", sequence_name, frame_ids)
    lidar2world = k3.load_lidars(sequence_name, frame_ids)

    out_dir = Path(out_dir)
    rangeview_dir = Path(rangeview_dir or (out_dir / "train"))
    rv_paths = [rangeview_dir / "{:010d}.npy".format(f) for f in frame_ids]
    lidar_h, lidar_w, _ = np.load(rv_paths[0]).shape

    im_paths = k3.get_image_paths("cam_00", sequence_name, frame_ids)
    # KITTI-360's rectified size where the 2D release is absent or unreadable
    im_h, im_w = png_size(im_paths[0]) or (376, 1408)

    id_to_idx = {f: i for i, f in enumerate(frame_ids)}
    for split, ids in [("train", train_ids), ("val", val_ids), ("test", test_ids)]:
        idxs = [id_to_idx[f] for f in ids]
        json_dict = {
            "w": im_w,
            "h": im_h,
            "w_lidar": lidar_w,
            "h_lidar": lidar_h,
            "fl_x": float(Ks[0][0, 0]),
            "fl_y": float(Ks[0][1, 1]),
            "cx": float(Ks[0][0, 2]),
            "cy": float(Ks[0][1, 2]),
            "aabb_scale": 2,
            "frames": [
                {
                    "file_path": str(Path(im_paths[i]).relative_to(out_dir))
                    if str(im_paths[i]).startswith(str(out_dir))
                    else str(im_paths[i]),
                    "transform_matrix": T_to_pose(Ts[i]).tolist(),
                    "lidar_file_path": str(rv_paths[i].relative_to(out_dir)),
                    "lidar2world": lidar2world[i].tolist(),
                }
                for i in idxs
            ],
        }
        json_path = out_dir / f"transforms_{sequence_id}_{split}.json"
        with open(json_path, "w") as f:
            json.dump(json_dict, f, indent=2)
        print(f"Saved {json_path}.")


class NeRFMVLLoader:
    """lidar2world.txt poses per class."""

    def __init__(self, nerf_mvl_root, class_name):
        self.root = Path(nerf_mvl_root)
        self.data_dir = self.root / class_name
        self.lidar2world_path = self.data_dir / "lidar2world.txt"
        if not self.data_dir.is_dir():
            raise FileNotFoundError(f"{self.data_dir} not found.")

    def load_lidars(self, frame_ids):
        all_poses = np.loadtxt(self.lidar2world_path).reshape(-1, 4, 4)
        return np.stack([all_poses[f] for f in frame_ids])


def write_nerfmvl_transforms(nerf_mvl_parent_dir, classes=None):
    """Write transforms_{class}_{split}.json."""
    parent = Path(nerf_mvl_parent_dir)
    pano_root = parent / "nerf_mvl_7k_pano"
    classes = classes or list(MVL_TRAIN_SPLIT)
    for class_name in classes:
        stride = MVL_TRAIN_SPLIT[class_name]
        rv_dir = pano_root / class_name
        filenames = [f for f in os.listdir(rv_dir) if f != "lidar2world.txt"]
        rv_paths = [rv_dir / f for f in filenames]
        n = len(rv_paths)
        train_ids = list(range(0, n, stride))
        val_ids = list(range(0, n, stride * 20))
        test_ids = val_ids

        loader = NeRFMVLLoader(pano_root, class_name)
        lidar2world = loader.load_lidars(np.arange(n))
        lidar_h, lidar_w, _ = np.load(rv_paths[0])["data"].shape

        for split, ids in [("train", train_ids), ("val", val_ids), ("test", test_ids)]:
            json_dict = {
                "w_lidar": lidar_w,
                "h_lidar": lidar_h,
                "aabb_scale": 2,
                "frames": [
                    {
                        "lidar_file_path": str(rv_paths[i].relative_to(parent)),
                        "lidar2world": lidar2world[i].tolist(),
                    }
                    for i in ids
                ],
            }
            json_path = parent / f"transforms_{class_name}_{split}.json"
            with open(json_path, "w") as f:
                json.dump(json_dict, f, indent=2)
            print(f"Saved {json_path}.")
