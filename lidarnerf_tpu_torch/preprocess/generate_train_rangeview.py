"""CLI: raw LiDAR -> range-view pano training data (KITTI-360 / NeRF-MVL).

    python -m lidarnerf_tpu_torch.preprocess.generate_train_rangeview [--dataset nerf_mvl]

Counterpart of preprocess/generate_train_rangeview.py over
`lidarnerf_tpu_torch.preprocess.rangeview`, with the same flags and files:
KITTI-360 reads `<root>/data/kitti360/KITTI-360` and writes
`data/kitti360/train/*.npy`; NeRF-MVL reads `<root>/data/nerf_mvl/nerf_mvl_7k`
and writes `dataset_bbox_7k.npy` (where it is missing) and
`nerf_mvl_7k_pano/<class>/*.npz`. `<root>` defaults to the checkout's root.
"""

import argparse
import os
from pathlib import Path

import numpy as np

from lidarnerf_tpu_torch.preprocess import PROJECT_ROOT
from lidarnerf_tpu_torch.preprocess import rangeview as rv


def create_kitti_rangeview(project_root=None, s_frame_id=1908, e_frame_id=1971):
    project_root = Path(project_root or PROJECT_ROOT)
    kitti_360_root = project_root / "data" / "kitti360" / "KITTI-360"
    out_dir = kitti_360_root.parent / "train"
    sequence_name = "2013_05_28_drive_0000"
    lidar_dir = (
        kitti_360_root / "data_3d_raw" / f"{sequence_name}_sync" / "velodyne_points" / "data"
    )
    lidar_paths = [
        os.path.join(lidar_dir, "%010d.bin" % f) for f in range(s_frame_id, e_frame_id + 1)
    ]
    rv.generate_kitti_rangeviews(lidar_paths, out_dir, points_dim=4, **rv.KITTI_RANGEVIEW)


def create_nerf_mvl_rangeview(project_root=None):
    project_root = Path(project_root or PROJECT_ROOT)
    nerf_mvl_root = project_root / "data" / "nerf_mvl" / "nerf_mvl_7k"
    parent = nerf_mvl_root.parent
    out_dir = parent / "nerf_mvl_7k_pano"
    bbox_path = parent / "dataset_bbox_7k.npy"
    if not bbox_path.exists():
        rv.compute_dataset_bbox(rv.ALL_MVL_CLASSES, nerf_mvl_root, parent)
    dataset_bbox = np.load(bbox_path, allow_pickle=True).item()
    rv.generate_mvl_rangeviews(rv.ALL_MVL_CLASSES, dataset_bbox, parent, out_dir)


def get_arg_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="kitti360", choices=["kitti360", "nerf_mvl"])
    return parser


def main(argv=None):
    args = get_arg_parser().parse_args(argv)
    if args.dataset == "kitti360":
        create_kitti_rangeview()
    else:
        create_nerf_mvl_rangeview()


if __name__ == "__main__":
    main()
