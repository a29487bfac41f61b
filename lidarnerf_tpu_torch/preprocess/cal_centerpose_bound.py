"""CLI: compute scene centerpose/scale constants for configs/*.txt.

    python -m lidarnerf_tpu_torch.preprocess.cal_centerpose_bound [--root_path data/kitti360]

Counterpart of preprocess/cal_centerpose_bound.py: the same flags and
printed lines (near, far; centerpose, the config's offset; scale).
"""

import argparse

from lidarnerf_tpu_torch.preprocess.normalize import (
    cal_centerpose_bound_scale,
    get_path_pose_from_json,
)


def get_arg_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_path", type=str, default="data/kitti360")
    parser.add_argument("--sequence_id", type=str, default="1908")
    parser.add_argument("--fov_up", type=float, default=2.0)
    parser.add_argument("--fov", type=float, default=26.9)
    return parser


def main(argv=None):
    args = get_arg_parser().parse_args(argv)
    paths, poses = get_path_pose_from_json(args.root_path, args.sequence_id)
    centerpose, scale, near, far = cal_centerpose_bound_scale(
        paths, poses, (args.fov_up, args.fov)
    )
    print("near, far:", near, far)
    print("centerpose: ", centerpose)
    print("scale: ", scale)


if __name__ == "__main__":
    main()
