"""CLI: write KITTI-360 transforms_{seq}_{split}.json files.

    python -m lidarnerf_tpu_torch.preprocess.kitti360_to_nerf [--sequence_id 1908]

Counterpart of preprocess/kitti360_to_nerf.py: reads
`<root>/data/kitti360/KITTI-360` and the panos in `data/kitti360/train/`,
writes `data/kitti360/transforms_<seq>_{train,val,test}.json`; `<root>` is
the checkout's root.
"""

import argparse

from lidarnerf_tpu_torch.preprocess import PROJECT_ROOT
from lidarnerf_tpu_torch.preprocess.to_nerf import write_kitti360_transforms


def get_arg_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--sequence_id", type=str, default="1908")
    return parser


def main(argv=None):
    args = get_arg_parser().parse_args(argv)
    kitti_360_root = PROJECT_ROOT / "data" / "kitti360" / "KITTI-360"
    write_kitti360_transforms(
        kitti_360_root, kitti_360_root.parent, sequence_id=args.sequence_id
    )


if __name__ == "__main__":
    main()
