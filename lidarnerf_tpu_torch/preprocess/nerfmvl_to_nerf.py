"""CLI: write NeRF-MVL transforms_{class}_{split}.json files.

    python -m lidarnerf_tpu_torch.preprocess.nerfmvl_to_nerf [--path DIR] [--classes car ...]

Counterpart of preprocess/nerfmvl_to_nerf.py: reads `<path>/nerf_mvl_7k_pano`
and writes `<path>/transforms_<class>_{train,val,test}.json`; `--path`
defaults to `data/nerf_mvl` under the checkout's root.
"""

import argparse
from pathlib import Path

from lidarnerf_tpu_torch.preprocess import PROJECT_ROOT
from lidarnerf_tpu_torch.preprocess.to_nerf import MVL_TRAIN_SPLIT, write_nerfmvl_transforms


def get_arg_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--path",
        type=str,
        default=None,
        help="nerf_mvl parent dir (default: <repo>/data/nerf_mvl)",
    )
    parser.add_argument(
        "--classes", type=str, nargs="*", default=None,
        help=f"subset of classes (default: all of {list(MVL_TRAIN_SPLIT)})",
    )
    return parser


def main(argv=None):
    args = get_arg_parser().parse_args(argv)
    root = Path(args.path) if args.path else PROJECT_ROOT / "data" / "nerf_mvl"
    write_nerfmvl_transforms(root, classes=args.classes)


if __name__ == "__main__":
    main()
