"""Classical LiDAR-NVS baseline runner (counterpart of lidarnvs/run.py).

    python -m lidarnerf_tpu_torch.lidarnvs.run --method pcgen --path data/kitti360 ...

Fits a baseline (poisson | nksr | pcgen) on the train split, then either
collects a ray-drop training set (`--enable_collect_raydrop_dataset`:
`{train,test}_data.pkl` under `--raydrop_data_dir/<method>/<dataset>_<seq>`)
or evaluates every test frame with `eval_points_and_pano` and prints the
mean metrics. The ray-drop nets and the Chamfer run on the card unless
LIDARNERF_PLATFORM=cpu. Poisson and NKSR need open3d (and nksr).
"""

import argparse
import os
import pickle
from pathlib import Path

import numpy as np

from lidarnerf_tpu_torch.lidarnvs.eval import eval_points_and_pano
from lidarnerf_tpu_torch.lidarnvs.loader import extract_dataset_frame
from lidarnerf_tpu_torch.lidarnvs.pcgen import LidarNVSPCGen, generate_raydrop_data_pcgen
from lidarnerf_tpu_torch.main_lidarnerf import device_from_env

KITTI360_SEQUENCE_IDS = ["1538", "1728", "1908", "3353"]
NERF_MVL_SEQUENCE_IDS = [
    "bollard", "car", "pedestrian", "pier", "plant", "tire",
    "traffic_cone", "warning_sign", "water_safety_barrier",
]


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="kitti360",
                        choices=["kitti360", "nerf_mvl"])
    parser.add_argument("--method", type=str, default="poisson",
                        choices=["poisson", "nksr", "pcgen"])
    parser.add_argument("--raycasting", type=str, default="cp", choices=["cp", "fpa"])
    parser.add_argument("--path", type=str, default="data/kitti360")
    parser.add_argument("--sequence_id", type=str, default="1908")
    parser.add_argument("--num_rays_lidar", type=int, default=4096)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--enable_collect_raydrop_dataset", action="store_true")
    parser.add_argument("--raydrop_data_dir", type=str, default="data/raydrop")
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--poisson_depth", type=int, default=11)
    parser.add_argument("--poisson_min_density", type=float, default=0.3)
    return parser


def build_datasets(args):
    kwargs = dict(
        root_path=args.path,
        offset=args.offset,
        num_rays_lidar=args.num_rays_lidar,
        sequence_id=args.sequence_id,
        preload=False,
        scale=1.0,
    )
    if args.dataset == "kitti360":
        from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset as DS
    else:
        from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset as DS
    return DS(split="train", **kwargs), DS(split="test", **kwargs)


def main(argv=None):
    """Run the baseline; returns the mean metrics (None in the collect mode)."""
    args = build_parser().parse_args(argv)
    valid = (
        KITTI360_SEQUENCE_IDS if args.dataset == "kitti360" else NERF_MVL_SEQUENCE_IDS
    )
    if args.sequence_id not in valid:
        raise ValueError(f"Unknown sequence id {args.sequence_id} for {args.dataset}")
    device = device_from_env()

    print("[Config]===============================================")
    print(f"dataset             : {args.dataset}")
    print(f"method              : {args.method}")
    print(f"sequence_id         : {args.sequence_id}")
    print(f"dataset_collect_mode: {args.enable_collect_raydrop_dataset}")
    print(f"device              : {device}")
    print("=======================================================")

    train_dataset, test_dataset = build_datasets(args)
    train_dataset.training = True
    ckpt_path = args.ckpt_path or None

    if args.method == "pcgen":
        nvs = LidarNVSPCGen(raycasting=args.raycasting, ckpt_path=ckpt_path, device=device)
    elif args.method == "poisson":
        from lidarnerf_tpu_torch.lidarnvs.meshing import LidarNVSPoisson

        nvs = LidarNVSPoisson(
            depth=args.poisson_depth,
            min_density=args.poisson_min_density,
            k=9,
            ckpt_path=ckpt_path,
            device=device,
        )
    else:
        from lidarnerf_tpu_torch.lidarnvs.meshing import LidarNVSNKSR

        nvs = LidarNVSNKSR(ckpt_path=ckpt_path, device=device)

    nvs.fit(train_dataset)

    if args.enable_collect_raydrop_dataset:
        out_dir = Path(args.raydrop_data_dir) / args.method / (
            f"{args.dataset}_{args.sequence_id}"
        )
        os.makedirs(out_dir, exist_ok=True)
        if args.method == "pcgen":
            generate = generate_raydrop_data_pcgen
        else:
            from lidarnerf_tpu_torch.lidarnvs import meshing

            generate = meshing.generate_raydrop_data_meshing
        for split, ds in [("train", train_dataset), ("test", test_dataset)]:
            data = generate(ds, nvs)
            with open(out_dir / f"{split}_data.pkl", "wb") as f:
                pickle.dump(data, f)
            print(f"Saved {out_dir / f'{split}_data.pkl'}")
        return None

    all_metrics = []
    for frame_idx in range(len(test_dataset)):
        gt = extract_dataset_frame(test_dataset, frame_idx=frame_idx)
        infer = nvs.predict_frame if ckpt_path is None else nvs.predict_frame_with_raydrop
        pd = infer(
            lidar_K=gt["lidar_K"],
            lidar_pose=gt["lidar_pose"],
            lidar_H=gt["lidar_H"],
            lidar_W=gt["lidar_W"],
        )
        if args.dataset == "nerf_mvl":
            # the metrics over the bounding rectangle of the object's mask
            mask = gt["pano_mask"]
            nz = np.array(np.nonzero(mask))
            new_h = nz[0].max() - nz[0].min() + 1
            new_w = nz[1].max() - nz[1].min() + 1
            metrics = eval_points_and_pano(
                gt_local_points=gt["local_points"],
                pd_local_points=pd["local_points"],
                gt_intensities=gt["intensities"][mask].reshape(new_h, new_w) * 255,
                pd_intensities=pd["intensities"][mask].reshape(new_h, new_w) * 255,
                gt_pano=gt["pano"][mask].reshape(new_h, new_w),
                pd_pano=pd["pano"][mask].reshape(new_h, new_w),
                device=device,
            )
        else:
            metrics = eval_points_and_pano(
                gt_local_points=gt["local_points"],
                pd_local_points=pd["local_points"],
                gt_intensities=gt["intensities"],
                pd_intensities=pd["intensities"],
                gt_pano=gt["pano"],
                pd_pano=pd["pano"],
                device=device,
            )
        all_metrics.append(metrics)
        print(f"frame {frame_idx}: {metrics}")

    mean_metrics = {
        k: float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]
    }
    print("[Mean metrics]=========================================")
    for k, v in mean_metrics.items():
        print(f"{k}: {v:.6f}")
    return mean_metrics


if __name__ == "__main__":
    main()
