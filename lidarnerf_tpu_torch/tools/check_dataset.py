#!/usr/bin/env python
"""Real-data readiness harness for KITTI-360 (counterpart of tools/check_dataset.py).

Given a raw KITTI-360 root (calibration/ + data_poses/ + data_3d_raw/, plus
optionally data_2d_raw/), runs the entire on-ramp the paper-parity run needs:

  1. calibration + pose chains, including the cam0_to_world.txt cross-check;
  2. range-view generation for the sequence's frame window;
  3. transforms_{seq}_{train,val,test}.json writing;
  4. scene-normalization constants vs the baked config values;
  5. a short smoke train through the port's CLI (``--train_steps`` iters),
     on CUDA unless LIDARNERF_PLATFORM=cpu is set.

Exit code 0 means "drop-in ready": the full run is then just
    python -m lidarnerf_tpu_torch.main_lidarnerf --config configs/kitti360_<seq>.txt \
        --path <out_dir> --workspace <ws> -L --scale <scale> --offset <offset>

Usage:
    python -m lidarnerf_tpu_torch.tools.check_dataset --kitti360_root /data/KITTI-360 \
        --sequence_id 1908 --out_dir /data/kitti360_nerf [--train_steps 10]
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

from lidarnerf_tpu_torch import native
from lidarnerf_tpu_torch.preprocess import PROJECT_ROOT
from lidarnerf_tpu_torch.preprocess.kitti360_loader import KITTI360Loader
from lidarnerf_tpu_torch.preprocess.normalize import cal_centerpose_bound_scale
from lidarnerf_tpu_torch.preprocess.rangeview import lidar_to_rangeview_kitti
from lidarnerf_tpu_torch.preprocess.to_nerf import KITTI_SEQUENCES, write_kitti360_transforms


def _stage(n, msg):
    print(f"[check {n}/5] {msg}", flush=True)


def check_dataset(
    kitti360_root,
    out_dir,
    sequence_id="1908",
    sequence_name="2013_05_28_drive_0000",
    max_frames=None,
    train_steps=10,
    config=None,
    workspace=None,
):
    """Run the five stages; returns {scale, offset, near, far} (stage 4),
    the stage-2 projection `route` and last-frame `fill_rate`, the stage-5
    `trainer` and the `seconds` of each stage."""
    seq = KITTI_SEQUENCES[sequence_id]
    frame_ids = list(range(seq["start"], seq["end"] + 1))
    if max_frames is not None:
        keep = set(frame_ids[:max_frames]) | set(seq["val"])
        frame_ids = [f for f in frame_ids if f in keep]
    seconds = {}
    t0 = time.perf_counter()

    def lap(stage):
        nonlocal t0
        seconds[stage] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # 1. calibration + pose chains (cross-checked against cam0_to_world.txt
    #    inside load_cameras)
    _stage(1, f"calibration + pose chains for {len(frame_ids)} frames")
    k3 = KITTI360Loader(kitti360_root)
    Ks, Ts = k3.load_cameras("cam_00", sequence_name, frame_ids)
    lidar2world = k3.load_lidars(sequence_name, frame_ids)
    if Ks.shape != (len(frame_ids), 3, 3) or lidar2world.shape != (len(frame_ids), 4, 4):
        raise AssertionError(f"intrinsics {Ks.shape}, lidar poses {lidar2world.shape}")
    print(f"    cam0_to_world cross-check passed; fl_x={Ks[0][0, 0]:.1f}")
    lap(1)

    # 2. range-view panos (66x1030, intrinsics (2.0, 26.9))
    _stage(2, "range-view generation")
    rv_dir = os.path.join(out_dir, "train")
    os.makedirs(rv_dir, exist_ok=True)
    for f in frame_ids:
        pts = k3.load_lidar_points(sequence_name, f)
        pano = lidar_to_rangeview_kitti(pts)
        if pano.shape != (66, 1030, 3):
            raise AssertionError(f"pano shape {pano.shape}")
        np.save(os.path.join(rv_dir, f"{f:010d}.npy"), pano)
    nz = float((pano[:, :, 2] > 0).mean())
    route = native.route()
    print(f"    {len(frame_ids)} panos written ({route} projection); last frame fill rate {nz:.2f}")
    if not nz > 0.05:
        raise AssertionError("suspiciously empty pano — wrong .bin layout?")
    lap(2)

    # 3. transforms_{seq}_{split}.json
    _stage(3, "transforms json writing")
    write_kitti360_transforms(
        kitti360_root, out_dir, sequence_id=sequence_id,
        sequence_name=sequence_name, rangeview_dir=rv_dir,
    )
    for split in ("train", "val", "test"):
        p = os.path.join(out_dir, f"transforms_{sequence_id}_{split}.json")
        if not os.path.isfile(p):
            raise AssertionError(f"{p} was not written")
        if max_frames is not None:
            # reduced check window: keep only frames whose pano exists so the
            # smoke train below can load the split
            with open(p) as fh:
                d = json.load(fh)
            d["frames"] = [
                fr for fr in d["frames"]
                if os.path.isfile(os.path.join(out_dir, fr["lidar_file_path"]))
            ]
            if not d["frames"]:
                raise AssertionError(f"no generated panos in {split} window")
            if split in ("val", "test"):
                # full-pano eval/test is the expensive part of the smoke
                # train — one frame proves the path
                d["frames"] = d["frames"][:1]
            with open(p, "w") as fh:
                json.dump(d, fh, indent=2)
    lap(3)

    # 4. normalization constants vs the baked config
    _stage(4, "scene normalization constants")
    rv_paths = [os.path.join(rv_dir, f"{f:010d}.npy") for f in frame_ids]
    centerpose, scale, near, far = cal_centerpose_bound_scale(
        rv_paths, lidar2world, (2.0, 26.9)
    )
    print(
        f"    offset={np.round(centerpose, 2).tolist()} scale={scale:.5f} "
        f"near={near:.2f} far={far:.2f}"
    )
    cfg = config or str(PROJECT_ROOT / "configs" / f"kitti360_{sequence_id}.txt")
    baked_scale = None
    if os.path.isfile(cfg):
        baked = {}
        with open(cfg) as fh:
            for line in fh:
                if "=" in line:
                    key, _, val = line.partition("=")
                    baked[key.strip()] = val.strip()
        if "scale" in baked and max_frames is None:
            baked_scale = float(baked["scale"])
            ratio = scale / baked_scale
            print(f"    baked config scale={baked['scale']} (ratio {ratio:.2f})")
            if not 0.5 < ratio < 2.0:
                print("    WARNING: computed scale far from the baked config —"
                      " check the frame window / units")
    lap(4)

    # 5. smoke train through the port's CLI
    _stage(5, f"{train_steps}-step smoke train")
    from lidarnerf_tpu_torch import main_lidarnerf as cli

    ws = workspace or os.path.join(out_dir, "_check_ws")
    trainer = cli.main([
        "--config", cfg,
        "--path", out_dir, "--workspace", ws,
        "--sequence_id", sequence_id,
        "--iters", str(train_steps), "--eval_interval", "10000",
        "--num_rays_lidar", "512", "--num_steps", "64", "--upsample_steps", "8",
        "--desired_resolution", "512", "--log2_hashmap_size", "15",
        "--max_ray_batch", "512", "--mesh_resolution", "32",
    ])
    if not os.path.isfile(os.path.join(ws, "log_lidar_nerf.txt")):
        raise AssertionError(f"the smoke train wrote no log into {ws}")
    lap(5)
    print("[check] dataset is drop-in ready — run the paper config next.")
    return {"scale": scale, "offset": centerpose, "near": near, "far": far,
            "baked_scale": baked_scale, "route": route, "fill_rate": nz,
            "trainer": trainer, "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kitti360_root", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--sequence_id", default="1908", choices=sorted(KITTI_SEQUENCES))
    ap.add_argument("--sequence_name", default="2013_05_28_drive_0000")
    ap.add_argument("--max_frames", type=int, default=None,
                    help="limit the frame window for a quicker check")
    ap.add_argument("--train_steps", type=int, default=10)
    ap.add_argument("--config", default=None)
    ap.add_argument("--workspace", default=None)
    args = ap.parse_args(argv)
    try:
        check_dataset(
            args.kitti360_root, args.out_dir, args.sequence_id,
            args.sequence_name, args.max_frames, args.train_steps,
            args.config, args.workspace,
        )
    except Exception:
        traceback.print_exc()
        print("[check] FAILED — see the stage banner above for where.")
        sys.exit(1)


if __name__ == "__main__":
    main()
