"""Generate a KITTI-scale synthetic drive dataset for integration runs
(counterpart of tools/make_synth_drive.py: the same scene, draws and files).

    python -m lidarnerf_tpu_torch.tools.make_synth_drive [out_dir] [n_train]

Analytic street scene — ground plane, two building walls, pillars — rendered
to 66x1030 LiDAR panos from poses moving along +x, written in the exact
transforms_{seq}_{split}.json + pano-npy format the KITTI-360 pipeline
produces. Lets the full training stack run at real shapes without the
(license-gated) KITTI-360 download. `python -m ... data_synth_drive60 60`
writes the committed `data_synth_drive60/`.

`write_kitti360_raw` casts the same street as a raw KITTI-360 tree instead
(calibration, poses, cam0_to_world.txt and HDL-64-sized velodyne scans),
the input of the on-ramp (`preprocess/`, `tools/check_dataset.py`).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np

from lidarnerf_tpu_torch.dataset.convert import pano_dirs, pano_to_lidar

H, W = 66, 1030
K_LIDAR = (2.0, 26.9)
SENSOR_Z = 1.7  # sensor height above ground


def ray_scene_depth(origins, dirs, rng):
    """Closest hit among: ground plane z=0, walls y=+-12, pillars, far cap."""
    o, d = origins, dirs
    INF = 1e9
    depth = np.full(len(d), INF)

    # ground plane z = 0 (sensor at z = SENSOR_Z)
    tz = np.where(d[:, 2] < -1e-6, -(o[:, 2]) / np.where(d[:, 2] == 0, 1, d[:, 2]), INF)
    depth = np.minimum(depth, np.where(tz > 0, tz, INF))

    # building walls at y = +-12, 0 < z < 8
    for wy in (12.0, -12.0):
        t = (wy - o[:, 1]) / np.where(np.abs(d[:, 1]) < 1e-9, 1e-9, d[:, 1])
        z = o[:, 2] + t * d[:, 2]
        ok = (t > 0) & (z > 0) & (z < 8.0)
        depth = np.minimum(depth, np.where(ok, t, INF))

    # cylindrical pillars along the street
    for px, py, r in [(8, 4, 0.4), (16, -5, 0.5), (26, 3, 0.4), (36, -4, 0.6),
                      (47, 5, 0.5), (58, -3, 0.4)]:
        oc = o[:, :2] - np.array([px, py])
        b = 2 * np.sum(oc * d[:, :2], axis=1)
        a = np.sum(d[:, :2] ** 2, axis=1)
        c = np.sum(oc**2, axis=1) - r * r
        disc = b * b - 4 * a * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * np.maximum(a, 1e-9)), INF)
        z = o[:, 2] + t * d[:, 2]
        ok = (t > 0) & (z > 0) & (z < 6.0)
        depth = np.minimum(depth, np.where(ok, t, INF))

    hit = depth < 75.0
    return np.where(hit, depth, 0.0), hit


def intensity_model(origins, dirs, depth, hit, rng):
    """Range + incidence dependent reflectance with per-surface albedo."""
    p = origins + dirs * depth[:, None]
    albedo = np.where(p[:, 2] < 0.05, 0.25, 0.6)  # ground darker
    albedo = np.where(np.abs(p[:, 1]) > 11.5, 0.45, albedo)
    falloff = 1.0 / (1.0 + (depth / 40.0) ** 2)
    inten = albedo * falloff
    return np.where(hit, np.clip(inten, 0, 1), 0.0)


def sensor_pose(i, spacing=3.0):
    """4x4 sensor -> scene pose of frame i: `spacing` m apart along +x, a
    slight weave in y and yaw, at SENSOR_Z."""
    t = np.array([i * spacing, 0.3 * np.sin(i * 0.4), SENSOR_Z])
    yaw = 0.05 * np.sin(i * 0.3)
    Rz = np.array(
        [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    )
    pose = np.eye(4)
    pose[:3, :3] = Rz
    pose[:3, 3] = t
    return pose


def cast(pose, dirs_local, rng):
    """Cast the street along sensor-frame unit directions [N, 3] from a
    sensor -> scene `pose`, with the drive's ray drop (distant returns lost
    with probability up to 0.35). Returns (depth [N], 0 where no return;
    intensity [N])."""
    d_world = dirs_local @ pose[:3, :3].T
    o_world = np.broadcast_to(pose[:3, 3], d_world.shape)
    depth, hit = ray_scene_depth(o_world, d_world, rng)
    # simulated ray-drop: distant/grazing returns sometimes lost
    drop_p = np.clip((depth - 40) / 80, 0, 0.35)
    dropped = hit & (rng.rand(len(depth)) < drop_p)
    hit = hit & ~dropped
    depth = np.where(hit, depth, 0.0)
    return depth, intensity_model(o_world, d_world, depth, hit, rng)


def main(out_dir="data_synth_drive", n_train=16, n_val=2):
    rng = np.random.RandomState(0)
    os.makedirs(out_dir, exist_ok=True)
    dirs0 = pano_dirs(H, W, K_LIDAR).reshape(-1, 3).astype(np.float64)

    n_total = n_train + 2 * n_val
    frames = []
    for i in range(n_total):
        pose = sensor_pose(i)
        depth, inten = cast(pose, dirs0, rng)
        pano = np.stack(
            [np.zeros(H * W), inten, depth], axis=-1
        ).reshape(H, W, 3).astype(np.float32)
        fn = f"frame_{i:04d}.npy"
        np.save(os.path.join(out_dir, fn), pano)
        frames.append(
            {
                "file_path": fn,
                "lidar_file_path": fn,
                "transform_matrix": pose.tolist(),
                "lidar2world": pose.tolist(),
            }
        )

    val_ids = list(range(n_train, n_train + n_val))
    test_ids = list(range(n_train + n_val, n_total))
    splits = {
        "train": list(range(n_train)),
        "val": val_ids,
        "test": test_ids,
    }
    for split, ids in splits.items():
        meta = {
            "w": W, "h": H, "w_lidar": W, "h_lidar": H, "aabb_scale": 2,
            "frames": [frames[i] for i in ids],
        }
        with open(os.path.join(out_dir, f"transforms_1908_{split}.json"), "w") as f:
            json.dump(meta, f)

    # scene normalisation constants (what cal_centerpose_bound computes)
    all_pts = []
    for i in range(n_total):
        pano = np.load(os.path.join(out_dir, f"frame_{i:04d}.npy"))
        pts = pano_to_lidar(pano[:, :, 2], K_LIDAR)
        pose = np.array(frames[i]["lidar2world"])
        ph = np.concatenate([pts, np.ones((len(pts), 1))], 1)
        all_pts.append((ph @ pose.T)[:, :3])
    pc = np.concatenate(all_pts)
    center = (pc.max(0) + pc.min(0)) / 2
    scale = 1.0 / np.abs(pc - center).max()
    print(f"offset = [{center[0]}, {center[1]}, {center[2]}]")
    print(f"scale = {scale}")
    with open(os.path.join(out_dir, "scene_constants.json"), "w") as f:
        json.dump({"offset": center.tolist(), "scale": float(scale)}, f)


# the raw tree: HDL-64E beam elevations (degrees; an upper block of 32 at 1/3
# degree from +2, a lower one of 32 at 1/2 degree from -8.83) and its azimuth
# step at 10 Hz (0.1728 degrees), KITTI-360's image size and calibration
# layout; the scene lies at a world offset of KITTI-360's order
HDL64_ELEVATIONS = np.concatenate([2.0 - np.arange(32) / 3.0, -53.0 / 6.0 - np.arange(32) * 0.5])
HDL64_AZIMUTH_STEPS = 2083
RAW_SPACING = 1.0  # m between frames: ~10 m/s at 10 Hz
WORLD_OFFSET = np.array([1000.0, 3700.0, 110.0])
IMAGE_HW = (376, 1408)


def _rigid(rotvec, t):
    """4x4 rigid transform: rotation by the axis-angle `rotvec`, then `t`."""
    theta = np.linalg.norm(rotvec)
    k = np.asarray(rotvec) / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    T[:3, 3] = t
    return T


# camera axes (x right, y down, z forward) in the vehicle's (x forward, y left, z up)
_CAM_AXES = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 1.0]])
CAM00_TO_IMU = _rigid([0.01, -0.02, 0.005], [1.575, 0.004, -0.65]) @ _CAM_AXES
CAM00_TO_VELO = _rigid([-0.004, 0.01, -0.002], [0.80, 0.30, -0.18]) @ _CAM_AXES
R_RECT_00 = _rigid([0.002, -0.003, 0.001], [0.0, 0.0, 0.0])[:3, :3]


def _row(m):
    return " ".join(repr(float(v)) for v in np.asarray(m).ravel())


def hdl64_dirs(azimuth_steps=HDL64_AZIMUTH_STEPS):
    """[64 * azimuth_steps, 3] unit directions of one HDL-64 sweep, sensor frame."""
    el = np.deg2rad(HDL64_ELEVATIONS)[:, None]
    az = -np.pi + (np.arange(azimuth_steps) + 0.5) * (2 * np.pi / azimuth_steps)
    return np.stack(np.broadcast_arrays(np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                                        np.sin(el)), axis=-1).reshape(-1, 3)


def write_kitti360_raw(root, frame_ids, sequence_name="2013_05_28_drive_0000",
                       azimuth_steps=HDL64_AZIMUTH_STEPS, seed=0):
    """Write a raw KITTI-360 tree of the street under `root` for `frame_ids`:
    calibration/{perspective,calib_cam_to_pose,calib_cam_to_velo}.txt,
    data_poses/<seq>_sync/{poses,cam0_to_world}.txt (consistent to float64
    rounding), one velodyne scan per frame (data_3d_raw/.../<fid>.bin,
    float32 x, y, z, intensity: the returns of an HDL-64 sweep cast from
    the frame's pose, ray drop as the drive's; draws from
    RandomState(seed + fid)) and the first frame's camera PNG
    (data_2d_raw, black, 376 x 1408). Returns the points per frame."""
    from lidarnerf_tpu_torch.utils.image_io import imwrite

    root = Path(root)
    cal = root / "calibration"
    poses_dir = root / "data_poses" / f"{sequence_name}_sync"
    velo = root / "data_3d_raw" / f"{sequence_name}_sync" / "velodyne_points" / "data"
    image = root / "data_2d_raw" / f"{sequence_name}_sync" / "image_00" / "data_rect"
    for d in (cal, poses_dir, velo, image):
        d.mkdir(parents=True, exist_ok=True)
    with open(cal / "perspective.txt", "w") as f:
        f.write(f"P_rect_00: 552.554261 0.0 682.049453 0.0 0.0 552.554261 238.769549 0.0 "
                f"0.0 0.0 1.0 0.0\nR_rect_00: {_row(R_RECT_00)}\n"
                f"P_rect_01: 552.554261 0.0 682.049453 -328.318735 0.0 552.554261 238.769549 "
                f"0.0 0.0 0.0 1.0 0.0\nR_rect_01: {_row(R_RECT_00)}\n")
    with open(cal / "calib_cam_to_pose.txt", "w") as f:
        for i, cam in enumerate(("image_00", "image_01", "image_02", "image_03")):
            c2i = CAM00_TO_IMU.copy()
            c2i[1, 3] -= 0.6 * i  # the other cameras further along the vehicle's y
            f.write(f"{cam}: {_row(c2i[:3])}\n")
    with open(cal / "calib_cam_to_velo.txt", "w") as f:
        f.write(_row(CAM00_TO_VELO[:3]) + "\n")

    rect = np.eye(4)
    rect[:3, :3] = R_RECT_00
    dirs = hdl64_dirs(azimuth_steps)
    counts = []
    with open(poses_dir / "poses.txt", "w") as fp, open(poses_dir / "cam0_to_world.txt", "w") as fc:
        for k, fid in enumerate(frame_ids):
            pose = sensor_pose(k, RAW_SPACING)  # velodyne -> scene
            velo_to_world = pose.copy()
            velo_to_world[:3, 3] += WORLD_OFFSET
            imu_to_world = velo_to_world @ CAM00_TO_VELO @ np.linalg.inv(CAM00_TO_IMU)
            fp.write(f"{fid} {_row(imu_to_world[:3])}\n")
            cam0_to_world = imu_to_world @ CAM00_TO_IMU @ np.linalg.inv(rect)
            fc.write(f"{fid} {_row(cam0_to_world)}\n")
            depth, inten = cast(pose, dirs, np.random.RandomState(seed + fid))
            hit = depth > 0
            pts = np.concatenate([dirs[hit] * depth[hit, None], inten[hit, None]], axis=1)
            pts.astype(np.float32).tofile(velo / f"{fid:010d}.bin")
            counts.append(int(hit.sum()))
    imwrite(image / f"{frame_ids[0]:010d}.png", np.zeros(IMAGE_HW, np.uint8))
    return counts


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*([args[0]] if args else []), **({"n_train": int(args[1])} if len(args) > 1 else {}))
