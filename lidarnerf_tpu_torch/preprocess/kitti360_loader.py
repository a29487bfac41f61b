"""KITTI-360 raw-dataset loader: calibration chains and sensor poses
(copy of lidarnerf_tpu/preprocess/kitti360_loader.py, numpy only).

The derived rectified cam0 -> world chain is cross-checked against
KITTI-360's own cam0_to_world.txt where the sequence has one.

Chains:
    cam_to_world  = imu_to_world @ cam_to_imu @ inv(R_rect)
    velo_to_world = imu_to_world @ cam00_to_imu @ inv(calib_cam_to_velo)
"""

from pathlib import Path

import numpy as np


def _pad_0001(mat34):
    """[3,4] -> [4,4] homogeneous."""
    return np.concatenate([mat34, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def _read_variable(path_or_fid, name, M, N):
    """Parse `name: v0 v1 ...` from a KITTI calibration text file."""
    if hasattr(path_or_fid, "readline"):
        fid = path_or_fid
        fid.seek(0, 0)
        lines = fid.readlines()
    else:
        with open(path_or_fid) as f:
            lines = f.readlines()
    for line in lines:
        if line.startswith(name):
            vals = line.replace(f"{name}:", "").split()
            if len(vals) != M * N:
                raise AssertionError(f"{name}: {len(vals)} values, expected {M} x {N}")
            return np.array([float(x) for x in vals]).reshape(M, N)
    return None


def load_perspective_intrinsics(intrinsics_path):
    """Rectified P / R matrices from perspective.txt."""
    out = {}
    with open(intrinsics_path) as fid:
        for name in ["P_rect_00", "R_rect_00", "P_rect_01", "R_rect_01"]:
            if name.startswith("P_rect"):
                out[name] = _pad_0001(_read_variable(fid, name, 3, 4))
            else:
                out[name] = _read_variable(fid, name, 3, 3)
    return out


class KITTI360Loader:
    def __init__(self, kitti_360_root):
        self.root = Path(kitti_360_root)
        if not self.root.is_dir():
            raise FileNotFoundError(f"KITTI-360 {kitti_360_root} not found.")
        self.calibration_dir = self.root / "calibration"
        self.data_poses_dir = self.root / "data_poses"
        self.data_3d_raw_dir = self.root / "data_3d_raw"
        for d in (self.calibration_dir, self.data_poses_dir, self.data_3d_raw_dir):
            if not d.is_dir():
                raise FileNotFoundError(f"{d} not found.")

    def _imu_to_world(self, sequence_name):
        poses_path = self.data_poses_dir / f"{sequence_name}_sync" / "poses.txt"
        d = {}
        for line in np.loadtxt(poses_path):
            d[int(line[0])] = line[1:].reshape(3, 4)
        return d

    def load_cameras(self, camera_name, sequence_name, frame_ids):
        """Per-frame (K [3,3], world->cam T [4,4]) for cam_00/cam_01."""
        idx = {"cam_00": "00", "cam_01": "01"}[camera_name]
        persp = load_perspective_intrinsics(self.calibration_dir / "perspective.txt")
        K = persp[f"P_rect_{idx}"][:3, :3]
        rect = np.eye(4)
        rect[:3, :3] = persp[f"R_rect_{idx}"]

        cam_to_imu = _pad_0001(
            _read_variable(
                self.calibration_dir / "calib_cam_to_pose.txt", f"image_{idx}", 3, 4
            )
        )
        imu_to_world = self._imu_to_world(sequence_name)

        cam_to_world = {}
        for fid in imu_to_world:
            unrec = imu_to_world[fid] @ cam_to_imu
            cam_to_world[fid] = _pad_0001(unrec @ np.linalg.inv(rect))

        if camera_name == "cam_00":
            self._check_against_gt(sequence_name, cam_to_world)

        Ks = np.stack([K for _ in frame_ids])
        Ts = np.stack([np.linalg.inv(cam_to_world[f]) for f in frame_ids])
        return Ks, Ts

    def _check_against_gt(self, sequence_name, cam_00_to_world):
        """Raise AssertionError where the derived chain and KITTI's
        cam0_to_world.txt disagree (a check that holds under -O too)."""
        gt_path = self.data_poses_dir / f"{sequence_name}_sync" / "cam0_to_world.txt"
        if not gt_path.is_file():
            return
        for line in np.loadtxt(gt_path):
            fid = int(line[0])
            gt = line[1:].reshape(4, 4)
            if not np.allclose(gt, cam_00_to_world[fid], atol=1e-5, rtol=1e-5):
                raise AssertionError(f"frame {fid}: the calibration chain's cam0 -> world "
                                     f"differs from {gt_path}")

    def load_lidars(self, sequence_name, frame_ids):
        """[N, 4, 4] velodyne->world poses."""
        cam_00_to_imu = _pad_0001(
            _read_variable(
                self.calibration_dir / "calib_cam_to_pose.txt", "image_00", 3, 4
            )
        )
        with open(self.calibration_dir / "calib_cam_to_velo.txt") as fid:
            vals = [float(x) for x in fid.readline().split()]
        cam_00_to_velo = _pad_0001(np.array(vals).reshape(3, 4))

        imu_to_world = self._imu_to_world(sequence_name)
        out = []
        for f in frame_ids:
            unrec = imu_to_world[f] @ cam_00_to_imu
            out.append(_pad_0001(unrec @ np.linalg.inv(cam_00_to_velo))[:4])
        return np.stack(out)

    def get_image_paths(self, camera_name, sequence_name, frame_ids):
        """Raw camera png paths (the data_2d_raw layout).

        The images themselves are only needed for the RGB branch; the LiDAR
        pipeline reads just the first one's shape (falling back to the KITTI
        default 376x1408 if the 2D release isn't downloaded).
        """
        idx = {"cam_00": "image_00", "cam_01": "image_01"}[camera_name]
        base = self.root / "data_2d_raw" / f"{sequence_name}_sync" / idx / "data_rect"
        return [base / f"{f:010d}.png" for f in frame_ids]

    def load_lidar_points(self, sequence_name, frame_id):
        """[N, 4] (x, y, z, intensity) from the raw velodyne .bin."""
        path = (
            self.data_3d_raw_dir
            / f"{sequence_name}_sync"
            / "velodyne_points"
            / "data"
            / f"{frame_id:010d}.bin"
        )
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
