"""KITTI-360 LiDAR range-image dataset (counterpart of lidarnerf_tpu/dataset/kitti360.py:45-111,147-148).

Loads `transforms_{seq}_{split}.json` and the pano `.npy`s into stacked
arrays: images [F, H, W, 3] = (ray_drop, intensity, depth * scale) and
lidar2world poses recentred and scaled as (t - offset) * scale. The fields
are the JAX dataclass's, in its order. Training samples its rays on the
device from `device_arrays` (nerf/train_step.py); the host API
(`collate`, `dataloader`, `SimpleLoader`) is not ported yet (ROADMAP.md,
queue A item 2).
"""

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

SEQUENCES = ("1538", "1728", "1908", "3353")
INTRINSICS_LIDAR = (2.0, 26.9)  # fov_up, fov


@dataclass
class KITTI360Dataset:
    device: str = "cpu"  # the default device of `device_arrays`
    split: str = "train"
    root_path: str = "data/kitti360"
    sequence_id: str = "1908"
    preload: bool = True  # frames are always loaded at construction, as in the JAX package
    scale: float = 1.0
    offset: list = field(default_factory=lambda: [0, 0, 0])
    fp16: bool = True  # not read, as in the JAX package
    patch_size: int = 1  # read by the host collate only (not ported)
    patch_size_lidar: int = 1  # read by the host collate only (not ported)
    enable_lidar: bool = True
    num_rays: int = 4096
    num_rays_lidar: int = 4096

    def __post_init__(self):
        if self.sequence_id not in SEQUENCES:
            raise ValueError(f"Invalid sequence id: {self.sequence_id}")
        if not self.enable_lidar:
            raise NotImplementedError("enable_lidar=False (RGB frames) is not ported yet "
                                      "(ROADMAP.md, queue A item 4)")
        self.training = self.split in ["train", "all", "trainval"]
        self.num_rays = self.num_rays if self.training else -1
        self.num_rays_lidar = self.num_rays_lidar if self.training else -1

        path = os.path.join(self.root_path, f"transforms_{self.sequence_id}_{self.split}.json")
        with open(path) as f:
            transform = json.load(f)
        self.H = int(transform["h"]) if "h" in transform else None
        self.W = int(transform["w"]) if "w" in transform else None
        self.H_lidar = int(transform["h_lidar"])
        self.W_lidar = int(transform["w_lidar"])

        poses, images = [], []
        for fr in transform["frames"]:
            poses.append(np.array(fr["lidar2world"], dtype=np.float32))
            pc = np.load(os.path.join(self.root_path, fr["lidar_file_path"]))
            # channels: (unused, intensity, depth) -> (ray_drop, intensity, depth * scale)
            ray_drop = np.where(pc[:, :, 2:3] == 0.0, 0.0, 1.0)
            images.append(np.concatenate([ray_drop, pc[:, :, 1:2], pc[:, :, 2:3] * self.scale], -1))

        self.poses_lidar = np.stack(poses)
        self.poses_lidar[:, :3, -1] = (self.poses_lidar[:, :3, -1] - np.asarray(self.offset)) * self.scale
        self.images_lidar = np.stack(images).astype(np.float32)
        self.intrinsics_lidar = INTRINSICS_LIDAR
        self._device_cache = {}

    def device_arrays(self, device=None):
        """(poses [F, 4, 4], images [F, H, W, 3]) float32 tensors on `device`
        (default: the dataset's `device`), cached."""
        device = torch.device(self.device if device is None else device)
        if device not in self._device_cache:
            self._device_cache[device] = (
                torch.as_tensor(self.poses_lidar, dtype=torch.float32, device=device),
                torch.as_tensor(self.images_lidar, dtype=torch.float32, device=device),
            )
        return self._device_cache[device]

    def __len__(self):
        return len(self.poses_lidar)
