"""KITTI-360 LiDAR range-image dataset (counterpart of lidarnerf_tpu/dataset/kitti360.py).

Loads `transforms_{seq}_{split}.json` and the pano `.npy`s into stacked
arrays: images [F, H, W, 3] = (ray_drop, intensity, depth * scale) and
lidar2world poses recentred and scaled as (t - offset) * scale. The fields
are the JAX dataclass's, in its order. Training samples its rays on the
device from `device_arrays` (nerf/train_step.py). The host API of the
reference, `collate` / `dataloader` over a `SimpleLoader`, returns tensors
on the dataset's `device`; its pixel draws come from numpy's global stream,
as the JAX package's do (`np.random.seed` makes them repeat).
"""

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.base import get_lidar_rays

SEQUENCES = ("1538", "1728", "1908", "3353")
INTRINSICS_LIDAR = (2.0, 26.9)  # fov_up, fov


class SimpleLoader:
    """Batch-1 loader over `dataset.collate`: frames in order, or shuffled by
    a numpy stream seeded 0 at construction (one permutation per pass)."""

    def __init__(self, dataset, shuffle):
        self._data = dataset
        self.shuffle = shuffle
        self.batch_size = 1
        self.has_gt = dataset.images_lidar is not None
        self._rng = np.random.RandomState(0)

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        order = np.arange(len(self._data))
        if self.shuffle:
            self._rng.shuffle(order)
        for idx in order:
            yield self._data.collate([int(idx)])


@dataclass
class KITTI360Dataset:
    device: str = "cpu"  # the default device of `device_arrays` and of `collate`'s tensors
    split: str = "train"
    root_path: str = "data/kitti360"
    sequence_id: str = "1908"
    preload: bool = True  # frames are always loaded at construction, as in the JAX package
    scale: float = 1.0
    offset: list = field(default_factory=lambda: [0, 0, 0])
    fp16: bool = True  # not read, as in the JAX package
    patch_size: int = 1  # not read, as in the JAX package
    patch_size_lidar: int = 1  # read by the host `collate` only
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

    def collate(self, index):
        """Frames `index` as the reference's batch dict, tensors on `device`.

        Training splits sample `num_rays_lidar` pixels (one draw shared by
        the batch, from a generator seeded by numpy's global stream);
        other splits give every pixel.
        """
        poses = torch.as_tensor(self.poses_lidar[index], device=self.device)
        generator = None
        if self.num_rays_lidar > 0:  # the JAX package's key: np.random.randint(0, 2**31 - 1)
            generator = torch.Generator(device=poses.device).manual_seed(
                int(np.random.randint(0, 2**31 - 1)))
        rays = get_lidar_rays(poses, self.intrinsics_lidar, self.H_lidar, self.W_lidar,
                              self.num_rays_lidar, self.patch_size_lidar, generator)
        results = {"H_lidar": self.H_lidar, "W_lidar": self.W_lidar,
                   "rays_o_lidar": rays["rays_o"], "rays_d_lidar": rays["rays_d"]}
        images = torch.as_tensor(self.images_lidar[index], device=self.device)  # [B, H, W, 3]
        if self.training:
            flat = images.reshape(len(index), -1, images.shape[-1])
            images = torch.gather(flat, 1, rays["inds"][..., None].expand(-1, -1, flat.shape[-1]))
        results["images_lidar"] = images
        return results

    def dataloader(self):
        return SimpleLoader(self, shuffle=self.training)

    def __len__(self):
        return len(self.poses_lidar)
