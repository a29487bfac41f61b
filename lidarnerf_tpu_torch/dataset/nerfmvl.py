"""NeRF-MVL object-level LiDAR dataset (counterpart of lidarnerf_tpu/dataset/nerfmvl.py).

Panos come from `.npz` files whose depth channel is -1 outside the
rectangle of the object's projected OBB (the bbox mask). Images are
[F, H, W, 3] = (ray_drop, intensity, depth * scale) with ray_drop 1 where
the depth is positive, 0 where it is 0 and -1 where it is masked. The
offset is the mean of the class's OBB corners (`dataset_bbox_7k.npy`): it
replaces the `offset` argument, so the CLI's `--offset` has no effect here.
`OBB_local` holds the OBB in each frame's sensor coordinates, from the
poses before centring and scaling; the test split's clouds are cropped to
it (`utils/geometry.py::filter_bbox_dataset`).

Training samples its rays on the device from `device_arrays`: per frame,
the flat indices of the unmasked pixels, padded to one length, and their
counts (the masked sampler of nerf/train_step.py draws positions in that
pool). `collate` / `dataloader` are the reference's host API: a training
batch of one frame keeps its unmasked pixels, `num_rays_lidar` of them
drawn by `np.random.permutation` when there are more.
"""

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
from lidarnerf_tpu_torch.dataset.kitti360 import SimpleLoader

SEQUENCE_IDS = [
    "bollard",
    "car",
    "pedestrian",
    "pier",
    "plant",
    "tire",
    "traffic_cone",
    "warning_sign",
    "water_safety_barrier",
]
INTRINSICS_LIDAR = (15, 40)  # fov_up, fov


@dataclass
class NeRFMVLDataset:
    device: str = "cpu"  # the default device of `device_arrays` and of `collate`'s tensors
    split: str = "train"
    root_path: str = "data/nerf_mvl"
    sequence_id: str = "car"
    preload: bool = True  # frames are always loaded at construction, as in the JAX package
    scale: float = 1.0
    offset: list = field(default_factory=lambda: [0, 0, 0])  # replaced by the OBB's mean
    fp16: bool = True  # not read, as in the JAX package
    patch_size: int = 1  # not read, as in the JAX package
    patch_size_lidar: int = 1  # read by the host `collate` only
    enable_lidar: bool = True
    num_rays: int = 4096
    num_rays_lidar: int = 4096

    def __post_init__(self):
        if not self.enable_lidar:
            raise NotImplementedError("enable_lidar=False (RGB frames) is not ported yet "
                                      "(ROADMAP.md, queue A item 4)")
        self.class_name = self.sequence_id
        self.training = self.split in ["train", "all", "trainval"]
        self.testing = self.split == "test"
        self.num_rays = self.num_rays if self.training else -1
        self.num_rays_lidar = self.num_rays_lidar if self.training else -1

        path = os.path.join(self.root_path, f"transforms_{self.class_name}_{self.split}.json")
        with open(path) as f:
            transform = json.load(f)
        self.H_lidar = int(transform["h_lidar"])
        self.W_lidar = int(transform["w_lidar"])

        poses, images = [], []
        have_images = True
        for fr in transform["frames"]:
            poses.append(np.array(fr["lidar2world"], dtype=np.float32))
            if "lidar_file_path" in fr:
                pc = np.load(os.path.join(self.root_path, fr["lidar_file_path"]))["data"]
                # ray_drop: depth > 0 -> 1, == 0 -> 0, -1 (masked) stays -1
                ray_drop = pc.reshape(-1, 3)[:, 2].copy()
                ray_drop[ray_drop > 0] = 1.0
                ray_drop = ray_drop.reshape(self.H_lidar, self.W_lidar, 1)
                images.append(np.concatenate(
                    [ray_drop, pc[:, :, 1:2], pc[:, :, 2:3] * self.scale], -1))
            else:
                have_images = False

        dataset_bbox = np.load(os.path.join(self.root_path, "dataset_bbox_7k.npy"),
                               allow_pickle=True).item()
        self.OBB = dataset_bbox[self.class_name]
        self.offset = np.mean(self.OBB, axis=0)

        self.poses_lidar = np.stack(poses, axis=0)
        poses_wo = self.poses_lidar.copy()
        OBB_pad = np.concatenate([self.OBB, np.ones((8, 1))], axis=1)
        self.OBB_local = np.stack(
            [OBB_pad @ np.linalg.inv(p.reshape(4, 4)).T for p in poses_wo], axis=0)
        self.poses_lidar[:, :3, -1] = (self.poses_lidar[:, :3, -1] - self.offset) * self.scale

        self.images_lidar = np.stack(images, axis=0).astype(np.float32) if have_images else None
        self.intrinsics_lidar = INTRINSICS_LIDAR
        self._device_cache = {}

    def valid_indices_padded(self):
        """Per-frame flat pixel indices where the bbox mask is > -1, padded.

        Returns (idx [F, P] int32, counts [F] int32) with P the largest
        count; padding repeats index 0 (never drawn: draws are < count).
        """
        HW = self.H_lidar * self.W_lidar
        masks = self.images_lidar[..., 0].reshape(len(self), HW) > -1
        counts = masks.sum(axis=1).astype(np.int32)
        P = int(counts.max())
        idx = np.zeros((len(self), P), np.int32)
        for n in range(len(self)):
            v = np.nonzero(masks[n])[0]
            idx[n, : len(v)] = v
        return idx, counts

    def device_arrays(self, device=None):
        """(poses [F, 4, 4] and images [F, H, W, 3] float32, valid_idx [F, P]
        and valid_counts [F] int64) on `device` (default: the dataset's
        `device`), cached."""
        device = torch.device(self.device if device is None else device)
        if device not in self._device_cache:
            idx, counts = self.valid_indices_padded()
            self._device_cache[device] = (
                torch.as_tensor(self.poses_lidar, dtype=torch.float32, device=device),
                torch.as_tensor(self.images_lidar, dtype=torch.float32, device=device),
                torch.as_tensor(idx, dtype=torch.long, device=device),
                torch.as_tensor(counts, dtype=torch.long, device=device),
            )
        return self._device_cache[device]

    def collate(self, index):
        """Frames `index` as the reference's batch dict, tensors on `device`.

        Every pixel's rays; a training batch (one frame only) keeps the
        unmasked pixels, subsampled to `num_rays_lidar` by
        `np.random.permutation`; the test split adds the frame's
        `OBB_local` [8, 4].
        """
        B = len(index)
        poses = torch.as_tensor(self.poses_lidar[index], device=self.device)
        rays = get_lidar_rays(poses, self.intrinsics_lidar, self.H_lidar, self.W_lidar, -1,
                              self.patch_size_lidar)
        results = {"H_lidar": self.H_lidar, "W_lidar": self.W_lidar,
                   "rays_o_lidar": rays["rays_o"], "rays_d_lidar": rays["rays_d"]}
        if self.testing:
            results["OBB_local"] = self.OBB_local[index].reshape(8, 4)

        if self.images_lidar is not None:
            images = self.images_lidar[index]  # [B, H, W, 3]
            if self.training:
                flat = images.reshape(B, -1, images.shape[-1])
                mask = flat[:, :, 0] > -1  # [B, HW]
                # the unmasked pixel set is per frame, so one `sel` serves a
                # batch of one frame only (the reference's DataLoader has
                # batch_size=1); the JAX package's assertion, raised always
                if B != 1:
                    raise AssertionError("MVL collate supports batch=1 only (per-frame mask)")
                sel = np.nonzero(mask[0])[0]
                if len(sel) > self.num_rays_lidar:
                    sel = np.random.permutation(sel)[: self.num_rays_lidar]
                images = flat[:, sel, :]
                sel_t = torch.as_tensor(sel, device=poses.device)
                results["rays_o_lidar"] = results["rays_o_lidar"][:, sel_t, :]
                results["rays_d_lidar"] = results["rays_d_lidar"][:, sel_t, :]
            results["images_lidar"] = torch.as_tensor(images, device=self.device)
        return results

    def dataloader(self):
        return SimpleLoader(self, shuffle=self.training)

    def __len__(self):
        return len(self.poses_lidar)
