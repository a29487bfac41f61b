"""PCGen baseline: accumulated-point projection NVS + learned ray-drop
(counterpart of lidarnerf_tpu/lidarnvs/pcgen.py).

`fit` accumulates every train frame's world points; `predict_frame`
re-projects them into the target sensor's pano by closest-point ("cp") or
fixed-point-averaging ("fpa") raycasting, host numpy as in the JAX
package; `predict_frame_with_raydrop` masks the pano where the ray-drop MLP
(on the card unless `device="cpu"`) says > 0.5.
"""

import numpy as np

from lidarnerf_tpu_torch.dataset.convert import (
    lidar_to_pano_with_intensities,
    lidar_to_pano_with_intensities_fpa,
    pano_dirs,
    pano_to_lidar_with_intensities,
)
from lidarnerf_tpu_torch.lidarnvs.base import LidarNVSBase
from lidarnerf_tpu_torch.lidarnvs.loader import extract_dataset_frame, homo_project
from lidarnerf_tpu_torch.lidarnvs.raydrop_pcgen import RayDropTrainer


class LidarNVSPCGen(LidarNVSBase):
    def __init__(self, raycasting="cp", ckpt_path=None, device=None):
        self.raycasting = raycasting
        self.raydrop = None
        if ckpt_path is not None:
            # the predictor takes the identity embeddings (i_embed -1, five
            # inputs); a checkpoint trained with another i_embed fails to load
            self.raydrop = RayDropTrainer(netdepth=4, netwidth=128, i_embed=-1, device=device)
            self.raydrop.load_checkpoint(ckpt_path)
            print(f"Checkpoint loaded from {ckpt_path}")

    def fit(self, dataset) -> None:
        all_points, all_intensities = [], []
        for frame_idx in range(len(dataset)):
            frame = extract_dataset_frame(dataset, frame_idx)
            all_points.append(frame["points"])
            all_intensities.append(frame["point_intensities"])
        self.points = np.vstack(all_points)
        self.point_intensities = np.hstack(all_intensities)
        assert len(self.points) == len(self.point_intensities)

    def predict_frame(self, lidar_K, lidar_pose, lidar_H, lidar_W) -> dict:
        # world -> local frame of the target sensor
        local_points = homo_project(self.points, np.linalg.inv(lidar_pose))
        pts_i = np.concatenate(
            [local_points, self.point_intensities.reshape(-1, 1)], axis=1
        )
        if self.raycasting == "cp":
            pano, intensities = lidar_to_pano_with_intensities(
                pts_i, lidar_H, lidar_W, lidar_K
            )
        elif self.raycasting == "fpa":
            pano, intensities = lidar_to_pano_with_intensities_fpa(
                pts_i, lidar_H, lidar_W, lidar_K
            )
        else:
            raise ValueError(f"unknown raycasting '{self.raycasting}'")

        return self._pack(pano, intensities, lidar_K, lidar_pose)

    def predict_frame_with_raydrop(self, lidar_K, lidar_pose, lidar_H, lidar_W) -> dict:
        if self.raydrop is None:
            raise RuntimeError("no ray-drop checkpoint loaded")
        frame = self.predict_frame(lidar_K, lidar_pose, lidar_H, lidar_W)
        dirs = get_direction(lidar_H, lidar_W, lidar_K)
        rays_val = np.concatenate(
            [
                dirs.reshape(-1, 3),
                frame["pano"].reshape(-1, 1),
                frame["intensities"].reshape(-1, 1),
            ],
            axis=-1,
        ).astype(np.float32)
        probs = self.raydrop.predict(rays_val)
        mask = np.where(probs > 0.5, 1.0, 0.0).reshape(lidar_H, lidar_W)
        pano, intensities = frame["pano"], frame["intensities"]
        if not np.all(mask == 0):
            pano = pano * mask
            intensities = intensities * mask
        return self._pack(pano, intensities, lidar_K, lidar_pose)

    def _pack(self, pano, intensities, lidar_K, lidar_pose):
        pts_i = pano_to_lidar_with_intensities(pano, intensities, lidar_K)
        local_points = pts_i[:, :3]
        local_point_intensities = pts_i[:, 3]
        points = homo_project(local_points, lidar_pose)
        return {
            "pano": pano,
            "intensities": intensities,
            "points": points,
            "point_intensities": local_point_intensities,
            "local_points": local_points,
            "local_point_intensities": local_point_intensities,
        }


def generate_raydrop_data_pcgen(dataset, nvs, rm_pano_mask=True):
    """(directions, panos, intensities, raydrop_masks) training lists: the
    inputs are the *synthesised* panos, the targets the ground-truth panos."""
    raydrop_masks, directions, panos, intensities = [], [], [], []
    for frame_idx in range(len(dataset)):
        gt = extract_dataset_frame(dataset, frame_idx, rm_pano_mask=rm_pano_mask)
        nvs_frame = nvs.predict_frame(
            gt["lidar_K"], gt["lidar_pose"], gt["lidar_H"], gt["lidar_W"]
        )
        raydrop_masks.append(gt["pano"])
        directions.append(get_direction(gt["lidar_H"], gt["lidar_W"], gt["lidar_K"]))
        panos.append(nvs_frame["pano"])
        intensities.append(nvs_frame["intensities"])
    return directions, panos, intensities, raydrop_masks


def get_direction(lidar_H, lidar_W, lidar_K):
    """Pano ray-direction grid [H, W, 3]."""
    return pano_dirs(lidar_H, lidar_W, lidar_K, dtype=np.float32)
