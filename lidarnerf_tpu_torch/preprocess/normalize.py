"""Scene normalization: centerpose (offset) and scale for configs (copy of
lidarnerf_tpu/preprocess/normalize.py).

The tool that produced the per-sequence `scale` / `offset` constants baked
into configs/*.txt: union all frames' world points, centre on the AABB
midpoint, scale so everything fits in [-bound, bound]^3.
"""

import json
import os

import numpy as np

from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar


def cal_centerpose_bound_scale(lidar_rangeview_paths, lidar2worlds, intrinsics, bound=1.0):
    """Returns (centerpose [3], scale, near, far)."""
    near, far = 200.0, 0.0
    points_world_list = []
    for i, path in enumerate(lidar_rangeview_paths):
        pano = np.load(path)
        pc = pano_to_lidar(pano[:, :, 2], intrinsics)
        pc_h = np.concatenate([pc, np.ones((pc.shape[0], 1))], -1)
        dis = np.linalg.norm(pc, axis=1)
        near = min(dis.min(), near)
        far = max(dis.max(), far)
        points_world_list.append((pc_h @ np.asarray(lidar2worlds[i]).T)[:, :3])

    pc_all = np.concatenate(points_world_list)
    centerpose = [
        (pc_all[:, 0].max() + pc_all[:, 0].min()) / 2.0,
        (pc_all[:, 1].max() + pc_all[:, 1].min()) / 2.0,
        (pc_all[:, 2].max() + pc_all[:, 2].min()) / 2.0,
    ]
    centered = pc_all - centerpose
    bound_ori = [centered[:, 0].max(), centered[:, 1].max(), centered[:, 2].max()]
    scale = bound / np.max(bound_ori)
    return centerpose, float(scale), float(near), float(far)


def get_path_pose_from_json(root_path, sequence_id):
    """(rangeview paths, lidar2world poses) of a sequence's train split."""
    with open(os.path.join(root_path, f"transforms_{sequence_id}_train.json")) as f:
        transform = json.load(f)
    paths, poses = [], []
    for fr in transform["frames"]:
        poses.append(np.array(fr["lidar2world"], dtype=np.float32))
        paths.append(os.path.join(root_path, fr["lidar_file_path"]))
    return paths, poses
