"""dataset"""

from lidarnerf_tpu_torch.dataset.base import get_lidar_rays, get_rays, nerf_matrix_to_ngp
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset
from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset

__all__ = [
    "get_lidar_rays",
    "get_rays",
    "nerf_matrix_to_ngp",
    "KITTI360Dataset",
    "NeRFMVLDataset",
]
