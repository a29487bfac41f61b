from lidarnerf_tpu_torch.lidarnvs.base import LidarNVSBase
from lidarnerf_tpu_torch.lidarnvs.pcgen import LidarNVSPCGen
from lidarnerf_tpu_torch.lidarnvs.eval import eval_points_and_pano

__all__ = ["LidarNVSBase", "LidarNVSPCGen", "eval_points_and_pano"]
