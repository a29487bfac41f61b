"""Shared baseline metrics: eval_points_and_pano (counterpart of
lidarnerf_tpu/lidarnvs/eval.py).

The protocol of the NeRF meters, so the classical baselines and the NeRF
compare directly: depth RMSE/a1/a2/a3/SSIM on depths clamped to [1e-3, 80],
Chamfer and F-score@0.05 on the local point clouds, intensity MAE. The
depth SSIM is taken on the flattened panos, as the reference does; the SSIM
of utils/ssim.py is n-dimensional, so this is skimage's 1-D windowed value.
The Chamfer runs on the card (ops/chamfer.py) unless `device="cpu"`.
"""

import numpy as np

from lidarnerf_tpu_torch.ops.chamfer import chamfer_and_fscore
from lidarnerf_tpu_torch.utils.ssim import structural_similarity


def eval_points_and_pano(
    gt_local_points,
    pd_local_points,
    gt_intensities,
    pd_intensities,
    gt_pano,
    pd_pano,
    device=None,
):
    if gt_local_points.ndim != 2 or gt_local_points.shape[1] != 3:
        raise ValueError(f"gt_local_points must be (N, 3), got {gt_local_points.shape}")
    if pd_local_points.ndim != 2 or pd_local_points.shape[1] != 3:
        raise ValueError(f"pd_local_points must be (M, 3), got {pd_local_points.shape}")
    if gt_intensities.ndim != 2:
        raise ValueError(f"gt_intensities must be (H, W), got {gt_intensities.shape}")
    H, W = gt_intensities.shape
    for name, arr in [
        ("pd_intensities", pd_intensities),
        ("gt_pano", gt_pano),
        ("pd_pano", pd_pano),
    ]:
        if arr.shape != (H, W):
            raise ValueError(f"{name} must be (H, W), got {arr.shape}")
    for arr in (gt_local_points, pd_local_points, gt_intensities, pd_intensities, gt_pano, pd_pano):
        if not isinstance(arr, np.ndarray):
            raise ValueError("All inputs must be numpy array.")

    def depth_metrics(gt, pd, min_depth=1e-3, max_depth=80, thresh_set=1.25):
        gt = np.clip(gt, min_depth, max_depth)
        pd = np.clip(pd, min_depth, max_depth)
        thresh = np.maximum(gt / pd, pd / gt)
        a1 = (thresh < thresh_set).mean()
        a2 = (thresh < thresh_set**2).mean()
        a3 = (thresh < thresh_set**3).mean()
        rmse = np.sqrt(((gt - pd) ** 2).mean())
        ssim = structural_similarity(gt, pd, data_range=gt.max() - gt.min())
        return rmse, a1, a2, a3, ssim

    metrics = {}
    (
        metrics["depth_rmse"],
        metrics["depth_a1"],
        metrics["depth_a2"],
        metrics["depth_a3"],
        metrics["depth_ssim"],
    ) = depth_metrics(gt_pano.flatten(), pd_pano.flatten())

    metrics["chamfer"], metrics["f_score"] = chamfer_and_fscore(
        pd_local_points.astype(np.float32),
        gt_local_points.astype(np.float32),
        threshold=0.05,
        device=device,
    )
    metrics["intensity_mae"] = np.abs(gt_intensities - pd_intensities).mean()
    return metrics
