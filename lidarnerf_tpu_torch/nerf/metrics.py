"""Evaluation meters (counterpart of lidarnerf_tpu/nerf/metrics.py).

The meters of the evaluation protocol, with the JAX package's semantics,
`report()` strings and `write()` calls: accumulation cadence, clamping
constants, scale handling, and the Chamfer/F-score path through
`pano_to_lidar`. They are host-side numpy; the Chamfer inner loop runs on
the device through `ops/chamfer.py`. `LPIPSMeter` (RGB only) needs the
optional `lpips` package and its pretrained weights; without them its
constructor raises ImportError, as the JAX package's does.
"""

import os

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar
from lidarnerf_tpu_torch.ops.chamfer import chamfer_and_fscore
from lidarnerf_tpu_torch.utils.ssim import structural_similarity


def _to_numpy(*inputs):
    return [np.asarray(x) for x in inputs]


class PSNRMeter:
    """Mean PSNR over the updates."""

    def __init__(self):
        self.V, self.N = 0, 0

    def clear(self):
        self.V, self.N = 0, 0

    def update(self, preds, truths):
        preds, truths = _to_numpy(preds, truths)
        psnr = -10 * np.log10(np.mean((preds - truths) ** 2))
        self.V += psnr
        self.N += 1

    def measure(self):
        return self.V / self.N

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(os.path.join(prefix, "PSNR"), self.measure(), global_step)

    def report(self):
        return f"PSNR = {self.measure():.6f}"


class RMSEMeter:
    """Mean RMSE over the updates."""

    def __init__(self):
        self.V, self.N = 0, 0

    def clear(self):
        self.V, self.N = 0, 0

    def update(self, preds, truths):
        preds, truths = _to_numpy(preds, truths)
        rmse = np.sqrt(((truths - preds) ** 2).mean())
        self.V += rmse
        self.N += 1

    def measure(self):
        return self.V / self.N

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(os.path.join(prefix, "RMSE"), self.measure(), global_step)

    def report(self):
        return f"RMSE = {self.measure():.6f}"


class MAEMeter:
    """Mean intensity MAE, scaled by intensity_inv_scale."""

    def __init__(self, intensity_inv_scale=1.0):
        self.V, self.N = 0, 0
        self.intensity_inv_scale = intensity_inv_scale

    def clear(self):
        self.V, self.N = 0, 0

    def update(self, preds, truths):
        preds, truths = _to_numpy(preds, truths)
        mae = np.abs(
            truths * self.intensity_inv_scale - preds * self.intensity_inv_scale
        ).mean()
        self.V += mae
        self.N += 1

    def measure(self):
        return self.V / self.N

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(os.path.join(prefix, "MAE"), self.measure(), global_step)

    def report(self):
        return f"MAE = {self.measure():.6f}"


class DepthMeter:
    """Depth RMSE, delta accuracies and SSIM in metres, clamped to [1e-3, 80] m."""

    def __init__(self, scale):
        self.V, self.N = [], 0
        self.scale = scale

    def clear(self):
        self.V, self.N = [], 0

    def update(self, preds, truths):
        preds, truths = _to_numpy(preds, truths)
        preds = preds / self.scale
        truths = truths / self.scale
        self.V.append(list(self.compute_depth_errors(truths, preds)))
        self.N += 1

    def compute_depth_errors(self, gt, pred, min_depth=1e-3, max_depth=80, thresh_set=1.25):
        pred = np.clip(pred, min_depth, max_depth)
        gt = np.clip(gt, min_depth, max_depth)
        thresh = np.maximum(gt / pred, pred / gt)
        a1 = (thresh < thresh_set).mean()
        a2 = (thresh < thresh_set**2).mean()
        a3 = (thresh < thresh_set**3).mean()
        rmse = np.sqrt(((gt - pred) ** 2).mean())
        ssim = structural_similarity(
            pred.squeeze(0), gt.squeeze(0), data_range=np.max(gt) - np.min(gt)
        )
        return rmse, a1, a2, a3, ssim

    def measure(self):
        assert self.N == len(self.V)
        return np.array(self.V).mean(0)

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(
            os.path.join(prefix, "depth error"), self.measure()[0], global_step
        )

    def report(self):
        return f"Depth_error(rmse, a1, a2, a3, ssim) = {self.measure()}"


class PointsMeter:
    """Chamfer distance and F-score at 0.05 of the panos' point clouds.

    device: where the Chamfer distances are computed; None runs on CUDA and
    raises if there is none, "cpu" runs on the CPU.
    """

    def __init__(self, scale, intrinsics, device=None):
        self.V, self.N = [], 0
        self.device = device
        self.scale = scale
        self.intrinsics = intrinsics

    def clear(self):
        self.V, self.N = [], 0

    def update(self, preds, truths):
        preds, truths = _to_numpy(preds, truths)
        preds = preds / self.scale
        truths = truths / self.scale
        pred_lidar = pano_to_lidar(preds[0], self.intrinsics)
        gt_lidar = pano_to_lidar(truths[0], self.intrinsics)
        chamfer, f = chamfer_and_fscore(pred_lidar, gt_lidar, threshold=0.05,
                                       device=self.device)
        self.V.append([chamfer, f])
        self.N += 1

    def measure(self):
        assert self.N == len(self.V)
        return np.array(self.V).mean(0)

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(os.path.join(prefix, "CD"), self.measure()[0], global_step)

    def report(self):
        return f"CD f-score = {self.measure()}"


class LPIPSMeter:
    """Mean perceptual similarity (the `lpips` package) over RGB updates.

    RGB only (never on the LiDAR path); needs the optional `lpips` package
    and its pretrained weights, so construction raises ImportError without
    them.
    """

    def __init__(self, net="alex", device=None):
        try:
            import lpips
        except ImportError as e:
            raise ImportError(
                "LPIPSMeter requires the optional 'lpips' package (RGB eval only)"
            ) from e
        self.V, self.N = 0, 0
        self.net = net
        self.fn = lpips.LPIPS(net=net).eval()

    def clear(self):
        self.V, self.N = 0, 0

    def update(self, preds, truths):
        p = torch.tensor(np.asarray(preds)).permute(0, 3, 1, 2).contiguous()
        t = torch.tensor(np.asarray(truths)).permute(0, 3, 1, 2).contiguous()
        self.V += self.fn(t, p, normalize=True).item()
        self.N += 1

    def measure(self):
        return self.V / self.N

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(os.path.join(prefix, f"LPIPS ({self.net})"), self.measure(),
                          global_step)

    def report(self):
        return f"LPIPS ({self.net}) = {self.measure():.6f}"


class SSIMMeter:
    """Mean SSIM of [1, H, W, 1] images; `device` is not read, as in the JAX meter."""

    def __init__(self, device=None):
        self.V, self.N = 0, 0

    def clear(self):
        self.V, self.N = 0, 0

    def update(self, preds, truths):
        preds, truths = _to_numpy(preds, truths)
        p = preds.squeeze(0).squeeze(-1)
        t = truths.squeeze(0).squeeze(-1)
        ssim = structural_similarity(p, t, data_range=max(t.max() - t.min(), 1e-9))
        self.V += ssim
        self.N += 1

    def measure(self):
        return self.V / self.N

    def write(self, writer, global_step, prefix=""):
        writer.add_scalar(os.path.join(prefix, "SSIM"), self.measure(), global_step)

    def report(self):
        return f"SSIM = {self.measure():.6f}"
