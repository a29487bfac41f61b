"""Per-element loss criteria (counterpart of lidarnerf_tpu/ops/losses.py:1-94).

The CLI's criteria {mse, l1, bce, huber, cos} with reduction='none' (huber
delta = 0.2 * scale), plus mape, eff_distloss and the sRGB pair.
"""

import torch

from lidarnerf_tpu_torch.ops.compositing import exclusive_cumsum


def mse(pred, gt):
    return (pred - gt) ** 2


def l1(pred, gt):
    return torch.abs(pred - gt)


def bce_with_logits(pred, gt):
    """Numerically stable BCEWithLogitsLoss, reduction='none'."""
    return torch.clamp(pred, min=0.0) - pred * gt + torch.log1p(torch.exp(-torch.abs(pred)))


def huber(pred, gt, delta=1.0):
    """torch.nn.HuberLoss semantics, reduction='none'."""
    err = torch.abs(pred - gt)
    quad = 0.5 * err**2
    lin = delta * (err - 0.5 * delta)
    return torch.where(err < delta, quad, lin)


def huber_loss_ngp(pred, gt, delta=0.1):
    """The torch-ngp huber variant (0.5 / delta scaling)."""
    rel = torch.abs(pred - gt)
    sqr = 0.5 / delta * rel * rel
    return torch.where(rel > delta, rel - 0.5 * delta, sqr)


def linear_to_srgb(x):
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * x**0.41666 - 0.055)


def srgb_to_linear(x):
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def cosine_similarity(pred, gt, axis=1, eps=1e-8):
    """torch.nn.CosineSimilarity semantics along `axis` (the JAX package's form)."""
    num = torch.sum(pred * gt, dim=axis)
    na = torch.linalg.norm(pred, dim=axis)
    nb = torch.linalg.norm(gt, dim=axis)
    return num / torch.clamp(na * nb, min=eps)


def mape(pred, gt, eps=1e-2):
    """Mean-absolute-percentage style loss, per element."""
    return torch.abs(pred - gt) / (torch.abs(gt) + eps)


def eff_distloss(weights, midpoints, intervals):
    """O(S) distortion loss of mip-NeRF 360.

    Args:
        weights: [..., S] compositing weights.
        midpoints: [..., S] sorted interval midpoints.
        intervals: [..., S] interval lengths.
    """
    wm = weights * midpoints
    w_prefix = exclusive_cumsum(weights)
    wm_prefix = exclusive_cumsum(wm)
    loss_uni = (1.0 / 3.0) * torch.sum(intervals * weights**2, dim=-1)
    loss_bi = 2.0 * torch.sum(wm * w_prefix - weights * wm_prefix, dim=-1)
    return loss_uni + loss_bi


def make_criterion(name: str, scale: float = 1.0):
    """The CLI's loss factory (main_lidarnerf.py:330-342)."""
    if name == "mse":
        return mse
    if name == "l1":
        return l1
    if name == "bce":
        return bce_with_logits
    if name == "huber":
        delta = 0.2 * scale
        return lambda p, g: huber(p, g, delta=delta)
    if name == "cos":
        return cosine_similarity
    raise ValueError(f"unknown loss '{name}' (choose from mse,l1,bce,huber,cos)")
