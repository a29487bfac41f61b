"""Chamfer distance and F-score (counterpart of lidarnerf_tpu/ops/chamfer.py:27-111).

The same computation as the JAX package's, on the device: the rows of one
cloud go in 1024-row chunks against the whole other cloud, each chunk a
[1024, M] product (|a|^2 + |b|^2 - 2 a.b), so the N x M distance matrix
never exists whole. Masked columns take a 1e12 sentinel, the minima are
clamped at 0, and the clouds are padded to power-of-two buckets of at least
1024 rows. Squared euclidean distances, both directions; eval only.

The F-score counts squared distances below a threshold (0.05 in the
evaluation protocol), so the product runs in full float32: TF32 keeps 10
mantissa bits, and its error on |a|^2 + |b|^2 - 2 a.b at coordinates of tens
of metres exceeds the distances being counted.
"""

import contextlib

import numpy as np
import torch

from lidarnerf_tpu_torch.ops.dispatch import resolve_device

_CHUNK = 1024
_BIG = 1e12  # the squared norm a masked column takes


@contextlib.contextmanager
def _fp32_matmul():
    """CUDA matmuls in full float32 (no TF32) within, whatever the global flag says."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@torch.no_grad()
def _min_sq_dists(a, a_mask, b, b_mask):
    """For each valid row of a [N, 3], the least squared distance to the valid rows of b [M, 3].

    Rows of a that are masked out get 0.
    """
    b_sq = (b * b).sum(-1)  # [M]
    b_sq_masked = torch.where(b_mask, b_sq, _BIG)
    n = a.shape[0]
    pad = (-n) % _CHUNK
    a_p = torch.cat([a, a.new_zeros((pad, 3))])
    mins = []
    with _fp32_matmul():
        for ac in a_p.split(_CHUNK):
            a_sq = (ac * ac).sum(-1, keepdim=True)  # [C, 1]
            cross = ac @ b.T  # [C, M]
            d = a_sq + torch.where(b_mask, -2.0 * cross, 0.0) + b_sq_masked[None, :]
            mins.append(d.amin(-1))
    mins = torch.clamp(torch.cat(mins)[:n], min=0.0)  # numerical floor
    return torch.where(a_mask, mins, 0.0)


def chamfer_distance(pred, gt, pred_mask=None, gt_mask=None):
    """Bidirectional squared chamfer terms.

    Args:
        pred: [N, 3], gt: [M, 3] float32 tensors on one device (may be padded).
        pred_mask / gt_mask: [N] / [M] bool validity (None = all valid).

    Returns:
        (dist1 [N], dist2 [M]): per-point least squared distances, 0 at padding.
    """
    pred, gt = pred.float(), gt.float()
    if pred_mask is None:
        pred_mask = torch.ones(pred.shape[0], dtype=torch.bool, device=pred.device)
    if gt_mask is None:
        gt_mask = torch.ones(gt.shape[0], dtype=torch.bool, device=gt.device)
    return _min_sq_dists(pred, pred_mask, gt, gt_mask), _min_sq_dists(gt, gt_mask, pred, pred_mask)


def _bucket(n):
    return max(_CHUNK, int(2 ** np.ceil(np.log2(max(n, 1)))))


def chamfer_and_fscore(pred_np, gt_np, threshold=0.05, device=None):
    """mean(dist1) + mean(dist2) and the F-score at `threshold` (on squared distances).

    Args:
        pred_np, gt_np: [N, 3] / [M, 3] numpy point clouds of any sizes; each
            is padded to its power-of-two bucket, as in the JAX package.
        device: None runs on CUDA and raises if there is none; pass "cpu"
            to run on the CPU.

    Returns:
        (chamfer, fscore) as Python floats.
    """
    device = resolve_device(device)
    n, m = pred_np.shape[0], gt_np.shape[0]
    bn, bm = _bucket(n), _bucket(m)
    pred = np.zeros((bn, 3), np.float32)
    pred[:n] = pred_np
    gt = np.zeros((bm, 3), np.float32)
    gt[:m] = gt_np
    d1, d2 = chamfer_distance(
        torch.from_numpy(pred).to(device), torch.from_numpy(gt).to(device),
        torch.arange(bn, device=device) < n, torch.arange(bm, device=device) < m,
    )
    d1 = d1[:n].cpu().numpy()
    d2 = d2[:m].cpu().numpy()
    chamfer = float(d1.mean() + d2.mean())
    f, _, _ = fscore(d1[None], d2[None], threshold)
    return chamfer, float(f[0])


def fscore(dist1, dist2, threshold=0.001):
    """F-score from [B, N] / [B, M] squared-distance arrays (numpy); NaN -> 0.

    Returns (fscore, precision_1, precision_2), each [B].
    """
    dist1 = np.asarray(dist1)
    dist2 = np.asarray(dist2)
    precision_1 = (dist1 < threshold).mean(axis=1)
    precision_2 = (dist2 < threshold).mean(axis=1)
    denom = precision_1 + precision_2
    with np.errstate(invalid="ignore", divide="ignore"):
        f = 2 * precision_1 * precision_2 / denom
    f = np.where(np.isnan(f), 0.0, f)
    return f, precision_1, precision_2
