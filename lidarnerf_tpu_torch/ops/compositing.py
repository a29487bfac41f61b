"""Alpha compositing of density samples along rays (counterpart of lidarnerf_tpu/ops/compositing.py).

Transmittance is a log-space exclusive cumsum of logaddexp(-x, log 1e-15),
x = delta * sigma: the same value as the reference's cumprod(1 - alpha + 1e-15),
with gradients bounded in (-1, 0] where a step saturates.
"""

import torch

# log(1e-15): the transmittance floor, matching the reference's "+ 1e-15"
_LOG_EPS = -34.538776394910684


def exclusive_cumsum(x):
    """Sum of the earlier entries along the last axis (0 at the first)."""
    c = torch.cumsum(x, dim=-1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def _log_trans(x):
    """log(1 - alpha + 1e-15) for alpha = 1 - exp(-x)."""
    return torch.logaddexp(-x, torch.full_like(x, _LOG_EPS))


def composite_weights(sigmas, z_vals, sample_dist, density_scale=1.0):
    """Per-sample compositing weights [N, S].

    Args:
        sigmas: [N, S] densities.
        z_vals: [N, S] sorted sample depths.
        sample_dist: [N, 1] per-ray base bin width, the last sample's delta.
    """
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])], dim=-1)
    x = deltas * density_scale * sigmas
    alphas = 1.0 - torch.exp(-x)
    return alphas * torch.exp(exclusive_cumsum(_log_trans(x)))


def merged_composite_weights(zA, sigA, zB, sigB, sample_dist, density_scale=1.0):
    """Compositing weights for the merge of two per-ray sorted sample lists,
    without materialising the merged order.

    Equal to composite_weights over the stably sorted concat([A, B]), split
    back into the two lists: equal depths order A before B. A sample's delta
    is its merge successor minus itself (a masked min over the other list),
    and its log-transmittance is its own list's exclusive cumsum plus a masked
    sum over the other list's earlier samples.

    Args:
        zA, sigA: [N, TA] sorted depths + densities (coarse list).
        zB, sigB: [N, TB] sorted depths + densities (fine list).
        sample_dist: [N, 1] base bin width.

    Returns:
        (wA [N, TA], wB [N, TB])
    """
    inf = torch.tensor(float("inf"), dtype=zA.dtype, device=zA.device)

    # successor of A[i]: next within A, or the first B >= A[i] (B ties sort after A)
    nextA = torch.cat([zA[..., 1:], torch.full_like(zA[..., :1], float("inf"))], dim=-1)
    minB_ge = torch.where(zB[:, None, :] >= zA[:, :, None], zB[:, None, :], inf).amin(-1)
    succA = torch.minimum(nextA, minB_ge)
    deltaA = torch.where(torch.isinf(succA), sample_dist, succA - zA)

    # successor of B[j]: next within B, or the first A strictly greater
    nextB = torch.cat([zB[..., 1:], torch.full_like(zB[..., :1], float("inf"))], dim=-1)
    minA_gt = torch.where(zA[:, None, :] > zB[:, :, None], zA[:, None, :], inf).amin(-1)
    succB = torch.minimum(nextB, minA_gt)
    deltaB = torch.where(torch.isinf(succB), sample_dist, succB - zB)

    xA = deltaA * density_scale * sigA
    xB = deltaB * density_scale * sigB
    aA = 1.0 - torch.exp(-xA)
    aB = 1.0 - torch.exp(-xB)
    lA = _log_trans(xA)
    lB = _log_trans(xB)

    # log T at A[i]: own exclusive cumsum + every B strictly before it; at
    # B[j]: own exclusive cumsum + every A at or before it
    crossB_at_A = torch.where(zB[:, None, :] < zA[:, :, None], lB[:, None, :], 0.0).sum(-1)
    crossA_at_B = torch.where(zA[:, None, :] <= zB[:, :, None], lA[:, None, :], 0.0).sum(-1)
    wA = aA * torch.exp(exclusive_cumsum(lA) + crossB_at_A)
    wB = aB * torch.exp(exclusive_cumsum(lB) + crossA_at_B)
    return wA, wB
