"""Structural similarity, numerically matching skimage.metrics.structural_similarity
(copy of lidarnerf_tpu/utils/ssim.py).

The depth-pano SSIM of the evaluation protocol is skimage's estimator with its
default settings (win_size=7 uniform filter, K1=0.01, K2=0.03, sample
covariance). skimage is not a dependency, so this is a from-scratch
implementation of the same estimator (Wang et al. 2004, as specialised by
skimage's defaults), on numpy and scipy.
"""

import numpy as np
from scipy.ndimage import uniform_filter


def structural_similarity(im1, im2, data_range=None, win_size=7, K1=0.01, K2=0.03):
    """Mean SSIM over valid (non-padded) windows; 2-D single-channel inputs."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    if im1.shape != im2.shape:
        raise ValueError("input shapes must match")
    if data_range is None:
        raise ValueError("data_range must be specified for float inputs")

    ndim = im1.ndim
    NP = win_size**ndim
    cov_norm = NP / (NP - 1)  # sample covariance, skimage default

    filt = lambda x: uniform_filter(x, size=win_size, mode="reflect")
    ux = filt(im1)
    uy = filt(im2)
    uxx = filt(im1 * im1)
    uyy = filt(im2 * im2)
    uxy = filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = data_range
    C1 = (K1 * R) ** 2
    C2 = (K2 * R) ** 2

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, s - pad) for s in S.shape)
    return float(S[crop].mean())
