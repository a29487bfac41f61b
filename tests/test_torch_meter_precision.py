"""The Chamfer meter's precision on the drive's lidar ranges (ROADMAP.md C10).

Both meters compute the squared distances as |a|^2 + |b|^2 - 2 a.b
(`lidarnerf_tpu/ops/chamfer.py`, `lidarnerf_tpu_torch/ops/chamfer.py`). The
port takes a.b in float32 on both devices. The JAX package writes `ac @
b.T` at default precision: float32 on the CPU, where these tests hold the
two meters equal, and one bfloat16 pass on a TPU, where its round-5 runs
measured their val and test meters. That TPU meter is not reproduced here;
`tools/torch_c10_bisect.py` logs an emulation of it beside the port's meter
(unverified against a TPU).

Held here on the drive's val panos (`data_synth_drive60/`, every fourth
row): the port's meter equals a float64 nearest-neighbour search within
float32's rounding of the sum (Chamfer within the points' mean slack, F
within the points that lie that close to the threshold; a perfect
prediction 0 and 1.0 exactly), and the JAX package's meter equals the
port's on the CPU.
"""

import os

import numpy as np
import pytest
from scipy.spatial import cKDTree

from lidarnerf_tpu.ops.chamfer import chamfer_and_fscore as chamfer_and_fscore_j
from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset
from lidarnerf_tpu_torch.ops.chamfer import chamfer_and_fscore, fscore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data_synth_drive60")
THRESHOLD = 0.05  # the protocol's F-score threshold on squared distances
NOISE = [0.0, 0.02, 0.1]  # metres of Gaussian error on each predicted point


@pytest.fixture(scope="module")
def val_clouds():
    """The drive's two val panos as point clouds in metres, every fourth row."""
    import json

    scene = json.load(open(os.path.join(DATA, "scene_constants.json")))
    ds = KITTI360Dataset(split="val", root_path=DATA, scale=scene["scale"],
                         offset=scene["offset"], num_rays_lidar=4096, device="cpu")
    clouds = []
    for img in ds.images_lidar:
        img = np.asarray(img)[::4]
        depth = img[..., 2] * img[..., 0] / ds.scale
        clouds.append(pano_to_lidar(depth, ds.intrinsics_lidar).astype(np.float32))
    return clouds


def exact_sq_dists(a, b):
    """float64 nearest-neighbour squared distances from each row of a to b."""
    d, _ = cKDTree(b.astype(np.float64)).query(a.astype(np.float64))
    return d ** 2


def f32_slack(r, b_max):
    """float32 rounding of |a|^2 + |b|^2 - 2 a.b at norms r and b_max (a few ulps of the sum)."""
    return 4.0 * 2.0 ** -24 * (r + b_max) ** 2


def perturbed(gt, noise, seed=0):
    return gt + np.random.RandomState(seed).normal(scale=noise, size=gt.shape).astype(np.float32)


@pytest.mark.parametrize("noise", NOISE)
def test_port_meter_is_exact_at_lidar_range(val_clouds, noise):
    """The port's meter, and the JAX package's on the CPU, against float64."""
    for gt in val_clouds:
        pred = perturbed(gt, noise)
        d1, d2 = exact_sq_dists(pred, gt), exact_sq_dists(gt, pred)
        chamfer = d1.mean() + d2.mean()
        f = fscore(d1[None], d2[None], THRESHOLD)[0][0]
        b_max = float(np.linalg.norm(gt, axis=1).max()) + 1.0
        slack = [f32_slack(np.linalg.norm(c, axis=1), b_max) for c in (pred, gt)]
        near = sum(int((np.abs(d - THRESHOLD) <= s).sum()) for d, s in zip((d1, d2), slack))
        got = chamfer_and_fscore(pred, gt, THRESHOLD, device="cpu")
        assert abs(got[0] - chamfer) <= slack[0].mean() + slack[1].mean(), (got, chamfer)
        assert abs(got[1] - f) <= 2.0 * near / min(len(pred), len(gt)) + 1e-12, (got, f)
        if noise == 0.0:
            assert chamfer == 0.0 and f == 1.0 and got[1] == 1.0
        # the JAX package's meter, float32 on the CPU, on every 8th point: the
        # same sums, rounded in another order
        sub_p, sub_g = pred[::8], gt[::8]
        want = chamfer_and_fscore(sub_p, sub_g, THRESHOLD, device="cpu")
        tol = 2.0 * (slack[0].mean() + slack[1].mean())
        got_j = chamfer_and_fscore_j(sub_p, sub_g, THRESHOLD)
        assert abs(got_j[0] - want[0]) <= tol and abs(got_j[1] - want[1]) <= 1e-3, (got_j, want)
