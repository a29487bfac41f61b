"""Port parity for the evaluation protocol: the meters, SSIM, Chamfer/F-score,
the PNG writer and colour maps, and the mesh export, lidarnerf_tpu_torch vs
the JAX package (and OpenCV for the images), on the same seeded numpy inputs.

Tolerances: SSIM, the numpy-only meters, the PNGs and the mesh are
bit-equal (the same numpy arithmetic). A Chamfer term |a|^2 + |b|^2 - 2 a.b
is summed in float32 in another order by XLA and by PyTorch: each of its
three parts and two sums rounds by at most 2 eps (|a|^2 + |b|^2), so a
point a's distance to the other cloud B may differ by
CHAMFER_ULPS * eps * (|a|^2 + max_B |b|^2) (eps = 2^-23), and a mean by
that with the mean |a|^2. The F-score counts distances against the
threshold; the test clouds keep them 1% away from it, beyond that
rounding: equal.
"""

import re

import cv2
import numpy as np
import pytest
import torch

from lidarnerf_tpu.nerf import metrics as metrics_j
from lidarnerf_tpu.ops.chamfer import chamfer_and_fscore as chamfer_and_fscore_j
from lidarnerf_tpu.ops.chamfer import chamfer_distance as chamfer_distance_j
from lidarnerf_tpu.utils import mesh as mesh_j
from lidarnerf_tpu.utils.ssim import structural_similarity as ssim_j
from lidarnerf_tpu_torch.nerf import metrics
from lidarnerf_tpu_torch.ops.chamfer import chamfer_and_fscore, chamfer_distance
from lidarnerf_tpu_torch.utils import image_io, mesh
from lidarnerf_tpu_torch.utils.ssim import structural_similarity

CHAMFER_ULPS = 16
EPS32 = 2.0**-23
SCALE = 0.05
INTRINSICS = (2.0, 26.9)


def _sq(cloud):
    return np.sum(np.square(cloud, dtype=np.float64), -1)


def _chamfer_atol(pred, gt):
    """The bound on a Chamfer distance's float32 rounding (module docstring)."""
    p, g = _sq(pred), _sq(gt)
    return CHAMFER_ULPS * EPS32 * (p.mean() + g.max() + g.mean() + p.max())


def _depth_panos(rs, n, H=16, W=64):
    """n (pred, gt) pairs of [1, H, W] scaled depth panos with dropped pixels."""
    out = []
    for _ in range(n):
        gt = rs.uniform(0.5, 30.0, (1, H, W)) * SCALE
        gt[rs.uniform(size=gt.shape) < 0.1] = 0.0
        pred = np.clip(gt + rs.normal(0, 0.5 * SCALE, gt.shape), 0.0, None)
        pred[rs.uniform(size=gt.shape) < 0.1] = 0.0
        out.append((pred.astype(np.float32), gt.astype(np.float32)))
    return out


@pytest.mark.parametrize("shape,data_range", [((16, 64), None), ((66, 1030), 80.0), ((9, 9), 1.0)])
def test_ssim_is_bit_equal(shape, data_range):
    rs = np.random.RandomState(sum(shape))
    a, b = rs.uniform(0, 80, shape), rs.uniform(0, 80, shape)
    dr = data_range if data_range is not None else b.max() - b.min()
    assert structural_similarity(a, b, data_range=dr) == ssim_j(a, b, data_range=dr)


def _numbers(report):
    return [float(x) for x in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", report.split("=", 1)[1])]


@pytest.mark.parametrize("name", ["PSNRMeter", "RMSEMeter", "MAEMeter", "DepthMeter",
                                  "PointsMeter", "SSIMMeter"])
def test_meter_matches_jax(name):
    """Three updates, measure, report and write, then clear; bit-equal except
    the Chamfer distance (its rounding bound, from the panos' clouds)."""
    rs = np.random.RandomState(7)
    kwargs = {"MAEMeter": dict(intensity_inv_scale=2.0), "DepthMeter": dict(scale=SCALE),
              "PointsMeter": dict(scale=SCALE, intrinsics=INTRINSICS)}.get(name, {})
    port = getattr(metrics, name)(**kwargs, **({"device": "cpu"} if name == "PointsMeter" else {}))
    ref = getattr(metrics_j, name)(**kwargs)
    atol = 0.0
    for pred, gt in _depth_panos(rs, 3):
        clouds = [metrics_j.pano_to_lidar(x[0] / SCALE, INTRINSICS) for x in (pred, gt)]
        atol = max(atol, _chamfer_atol(*clouds))
        if name == "SSIMMeter":
            pred, gt = pred[..., None], gt[..., None]
        port.update(pred, gt)
        ref.update(pred, gt)
    got, want = np.asarray(port.measure()), np.asarray(ref.measure())
    if name == "PointsMeter":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)
        assert got[1] == want[1]
        assert port.report().split("=")[0] == ref.report().split("=")[0]
        np.testing.assert_allclose(_numbers(port.report()), _numbers(ref.report()),
                                   rtol=1e-7, atol=atol)  # the report's 8 digits
    else:
        np.testing.assert_array_equal(got, want)
        assert port.report() == ref.report()

    class Writer:
        def __init__(self):
            self.calls = []

        def add_scalar(self, *args):
            self.calls.append(args)

    wp, wr = Writer(), Writer()
    port.write(wp, 3, prefix="LiDAR_evaluate")
    ref.write(wr, 3, prefix="LiDAR_evaluate")
    assert [c[::2] for c in wp.calls] == [c[::2] for c in wr.calls]  # tag, step
    np.testing.assert_allclose([c[1] for c in wp.calls], [c[1] for c in wr.calls],
                               rtol=0, atol=atol)
    port.clear()
    assert port.N == 0


def _cloud(rs, n, spread=20.0):
    return rs.uniform(-spread, spread, (n, 3)).astype(np.float32)


def _threshold_pair(n):
    """gt = pred + an offset whose squared length is 0.05 * (1 -+ 1%), on a
    0.5 m grid within 3 m of the origin: each nearest-neighbour distance
    sits at the F-score threshold, on a known side of it."""
    g = np.arange(-3.0, 3.01, 0.5)
    pred = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)[:n]
    side = np.where(np.arange(n) % 2 == 0, 0.99, 1.01)
    gt = pred + np.array([0, 0, 1.0]) * np.sqrt(0.05 * side)[:, None]
    return pred.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("case", ["1x1023", "1023x1024", "1024x1025", "1025x1", "5000x4711",
                                  "duplicates", "at-threshold"])
def test_chamfer_and_fscore_match_jax(case):
    rs = np.random.RandomState(len(case))
    if case == "duplicates":
        base = _cloud(rs, 700, spread=2.0)
        pred = np.concatenate([base, base[:300], base[:5]])
        gt = np.concatenate([base[100:], base[100:400] + 0.01, base[:1]])
    elif case == "at-threshold":
        pred, gt = _threshold_pair(1500)
    else:
        n, m = map(int, case.split("x"))
        pred, gt = _cloud(rs, n, 2.0), _cloud(rs, m, 2.0)
    got = chamfer_and_fscore(pred, gt, threshold=0.05, device="cpu")
    want = chamfer_and_fscore_j(pred, gt, threshold=0.05)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=_chamfer_atol(pred, gt))
    assert got[1] == want[1]
    # each point's distance, unpadded (all valid)
    d = chamfer_distance(torch.from_numpy(pred), torch.from_numpy(gt))
    dj = chamfer_distance_j(pred, gt)
    for x, y, a, b in zip(d, dj, (pred, gt), (gt, pred)):
        bound = CHAMFER_ULPS * EPS32 * (_sq(a) + _sq(b).max())
        assert np.all(np.abs(x.numpy() - np.asarray(y)) <= bound)
    if case == "at-threshold":  # half the points on each side in each direction
        assert got[1] == 0.5
    if case == "duplicates":
        assert got[0] > 0 and got[1] > 0


@pytest.mark.parametrize("kind", ["grey", "bone", "hsv"])
def test_png_writer_and_colour_maps_match_opencv(kind, tmp_path):
    """The trainer's three image writes: the grey raydrop mask, intensity
    through COLORMAP_BONE and depth through COLORMAP_HSV, with the JAX
    trainer's `(x * 255).astype(np.uint8)` casts. The port's file and
    OpenCV's hold the same pixels (read back with cv2.imread)."""
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 1.2, (66, 1030))  # values above 1 wrap in the cast, as in the trainer
    x[:3] = np.linspace(0, 1, 1030)  # every grey level
    img = (x * 255).astype(np.uint8)
    if kind == "grey":
        ours, theirs = img, img
    else:
        cid = {"bone": image_io.COLORMAP_BONE, "hsv": image_io.COLORMAP_HSV}[kind]
        ours, theirs = image_io.apply_color_map(img, cid), cv2.applyColorMap(img, cid)
        np.testing.assert_array_equal(ours, theirs)
    image_io.imwrite(str(tmp_path / "port.png"), ours)
    cv2.imwrite(str(tmp_path / "cv2.png"), theirs)
    a = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_UNCHANGED)
    assert a.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_colour_map_tables_are_opencvs():
    ramp = np.arange(256, dtype=np.uint8)[:, None]
    for cid in (image_io.COLORMAP_BONE, image_io.COLORMAP_HSV):
        np.testing.assert_array_equal(image_io.COLORMAPS[cid], cv2.applyColorMap(ramp, cid)[:, 0])


def test_mesh_export_matches_jax(tmp_path):
    """extract_geometry and export_ply on the same density function (two
    blobs and a plane, chunked: resolution 40 > the chunk of 32 would need
    S=32; the default chunk of 128 covers it in one call)."""
    def density(pts):
        r1 = np.linalg.norm(pts - np.array([0.3, 0.0, 0.1]), axis=-1)
        r2 = np.linalg.norm(pts - np.array([-0.4, 0.2, -0.2]), axis=-1)
        return 30 * np.exp(-8 * r1**2) + 25 * np.exp(-12 * r2**2) + 12 * (pts[:, 2] < -0.7)

    calls = []

    def counted(pts):
        calls.append(len(pts))
        return density(pts)

    args = (np.full(3, -1.0), np.full(3, 1.0))
    v, t = mesh.extract_geometry(*args, resolution=40, threshold=10, query_func=counted)
    vj, tj = mesh_j.extract_geometry(*args, resolution=40, threshold=10, query_func=density)
    assert len(t) > 100 and calls == [40**3]
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(t, tj)
    mesh.export_ply(str(tmp_path / "port.ply"), v, t)
    mesh_j.export_ply(str(tmp_path / "jax.ply"), vj, tj)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    # chunked sampling (S < resolution) visits the grid in the same order
    u = mesh.extract_fields(*args, 20, density, S=8)
    np.testing.assert_array_equal(u, mesh_j.extract_fields(*args, 20, density, S=8))
