"""Port parity for the NeRF-MVL object-level path: lidarnerf_tpu_torch against
the JAX package on the tiny masked dataset of tests/test_e2e_mvl.py (16 x 64
panos, -1 outside a rectangle around a sphere).

Exact: the dataset (fields, poses, images, OBB_local, offset, pools), the
host collate (numpy's global stream seeded), SimpleLoader's order, the OBB
crop and the six pano converters (the same numpy arithmetic). The masked
training step through the Trainer is held to tests/test_torch_train.py's
tolerances; the MVL evaluation and test branches are fed the same panos on
both sides and held to tests/test_torch_metrics.py's (numpy meters bit-equal,
the Chamfer distance within its float32 rounding bound) and bit-equal
clouds, and the two packages' renders of those panos to the render parity
tolerance (rtol 1e-4, atol 1e-5). The tiny CLI flow writes the JAX CLI's
files; resume repeats an uninterrupted run bit for bit; the device-side
pool draw is uniform; the synthetic-data tool traces and writes what the
JAX tool does.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import main_lidarnerf as cli_j  # noqa: E402
import make_synth_mvl as synth_j  # noqa: E402
from lidarnerf_tpu.dataset import convert as convert_j  # noqa: E402
from lidarnerf_tpu.dataset.kitti360 import KITTI360Dataset as KITTI360DatasetJ  # noqa: E402
from lidarnerf_tpu.dataset.kitti360 import SimpleLoader as SimpleLoaderJ  # noqa: E402
from lidarnerf_tpu.dataset.nerfmvl import NeRFMVLDataset as NeRFMVLDatasetJ  # noqa: E402
from lidarnerf_tpu.nerf import metrics as metrics_j  # noqa: E402
from lidarnerf_tpu.nerf import train_step as tsj  # noqa: E402
from lidarnerf_tpu.nerf.trainer import Trainer as TrainerJ  # noqa: E402
from lidarnerf_tpu.utils import geometry as geometry_j  # noqa: E402
from lidarnerf_tpu_torch import main_lidarnerf as cli  # noqa: E402
from lidarnerf_tpu_torch.dataset import convert  # noqa: E402
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset, SimpleLoader  # noqa: E402
from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset  # noqa: E402
from lidarnerf_tpu_torch.nerf import metrics  # noqa: E402
from lidarnerf_tpu_torch.nerf import train_step as tst  # noqa: E402
from lidarnerf_tpu_torch.nerf.trainer import Trainer  # noqa: E402
from lidarnerf_tpu_torch.tools import make_synth_mvl as synth  # noqa: E402
from lidarnerf_tpu_torch.utils import geometry  # noqa: E402
from lidarnerf_tpu_torch.utils.params import params_from_jax, params_to_jax  # noqa: E402
from test_e2e_mvl import H, W, write_synthetic_mvl  # noqa: E402
from test_torch_cli import _files  # noqa: E402

SCALE = 0.05
K_MVL = (15, 40)
RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
CHAMFER_ULPS, EPS32 = 16, 2.0**-23  # the Chamfer rounding bound of tests/test_torch_metrics.py
# the tiny flow of tests/test_e2e_mvl.py, with the coarse field of
# tests/test_torch_workspace.py (a 64-cell 2^10 table, 16 + 4 samples)
TINY_ARGV = ["--config", "configs/nerf_mvl.txt", "--iters", "9", "--num_steps", "16",
             "--upsample_steps", "4", "--num_rays_lidar", "128", "--desired_resolution", "64",
             "--log2_hashmap_size", "10", "--max_ray_batch", "512", "--scale", str(SCALE)]
N, T, S = 128, 16, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread, so that the workers of a parallel
    test run do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mvl"))
    write_synthetic_mvl(root)  # 3 train, 2 val, 2 test frames
    return root


def _kw(data, split, **kw):
    return {"split": split, "root_path": data, "sequence_id": "car", "scale": SCALE,
            "offset": [1.0, 2.0, 3.0], "num_rays_lidar": N, **kw}


# ---------------------------------------------------------------- the dataset


def test_mvl_dataset_fields_are_the_jax_dataclass_fields():
    port = [(f.name, f.default) for f in dataclasses.fields(NeRFMVLDataset)]
    jax_ = [(f.name, f.default) for f in dataclasses.fields(NeRFMVLDatasetJ)]
    assert port == jax_ and len(port) == 13


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_mvl_dataset_matches_jax(data, split):
    """Poses, images, OBB, OBB_local and the offset (the OBB's mean, not the
    `offset` argument), the -1 rule off the train split, the pools, and the
    device arrays (four, cached per device)."""
    ds, ref = NeRFMVLDataset(**_kw(data, split)), NeRFMVLDatasetJ(**_kw(data, split))
    for name in ("class_name", "training", "testing", "num_rays", "num_rays_lidar", "H_lidar",
                 "W_lidar", "intrinsics_lidar"):
        assert getattr(ds, name) == getattr(ref, name), name
    assert ds.num_rays_lidar == (N if split == "train" else -1)
    for name in ("poses_lidar", "images_lidar", "OBB", "OBB_local", "offset"):
        a, b = getattr(ds, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert not np.allclose(ds.offset, [1.0, 2.0, 3.0])
    assert (ds.images_lidar[..., 0] == -1).any() and (ds.images_lidar[..., 0] == 0).any()
    idx, counts = ds.valid_indices_padded()
    idx_j, counts_j = ref.valid_indices_padded()
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(counts, counts_j)
    arrs = ds.device_arrays("cpu")
    assert len(arrs) == 4 and ds.device_arrays("cpu")[2] is arrs[2]  # cached
    for a, b in zip(arrs, ref.device_arrays()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert arrs[2].dtype == arrs[3].dtype == torch.long


@pytest.mark.parametrize("split", ["train", "test"])
def test_mvl_dataset_rgb_frames(data, split):
    """enable_lidar=False loads the frames as the JAX dataset does; collate
    returns no LiDAR keys (the test split keeps its OBB_local) and draws
    nothing."""
    ds = NeRFMVLDataset(**_kw(data, split, enable_lidar=False))
    ref = NeRFMVLDatasetJ(**_kw(data, split, enable_lidar=False))
    np.testing.assert_array_equal(ds.images_lidar, ref.images_lidar)
    np.testing.assert_array_equal(ds.poses_lidar, ref.poses_lidar)
    np.random.seed(0)
    out, want = ds.collate([0]), ref.collate([0])
    assert out.keys() == want.keys() == ({"OBB_local"} if split == "test" else set())
    for k in out:
        np.testing.assert_array_equal(out[k], want[k])
    assert np.random.randint(0, 2**31 - 1) == np.random.RandomState(0).randint(0, 2**31 - 1)


def _assert_batches_equal(out, ref):
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if k == "rays_d_lidar":  # float32 trig of two libms: a few ulps
            np.testing.assert_allclose(out[k].numpy(), np.asarray(v), rtol=0, atol=1e-6)
        elif isinstance(v, int):
            assert out[k] == v, k
        else:
            got = out[k].numpy() if torch.is_tensor(out[k]) else out[k]
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_mvl_collate_matches_jax(data, split):
    """With numpy's global stream seeded alike, the same pixels (a training
    frame's unmasked ones, subsampled by np.random.permutation), the same
    images and, on test, the frame's OBB_local."""
    ds, ref = NeRFMVLDataset(**_kw(data, split, num_rays_lidar=40)), NeRFMVLDatasetJ(
        **_kw(data, split, num_rays_lidar=40))
    for i in range(len(ds)):
        np.random.seed(i)
        out = ds.collate([i])
        np.random.seed(i)
        _assert_batches_equal(out, ref.collate([i]))
    if split == "train":
        assert out["images_lidar"].shape == (1, 40, 3)
        assert (out["images_lidar"][..., 0] > -1).all()
    else:
        assert out["images_lidar"].shape == (1, H, W, 3)
    assert ("OBB_local" in out) == (split == "test")


def test_mvl_collate_rejects_batch_gt1(data):
    ds = NeRFMVLDataset(**_kw(data, "train"))
    assert ds.collate([0])["images_lidar"].shape[0] == 1
    with pytest.raises(AssertionError, match="batch=1"):
        ds.collate([0, 1])
    # off the train split the whole panos of several frames are fine
    assert NeRFMVLDataset(**_kw(data, "val")).collate([0, 1])["images_lidar"].shape[0] == 2


def test_kitti360_collate_follows_numpy_and_keeps_the_jax_layout():
    """The KITTI-360 host collate: on the train split `num_rays_lidar` pixels
    whose draw repeats under np.random.seed (its generator is seeded from
    numpy's stream, as the JAX package's key is), each image row the pixel
    of its ray; off it, the JAX collate's every ray and whole panos."""
    from test_torch_train import DATA, _drive

    scale, offset = _drive()
    kw = dict(root_path=DATA, scale=scale, offset=offset, num_rays_lidar=64)
    ds = KITTI360Dataset(split="train", **kw)
    np.random.seed(3)
    a = ds.collate([5])
    np.random.seed(3)
    b = ds.collate([5])
    for k in ("rays_o_lidar", "rays_d_lidar", "images_lidar"):
        assert a[k].shape == (1, 64, 3) and torch.equal(a[k], b[k]), k
    # the images are the gathered pixels of the rays: find each ray's pixel
    dirs = convert.pano_dirs(ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar).reshape(-1, 3)
    local = a["rays_d_lidar"][0].numpy() @ ds.poses_lidar[5][:3, :3]
    pix = np.argmin(((local[:, None] - dirs[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(a["images_lidar"][0].numpy(),
                                  ds.images_lidar[5].reshape(-1, 3)[pix])
    ref = KITTI360DatasetJ(split="val", **kw)
    _assert_batches_equal(KITTI360Dataset(split="val", **kw).collate([0]), ref.collate([0]))


def test_simple_loader_order_matches_jax(data):
    """Three passes, shuffled and in order: the same frames in the same order."""

    class Frames:
        images_lidar = np.zeros(1)

        def __len__(self):
            return 7

        def collate(self, index):
            return index

    for shuffle in (True, False):
        port, ref = SimpleLoader(Frames(), shuffle), SimpleLoaderJ(Frames(), shuffle)
        assert (len(port), port.batch_size, port.has_gt) == (len(ref), 1, True)
        assert [list(port) for _ in range(3)] == [list(ref) for _ in range(3)]
    for split, shuffle in (("train", True), ("test", False)):
        loader = NeRFMVLDataset(**_kw(data, split)).dataloader()
        assert loader.shuffle == shuffle and len(loader) == (3 if split == "train" else 2)
        assert all(b["images_lidar"].shape[0] == 1 for b in loader)


# ---------------------------------------------------- geometry and converters


def _obb(rs, yaw, center=(0.0, 0.0, 0.0), half=(2.0, 1.0, 0.8)):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    return (corners * half) @ R.T + np.asarray(center)


@pytest.mark.parametrize("case", ["random", "rotated", "edges"])
def test_filter_bbox_dataset_matches_jax(case):
    rs = np.random.RandomState(len(case))
    if case == "edges":
        # an axis-aligned box: points on its edges, at its vertices, on its
        # z faces, and just outside each
        obb = _obb(rs, 0.0, half=(2.0, 1.0, 1.0))
        t = np.linspace(-1.0, 1.0, 9)
        pts = [[2.0 * x, 1.0, 0.0] for x in t] + [[-2.0, y, 0.5] for y in t]
        pts += [[sx * 2.0, sy * 1.0, sz * 1.0] for sx in (-1, 1) for sy in (-1, 1)
                for sz in (-1, 1)]
        pts += [[0.5, 0.5, 1.0], [0.5, 0.5, -1.0], [2.0 + 1e-6, 0.0, 0.0],
                [0.0, -1.0 - 1e-6, 0.0], [0.0, 0.0, 1.0 + 1e-6], [0.0, 0.0, 0.0]]
        pc = np.array(pts, np.float32)
    else:
        obb = _obb(rs, 0.0 if case == "random" else 0.6, center=(6.0, 0.5, -0.2))
        pc = rs.uniform(-1, 1, (4000, 3)).astype(np.float32) * [5, 3, 2] + [6.0, 0.5, -0.2]
    obb = np.concatenate([obb, np.ones((8, 1))], 1)  # OBB_local's [8, 4]
    got = geometry.filter_bbox_dataset(pc, obb[:, :3])
    want = geometry_j.filter_bbox_dataset(pc, obb[:, :3])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(pc)
    quad = obb[:4, :2][[0, 3, 1, 2]]
    np.testing.assert_array_equal(geometry.sort_quadrilateral(quad),
                                  geometry_j.sort_quadrilateral(quad))
    np.testing.assert_array_equal(geometry.points_in_poly(pc[:, 0], pc[:, 1], quad),
                                  geometry_j.points_in_poly(pc[:, 0], pc[:, 1], quad))


def _local_cloud(rs, n=3000):
    """Points around the sensor with intensities: ranges 0.5-90 m, elevations
    inside and outside the MVL field of view, duplicates that share pixels."""
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * rs.uniform(0.5, 90.0, (n, 1))
    pts = np.concatenate([pts, pts[:300] * 1.01, pts[:50]])
    return np.concatenate([pts, rs.uniform(0, 255, (len(pts), 1))], 1)


@pytest.mark.parametrize("name", ["_project_rc", "lidar_to_pano_with_intensities", "lidar_to_pano",
                                  "lidar_to_pano_with_intensities_with_bbox_mask",
                                  "pano_to_lidar_padded", "lidar_to_pano_with_intensities_fpa"])
def test_converter_matches_jax(name):
    rs = np.random.RandomState(len(name))
    pts = _local_cloud(rs)
    args = {
        "_project_rc": (pts[:, :3], H, W, K_MVL),
        "lidar_to_pano_with_intensities": (pts, H, W, K_MVL),
        "lidar_to_pano": (pts[:, :3], H, W, K_MVL),
        "lidar_to_pano_with_intensities_with_bbox_mask": (
            pts, H, W, K_MVL, np.concatenate([_obb(rs, 0.4, center=(6, 1, 0)),
                                              np.ones((8, 1))], 1)),
        "pano_to_lidar_padded": (convert_j.lidar_to_pano(pts[:, :3], H, W, K_MVL), K_MVL),
        "lidar_to_pano_with_intensities_fpa": (pts, H, W, K_MVL),
    }[name]
    got, want = getattr(convert, name)(*args), getattr(convert_j, name)(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if name == "lidar_to_pano_with_intensities_with_bbox_mask":
        assert (got[0] == -1).any() and (got[0] > 0).any()


# ------------------------------------------------- the masked training step


def _opts(data, *extra):
    """The port's and the JAX CLI's options after main()'s own settings."""
    argv = TINY_ARGV + ["--path", data, *extra]
    opt, opt_j = cli.get_arg_parser().parse_args(argv), cli_j.get_arg_parser().parse_args(argv)
    for o in (opt, opt_j):
        o.enable_lidar = True
        o.min_near = o.min_near_lidar = o.scale
        o.H_lidar, o.W_lidar, o.intrinsics_lidar = H, W, K_MVL
    cli.apply_macros(opt)
    return opt, opt_j


def _meters(opt, port=True):
    m = metrics if port else metrics_j
    extra = {"device": "cpu"} if port else {}
    return [m.MAEMeter(intensity_inv_scale=opt.intensity_inv_scale), m.RMSEMeter(),
            m.DepthMeter(scale=opt.scale),
            m.PointsMeter(scale=opt.scale, intrinsics=K_MVL, **extra)]


def _trainer(opt, workspace=None, **kw):
    kw = {"ema_decay": 0.95, "use_checkpoint": "latest", **kw}
    return Trainer("lidar_nerf", opt, cli.build_model(opt), device="cpu", mute=True,
                   workspace=None if workspace is None else str(workspace), **kw)


def _jax_trainer(opt_j, workspace, port, **kw):
    """The JAX Trainer holding the port trainer's weights and EMA."""
    tj = TrainerJ("lidar_nerf", opt_j, cli_j.build_model(opt_j), mute=True,
                  workspace=str(workspace), ema_decay=0.95, **kw)
    tj.params = jax.tree.map(jnp.asarray, params_to_jax(port.model.state_dict()))
    tj.ema_params = jax.tree.map(jnp.asarray, params_to_jax(port.ema_params))
    return tj


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_masked_step_through_the_trainer_matches_jax(data, tmp_path):
    """The Trainer's masked data path (the dataset's four arrays, the masked
    step function) against the JAX Trainer's, on the same weights and the
    draws the JAX step derives from its key: the loss, the gradients and the
    Adam update to tests/test_torch_train.py's tolerances."""
    from test_torch_train import _grad_tol

    opt, opt_j = _opts(data)
    port = _trainer(opt)
    # a field with structure: O(1) table values, a sharpened density head
    with torch.no_grad():
        port.model.hash_table.mul_(1e4)
        port.model.sigma_net.layers[1].weight[0].mul_(3.0).add_(0.1)
    tj = _jax_trainer(opt_j, tmp_path, port)
    ds, ds_j = NeRFMVLDataset(**_kw(data, "train")), NeRFMVLDatasetJ(**_kw(data, "train"))
    poses, images, vi, vc, masked = port._device_data(ds)
    poses_j, images_j, vi_j, vc_j, masked_j = tj._device_data(ds_j)
    assert masked and masked_j
    frame, key = 1, jax.random.PRNGKey(7)

    loss_fn = tsj.make_loss_fn(tj.module, tj.train_cfg, tj.render_cfg, 1, True)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        tj.params, poses_j[frame], images_j[frame].reshape(-1, 3), vi_j[frame], vc_j[frame],
        key, None)
    new_j, _, m_j = tj._get_step_fn(1, True)(tj.params, tj.opt_state, poses_j, images_j, vi_j,
                                             vc_j, frame, key, 0)
    k_pix, k_render = jax.random.split(key)
    k_strat, k_pdf = jax.random.split(k_render)
    draws = {"pool_draws": jax.random.randint(k_pix, (N,), 0, int(vc[frame])),
             "noise": jax.random.uniform(k_strat, (N, T), dtype=jnp.float32),
             "u": jax.random.uniform(k_pdf, (N, S), dtype=jnp.float32)}
    before = {k: v.copy() for k, v in _flat(params_to_jax(port.model.state_dict())).items()}
    m = port._get_step_fn(1, True)(poses, images, vi, vc, frame, draws={
        k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    assert port._get_step_fn(1, True) is not port._get_step_fn(1, False)

    assert m["skipped_nonfinite"] == 0.0 and float(m_j["skipped_nonfinite"]) == 0.0
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
    for k in ("depth_mae", "raydrop_err"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=1e-7)
    gj = _flat(jax.tree.map(np.asarray, grads_j))
    gt = _flat(params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                              for k, p in port.model.named_parameters()}))
    after, after_j = _flat(params_to_jax(port.model.state_dict())), _flat(new_j)
    for name, ref in gj.items():
        peak = np.abs(ref).max()
        if name.startswith("params/color_net"):  # the RGB head is not on the LiDAR path
            continue
        assert peak > 0, name
        np.testing.assert_allclose(gt[name], ref, rtol=0, atol=_grad_tol(name) * peak,
                                   err_msg=name)
        live = np.abs(ref) > 1e-3 * peak
        np.testing.assert_allclose(after[name][live], after_j[name][live], rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(np.abs(after[name][live] - before[name][live]), opt.lr,
                                   rtol=1e-3)


def test_masked_trainer_draws_only_unmasked_pixels(data, monkeypatch):
    """Trainer.train on NeRF-MVL goes through the masked sampler: every
    pixel a step draws is unmasked in its frame."""
    opt, _ = _opts(data)
    ds = NeRFMVLDataset(**_kw(data, "train"))
    seen = []
    sample = tst.sample_pixels

    def spy(cfg, patch, masked, without, valid_idx, valid_count, *args, **kw):
        inds = sample(cfg, patch, masked, without, valid_idx, valid_count, *args, **kw)
        seen.append((masked, inds, valid_idx[:valid_count]))
        return inds

    monkeypatch.setattr(tst, "sample_pixels", spy)
    t = _trainer(opt)
    t.train(ds, None, max_epochs=1)
    assert len(seen) == 3 and all(masked for masked, _, _ in seen)
    pools = [p[:c] for p, c in zip(*ds.valid_indices_padded())]
    assert sorted(tuple(pool.tolist()) for _, _, pool in seen) == sorted(
        tuple(p.tolist()) for p in pools)  # each frame once
    for _, inds, pool in seen:
        assert len(inds) == N and np.isin(inds.numpy(), pool.numpy()).all()


# --------------------------------------------- evaluation, test, CLI, resume


def _same_panos(port, tj):
    """Make the JAX trainer render what the port renders (frame by frame, in
    call order), and keep the port's panos and the JAX trainer's own renders
    of the same weights to compare."""
    panos, own = [], []
    render, render_j = port._render_full_frame, tj._render_full_frame

    def port_render(dataset, i):
        out = render(dataset, i)
        panos.append(out)
        return out

    def jax_render(params, dataset, i):
        own.append(render_j(params, dataset, i))
        return panos[len(own) - 1]

    port._render_full_frame, tj._render_full_frame = port_render, jax_render
    return panos, own


def _keeping(meter):
    """The JAX meter, keeping its last measurement when the trainer clears it."""
    clear = meter.clear

    def keep():
        if meter.N:
            meter.kept = meter.measure()
        clear()

    meter.clear = keep
    return meter


def _trained(data, opt, epochs=2):
    t = _trainer(opt, depth_metrics=_meters(opt))
    t.train(NeRFMVLDataset(**_kw(data, "train")), None, max_epochs=epochs)
    return t


def test_evaluate_one_epoch_on_mvl_matches_jax(data, tmp_path):
    """The MVL evaluation branch (the crop of the unmasked rectangle, the
    masked raydrop, the DepthMeter on the crop, the PointsMeter on the whole
    masked pano) against the JAX Trainer's, both fed the port's panos of the
    EMA weights: numpy meters bit-equal, the Chamfer distance within its
    rounding bound. The JAX renders of the same weights agree with those
    panos to the render tolerance."""
    opt, opt_j = _opts(data)
    port = _trained(data, opt)
    meters_j = [_keeping(m) for m in _meters(opt_j, port=False)]
    tj = _jax_trainer(opt_j, tmp_path, port, depth_metrics=meters_j)
    panos, own = _same_panos(port, tj)
    crops = []
    update = port.depth_metrics[2].update
    port.depth_metrics[2].update = lambda p, g: (crops.append(p.shape), update(p, g))
    port.evaluate(NeRFMVLDataset(**_kw(data, "val")))
    tj.evaluate(NeRFMVLDatasetJ(**_kw(data, "val")))
    got = port.run_log[-1]["meters"]
    assert len(panos) == len(own) == 2 and port.run_log[-1]["frames"] == 2
    gt = NeRFMVLDataset(**_kw(data, "val")).images_lidar
    for i, shape in enumerate(crops):  # the crop: the unmasked rectangle
        ys, xs = np.nonzero(gt[i, ..., 0] != -1)
        assert shape == (1, np.ptp(ys) + 1, np.ptp(xs) + 1) and shape[1] * shape[2] < H * W
    for name in ("MAEMeter", "RMSEMeter", "DepthMeter"):
        np.testing.assert_array_equal(got[name], next(
            m.kept for m in meters_j if type(m).__name__ == name), err_msg=name)
    # each frame's Chamfer distance within CHAMFER_ULPS eps (|a|^2 + max |b|^2)
    # per direction: 4 r^2 bounds both, r the farthest point of either cloud
    r = max(np.abs(p[2]).max() for p in panos + own) / SCALE
    bound = CHAMFER_ULPS * EPS32 * 4 * max(r, np.abs(gt[..., 2]).max() / SCALE) ** 2
    np.testing.assert_allclose(got["PointsMeter"][0], meters_j[3].kept[0], rtol=0, atol=bound)
    assert got["PointsMeter"][1] == meters_j[3].kept[1]
    for a, b in zip(panos, own):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **RENDER_TOL)


def test_test_clouds_on_mvl_match_jax(data, tmp_path):
    """Trainer.test on NeRF-MVL: each cloud cropped to its frame's OBB,
    bit-equal to the JAX Trainer's from the same panos; the JAX renders of
    the same raw weights agree with those panos to the render tolerance,
    and every saved point lies in its frame's OBB."""
    opt, opt_j = _opts(data)
    port = _trained(data, opt)
    tj = _jax_trainer(opt_j, tmp_path / "jax", port)
    panos, own = _same_panos(port, tj)
    ds = NeRFMVLDataset(**_kw(data, "test"))
    port.test(ds, save_path=str(tmp_path / "port"), name="t", write_video=False)
    tj.test(NeRFMVLDatasetJ(**_kw(data, "test")), save_path=str(tmp_path / "jaxr"), name="t",
            write_video=False)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jaxr"))
    cropped = 0
    for i, (pano, jpano) in enumerate(zip(panos, own)):
        f = f"test_t_{i:04d}_depth_lidar.npy"
        a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jaxr" / f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        depth = pano[2] * np.where(pano[0] > 0.5, 1.0, 0.0)
        full = convert.pano_to_lidar(depth / SCALE, K_MVL)
        np.testing.assert_array_equal(a, geometry_j.filter_bbox_dataset(
            full, ds.OBB_local[i][:, :3]))
        np.testing.assert_array_equal(geometry.filter_bbox_dataset(a, ds.OBB_local[i][:, :3]), a)
        cropped += len(full) - len(a)
        for x, y in zip(pano, jpano):
            np.testing.assert_allclose(x, y, **RENDER_TOL)
    assert cropped > 0  # the crop removed points


def _mvl_argv(data, workspace, *extra):
    return [*TINY_ARGV[:2], "--path", str(data), "--workspace", str(workspace),
            *TINY_ARGV[2:], "--iters", "6", "--eval_interval", "2", "--mesh_resolution", "32",
            *extra]


def test_tiny_mvl_flow_writes_the_jax_cli_artifacts(data, tmp_path, monkeypatch):
    """`--dataloader nerf_mvl` (configs/nerf_mvl.txt) on the CPU: train ->
    evaluate (val, test) -> test -> mesh writes the JAX CLI's files, the
    validation panos and clouds and the OBB-cropped test clouds
    (tests/test_e2e_mvl.py's checks); --test_eval repeats the test meters
    bit for bit."""
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    monkeypatch.chdir(REPO)
    trainer = cli.main(_mvl_argv(data, tmp_path / "port"))
    monkeypatch.setattr(sys, "argv", ["main_lidarnerf.py", *_mvl_argv(data, tmp_path / "jax")])
    cli_j.main()
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert "log_lidar_nerf.txt" in files
    assert any(f.startswith("validation/") and f.endswith("_lidar.npy") for f in files)
    assert any(f.startswith("results/") and f.endswith("_depth_lidar.npy") for f in files)
    assert trainer.opt.dataloader == "nerf_mvl" and (trainer.opt.H_lidar, trainer.opt.W_lidar,
                                                     trainer.opt.intrinsics_lidar) == (H, W, K_MVL)
    evals = [e for e in trainer.run_log if e["event"] == "eval"]
    assert [e["epoch"] for e in evals] == [2, 2]
    for e in evals:
        assert all(np.isfinite(v).all() for v in e["meters"].values())
    again = cli.main(_mvl_argv(data, tmp_path / "port", "--test_eval"))
    test_eval = [e for e in again.run_log if e["event"] == "eval"]
    assert len(test_eval) == 1 and test_eval[0]["frames"] == 2
    for k, v in evals[1]["meters"].items():
        np.testing.assert_array_equal(test_eval[0]["meters"][k], v, err_msg=k)


def test_resume_equals_an_uninterrupted_mvl_run(data, tmp_path):
    """Epochs 1-2, then a new Trainer from the workspace trains epoch 3: its
    masked steps' losses and weights equal those of three epochs in one run."""
    opt, _ = _opts(data)
    ds = NeRFMVLDataset(**_kw(data, "train"))
    whole = _trainer(opt, tmp_path / "whole")
    whole.train(ds, None, max_epochs=3)
    first = _trainer(opt, tmp_path / "resumed")
    first.train(ds, None, max_epochs=2)
    resumed = _trainer(opt, tmp_path / "resumed")
    assert resumed.epoch == 2
    resumed.train(ds, None, max_epochs=3)
    assert resumed.stats["step_loss"] == whole.stats["step_loss"]
    assert len(whole.stats["step_loss"]) == 9 and not any(whole.stats["skipped"])
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


# ------------------------------------------------ the device-side pool draw


def test_pool_draws_are_uniform_in_range_and_repeatable():
    """positions uniform over [0, count) (a chi-square test at a fixed seed),
    never at or past the count, and the same from a generator in the same
    state; sample_pixels' masked branch maps them through the pool."""
    count, n = 37, 74000
    draw = tst.pool_draws(torch.tensor(count), n, torch.Generator().manual_seed(5))
    assert draw.dtype == torch.long and draw.min() >= 0 and draw.max() < count
    observed = np.bincount(draw.numpy(), minlength=count)
    chi2 = ((observed - n / count) ** 2 / (n / count)).sum()
    assert chi2 < 69.35  # the 99.9% quantile of chi-square with 36 degrees of freedom
    again = tst.pool_draws(torch.tensor(count), n, torch.Generator().manual_seed(5))
    assert torch.equal(draw, again)
    assert not torch.equal(draw, tst.pool_draws(torch.tensor(count), n,
                                                torch.Generator().manual_seed(6)))
    pool = torch.arange(100, 200)
    cfg = tst.TrainConfig(num_rays_lidar=500, H_lidar=H, W_lidar=W)
    inds = tst.sample_pixels(cfg, 1, True, False, pool, torch.tensor(count),
                             torch.Generator().manual_seed(5))
    assert inds.min() >= 100 and inds.max() < 100 + count


# --------------------------------------------------- the synthetic-data tool


def test_sdf_tracer_matches_the_jax_tool():
    """4096 rays of an orbit pose around the object (most hit it): depth and
    intensity within 1e-5 of tools/make_synth_mvl.py's tracer."""
    rs = np.random.RandomState(0)
    eye = synth.CENTER + np.array([-6.0, -1.0, 0.4])
    target = synth.CENTER + rs.uniform(-1, 1, (4096, 3)) * [3.0, 1.6, 1.2]
    d = (target - eye) / np.linalg.norm(target - eye, axis=1, keepdims=True)
    d, o = d.astype(np.float32), np.broadcast_to(eye, d.shape).astype(np.float32)
    depth_j, inten_j = synth_j._sdf_hits(o, d)
    depth, inten = synth.sdf_hits(torch.from_numpy(np.ascontiguousarray(o)), torch.from_numpy(d))
    assert 1000 < (depth_j > 0).sum() < 4096
    np.testing.assert_allclose(depth.numpy(), depth_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(inten.numpy(), inten_j, rtol=0, atol=1e-5)


def test_make_synth_mvl_writes_the_jax_tools_files(tmp_path, monkeypatch):
    """At a reduced pano (the module constants H, W set on both tools), the
    same OBB, poses and transforms, the same -1 rectangles, and depth and
    intensity within the tracer's 1e-5; the port's dataset reads the files."""
    for mod in (synth, synth_j):
        monkeypatch.setattr(mod, "H", 24)
        monkeypatch.setattr(mod, "W", 160)
    secs = synth.main(str(tmp_path / "port"), n_train=2, n_val=1, device="cpu")
    synth_j.main(str(tmp_path / "jax"), n_train=2, n_val=1)
    assert len(secs) == 4
    bbox = [np.load(tmp_path / k / "dataset_bbox_7k.npy", allow_pickle=True).item()
            for k in ("port", "jax")]
    np.testing.assert_array_equal(bbox[0]["car"], bbox[1]["car"])
    for split in ("train", "val", "test"):
        a, b = (json.loads((tmp_path / k / f"transforms_car_{split}.json").read_text())
                for k in ("port", "jax"))
        assert a == b
        for fr in a["frames"]:
            x, y = (np.load(tmp_path / k / fr["lidar_file_path"])["data"] for k in ("port", "jax"))
            np.testing.assert_array_equal(x[..., 2] == -1, y[..., 2] == -1)
            np.testing.assert_array_equal(x[..., 0], y[..., 0])
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)
            assert (x[..., 2] == -1).any() and (x[..., 2] > 0).any()
    ds = NeRFMVLDataset(split="train", root_path=str(tmp_path / "port"), scale=0.1)
    assert ds.images_lidar.shape == (2, 24, 160, 3)
    np.testing.assert_allclose(ds.offset, bbox[0]["car"].mean(0))
