"""Port parity for the data on-ramp's modules: lidarnerf_tpu_torch.native and
lidarnerf_tpu_torch.preprocess against lidarnerf_tpu's, and the four command
lines against preprocess/*.py.

The same seeded numpy inputs and raw trees (a KITTI-360 tree cast by
`tools/make_synth_drive.write_kitti360_raw` at a coarse azimuth step, a
nine-class NeRF-MVL tree of point clouds) go through both packages. Exact:
the range views on each route (numpy to numpy, native to native), the OBB,
`dataset_bbox_7k.npy`, the KITTI .npy files byte for byte and the MVL .npz
arrays (a zip member carries its write time, so the .npz bytes are not
compared), the loader's intrinsics, poses and points, the transforms JSON
byte for byte with and without a camera PNG, the scene constants and the
command lines' options and files. The port's native route against its
numpy route is held as tests/test_native.py holds them (allclose, with the
intensities compared where the depths agree).
"""

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import cv2

from lidarnerf_tpu import native as native_j
from lidarnerf_tpu.preprocess import kitti360_loader as loader_j
from lidarnerf_tpu.preprocess import normalize as normalize_j
from lidarnerf_tpu.preprocess import rangeview as rv_j
from lidarnerf_tpu.preprocess import to_nerf as to_nerf_j
from lidarnerf_tpu_torch import native
from lidarnerf_tpu_torch.dataset import convert
from lidarnerf_tpu_torch.preprocess import (
    PROJECT_ROOT,
    cal_centerpose_bound,
    generate_train_rangeview,
    kitti360_to_nerf,
    nerfmvl_to_nerf,
)
from lidarnerf_tpu_torch.preprocess import kitti360_loader as loader
from lidarnerf_tpu_torch.preprocess import normalize
from lidarnerf_tpu_torch.preprocess import rangeview as rv
from lidarnerf_tpu_torch.preprocess import to_nerf
from lidarnerf_tpu_torch.tools.make_synth_drive import WORLD_OFFSET, sensor_pose, write_kitti360_raw
from lidarnerf_tpu_torch.utils.image_io import png_size

REPO = Path(__file__).resolve().parent.parent
SEQ = "2013_05_28_drive_0000"
WINDOW = list(range(1908, 1972))
K_KITTI = (2.0, 26.9)


def _cli_j(name):
    """The JAX command line preprocess/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", REPO / "preprocess" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scan(seed, n=5000):
    """As tests/test_native.py's scan: ranges 2-70 m, elevations -0.4-0.03 rad."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(2, 70, n)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(-0.4, 0.03, n)
    return np.stack([d * np.cos(el) * np.cos(az), d * np.cos(el) * np.sin(az), d * np.sin(el),
                     rng.rand(n)], axis=1).astype(np.float32)


def _write_mvl_raw(root, classes, n=2, seed=0):
    """A NeRF-MVL raw tree: per class `n` [N, 4] float32 clouds (a blob
    4-8 m ahead, intensities 0-255) and lidar2world.txt (yawed poses)."""
    rng = np.random.RandomState(seed)
    for cls in classes:
        d = Path(root) / cls
        d.mkdir(parents=True)
        poses = []
        for i in range(n):
            center = np.array([rng.uniform(4, 8), rng.uniform(-1, 1), rng.uniform(-1.0, 0.0)])
            xyz = center + rng.randn(1500, 3) * [1.2, 0.6, 0.4]
            pts = np.concatenate([xyz, rng.uniform(0, 255, (1500, 1))], axis=1)
            np.save(d / f"{i}.npy", pts.astype(np.float32))
            yaw = rng.uniform(-np.pi, np.pi)
            pose = np.eye(4)
            pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
            pose[:3, 3] = rng.uniform(-5, 5, 3)
            poses.append(pose.ravel())
        np.savetxt(d / "lidar2world.txt", np.stack(poses))


@pytest.fixture(scope="module")
def kitti_raw(tmp_path_factory):
    """The 64-frame window of sequence 1908 as a raw tree (64 beams x 64
    azimuth steps a frame), with the first frame's pano in <root>/train."""
    root = tmp_path_factory.mktemp("kitti") / "KITTI-360"
    write_kitti360_raw(root, WINDOW, azimuth_steps=64)
    pts = loader.KITTI360Loader(root).load_lidar_points(SEQ, WINDOW[0])
    (root.parent / "train").mkdir()
    np.save(root.parent / "train" / f"{WINDOW[0]:010d}.npy", rv.lidar_to_rangeview_kitti(pts))
    return root


def _files(root):
    return {p.relative_to(root).as_posix(): p for p in Path(root).rglob("*") if p.is_file()}


def _assert_same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        if name.endswith(".npz"):
            x, y = np.load(fa[name]), np.load(fb[name])
            assert x.files == y.files and all(
                x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files), name
        else:
            assert fa[name].read_bytes() == fb[name].read_bytes(), name


# -- native --------------------------------------------------------------------------------


@pytest.fixture
def require_native():
    if not (native.available() and native_j.available()):
        pytest.skip(f"no C++ toolchain for the native library: {native.build_error()}")


def test_native_builds_into_the_build_directory(require_native):
    assert native.route() == "native" and native.build_error() is None
    lib = native.library_path()
    assert lib.parent == PROJECT_ROOT / "lidarnerf_tpu_torch" / "_build" and lib.is_file()
    assert "lidarnerf_tpu_torch/_build/" in (REPO / ".gitignore").read_text().split()
    # nothing is written beside the sources of the package
    src = {p.name for p in native.SOURCE.parent.iterdir()} - {"__pycache__"}
    assert src == {"__init__.py", "rangeview.cpp"}
    assert not [p for p in (PROJECT_ROOT / "lidarnerf_tpu_torch").rglob("*.so")
                if "_build" not in p.parts]


def test_failed_build_keeps_its_error_and_falls_back_to_numpy(tmp_path, monkeypatch):
    bad = tmp_path / "rangeview.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_state", {})
    assert not native.available() and native.route() == "numpy"
    assert "g++" in native.build_error() or "No such file" in native.build_error()
    with pytest.raises(RuntimeError, match="native rangeview library unavailable"):
        native.lidar_to_pano_with_intensities(_scan(0), 66, 1030, K_KITTI)
    pts = _scan(1)
    want = np.zeros((66, 1030, 3))
    want[..., 2], want[..., 1] = convert.lidar_to_pano_with_intensities(pts, 66, 1030, K_KITTI, 80.0)
    assert np.array_equal(rv.lidar_to_rangeview_kitti(pts), want)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_matches_the_numpy_projection(require_native):
    pts = _scan(0)
    pano_n, inten_n = native.lidar_to_pano_with_intensities(pts, 66, 1030, K_KITTI)
    pano_p, inten_p = convert.lidar_to_pano_with_intensities(pts, 66, 1030, K_KITTI)
    np.testing.assert_allclose(pano_n, pano_p, rtol=1e-6, atol=1e-9)
    same = pano_n == pano_p
    np.testing.assert_allclose(inten_n[same], inten_p[same], rtol=1e-6)
    pano, inten = convert.lidar_to_pano_with_intensities(_scan(1), 32, 256, (15.0, 40.0))
    got = native.pano_to_lidar_with_intensities(pano, inten, (15.0, 40.0))
    want = convert.pano_to_lidar_with_intensities(pano, inten, (15.0, 40.0))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    pano, _ = native.lidar_to_pano_with_intensities(
        np.array([[100.0, 0, 0, 1.0], [10.0, 0, 0, 0.5]], np.float32), 16, 64, (10.0, 30.0))
    assert (pano == 100.0).sum() == 0 and (pano == 10.0).sum() == 1
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        native.lidar_to_pano_with_intensities(pts[:, :3], 66, 1030, K_KITTI)


def test_native_equals_the_jax_packages_library(require_native):
    pts = _scan(2, n=20000)
    a = native.lidar_to_pano_with_intensities(pts, 66, 1030, K_KITTI)
    b = native_j.lidar_to_pano_with_intensities(pts, 66, 1030, K_KITTI)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(native.pano_to_lidar_with_intensities(*a, K_KITTI),
                          native_j.pano_to_lidar_with_intensities(*b, K_KITTI))


# -- rangeview -----------------------------------------------------------------------------


@pytest.fixture(params=["numpy", "native"])
def route(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(native_j, "available", lambda: False)
    elif not (native.available() and native_j.available()):
        pytest.skip(f"no C++ toolchain for the native library: {native.build_error()}")
    return request.param


def test_rangeview_kitti_matches_jax(route, tmp_path):
    assert native.route() == route
    pts = _scan(3, n=30000)
    got = rv.lidar_to_rangeview_kitti(pts, **rv.KITTI_RANGEVIEW)
    assert np.array_equal(got, rv_j.lidar_to_rangeview_kitti(pts, **rv_j.KITTI_RANGEVIEW))
    assert got.shape == (66, 1030, 3) and (got[..., 2] > 0).sum() > 5000
    bins = []
    for i in range(2):
        bins.append(tmp_path / f"{i:010d}.bin")
        _scan(10 + i).tofile(bins[-1])
    rv.generate_kitti_rangeviews(bins, tmp_path / "port", points_dim=4, **rv.KITTI_RANGEVIEW)
    rv_j.generate_kitti_rangeviews(bins, tmp_path / "jax", points_dim=4, **rv_j.KITTI_RANGEVIEW)
    _assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_rangeview_mvl_and_obb_match_jax():
    rng = np.random.RandomState(4)
    xy = rng.randn(500, 2) @ np.array([[2.0, 0.5], [0.0, 1.0]]) + 5
    assert np.array_equal(rv.oriented_bounding_box_xy(xy), rv_j.oriented_bounding_box_xy(xy))
    pts = _scan(5)
    pts[:, 3] *= 255
    obb = np.concatenate([rv.oriented_bounding_box_xy(pts[:, :2]), np.zeros((4, 1))], axis=1)
    obb = np.concatenate([obb + [0, 0, 1], obb - [0, 0, 2]])
    obb_local = np.concatenate([obb, np.ones((8, 1))], axis=1)
    got = rv.lidar_to_rangeview_mvl(pts, obb_local, **rv.MVL_RANGEVIEW)
    assert np.array_equal(got, rv_j.lidar_to_rangeview_mvl(pts, obb_local, **rv_j.MVL_RANGEVIEW_KW))
    assert rv.MVL_RANGEVIEW == rv_j.MVL_RANGEVIEW == rv_j.MVL_RANGEVIEW_KW
    assert rv.ALL_MVL_CLASSES == rv_j.ALL_MVL_CLASSES


def test_mvl_bbox_and_panos_match_jax(tmp_path):
    raw = tmp_path / "nerf_mvl_7k"
    _write_mvl_raw(raw, ["car", "tire"])
    for out, module in ((tmp_path / "port", rv), (tmp_path / "jax", rv_j)):
        out.mkdir()
        bbox = module.compute_dataset_bbox(["car", "tire"], raw, out)
        module.generate_mvl_rangeviews(["car", "tire"], bbox, tmp_path, out / "pano")
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    data = np.load(tmp_path / "port" / "pano" / "car" / "0000000000.npz")["data"]
    assert data.shape == (256, 1800, 3) and (data[..., 2] > 0).sum() > 100
    assert (data[..., 2] == -1).mean() > 0.5  # -1 outside the projected OBB


# -- the KITTI-360 loader -----------------------------------------------------------------


def test_kitti360_loader_matches_jax(kitti_raw):
    port, jax_ = loader.KITTI360Loader(kitti_raw), loader_j.KITTI360Loader(kitti_raw)
    ids = WINDOW[::7]
    for a, b in zip(port.load_cameras("cam_00", SEQ, ids), jax_.load_cameras("cam_00", SEQ, ids)):
        assert np.array_equal(a, b)
    velo = port.load_lidars(SEQ, ids)
    assert np.array_equal(velo, jax_.load_lidars(SEQ, ids))
    for fid in ids[:3]:
        assert np.array_equal(port.load_lidar_points(SEQ, fid), jax_.load_lidar_points(SEQ, fid))
    assert port.get_image_paths("cam_00", SEQ, ids) == jax_.get_image_paths("cam_00", SEQ, ids)
    p = kitti_raw / "calibration" / "perspective.txt"
    for a, b in zip(loader.load_perspective_intrinsics(p).values(),
                    loader_j.load_perspective_intrinsics(p).values()):
        assert np.array_equal(a, b)
    # the raw writer's scans sit at the poses it meant: the drive plus the world offset
    for k, fid in enumerate(ids):
        want = sensor_pose(WINDOW.index(fid), 1.0)
        want[:3, 3] += WORLD_OFFSET
        np.testing.assert_allclose(velo[k], want, atol=1e-9)


def test_read_variable_matches_jax(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("foo: 1 2 3 4 5 6\nbar: 9 9\n")
    assert np.array_equal(loader._read_variable(p, "foo", 2, 3), loader_j._read_variable(p, "foo", 2, 3))
    assert loader._read_variable(p, "baz", 1, 1) is None
    for module in (loader, loader_j):
        with pytest.raises(AssertionError):
            module._read_variable(p, "bar", 1, 3)


def test_corrupted_cam0_to_world_raises_in_both(kitti_raw, tmp_path):
    root = tmp_path / "KITTI-360"
    shutil.copytree(kitti_raw, root)
    gt = root / "data_poses" / f"{SEQ}_sync" / "cam0_to_world.txt"
    rows = np.loadtxt(gt)
    rows[5, 4] += 0.1  # frame 1913's x translation, 10 cm off (the check allows ~1 cm at 1 km)
    np.savetxt(gt, rows)
    for module in (loader, loader_j):
        with pytest.raises(AssertionError):
            module.KITTI360Loader(root).load_cameras("cam_00", SEQ, WINDOW[:2])
    (root / "data_poses" / f"{SEQ}_sync" / "poses.txt").unlink()
    shutil.rmtree(root / "data_3d_raw")
    for module in (loader, loader_j):
        with pytest.raises(FileNotFoundError):
            module.KITTI360Loader(root)


# -- transforms writers -------------------------------------------------------------------


@pytest.mark.parametrize("image", ["written", "none", "cv2_png", "not_png"])
def test_kitti360_transforms_match_jax(kitti_raw, tmp_path, image):
    root = tmp_path / "KITTI-360"
    shutil.copytree(kitti_raw, root)
    shutil.copytree(kitti_raw.parent / "train", tmp_path / "train")
    png = root / "data_2d_raw" / f"{SEQ}_sync" / "image_00" / "data_rect" / f"{WINDOW[0]:010d}.png"
    if image == "none":
        png.unlink()
    elif image == "cv2_png":
        cv2.imwrite(str(png), np.random.RandomState(0).randint(0, 255, (40, 90, 3), np.uint8))
    elif image == "not_png":
        png.write_bytes(b"not an image at all, not even 24 bytes long?")
    want_hw = {"written": (376, 1408), "none": None, "cv2_png": (40, 90), "not_png": None}[image]
    assert png_size(png) == want_hw
    outputs = {}
    for name, module in (("port", to_nerf), ("jax", to_nerf_j)):
        module.write_kitti360_transforms(root, tmp_path, sequence_id="1908", sequence_name=SEQ)
        outputs[name] = {s: (tmp_path / f"transforms_1908_{s}.json").read_bytes()
                         for s in ("train", "val", "test")}
    assert outputs["port"] == outputs["jax"]
    meta = json.loads(outputs["port"]["train"])
    assert (meta["h"], meta["w"]) == (want_hw or (376, 1408))
    assert (meta["h_lidar"], meta["w_lidar"]) == (66, 1030) and len(meta["frames"]) == 60
    assert to_nerf.KITTI_SEQUENCES == to_nerf_j.KITTI_SEQUENCES
    assert to_nerf.MVL_TRAIN_SPLIT == to_nerf_j.MVL_TRAIN_SPLIT


def test_nerfmvl_transforms_match_jax(tmp_path):
    pano_root = tmp_path / "nerf_mvl_7k_pano"
    for cls, n in (("car", 7), ("tire", 45)):
        (pano_root / cls).mkdir(parents=True)
        np.savetxt(pano_root / cls / "lidar2world.txt",
                   np.random.RandomState(n).randn(n, 16))
        for i in range(n):
            np.savez_compressed(pano_root / cls / f"{i:010d}.npz", data=np.zeros((8, 16, 3)))
    outputs = {}
    for name, module in (("port", to_nerf), ("jax", to_nerf_j)):
        module.write_nerfmvl_transforms(tmp_path, classes=["car", "tire"])
        outputs[name] = {p.name: p.read_bytes() for p in tmp_path.glob("transforms_*.json")}
    assert len(outputs["port"]) == 6 and outputs["port"] == outputs["jax"]
    poses = np.loadtxt(pano_root / "car" / "lidar2world.txt").reshape(-1, 4, 4)
    assert np.array_equal(to_nerf.NeRFMVLLoader(pano_root, "car").load_lidars([1, 3]),
                          poses[[1, 3]])
    with pytest.raises(FileNotFoundError):
        to_nerf.NeRFMVLLoader(pano_root, "pier")


# -- scene constants ----------------------------------------------------------------------


def test_scene_constants_match_jax(tmp_path):
    frames, paths = [], []
    for i in range(3):
        paths.append(tmp_path / "train" / f"{i}.npy")
        paths[-1].parent.mkdir(exist_ok=True)
        np.save(paths[-1], rv.lidar_to_rangeview_kitti(_scan(20 + i)))
        pose = sensor_pose(i)
        pose[:3, 3] += WORLD_OFFSET
        frames.append({"lidar_file_path": f"train/{i}.npy", "lidar2world": pose.tolist()})
    (tmp_path / "transforms_1908_train.json").write_text(json.dumps({"frames": frames}))
    got_paths, got_poses = normalize.get_path_pose_from_json(str(tmp_path), "1908")
    want_paths, want_poses = normalize_j.get_path_pose_from_json(str(tmp_path), "1908")
    assert got_paths == want_paths and all(
        a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got_poses, want_poses))
    got = normalize.cal_centerpose_bound_scale(got_paths, got_poses, K_KITTI)
    want = normalize_j.cal_centerpose_bound_scale(want_paths, want_poses, K_KITTI)
    assert got == want
    centerpose, scale, near, far = got
    assert 0 < scale < 1 and 2 <= near < far <= 70


# -- the command lines --------------------------------------------------------------------


class _Stop(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser that `main()` builds (its parse_args is stopped)."""
    got = []

    def grab(self, *args, **kwargs):
        got.append(self)
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        m.setattr(sys, "argv", ["prog"])
        with pytest.raises(_Stop):
            main()
    return got[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs, a.required,
                     a.help) for a in parser._actions}


@pytest.mark.parametrize("name", ["generate_train_rangeview", "kitti360_to_nerf",
                                  "nerfmvl_to_nerf", "cal_centerpose_bound"])
def test_cli_parser_has_the_jax_options(name, monkeypatch):
    port = {"generate_train_rangeview": generate_train_rangeview, "kitti360_to_nerf": kitti360_to_nerf,
            "nerfmvl_to_nerf": nerfmvl_to_nerf, "cal_centerpose_bound": cal_centerpose_bound}[name]
    assert _options(port.get_arg_parser()) == _options(_parser_of(_cli_j(name).main, monkeypatch))


def test_default_project_root_is_the_jax_scripts():
    jax_root = Path(_cli_j("generate_train_rangeview").__file__).resolve().parent.parent
    assert PROJECT_ROOT == jax_root == REPO


def test_cli_runs_on_a_project_root_write_the_jax_files(kitti_raw, tmp_path, monkeypatch):
    """generate_train_rangeview (kitti360 over frames 1908-1911; nerf_mvl over
    all nine classes) and kitti360_to_nerf on tmp project roots, port and
    JAX, write the same files."""
    jax_gen, jax_k2n = _cli_j("generate_train_rangeview"), _cli_j("kitti360_to_nerf")
    for side in ("port", "jax"):
        data = tmp_path / side / "data"
        shutil.copytree(kitti_raw, data / "kitti360" / "KITTI-360")
        _write_mvl_raw(data / "nerf_mvl" / "nerf_mvl_7k", rv.ALL_MVL_CLASSES)
    for side, gen in (("port", generate_train_rangeview), ("jax", jax_gen)):
        gen.create_kitti_rangeview(project_root=tmp_path / side, s_frame_id=1908, e_frame_id=1911)
        gen.create_nerf_mvl_rangeview(project_root=tmp_path / side)
    # the transforms read the window's first pano only
    monkeypatch.setattr(kitti360_to_nerf, "PROJECT_ROOT", tmp_path / "port")
    kitti360_to_nerf.main([])
    monkeypatch.setattr(jax_k2n, "__file__", str(tmp_path / "jax" / "preprocess" / "x.py"))
    monkeypatch.setattr(sys, "argv", ["kitti360_to_nerf.py"])
    jax_k2n.main()
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port" / "data" / "nerf_mvl" / "nerf_mvl_7k_pano").glob("*/*.npz"))) == 18


def test_cal_centerpose_bound_prints_the_jax_lines(tmp_path, monkeypatch, capsys):
    frames = []
    for i in range(2):
        np.save(tmp_path / f"{i}.npy", rv.lidar_to_rangeview_kitti(_scan(30 + i)))
        frames.append({"lidar_file_path": f"{i}.npy", "lidar2world": sensor_pose(i).tolist()})
    (tmp_path / "transforms_1728_train.json").write_text(json.dumps({"frames": frames}))
    argv = ["--root_path", str(tmp_path), "--sequence_id", "1728", "--fov", "26.9"]
    cal_centerpose_bound.main(argv)
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["cal_centerpose_bound.py", *argv])
    _cli_j("cal_centerpose_bound").main()
    assert port == capsys.readouterr().out and port.count("\n") == 3


def test_nerfmvl_to_nerf_cli_writes_the_jax_files(tmp_path, monkeypatch):
    for side in ("port", "jax"):
        cls = tmp_path / side / "nerf_mvl_7k_pano" / "car"
        cls.mkdir(parents=True)
        np.savetxt(cls / "lidar2world.txt", np.tile(np.eye(4).ravel(), (4, 1)))
        for i in range(4):
            np.savez_compressed(cls / f"{i:010d}.npz", data=np.zeros((8, 16, 3)))
    nerfmvl_to_nerf.main(["--path", str(tmp_path / "port"), "--classes", "car"])
    monkeypatch.setattr(sys, "argv", ["nerfmvl_to_nerf.py", "--path", str(tmp_path / "jax"),
                                      "--classes", "car"])
    _cli_j("nerfmvl_to_nerf").main()
    _assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_nerf_mvl_rangeview_of_one_class_matches_jax(tmp_path):
    """The bbox and panos of a tree of one class, as chip_smoke.py makes
    them with the port's compute_dataset_bbox and generate_mvl_rangeviews,
    equal the JAX functions' files."""
    for side, module in (("port", rv), ("jax", rv_j)):
        parent = tmp_path / side / "nerf_mvl"
        _write_mvl_raw(parent / "nerf_mvl_7k", ["car"], n=3)
        bbox = module.compute_dataset_bbox(["car"], parent / "nerf_mvl_7k", parent)
        module.generate_mvl_rangeviews(["car"], bbox, parent, parent / "nerf_mvl_7k_pano")
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
