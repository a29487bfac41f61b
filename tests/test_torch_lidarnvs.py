"""The classical baselines of the port (lidarnerf_tpu_torch/lidarnvs/) against
the JAX package's (lidarnerf_tpu/lidarnvs/ and the root lidarnvs/ CLIs), on
the CPU: frame extraction, PCGen's cp and fpa panos and its ray-drop data,
the evaluation protocol, the ray packing and embedder, the Poisson and NKSR
flows on a numpy stand-in for open3d, the i_embed check, and the three
CLIs in-process on tests/test_e2e.py's synthetic KITTI-360 drive under
LIDARNERF_PLATFORM=cpu. The host numpy paths are the same code on both
sides, so their outputs are compared exactly; each other case states its
tolerance.
"""

import pickle
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import lidarnvs.raydrop_train_poisson as jcli_poisson  # noqa: E402
import lidarnvs.run as jcli_run  # noqa: E402
from lidarnerf_tpu.dataset.convert import pano_dirs  # noqa: E402
from lidarnerf_tpu.lidarnvs import eval as jeval  # noqa: E402
from lidarnerf_tpu.lidarnvs import loader as jloader  # noqa: E402
from lidarnerf_tpu.lidarnvs import meshing as jmeshing  # noqa: E402
from lidarnerf_tpu.lidarnvs import pcgen as jpcgen  # noqa: E402
from lidarnerf_tpu.lidarnvs import raydrop_pcgen as jraydrop  # noqa: E402
from lidarnerf_tpu.lidarnvs import raydrop_unet as junet_tr  # noqa: E402
from lidarnerf_tpu_torch.lidarnvs import (  # noqa: E402
    eval as peval,
    loader as ploader,
    meshing as pmeshing,
    pcgen as ppcgen,
    raydrop_pcgen as praydrop,
    raydrop_train_pcgen as pcli_pcgen,
    raydrop_train_poisson as pcli_poisson,
    run as pcli_run,
)
from test_e2e import write_synthetic_kitti  # noqa: E402

CONFIG = str(REPO / "lidarnvs" / "configs" / "pcgen_kitti360_raydrop.txt")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread, so that the workers of a parallel
    test run do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeDataset:
    """Minimal dataset (a copy of tests/test_lidarnvs.py's): sensors along x in
    a sphere world of radius 8."""

    def __init__(self, n_frames=2, H=24, W=96):
        self.H_lidar = H
        self.W_lidar = W
        self.intrinsics_lidar = (10.0, 30.0)
        self.poses_lidar = []
        self.images_lidar = []
        dirs = pano_dirs(H, W, self.intrinsics_lidar).reshape(-1, 3)
        for i in range(n_frames):
            t = np.array([i * 0.5, 0.0, 0.0])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = t
            o = np.broadcast_to(t, dirs.shape)
            b = 2 * np.sum(o * dirs, 1)
            c = np.sum(o * o, 1) - 64.0
            disc = b * b - 4 * c
            s = np.where(disc > 0, (-b + np.sqrt(np.maximum(disc, 0))) / 2, 0.0)
            depth = np.where(s > 0, s, 0.0).reshape(H, W)
            inten = np.where(depth > 0, 0.5, 0.0)
            self.poses_lidar.append(pose)
            self.images_lidar.append(
                np.stack([np.zeros_like(depth), inten, depth], -1).astype(np.float32)
            )

    def __len__(self):
        return len(self.poses_lidar)


def _install_fake_open3d(monkeypatch, radius=8.0):
    """A numpy stand-in for the part of open3d the meshing baselines use (a
    copy of tests/test_lidarnvs.py's): PointCloud, KDTreeFlann, Poisson
    meshing, RaycastingScene; the raycaster intersects the sphere that
    FakeDataset and the synthetic drive render."""
    o3d = types.ModuleType("open3d")
    geometry = types.ModuleType("open3d.geometry")
    utility = types.ModuleType("open3d.utility")
    core = types.ModuleType("open3d.core")
    t_mod = types.ModuleType("open3d.t")
    t_geometry = types.ModuleType("open3d.t.geometry")

    class Vector3dVector:
        def __init__(self, arr):
            self.arr = np.asarray(arr, dtype=np.float64)

        def __array__(self, dtype=None, copy=None):
            return self.arr if dtype is None else self.arr.astype(dtype)

    class PointCloud:
        def __init__(self):
            self.points = None
            self.normals = None

        def estimate_normals(self):
            pts = np.asarray(self.points)
            self.normals = Vector3dVector(
                pts / (np.linalg.norm(pts, axis=1, keepdims=True) + 1e-9)
            )

    class FakeMesh:
        def __init__(self, vertices):
            self.vertices = vertices
            self.removed_mask = None

        def remove_vertices_by_mask(self, mask):
            self.removed_mask = np.asarray(mask)

    class TriangleMesh:
        def __init__(self, vertices=None, triangles=None):
            self.vertices = vertices
            self.triangles = triangles
            self.removed_mask = None

        @staticmethod
        def create_from_point_cloud_poisson(pcd, depth=8):
            pts = np.asarray(pcd.points)
            densities = np.linspace(0.0, 1.0, len(pts))
            return FakeMesh(pts), densities

    class KDTreeFlann:
        def __init__(self, pcd):
            self.pts = np.asarray(pcd.points)

        def search_knn_vector_3d(self, p, k):
            d = np.linalg.norm(self.pts - np.asarray(p), axis=1)
            idx = np.argsort(d)[:k]
            return k, idx.tolist(), (d[idx] ** 2).tolist()

    class _T:
        def __init__(self, a):
            self._a = np.asarray(a)

        def numpy(self):
            return self._a

    class Tensor:
        def __init__(self, arr):
            self.arr = np.asarray(arr)

    class RaycastingScene:
        def add_triangles(self, mesh):
            self.mesh = mesh

        def cast_rays(self, tensor):
            rays = np.asarray(tensor.arr)
            o, d = rays[:, :3], rays[:, 3:]
            b = 2 * np.sum(o * d, 1)
            c = np.sum(o * o, 1) - radius * radius
            disc = b * b - 4 * c
            t = np.where(disc > 0, (-b + np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
            t = np.where(t > 1e-6, t, np.inf)
            hitp = o + d * np.where(np.isfinite(t), t, 0.0)[:, None]
            normals = -hitp / (np.linalg.norm(hitp, axis=1, keepdims=True) + 1e-9)
            return {
                "t_hit": _T(t.astype(np.float32)),
                "primitive_normals": _T(normals.astype(np.float32)),
            }

    class TTriangleMesh:
        @staticmethod
        def from_legacy(mesh):
            return mesh

    geometry.PointCloud = PointCloud
    geometry.TriangleMesh = TriangleMesh
    geometry.KDTreeFlann = KDTreeFlann
    utility.Vector3dVector = Vector3dVector
    utility.Vector3iVector = Vector3dVector
    core.Tensor = Tensor
    t_geometry.RaycastingScene = RaycastingScene
    t_geometry.TriangleMesh = TTriangleMesh
    t_mod.geometry = t_geometry
    o3d.geometry = geometry
    o3d.utility = utility
    o3d.core = core
    o3d.t = t_mod
    monkeypatch.setitem(sys.modules, "open3d", o3d)
    return o3d


def _fake_nksr(monkeypatch, calls):
    """A stand-in nksr whose reconstructor records its device and returns a small mesh."""

    class _DualMesh:
        def __init__(self, pts):
            self.v = torch.from_numpy(pts[:8].copy())
            self.f = torch.zeros((4, 3), dtype=torch.int64)

    class _Field:
        def __init__(self, pts):
            self._pts = pts

        def extract_dual_mesh(self, mise_iter=0):
            calls["mise_iter"] = mise_iter
            return _DualMesh(self._pts)

    class _Reconstructor:
        def __init__(self, device):
            calls["device"] = str(device)

        def reconstruct(self, pts, nrm):
            assert pts.shape == nrm.shape and pts.dtype == torch.float32
            calls["n_points"] = int(pts.shape[0])
            return _Field(pts.cpu().numpy())

    nksr = types.ModuleType("nksr")
    nksr.Reconstructor = _Reconstructor
    monkeypatch.setitem(sys.modules, "nksr", nksr)


def _assert_same(a, b, path="frame"):
    """Equal dicts / lists / arrays, dtypes too."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


# ---------------------------------------------------------------- the modules


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """write_synthetic_kitti's drive (16 x 64): 4 train, 2 test frames; both
    packages' datasets of it."""
    root = tmp_path_factory.mktemp("kitti")
    write_synthetic_kitti(str(root), n_train=4, n_val=1, n_test=2)
    return root


def test_extract_dataset_frame_matches_jax(kitti):
    """Every key, dtype and value of the frame dict: the rays within 1e-6
    (the two packages' direction products), the rest exactly; on the fake
    dataset and on the synthetic drive through both packages' datasets."""
    from lidarnerf_tpu.dataset.kitti360 import KITTI360Dataset as JDS
    from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset as PDS

    kw = dict(root_path=str(kitti), sequence_id="1908", split="test", preload=False, scale=1.0)
    for jds, pds in [(FakeDataset(), FakeDataset()), (JDS(**kw), PDS(**kw))]:
        for idx in range(len(jds)):
            for rm in (True, False):
                want = jloader.extract_dataset_frame(jds, idx, rm_pano_mask=rm)
                got = ploader.extract_dataset_frame(pds, idx, rm_pano_mask=rm)
                assert got.keys() == want.keys()
                np.testing.assert_allclose(got.pop("rays"), want.pop("rays"), rtol=0, atol=1e-6)
                _assert_same(got, want)


@pytest.mark.parametrize("raycasting", ["cp", "fpa"])
def test_pcgen_panos_and_raydrop_data_equal_jax(raycasting):
    """fit -> predict_frame at every frame and generate_raydrop_data_pcgen:
    numpy on both sides, equal."""
    ds = FakeDataset()
    j, p = jpcgen.LidarNVSPCGen(raycasting), ppcgen.LidarNVSPCGen(raycasting)
    j.fit(ds)
    p.fit(ds)
    np.testing.assert_array_equal(p.points, j.points)
    for idx in range(len(ds)):
        args = (ds.intrinsics_lidar, ds.poses_lidar[idx], ds.H_lidar, ds.W_lidar)
        _assert_same(p.predict_frame(*args), j.predict_frame(*args))
    _assert_same(list(ppcgen.generate_raydrop_data_pcgen(ds, p)),
                 list(jpcgen.generate_raydrop_data_pcgen(ds, j)))
    _assert_same(ppcgen.get_direction(24, 96, (10.0, 30.0)),
                 jpcgen.get_direction(24, 96, (10.0, 30.0)))
    with pytest.raises(RuntimeError, match="ray-drop"):
        p.predict_frame_with_raydrop(*args)


def test_eval_points_and_pano_matches_jax():
    """The depth metrics and intensity MAE within 1e-6 relative, the Chamfer
    within 1e-5 relative and the F-score within 1e-6 (the two devices' Chamfer
    reductions); the shape checks raise alike."""
    rs = np.random.RandomState(0)
    H, W = 16, 64
    gt_pano = rs.uniform(0, 60, (H, W)) * (rs.rand(H, W) > 0.2)
    pd_pano = np.clip(gt_pano + rs.normal(0, 0.5, (H, W)), 0, None) * (rs.rand(H, W) > 0.1)
    gt_i, pd_i = rs.rand(H, W), rs.rand(H, W)
    gt_pts = pano_dirs(H, W, (2.0, 26.9)).reshape(-1, 3) * gt_pano.reshape(-1, 1)
    pd_pts = gt_pts[rs.rand(H * W) > 0.3] + rs.normal(0, 0.1, (1, 3))
    args = (gt_pts, pd_pts, gt_i, pd_i, gt_pano, pd_pano)
    want = jeval.eval_points_and_pano(*args)
    got = peval.eval_points_and_pano(*args, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        rtol = 1e-5 if k == "chamfer" else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-12, err_msg=k)
    bad = (np.zeros((5, 2)), np.zeros((5, 3)), np.zeros((4, 4)), np.zeros((4, 4)),
           np.zeros((4, 4)), np.zeros((4, 4)))
    for fn in (jeval.eval_points_and_pano, peval.eval_points_and_pano):
        with pytest.raises(ValueError):
            fn(*bad)


def test_pack_rays_embedder_and_cosine_scheduler_match_jax():
    """pack_rays equal (masked -1 pixels dropped, targets binarised); the
    embedder's widths equal and its values within 1e-6; the cosine schedule
    equal, with and without warm-up."""
    rs = np.random.RandomState(0)
    dirs = [rs.randn(4, 6, 3) for _ in range(2)]
    panos = [rs.rand(4, 6) * 50 for _ in range(2)]
    inten = [rs.rand(4, 6) for _ in range(2)]
    masks = [np.where(rs.rand(4, 6) > 0.7, -1.0, rs.rand(4, 6) * (rs.rand(4, 6) > 0.5))
             for _ in range(2)]
    _assert_same(praydrop.pack_rays(dirs, panos, inten, masks),
                 jraydrop.pack_rays(dirs, panos, inten, masks))
    x = rs.randn(7, 3).astype(np.float32) * 4
    for multires, dims, i in [(4, 1, 0), (10, 3, 0), (4, 3, -1)]:
        fj, dj = jraydrop.get_embedder(multires, input_dims=dims, i=i)
        fp, dp = praydrop.get_embedder(multires, input_dims=dims, i=i)
        assert dp == dj
        np.testing.assert_allclose(fp(torch.from_numpy(x[:, :dims])).numpy(),
                                   np.asarray(fj(jnp.asarray(x[:, :dims]))), rtol=0, atol=1e-6)
    for args in [(5e-3, 5e-5, 100), (1.0, 0.1, 50, 10, 0.01)]:
        _assert_same(praydrop.cosine_scheduler(*args), jraydrop.cosine_scheduler(*args))


class _ConstRaydrop:
    """Stands in for UNetRaydropTrainer.predict: keep every ray."""

    def predict(self, features):
        return np.ones(features.shape[:3], dtype=np.float32)


def test_poisson_flow_equals_jax(monkeypatch):
    """fit -> predict_frame -> predict_frame_with_raydrop ->
    generate_raydrop_data_meshing on the open3d stand-in: equal to the JAX
    package's; without a checkpoint the ray-drop prediction raises."""
    _install_fake_open3d(monkeypatch)
    ds = FakeDataset()
    j = jmeshing.LidarNVSPoisson(depth=11, min_density=0.3, k=3)
    p = pmeshing.LidarNVSPoisson(depth=11, min_density=0.3, k=3)
    j.fit(ds)
    p.fit(ds)
    _assert_same(p.mesh.removed_mask, j.mesh.removed_mask)
    args = (ds.intrinsics_lidar, ds.poses_lidar[1], ds.H_lidar, ds.W_lidar)
    _assert_same(p.predict_frame(*args), j.predict_frame(*args))
    with pytest.raises(RuntimeError, match="ray-drop"):
        p.predict_frame_with_raydrop(*args)
    j.raydrop = p.raydrop = _ConstRaydrop()
    _assert_same(p.predict_frame_with_raydrop(*args), j.predict_frame_with_raydrop(*args))
    _assert_same(pmeshing.generate_raydrop_data_meshing(ds, p),
                 jmeshing.generate_raydrop_data_meshing(ds, j))


def test_poisson_with_a_unet_checkpoint_equals_jax(monkeypatch, tmp_path):
    """A JAX UNet checkpoint behind both packages' Poisson baseline: the
    probabilities of the port's UNet (evaluation mode, on the CPU) within
    1e-5 of the JAX package's, and the masked pano and intensities equal
    wherever the probability is not within 1e-4 of the 0.5 threshold (over
    99% of the pixels)."""
    _install_fake_open3d(monkeypatch)
    jt = junet_tr.UNetRaydropTrainer(seed=4)
    jt.save_checkpoint(tmp_path / "unet.ckpt")
    ds = FakeDataset(H=16, W=32)
    j = jmeshing.LidarNVSPoisson(k=3, ckpt_path=tmp_path / "unet.ckpt")
    p = pmeshing.LidarNVSPoisson(k=3, ckpt_path=tmp_path / "unet.ckpt", device="cpu")
    j.fit(ds)
    p.fit(ds)
    args = (ds.intrinsics_lidar, ds.poses_lidar[0], ds.H_lidar, ds.W_lidar)
    feats = p._raydrop_features(p.predict_frame(*args), *args)
    prob = p.raydrop.predict(feats[None])[0]
    np.testing.assert_allclose(prob, j.raydrop.predict(feats[None])[0], atol=1e-5)
    sure = np.abs(prob - 0.5) > 1e-4
    assert sure.mean() > 0.99
    got, want = p.predict_frame_with_raydrop(*args), j.predict_frame_with_raydrop(*args)
    for k in ("pano", "intensities"):
        np.testing.assert_array_equal(got[k][sure], want[k][sure], err_msg=k)


def test_nksr_flow_equals_jax_and_follows_the_device_rule(monkeypatch):
    """The NKSR flow on the stand-ins: the reconstructor sees every point and
    extracts with mise_iter 1; the panos equal the JAX package's. Its device
    is the one asked for: "cpu" here, CUDA by default, raising with no GPU
    (the JAX package falls back to the CPU)."""
    _install_fake_open3d(monkeypatch)
    calls = {}
    _fake_nksr(monkeypatch, calls)
    ds = FakeDataset()
    p = pmeshing.LidarNVSNKSR(k=3, device="cpu")
    p.fit(ds)
    assert calls == {"device": "cpu", "n_points": len(p.points), "mise_iter": 1}
    j = jmeshing.LidarNVSNKSR(k=3)
    j.fit(ds)
    args = (ds.intrinsics_lidar, ds.poses_lidar[0], ds.H_lidar, ds.W_lidar)
    _assert_same(p.predict_frame(*args), j.predict_frame(*args))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmeshing.LidarNVSNKSR(k=3).fit(ds)


def test_meshing_without_open3d_or_nksr_raises(monkeypatch):
    """Without open3d the meshing fit raises an ImportError that names it;
    without nksr the NKSR baseline raises at construction."""
    monkeypatch.setitem(sys.modules, "open3d", None)
    monkeypatch.setitem(sys.modules, "nksr", None)
    with pytest.raises(ImportError, match="open3d"):
        pmeshing.LidarNVSPoisson().fit(FakeDataset())
    with pytest.raises(ImportError, match="nksr"):
        pmeshing.LidarNVSNKSR()


def test_a_checkpoint_trained_with_another_i_embed_fails_at_load(tmp_path):
    """LidarNVSPCGen predicts with i_embed -1 (five inputs); a checkpoint of
    either package trained with the embedding (81 inputs) fails at load with
    a message that names i_embed (the JAX package fails only at predict)."""
    pt = praydrop.RayDropTrainer(i_embed=0, basedir=str(tmp_path), expname="p", device="cpu")
    jt = jraydrop.RayDropTrainer(i_embed=0, basedir=str(tmp_path), expname="j")
    for path in (pt.save_checkpoint(1), jt.save_checkpoint(1)):
        with pytest.raises(ValueError, match="i_embed"):
            ppcgen.LidarNVSPCGen(ckpt_path=path, device="cpu")
    ok = praydrop.RayDropTrainer(i_embed=-1, basedir=str(tmp_path), expname="ok", device="cpu")
    assert ppcgen.LidarNVSPCGen(ckpt_path=ok.save_checkpoint(2), device="cpu").raydrop is not None


# ------------------------------------------------------------------- the CLIs


def _run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["run.py", *argv])
    return jcli_run.main()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_metrics(got, want):
    """Mean metrics within 1e-6 relative, but the Chamfer within 1e-4 relative
    + 1e-5: its float32 |a|^2 + |b|^2 - 2 a.b at ranges to ~11 m, summed in
    another order, rounds by up to 2 eps (|a|^2 + |b|^2) ~ 5.8e-5 a term (by
    ~1e-7 to 1e-6 here), beside distances of ~3e-3 (PCGen) and ~1e-6
    (Poisson on the stand-in's exact sphere)."""
    assert got.keys() == want.keys()
    for k in want:
        rtol, atol = (1e-4, 1e-5) if k == "chamfer" else (1e-6, 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("raycasting", ["cp", "fpa"])
def test_run_pcgen_cli_equals_jax(kitti, tmp_path, monkeypatch, raycasting):
    """`run --method pcgen` on the synthetic drive: the evaluation's mean
    metrics equal the JAX CLI's; the collect mode writes the same pickles;
    a ray-drop MLP trained by the port's `raydrop_train_pcgen` with the
    repo's config (20 iterations) loads into the JAX trainer and predicts
    what it predicts in the port (5e-6), and `run --ckpt_path` with it gives
    the same mean metrics in both packages."""
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    base = ["--method", "pcgen", "--raycasting", raycasting, "--path", str(kitti)]
    _same_metrics(pcli_run.main(base), _run_jax(monkeypatch, base))

    for pkg, fn in (("port", pcli_run.main), ("jax", lambda a: _run_jax(monkeypatch, a))):
        assert fn([*base, "--enable_collect_raydrop_dataset",
                   "--raydrop_data_dir", str(tmp_path / pkg)]) is None
    data = tmp_path / "port" / "pcgen" / "kitti360_1908"
    for split in ("train", "test"):
        _assert_same(_load(data / f"{split}_data.pkl"),
                     _load(tmp_path / "jax" / "pcgen" / "kitti360_1908" / f"{split}_data.pkl"))

    trainer = pcli_pcgen.main(["--config", CONFIG, "--datadir", str(data), "--basedir",
                               str(tmp_path / "log"), "--N_iters", "20", "--N_rand", "256",
                               "--i_print", "10"])
    ckpt = tmp_path / "log" / "raysdrop" / "000020.ckpt"
    assert ckpt.exists() and trainer.count == 20 and trainer.input_ch == 5
    jt = jraydrop.RayDropTrainer(i_embed=-1)
    assert jt.load_checkpoint(ckpt) == 20
    rays = praydrop.pack_rays(*_load(data / "test_data.pkl"))[:, :5]
    np.testing.assert_allclose(trainer.predict(rays), jt.predict(rays), atol=5e-6)
    with_ckpt = [*base, "--ckpt_path", str(ckpt)]
    _same_metrics(pcli_run.main(with_ckpt), _run_jax(monkeypatch, with_ckpt))


def test_run_poisson_cli_and_the_unet_trainer_cli(kitti, tmp_path, monkeypatch):
    """`run --method poisson` on the open3d stand-in: the mean metrics and the
    collected pickles equal the JAX CLI's; `raydrop_train_poisson` trains a
    UNet on them (batch 2, 1 epoch; `--amp` and `--scale` accepted, unused),
    its checkpoint loads into the JAX trainer, which predicts what the port
    predicts (1e-5), `--load` resumes from it, and `--classes 2` exits."""
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    _install_fake_open3d(monkeypatch)
    base = ["--method", "poisson", "--path", str(kitti)]
    _same_metrics(pcli_run.main(base), _run_jax(monkeypatch, base))
    for pkg, fn in (("port", pcli_run.main), ("jax", lambda a: _run_jax(monkeypatch, a))):
        fn([*base, "--enable_collect_raydrop_dataset", "--raydrop_data_dir", str(tmp_path / pkg)])
    data = tmp_path / "port" / "poisson" / "kitti360_1908"
    for split in ("train", "test"):
        _assert_same(_load(data / f"{split}_data.pkl"),
                     _load(tmp_path / "jax" / "poisson" / "kitti360_1908" / f"{split}_data.pkl"))

    argv = ["--data_dir", str(data), "--ckpt_dir", str(tmp_path / "ckpt"), "--epochs", "1",
            "--batch-size", "2", "--learning-rate", "1e-4", "--amp", "--scale", "0.3"]
    hist = pcli_poisson.main(argv)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    ckpt = tmp_path / "ckpt" / "checkpoint_epoch1.ckpt"
    images, _ = junet_tr.RaydropDataset.collate(_load(data / "test_data.pkl"))
    jt = junet_tr.UNetRaydropTrainer()
    jt.load_checkpoint(ckpt)
    from lidarnerf_tpu_torch.lidarnvs.raydrop_unet import UNetRaydropTrainer

    pt = UNetRaydropTrainer(device="cpu")
    pt.load_checkpoint(ckpt)
    np.testing.assert_allclose(pt.predict(images), jt.predict(images), atol=1e-5)
    assert pcli_poisson.main([*argv[:2], "--ckpt_dir", str(tmp_path / "ckpt2"), "--epochs", "1",
                              "--load", str(ckpt)])
    assert (tmp_path / "ckpt2" / "checkpoint_epoch1.ckpt").exists()
    with pytest.raises(SystemExit):
        pcli_poisson.main([*argv, "--classes", "2"])
    assert vars(pcli_poisson.get_args(argv)) == vars(_jax_poisson_args(monkeypatch, argv))


def _jax_poisson_args(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["raydrop_train_poisson.py", *argv])
    return jcli_poisson.get_args()


def test_cli_parsers_match_the_jax_clis(monkeypatch):
    """The three parsers give the JAX CLIs' namespaces: defaults, the repo's
    two ray-drop configs, and flags."""
    import lidarnvs.raydrop_train_pcgen as jcli_pcgen

    for argv in ([], ["--method", "nksr", "--offset", "1", "2", "3", "--dataset", "nerf_mvl",
                      "--sequence_id", "car", "--enable_collect_raydrop_dataset"]):
        assert vars(pcli_run.build_parser().parse_args(argv)) == vars(
            jcli_run.build_parser().parse_args(argv))
    monkeypatch.chdir(REPO)
    for argv in ([], ["--config", "lidarnvs/configs/pcgen_kitti360_raydrop.txt"],
                 ["--config", "lidarnvs/configs/pcgen_nerfmvl_raydrop.txt", "--cosLR",
                  "--N_iters", "7"]):
        assert vars(pcli_pcgen.build_parser().parse_args(argv)) == vars(
            jcli_pcgen.build_parser().parse_args(argv))
    assert vars(pcli_poisson.get_args([])) == vars(_jax_poisson_args(monkeypatch, []))


def test_run_cli_needs_a_gpu_unless_told_cpu_and_open3d_for_poisson(kitti, monkeypatch):
    """Without LIDARNERF_PLATFORM=cpu the CLIs need a GPU and raise without
    one; `--method poisson` without open3d raises its ImportError."""
    monkeypatch.delenv("LIDARNERF_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--method", "pcgen", "--path", str(kitti)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli_run.main(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli_pcgen.main(["--datadir", str(kitti)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli_poisson.main(["--data_dir", str(kitti)])
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    monkeypatch.setitem(sys.modules, "open3d", None)
    with pytest.raises(ImportError, match="open3d"):
        pcli_run.main(["--method", "poisson", "--path", str(kitti)])


def test_plot_poisson_grid_search(tmp_path):
    """The plot script's copy writes its heatmap where matplotlib exists, and
    imports matplotlib only inside plot()."""
    import json

    from lidarnerf_tpu_torch.lidarnvs import plot_poisson_grid_search as plot_mod

    assert "matplotlib" not in vars(plot_mod)
    rows = [{"poisson_depth": d, "poisson_min_density": m, "chamfer": d * m}
            for d in (9, 10, 11) for m in (0.1, 0.3)]
    (tmp_path / "g.json").write_text(json.dumps(rows))
    pytest.importorskip("matplotlib")
    plot_mod.plot(str(tmp_path / "g.json"), str(tmp_path / "g.png"))
    assert (tmp_path / "g.png").stat().st_size > 0


_IMPORT_ALL = """
import importlib, pkgutil, sys
import lidarnerf_tpu_torch.lidarnvs as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m in sys.modules if m.split(".")[0] in
      ("open3d", "nksr", "matplotlib", "jax", "flax", "optax", "lidarnerf_tpu")))
"""


def test_baselines_import_no_open3d_nksr_or_matplotlib():
    """Importing every module of lidarnerf_tpu_torch.lidarnvs (the nine
    modules, the three CLIs and the plot script) imports no open3d, nksr or
    matplotlib, and nothing of JAX."""
    import os
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout.split(
                             maxsplit=1)
    assert int(out[0]) == 12
    assert out[1].strip() == "[]"
