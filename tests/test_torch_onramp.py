"""Port parity for the on-ramp's tools: lidarnerf_tpu_torch.tools.check_dataset
against tools/check_dataset.py, and lidarnerf_tpu_torch.tools.make_synth_drive
against tools/make_synth_drive.py and the committed data_synth_drive60/.

The checks run on tests/test_check_dataset.py's synthetic raw tree (the
sequence 1908 window, six frames of sphere-shell scans). Stages 1-4 of the
two checks write the same panos and JSON byte for byte, and hand stage 5 the
same command line (each package's CLI replaced by a recorder); the full
check, whose stage 5 trains through the port's CLI on the CPU, is marked
slow as its JAX twin is (it renders two 66 x 1030 panos: ~100 s on
the CPU alone).
"""

import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import make_synth_drive as synth_j  # noqa: E402
from check_dataset import check_dataset as check_dataset_j  # noqa: E402
from check_dataset import main as check_main_j  # noqa: E402
from lidarnerf_tpu_torch import main_lidarnerf as cli  # noqa: E402
from lidarnerf_tpu_torch.preprocess.kitti360_loader import KITTI360Loader  # noqa: E402
from lidarnerf_tpu_torch.preprocess.rangeview import lidar_to_rangeview_kitti  # noqa: E402
from lidarnerf_tpu_torch.tools import check_dataset as check  # noqa: E402
from lidarnerf_tpu_torch.tools import make_synth_drive as synth  # noqa: E402
from test_check_dataset import SEQ, _write_fake_kitti_tree  # noqa: E402
from test_torch_preprocess import _files, _options, _parser_of  # noqa: E402


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw") / "KITTI-360"
    _write_fake_kitti_tree(root)
    return root


def _recorder(calls, argv_of):
    """A stand-in for a CLI's main: records its command line and writes the
    workspace log that stage 5 looks for."""
    def main(*args):
        argv = argv_of(*args)
        calls.append(argv)
        ws = argv[argv.index("--workspace") + 1]
        os.makedirs(ws, exist_ok=True)
        Path(ws, "log_lidar_nerf.txt").write_text("recorded\n")
        return SimpleNamespace(argv=argv)
    return main


def test_check_dataset_catches_broken_calibration(tmp_path):
    """A truncated tree must fail loudly at stage 1, not crash later."""
    root = tmp_path / "KITTI-360"
    (root / "calibration").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        check.check_dataset(str(root), str(tmp_path / "out"), sequence_id=SEQ)


def test_check_dataset_stages_1_to_4_match_jax(raw_tree, tmp_path, monkeypatch):
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(cli, "main", _recorder(calls["port"], lambda argv: list(argv)))
    monkeypatch.setitem(sys.modules, "main_lidarnerf",
                        SimpleNamespace(main=_recorder(calls["jax"], lambda: sys.argv[1:])))
    got = check.check_dataset(str(raw_tree), str(tmp_path / "port"), sequence_id=SEQ,
                              max_frames=2, train_steps=4, workspace=str(tmp_path / "ws"))
    want = check_dataset_j(str(raw_tree), str(tmp_path / "jax"), sequence_id=SEQ,
                           max_frames=2, train_steps=4, workspace=str(tmp_path / "ws"))
    assert {k: got[k] for k in want} == want
    # the same command line but for --path, each check's out_dir
    port_argv = [str(tmp_path / "jax") if a == str(tmp_path / "port") else a for a in calls["port"][0]]
    assert [port_argv] == calls["jax"] and len(calls["port"]) == 1
    assert calls["port"][0][:2] == ["--config", str(REPO / "configs" / "kitti360_1908.txt")]
    assert got["trainer"].argv == calls["port"][0] and set(got["seconds"]) == {1, 2, 3, 4, 5}
    fa, fb = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(fa) == sorted(fb) and len([f for f in fa if f.endswith(".npy")]) == 6
    assert all(fa[f].read_bytes() == fb[f].read_bytes() for f in fa)


def test_check_dataset_command_line_matches_jax(raw_tree, tmp_path, monkeypatch, capsys):
    assert _options(_parser_of(check.main, monkeypatch)) == _options(_parser_of(check_main_j, monkeypatch))
    # a failing check exits 1 with the FAILED line, as the JAX tool does
    broken = tmp_path / "broken"
    (broken / "calibration").mkdir(parents=True)
    argv = ["--kitti360_root", str(broken), "--out_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as port:
        check.main(argv)
    monkeypatch.setattr(sys, "argv", ["check_dataset.py", *argv])
    with pytest.raises(SystemExit) as jax_:
        check_main_j()
    assert port.value.code == jax_.value.code == 1
    assert capsys.readouterr().out.count("[check] FAILED") == 2


@pytest.mark.slow
def test_check_dataset_end_to_end_on_cpu(raw_tree, tmp_path, monkeypatch):
    """The whole check, stage 5 through the port's CLI on the CPU: the panos
    and JSON equal what the JAX check's stages 1-4 write; the workspace log,
    the test results and the mesh are written."""
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    monkeypatch.setitem(sys.modules, "main_lidarnerf",
                        SimpleNamespace(main=_recorder([], lambda: sys.argv[1:])))
    check_dataset_j(str(raw_tree), str(tmp_path / "jax"), sequence_id=SEQ, max_frames=2,
                    train_steps=4, workspace=str(tmp_path / "jax_ws"))
    res = check.check_dataset(str(raw_tree), str(tmp_path / "port"), sequence_id=SEQ,
                              max_frames=2, train_steps=4, workspace=str(tmp_path / "ws"))
    fa, fb = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(fa) == sorted(fb) and all(fa[f].read_bytes() == fb[f].read_bytes() for f in fa)
    trainer = res["trainer"]
    assert trainer.global_step == 4 and np.isfinite(trainer.stats["step_loss"]).all()
    ws = _files(tmp_path / "ws")
    assert "log_lidar_nerf.txt" in ws and "meshes/lidar_nerf_2.ply" in ws
    assert any(f.startswith("results/test_") and f.endswith("_depth_lidar.npy") for f in ws)
    assert 3.0 < res["near"] < res["far"] <= 45.0


def test_make_synth_drive_writes_the_jax_tools_files(tmp_path):
    synth.main(str(tmp_path / "port"), n_train=2, n_val=1)
    synth_j.main(str(tmp_path / "jax"), n_train=2, n_val=1)
    fa, fb = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(fa) == sorted(fb) and len(fa) == 4 + 4
    assert all(fa[f].read_bytes() == fb[f].read_bytes() for f in fa)
    # the draws are per frame in order, so the first frames are the committed dataset's
    for f in ("frame_0000.npy", "frame_0001.npy"):
        assert fa[f].read_bytes() == (REPO / "data_synth_drive60" / f).read_bytes()


def test_write_kitti360_raw_casts_hdl64_sized_scans(tmp_path):
    counts = synth.write_kitti360_raw(tmp_path / "KITTI-360", [1908, 1909])
    assert all(110_000 < n <= 64 * synth.HDL64_AZIMUTH_STEPS for n in counts)
    k3 = KITTI360Loader(tmp_path / "KITTI-360")
    Ks, _ = k3.load_cameras("cam_00", "2013_05_28_drive_0000", [1908, 1909])  # the cross-check
    assert Ks[0][0, 0] == pytest.approx(552.554261)
    pts = k3.load_lidar_points("2013_05_28_drive_0000", 1909)
    assert pts.shape == (counts[1], 4) and 0 <= pts[:, 3].min() and pts[:, 3].max() <= 1
    pano = lidar_to_rangeview_kitti(pts)
    assert (pano[..., 2] > 0).mean() > 0.8  # a drive's pano: 64 beams over 66 rows, few misses
    # every beam lands on a row of the 66-row pano (none beyond its +2 / -24.9 degrees)
    rows = np.unique(np.nonzero(pano[..., 2] > 0)[0])
    assert len(synth.HDL64_ELEVATIONS) == 64 and rows[0] == 0 and rows[-1] == 65
    assert len(rows) >= 58
