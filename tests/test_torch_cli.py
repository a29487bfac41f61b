"""The port's CLI, `python -m lidarnerf_tpu_torch.main_lidarnerf`, against the
JAX package's `main_lidarnerf.py`: the same parser, the same flow and
artifacts on the tiny flow of tests/test_e2e.py under
LIDARNERF_PLATFORM=cpu, `--test_eval` reproducing the in-train meters bit
for bit (the EMA weights of the latest checkpoint, a deterministic render),
every `--encoding` through the same flow, and the flags whose paths are
not ported raising with their ROADMAP item.
"""

import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import main_lidarnerf as cli_j  # noqa: E402
from lidarnerf_tpu_torch import main_lidarnerf as cli  # noqa: E402
from test_e2e import write_synthetic_kitti  # noqa: E402

# the argv of tests/test_e2e.py's flows, after "--path DATA --workspace WS"
E2E_ARGV = {
    "tiny": ["--iters", "4", "--num_steps", "16", "--upsample_steps", "4",
             "--num_rays_lidar", "128", "--desired_resolution", "64", "--log2_hashmap_size",
             "10", "--eval_interval", "2", "--max_ray_batch", "512", "--mesh_resolution", "32",
             "--scale", "0.05", "--offset", "0", "0", "0"],
    "perstep-seam": ["--iters", "2", "--num_steps", "16", "--upsample_steps", "4",
                     "--num_rays_lidar", "128", "--desired_resolution", "64",
                     "--log2_hashmap_size", "10", "--eval_interval", "1000", "--max_ray_batch",
                     "512", "--mesh_resolution", "16", "--scale", "0.05", "--offset", "0", "0",
                     "0", "--seam_tie", "1", "--seam_sync_hashed", "8"],
    "full": ["--iters", "40", "--num_steps", "32", "--upsample_steps", "8",
             "--num_rays_lidar", "256", "--desired_resolution", "128", "--log2_hashmap_size",
             "12", "--eval_interval", "10", "--max_ray_batch", "256", "--scale", "0.05",
             "--offset", "0", "0", "0"],
}
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(str(REPO / "configs" / "*.txt")))


def _argv(data, workspace, flow="tiny", *extra):
    return ["--config", str(REPO / "configs" / "kitti360_1908.txt"), "--path", str(data),
            "--workspace", str(workspace), *E2E_ARGV[flow], *extra]


@pytest.mark.parametrize("argv", [
    *[["--config", f"configs/{c}"] for c in CONFIGS],
    *[["--config", "configs/kitti360_1908.txt", "--path", "d", "--workspace", "w", *a]
      for a in E2E_ARGV.values()],
    ["--config", "configs/kitti360_1908.txt", "-L", "--fast", "--test_eval", "--ckpt", "best",
     "--change_patch_size_lidar", "4", "16", "--profile", "--fuse_epoch", "0"],
], ids=[*CONFIGS, *[f"e2e-{k}" for k in E2E_ARGV], "flags"])
def test_parser_matches_the_jax_cli(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    assert vars(cli.get_arg_parser().parse_args(argv)) == vars(
        cli_j.get_arg_parser().parse_args(argv))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread, so that the workers of a parallel
    test run do not oversubscribe the cores (every comparison in this file is
    between runs made under this one setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_synthetic_kitti(str(root), n_train=2, n_val=1, n_test=1)
    return root


def _files(workspace):
    """The workspace's files, relative; the tensorboard event file by its directory."""
    out = set()
    for path in Path(workspace).rglob("*"):
        if path.is_file():
            rel = path.relative_to(workspace).as_posix()
            out.add(rel.rsplit("/", 1)[0] + "/<events>" if "tfevents" in rel else rel)
    return out


def test_tiny_flow_writes_the_jax_cli_artifacts(data, tmp_path, monkeypatch):
    """train -> evaluate (val, test) -> test -> mesh: the same files as the
    JAX CLI, and --test_eval on the same workspace reproduces the meters of
    the last evaluation of each split bit for bit."""
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    monkeypatch.chdir(REPO)
    trainer = cli.main(_argv(data, tmp_path / "port"))
    monkeypatch.setattr(sys, "argv", ["main_lidarnerf.py", *_argv(data, tmp_path / "jax")])
    cli_j.main()
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert {"args.txt", "log_lidar_nerf.txt", "checkpoints/lidar_nerf.ckpt",
            "checkpoints/lidar_nerf_ep0002.ckpt", "meshes/lidar_nerf_2.ply",
            "results/test_lidar_nerf_ep0002_0000_depth_lidar.npy"} <= files
    assert (tmp_path / "port" / "args.txt").read_text() == (
        tmp_path / "jax" / "args.txt").read_text().replace(str(tmp_path / "jax"),
                                                          str(tmp_path / "port"))
    log = (tmp_path / "port" / "log_lidar_nerf.txt").read_text()
    # the epochs go through make_epoch_step (eager on the CPU); the old "run
    # step by step" notice is gone
    assert "Finished Epoch 2" in log and "queue A item 1" not in log
    evals = [e for e in trainer.run_log if e["event"] == "eval"]
    assert [e["epoch"] for e in evals] == [2, 2]  # val in train, then test
    for e in evals:
        assert all(np.isfinite(v).all() for v in e["meters"].values())

    again = cli.main(_argv(data, tmp_path / "port", "tiny", "--test_eval"))
    test_eval = [e for e in again.run_log if e["event"] == "eval"]
    assert len(test_eval) == 1 and test_eval[0]["frames"] == 1
    for k, v in evals[1]["meters"].items():
        np.testing.assert_array_equal(test_eval[0]["meters"][k], v, err_msg=k)
    # the in-train evaluation of the val split, from the same weights
    again.evaluate(cli.build_dataset(again.opt, "val", "cpu"))
    for k, v in evals[0]["meters"].items():
        np.testing.assert_array_equal(again.run_log[-1]["meters"][k], v, err_msg=k)


# each encoding at the tiny flow's widths (periodic_volume: a table of 2^9 = 8^3 rows)
# and the hash grid under --fast, whose grid refresh reads the field's density
ENCODING_ARGV = {"hashgrid": [], "tiledgrid": [], "frequency": [],
                 "periodic_volume": ["--log2_hashmap_size", "9"],
                 "hashgrid-fast": ["--fast", "--occ_grid_size", "32"]}


@pytest.mark.parametrize("encoding", list(ENCODING_ARGV))
def test_every_encoding_trains_evaluates_and_tests(encoding, data, tmp_path, monkeypatch):
    """--encoding other than blockhash: train -> evaluate -> test -> mesh with
    the blockhash run's files (hashgrid: the JAX CLI's), finite losses and
    meters, the model of that encoding, and --test_eval reproducing the
    in-train meters bit for bit."""
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    monkeypatch.chdir(REPO)
    argv = ["--encoding", encoding.removesuffix("-fast"), *ENCODING_ARGV[encoding]]
    trainer = cli.main(_argv(data, tmp_path / "port", "tiny", *argv))
    assert trainer.model.encoding == encoding.removesuffix("-fast")
    assert (trainer.occ_grid is not None) == encoding.endswith("-fast")
    assert ("hash_table" in trainer.model.state_dict()) == (encoding != "frequency")
    assert len(trainer.stats["step_loss"]) == 4 and np.isfinite(trainer.stats["step_loss"]).all()
    evals = [e for e in trainer.run_log if e["event"] == "eval"]
    assert [e["epoch"] for e in evals] == [2, 2]
    for e in evals:
        assert all(np.isfinite(v).all() for v in e["meters"].values())
    if encoding == "hashgrid":
        monkeypatch.setattr(sys, "argv", ["main_lidarnerf.py",
                                          *_argv(data, tmp_path / "ref", "tiny", *argv)])
        cli_j.main()
    else:  # blockhash with the same flags
        cli.main(_argv(data, tmp_path / "ref", "tiny", *ENCODING_ARGV[encoding]))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    again = cli.main(_argv(data, tmp_path / "port", "tiny", *argv, "--test_eval"))
    test_eval = [e for e in again.run_log if e["event"] == "eval"]
    for k, v in evals[1]["meters"].items():
        np.testing.assert_array_equal(test_eval[0]["meters"][k], v, err_msg=k)


@pytest.mark.parametrize("flag,match", [
    (["--seam_tie", "1"], "--seam_tie.*queue A item 5"),
    (["--seam_sync_hashed", "8"], "--seam_sync_hashed.*queue A item 5"),
    (["--alpha_seam", "0.1"], "--alpha_seam.*queue A item 5"),
    (["--ckpt_format", "orbax"], "--ckpt_format orbax.*queue A item 6"),
], ids=["seam_tie", "seam_sync_hashed", "alpha_seam", "orbax"])
def test_unported_flags_raise(flag, match, data, tmp_path, monkeypatch):
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match=match):
        cli.main(_argv(data, tmp_path / "ws", "tiny", *flag))
    assert not (tmp_path / "ws").exists()


def test_cli_needs_a_gpu_unless_told_cpu(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LIDARNERF_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="LIDARNERF_PLATFORM=cpu"):
        cli.main(_argv(data, tmp_path / "ws"))
    monkeypatch.setenv("LIDARNERF_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        cli.main(_argv(data, tmp_path / "ws"))
    assert not (tmp_path / "ws").exists()
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    assert cli.device_from_env() == torch.device("cpu")


_IMPORT_ALL = """
import importlib, pkgutil, sys
import lidarnerf_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "lidarnerf_tpu", "cv2", "imageio", "orbax", "tensorboardX")))
"""


def test_port_imports_no_cv2_imageio_or_orbax():
    """The port writes its PNGs itself; imageio and tensorboardX are imported
    only where the JAX trainer imports them (inside `test` and `train`)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
    for path in (REPO / "lidarnerf_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for mod in ("cv2", "orbax", "jax"):
            assert f"import {mod}" not in text and f"from {mod}" not in text, (path, mod)
