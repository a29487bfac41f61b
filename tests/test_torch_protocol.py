"""Port parity for the protocol drivers: `lidarnerf_tpu_torch/tools/{ab_run,
full_run,protocol_report}.py` against tools/{ab_run,full_run,protocol_report}.py.

The JAX tools import no JAX, so they are loaded from tools/ as they are.
- The log parsers and the report's printed text, on the committed round-5
  logs of the JAX package (out_r5/protocol_log.txt.gz, full_run_r5b/,
  drive60/): the same blocks, rates and text.
- full_run's command lines (segment 0, a resume, --best_eval) and its result
  JSON against the JAX tool's, both driving a recorder in place of the
  trainer; its kill and stall loop against a stub trainer command that
  writes log lines; one tiny --no_kill run through the port's
  CLI under LIDARNERF_PLATFORM=cpu, its result JSON against the JAX
  schema (out_r5/full_run_result.json).
- ab_run's command lines and tabulated results against the JAX tool's.
"""

import gzip
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from lidarnerf_tpu_torch.tools import ab_run, full_run, protocol_report

REPO = Path(__file__).resolve().parent.parent
LOGS = {
    "protocol": ("out_r5/protocol_log.txt.gz", "out_r5/full_run_result.json"),
    "r5b": ("out_r5/full_run_r5b/log.txt.gz", "out_r5/full_run_r5b/full_run_result.json"),
    "drive60": ("out_r5/drive60/log.txt.gz", None),
}


def _load(name, path):
    """A root tools/ script as a module (full_run.py imports `ab_run` from tools/)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(name, REPO / path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO / "tools"))
    return module


@pytest.fixture(scope="module")
def jax_tools():
    return SimpleNamespace(ab_run=_load("jax_ab_run", "tools/ab_run.py"),
                           full_run=_load("jax_full_run", "tools/full_run.py"),
                           protocol_report=_load("jax_protocol_report",
                                                 "tools/protocol_report.py"))


def _workspace(tmp_path, log, result):
    ws = tmp_path / "ws"
    ws.mkdir()
    with gzip.open(REPO / log, "rt") as f:
        (ws / "log_lidar_nerf.txt").write_text(f.read())
    if result is not None:
        shutil.copy(REPO / result, ws / "full_run_result.json")
    return ws


@pytest.mark.parametrize("name", sorted(LOGS))
def test_parsers_and_report_match_jax_on_round5_logs(name, jax_tools, tmp_path, capsys):
    ws = _workspace(tmp_path, *LOGS[name])
    log = str(ws / "log_lidar_nerf.txt")
    evals = ab_run.parse_evals(log)
    assert evals == jax_tools.ab_run.parse_evals(log)
    assert len(evals) >= 3 and all("chamfer" in b for b in evals)
    assert ab_run.rays_per_sec(log) == jax_tools.ab_run.rays_per_sec(log) > 0
    txt = (ws / "log_lidar_nerf.txt").read_text()
    assert protocol_report.parse_blocks(txt) == jax_tools.protocol_report.parse_blocks(txt)

    jax_tools.protocol_report.main(str(ws))
    text_j = capsys.readouterr().out
    protocol_report.main(str(ws))
    text = capsys.readouterr().out
    assert text == text_j
    assert "## val Chamfer trajectory" in text and "median train rate" in text


def test_arms_and_base_are_the_jax_tools():
    jax_ab = _load("jax_ab_run_consts", "tools/ab_run.py")
    assert ab_run.ARMS == jax_ab.ARMS
    assert ab_run.BASE == jax_ab.BASE
    assert ab_run.CLI[-2:] == ["-m", "lidarnerf_tpu_torch.main_lidarnerf"]
    assert ab_run.REPO == REPO


# ----------------------------------------------------- full_run with a recorder


def _log_slice(lo, hi):
    with gzip.open(REPO / LOGS["r5b"][0], "rt") as f:
        return "".join(f.readlines()[lo:hi])


class _Recorder:
    """subprocess as full_run uses it: Popen and call record their argv and
    cwd and append a slice of the round-5 log to the workspace log."""

    DEVNULL = STDOUT = None

    def __init__(self, real):
        self.calls = []
        self.TimeoutExpired = real.TimeoutExpired

    def _write(self, argv, best):
        ws = Path(argv[argv.index("--workspace") + 1])
        ws.mkdir(parents=True, exist_ok=True)
        with open(ws / "log_lidar_nerf.txt", "a") as f:
            # training through one val eval, or the best checkpoint's test eval
            f.write(_log_slice(4060, 4078) if best else _log_slice(0, 120) + _log_slice(4040, 4060))

    def Popen(self, argv, cwd=None, **kw):  # noqa: N802 - subprocess's name
        self.calls.append((list(argv), cwd))
        self._write(argv, best=False)
        return SimpleNamespace(returncode=0, wait=lambda timeout=None: 0)

    def call(self, argv, cwd=None, **kw):
        self.calls.append((list(argv), cwd))
        self._write(argv, best=True)
        return 0


@pytest.mark.parametrize("resume", [False, True], ids=["scratch", "resume"])
def test_full_run_argv_and_result_match_jax(resume, jax_tools, tmp_path, monkeypatch, capsys):
    import subprocess

    opts = ["--arm", "fast_dil1", "--iters", "30000", "--eval_interval", "50", "--best_eval",
            "--no_kill"] + (["--resume"] if resume else [])
    rec_j, rec = _Recorder(subprocess), _Recorder(subprocess)
    monkeypatch.setattr(jax_tools.full_run, "subprocess", rec_j)
    monkeypatch.setattr(sys, "argv", ["full_run.py", *opts, "--workspace", str(tmp_path / "j")])
    assert jax_tools.full_run.main() == 0
    result_j = json.loads((tmp_path / "j" / "full_run_result.json").read_text())

    monkeypatch.setattr(full_run, "subprocess", rec)
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    assert full_run.main([*opts, "--workspace", str(tmp_path / "p")]) == 0
    result = json.loads((tmp_path / "p" / "full_run_result.json").read_text())
    out = capsys.readouterr().out

    # the trainer's argv after the interpreter's (JAX: main_lidarnerf.py, port:
    # -m lidarnerf_tpu_torch.main_lidarnerf), the workspace apart; the port runs
    # from the repository's root
    def strip(argv, n, ws):
        return [a.replace(ws, "WS") for a in argv[n:]]

    assert len(rec.calls) == len(rec_j.calls) == 2
    for (argv, cwd), (argv_j, _) in zip(rec.calls, rec_j.calls):
        assert argv[:len(ab_run.CLI)] == ab_run.CLI and argv_j[1:3] == ["-u", "main_lidarnerf.py"]
        assert strip(argv, len(ab_run.CLI), str(tmp_path / "p")) == strip(
            argv_j, 3, str(tmp_path / "j"))
        assert cwd == REPO
    seg = rec.calls[0][0]
    assert ("latest" in seg) == resume and ("scratch" in seg) == (not resume)
    assert seg[-5:] == ["--ckpt_interval", "50", "--fast", "--occ_dilate", "1"]
    assert rec.calls[1][0][-3:] == ["--ckpt", "best", "--test_eval"]

    # the result: the same fields and, apart from the wall-clock, the same values
    assert result.keys() == result_j.keys()
    for k in ("total_wall_s", "north_star", "segments"):
        result.pop(k), result_j.pop(k)
    assert result == result_j
    assert result["test_best"] is not None and result["resume_points"][-1] == ["450", "7200"]
    assert json.loads(out.strip().splitlines()[-1])["arm"] == "fast_dil1"


def test_ab_run_argv_and_table_match_jax(jax_tools, tmp_path, monkeypatch, capsys):
    """Both tools with a recorder for subprocess.run that writes a slice of the
    round-5 log (two eval blocks) into each arm's workspace. The JAX tool's
    /tmp paths are redirected under tmp_path; the port's follow TMPDIR."""
    import builtins
    import subprocess

    jax_tmp = tmp_path / "jax"
    jax_tmp.mkdir()

    def redirect(path):
        path = str(path)
        return str(jax_tmp / path[len("/tmp/"):]) if path.startswith("/tmp/") else path

    def recorder(calls, where):
        def run(argv, cwd=None, **kw):
            calls.append((list(argv), cwd))
            ws = Path(where(argv[argv.index("--workspace") + 1]))
            ws.mkdir(parents=True, exist_ok=True)
            (ws / "log_lidar_nerf.txt").write_text(_log_slice(0, 120) + _log_slice(4040, 4060))
            return subprocess.CompletedProcess(argv, 0, "", "")
        return SimpleNamespace(run=run)

    calls_j, calls = [], []
    monkeypatch.setattr(jax_tools.ab_run, "subprocess", recorder(calls_j, redirect))
    monkeypatch.setattr(jax_tools.ab_run, "open", lambda p, *a, **k: builtins.open(
        redirect(p), *a, **k), raising=False)
    monkeypatch.setattr(jax_tools.ab_run, "shutil", SimpleNamespace(rmtree=lambda *a, **k: None))
    arms = ["--arms", "parity", "fast_dil1", "--iters", "32", "--small"]
    monkeypatch.setattr(sys, "argv", ["ab_run.py", *arms])
    jax_tools.ab_run.main()
    out_j = capsys.readouterr().out

    monkeypatch.setenv("TMPDIR", str(tmp_path / "port"))
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(ab_run.tempfile, "tempdir", None)  # re-read TMPDIR
    monkeypatch.setattr(ab_run, "subprocess", recorder(calls, lambda p: p))
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    results = ab_run.main(arms)
    out = capsys.readouterr().out

    assert len(calls) == len(calls_j) == 2
    for (argv, cwd), (argv_j, _) in zip(calls, calls_j):
        ws = argv[argv.index("--workspace") + 1]
        assert ws.startswith(str(tmp_path / "port")) and cwd == REPO
        assert [a.replace(os.path.dirname(ws), "/tmp") for a in argv[len(ab_run.CLI):]] == \
            argv_j[3:]
    # the printed arms, rows and table, the wall-clock apart
    def table(text):
        return [line.rsplit(None, 1)[0] if line[:6] in ("parity", "fast_d") else line
                for line in text.splitlines() if not line.startswith("{")]

    assert table(out.replace(str(tmp_path / "port"), "/tmp")) == table(out_j)
    saved = json.loads((tmp_path / "port" / "ab_results.json").read_text())
    saved_j = json.loads((jax_tmp / "ab_results.json").read_text())
    for tag in ("parity", "fast_dil1"):
        assert results[tag]["test"] == saved[tag]["test"] == saved_j[tag]["test"]
        assert saved[tag]["val"] == saved_j[tag]["val"] is not None
        assert saved[tag]["rays_per_s"] == saved_j[tag]["rays_per_s"]


# ------------------------------------------- the kill and stall loop on a stub

STUB = r'''
import os, sys, time
argv = sys.argv[1:]
ws = argv[argv.index("--workspace") + 1]
mode = argv[argv.index("--stub") + 1]
os.makedirs(ws, exist_ok=True)
log = open(os.path.join(ws, "log_lidar_nerf.txt"), "a")
resumed = "latest" in argv
if resumed and not os.environ.get("STUB_NO_CHECKPOINT"):
    print("[INFO] load at epoch 3, global step 48", file=log, flush=True)
first = 4 if resumed else 1
if mode == "stall" and not resumed:
    print("==> Finished Epoch 1. loss=1.0000 (1000 rays/s, 0.26M samples/s)", file=log, flush=True)
    time.sleep(60)
n = 6 if resumed else 400
for e in range(first, first + n):
    print(f"==> Finished Epoch {e}. loss={1.0 / e:.4f} (1000 rays/s, 0.26M samples/s)",
          file=log, flush=True)
    time.sleep(0.02)
for split in ("val", "test"):
    print(f"++> Evaluate at epoch {e} ...", file=log)
    print("MAE = 0.010000", file=log)
    print("RMSE = 0.020000", file=log)
    print("Depth_error(rmse, a1, a2, a3, ssim) = [4.0 0.9 0.95 0.97 0.96]", file=log)
    print("CD f-score = [0.10 0.95]", file=log)
    print(f"++> Evaluate epoch {e} Finished (0.1s, 2 frames).", file=log, flush=True)
'''


@pytest.mark.parametrize("mode", ["kill", "stall"])
def test_full_run_kills_stalls_and_resumes_a_stub_trainer(mode, tmp_path, monkeypatch, capsys):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    monkeypatch.setattr(ab_run, "CLI", [sys.executable, "-u", str(stub)])
    monkeypatch.setattr(ab_run, "BASE", ["--stub", mode, "--ckpt", "scratch"])
    monkeypatch.setattr(full_run, "POLL_S", 0.05)
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    ws = tmp_path / "ws"
    opts = ["--arm", "parity", "--iters", "64", "--workspace", str(ws)]
    if mode == "kill":  # one kill 1.5 s in: the stub logs 400 epochs over ~8 s
        opts += ["--kill_at", "0.5", "--expected_train_s", "3"]
    else:
        opts += ["--no_kill", "--stall_timeout_s", "1.5"]
    assert full_run.main(opts) == 0
    result = json.loads((ws / "full_run_result.json").read_text())
    out = capsys.readouterr().out

    killed, done = result["segments"]
    assert killed["killed"] and killed["why"] == ("kill_point" if mode == "kill" else "stalled")
    assert killed["rc"] is None and 1.0 < killed["dur_s"] < 8.0
    assert done == {"dur_s": done["dur_s"], "rc": 0, "killed": False}
    assert result["resume_points"] == [["3", "48"]]
    assert result["n_evals"] == 2 and result["test"]["chamfer"] == 0.10
    assert result["test_best"] is None and result["nonfinite_log_lines"] == 0
    assert "=== segment 1:" in out and "killed at epoch ~" in out
    assert ("STALLED" in out) == (mode == "stall")
    assert "found no checkpoint" not in out


def test_full_run_reports_a_resume_that_found_no_checkpoint(tmp_path, monkeypatch, capsys):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    monkeypatch.setenv("STUB_NO_CHECKPOINT", "1")  # the resume logs no "load at epoch"
    monkeypatch.setattr(ab_run, "CLI", [sys.executable, "-u", str(stub)])
    monkeypatch.setattr(ab_run, "BASE", ["--stub", "kill", "--ckpt", "scratch"])
    monkeypatch.setattr(full_run, "POLL_S", 0.05)
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    ws = tmp_path / "ws"
    opts = ["--arm", "parity", "--workspace", str(ws), "--kill_at", "0.5",
            "--expected_train_s", "1"]
    assert full_run.main(opts) == 0
    assert "1 of 1 resume(s) found no checkpoint" in capsys.readouterr().out
    assert json.loads((ws / "full_run_result.json").read_text())["resume_points"] == []


def test_drivers_raise_without_a_gpu(monkeypatch, tmp_path):
    import torch

    monkeypatch.delenv("LIDARNERF_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_run.main(["--workspace", str(tmp_path / "ws"), "--no_kill"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_run.main(["--arms", "parity"])
    assert not (tmp_path / "ws").exists()


# ------------------------------------------------ one tiny run through the CLI

TINY = ["--num_steps", "16", "--upsample_steps", "4", "--num_rays_lidar", "128",
        "--desired_resolution", "64", "--log2_hashmap_size", "10", "--max_ray_batch", "512"]


def test_tiny_no_kill_run_through_the_port_cli(tmp_path, monkeypatch, capsys):
    sys.path.insert(0, str(REPO / "tests"))
    from test_e2e import write_synthetic_kitti

    data = tmp_path / "data"
    write_synthetic_kitti(str(data), n_train=2, n_val=1, n_test=1)
    base = ["--config", "configs/kitti360_1908.txt", "--path", str(data), "--scale", "0.05",
            "--offset", "0", "0", "0", "--ckpt", "scratch", "--mesh_resolution", "16", *TINY]
    monkeypatch.setattr(ab_run, "BASE", base)
    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    ws = tmp_path / "ws"
    assert full_run.main(["--arm", "parity", "--iters", "4", "--eval_interval", "1",
                          "--no_kill", "--workspace", str(ws)]) == 0
    result = json.loads((ws / "full_run_result.json").read_text())
    schema = json.loads((REPO / "out_r5/full_run_result.json").read_text())

    assert result.keys() == schema.keys()
    assert result["segments"] == [{"dur_s": result["segments"][0]["dur_s"], "rc": 0,
                                   "killed": False}]
    # 2 epochs of 2 frames, a val eval after each, then the test split's eval
    assert result["n_evals"] == 3
    for k in ("val", "test"):
        assert result[k].keys() == schema[k].keys(), k
    assert result["test_best"] is None and schema["test_best"] is not None
    assert result["resume_points"] == [] and result["nonfinite_log_lines"] == 0
    assert result["rays_per_s"] > 0 and result["north_star"].keys() == schema["north_star"].keys()
    log = (ws / "log_lidar_nerf.txt").read_text()
    assert "| cpu |" in log and log.count("==> Finished Epoch") == 2
    assert os.path.exists(ws / "checkpoints")
