"""Each cell of BENCHMARK.json run at tiny sizes on the CPU (all of a run but
the look for a chip) in a process of its own: a valid last line, and no
module of JAX, a JAX library or the JAX package loaded; the reference alone
loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def dry_run(cell, *extra, cwd=ROOT):
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.dryrun", "--workload", cell,
                          *extra], cwd=cwd, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1].removeprefix("FOREIGN "))


def check_line(result, cell, trace):
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert isinstance(result["correct"], bool) and result["attempted"] > 0
    assert result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in result["breakdown"].values())
        wanted = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
        assert set(result["metrics"]) <= wanted
    else:
        wanted = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)}
        assert set(result["metrics"]) == wanted
    for t in result["checks"].values():
        assert set(t) == {"value", "limit"} and t["limit"] is not None


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_prints_a_valid_line_and_loads_no_jax(cell, trace):
    result, foreign = dry_run(cell, "--trace", str(trace))
    check_line(result, cell, trace)
    assert foreign == []


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, torch\n"
        "from benchmark import bounds, check, reference, scenes, weights\n"
        "from benchmark.common import ROOT, cell_files, load_json\n"
        "from benchmark.serve import reference_pano\n"
        "from benchmark.tests.tiny import tiny\n"
        "from benchmark.train import reference_run\n"
        "bench = load_json(ROOT / 'BENCHMARK.json')\n"
        "dev = torch.device('cpu')\n"
        "for name in ('kitti360.train', 'kitti360.serve'):\n"
        "    cell, cfg, traffic = cell_files(bench, name)\n"
        "    cfg, traffic = tiny(cfg, traffic)\n"
        "    data = scenes.make(cfg, 1, dev)\n"
        "    if traffic['entry'] == 'train':\n"
        "        reference_run(cfg, traffic, 3, data, [(0, 1, 0), (1, [2, 8], 1)], dev)\n"
        "    else:\n"
        "        reference_pano(cfg, traffic, 3, data, data['serve_poses'][0].numpy(), dev)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'lidarnerf_tpu_torch', 'lidarnerf_tpu', 'jax', 'jaxlib', 'flax',"
        " 'optax', 'orbax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
