"""A later PR adds a cell by adding files and entries only: here a new
configuration, traffic mix, per-layer metric and limits file, in a copy of
the harness in a temporary directory, are found by their names and run (at
tiny sizes on the CPU) with no file of the harness edited."""

import hashlib
import json
import os
import shutil
from pathlib import Path

from benchmark.tests.test_bench_dry_run import dry_run

ROOT = Path(__file__).resolve().parent.parent.parent


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files_runs(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "lidarnerf_tpu_torch", tmp_path / "lidarnerf_tpu_torch")
    before = digests(tmp_path)
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "kitti360.json").read_text())
    config.update(name="street_copy", num_layers_color=3)
    (b / "configs" / "street_copy.json").write_text(json.dumps(config))
    traffic = json.loads((b / "traffic" / "serve.json").read_text())
    traffic.update(check_panos=1, about="serving, one pano checked")
    (b / "traffic" / "serve_one.json").write_text(json.dumps(traffic))
    (b / "metrics" / "traced_panos.py").write_text(
        '"""Panos in the traced sub-window."""\n\n\ndef read(ctx):\n    return float(ctx.units)\n')
    (b / "limits" / "street_copy.serve_one.json").write_text(
        (b / "limits" / "kitti360.serve.json").read_text())

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "street_copy", "source": bench["configs"][0]["source"],
                             "file": "benchmark/configs/street_copy.json", "reduced": [],
                             "why": "a copy of kitti360 for this test"})
    bench["workloads"].append({"name": "street_copy.serve_one", "config": "street_copy",
                               "traffic": "serve_one", "chips": 1, "why": "this test's cell"})
    for m in bench["end_to_end"]:
        if "panos_per_s" == m["name"]:
            m["workloads"].append("street_copy.serve_one")
    bench["per_layer"].append({"name": "traced_panos", "unit": "panos", "better": "higher",
                               "source": "program_counter", "layer": "serving entry",
                               "moves": "panos_per_s", "workloads": ["street_copy.serve_one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result, foreign = dry_run("street_copy.serve_one", "--trace", "1", cwd=tmp_path)
    assert result["metrics"]["traced_panos"]["value"] == 2.0  # tiny's trace_panos
    assert set(result["checks"]) == {"depth_gap", "raydrop_gap", "intensity_gap"}
    assert foreign == []
    after = digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
