"""The check against the timed path broken underneath: each fault a cell can
have, planted in the program, comes out not correct on a tiny CPU run (all
of a run but the look for a chip), by the number that holds it; and the
control, the reference in the precision one step below the configuration's,
comes out not correct in the program's place."""

import pytest
import torch

from benchmark import check
from benchmark import reference as ref
from benchmark.calibrate import train_readings
from benchmark.common import ROOT, cell_files, load_json
from benchmark.serve import reference_pano
from benchmark.tests.test_bench_dry_run import dry_run
from benchmark.tests.tiny import tiny

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
TRAIN = [c for c in CELLS if c.endswith(("train", "train_fast"))]
FAULTS = [(c, "unchanged", "change_gap") for c in TRAIN] + [
    (c, "epoch_unchanged", "loss_gap") for c in TRAIN] + [
    (c, "half_batch", "loss_gap") for c in TRAIN] + [
    ("kitti360.train_fast", "stale_grid", "grid_unchanged"),
    ("kitti360.serve", "altered", "depth_gap")]


@pytest.mark.parametrize("cell,fault,number", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault, number):
    sound, _ = dry_run(cell)
    broken, _ = dry_run(cell, "--fault", fault)
    assert broken["correct"] is False
    t = broken["checks"][number]
    assert t["value"] > t["limit"] >= sound["checks"][number]["value"]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_training_control_is_not_correct(cell):
    _, cfg, traffic = cell_files(BENCH, cell)
    cfg, traffic = tiny(cfg, traffic)
    r = train_readings(cfg, traffic, 5, torch.device("cpu"), ["program", "control"])
    ok, _ = check.judge(r["control"], check.limits(cell))
    assert not ok
    assert r["control"]["grad_diff"] > 2 * r["program"]["grad_diff"]


def test_the_serving_control_is_not_correct():
    _, cfg, traffic = cell_files(BENCH, "kitti360.serve")
    cfg, traffic = tiny(cfg, traffic)
    from benchmark import scenes

    dev = torch.device("cpu")
    data = scenes.make(cfg, 9, dev)
    pose = data["serve_poses"][1].numpy()
    exact = reference_pano(cfg, traffic, 9, data, pose, dev)
    control = reference_pano(cfg, traffic, 9, data, pose, dev, precision=ref.CONTROL)
    ok, _ = check.judge(check.pano_numbers(control, exact), check.limits("kitti360.serve"))
    assert not ok
