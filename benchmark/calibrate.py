"""Readings for the limits of `check.py`, one JSON line a seed (not run by the
benchmark's own runs).

    python -m benchmark.calibrate --workload <cell> --seeds 1 2 3 [--what program control fault]

For each seed: `program`, the numbers of the program's timed path (the
cell's set-up: the check's eager steps and first epoch, or the sampled
panos rendered through the serving entry) against the reference;
`control`, the reference in the control's precision (`reference.CONTROL`)
in the program's place; `fault`, training's planted faults in the
reference in the program's place: half of the batch left out (the mean
over the rest), and the epoch's steps leaving the state unchanged. A state
left unchanged by every step reads 1 on `change_gap` by its definition and
needs no run.
"""

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark import check
from benchmark import reference as ref
from benchmark.common import ROOT, cell_files, load_json, sub_seed
from benchmark.run import build_kernels, use_caches
from benchmark.serve import ServeCell, reference_pano
from benchmark.train import TrainCell, reference_run


def raw(r):
    """The per-leaf norms and losses of a reference or program reading."""
    return {k: r[k] for k in ("losses", "first_grad", "change")}


def train_readings(cfg, traffic, seed, device, what, leaves=False):
    """Each number, and with `leaves` the raw readings (losses and each
    leaf's norms) of every side beside its reference's."""
    out = {}
    c = TrainCell(cfg, traffic, seed, device)
    plan = c.check_plan()
    pairs = {}
    own = None  # the reference on its own grid: every side's but the program's and the control's

    def reference(grid=None):
        nonlocal own
        if grid is not None:
            return reference_run(cfg, traffic, seed, c.data, plan, device, grid=grid)
        if own is None:
            own = reference_run(cfg, traffic, seed, c.data, plan, device)
        return own

    if "program" in what:
        c.setup()
        prog = c.release()
        gc.collect()
        torch.cuda.empty_cache()
        pairs["program"] = (prog, reference(prog.get("grid")))
    if "control" in what:
        ctrl = reference_run(cfg, traffic, seed, c.data, plan, device, precision=ref.CONTROL)
        pairs["control"] = (ctrl, reference(ctrl.get("grid")))
    if "fault" in what:
        for fault in ("half_batch", "epoch_unchanged"):
            pairs[fault] = (reference_run(cfg, traffic, seed, c.data, plan, device, fault=fault),
                            reference())
    for name, (side, refr) in pairs.items():
        out[name] = check.train_numbers(side, refr)
        if leaves:
            out[name + "_raw"] = [raw(side), raw(refr)]
            out[name + "_grad_diff"] = check.grad_diffs(side, refr)
    return out


def serve_readings(cfg, traffic, seed, device, what):
    out = {}
    c = ServeCell(cfg, traffic, seed, device)
    picks = np.random.default_rng(sub_seed(seed, 6)).choice(
        len(c.poses), size=traffic["check_panos"], replace=False)
    refs = [reference_pano(cfg, traffic, seed, c.data, c.poses[i], device) for i in picks]
    if "program" in what:
        c.setup()
        out["program"] = check.worst([check.pano_numbers(c.pano(i), r)
                                      for i, r in zip(picks, refs)])
    c.release()
    if "control" in what:
        out["control"] = check.worst([check.pano_numbers(
            reference_pano(cfg, traffic, seed, c.data, c.poses[i], device,
                           precision=ref.CONTROL), r) for i, r in zip(picks, refs)])
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=["program", "control", "fault"])
    p.add_argument("--leaves", action="store_true", help="each leaf's norms, program and reference")
    args = p.parse_args(argv)
    use_caches()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = cell_files(bench, args.workload)
    device = torch.device("cuda", 0)
    build_kernels(traffic)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if traffic["entry"] == "train":
            r = train_readings(cfg, traffic, seed, device, args.what, args.leaves)
        else:
            r = serve_readings(cfg, traffic, seed, device, args.what)
        print(json.dumps({"cell": args.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
