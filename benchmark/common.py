"""What every part of the harness shares: finding a cell's files by name,
seeds, timing helpers and the profiled sub-window."""

import contextlib
import json
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH_DIR = Path(__file__).resolve().parent
OUT_DIR = ROOT / "bench_out"  # traces; git-ignored


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(bench, workload):
    """(cell, config, traffic) of `workload` in BENCHMARK.json's dict: the
    config's file is BENCHMARK.json's, the traffic's `benchmark/traffic/<name>.json`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def sub_seed(seed, k):
    """The k-th stream of a run's seed: weights 0, data 1, training draws 2,
    frame orders 3, serving order 4, the check steps' frames 5, the checked
    panos 6."""
    return (int(seed) * 8 + k) % (1 << 63)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traced:
    """The profiled sub-window of a `--trace 1` run: `torch.profiler` over
    CPU and CUDA activity, with the benchmark's span `bench.traced` around
    the work it covers. `units` counts the steps or panos inside."""

    def __init__(self, device):
        self.device, self.units, self.prof, self.seconds = device, 0, None, None
        self.extra = {}

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        sync(self.device)
        t0 = time.perf_counter()
        try:
            with record_function("bench.traced"):
                yield self
                sync(self.device)
        finally:
            self.seconds = time.perf_counter() - t0
            self.prof.stop()

    def export(self, path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        return path
