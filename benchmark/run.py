"""The benchmark of the port `lidarnerf_tpu_torch` on one H100.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of BENCHMARK.json named `--workload`: its configuration
(`benchmark/configs/<config>.json`) under its traffic mix
(`benchmark/traffic/<traffic>.json`, whose `entry` names the harness's entry module:
`train` or `serve`). Set-up (imports, the kernels' build or load, data and
weights from the seed, warm-up) is timed as `setup_s`; then the window runs
for `--seconds`; then the program's state is freed and the plain reference
checks what the window's path produced (`check.py`). With `--trace 1` a
sub-window is profiled and the per-layer metrics are read from it by the
readers `benchmark/metrics/<metric>.py`; the trace goes to `bench_out/`.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device[, breakdown], checks); the numbers compared, each
beside its limit, are also the last lines of standard error. Exits 2
without enough CUDA devices, and 3 if JAX or the JAX package is loaded once
the window has closed.
"""

import sys
import time

T_START = time.perf_counter()
if __name__ == "__main__":  # byte code of everything imported below, kept under the checkout
    from pathlib import Path

    sys.pycache_prefix = str(Path(__file__).resolve().parent.parent / ".bench_cache" / "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark.common import (  # noqa: E402
    BENCH_DIR, OUT_DIR, ROOT, Traced, cell_files, load_json, sub_seed, sync)

CACHE_DIR = ROOT / ".bench_cache"  # fixed, inside the checkout; git-ignored
FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "lidarnerf_tpu")
GIB = 2.0 ** 30


def use_caches():
    """Any kernel cache under the checkout's fixed cache directory (the byte
    code's is set before the imports, above)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE_DIR / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def foreign_modules():
    """Loaded modules whose top-level name is JAX's, a JAX library's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def build_kernels(traffic):
    from lidarnerf_tpu_torch.ops import cuda_lib, occ_sample_cuda

    cuda_lib.build(("block_hash_fwd.cu", "block_hash_bwd.cu")
                   + ((occ_sample_cuda.SOURCE,) if traffic.get("fast") else ()))


def read_metric(name, ctx):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def reports(metric, cell, end_to_end):
    """Does `cell` report the metric (a per-layer one through its `moves`)?"""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = {m["name"]: m for m in end_to_end}[metric["moves"]]
        return reports(moved, cell, end_to_end)
    return True


def work_totals(c, kept, traced, cfg, traffic):
    """The bounds (ms) and matmul operations of the traced sub-window's work,
    from the reference's sample positions of the cell's own queries."""
    import torch

    from benchmark import bounds
    from benchmark import reference as ref

    levels, blocks = ref.block_levels(cfg["num_levels"], cfg["base_resolution"],
                                      cfg["log2_hashmap_size"], cfg["desired_resolution"])
    rows = len(levels) * blocks
    b = cfg["bound"]

    def x01(xyz):
        return ((xyz.reshape(-1, 3) + b) / (2 * b)).float()

    n = traced.units
    if traffic["entry"] == "train":
        xc, xf = x01(kept["coarse"]), x01(kept["fine"])
        per_step = {"b1_ms": bounds.fwd_ms(xc, levels, blocks) + bounds.fwd_ms(xf, levels, blocks),
                    "b2_ms": bounds.bwd_ms(xc.shape[0], len(levels), rows)
                    + bounds.bwd_ms(xf.shape[0], len(levels), rows),
                    "model_flops": 3.0 * (xc.shape[0] + xf.shape[0]) * bounds.sample_flops(cfg)}
        out = {k: v * n for k, v in per_step.items()}
        fast = traffic.get("fast")
        if fast:
            ro, rd = kept["rays"]
            near = c.data["scale"]
            out["occ_sample_ms"] = n * bounds.occ_sample_ms(
                ro, rd, near, near * ref.FAR_MULT, fast, b, fast["num_steps"])
            G = fast["grid_size"]
            i = torch.arange(G, dtype=torch.float32, device=xc.device)
            cells = torch.stack(torch.meshgrid(i, i, i, indexing="ij"), -1).reshape(-1, 3)
            refresh = (cells + 0.5) / G  # the cells' centres: the jitter's mean
            out["b1_ms"] += traced.extra["refreshes"] * bounds.fwd_ms(refresh, levels, blocks)
        return out
    per_pano = {"b1_ms": 0.0, "model_flops": 0.0}
    for blk in kept:
        xc, xf = x01(blk["coarse"]), x01(blk["fine"])
        per_pano["b1_ms"] += bounds.fwd_ms(xc, levels, blocks) + bounds.fwd_ms(xf, levels, blocks)
        per_pano["model_flops"] += (xc.shape[0] + xf.shape[0]) * bounds.sample_flops(cfg)
    return {k: v * n for k, v in per_pano.items()}


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(bench, cell, cfg, traffic, seed, seconds, trace, device, fault=None):
    """Set-up, window, check (and with `trace`, the per-layer readings) of
    one cell on `device`; returns the result dict. `fault` plants a fault
    for the harness's own tests (`benchmark/tests/faults.py`)."""
    import numpy as np
    import torch

    from benchmark import check
    from benchmark.serve import ServeCell, reference_pano
    from benchmark.train import TrainCell, reference_run

    cuda = device.type == "cuda"
    phases = {"imports": time.perf_counter() - T_START}
    if cuda:
        build_kernels(traffic)
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    phases["kernels"] = time.perf_counter() - T_START
    Cell = {"train": TrainCell, "serve": ServeCell}[traffic["entry"]]
    c = Cell(cfg, traffic, seed, device)
    sync(device)
    phases["data_and_model"] = time.perf_counter() - T_START
    if fault is not None:
        fault(c)
    c.setup()
    sync(device)
    setup_s = time.perf_counter() - T_START
    phases["warm_up"] = setup_s
    print("setup phases (s from start): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + "; within the cell (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                 getattr(c, "phases", {}).items()), file=sys.stderr)
    traced = Traced(device) if trace else None
    done, secs = c.window(seconds, traced)
    sync(device)
    drift = c.drift() if hasattr(c, "drift") else None
    if drift:
        print(f"window rays/s: first third {drift[0]!r}, last third {drift[1]!r}", file=sys.stderr)
    memory = torch.cuda.max_memory_reserved(device) if cuda else 0
    trace_path = None
    if traced is not None:
        trace_path = traced.export(OUT_DIR / f"{cell['name']}.seed{seed}.trace.json")
    program = c.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    kept = {} if traffic["entry"] == "train" else []
    if traffic["entry"] == "train":
        refr = reference_run(cfg, traffic, seed, c.data, c.check_plan(), device,
                             grid=program.get("grid"), keep=kept)
        numbers = check.train_numbers(program, refr)
        attempted, failed = done, c.failed
    else:
        rng = np.random.default_rng(sub_seed(seed, 6))
        picks = rng.choice(len(c.served), size=min(traffic["check_panos"], len(c.served)),
                           replace=False)
        readings = []
        for k, j in enumerate(sorted(picks)):
            i, *out = c.served[j]
            refp = reference_pano(cfg, traffic, seed, c.data, c.poses[i], device,
                                  keep=kept if k == 0 else None)
            readings.append(check.pano_numbers(out, refp))
        numbers = check.worst(readings)
        attempted, failed = done, c.failed
    correct, table = check.judge(numbers, check.limits(cell["name"]))

    e2e = [m for m in bench["end_to_end"] if reports(m, cell["name"], bench["end_to_end"])]
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    if not trace:
        values = {"setup_s": setup_s, "peak_mem_gib": memory / GIB}
        if traffic["entry"] == "train":
            values["train_rays_per_s"] = done * cfg["num_rays_lidar"] / secs
        else:
            values["panos_per_s"] = done / secs
            values["pano_ms_p90"] = float(np.percentile(c.latency_ms, 90))
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] in values}
    else:
        from benchmark.trace import Reading

        reading = Reading(trace_path)
        ctx = SimpleNamespace(
            kind=traffic["entry"], units=traced.units, window_s=reading.window_us / 1e6,
            busy_s=reading.busy_us / 1e6,
            time_s={k: v / 1e6 for k, v in reading.time_us.items()},
            work=work_totals(c, kept, traced, cfg, traffic), cfg=cfg, traffic=traffic)
        metrics = {}
        for m in bench["per_layer"]:
            if reports(m, cell["name"], bench["end_to_end"]):
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        result["breakdown"] = reading.breakdown()
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    result.update(metrics=metrics, device=device_info, checks=table)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_caches()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = cell_files(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, cfg, traffic, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0))
    found = foreign_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for name, t in result["checks"].items():
        print(f"check {name} {t['value']!r} limit {t['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
