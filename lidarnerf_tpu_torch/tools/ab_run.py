"""A/B driver: run CLI arms sequentially on the synth drive and tabulate
(counterpart of tools/ab_run.py).

    python -m lidarnerf_tpu_torch.tools.ab_run --iters 320 --arms parity fast_dil0 fast_dil1
    ... --arms seam0 seam1 seam100 hashgrid    # encoder-quality arms

Each arm runs the port's CLI (`python -m lidarnerf_tpu_torch.main_lidarnerf`)
from the repository's root in a fresh workspace `ab_<tag>` under the
temporary directory (`tempfile.gettempdir()`); metrics are parsed from the
workspace log (the trainer writes the meter reports there). The final two
eval blocks per run are the end-of-training val eval and the test-split
eval (the CLI runs evaluate(test) + test(test) after training). The data is
`data_synth_drive/`, which `python -m lidarnerf_tpu_torch.tools.make_synth_drive`
writes. The arms run on CUDA unless LIDARNERF_PLATFORM=cpu, which the CLI
reads; without it a GPU is needed.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from lidarnerf_tpu_torch.main_lidarnerf import device_from_env

REPO = Path(__file__).resolve().parents[2]  # the CLI runs from the repository's root
CLI = [sys.executable, "-u", "-m", "lidarnerf_tpu_torch.main_lidarnerf"]

ARMS = {
    "parity": [],
    "fast_dil0": ["--fast", "--occ_dilate", "0"],
    "fast_dil1": ["--fast", "--occ_dilate", "1"],
    "fast_dil2": ["--fast", "--occ_dilate", "2"],
    "seam0": ["--encoding", "blockhash", "--alpha_seam", "0"],
    "seam1": ["--encoding", "blockhash", "--alpha_seam", "1"],
    "seam100": ["--encoding", "blockhash", "--alpha_seam", "100"],
    "seam10k": ["--encoding", "blockhash", "--alpha_seam", "10000"],
    "hashgrid": ["--encoding", "hashgrid"],
    # boundary-corner-sharing arms (ops/block_hash.tie_dense_seams /
    # sync_hashed_seams)
    "tie0": ["--encoding", "blockhash", "--seam_tie", "0"],
    "tie1": ["--encoding", "blockhash", "--seam_tie", "1"],
    "tie1sync": ["--encoding", "blockhash", "--seam_tie", "1",
                 "--seam_sync_hashed", "4096"],
    "sync_only": ["--encoding", "blockhash", "--seam_tie", "0",
                  "--seam_sync_hashed", "4096"],
}

BASE = [
    "--config", "configs/kitti360_1908.txt",
    "--path", "data_synth_drive",
    "--scale", "0.009913937624654217",
    "--offset", "28.67044005924491", "0.0", "2.154948902130127",
    "--ckpt", "scratch",
    # A/B metrics come from the eval meters; no full-res marching-cubes
    # export per arm
    "--mesh_resolution", "32",
]


def parse_evals(log_path):
    """Return the list of eval blocks: dicts of the meter reports."""
    txt = open(log_path).read()
    blocks = []
    cur = None
    for line in txt.splitlines():
        if "Evaluate" in line and "..." in line:
            cur = {}
        m = re.match(r"MAE = ([\d.eE+-]+)", line)
        if m and cur is not None:
            cur["mae"] = float(m.group(1))
        m = re.match(r"RMSE = ([\d.eE+-]+)", line)
        if m and cur is not None:
            cur["rmse"] = float(m.group(1))
        m = re.match(r"Depth_error\(rmse, a1, a2, a3, ssim\) = \[(.*)\]", line)
        if m and cur is not None:
            v = [float(t) for t in m.group(1).split()]
            cur.update(depth_rmse=v[0], a1=v[1], a2=v[2], a3=v[3], ssim=v[4])
        m = re.match(r"CD f-score = \[(.*)\]", line)
        if m and cur is not None:
            v = [float(t) for t in m.group(1).split()]
            cur.update(chamfer=v[0], fscore=v[1])
            blocks.append(cur)
            cur = None
    return blocks


def rays_per_sec(log_path):
    rates = [
        float(m.group(1))
        for m in re.finditer(r"\((\d+) rays/s", open(log_path).read())
    ]
    # steady-state: median of the second half (skips the epochs that build
    # kernels and capture graphs)
    if not rates:
        return None
    tail = sorted(rates[len(rates) // 2 :])
    return tail[len(tail) // 2]


def main(argv=None):
    """Run the arms; returns {tag: result} of the arms that finished."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=320)
    ap.add_argument("--eval_interval", type=int, default=1000000)
    ap.add_argument("--arms", nargs="+", required=True)
    ap.add_argument("--timeout", type=int, default=5400, help="per arm, seconds")
    ap.add_argument(
        "--small",
        action="store_true",
        help="round-2 encoder-A/B config (1024 rays, 256+32 samples, "
        "desired_res 4096, log2 17) — the largest config the exact hashgrid "
        "control trains at practical speed",
    )
    args = ap.parse_args(argv)
    device_from_env()  # the CLI's rule, before any arm starts: raises with no GPU

    small = [
        "--num_rays_lidar", "1024", "--num_steps", "256", "--upsample_steps",
        "32", "--desired_resolution", "4096", "--log2_hashmap_size", "17",
        "--max_ray_batch", "1024",
    ] if args.small else []

    results = {}
    for tag in args.arms:
        ws = os.path.join(tempfile.gettempdir(), f"ab_{tag}")
        shutil.rmtree(ws, ignore_errors=True)
        argv = (
            CLI
            + BASE
            + small
            + ["--workspace", ws, "--iters", str(args.iters),
               "--eval_interval", str(args.eval_interval)]
            + ARMS[tag]
        )
        print(f"=== arm {tag}: {' '.join(argv[len(CLI):])}", flush=True)
        t0 = time.time()
        r = subprocess.run(
            argv, cwd=REPO, timeout=args.timeout,
            capture_output=True, text=True,
        )
        wall = time.time() - t0
        if r.returncode != 0:
            print(f"arm {tag} FAILED rc={r.returncode}\n{r.stdout[-2000:]}\n"
                  f"{r.stderr[-2000:]}", flush=True)
            continue
        log = os.path.join(ws, "log_lidar_nerf.txt")
        evals = parse_evals(log)
        val = evals[-2] if len(evals) >= 2 else None
        test = evals[-1] if evals else None
        results[tag] = {
            "val": val, "test": test, "wall_s": round(wall, 1),
            "rays_per_s": rays_per_sec(log),
        }
        print(json.dumps({tag: results[tag]}), flush=True)

    cols = ["mae", "depth_rmse", "a1", "ssim", "chamfer", "fscore"]
    print("\narm        split " + " ".join(f"{c:>10}" for c in cols) +
          "      rays/s   wall_s", flush=True)
    for tag, r in results.items():
        for split in ("val", "test"):
            b = r[split]
            if b is None:
                continue
            print(
                f"{tag:10s} {split:5s} "
                + " ".join(f"{b.get(c, float('nan')):10.4f}" for c in cols)
                + f"  {r['rays_per_s'] or 0:10.0f} {r['wall_s']:8.1f}",
                flush=True,
            )
    with open(os.path.join(tempfile.gettempdir(), "ab_results.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
