"""Full-budget measured run: 30k steps on the synth drive, with resume soak
(counterpart of tools/full_run.py).

    python -m lidarnerf_tpu_torch.tools.full_run --arm fast_dil1 --iters 30000 \
        --eval_interval 50 --best_eval --kill_at 0.5

Executes the reference training budget (30,000 iters; configs/
kitti360_1908.txt + main_lidarnerf.py) end to end through the port's CLI
(`python -m lidarnerf_tpu_torch.main_lidarnerf`, run from the repository's
root), measuring wall-clock, and — unless --no_kill — SIGKILLs the trainer
at the requested fractions of --expected_train_s (wall-clock from the
start) and restarts it with --ckpt latest, so the checkpoint/resume
contract is soaked at full scale (the trainer's generator and frame-order
streams, the keep-2 ring, best-by-Chamfer). The default --expected_train_s
is the order of a `--fast` run on one H100, where the JAX tool's 3600 s
would place a 0.5 kill after the run's end.

Outputs one JSON line at the end: wall-clock, the number of kills,
per-segment durations, final eval metrics parsed from the workspace log, and
the 4-chip-scaled wall-clock estimate vs the <=20-min north star
(BASELINE.md); the same object goes to `full_run_result.json` in the
workspace. A resume that found no checkpoint (a kill before the first one)
is reported on its own line, and shows as fewer `resume_points` than kills.
The data is `data_synth_drive/` (`python -m
lidarnerf_tpu_torch.tools.make_synth_drive`). The CLI runs on CUDA unless
LIDARNERF_PLATFORM=cpu; without it a GPU is needed.
"""

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from lidarnerf_tpu_torch.main_lidarnerf import device_from_env
from lidarnerf_tpu_torch.tools import ab_run
from lidarnerf_tpu_torch.tools.ab_run import ARMS, parse_evals, rays_per_sec

POLL_S = 15.0  # the watchdog's period between checks of the log's progress


def train_argv(args):
    """(segment 0's argv, a resume's argv): BASE + the run's options + the arm;
    a resume loads the latest checkpoint instead of starting from scratch."""
    argv = (
        ab_run.CLI
        + ab_run.BASE
        + ["--workspace", args.workspace, "--iters", str(args.iters),
           "--eval_interval", str(args.eval_interval),
           # tiny-epoch drives: amortize the per-epoch checkpoint write
           "--ckpt_interval", "50"]
        + ARMS[args.arm]
    )
    return argv, [a if a != "scratch" else "latest" for a in argv]


def best_argv(args):
    """The best-by-val-Chamfer checkpoint evaluated on the test split."""
    return (
        ab_run.CLI
        + ab_run.BASE
        + ["--workspace", args.workspace, "--iters", str(args.iters)]
        + ARMS[args.arm]
        + ["--ckpt", "best", "--test_eval"]  # last --ckpt wins
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arm", default="fast_dil1", choices=sorted(ARMS))
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--workspace", default=os.path.join(tempfile.gettempdir(), "full_run"))
    ap.add_argument("--kill_at", type=float, nargs="*", default=[0.33, 0.66],
                    help="fractions of the expected train wall-clock at which "
                    "to SIGKILL and resume")
    ap.add_argument("--no_kill", action="store_true")
    ap.add_argument("--eval_interval", type=int, default=1000000,
                    help="epochs between val evals (default: end-only)")
    ap.add_argument("--expected_train_s", type=float, default=480.0,
                    help="estimate used to place the kill points")
    ap.add_argument("--resume", action="store_true",
                    help="keep the existing workspace and continue from the "
                    "latest checkpoint (recovery after an external stall)")
    ap.add_argument("--best_eval", action="store_true",
                    help="after the run, reload the best-by-val-Chamfer "
                    "checkpoint and evaluate it on the test split (the "
                    "reference protocol's model-selection law) — reported "
                    "as 'test_best'")
    ap.add_argument("--stall_timeout_s", type=float, default=900.0,
                    help="watchdog: if the workspace log stops advancing for "
                    "this long mid-segment, SIGKILL and resume")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device_from_env()  # the CLI's rule, before anything starts: raises with no GPU
    ws = args.workspace
    if not args.resume:
        shutil.rmtree(ws, ignore_errors=True)

    argv, resume_argv = train_argv(args)
    kills = [] if args.no_kill else sorted(args.kill_at)
    t_start = time.time()
    segments = []
    n_seg = 1 if args.resume else 0
    log_path = os.path.join(ws, "log_lidar_nerf.txt")

    def wait_watchdog(proc, kill_after, t_seg):
        """'done' | 'kill_point' | 'stalled' (log stopped advancing)."""
        while True:
            timeout = POLL_S
            if kill_after is not None:  # wake at the kill point, not after it
                timeout = min(timeout, max(kill_after - (time.time() - t_seg), 0.0))
            try:
                proc.wait(timeout=timeout)
                return "done"
            except subprocess.TimeoutExpired:
                pass
            if kill_after is not None and time.time() - t_seg >= kill_after:
                return "kill_point"
            # a hang leaves the process alive at zero progress; the log's
            # mtime is the progress signal, measured from the later of its
            # mtime and the segment's start (start-up has no log lines)
            last = max(
                os.path.getmtime(log_path) if os.path.exists(log_path) else 0.0,
                t_seg,
            )
            if time.time() - last > args.stall_timeout_s:
                return "stalled"

    stalls = 0
    while True:
        seg_argv = argv if n_seg == 0 else resume_argv
        kill_after = None
        if kills:
            target = kills[0] * args.expected_train_s
            elapsed = time.time() - t_start
            if target > elapsed:
                kill_after = target - elapsed
        print(f"=== segment {n_seg}: kill_after="
              f"{kill_after and round(kill_after, 1)}", flush=True)
        t0 = time.time()
        proc = subprocess.Popen(
            seg_argv, cwd=ab_run.REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        )
        why = wait_watchdog(proc, kill_after, t0)
        if why == "done":
            segments.append({"dur_s": round(time.time() - t0, 1),
                             "rc": proc.returncode, "killed": False})
            if proc.returncode != 0:
                print(f"segment {n_seg} FAILED rc={proc.returncode}; "
                      f"see {log_path}", flush=True)
                tail = open(log_path).read()[-3000:] if os.path.exists(log_path) else ""
                print(tail, flush=True)
                return 1
            break  # training + eval + test + mesh completed
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        segments.append({"dur_s": round(time.time() - t0, 1),
                         "rc": None, "killed": True, "why": why})
        if why == "kill_point":
            kills.pop(0)
        else:
            stalls += 1
            print(f"segment {n_seg} STALLED (log idle "
                  f">{args.stall_timeout_s}s); resuming", flush=True)
            if stalls > 8:
                print("too many stalls; giving up", flush=True)
                return 1
        n_seg += 1
        # resumed epoch, for the soak evidence
        if os.path.exists(log_path):
            m = re.findall(r"Finished Epoch (\d+)", open(log_path).read())
            print(f"killed at epoch ~{m[-1] if m else '?'}", flush=True)

    total_s = time.time() - t_start
    evals = parse_evals(log_path)
    killed = sum(s["killed"] for s in segments)
    loads = len(re.findall(r"load at epoch \d+", open(log_path).read()))
    if loads < killed:
        print(f"{killed - loads} of {killed} resume(s) found no checkpoint and "
              "restarted from scratch: not a resume soak", flush=True)

    # protocol model selection: reload the best-by-val-Chamfer checkpoint and
    # score the test split with it (the reference's published-number law,
    # --ckpt best)
    test_best = None
    if args.best_eval:
        n_before = len(evals)
        rc = subprocess.call(
            best_argv(args), cwd=ab_run.REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        )
        evals2 = parse_evals(log_path)
        if rc == 0 and len(evals2) > n_before:
            test_best = evals2[-1]
        else:
            print(f"best-ckpt eval failed rc={rc}", flush=True)
    rps = rays_per_sec(log_path)
    txt = open(log_path).read()
    skips = len(re.findall(r"non-finite", txt))
    resumed = re.findall(r"load at epoch (\d+), global step (\d+)", txt)

    result = {
        "arm": args.arm,
        "iters": args.iters,
        "total_wall_s": round(total_s, 1),
        "segments": segments,
        "resume_points": resumed,
        "rays_per_s": rps,
        "nonfinite_log_lines": skips,
        "val": evals[-2] if len(evals) >= 2 else None,
        "test": evals[-1] if evals else None,
        "test_best": test_best,
        "n_evals": len(evals),
        "north_star": {
            "target_min_4chip": 20.0,
            "scaled_min_4chip": round(total_s / 60.0 / 4.0, 1),
        },
    }
    print(json.dumps(result), flush=True)
    # the run's own workspace: successive runs keep their own evidence
    with open(os.path.join(ws, "full_run_result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
