"""Summarize a protocol-cadence run's workspace log into a markdown table
(counterpart of tools/protocol_report.py).

    python -m lidarnerf_tpu_torch.tools.protocol_report WORKSPACE

Parses the trainer log for the per-eval meter blocks (val cadence), the
best-checkpoint transitions, the final val/test evals, and — when
`lidarnerf_tpu_torch.tools.full_run --best_eval` appended one — the
best-ckpt test eval, and prints (a) the val-Chamfer trajectory, (b) a
metrics table row per final block, (c) the steady-state training rate, then
echoes the workspace's `full_run_result.json`. The port's trainer writes
the JAX trainer's log lines, so either package's workspace reads alike.
Host only: no device is touched.
"""

import json
import os
import re
import sys
import tempfile


def parse_blocks(txt):
    """Every eval block in order: dict with epoch + meters."""
    blocks = []
    cur = None
    for line in txt.splitlines():
        m = re.match(r"\+\+> Evaluate at epoch (\d+)", line)
        if m:
            cur = {"epoch": int(m.group(1))}
            continue
        if cur is None:
            continue
        m = re.match(r"MAE = ([\d.eE+-]+)", line)
        if m:
            cur["mae"] = float(m.group(1))
        m = re.match(r"RMSE = ([\d.eE+-]+)", line)
        if m:
            cur["rmse"] = float(m.group(1))
        m = re.match(r"Depth_error\(rmse, a1, a2, a3, ssim\) = \[([^\]]+)\]", line)
        if m:
            v = [float(x) for x in m.group(1).split()]
            cur.update(depth_rmse=v[0], a1=v[1], a2=v[2], a3=v[3], ssim=v[4])
        m = re.match(r"CD f-score = \[([^\]]+)\]", line)
        if m:
            v = [float(x) for x in m.group(1).split()]
            cur.update(chamfer=v[0], fscore=v[1])
        if "Evaluate epoch" in line and "Finished" in line:
            m = re.search(r"\((\d+\.\d+)s", line)
            if m:
                cur["eval_s"] = float(m.group(1))
            blocks.append(cur)
            cur = None
    return blocks


def main(ws):
    txt = open(os.path.join(ws, "log_lidar_nerf.txt")).read()
    blocks = parse_blocks(txt)
    rates = [float(x) for x in re.findall(r"\((\d+) rays/s", txt)]
    best = re.findall(r"New best result: [\S]+ --> ([\d.]+)", txt)

    print("## val Chamfer trajectory")
    for b in blocks:
        if "chamfer" in b:
            tag = f" ({b['eval_s']:.0f}s)" if "eval_s" in b else ""
            print(f"  ep{b['epoch']:5d}  chamfer={b['chamfer']:.4f}  "
                  f"F={b.get('fscore', float('nan')):.4f}{tag}")
    if best:
        print(f"\nbest val Chamfer (checkpointed): {best[-1]}")
    if rates:
        mid = sorted(rates)[len(rates) // 2]
        print(f"median train rate: {mid:.0f} rays/s/chip")

    cols = ["mae", "rmse", "depth_rmse", "a1", "a2", "a3", "ssim", "chamfer",
            "fscore"]
    print("\n## final eval blocks (last 3: end-val, end-test, best-ckpt test)")
    print("| block | " + " | ".join(cols) + " |")
    print("|" + "---|" * (len(cols) + 1))
    for b in blocks[-3:]:
        row = " | ".join(
            f"{b[c]:.4f}" if c in b else "-" for c in cols
        )
        print(f"| ep{b['epoch']} | {row} |")

    rj = os.path.join(ws, "full_run_result.json")
    if os.path.exists(rj):
        print("\nfull_run_result.json:")
        print(json.dumps(json.load(open(rj)), indent=1)[:2000])


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(tempfile.gettempdir(), "full_run"))
