"""The comparison that decides `correct`: the numbers the program's timed
path gives against the plain reference's, each beside its limit
(`benchmark/limits/<cell>.json`, set from the readings that PERF.md lists).

Training cells compare the check (`train.check_plan`): the eager steps, one
of each patch size, then the first steps of the first epoch, replays of the
graph that the window replays:
- `loss_gap`: the largest |program - reference| / |reference| of a step's
  loss, each epoch step's read from the epoch's metrics; every loss after
  the first follows every update before it;
- `change_gap`: over the leaves, the largest gap between the program's norm
  of the parameters' change over the eager steps and the reference's, over
  the reference's norm of that leaf's change or of the median leaf's,
  whichever is larger;
- `grad_diff`: over the MLPs' leaves, the largest norm of the difference
  between the program's first gradient (Adam's first moment after one step
  over 1 - b1) and the reference's, over the reference's norm of that leaf
  or of the median leaf, whichever is larger. The table's gradient is held
  by the losses and its change instead, and the gap of two norms is not
  compared: no control or fault reads far enough above the sound runs on
  either (PERF.md);
- under `--fast`, `grid_gap`: mean |program - reference| over mean |reference|
  of the occupancy grid after its first refresh; and `grid_unchanged`, the
  program's alone: the share of the grid's cells that the refreshes made in
  place between the first epoch's replays left at their value after the
  first refresh (1 where they were stale).
A leaf whose reference gradient is under a thousandth of the median leaf's
(the RGB head, which LiDAR rays never run) moves by round-off alone and is
left out of `grad_diff` and `change_gap`.

Serving cells compare the sampled panos, the largest over them of
`depth_gap` (mean |program - reference| over mean |reference|),
`raydrop_gap` and `intensity_gap` (mean |program - reference|).
"""

import numpy as np

from benchmark.common import BENCH_DIR, load_json

TABLE = "hash_table"


def leaf_gap(prog, refr, keep):
    med = float(np.median(list(refr.values())))
    return max(abs(prog[n] - refr[n]) / max(refr[n], med) for n in keep)


def moving_leaves(ref_grad):
    med = float(np.median(list(ref_grad.values())))
    return [n for n, g in ref_grad.items() if g >= 1e-3 * med]


def grad_diffs(prog, refr):
    """{leaf: |program's first gradient - reference's| / max(|reference's|, median)}
    over the moving leaves."""
    med = float(np.median(list(refr["first_grad"].values())))
    gp, gr = prog["first_grad_full"], refr["first_grad_full"]
    return {n: float((gp[n].to(gr[n].device).double() - gr[n].double()).norm())
            / max(refr["first_grad"][n], med) for n in moving_leaves(refr["first_grad"])}


def train_numbers(prog, refr):
    keep = moving_leaves(refr["first_grad"])
    out = {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], refr["losses"])),
        "grad_diff": max(v for n, v in grad_diffs(prog, refr).items() if n != TABLE),
        "change_gap": leaf_gap(prog["change"], refr["change"], keep),
    }
    if "grid" in refr:
        g, r = prog["grid"].double(), refr["grid"].double()
        out["grid_gap"] = float((g - r).abs().mean() / r.abs().mean())
    if "grid_epoch" in prog:
        out["grid_unchanged"] = float((prog["grid_epoch"] == prog["grid"]).double().mean())
    return out


def pano_numbers(prog, refr):
    """prog, refr: (raydrop, intensity, depth) [H, W] arrays of one pano."""
    (pr, pi, pd), (rr, ri, rd) = prog, refr
    return {"depth_gap": float(np.abs(pd - rd).mean() / np.abs(rd).mean()),
            "raydrop_gap": float(np.abs(pr - rr).mean()),
            "intensity_gap": float(np.abs(pi - ri).mean())}


def worst(readings):
    return {k: max(r[k] for r in readings) for k in readings[0]}


def limits(cell_name):
    path = BENCH_DIR / "limits" / f"{cell_name}.json"
    return {k: v for k, v in load_json(path).items() if not k.startswith("_")}


def judge(numbers, lim):
    """(correct, {name: {"value", "limit"}}); a number without a limit fails."""
    table = {k: {"value": v, "limit": lim.get(k)} for k, v in numbers.items()}
    ok = all(t["limit"] is not None and np.isfinite(t["value"]) and t["value"] <= t["limit"]
             for t in table.values())
    return ok, table
