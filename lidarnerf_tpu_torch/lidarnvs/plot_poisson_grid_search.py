"""Plot the Poisson (depth, min_density) grid-search Chamfer matrix (copy of
lidarnvs/plot_poisson_grid_search.py).

    python -m lidarnerf_tpu_torch.lidarnvs.plot_poisson_grid_search [json_path] [out_path]

Reads poisson_grid_search.json [{poisson_depth, poisson_min_density,
chamfer}, ...] and renders a heatmap of the Chamfer per configuration.
matplotlib is imported by `plot` only.
"""
import json
import sys

import numpy as np


def plot(json_path="poisson_grid_search.json", out_path="poisson_grid_search.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(json_path) as f:
        rows = json.load(f)
    depths = sorted({r["poisson_depth"] for r in rows})
    dens = sorted({r["poisson_min_density"] for r in rows})
    mat = np.full((len(depths), len(dens)), np.nan)
    for r in rows:
        i = depths.index(r["poisson_depth"])
        j = dens.index(r["poisson_min_density"])
        mat[i, j] = r["chamfer"]

    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(mat, cmap="viridis")
    ax.set_xticks(range(len(dens)), [f"{d:g}" for d in dens])
    ax.set_yticks(range(len(depths)), [str(d) for d in depths])
    ax.set_xlabel("min_density")
    ax.set_ylabel("poisson depth")
    ax.set_title("Poisson grid search: Chamfer distance")
    for i in range(len(depths)):
        for j in range(len(dens)):
            if np.isfinite(mat[i, j]):
                ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center",
                        color="w", fontsize=8)
    fig.colorbar(im)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    print(f"saved {out_path}")


if __name__ == "__main__":
    plot(*sys.argv[1:])
