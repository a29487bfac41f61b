"""The occupancy bin lookup (P12) checked and timed against torch.take
(counterpart of tools/exp_occ_lookup.py).

    python -m lidarnerf_tpu_torch.tools.exp_occ_lookup

Draws the JAX tool's inputs from `np.random.RandomState(0)` in its order (a
128^3 float32 grid, then 4096 x 128 int32 cell indices, uniform), looks
them up through `ops/occ_lookup.py::occ_lookup` (on CUDA the hand-written
kernel `csrc/occ_lookup.cu`, given the grid as its [G*G, G] rows as the
TPU kernel is) and through `torch.take`, and prints the largest difference,
then each one's device time per call. Each is a few microseconds on the
card, less than the host takes to enqueue a call, so back-to-back calls
from Python would time the host: instead `BATCH` calls are captured in one
CUDA graph, and CUDA events time its replays after a warm-up (the median
replay over `BATCH`). `torch.take`'s int64 index is cast once, outside the
timed calls. Runs on CUDA unless `main` is given `device="cpu"`, which
checks the plain version and times nothing. Nothing runs at import.
"""

import argparse

import numpy as np
import torch

from lidarnerf_tpu_torch.ops import device_counts, occ_lookup_cuda
from lidarnerf_tpu_torch.ops.dispatch import resolve_device
from lidarnerf_tpu_torch.ops.occ_lookup import occ_lookup

G = 128
N, K = 4096, 128  # rays x bins: the --fast step's lookups
BATCH = 100  # calls in the timed graph


def inputs():
    """(grid [G, G, G] float32, idx [N * K] int32) as the JAX tool draws them."""
    rng = np.random.RandomState(0)
    grid = rng.rand(G, G, G).astype(np.float32)
    idx = rng.randint(0, G**3, size=N * K).astype(np.int32)
    return grid, idx


def device_ms(fn, replays=5):
    """Device ms of one fn() call: `BATCH` calls captured back to back in a
    CUDA graph, the median over `replays` replays between two CUDA events,
    over `BATCH`. The count on the card is paused: the graph holds the
    kernels alone."""
    with device_counts.paused():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(BATCH):
                fn()
        graph.replay()
        times = []
        for _ in range(replays):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / BATCH)
    return float(np.median(times))


def main(argv=None, device=None):
    """Check and time; returns {"device", "max_abs_diff", "bit_equal",
    "kernel_ms", "take_ms", "launches"} (the times None on the CPU).
    `launches` counts the wrapper's calls: the check's, and on the card each
    timed graph's warm-up and captured calls."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    dev = resolve_device(device)
    grid_np, idx_np = inputs()
    grid = torch.from_numpy(grid_np).to(dev)
    grid2d = grid.reshape(G * G, G)
    idx = torch.from_numpy(idx_np).to(dev)
    idx_long = idx.long()

    before = occ_lookup_cuda.launches
    a = occ_lookup(idx, grid2d)
    b = torch.take(grid, idx_long)
    diff = float((a - b).abs().max())
    result = {"device": str(dev), "max_abs_diff": diff,
              "bit_equal": torch.equal(a.view(torch.int32), b.view(torch.int32)),
              "kernel_ms": None, "take_ms": None}
    print(f"max abs diff: {diff}", flush=True)
    if dev.type != "cuda":
        print("occ_lookup: not timed (plain version on the CPU)", flush=True)
    else:
        result["kernel_ms"] = device_ms(lambda: occ_lookup(idx, grid2d))
        print(f"occ_lookup kernel: {result['kernel_ms']:.5f} ms", flush=True)
        result["take_ms"] = device_ms(lambda: torch.take(grid, idx_long))
        print(f"torch.take: {result['take_ms']:.5f} ms", flush=True)
    result["launches"] = occ_lookup_cuda.launches - before
    return result


if __name__ == "__main__":
    main()
