"""Sensor-rate rendering benchmark: full-pano LiDAR frames per second
(counterpart of tools/bench_render.py).

    python -m lidarnerf_tpu_torch.tools.bench_render

The stretch goal from BASELINE.json configs[4]: can the trained model render
novel 64-beam panos at sensor rate (10 Hz)? Measures staged full-frame
inference (KITTI 66x1030 = 67,980 rays x 832 samples) of the flagship model
(seed-0 weights) at the identity pose through
`models/renderer.py::render_rays_staged` in 8192-ray chunks: one warm-up
frame, then the mean of 5, each ended by a host read of the depth sum. Runs
on CUDA unless LIDARNERF_PLATFORM=cpu or `main(device="cpu")` asks for the
CPU.

Prints one JSON line: {"metric": "pano_fps", ...}.
"""

import json
import time

import torch

from lidarnerf_tpu_torch.bench import driver_device, flagship
from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays_staged

H, W = 66, 1030
INTRINSICS = (2.0, 26.9)
CHUNK = 8192  # the JAX tool's chunk (the CLI's --max_ray_batch default is 4096)
FRAMES = 5


def setup(num_steps=768, upsample_steps=64, device=None):
    """(model, RenderConfig, rays_o [H*W, 3], rays_d [H*W, 3]) of the benchmark
    on `device`: the seed-0 flagship model at the identity pose."""
    device = driver_device(device)
    model = flagship(0).to(device).eval()
    cfg = RenderConfig(num_steps=num_steps, upsample_steps=upsample_steps, min_near_lidar=0.01,
                       bound=1.0)
    pose = torch.eye(4, device=device)[None]
    rays = get_lidar_rays(pose, INTRINSICS, H, W, N=-1)
    return model, cfg, rays["rays_o"][0], rays["rays_d"][0]


def main(num_steps=768, upsample_steps=64, device=None):
    """Time the panos and print the JSON line; returns the printed dict."""
    model, cfg, ro, rd = setup(num_steps, upsample_steps, device)

    def frame():
        out = render_rays_staged(model, ro, rd, cfg, chunk=CHUNK)
        return float(torch.sum(out["depth"]))  # device-to-host completion barrier

    frame()  # warm-up: the kernels' build and the allocator's first blocks
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        frame()
    dt = (time.perf_counter() - t0) / FRAMES
    result = {
        "metric": "pano_fps",
        "value": round(1.0 / dt, 3),
        "unit": "full 66x1030 panos/s",
        "vs_baseline": round((1.0 / dt) / 10.0, 3),  # 10 Hz sensor rate
        "samples_per_sec": round(H * W * (num_steps + upsample_steps) / dt),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
