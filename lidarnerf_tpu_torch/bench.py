"""Benchmark: composited ray-samples/s per GPU on the real training step
(counterpart of the repo's bench.py).

    python -m lidarnerf_tpu_torch.bench

Runs the full KITTI-360-class training step (4096 rays x (768 + 64)
samples, block-hash grid desired_res=32768 / 2^19 table, bf16 matmuls,
grad_loss patch regularizer) on synthetic data and reports throughput
against the target of 5M composited ray-samples/s per chip (BASELINE.md).
The model, configs, data and step schedule are bench.py's: 4 frames at
identity poses, images from `np.random.RandomState(0)`, flat and [2, 8]-patch
steps alternating on frame i % 4, 3 warm-up steps, then 30 timed, each run
of steps ended by one host read of the loss.

The step is the trainer's: `nerf/train_step.py::make_epoch_step`, one epoch
function per patch size sharing one `DeviceAdam`, each called with a
one-step epoch. On CUDA each captures its step as a CUDA graph at its first
call (an eager warm-up step, then the capture) and replays it afterwards,
so the two graphs alternate step by step, as the trainer's alternate epoch
by epoch; they share one graph pool and replay one after another. On the
CPU (`LIDARNERF_PLATFORM=cpu` or `main(device="cpu")`) the steps run
eagerly; without either a GPU is needed. The draws come from a
`torch.Generator` seeded with 0 on the step's device.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""

import json
import time

import numpy as np
import torch

from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.renderer import RenderConfig
from lidarnerf_tpu_torch.nerf import train_step
from lidarnerf_tpu_torch.nerf.train_step import TrainConfig

H, W = 66, 1030
NUM_RAYS = 4096
NUM_STEPS, UPSAMPLE = 768, 64
FRAMES = 4
PATCHES = (1, [2, 8])  # step i takes PATCHES[i % 2], as bench.py alternates them
WARMUP, TIMED = 3, 30
TARGET = 5e6  # composited ray-samples/s per chip (BASELINE.md)


def driver_device(device=None):
    """`device` if given, else the CLI's rule (`main_lidarnerf.device_from_env`):
    CUDA, raising without a GPU, unless LIDARNERF_PLATFORM=cpu."""
    if device is not None:
        return torch.device(device)
    from lidarnerf_tpu_torch.main_lidarnerf import device_from_env

    return device_from_env()


def flagship(seed=0):
    """The KITTI-360-class model (bench.py:29-35), its init drawn from `seed`."""
    return NeRFNetwork(
        encoding="blockhash",  # kernels B1 (forward) and B2 (table gradient) on CUDA
        desired_resolution=32768,
        log2_hashmap_size=19,
        bound=1.0,
        compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(seed),
    )


def configs():
    """(TrainConfig, RenderConfig) of bench.py:36-50."""
    tcfg = TrainConfig(
        alpha_d=1000.0,
        alpha_i=10.0,
        alpha_grad=100.0,
        grad_loss=True,
        scale=0.0108,
        num_rays_lidar=NUM_RAYS,
        H_lidar=H,
        W_lidar=W,
        intrinsics_lidar=(2.0, 26.9),
        iters=30000,
    )
    rcfg = RenderConfig(num_steps=NUM_STEPS, upsample_steps=UPSAMPLE, min_near_lidar=0.0108,
                        bound=1.0)
    return tcfg, rcfg


def frames():
    """(poses [4, 4, 4], images [4, H, W, 3]) float32, as bench.py:55-61 makes them."""
    rng = np.random.RandomState(0)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (FRAMES, 4, 4)).copy()
    images = rng.rand(FRAMES, H, W, 3).astype(np.float32)
    images[..., 2] *= 0.6
    return poses, images


class Bench:
    """The flagship model, its DeviceAdam and one epoch function per patch
    size on `device`; `capture=False` runs the steps eagerly on CUDA too."""

    def __init__(self, device=None, capture=True, seed=0):
        self.device = driver_device(device)
        self.model = flagship(seed).to(self.device)
        self.tcfg, self.rcfg = configs()
        self.optimizer = train_step.make_optimizer(self.model.named_parameters(), self.tcfg)
        pool = (train_step.GraphPool(self.device)
                if capture and self.device.type == "cuda" else None)
        self.epoch_fns = [
            train_step.make_epoch_step(self.model, self.tcfg, self.rcfg, patch_size=p,
                                       optimizer=self.optimizer, device=self.device,
                                       capture=capture, graph_pool=pool)
            for p in PATCHES
        ]
        poses, images = frames()
        self.poses = torch.from_numpy(poses).to(self.device)
        self.images = torch.from_numpy(images).to(self.device)
        self.valid_idx = torch.zeros((FRAMES, 1), dtype=torch.long, device=self.device)
        self.valid_counts = torch.full((FRAMES,), H * W, dtype=torch.long, device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def run(self, n):
        """Steps i = 0 .. n-1 (patch PATCHES[i % 2], frame i % 4, global
        step i), then one host read of the last loss, which must be finite.
        Returns the n losses, on the device."""
        losses = []
        for i in range(n):
            m = self.epoch_fns[i % 2](self.poses, self.images, self.valid_idx,
                                      self.valid_counts, np.array([i % FRAMES]), step0=i,
                                      generator=self.generator)
            losses.append(m["loss"])
        losses = torch.cat(losses)
        last = float(losses[-1])  # the host read is the completion barrier
        if not np.isfinite(last):
            raise FloatingPointError(f"the bench step's loss is {last}")
        return losses


def main(device=None):
    """Run the benchmark and print its JSON line. Returns the printed dict and
    the losses of every step, the warm-up's first, on the device."""
    bench = Bench(device)
    warm = bench.run(WARMUP)  # the kernels' build, each graph's warm-up step and capture
    t0 = time.perf_counter()
    timed = bench.run(TIMED)
    dt = time.perf_counter() - t0

    samples_per_step = NUM_RAYS * (NUM_STEPS + UPSAMPLE)
    n_chips = 1  # one GPU
    value = TIMED * samples_per_step / dt / n_chips
    result = {
        "metric": "composited_ray_samples_per_sec_per_chip",
        "value": round(value),
        "unit": "samples/s/chip",
        "vs_baseline": round(value / TARGET, 3),
    }
    print(json.dumps(result))
    return result, torch.cat([warm, timed])


if __name__ == "__main__":
    main()
