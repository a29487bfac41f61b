"""lidarnerf_tpu_torch — the PyTorch/CUDA port of lidarnerf_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (`ops/`, `models/`, `dataset/`,
`nerf/`, `utils/`) and its function names, so each function has a findable
counterpart there. It imports `torch` and numpy only, never JAX or anything of
`lidarnerf_tpu`.

Every TPU (Pallas) kernel on a ported path is a hand-written CUDA kernel here,
built at first use from `csrc/` into `_build/`; beside it stays a plain
PyTorch version of the same function. A CUDA tensor always takes the kernel,
a CPU tensor the plain version (`ops/dispatch.py`).

Ported so far: full-pano LiDAR inference rendering (`nerf/infer.PanoRenderer`)
with the block-hash forward kernel (`csrc/block_hash_fwd.cu`), and training
(`nerf/train_step.make_train_step`, `nerf/trainer.Trainer`,
`dataset/kitti360.KITTI360Dataset`) with the block-hash backward kernel
(`csrc/block_hash_bwd.cu`) for the table gradient.
"""

__version__ = "0.1.0"
