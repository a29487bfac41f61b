"""lidarnerf_tpu_torch — the PyTorch/CUDA port of lidarnerf_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (`ops/`, `models/`, `dataset/`,
`nerf/`, `utils/`) and its function names, so each function has a findable
counterpart there. It imports `torch` and numpy only, never JAX or anything of
`lidarnerf_tpu`.

Every TPU (Pallas) kernel on a ported path is a hand-written CUDA kernel here,
built at first use from `csrc/` into `_build/`; beside it stays a plain
PyTorch version of the same function. A CUDA tensor always takes the kernel,
a CPU tensor the plain version (`ops/dispatch.py`).

Ported so far:
- full-pano LiDAR inference rendering (`nerf/infer.PanoRenderer`) with the
  block-hash forward kernel B1 (`csrc/block_hash_fwd.cu`);
- training (`nerf/train_step.make_epoch_step` over `make_train_step`, a
  CUDA graph of the step on the card; `nerf/trainer.Trainer`,
  `dataset/kitti360.KITTI360Dataset`) with the block-hash backward kernel
  B2 (`csrc/block_hash_bwd.cu`), whose table gradient is the same bit for
  bit from run to run, as the JAX package's;
- the run-collapsing encoder variants on both paths
  (`LIDARNERF_SEG_KERNELS=1`: B3a/B3b, `LIDARNERF_WIN_KERNELS=1`: B4a/B4b,
  `csrc/block_hash_{seg,win}_{fwd,bwd}.cu`);
- occupancy-prior sampling (`--fast`, `models/occupancy.py`) on both paths;
- the fused MLP B5 (`ops/fused_mlp.py`, `csrc/fused_mlp.cu`) and the
  permutation gather B6 of `ops/sampling.sort_merge_z` (`csrc/perm_gather.cu`);
- the CLI (`python -m lidarnerf_tpu_torch.main_lidarnerf`, the counterpart
  of `main_lidarnerf.py`) and the trainer's workspace: evaluation with the
  LiDAR meters (`nerf/metrics.py`, `ops/chamfer.py`), test panos and point
  clouds, mesh export, checkpoints that each package reads, and resume;
- NeRF-MVL (`dataset/nerfmvl.NeRFMVLDataset`, `--dataloader nerf_mvl`):
  masked pixel sampling on the device, crop meters, test clouds cropped to
  each frame's OBB (`utils/geometry.py`), and a synthetic NeRF-MVL car
  traced on the card (`tools/make_synth_mvl.py`);
- the data on-ramp (`preprocess/`, `native/`, `tools/check_dataset.py`,
  `tools/make_synth_drive.py`): raw KITTI-360 / NeRF-MVL trees -> range-view
  panos (a host C++ projection built with g++ at first use, else numpy) ->
  transforms JSON -> scene constants, with no JAX on the machine;
- every position encoding of the JAX model (`ops/hash_grid.py`, the
  default `hashgrid` and `tiledgrid`; `ops/periodic_volume.py`; frequency;
  None; `ops/factory.get_encoder`), plain PyTorch with an order-free table
  gradient (`ops/order_free.py`), and RGB rendering with the background
  sphere (`models/renderer.py`, `dataset/base.get_rays`).
"""

__version__ = "0.1.0"
