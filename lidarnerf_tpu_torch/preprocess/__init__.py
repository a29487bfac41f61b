"""The data on-ramp: raw KITTI-360 / NeRF-MVL -> range-view panos ->
transforms_*.json -> scene constants (counterpart of lidarnerf_tpu/preprocess
and the repo's preprocess/*.py command lines, which are modules here:
`python -m lidarnerf_tpu_torch.preprocess.<name>`)."""

from pathlib import Path

# the checkout's root, whose data/ the command lines default to (the JAX
# scripts' Path(__file__).parent.parent, one level up from preprocess/)
PROJECT_ROOT = Path(__file__).resolve().parents[2]
