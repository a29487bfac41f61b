"""Data parallelism and the row-sharded table over torch.distributed (parallel/sharding.py)."""

from lidarnerf_tpu_torch.parallel.sharding import (
    make_mesh,
    make_sharded_train_step,
    replicate,
    shard_rays,
)

__all__ = ["make_mesh", "make_sharded_train_step", "replicate", "shard_rays"]
