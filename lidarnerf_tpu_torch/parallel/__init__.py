"""Data parallelism and the row-sharded table over torch.distributed (parallel/sharding.py)."""
