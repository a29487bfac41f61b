"""Kernel B1 (`csrc/block_hash_fwd.cu`) in the training window: the sum of
its calls' bounds (`bounds.fwd_ms` on the cell's own queries: the coarse and
fine samples of a step, and under --fast the grid refresh's cells) over its
device time."""


def read(ctx):
    t = ctx.time_s.get("b1")
    if ctx.kind != "train" or not t:
        return None
    return 100.0 * ctx.work["b1_ms"] / 1e3 / t
