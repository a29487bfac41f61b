"""Kernel B2 (`csrc/block_hash_bwd.cu`, the table gradient) in the training
window: the sum of its calls' bounds (`bounds.bwd_ms`: the coarse and fine
queries of each step) over its device time."""


def read(ctx):
    t = ctx.time_s.get("b2")
    if ctx.kind != "train" or not t:
        return None
    return 100.0 * ctx.work["b2_ms"] / 1e3 / t
