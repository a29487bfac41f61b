"""Kernel B1 (`csrc/block_hash_fwd.cu`) in the serving window: the sum of
its calls' bounds (`bounds.fwd_ms` on the cell's own queries: the coarse and
fine samples of each chunk of a pano, padding left out) over its device time."""


def read(ctx):
    t = ctx.time_s.get("b1")
    if ctx.kind != "serve" or not t:
        return None
    return 100.0 * ctx.work["b1_ms"] / 1e3 / t
