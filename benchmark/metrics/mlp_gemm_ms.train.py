"""Device time of the GEMM kernels (the MLPs' products, forward and
backward) a training step."""


def read(ctx):
    t = ctx.time_s.get("gemm")
    if ctx.kind != "train" or not t or not ctx.units:
        return None
    return 1e3 * t / ctx.units
