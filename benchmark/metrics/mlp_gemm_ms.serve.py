"""Device time of the GEMM kernels (the MLPs' products, forward only) a
served pano."""


def read(ctx):
    t = ctx.time_s.get("gemm")
    if ctx.kind != "serve" or not t or not ctx.units:
        return None
    return 1e3 * t / ctx.units
