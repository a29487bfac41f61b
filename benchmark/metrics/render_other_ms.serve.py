"""Device time a served pano of every operation outside B1, B2, the GEMMs,
the fused sampler and the fused Adam: the render's elementwise, mask,
sort and reduction kernels, copies (the pano to the host) and fills."""


def read(ctx):
    t = ctx.time_s.get("other")
    if ctx.kind != "serve" or not t or not ctx.units:
        return None
    return 1e3 * t / ctx.units
