"""Device time a training step of every operation outside B1, B2, the GEMMs,
the fused sampler and the fused Adam: the render's elementwise, mask,
sort and reduction kernels, the losses, copies and fills."""


def read(ctx):
    t = ctx.time_s.get("other")
    if ctx.kind != "train" or not t or not ctx.units:
        return None
    return 1e3 * t / ctx.units
