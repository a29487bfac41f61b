"""Device time a served pano of the operations launched in the render's
sampling stage (program span `render.sample`: the rays' nears and fars, the
coarse depths, the coarse weights, `sample_pdf` and the sort)."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.device_spans(ctx) if ctx.kind == "serve" and ctx.units else None
    if not spans or "render.sample" not in spans:
        return None
    return 1e3 * spans["render.sample"]["self_device_s"] / ctx.units
