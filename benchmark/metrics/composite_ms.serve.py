"""Device time a served pano of the operations launched in the render's
compositing stage (program span `render.composite`, the colour queries
inside it left out: the merged weights, the weight masks, the depth, image
and weight sums)."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.device_spans(ctx) if ctx.kind == "serve" and ctx.units else None
    if not spans or "render.composite" not in spans:
        return None
    return 1e3 * spans["render.composite"]["self_device_s"] / ctx.units
