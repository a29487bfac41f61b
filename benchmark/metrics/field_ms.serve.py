"""Device time a served pano of the operations launched in the render's
field stage (program span `render.field`: both density queries, the
direction encoding and the colour head; B1 and the GEMMs among them)."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.device_spans(ctx) if ctx.kind == "serve" and ctx.units else None
    if not spans or "render.field" not in spans:
        return None
    return 1e3 * spans["render.field"]["self_device_s"] / ctx.units
