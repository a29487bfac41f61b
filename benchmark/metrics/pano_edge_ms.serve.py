"""Device time a served pano of the operations launched in the serving entry
outside the chunks' renders: in program span `pano.frame` but in no
`pano.chunk` (the rays, the padding, the gathers, the copy to the host)."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.device_spans(ctx) if ctx.kind == "serve" and ctx.units else None
    if not spans or "pano.frame" not in spans:
        return None
    chunks = spans.get("pano.chunk", {}).get("device_s", 0.0)
    return 1e3 * (spans["pano.frame"]["device_s"] - chunks) / ctx.units
