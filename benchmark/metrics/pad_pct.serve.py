"""The share of the rays rendered in the serving window that were padding
(the program's counters `pano.rays_padded` over `pano.rays_rendered`: the
last chunk of a pano filled up to the chunk's size)."""

from benchmark import program_spans


def read(ctx):
    if ctx.kind != "serve":
        return None
    counters = program_spans.read(ctx).counters
    if not counters.get("pano.rays_rendered"):
        return None
    return 100.0 * counters.get("pano.rays_padded", 0) / counters["pano.rays_rendered"]
