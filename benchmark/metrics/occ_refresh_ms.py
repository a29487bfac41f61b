"""Device time of one --fast occupancy refresh in the training window: the
operations launched in program span `occ.refresh` (`update_occ_grid` on
the grid's cells and the copy into the grid) over its calls."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.device_spans(ctx) if ctx.kind == "train" else None
    if not spans or not spans.get("occ.refresh", {}).get("calls"):
        return None
    return 1e3 * spans["occ.refresh"]["device_s"] / spans["occ.refresh"]["calls"]
