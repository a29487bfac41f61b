"""Idle device time a training step while the host had not yet launched
the next operation, given to the program spans the host was in (the part
in the harness left out; `program_spans.SpanReading`)."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.device_spans(ctx) if ctx.kind == "train" and ctx.units else None
    if not spans:
        return None
    return 1e3 * ctx.idle_late_s / ctx.units
