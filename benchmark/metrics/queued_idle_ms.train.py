"""Idle device time a training step before operations that the host had
already launched from inside a program span: the device's own latency
between queued operations and graph replays (`program_spans.SpanReading`)."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.device_spans(ctx) if ctx.kind == "train" and ctx.units else None
    if not spans:
        return None
    return 1e3 * ctx.idle_queued_s / ctx.units
