"""The fused --fast sampler (`csrc/occ_sample.cu`) in the training window:
its bound (`bounds.occ_sample_ms` on a step's rays) a call over its device
time a call."""


def read(ctx):
    t = ctx.time_s.get("occ_sample")
    if ctx.kind != "train" or not t or "occ_sample_ms" not in ctx.work:
        return None
    return 100.0 * ctx.work["occ_sample_ms"] / 1e3 / t
