"""The training steps' matmul operations (the sigma net and the LiDAR head on
every sample, forward and two backward products: x 3) over the traced
window's time, against the H100's 989 TFLOP/s in bf16."""

from benchmark.bounds import BF16_FLOPS


def read(ctx):
    if ctx.kind != "train" or not ctx.work.get("model_flops"):
        return None
    return 100.0 * ctx.work["model_flops"] / ctx.window_s / BF16_FLOPS
