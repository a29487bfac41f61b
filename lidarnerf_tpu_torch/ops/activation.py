"""Truncated exponential activation (counterpart of lidarnerf_tpu/ops/activation.py:23-36).

Forward: exp(min(x, 80)) in float32 — the clip keeps a saturated density
finite (exp(80) = 5.5e34), so compositing never meets 0 * inf.
Backward: grad * exp(clamp(x, -15, 15)), so gradients never overflow.
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=80.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
