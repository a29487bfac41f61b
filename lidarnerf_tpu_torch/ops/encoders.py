"""Frequency (NeRF positional) encoder (counterpart of lidarnerf_tpu/ops/encoders.py:21-41).

Output layout [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], the D
input dims kept together in each block, C = D + 2*D*degree.
"""

import torch


def frequency_encoding_dim(input_dim: int, degree: int) -> int:
    return input_dim + 2 * input_dim * degree


def frequency_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """[..., D] -> [..., D + 2*D*degree]."""
    outs = [x]
    for f in range(degree):
        scaled = x * (2.0**f)
        outs.append(torch.sin(scaled))
        outs.append(torch.cos(scaled))
    return torch.cat(outs, dim=-1)
