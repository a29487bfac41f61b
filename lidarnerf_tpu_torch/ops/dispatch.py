"""Device choice and kernel dispatch.

Counterpart of lidarnerf_tpu/ops/dispatch.py:24-45, with one rule instead of
a platform guess: a CUDA tensor takes the hand-written kernel, a CPU tensor
takes the plain PyTorch version. There is no switch that sends CUDA tensors
to the plain path, and no silent fallback to the CPU: an entry point that is
not told `device="cpu"` needs a GPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def uses_kernel(t: torch.Tensor) -> bool:
    """True iff `t` lies on a CUDA device, i.e. the kernel path serves it."""
    return t.device.type == "cuda"
