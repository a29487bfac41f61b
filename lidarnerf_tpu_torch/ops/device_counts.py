"""Kernel launches counted on the card.

A wrapper's own count (`launch_counts()` of each `*_cuda` module) sees a
launch where Python calls the wrapper. A replay of a CUDA graph runs no
Python, so that count sees a graph's eager warm-up and its capture, never a
replay. With counting on (`enable(device)`), each wrapper also adds one to its
kernel's slot of an int64 tensor on the launch's device, on the launch's
stream, right after the launch: a capture records that add beside the
kernel, so every replay counts as well.

The slots live as long as the process: a graph captured with counting on
holds their address, so `reset()` zeroes them in place and `paused()`
stops new adds within a block without freeing them. `counts()` reads them
back, a host read that must stay outside a capture. Off (the default), a
wrapper adds nothing and launches nothing more.
"""

import contextlib

import torch

KERNELS = ("block_hash_fwd", "block_hash_bwd", "block_hash_seg_fwd", "block_hash_seg_bwd",
           "block_hash_win_fwd", "block_hash_win_bwd", "fused_mlp", "perm_gather_fwd",
           "perm_gather_bwd", "occ_lookup")
_INDEX = {name: i for i, name in enumerate(KERNELS)}

_slots = {}  # torch.device -> int64 [len(KERNELS)] on it, kept for the process's life
_on = False


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def enable(device="cuda"):
    """Count launches on `device` (and on every device enabled before)."""
    global _on
    device = _device(device)
    if device not in _slots:
        _slots[device] = torch.zeros(len(KERNELS), dtype=torch.int64, device=device)
    _on = True


@contextlib.contextmanager
def paused():
    """No adds within the block (such as around a kernel being timed)."""
    global _on
    was, _on = _on, False
    try:
        yield
    finally:
        _on = was


def add(name: str, device):
    """One launch of kernel `name` on `device`: a wrapper calls this right
    after it launches, on the stream it launched on (the current one)."""
    if _on:
        slots = _slots.get(device)
        if slots is not None:
            slots[_INDEX[name]].add_(1)


def reset():
    """Zero every slot in place (no allocation: captured adds keep their target)."""
    for slots in _slots.values():
        slots.zero_()


def counts() -> dict:
    """{kernel name: launches counted on every enabled device since the last reset()}."""
    total = dict.fromkeys(KERNELS, 0)
    for slots in _slots.values():
        for name, n in zip(KERNELS, slots.tolist()):
            total[name] += n
    return total
