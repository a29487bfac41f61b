"""ops/device_counts.py: the launch count on the device, on CPU tensors.

The wrappers add to it only after a launch on the card; here the module's
own contract is held on a CPU slot tensor: adds only while on, nothing while
paused, a reset in place (the address a captured add holds stays
valid), and one slot per kernel wrapper of the port.
"""

import pytest
import torch

from lidarnerf_tpu_torch.ops import (
    block_hash_cuda,
    device_counts,
    fused_mlp_cuda,
    occ_lookup_cuda,
    perm_gather_cuda,
)

CPU = torch.device("cpu")


@pytest.fixture
def counting():
    """The module's state, restored after the test."""
    slots, on = dict(device_counts._slots), device_counts._on
    device_counts._slots.pop(CPU, None)
    device_counts._on = False
    yield
    device_counts._slots.clear()
    device_counts._slots.update(slots)
    device_counts._on = on


def test_one_slot_per_kernel_wrapper():
    names = {**block_hash_cuda.launch_counts(), **fused_mlp_cuda.launch_counts(),
             **perm_gather_cuda.launch_counts(), **occ_lookup_cuda.launch_counts()}
    assert set(device_counts.KERNELS) == set(names)
    assert len(device_counts.KERNELS) == len(names)


def test_adds_only_while_on(counting):
    device_counts.add("block_hash_fwd", CPU)  # off: no slots, no add
    assert device_counts.counts() == dict.fromkeys(device_counts.KERNELS, 0)
    device_counts.enable(CPU)
    for _ in range(3):
        device_counts.add("block_hash_seg_bwd", CPU)
    device_counts.add("perm_gather_fwd", CPU)
    with device_counts.paused():
        device_counts.add("block_hash_seg_bwd", CPU)
    device_counts.add("fused_mlp", CPU)
    want = dict.fromkeys(device_counts.KERNELS, 0)
    want.update(block_hash_seg_bwd=3, perm_gather_fwd=1, fused_mlp=1)
    assert device_counts.counts() == want


def test_reset_keeps_the_slots_in_place(counting):
    device_counts.enable(CPU)
    slots = device_counts._slots[CPU]
    ptr = slots.data_ptr()
    device_counts.add("block_hash_bwd", CPU)
    device_counts.reset()
    device_counts.enable(CPU)  # enabling again allocates nothing
    assert device_counts._slots[CPU] is slots and slots.data_ptr() == ptr
    assert device_counts.counts()["block_hash_bwd"] == 0
    device_counts.add("block_hash_bwd", CPU)
    assert device_counts.counts()["block_hash_bwd"] == 1
    assert slots.dtype == torch.int64 and slots.tolist()[1] == 1
