"""The frozen arithmetic of `bounds.py` against PERF.md's kernel table: B1's
bound on the coarse queries of the first 4096-ray chunk of a served pano
(0.1446 ms) and B2's on a 4096 x 768 training chunk (0.1515 ms), at the
H100's published rate."""

import math

import pytest
import torch

from benchmark import bounds
from benchmark import reference as ref


def levels():
    return ref.block_levels(16, 16, 19, 32768)


def test_b1_bound_at_the_coarse_serving_chunk():
    lv, blocks = levels()
    scale = 0.010784853507573345  # configs/kitti360_1908.txt
    pose = torch.eye(4)
    pose[0, 3] = -0.01  # the first pose of chip_smoke.py's short drive
    o, d = ref.pixel_rays(pose, torch.arange(4096), 66, 1030, (2.0, 26.9))
    z = scale + (81 * scale - scale) * torch.linspace(0.0, 1.0, 768)
    xyz = torch.clamp(o[:, None] + d[:, None] * z[None, :, None], -1.0, 1.0)
    x01 = ((xyz + 1.0) / 2.0).reshape(-1, 3)
    assert x01.shape[0] == 3_145_728
    assert bounds.fwd_ms(x01, lv, blocks) == pytest.approx(0.1446, abs=5e-5)


def test_b2_bound_at_the_coarse_training_chunk():
    lv, blocks = levels()
    assert bounds.bwd_ms(4096 * 768, len(lv), len(lv) * blocks) == pytest.approx(0.1515, abs=5e-5)


def test_bounds_grow_with_the_rows_touched():
    lv, blocks = levels()
    gen = torch.Generator().manual_seed(0)
    few = torch.full((4096, 3), 0.5)
    many = torch.rand((4096, 3), generator=gen)
    assert bounds.touched_rows(few, lv, blocks) == len(lv)
    assert bounds.fwd_ms(few, lv, blocks) < bounds.fwd_ms(many, lv, blocks)


def test_model_flops_a_sample():
    cfg = {"num_levels": 16, "num_layers": 2, "hidden_dim": 64, "geo_feat_dim": 15,
           "num_layers_color": 3, "hidden_dim_color": 64}
    sigma = 2 * (32 * 64 + 64 * 16)
    head = 2 * (90 * 64 + 64 * 64 + 64 * 2)
    assert bounds.sample_flops(cfg) == sigma + head
    assert math.isclose(bounds.bound_ms(bounds.HBM_BYTES_PER_S / 1e3, 0), 1.0)
