"""Kernel tests that need an NVIDIA GPU with nvcc (sm_90a); they skip elsewhere.

This file imports no JAX, so it also runs where only PyTorch is installed:
    python -m pytest -m cuda tests/test_torch_cuda.py -q
Each kernel is held against its plain PyTorch version on the same inputs.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lidarnerf_tpu_torch.ops import (
    block_hash,
    block_hash_cuda,
    cuda_lib,
    fused_mlp,
    fused_mlp_cuda,
    occ_lookup,
    occ_lookup_cuda,
    perm_gather,
    perm_gather_cuda,
    sampling,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _rays(rs, Q, per_ray, length=0.5):
    """Q samples along rays of `per_ray` consecutive samples each, in ray order."""
    n = max(1, -(-Q // per_ray))
    o = rs.uniform(0.3, 0.7, (n, 1, 3))
    d = rs.normal(size=(n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o + d * np.linspace(0.0, length, per_ray)[None, :, None]).reshape(-1, 3)[:Q]


# the point sets of the block-hash kernel tests, and their sizes
POINTS = {
    "rays": 20000,  # rays of ~512 samples, as a render chunk orders them
    "uniform": 20000,  # no runs
    "one_cell": 20013,  # every query in one cell: the worst contention
    "ragged": 20013,  # rays of 333 samples: runs cross warp and tile ends, Q no multiple of 32
    "reversed": 20013,  # the ragged rays in reverse order
    "permuted": 20013,  # the ragged rays in a random order: no runs of lanes
    "faces": 20013,  # rays clamped to [0, 1]^3 (samples on the faces), some left outside
    "single": 1,
    # aimed at the tile layouts of the seg and win kernels (B3a/B3b, B4a/B4b)
    "tile_ends": 785,  # short dense rays of 96: long runs across group and tile ends, Q = 3 * 256 + 17
    "many_runs": 8192,  # a 4096-query chunk of uniform points (> 819 runs), then rays
    "pairs": 20013,  # each point twice: 16 runs a group, as many as B3b's ring holds
    "quads": 20013,  # four times: uniform windows of 8 rows a group, more than B4a's ring holds
    "octets": 20013,  # eight times: uniform windows of 4 rows a group, as many as B4a's ring holds
}


def _points(Q, seed, kind):
    rs = np.random.RandomState(seed)
    if kind == "rays":
        x = _rays(rs, Q, -(-Q // max(1, Q // 512)))
    elif kind == "uniform":
        x = rs.uniform(-0.05, 1.05, (Q, 3))
    elif kind == "one_cell":
        x = np.repeat(rs.uniform(0.0, 1.0, (1, 3)), Q, axis=0)
    elif kind in ("ragged", "reversed", "permuted"):
        x = _rays(rs, Q, 333)
        x = {"ragged": x, "reversed": x[::-1], "permuted": x[rs.permutation(Q)]}[kind]
    elif kind == "faces":
        x = _rays(rs, Q, 333, length=1.5)
        clamped = np.repeat(rs.uniform(size=-(-Q // 333)) < 0.9, 333)[:Q]
        x[clamped] = np.clip(x[clamped], 0.0, 1.0)
    elif kind == "tile_ends":
        x = _rays(rs, Q, 96, length=0.1)
    elif kind == "many_runs":
        x = np.concatenate([rs.uniform(0.0, 1.0, (4096, 3)), _rays(rs, Q - 4096, 512)])
    elif kind in ("pairs", "quads", "octets"):
        times = {"pairs": 2, "quads": 4, "octets": 8}[kind]
        x = np.repeat(rs.uniform(0.0, 1.0, (-(-Q // times), 3)), times, axis=0)[:Q]
    else:
        x = rs.uniform(0.0, 1.0, (Q, 3))
    if kind in ("rays", "uniform"):
        x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.5]]
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).cuda()


SPECS = {
    "small": dict(num_levels=4, log2_hashmap_size=14, desired_resolution=32768),
    "full_width": dict(num_levels=16, log2_hashmap_size=19, desired_resolution=32768),
}
# B1 and B2 also take odd level counts, and up to MAX_LEVELS (the tile then
# needs more than 48 KB of shared memory)
B12_SPECS = {
    **SPECS,
    "odd_levels": dict(num_levels=3, log2_hashmap_size=14, desired_resolution=512),
    "max_levels": dict(num_levels=32, log2_hashmap_size=14, desired_resolution=32768),
}


@pytest.mark.parametrize("kind", list(POINTS))
@pytest.mark.parametrize("spec_name", list(B12_SPECS))
def test_block_hash_kernel_matches_plain(require_cuda, spec_name, kind):
    spec = block_hash.make_block_hash_spec(**B12_SPECS[spec_name])
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(spec.table_rows, 128, generator=g, device="cuda")
    x = _points(POINTS[kind], 1, kind)
    before = block_hash_cuda.launches
    out = block_hash.block_hash_encode(x, table, spec)
    torch.cuda.synchronize()
    assert block_hash_cuda.launches == before + 1
    assert out.shape == (x.shape[0], spec.output_dim)
    ref = block_hash.encode_plain(x, table, spec)
    # the same fp32 products; 8 corners summed in another order (fma)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def _assert_bwd_close(out, x, g, spec):
    """|kernel - plain| <= 1e-5 * S + 1e-7, S = encode_bwd_plain(x, |g|).

    The trilinear weights are non-negative, so S is the sum of the absolute
    terms of each entry: a bound on the rounding of any summation order.
    """
    ref = block_hash.encode_bwd_plain(x, g, spec)
    S = block_hash.encode_bwd_plain(x, g.abs(), spec)
    bad = (out - ref).abs() > 1e-5 * S + 1e-7
    assert not bad.any(), f"{int(bad.sum())} entries off; max err {(out - ref).abs().max()}"


def test_block_hash_kernel_empty_and_no_grad_guard(require_cuda):
    """The table gradient of block_hash_encode launches B2 once and matches its
    plain version; an empty batch launches nothing."""
    spec = block_hash.make_block_hash_spec(**SPECS["small"])
    table = torch.zeros(spec.table_rows, 128, device="cuda", requires_grad=True)
    x = _points(3000, 2, "rays")
    g = torch.randn(3000, spec.output_dim, device="cuda")
    fwd0, bwd0 = block_hash_cuda.launches, block_hash_cuda.bwd_launches
    (block_hash.block_hash_encode(x, table, spec) * g).sum().backward()
    torch.cuda.synchronize()
    assert (block_hash_cuda.launches, block_hash_cuda.bwd_launches) == (fwd0 + 1, bwd0 + 1)
    _assert_bwd_close(table.grad, x, g, spec)
    with torch.no_grad():
        assert block_hash.block_hash_encode(x[:0], table, spec).shape == (0, spec.output_dim)
    empty = block_hash_cuda.block_hash_bwd(x[:0], g[:0], spec)
    assert empty.shape == (spec.table_rows, 128) and not empty.any()
    assert (block_hash_cuda.launches, block_hash_cuda.bwd_launches) == (fwd0 + 1, bwd0 + 1)


@pytest.mark.parametrize("kind", list(POINTS))
@pytest.mark.parametrize("spec_name", list(B12_SPECS))
def test_block_hash_bwd_kernel_matches_plain(require_cuda, spec_name, kind):
    """B2 on every point set: runs summed in registers and carried from group
    to group (rays, one cell, clamped samples on the faces), the plain path
    (uniform, and any order without runs of lanes)."""
    spec = block_hash.make_block_hash_spec(**B12_SPECS[spec_name])
    Q = POINTS[kind]
    x = _points(Q, 3, kind)
    g = torch.randn(Q, spec.output_dim, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    before = block_hash_cuda.bwd_launches
    out = block_hash_cuda.block_hash_bwd(x, g, spec)
    torch.cuda.synchronize()
    assert block_hash_cuda.bwd_launches == before + 1
    _assert_bwd_close(out, x, g, spec)


VARIANT_ENV = {"seg": "LIDARNERF_SEG_KERNELS", "win": "LIDARNERF_WIN_KERNELS"}


@pytest.mark.parametrize("kind", list(POINTS))
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_forward_equals_b1_bit_for_bit(require_cuda, variant, spec_name, kind):
    """B3a and B4a load a run's or window's row once; the features are B1's,
    whose tile layout reads the same corners in the same order."""
    spec = block_hash.make_block_hash_spec(**SPECS[spec_name])
    table = torch.randn(spec.table_rows, 128, generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda")
    x = _points(POINTS[kind], 6, kind)
    counts = block_hash_cuda.launch_counts()
    out = block_hash_cuda.FWD[variant](x, table, spec)
    ref = block_hash_cuda.block_hash_fwd(x, table, spec)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    after = block_hash_cuda.launch_counts()
    assert after[f"block_hash_{variant}_fwd"] == counts[f"block_hash_{variant}_fwd"] + 1


@pytest.mark.parametrize("kind", [k for k in POINTS if k != "single"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_backward_matches_plain(require_cuda, variant, spec_name, kind):
    """B3b and B4b within B2's slack of encode_bwd_plain and of their own
    run-structured plain versions, on every point set: runs carried across
    group ends and added at tile ends, groups of more runs than B3b's ring
    holds, chunks beyond the TPU kernel's run limit."""
    spec = block_hash.make_block_hash_spec(**SPECS[spec_name])
    x = _points(POINTS[kind], 7, kind)
    g = torch.randn(x.shape[0], spec.output_dim,
                    generator=torch.Generator(device="cuda").manual_seed(8), device="cuda")
    out = block_hash_cuda.BWD[variant](x, g, spec)
    torch.cuda.synchronize()
    _assert_bwd_close(out, x, g, spec)
    own = block_hash.ENCODE_BWD_PLAIN[variant](x, g, spec)
    S = block_hash.encode_bwd_plain(x, g.abs(), spec)
    assert ((out - own).abs() <= 1e-5 * S + 1e-7).all()


def _model_chunk(kind):
    """The coarse queries of one 4096-ray chunk as the model's paths form
    them, 768 samples per ray in ray order: a served pano's first chunk, or
    a training chunk of frame 0 of data_synth_drive60 (jittered samples)."""
    import json
    from pathlib import Path

    from lidarnerf_tpu_torch.dataset.base import get_lidar_rays, rays_from_indices, sample_ray_indices
    from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset

    gen = torch.Generator(device="cuda").manual_seed(2)
    if kind == "served_chunk":
        scale = 0.010784853507573345
        rays = get_lidar_rays(torch.eye(4, device="cuda")[None], (2.0, 26.9), 66, 1030)
        o, d = rays["rays_o"][0, :4096], rays["rays_d"][0, :4096]
    else:
        data = Path(__file__).resolve().parent.parent / "data_synth_drive60"
        c = json.loads((data / "scene_constants.json").read_text())
        ds = KITTI360Dataset(root_path=str(data), scale=c["scale"], offset=c["offset"])
        scale = ds.scale
        poses, _ = ds.device_arrays("cuda")
        inds = sample_ray_indices(ds.H_lidar, ds.W_lidar, 4096, 1, gen, "cuda")
        o, d = rays_from_indices(poses[0], inds, ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    near = torch.full((4096, 1), scale, device="cuda")
    z = sampling.stratified_z_vals(near, near * 81.0, 768, perturb=kind == "training_chunk",
                                   generator=gen)
    xyz = torch.clamp(o[:, None] + d[:, None] * z[..., None], -1.0, 1.0)
    return ((xyz + 1.0) / 2.0).reshape(-1, 3).contiguous()


@pytest.mark.parametrize("kind", ["served_chunk", "training_chunk"])
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_forward_equals_b1_on_model_chunks(require_cuda, variant, kind):
    """B3a and B4a on the model's own chunks at full width: B1's features bit for bit."""
    spec = block_hash.make_block_hash_spec(**SPECS["full_width"])
    table = torch.randn(spec.table_rows, 128, generator=torch.Generator(device="cuda").manual_seed(9),
                        device="cuda")
    x = _model_chunk(kind)
    out = block_hash_cuda.FWD[variant](x, table, spec)
    assert torch.equal(out, block_hash_cuda.block_hash_fwd(x, table, spec))


# the point sets of the determinism tests: a training chunk, 1024 copies of
# one point (tests/test_determinism.py's case) and the adversarial sets
DETERMINISM_SETS = ["training_chunk", "one_point", "one_cell", "ragged", "reversed", "permuted",
                    "faces", "single", "tile_ends", "many_runs", "pairs", "quads", "octets"]


def _bwd_case(kind, spec, seed):
    if kind == "training_chunk":
        x = _model_chunk(kind)
    elif kind == "one_point":
        x = torch.tensor([[0.3, 0.5, 0.7]], device="cuda").repeat(1024, 1)
    else:
        x = _points(POINTS[kind], seed, kind)
    g = torch.randn(x.shape[0], spec.output_dim,
                    generator=torch.Generator(device="cuda").manual_seed(seed + 1), device="cuda")
    return x, g


@pytest.mark.parametrize("kind", DETERMINISM_SETS)
@pytest.mark.parametrize("variant", list(block_hash.VARIANTS))
def test_backward_kernels_repeat_bit_for_bit(require_cuda, variant, kind):
    """B2, B3b and B4b add through an order-free accumulator: two calls on the
    same inputs give the same table gradient bit for bit, within B2's slack
    of encode_bwd_plain and of the variant's own plain version."""
    spec = block_hash.make_block_hash_spec(**SPECS["full_width"])
    x, g = _bwd_case(kind, spec, 10)
    first = block_hash_cuda.BWD[variant](x, g, spec)
    second = block_hash_cuda.BWD[variant](x, g, spec)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    _assert_bwd_close(first, x, g, spec)
    own = block_hash.ENCODE_BWD_PLAIN[variant](x, g, spec)
    S = block_hash.encode_bwd_plain(x, g.abs(), spec)
    assert ((first - own).abs() <= 1e-5 * S + 1e-7).all()


@pytest.mark.parametrize("kind", ["rays", "pairs"])
@pytest.mark.parametrize("variant", list(block_hash.VARIANTS))
def test_backward_kernels_propagate_non_finite(require_cuda, variant, kind):
    """A NaN and an Inf in g give non-finite table entries exactly where the
    plain version has them (the guarded update then skips the step), and
    the result still repeats bit for bit: in long runs carried from group to
    group, and in groups whose runs fill B3b's ring."""
    spec = block_hash.make_block_hash_spec(**SPECS["full_width"])
    x = _points(20000, 11, kind)
    g = torch.randn(20000, spec.output_dim, generator=torch.Generator(device="cuda").manual_seed(12),
                    device="cuda")
    g[5, 3] = float("nan")  # level 1, in a long run
    g[7000, 0] = float("inf")
    g[12000, 31] = float("-inf")  # the finest level
    out = block_hash_cuda.BWD[variant](x, g, spec)
    again = block_hash_cuda.BWD[variant](x, g, spec)
    torch.cuda.synchronize()
    ref = block_hash.ENCODE_BWD_PLAIN[variant](x, g, spec)
    assert (~ref.isfinite()).any()
    assert torch.equal(out.isfinite(), ref.isfinite())
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    finite = ref.isfinite()
    S = block_hash.encode_bwd_plain(x, g.nan_to_num(0.0, 0.0, 0.0).abs(), spec)
    assert ((out - ref).abs()[finite] <= (1e-5 * S + 1e-7)[finite]).all()


@pytest.mark.parametrize("Q", [0, 1, 31, 257])
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_empty_input(require_cuda, variant, Q):
    """No query launches nothing; a few (one, less than a group, one past a
    tile) launch each kernel once, the forward equal to B1 bit for bit and
    the backward within B2's slack."""
    spec = block_hash.make_block_hash_spec(**SPECS["small"])
    x = _points(Q, 13, "ragged") if Q else torch.zeros(0, 3, device="cuda")
    table = torch.randn(spec.table_rows, 128, generator=torch.Generator(device="cuda").manual_seed(14),
                        device="cuda")
    g = torch.randn(Q, spec.output_dim, generator=torch.Generator(device="cuda").manual_seed(15),
                    device="cuda")
    counts = block_hash_cuda.launch_counts()
    out = block_hash_cuda.FWD[variant](x, table, spec)
    assert out.shape == (Q, spec.output_dim)
    grad = block_hash_cuda.BWD[variant](x, g, spec)
    assert grad.shape == (spec.table_rows, 128)
    after = block_hash_cuda.launch_counts()
    moved = {k: after[k] - counts[k] for k in after if after[k] != counts[k]}
    if not Q:
        assert not grad.any() and not moved
        return
    assert moved == {f"block_hash_{variant}_fwd": 1, f"block_hash_{variant}_bwd": 1}
    assert torch.equal(out, block_hash_cuda.block_hash_fwd(x, table, spec))
    _assert_bwd_close(grad, x, g, spec)


@pytest.mark.parametrize("variant", ["seg", "win"])
def test_variant_on_cuda_launches_its_kernels_only(require_cuda, monkeypatch, variant):
    """With a switch set, block_hash_encode on CUDA launches the variant's
    forward and backward once each, no other kernel, and no plain version."""
    monkeypatch.setenv(VARIANT_ENV[variant], "1")
    spec = block_hash.make_block_hash_spec(**SPECS["small"])
    x = _points(5000, 9, "rays")
    g = torch.randn(5000, spec.output_dim, device="cuda")
    table = torch.zeros(spec.table_rows, 128, device="cuda", requires_grad=True)

    def plain(*args):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("encode_plain", "encode_bwd_plain", "encode_bwd_seg_plain", "encode_bwd_win_plain"):
        monkeypatch.setattr(block_hash, name, plain)
    monkeypatch.setattr(block_hash, "ENCODE_BWD_PLAIN", {k: plain for k in block_hash.VARIANTS})
    counts = block_hash_cuda.launch_counts()
    (block_hash.block_hash_encode(x, table, spec) * g).sum().backward()
    torch.cuda.synchronize()
    after = block_hash_cuda.launch_counts()
    moved = {k: after[k] - counts[k] for k in after if after[k] != counts[k]}
    assert moved == {f"block_hash_{variant}_fwd": 1, f"block_hash_{variant}_bwd": 1}
    assert table.grad is not None and table.grad.any()


# B5: the model's nets (sigma, LiDAR head), a relu head and a wide first layer;
# on the tensor-core route, a hidden layer wider than REG_WIDTH goes through a
# per-warp buffer (one, or two in turns when two follow each other), and an
# 8-layer chain mixes both routes with widths that need K and N padding
B5_NETS = {
    "sigma": ([32, 64, 16], "none"),
    "lidar_head": ([90, 64, 64, 2], "sigmoid"),
    "relu": ([16, 32, 8], "relu"),
    "wide": ([256, 64, 3], "none"),
    "wide_hidden": ([32, 256, 16], "none"),
    "two_wide": ([32, 128, 96, 8], "relu"),
    "chain8": ([33, 64, 48, 80, 16, 64, 24, 8, 3], "sigmoid"),
}
B5_DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _mlp_case(dims, dtype, rows, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, dims[0], generator=g, device="cuda")
    ws = [(torch.randn(a, b, generator=g, device="cuda") / a**0.5).to(dtype)
          for a, b in zip(dims[:-1], dims[1:])]
    return x, ws


def _assert_mlp_close(out, x, ws, act):
    """|kernel - plain| <= r * S + 1e-6, S the chain on |x| and |W| (a bound on
    the sum of absolute terms); r = 1e-5 for float32 weights, 2^-7 for
    bfloat16 ones, where a sum taken in another order may round an
    intermediate to the other neighbouring bfloat16 value."""
    ref = fused_mlp.mlp_reference(x, ws, act)
    S = fused_mlp.mlp_reference(x.abs(), [w.abs() for w in ws], "none")
    r = 1e-5 if ws[0].dtype == torch.float32 else 2.0**-7
    bad = (out - ref).abs() > r * S + 1e-6
    assert not bad.any(), f"{int(bad.sum())} entries off; max err {(out - ref).abs().max()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("net", list(B5_NETS))
def test_fused_mlp_kernel_matches_plain(require_cuda, net, dtype):
    dims, act = B5_NETS[net]
    x, ws = _mlp_case(dims, dtype, 5000 + 37, 0)  # a ragged last tile
    before = fused_mlp_cuda.launches
    out = fused_mlp.fused_mlp_inference(x, ws, act)
    torch.cuda.synchronize()
    assert fused_mlp_cuda.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], dims[-1])
    _assert_mlp_close(out, x, ws, act)


def test_fused_mlp_on_cuda_runs_b5_forward_and_recomputes_backward(require_cuda, monkeypatch):
    """fused_mlp's forward launches B5 (never the plain chain); its backward
    recomputes through mlp_reference, as the JAX package's does."""
    x, ws = _mlp_case([32, 64, 16], torch.float32, 3000, 1)
    x.requires_grad_()
    for w in ws:
        w.requires_grad_()
    cot = torch.randn(3000, 16, device="cuda")
    plain = fused_mlp.mlp_reference
    forward_only = {"plain": 0}

    def counting(*args):
        forward_only["plain"] += 1
        return plain(*args)

    monkeypatch.setattr(fused_mlp, "mlp_reference", counting)
    before = fused_mlp_cuda.launches
    out = fused_mlp.fused_mlp(x, ws)
    assert forward_only["plain"] == 0 and fused_mlp_cuda.launches == before + 1
    out.backward(cot)
    assert forward_only["plain"] == 1 and fused_mlp_cuda.launches == before + 1
    xr = x.detach().clone().requires_grad_()
    wr = [w.detach().clone().requires_grad_() for w in ws]
    plain(xr, wr, "none").backward(cot)
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-6)
    for a, b in zip(ws, wr):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_fused_mlp_wrapper_limits(require_cuda):
    x, ws = _mlp_case([32, 64, 16], torch.float32, 10, 2)
    before = fused_mlp_cuda.launches
    assert fused_mlp_cuda.fused_mlp_fwd(x[:0], ws).shape == (0, 16)
    for bad_dims, match in (([256, 128, 3], "shared memory"), ([300, 8], "widths up to"),
                            ([8] * 10, "layers")):
        with pytest.raises(ValueError, match=match):
            fused_mlp_cuda.fused_mlp_fwd(*_mlp_case(bad_dims, torch.float32, 10, 3))
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        fused_mlp_cuda.fused_mlp_fwd(x, [ws[0], ws[1].to(torch.bfloat16)])
    with pytest.raises(ValueError, match="continue the chain"):
        fused_mlp_cuda.fused_mlp_fwd(x, ws[::-1])
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp_cuda.fused_mlp_fwd(*_mlp_case([256] * 9, torch.bfloat16, 10, 3))
    assert fused_mlp_cuda.launches == before


@B5_DTYPES
@pytest.mark.parametrize("Q", [1, 15, 17, 5037])
def test_fused_mlp_head_ragged_last_tile(require_cuda, Q, dtype):
    """A last tile of 1..15 rows (or one whole tile): no copy past x, no wait
    on a copy never issued, only rows < Q stored."""
    dims, act = B5_NETS["lidar_head"]
    x, ws = _mlp_case(dims, dtype, Q, 4)
    out = fused_mlp.fused_mlp_inference(x, ws, act)
    torch.cuda.synchronize()
    assert out.shape == (Q, 2)
    _assert_mlp_close(out, x, ws, act)


@B5_DTYPES
@pytest.mark.parametrize("d_out", [1, 2, 3])
@pytest.mark.parametrize("d_in", [1, 33, 90])
def test_fused_mlp_padded_widths(require_cuda, d_in, d_out, dtype):
    """Input widths that are no multiple of 16 (or of 4: rows packed in the
    ring), output widths that are no multiple of 8 (odd: scalar stores)."""
    x, ws = _mlp_case([d_in, 64, d_out], dtype, 1000 + 13, 5)
    out = fused_mlp.fused_mlp_inference(x, ws, "none")
    torch.cuda.synchronize()
    assert out.shape == (x.shape[0], d_out)
    _assert_mlp_close(out, x, ws, "none")


@B5_DTYPES
@pytest.mark.parametrize("net", ["sigma", "lidar_head"])
def test_fused_mlp_non_finite_inputs_stay_in_their_rows(require_cuda, net, dtype):
    """A NaN or an Inf in x reaches only its row's outputs, where and as
    mlp_reference has them: the K padding and the ReLU spread nothing (a
    zero weight times an Inf would be a NaN)."""
    dims, act = B5_NETS[net]
    x, ws = _mlp_case(dims, dtype, 777, 6)
    bad = [5, 40, 41, 300]
    x[5, 3] = float("nan")
    x[40, 0] = float("inf")
    x[41, dims[0] - 1] = float("-inf")
    x[300, 2], x[300, 7] = float("nan"), float("inf")
    out = fused_mlp.fused_mlp_inference(x, ws, act)
    ref = fused_mlp.mlp_reference(x, ws, act)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan(), ref.isnan()) and torch.equal(out.isinf(), ref.isinf())
    assert torch.equal(out[out.isinf()], ref[ref.isinf()])
    rows = (~out.isfinite()).any(1).nonzero().flatten().tolist()
    assert rows and set(rows) <= set(bad)
    good = torch.ones(x.shape[0], dtype=torch.bool, device="cuda")
    good[bad] = False
    _assert_mlp_close(out[good], x[good], ws, act)


@B5_DTYPES
def test_fused_mlp_misaligned_view(require_cuda, dtype):
    """x[1:] of a [Q + 1, 90] tensor is contiguous and 8-byte aligned, not
    16: the wrapper copies such an x once for the tensor-core route (whose
    16-byte copies need the alignment; its C entry point refuses it), and the
    float32 route reads it as it is."""
    dims, act = B5_NETS["lidar_head"]
    full, ws = _mlp_case(dims, dtype, 2001 + 1, 7)
    x = full[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    before = fused_mlp_cuda.launches
    out = fused_mlp.fused_mlp_inference(x, ws, act)
    torch.cuda.synchronize()
    assert fused_mlp_cuda.launches == before + 1
    _assert_mlp_close(out, x, ws, act)
    assert torch.equal(out, fused_mlp.fused_mlp_inference(x.clone(), ws, act))
    if dtype == torch.bfloat16:
        L = len(ws)
        err = fused_mlp_cuda._kernel()(
            x.data_ptr(), out.data_ptr(), x.shape[0],
            (ctypes.c_void_p * L)(*[w.data_ptr() for w in ws]),
            (ctypes.c_int * (L + 1))(*dims), L, 1, 0, torch.cuda.current_stream().cuda_stream)
        assert err != 0


@B5_DTYPES
@pytest.mark.parametrize("net", ["sigma", "lidar_head", "wide_hidden", "chain8"])
def test_fused_mlp_repeats_bit_for_bit(require_cuda, net, dtype):
    """B5 adds without atomics, in a fixed order: two calls agree bit for bit."""
    dims, act = B5_NETS[net]
    x, ws = _mlp_case(dims, dtype, 20000 + 7, 8)
    a = fused_mlp.fused_mlp_inference(x, ws, act)
    b = fused_mlp.fused_mlp_inference(x, ws, act)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@B5_DTYPES
@pytest.mark.parametrize("net", list(B5_NETS))
def test_fused_mlp_occupancy_matches_the_wrapper(require_cuda, net, dtype):
    """Every instance gets at least one block an SM, with the shared memory
    the wrapper computes."""
    dims, act = B5_NETS[net]
    occ = fused_mlp_cuda.occupancy(dims, dtype, act)
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
    assert occ["smem_bytes"] == fused_mlp_cuda.smem_bytes(dims, dtype)


def test_fused_mlp_ptxas_reports_no_spill(require_cuda):
    """ptxas (-v) reports 0 bytes spilled for every kernel of the library: the
    float32 one and each tensor-core instance."""
    lib = cuda_lib.build([fused_mlp_cuda.SOURCE])[fused_mlp_cuda.SOURCE]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        lib.with_suffix(".log").read_text())
    assert len(spills) >= 2 and all(a == b == "0" for a, b in spills), spills


def test_fused_mlp_bf16_route_runs_on_tensor_cores(require_cuda):
    """The built library's SASS issues HMMA (the bf16 mma.sync)."""
    lib = cuda_lib.build([fused_mlp_cuda.SOURCE])[fused_mlp_cuda.SOURCE]
    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    assert "HMMA" in sass


def _perm_case(N, S, C, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = torch.randn(N, S, C, generator=g, device="cuda")
    vals.view(-1)[:5] = torch.tensor([-0.0, float("inf"), float("nan"), 1e-40, -1e30])
    order = torch.argsort(torch.rand(N, S, generator=g, device="cuda"), dim=1)
    return vals, order, sampling.inverse_permutation(order)


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("S,C", [(832, 17), (256, 17), (100, 3), (3100, 17)])
def test_perm_gather_kernel_is_bit_exact_both_ways(require_cuda, S, C):
    vals, order, inv = _perm_case(300, S, C, 4)
    before = perm_gather_cuda.launch_counts()
    out = perm_gather_cuda.perm_gather_fwd(vals, inv.int())
    g = torch.randn_like(vals)
    back = perm_gather_cuda.perm_gather_bwd(g, inv.int())
    torch.cuda.synchronize()
    assert perm_gather_cuda.launch_counts() == {
        "perm_gather_fwd": before["perm_gather_fwd"] + 1,
        "perm_gather_bwd": before["perm_gather_bwd"] + 1}
    idx = order[..., None].expand_as(vals)
    assert torch.equal(_bits(out), _bits(torch.gather(vals, 1, idx)))
    assert torch.equal(_bits(out), _bits(perm_gather.scatter_by_inverse(vals, inv)))
    assert torch.equal(_bits(back), _bits(perm_gather.gather_by_inverse(g, inv)))


def test_perm_gather_wrapper_limits(require_cuda):
    vals, _, inv = _perm_case(4, 8, 3, 5)
    before = perm_gather_cuda.launch_counts()
    with pytest.raises(ValueError, match="int32"):
        perm_gather_cuda.perm_gather_fwd(vals, inv)  # int64
    big = torch.zeros(2, 4000, 17, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        perm_gather_cuda.perm_gather_fwd(big, torch.zeros(2, 4000, dtype=torch.int32, device="cuda"))
    empty = perm_gather_cuda.perm_gather_fwd(vals[:0], inv[:0].int())
    assert empty.shape == (0, 8, 3) and perm_gather_cuda.launch_counts() == before


def _occ_case(case):
    """(idx, grid) on the card: the occupancy tool's draws (a 128^3 grid and
    524,288 uniform cells), a count no multiple of 4 or 4096, a view at an
    odd offset (not 16-byte aligned: the scalar loop), indices past either
    end and in the wrapped range, and none."""
    rs = np.random.RandomState(0)
    G = 128
    grid = torch.from_numpy(rs.rand(G, G, G).astype(np.float32)).cuda()
    idx = torch.from_numpy(rs.randint(0, G**3, size=4096 * 128).astype(np.int32)).cuda()
    n = G**3
    edges = torch.tensor([0, n - 1, n, n + 1, -1, -n, -n - 1, 2**31 - 1, -2**31],
                         dtype=torch.int32, device="cuda")
    wild = torch.from_numpy(rs.randint(-2 * n, 2 * n, 20011).astype(np.int32)).cuda()
    return {"tool": (idx, grid.reshape(G * G, G)), "ragged": (idx[: 4096 * 128 - 3], grid),
            "odd_offset": (idx[1:], grid.reshape(-1)), "out_of_range": (torch.cat([edges, wild]), grid),
            "empty": (idx[:0], grid)}[case]


@pytest.mark.parametrize("case", ["tool", "ragged", "odd_offset", "out_of_range", "empty"])
def test_occ_lookup_kernel_is_bit_exact(require_cuda, case):
    idx, grid = _occ_case(case)
    before = occ_lookup_cuda.launches
    out = occ_lookup.occ_lookup(idx, grid)
    torch.cuda.synchronize()
    assert occ_lookup_cuda.launches == before + (idx.numel() > 0)
    assert out.shape == idx.shape and out.dtype == torch.float32 and out.is_cuda
    assert torch.equal(_bits(out), _bits(occ_lookup.occ_lookup_plain(idx, grid)))
    inside = (idx >= -grid.numel()) & (idx < grid.numel())
    if case != "empty":
        assert torch.isnan(out).equal(~inside)
        assert torch.equal(out[inside], torch.take(grid, idx[inside].long() % grid.numel()))


def test_occ_lookup_in_a_cuda_graph_and_the_tool(require_cuda):
    """The kernel captured in a CUDA graph replays bit-equal to the plain
    version; the tool times through such graphs and reports its calls."""
    from lidarnerf_tpu_torch.tools import exp_occ_lookup

    idx, grid = _occ_case("ragged")
    occ_lookup.occ_lookup(idx, grid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = occ_lookup.occ_lookup(idx, grid)
    out.fill_(0.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(occ_lookup.occ_lookup_plain(idx, grid)))
    result = exp_occ_lookup.main([])
    assert result["max_abs_diff"] == 0.0 and result["bit_equal"]
    assert result["kernel_ms"] > 0 and result["take_ms"] > 0
    assert result["launches"] == 2 + exp_occ_lookup.BATCH  # check, warm-up, captured calls


def test_occ_lookup_wrapper_limits(require_cuda):
    idx, grid = _occ_case("tool")
    before = occ_lookup_cuda.launches
    with pytest.raises(ValueError, match="int32"):
        occ_lookup_cuda.occ_lookup(idx.long(), grid)
    with pytest.raises(ValueError, match="not contiguous"):
        occ_lookup_cuda.occ_lookup(idx[::2], grid)
    with pytest.raises(ValueError, match="float32 grid"):
        occ_lookup_cuda.occ_lookup(idx, grid.double())
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        occ_lookup_cuda.occ_lookup(idx, grid.cpu())
    assert occ_lookup_cuda.launches == before


def test_sort_merge_z_on_cuda_runs_b6_and_matches_the_cpu(require_cuda, monkeypatch):
    """On CUDA tensors sort_merge_z reorders through B6 in both directions and
    never through a gather; its outputs and gradients equal the CPU path's
    bit for bit."""
    g = torch.Generator().manual_seed(6)
    zc = torch.sort(torch.rand(64, 96, generator=g), dim=1).values
    zf = torch.sort(torch.rand(64, 32, generator=g), dim=1).values
    zf[:, 5] = zc[:, 40]  # ties
    zf = torch.sort(zf, dim=1).values
    extras = [torch.randn(64, 96, generator=g), torch.randn(64, 32, generator=g),
              torch.randn(64, 96, 15, generator=g), torch.randn(64, 32, 15, generator=g)]
    cots = [torch.randn(64, 128, generator=g), torch.randn(64, 128, 15, generator=g)]

    def run(device):
        leaves = [e.detach().to(device, copy=True).requires_grad_() for e in extras]
        z, order, s, geo = sampling.sort_merge_z(zc.to(device), zf.to(device),
                                                 (leaves[0], leaves[1]), (leaves[2], leaves[3]))
        torch.autograd.backward([s, geo], [c.to(device) for c in cots])
        return [t.detach().cpu() for t in (z, order, s, geo, *[leaf.grad for leaf in leaves])]

    cpu = run("cpu")

    def no_gather(*args):
        raise AssertionError("a gather ran on the CUDA path")

    for name in ("scatter_by_inverse", "gather_by_inverse"):
        monkeypatch.setattr(perm_gather, name, no_gather)
    monkeypatch.setattr(sampling, "permutation_gather", no_gather)
    before = perm_gather_cuda.launch_counts()
    gpu = run("cuda")
    after = perm_gather_cuda.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"perm_gather_fwd": 1, "perm_gather_bwd": 1}
    for a, b in zip(gpu, cpu):
        assert torch.equal(a, b)


def _pano_clouds(rs, H=66, W=1030):
    """(pred, gt) point clouds of two full 66 x 1030 panos (depths 2-60 m, some
    rays dropped), as PointsMeter makes them."""
    from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar

    gt = rs.uniform(2.0, 60.0, (H, W)) * (rs.uniform(size=(H, W)) > 0.1)
    pred = np.clip(gt + rs.normal(0.0, 0.1, (H, W)), 0.0, None) * (rs.uniform(size=(H, W)) > 0.1)
    return pano_to_lidar(pred, (2.0, 26.9)), pano_to_lidar(gt, (2.0, 26.9))


@pytest.fixture(scope="module")
def pano_chamfer_cpu():
    """Two full-pano clouds and their Chamfer terms on the CPU, computed once
    (and only where the GPU tests run: a module fixture is set up first)."""
    from lidarnerf_tpu_torch.ops import chamfer

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")

    pred, gt = _pano_clouds(np.random.RandomState(5))
    d = chamfer.chamfer_distance(*(torch.from_numpy(x.astype(np.float32)) for x in (pred, gt)))
    return pred, gt, [x.numpy() for x in d]


@pytest.mark.parametrize("tf32", [False, True], ids=["tf32-off", "tf32-on-globally"])
def test_chamfer_on_cuda_matches_the_cpu_at_full_pano_sizes(require_cuda, tf32, monkeypatch,
                                                            pano_chamfer_cpu):
    """The device Chamfer terms in full float32 whatever the global TF32 flag:
    each point's distance within the float32 rounding bound of the
    |a|^2 + |b|^2 - 2 a.b form (16 eps (|a|^2 + max |b|^2), as
    tests/test_torch_metrics.py states), and the F-score's counts differ by
    no more than the points whose distance lies within that bound of 0.05."""
    from lidarnerf_tpu_torch.ops import chamfer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    pred, gt, d_cpu = pano_chamfer_cpu
    assert 55000 < len(pred) < 66 * 1030
    d_gpu = [d.cpu().numpy() for d in chamfer.chamfer_distance(
        *(torch.from_numpy(x.astype(np.float32)).cuda() for x in (pred, gt)))]
    assert torch.backends.cuda.matmul.allow_tf32 == tf32  # restored
    eps = 2.0**-23
    near = 0
    for g, c, a, b in zip(d_gpu, d_cpu, (pred, gt), (gt, pred)):
        bound = 16 * eps * ((a**2).sum(-1) + (b**2).sum(-1).max())
        assert np.all(np.abs(g - c) <= bound)
        near = max(near, int((np.abs(c - 0.05) <= bound).sum()))
        assert abs(int((g < 0.05).sum()) - int((c < 0.05).sum())) <= near
    # the padded path of the meter, against the CPU's terms
    cd_gpu, f_gpu = chamfer.chamfer_and_fscore(pred, gt, device="cuda")
    cd_cpu = float(d_cpu[0].mean() + d_cpu[1].mean())
    f_cpu = float(chamfer.fscore(d_cpu[0][None], d_cpu[1][None], 0.05)[0][0])
    assert abs(cd_gpu - cd_cpu) <= 16 * eps * 2 * (
        (pred**2).sum(-1).mean() + (gt**2).sum(-1).max())
    assert 0.0 < f_gpu < 1.0 and abs(f_gpu - f_cpu) <= 2 * near / min(len(pred), len(gt)) + 1e-12


def test_checkpoint_saved_on_the_card_loads_on_the_cpu_and_back(require_cuda, tmp_path):
    """A port checkpoint written from CUDA tensors holds numpy leaves: the CPU
    trainer loads its weights, EMA and Adam state exactly (the CUDA
    generator's state stays behind, with a warning), and its own checkpoint
    loads back on the card."""
    import json

    from lidarnerf_tpu_torch import main_lidarnerf as cli
    from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    root = Path(__file__).resolve().parent.parent
    with open(root / "data_synth_drive60" / "scene_constants.json") as f:
        c = json.load(f)
    opt = cli.get_arg_parser().parse_args([
        "--config", str(root / "configs" / "kitti360_1908.txt"), "--iters", "120",
        "--num_steps", "32", "--upsample_steps", "8", "--num_rays_lidar", "256",
        "--desired_resolution", "256", "--log2_hashmap_size", "14"])
    opt.min_near = opt.min_near_lidar = opt.scale = c["scale"]
    opt.H_lidar, opt.W_lidar, opt.intrinsics_lidar = 66, 1030, (2.0, 26.9)
    ds = KITTI360Dataset(root_path=str(root / "data_synth_drive60"), scale=c["scale"],
                         offset=c["offset"], num_rays_lidar=256)

    def trainer(device, ws):
        return Trainer("lidar_nerf", opt, cli.build_model(opt), device=device, mute=True,
                       ema_decay=0.95, workspace=str(ws))

    def same(a, b):
        for k, v in a.model.state_dict().items():
            assert torch.equal(v.cpu(), b.model.state_dict()[k].cpu()), k
        for k, v in a.ema_params.items():
            assert torch.equal(v.cpu(), b.ema_params[k].cpu()), k
        sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
        assert (sa["count"], sa["schedule_count"]) == (sb["count"], sb["schedule_count"])
        for kind in ("mu", "nu"):
            for k, v in sa[kind].items():
                assert torch.equal(v, sb[kind][k]), (kind, k)

    gpu = trainer("cuda", tmp_path)
    gpu.train(ds, None, max_epochs=1)
    cpu = trainer("cpu", tmp_path)
    assert cpu.epoch == 1 and cpu.model.hash_table.device.type == "cpu"
    same(gpu, cpu)
    assert "no cpu generator state" in (tmp_path / "log_lidar_nerf.txt").read_text()
    cpu.epoch = 2
    cpu.save_checkpoint(full=True)
    back = trainer("cuda", tmp_path)
    assert back.epoch == 2 and back.model.hash_table.device.type == "cuda"
    same(cpu, back)


def _mvl_small(tmp_path, monkeypatch):
    """A small NeRF-MVL set (2 train frames of 32 x 128) traced on the card by
    the port's tool, and an fp32 4-level field's configs for it."""
    from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset
    from lidarnerf_tpu_torch.models.renderer import RenderConfig
    from lidarnerf_tpu_torch.nerf.train_step import TrainConfig
    from lidarnerf_tpu_torch.tools import make_synth_mvl

    monkeypatch.setattr(make_synth_mvl, "H", 32)
    monkeypatch.setattr(make_synth_mvl, "W", 128)
    make_synth_mvl.main(str(tmp_path), n_train=2, n_val=1)
    ds = NeRFMVLDataset(root_path=str(tmp_path), scale=0.1, num_rays_lidar=256)
    cfg = TrainConfig(scale=0.1, num_rays_lidar=256, H_lidar=32, W_lidar=128,
                      intrinsics_lidar=ds.intrinsics_lidar)
    rcfg = RenderConfig(num_steps=64, upsample_steps=8, min_near_lidar=0.1, min_near=0.1)
    return ds, cfg, rcfg


def _mvl_net():
    from lidarnerf_tpu_torch.models.network import NeRFNetwork

    return NeRFNetwork(encoding="blockhash", num_levels=4, log2_hashmap_size=14,
                       desired_resolution=64, hidden_dim=32,
                       generator=torch.Generator().manual_seed(0))


def test_mvl_masked_step_on_cuda_matches_the_cpu(require_cuda, tmp_path, monkeypatch):
    """One masked (NeRF-MVL) training step on the card (kernels B1, B2) and on
    the CPU from the same weights and injected pool draws, noise and u: the
    loss within 1e-4 relative and each gradient within 1e-3 of its tensor's
    largest entry (5e-3 for the LiDAR head), chip_smoke.py's GPU-vs-CPU
    tolerances for a training step."""
    from lidarnerf_tpu_torch.nerf.train_step import make_train_step, pool_draws

    ds, cfg, rcfg = _mvl_small(tmp_path, monkeypatch)
    _, _, vi, vc = ds.device_arrays("cpu")
    gen = torch.Generator().manual_seed(3)
    draws = {"pool_draws": pool_draws(vc[1], 256, gen), "noise": torch.rand((256, 64), generator=gen),
             "u": torch.rand((256, 8), generator=gen)}
    results = {}
    for dev in ("cuda", "cpu"):
        net = _mvl_net()
        step = make_train_step(net, cfg, rcfg, masked_sampling=True, device=dev)
        m = step(*ds.device_arrays(dev), 1, draws={k: v.to(dev) for k, v in draws.items()})
        assert m["skipped_nonfinite"] == 0.0
        results[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in net.named_parameters()
                                          if p.grad is not None})
    (loss_g, grads_g), (loss_c, grads_c) = results["cuda"], results["cpu"]
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    assert grads_g.keys() == grads_c.keys()
    for k, ref in grads_c.items():
        peak = ref.abs().max().item()
        tol = 5e-3 if k.startswith("lidar_color_net") else 1e-3
        assert peak > 0 and (grads_g[k] - ref).abs().max().item() <= tol * peak, k


def test_mvl_masked_step_reads_nothing_back(require_cuda, tmp_path, monkeypatch):
    """The masked sampler draws its pool positions on the card: a whole step
    (sampler, render, loss, backward and the guarded Adam update, whose flag
    stays on the device) runs under torch.cuda.set_sync_debug_mode("error"),
    and every drawn pixel is unmasked."""
    from lidarnerf_tpu_torch.nerf import train_step

    ds, cfg, rcfg = _mvl_small(tmp_path, monkeypatch)
    poses, images, vi, vc = ds.device_arrays("cuda")
    net = _mvl_net().cuda()
    step = train_step.make_train_step(net, cfg, rcfg, masked_sampling=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    drawn = []
    sample = train_step.sample_pixels

    def keep(*args, **kw):
        drawn.append(sample(*args, **kw))
        return drawn[-1]

    monkeypatch.setattr(train_step, "sample_pixels", keep)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = step(poses, images, vi, vc, 0, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(m["loss"].item()) and net.hash_table.grad is not None
    assert m["skipped_nonfinite"].item() == 0.0 and int(step.optimizer.count) == 1
    valid = images[0, ..., 0].reshape(-1) > -1
    assert valid[drawn[0]].all() and drawn[0].shape == (256,)


# --- the captured training step (nerf/train_step.make_epoch_step) ---

def _graph_opt(**kw):
    """The CLI's kitti360_1908 options at a small width (256 rays, 32 + 8
    samples, a 2^14 table at 256) on data_synth_drive60."""
    import json

    from lidarnerf_tpu_torch import main_lidarnerf as cli

    root = Path(__file__).resolve().parent.parent
    with open(root / "data_synth_drive60" / "scene_constants.json") as f:
        c = json.load(f)
    opt = cli.get_arg_parser().parse_args([
        "--config", str(root / "configs" / "kitti360_1908.txt"), "--iters", "120",
        "--num_steps", "32", "--upsample_steps", "8", "--num_rays_lidar", "256",
        "--desired_resolution", "256", "--log2_hashmap_size", "14", "--occ_grid_size", "32",
        "--occ_update_interval", "4"])
    opt.enable_lidar = True
    cli.apply_macros(opt)
    opt.min_near = opt.min_near_lidar = opt.scale = c["scale"]
    opt.H_lidar, opt.W_lidar, opt.intrinsics_lidar = 66, 1030, (2.0, 26.9)
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt, c


def _graph_case(case, tmp_path, monkeypatch):
    """(options, training set) of a sampler/variant case: default, seg, win,
    fast (--fast: a 32^3 grid refreshed every 4 steps), masked (NeRF-MVL) or
    seams (--seam_tie 1 --alpha_seam 100 --seam_sync_hashed 256: the sync
    before steps 0, 16, 32, ... between replays)."""
    from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset

    for name in ("LIDARNERF_SEG_KERNELS", "LIDARNERF_WIN_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    if case in ("seg", "win"):
        monkeypatch.setenv(f"LIDARNERF_{case.upper()}_KERNELS", "1")
    if case == "masked":
        ds, cfg, _ = _mvl_small(tmp_path, monkeypatch)
        opt, _ = _graph_opt(dataloader="nerf_mvl", H_lidar=32, W_lidar=128,
                            intrinsics_lidar=ds.intrinsics_lidar, scale=0.1, min_near=0.1,
                            min_near_lidar=0.1)
        return opt, ds
    kw = {"fast": {"occ_sampling": True},
          "seams": {"seam_tie": 1, "alpha_seam": 100.0, "seam_sync_hashed": 256}}
    opt, c = _graph_opt(**kw.get(case, {}))
    root = Path(__file__).resolve().parent.parent
    ds = KITTI360Dataset(root_path=str(root / "data_synth_drive60"), scale=c["scale"],
                         offset=c["offset"], num_rays_lidar=256)
    return opt, ds


def _graph_trainer(opt, fuse, ws=None):
    from types import SimpleNamespace

    from lidarnerf_tpu_torch import main_lidarnerf as cli
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    return Trainer("lidar_nerf", SimpleNamespace(**{**vars(opt), "fuse_epoch": fuse}),
                   cli.build_model(opt), mute=True, ema_decay=0.95,
                   workspace=None if ws is None else str(ws))


def _same_state(a, b):
    """Weights, EMA, both Adam moments and counts, the generator, the grid."""
    assert a.stats["step_loss"] == b.stats["step_loss"] and a.global_step == b.global_step
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for k, v in a.ema_params.items():
        assert torch.equal(v, b.ema_params[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (sa["count"], sa["schedule_count"]) == (sb["count"], sb["schedule_count"])
    for kind in ("mu", "nu"):
        for k, v in sa[kind].items():
            assert torch.equal(v, sb[kind][k]), (kind, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert (a.occ_grid is None) == (b.occ_grid is None)
    assert a.occ_grid is None or torch.equal(a.occ_grid, b.occ_grid)


def _device_launches(fn):
    """fn() with the count on the card on (ops/device_counts.py): {kernel
    wrapper name: its kernels that ran on the card}, replays of a CUDA graph
    included (each replay runs the add captured beside each launch)."""
    from lidarnerf_tpu_torch.ops import device_counts

    device_counts.enable("cuda")
    torch.cuda.synchronize()
    device_counts.reset()
    fn()
    torch.cuda.synchronize()
    counts = device_counts.counts()
    return {k: counts[k] for k in block_hash_cuda.launch_counts()}


@pytest.mark.parametrize("case", ["default", "seg", "win", "fast", "masked", "seams"])
def test_captured_epochs_equal_the_eager_epochs(require_cuda, tmp_path, monkeypatch, case):
    """Two epochs (patch 1, then the [2, 8] patches: two graphs) with the
    step captured (`--fuse_epoch 1`) and eager (`0`), from the same state
    and generator: the same step losses, weights, EMA, Adam state, generator
    state and grid, bit for bit, and the same kernels run on the card as
    the eager run's wrappers launch. The graphed run's wrappers count only
    the warm-up and the capture of each graph: its replays run no Python."""
    opt, ds = _graph_case(case, tmp_path, monkeypatch)
    runs, counts, device = [], [], []
    for fuse in (0, 1):
        t = _graph_trainer(opt, fuse)
        block_hash_cuda.reset_counts()
        device.append(_device_launches(lambda: t.train(ds, None, max_epochs=2)))
        runs.append(t)
        counts.append(block_hash_cuda.launch_counts())
    eager, graphed = runs
    graphs = [g for f in graphed._epoch_fns.values() for g in f.graphs.values()]
    assert len(graphs) == 2 and all(g.graph is not None for g in graphs)
    assert not any(f.graphs for f in eager._epoch_fns.values())
    _same_state(eager, graphed)
    assert device[0] == device[1] == counts[0] and sum(counts[0].values()) > 0
    steps = 2 * len(ds)
    refresh = {"block_hash_fwd": len(range(0, steps, 4)) if case == "fast" else 0}
    per_step = {k: (n - refresh.get(k, 0)) // steps for k, n in counts[0].items()}
    assert counts[0] == {k: n * steps + refresh.get(k, 0) for k, n in per_step.items()}
    assert counts[1] == {k: n * 2 * len(graphs) + refresh.get(k, 0) for k, n in per_step.items()}
    assert not any(graphed.stats["skipped"]) and np.isfinite(graphed.stats["step_loss"]).all()


def test_two_captured_runs_repeat_bit_for_bit(require_cuda, tmp_path, monkeypatch):
    """Two trainers from the same seed, each capturing its own graphs: three
    epochs (captures in the first two, replays only in the third) equal bit
    for bit."""
    opt, ds = _graph_case("default", tmp_path, monkeypatch)
    runs = []
    for _ in range(2):
        t = _graph_trainer(opt, 1)
        t.train(ds, None, max_epochs=3)
        runs.append(t)
    _same_state(*runs)


def test_graph_resume_equals_the_uninterrupted_run(require_cuda, tmp_path, monkeypatch):
    """Epochs 1-2 captured and replayed, then a new trainer resumes from the
    checkpoint (the generator state after the replays included) and captures
    anew: its third epoch repeats the uninterrupted captured run bit for bit."""
    opt, ds = _graph_case("fast", tmp_path, monkeypatch)
    whole = _graph_trainer(opt, 1, tmp_path / "whole")
    whole.train(ds, None, max_epochs=3)
    first = _graph_trainer(opt, 1, tmp_path / "resumed")
    first.train(ds, None, max_epochs=2)
    resumed = _graph_trainer(opt, 1, tmp_path / "resumed")
    assert resumed.epoch == 2 and int(resumed.optimizer.count) == 2 * len(ds)
    resumed.train(ds, None, max_epochs=3)
    _same_state(resumed, whole)


def test_capture_refuses_a_host_read(require_cuda):
    """A step that reads the device inside the capture raises (no quiet
    fall-back to the eager loop): the capture is what proves that a replayed
    epoch reads nothing back."""
    from lidarnerf_tpu_torch.nerf import train_step

    step = lambda *a, **k: {m: torch.zeros((), device="cuda") + float(a[4].item())  # noqa: E731
                            for m in train_step.METRICS}
    captured = train_step._CapturedStep(step, train_step.GraphPool(torch.device("cuda")))
    x = torch.zeros((3, 1), device="cuda")
    with pytest.raises(Exception):
        captured.epoch(x, x, x, x, np.arange(3), None, None, lambda i: None)


def test_native_library_projects_an_hdl64_frame_as_numpy(require_cuda, tmp_path):
    """The host C++ projection builds on the card's machine (g++, nvcc's host
    compiler) and projects one HDL-64-sized sweep of the synthetic street
    (~131k points) to numpy's pano within tests/test_native.py's tolerance."""
    from lidarnerf_tpu_torch import native
    from lidarnerf_tpu_torch.dataset import convert
    from lidarnerf_tpu_torch.preprocess.kitti360_loader import KITTI360Loader
    from lidarnerf_tpu_torch.tools.make_synth_drive import write_kitti360_raw

    native.build()
    assert native.route() == "native", native.build_error()
    (count,) = write_kitti360_raw(tmp_path, [1908])
    pts = KITTI360Loader(tmp_path).load_lidar_points("2013_05_28_drive_0000", 1908)
    assert pts.shape == (count, 4) and count > 110_000
    pano_n, inten_n = native.lidar_to_pano_with_intensities(pts, 66, 1030, (2.0, 26.9))
    pano_p, inten_p = convert.lidar_to_pano_with_intensities(pts, 66, 1030, (2.0, 26.9))
    np.testing.assert_allclose(pano_n, pano_p, rtol=1e-6, atol=1e-9)
    same = pano_n == pano_p
    np.testing.assert_allclose(inten_n[same], inten_p[same], rtol=1e-6)
    assert (pano_n > 0).mean() > 0.8


def test_onramp_dataset_trains_on_cuda(require_cuda, tmp_path):
    """A KITTI-like raw tree written into tmp_path goes through the port's
    check: stages 1-4 build its panos, transforms and scene constants on the
    host, stage 5 trains it four steps through the CLI on CUDA (B1, B2)."""
    from lidarnerf_tpu_torch.tools.check_dataset import check_dataset
    from lidarnerf_tpu_torch.tools.make_synth_drive import write_kitti360_raw

    # the check's transforms take the whole window's poses (frames 1908-1971)
    write_kitti360_raw(tmp_path / "KITTI-360", list(range(1908, 1972)), azimuth_steps=256)
    block_hash_cuda.reset_counts()
    res = check_dataset(str(tmp_path / "KITTI-360"), str(tmp_path / "out"), max_frames=2,
                        train_steps=4, workspace=str(tmp_path / "ws"))
    trainer = res["trainer"]
    assert trainer.device.type == "cuda" and trainer.global_step == 4
    assert np.isfinite(trainer.stats["step_loss"]).all() and not any(trainer.stats["skipped"])
    counts = block_hash_cuda.launch_counts()
    assert counts["block_hash_fwd"] > 0 and counts["block_hash_bwd"] > 0
    assert res["route"] == "native" and 0 < res["scale"] < 1
    assert (tmp_path / "ws" / "log_lidar_nerf.txt").is_file()


# --- the hash grid (plain PyTorch on both devices; no kernel of its own) ---

def _hashgrid_case(Q, seed):
    from lidarnerf_tpu_torch.ops import hash_grid

    spec = hash_grid.make_hash_grid_spec(log2_hashmap_size=19, desired_resolution=32768)
    gen = torch.Generator().manual_seed(seed)
    x = _rays(np.random.RandomState(seed), Q, 768)  # sample runs along rays, as a chunk orders them
    x = torch.from_numpy(np.clip(x, 0.0, 1.0).astype(np.float32))
    table = torch.rand((spec.table_rows, 2), generator=gen) * 2 - 1
    g = torch.randn((Q, spec.output_dim), generator=gen)
    return hash_grid, spec, x, table, g


def test_hashgrid_forward_on_cuda_matches_the_cpu(require_cuda):
    """The full-width spec (dense and hashed levels) on the card and on the
    CPU: the same float32 products, the corners summed in another order."""
    hash_grid, spec, x, table, _ = _hashgrid_case(200_000, 0)
    gpu = hash_grid.hash_grid_encode(x.cuda(), table.cuda(), spec).cpu()
    cpu = hash_grid.hash_grid_encode(x, table, spec)
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=1e-6)


def test_hashgrid_table_gradient_repeats_bit_for_bit_on_cuda(require_cuda):
    """Two calls on one input (a NaN in g included) give the same bits on the
    card, and the CPU's: every term is rounded once and added as an integer."""
    hash_grid, spec, x, _, g = _hashgrid_case(200_000, 1)
    g[7, 3] = float("nan")
    g[9, 30] = float("inf")
    a = hash_grid.encode_bwd(x.cuda(), g.cuda(), spec)
    b = hash_grid.encode_bwd(x.cuda(), g.cuda(), spec)
    assert torch.equal(a.isnan(), b.isnan()) and a.isnan().any()
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    cpu = hash_grid.encode_bwd(x, g, spec)
    assert torch.equal(torch.nan_to_num(a.cpu()), torch.nan_to_num(cpu))


def test_captured_hashgrid_step_equals_the_eager_step(require_cuda, tmp_path, monkeypatch):
    """--encoding hashgrid: two epochs captured and eager from one state are
    equal bit for bit, no kernel of the port runs on the card, and the
    block-hash variant switch keeps no graph of its own."""
    opt, ds = _graph_case("seg", tmp_path, monkeypatch)  # the switch set: not read
    opt.encoding = "hashgrid"
    runs, device = [], []
    for fuse in (0, 1):
        t = _graph_trainer(opt, fuse)
        block_hash_cuda.reset_counts()
        device.append(_device_launches(lambda: t.train(ds, None, max_epochs=2)))
        runs.append(t)
        assert not any(block_hash_cuda.launch_counts().values())
    eager, graphed = runs
    assert not any(device[0].values()) and not any(device[1].values())
    assert [list(f.graphs) for f in graphed._epoch_fns.values()] == [["default"], ["default"]]
    _same_state(eager, graphed)
    assert not any(graphed.stats["skipped"]) and np.isfinite(graphed.stats["step_loss"]).all()


def test_rgb_render_on_cuda_matches_the_cpu(require_cuda):
    """A small RGB frame (fp32 hashgrid field, the background sphere) on the
    card and on the CPU from the same weights."""
    from lidarnerf_tpu_torch.dataset.base import get_rays
    from lidarnerf_tpu_torch.models.network import NeRFNetwork
    from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays_staged

    net = NeRFNetwork(desired_resolution=2048, log2_hashmap_size=16, hidden_dim=32, bg_radius=8.0,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.hash_table.mul_(1e4)
        net.bg_table.mul_(1e4)
    cfg = RenderConfig(num_steps=64, upsample_steps=8, min_near=0.05, cal_lidar_color=False,
                       bg_radius=8.0)
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.1, -0.2, 0.05])
    rays = get_rays(pose[None], (40.0, 40.0, 32.0, 24.0), 48, 64)
    cpu = render_rays_staged(net, rays["rays_o"][0], rays["rays_d"][0], cfg, chunk=1024)
    net.cuda()
    gpu = render_rays_staged(net, rays["rays_o"][0].cuda(), rays["rays_d"][0].cuda(), cfg,
                             chunk=1024)
    for k in ("depth", "image", "weights_sum"):
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=1e-3, atol=1e-5)


@pytest.fixture
def no_tf32(monkeypatch):
    """Full float32 products and convolutions on the card (cuDNN's TF32 is on by default)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def test_raydrop_mlp_on_cuda_matches_the_cpu(require_cuda, no_tf32):
    """The PCGen ray-drop MLP (D 4, W 128, i_embed -1; its seeded init is made
    on the CPU, so both devices start equal), on a full 66 x 1030 pano's rays:
    the logits within 1e-5 of max|logit|, a batch's gradients within 1e-4 of
    each leaf's max|g|, and three updates from the same gradients (the
    card's fused Adam, the CPU's) within 1e-6 of each leaf's max|p|. Whole
    runs are not compared: a step of Adam moves a weight by ~lr whatever the
    size of its gradient, so gradients at the level of rounding move the two
    devices' weights apart by ~lr within a few steps."""
    from lidarnerf_tpu_torch.lidarnvs.raydrop_pcgen import RayDropTrainer, run_network

    rs = np.random.RandomState(0)
    n = 66 * 1030
    dirs = rs.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays = torch.from_numpy(np.concatenate(
        [dirs, rs.uniform(0, 80, (n, 1)), rs.uniform(size=(n, 1)), dirs[:, 2:3] < 0],
        1).astype(np.float32))
    gpu, cpu = RayDropTrainer(i_embed=-1, device="cuda"), RayDropTrainer(i_embed=-1, device="cpu")
    with torch.no_grad():
        want = run_network(rays[:, :5], cpu.model, cpu.embed_fn, cpu.embeddirs_fn)
        got = run_network(rays[:, :5].cuda(), gpu.model, gpu.embed_fn, gpu.embeddirs_fn).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    batch = rays[:2048]
    gpu.loss_fn(batch.cuda()).backward()
    cpu.loss_fn(batch).backward()
    for (k, a), b in zip(gpu.model.named_parameters(), cpu.model.parameters()):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=0,
                                   atol=1e-4 * float(b.grad.abs().max()), msg=k)
    grads = [p.grad.clone() for p in cpu.model.parameters()]
    for _ in range(3):
        for t in (gpu, cpu):
            for p, g in zip(t.model.parameters(), grads):
                p.grad = g.to(p.device)
            t.optimizer.param_groups[0]["lr"] = t.lr_fn(t.count)
            t.optimizer.step()
            t.count += 1
    for (k, a), b in zip(gpu.model.state_dict().items(), cpu.model.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6 * float(b.abs().max()), msg=k)


@pytest.mark.parametrize("bilinear", [False, True], ids=["transposed", "bilinear"])
def test_unet_on_cuda_matches_the_cpu(require_cuda, no_tf32, bilinear):
    """The UNet (64-...-1024) on one full 66 x 1030 frame from the same
    weights: evaluation-mode logits within 1e-4 of max|logit|, training-mode
    logits (batch statistics) within 1e-3, and the running statistics that
    forward leaves within 1e-4 of each buffer's max."""
    from lidarnerf_tpu_torch.lidarnvs.unet import UNet

    net = UNet(bilinear=bilinear, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # running statistics off their init
        for name, buf in net.named_buffers():
            buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(1)) * 0.5)
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 10, 66, 1030).astype(np.float32))
    gpu = UNet(bilinear=bilinear).cuda()
    gpu.load_state_dict(net.state_dict())
    for train, tol in ((False, 1e-4), (True, 1e-3)):
        net.train(train)
        gpu.train(train)
        with torch.no_grad():
            want = net(x)
            got = gpu(x.cuda()).cpu()
        assert got.shape == (1, 1, 66, 1030)
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))
    for (k, a), b in zip(gpu.state_dict().items(), net.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()), msg=k)


def test_unet_trainer_on_cuda_matches_the_cpu(require_cuda, no_tf32, tmp_path):
    """Two UNet ray-drop updates (batch 2, 66 x 1030) on the card and on the
    CPU from the same seeded weights: the first loss within 1e-4 relative,
    the second within 1e-2 (the training gradient is ill-conditioned in
    float32: tests/test_torch_lidarnvs_nets.py); the step reads nothing back
    to the host."""
    from lidarnerf_tpu_torch.lidarnvs.raydrop_unet import UNetRaydropTrainer

    rs = np.random.RandomState(2)
    images = rs.rand(2, 66, 1030, 10).astype(np.float32)
    masks = (rs.rand(2, 66, 1030) > 0.3).astype(np.float32)
    gpu = UNetRaydropTrainer(learning_rate=1e-4, device="cuda")
    cpu = UNetRaydropTrainer(learning_rate=1e-4, device="cpu")
    on_card = torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg = [gpu.step(*on_card) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    lc = [float(cpu.step(images, masks)) for _ in range(2)]
    lg = [float(x) for x in lg]
    np.testing.assert_allclose(lg[0], lc[0], rtol=1e-4)
    np.testing.assert_allclose(lg[1], lc[1], rtol=1e-2)


def _seam_spec():
    """The KITTI-360 model's table: 16 levels, 2^19, desired resolution 32768."""
    return block_hash.make_block_hash_spec(num_levels=16, log2_hashmap_size=19,
                                           desired_resolution=32768)


def test_seam_functions_on_cuda_match_the_cpu(require_cuda):
    """tie_dense_seams, sync_hashed_seams and block_hash_seam_loss at the full
    table on the card against the CPU on the same table and draws: the tie,
    its gradient and the sync bit for bit, the loss within 1e-6 relative and
    its order-free gradient bit for bit."""
    spec = _seam_spec()
    g = torch.Generator().manual_seed(0)
    table = torch.randn((spec.table_rows, 128), generator=g)
    up = torch.randn((spec.table_rows, 128), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        t = table.detach().to(dev).clone().requires_grad_()
        tied = block_hash.tie_dense_seams(t, spec)
        (tied * up.to(dev)).sum().backward()
        sync = block_hash.sync_hashed_seams(table.to(dev).clone(), spec, draws={
            k: (m.to(dev), o.to(dev)) for k, (m, o) in block_hash.seam_draws(
                spec, 4096, torch.Generator().manual_seed(1), hashed_only=True).items()})
        t2 = table.detach().to(dev).clone().requires_grad_()
        loss = block_hash.block_hash_seam_loss(t2, spec, draws={
            k: (m.to(dev), o.to(dev)) for k, (m, o) in block_hash.seam_draws(
                spec, 512, torch.Generator().manual_seed(2)).items()})
        loss.backward()
        out[dev] = [x.detach().cpu() for x in (tied, t.grad, sync, loss, t2.grad)]
    (tied, tgrad, sync, loss, lgrad), gpu = out["cpu"], out["cuda"]
    for name, a, b in (("tie", gpu[0], tied), ("tie gradient", gpu[1], tgrad),
                       ("sync", gpu[2], sync), ("seam loss gradient", gpu[4], lgrad)):
        assert torch.equal(a, b), (name, (a - b).abs().max().item(), (a != b).sum().item())
    assert not torch.equal(sync, table)
    torch.testing.assert_close(gpu[3], loss, rtol=1e-6, atol=0)


def test_seam_sync_on_cuda_draws_on_the_card_without_a_host_read(require_cuda):
    """The sync and the loss draw their samples from a generator on the card
    inside a CUDA graph capture (no host read), and a replay syncs again."""
    spec = _seam_spec()
    table = torch.randn((spec.table_rows, 128), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    before = table.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, as the captured step's
        block_hash.sync_hashed_seams(table, spec, gen, 256)
        block_hash.block_hash_seam_loss(table, spec, gen, 512)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        block_hash.sync_hashed_seams(table, spec, gen, 256)
        loss = block_hash.block_hash_seam_loss(table, spec, gen, 512)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(table, before) and torch.isfinite(loss)
