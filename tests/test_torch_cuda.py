"""Kernel tests that need an NVIDIA GPU with nvcc (sm_90a); they skip elsewhere.

This file imports no JAX, so it also runs where only PyTorch is installed:
    python -m pytest -m cuda tests/test_torch_cuda.py -q
Each kernel is held against its plain PyTorch version on the same inputs.
"""

import numpy as np
import pytest
import torch

from lidarnerf_tpu_torch.ops import (
    block_hash,
    block_hash_cuda,
    fused_mlp,
    fused_mlp_cuda,
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


@pytest.mark.parametrize("kind", ["rays", "uniform"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_backward_matches_plain(require_cuda, variant, spec_name, kind):
    """B3b and B4b within B2's slack of encode_bwd_plain and of their own
    run-structured plain versions."""
    spec = block_hash.make_block_hash_spec(**SPECS[spec_name])
    x = _points(20000, 7, kind)
    g = torch.randn(20000, spec.output_dim, generator=torch.Generator(device="cuda").manual_seed(8),
                    device="cuda")
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
                    "faces", "single"]


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


@pytest.mark.parametrize("variant", list(block_hash.VARIANTS))
def test_backward_kernels_propagate_non_finite(require_cuda, variant):
    """A NaN and an Inf in g give non-finite table entries exactly where the
    plain version has them (the guarded update then skips the step), and
    the result still repeats bit for bit."""
    spec = block_hash.make_block_hash_spec(**SPECS["full_width"])
    x = _points(20000, 11, "rays")
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


@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_empty_input(require_cuda, variant):
    spec = block_hash.make_block_hash_spec(**SPECS["small"])
    x = torch.zeros(0, 3, device="cuda")
    table = torch.zeros(spec.table_rows, 128, device="cuda")
    counts = block_hash_cuda.launch_counts()
    assert block_hash_cuda.FWD[variant](x, table, spec).shape == (0, spec.output_dim)
    grad = block_hash_cuda.BWD[variant](x, torch.zeros(0, spec.output_dim, device="cuda"), spec)
    assert grad.shape == (spec.table_rows, 128) and not grad.any()
    assert block_hash_cuda.launch_counts() == counts


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


# B5: the model's nets (sigma, LiDAR head), a relu head and a wide first layer
B5_NETS = {
    "sigma": ([32, 64, 16], "none"),
    "lidar_head": ([90, 64, 64, 2], "sigmoid"),
    "relu": ([16, 32, 8], "relu"),
    "wide": ([256, 64, 3], "none"),
}


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
    assert fused_mlp_cuda.launches == before


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
