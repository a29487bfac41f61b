"""Kernel tests that need an NVIDIA GPU with nvcc (sm_90a); they skip elsewhere.

This file imports no JAX, so it also runs where only PyTorch is installed:
    python -m pytest -m cuda tests/test_torch_cuda.py -q
Each kernel is held against its plain PyTorch version on the same inputs.
"""

import numpy as np
import pytest
import torch

from lidarnerf_tpu_torch.ops import block_hash, block_hash_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _points(Q, seed, coherent):
    rs = np.random.RandomState(seed)
    if coherent:
        n = max(1, Q // 512)
        o = rs.uniform(0.3, 0.7, (n, 1, 3))
        d = rs.normal(size=(n, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        x = (o + d * np.linspace(0.0, 0.5, -(-Q // n))[None, :, None]).reshape(-1, 3)[:Q]
    else:
        x = rs.uniform(-0.05, 1.05, (Q, 3))
    x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.5]]
    return torch.from_numpy(x.astype(np.float32)).cuda()


SPECS = {
    "small": dict(num_levels=4, log2_hashmap_size=14, desired_resolution=32768),
    "full_width": dict(num_levels=16, log2_hashmap_size=19, desired_resolution=32768),
}


@pytest.mark.parametrize("coherent", [True, False], ids=["rays", "uniform"])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_block_hash_kernel_matches_plain(require_cuda, spec_name, coherent):
    spec = block_hash.make_block_hash_spec(**SPECS[spec_name])
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(spec.table_rows, 128, generator=g, device="cuda")
    x = _points(20000, 1, coherent)
    before = block_hash_cuda.launches
    out = block_hash.block_hash_encode(x, table, spec)
    torch.cuda.synchronize()
    assert block_hash_cuda.launches == before + 1
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
    x = _points(3000, 2, coherent=True)
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


@pytest.mark.parametrize("coherent", [True, False], ids=["rays", "uniform"])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_block_hash_bwd_kernel_matches_plain(require_cuda, spec_name, coherent):
    spec = block_hash.make_block_hash_spec(**SPECS[spec_name])
    x = _points(20000, 3, coherent)
    g = torch.randn(20000, spec.output_dim, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    before = block_hash_cuda.bwd_launches
    out = block_hash_cuda.block_hash_bwd(x, g, spec)
    torch.cuda.synchronize()
    assert block_hash_cuda.bwd_launches == before + 1
    _assert_bwd_close(out, x, g, spec)


VARIANT_ENV = {"seg": "LIDARNERF_SEG_KERNELS", "win": "LIDARNERF_WIN_KERNELS"}


@pytest.mark.parametrize("coherent", [True, False], ids=["rays", "uniform"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_forward_equals_b1_bit_for_bit(require_cuda, variant, spec_name, coherent):
    """B3a and B4a load a run's or window's row once; the features are B1's."""
    spec = block_hash.make_block_hash_spec(**SPECS[spec_name])
    table = torch.randn(spec.table_rows, 128, generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda")
    x = _points(20000, 6, coherent)
    counts = block_hash_cuda.launch_counts()
    out = block_hash_cuda.FWD[variant](x, table, spec)
    ref = block_hash_cuda.block_hash_fwd(x, table, spec)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    after = block_hash_cuda.launch_counts()
    assert after[f"block_hash_{variant}_fwd"] == counts[f"block_hash_{variant}_fwd"] + 1


@pytest.mark.parametrize("coherent", [True, False], ids=["rays", "uniform"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_run_collapsing_backward_matches_plain(require_cuda, variant, spec_name, coherent):
    """B3b and B4b within B2's slack of encode_bwd_plain and of their own
    run-structured plain versions."""
    spec = block_hash.make_block_hash_spec(**SPECS[spec_name])
    x = _points(20000, 7, coherent)
    g = torch.randn(20000, spec.output_dim, generator=torch.Generator(device="cuda").manual_seed(8),
                    device="cuda")
    out = block_hash_cuda.BWD[variant](x, g, spec)
    torch.cuda.synchronize()
    _assert_bwd_close(out, x, g, spec)
    own = block_hash.ENCODE_BWD_PLAIN[variant](x, g, spec)
    S = block_hash.encode_bwd_plain(x, g.abs(), spec)
    assert ((out - own).abs() <= 1e-5 * S + 1e-7).all()


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
    x = _points(5000, 9, coherent=True)
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
