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


def test_block_hash_kernel_empty_and_no_grad_guard(require_cuda):
    spec = block_hash.make_block_hash_spec(**SPECS["small"])
    table = torch.zeros(spec.table_rows, 128, device="cuda", requires_grad=True)
    x = torch.rand(7, 3, device="cuda")
    with pytest.raises(NotImplementedError):
        block_hash.block_hash_encode(x, table, spec)
    with torch.no_grad():
        assert block_hash.block_hash_encode(x[:0], table, spec).shape == (0, spec.output_dim)
