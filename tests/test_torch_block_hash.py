"""Port parity: the block-hash encoder of lidarnerf_tpu_torch vs the JAX package.

The port's plain encoder is held against both JAX forms of the function: the
XLA gather path `_encode_xla` and the Pallas kernel B1 (`_fwd_from_prep`) run
in interpret mode. The small spec keeps a dense level 0 and hashed levels
1-3, and level 3's block coordinates reach 10,922, so the uint32 products of
the prime-XOR hash wrap.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.ops import block_hash as bh
from lidarnerf_tpu.ops import block_hash_pallas as bhp
from lidarnerf_tpu_torch.ops import block_hash as tbh

SMALL = dict(num_levels=4, log2_hashmap_size=14, desired_resolution=32768)


def _levels(spec):
    return [(lv.scale, lv.max_cell, lv.blocks_axis, lv.dense) for lv in spec.levels]


@pytest.mark.parametrize(
    "kw", [SMALL, dict(num_levels=16, log2_hashmap_size=19, desired_resolution=32768)],
    ids=["small", "full_width"],
)
def test_spec_levels_equal(kw):
    ref = bh.make_block_hash_spec(**kw)
    spec = tbh.make_block_hash_spec(**kw)
    assert _levels(spec) == _levels(ref)
    assert spec.blocks_per_level == ref.blocks_per_level
    assert spec.table_rows == ref.table_rows


def test_small_spec_has_dense_and_wrapping_hashed_levels():
    spec = tbh.make_block_hash_spec(**SMALL)
    assert [lv.dense for lv in spec.levels] == [True, False, False, False]
    top = spec.levels[-1].blocks_axis - 1
    assert top * 2654435761 > 0xFFFFFFFF  # the hash products wrap at this level


def _inputs(Q, seed, ray_coherent):
    rs = np.random.RandomState(seed)
    if ray_coherent:
        # samples along a few rays, as the renderer feeds them
        n_rays = max(1, Q // 500)
        o = rs.uniform(0.3, 0.7, (n_rays, 1, 3))
        d = rs.normal(size=(n_rays, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.linspace(0.0, 0.5, -(-Q // n_rays))[None, :, None]
        x = (o + d * t).reshape(-1, 3)[:Q]
    else:
        x = rs.uniform(-0.05, 1.05, (Q, 3))  # some points out of [0, 1]
    x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.5]]  # the edges
    return x.astype(np.float32)


def _table(spec, seed):
    return np.random.RandomState(seed).randn(spec.table_rows, 128).astype(np.float32)


def test_level_rows_equal_jax():
    spec_j = bh.make_block_hash_spec(**SMALL)
    spec = tbh.make_block_hash_spec(**SMALL)
    x = _inputs(3000, 0, ray_coherent=False).clip(0.0, 1.0)
    for li, (lj, lt) in enumerate(zip(spec_j.levels, spec.levels)):
        rows_j, w_j = bh.level_indices_and_weights(jnp.asarray(x), lj, li, spec_j)
        rows_t, w_t = tbh.level_indices_and_weights(torch.from_numpy(x), lt, li, spec)
        np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
        # same float32 arithmetic in the same order: equal to the bit
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("ray_coherent", [True, False], ids=["rays", "uniform"])
def test_plain_encode_matches_encode_xla(ray_coherent):
    spec_j = bh.make_block_hash_spec(**SMALL)
    spec = tbh.make_block_hash_spec(**SMALL)
    x = _inputs(5000, 1, ray_coherent)
    table = _table(spec, 2)
    ref = bh.block_hash_encode(jnp.asarray(x), jnp.asarray(table), spec_j, False)
    out = tbh.block_hash_encode(torch.from_numpy(x), torch.from_numpy(table), spec)
    assert out.shape == (5000, spec.output_dim)
    # fp32 both sides, the 8 weighted corners summed in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    if not ray_coherent:
        outside = ((x < 0) | (x > 1)).any(-1)
        assert outside.any()
        assert (out.numpy()[outside] == 0).all()


def test_plain_encode_matches_pallas_b1_interpret():
    spec_j = bh.make_block_hash_spec(**SMALL)
    spec = tbh.make_block_hash_spec(**SMALL)
    Q = 5000  # not a multiple of the kernel's 4096-query chunk
    x = _inputs(Q, 3, ray_coherent=True)
    table = _table(spec, 4)
    rows, lf, _ = bhp.prep_inputs_padded(jnp.asarray(x), spec_j)
    ref = bhp._fwd_from_prep(rows, lf, jnp.asarray(table), Q, spec_j, interpret=True)
    # the out-of-range zeroing that block_hash.py:258-259 applies after B1
    outside = ((x < 0) | (x > 1)).any(-1, keepdims=True)
    assert outside.any() and not outside.all()
    ref = np.where(outside, 0.0, np.asarray(ref))
    out = tbh.encode_plain(torch.from_numpy(x), torch.from_numpy(table), spec)
    # B1 reduces the lanes through a split-bf16 (hi + lo) product
    # (block_hash_pallas.py:93-105): each weighted corner keeps ~2^-18 of its
    # size, and the corner weights sum to 1, so the error stays below
    # 2^-17 of the largest table entry
    atol = 2.0**-17 * np.abs(table).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)


def test_plain_encode_table_grad_matches_jax():
    spec_j = bh.make_block_hash_spec(**SMALL)
    spec = tbh.make_block_hash_spec(**SMALL)
    x = _inputs(2000, 5, ray_coherent=True)
    g = np.random.RandomState(6).randn(2000, spec.output_dim).astype(np.float32)
    table0 = np.zeros((spec.table_rows, 128), np.float32)
    ref = jax.grad(
        lambda t: jnp.sum(bh.block_hash_encode(jnp.asarray(x), t, spec_j, False) * g)
    )(jnp.asarray(table0))
    t = torch.zeros((spec.table_rows, 128), requires_grad=True)
    (tbh.block_hash_encode(torch.from_numpy(x), t, spec) * torch.from_numpy(g)).sum().backward()
    # scatter-adds of up to hundreds of duplicate rows in another order
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
