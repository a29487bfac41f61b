"""Port parity: every criterion of lidarnerf_tpu_torch.ops.losses vs lidarnerf_tpu.ops.losses.

The same numpy inputs from a seed go to both; float32 on both sides, so the
tolerance is a few ulps of the result (rtol 1e-6, atol 1e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidarnerf_tpu.ops import losses as LJ
from lidarnerf_tpu_torch.ops import losses as LT

SCALE = 0.010784853507573345
TOL = dict(rtol=1e-6, atol=1e-7)


def _pair(seed, shape=(8, 37), lo=-1.0, hi=1.0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(lo, hi, shape).astype(np.float32),
            rs.uniform(lo, hi, shape).astype(np.float32))


def _check(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["mse", "l1", "bce", "huber", "cos"])
def test_make_criterion_matches_jax(name):
    # depths on the scale the huber delta (0.2 * scale) cuts through
    pred, gt = _pair(0, lo=0.0, hi=4 * SCALE)
    if name == "bce":
        pred, gt = _pair(1, lo=-6.0, hi=6.0)
        gt = (gt > 0).astype(np.float32)
    ref = LJ.make_criterion(name, SCALE)(jnp.asarray(pred), jnp.asarray(gt))
    out = LT.make_criterion(name, SCALE)(torch.from_numpy(pred), torch.from_numpy(gt))
    assert out.shape == tuple(np.shape(ref))
    _check(out, ref)
    if name == "huber":  # both branches of the 0.2 * scale delta are taken
        err = np.abs(pred - gt)
        assert (err < 0.2 * SCALE).any() and (err >= 0.2 * SCALE).any()


def test_unknown_criterion_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        LT.make_criterion("l3")


@pytest.mark.parametrize("axis", [0, 1])
def test_cosine_similarity_matches_jax(axis):
    a, b = _pair(2)
    b[:, 3] = 0.0
    a[:, 3] = 0.0  # a zero column: the eps guard
    ref = LJ.cosine_similarity(jnp.asarray(a), jnp.asarray(b), axis=axis)
    _check(LT.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b), axis=axis), ref)


@pytest.mark.parametrize("fn", ["huber_loss_ngp", "mape", "linear_to_srgb", "srgb_to_linear"])
def test_elementwise_extras_match_jax(fn):
    a, b = _pair(3, lo=0.0, hi=1.0)
    a[0, :4] = [0.0, 0.001, 0.003, 0.05]  # both sides of the sRGB knees
    if fn in ("linear_to_srgb", "srgb_to_linear"):
        ref = getattr(LJ, fn)(jnp.asarray(a))
        out = getattr(LT, fn)(torch.from_numpy(a))
    else:
        ref = getattr(LJ, fn)(jnp.asarray(a), jnp.asarray(b))
        out = getattr(LT, fn)(torch.from_numpy(a), torch.from_numpy(b))
    _check(out, ref)


def test_eff_distloss_matches_jax():
    rs = np.random.RandomState(4)
    w = rs.uniform(0, 1, (6, 40)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    mid = np.sort(rs.uniform(0, 1, (6, 40)), -1).astype(np.float32)
    iv = rs.uniform(0, 0.05, (6, 40)).astype(np.float32)
    ref = LJ.eff_distloss(*map(jnp.asarray, (w, mid, iv)))
    out = LT.eff_distloss(*map(torch.from_numpy, (w, mid, iv)))
    # two cumsums of 40 terms each, in another order: ~1e-6 relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
