"""Port parity: frequency_encode and trunc_exp of lidarnerf_tpu_torch vs the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.ops.activation import trunc_exp as trunc_exp_j
from lidarnerf_tpu.ops.encoders import frequency_encode as freq_j
from lidarnerf_tpu.ops.encoders import frequency_encoding_dim as freq_dim_j
from lidarnerf_tpu_torch.ops.activation import trunc_exp
from lidarnerf_tpu_torch.ops.encoders import frequency_encode, frequency_encoding_dim


def _dirs(n, seed):
    d = np.random.RandomState(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_frequency_encode_matches_jax():
    d = _dirs(500, 0)
    ref = np.asarray(freq_j(jnp.asarray(d), 12))
    out = frequency_encode(torch.from_numpy(d), 12).numpy()
    assert out.shape == ref.shape == (500, frequency_encoding_dim(3, 12))
    assert frequency_encoding_dim(3, 12) == freq_dim_j(3, 12)
    # the layout is exact; sin/cos of |x| <= 2^11 differ by a few ulps of the
    # argument between the two libms
    np.testing.assert_array_equal(out[:, :3], ref[:, :3])
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)


def test_frequency_encode_grad_matches_jax():
    d = _dirs(200, 1)
    g = np.random.RandomState(2).normal(size=(200, 75)).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(freq_j(x, 12) * g))(jnp.asarray(d))
    x = torch.from_numpy(d).requires_grad_()
    (frequency_encode(x, 12) * torch.from_numpy(g)).sum().backward()
    # d/dx sums 2^f-scaled terms up to 2^11: fp32 error grows with the scale
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-2)


_X = np.array([-200.0, -20.0, -15.5, -15.0, -1.0, 0.0, 0.5, 14.9, 15.0, 16.0,
               79.0, 80.0, 81.0, 200.0], np.float32)


def test_trunc_exp_forward_matches_jax():
    ref = np.asarray(trunc_exp_j(jnp.asarray(_X)))
    out = trunc_exp(torch.from_numpy(_X)).numpy()
    assert np.isfinite(out).all()
    assert out[-1] == out[-2] == out[-3]  # clipped at 80
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_trunc_exp_grad_matches_jax():
    ref = jax.grad(lambda x: jnp.sum(trunc_exp_j(x)))(jnp.asarray(_X))
    x = torch.from_numpy(_X).requires_grad_()
    trunc_exp(x).sum().backward()
    assert x.grad[0] == pytest.approx(np.exp(-15.0), rel=1e-6)  # clamped below
    assert x.grad[-1] == pytest.approx(np.exp(15.0), rel=1e-6)  # and above
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
