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


# ------------------------------------------------ SH, the factory, Morton, LPIPS

from lidarnerf_tpu.ops import morton as morton_j  # noqa: E402
from lidarnerf_tpu.ops.encoders import sh_encode as sh_j  # noqa: E402
from lidarnerf_tpu.ops.encoders import sh_encoding_dim as sh_dim_j  # noqa: E402
from lidarnerf_tpu.ops.factory import get_encoder as get_encoder_j  # noqa: E402
from lidarnerf_tpu_torch.nerf.metrics import LPIPSMeter  # noqa: E402
from lidarnerf_tpu_torch.ops import morton  # noqa: E402
from lidarnerf_tpu_torch.ops.encoders import sh_encode, sh_encoding_dim  # noqa: E402
from lidarnerf_tpu_torch.ops.factory import get_encoder  # noqa: E402


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(degree):
    """Degrees 1-4 are the closed forms, 5-8 the monomial tables: the same
    float32 products in the same order, so equal to a few ulps of 1."""
    d = _dirs(400, 3 + degree)
    ref = np.asarray(sh_j(jnp.asarray(d), degree))
    out = sh_encode(torch.from_numpy(d), degree).numpy()
    assert out.shape == ref.shape == (400, sh_encoding_dim(degree)) == (400, sh_dim_j(degree))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_sh_encode_refuses_degree_9():
    with pytest.raises(NotImplementedError, match="degree 1..8"):
        sh_encode(torch.zeros(2, 3), 9)


# small widths of each encoder; periodic_volume needs log2_hashmap_size % 3 == 0
ENCODER_KW = dict(num_levels=4, log2_hashmap_size=9, desired_resolution=64, multires=4, degree=3)
ENCODERS = [None, "frequency", "sphere_harmonics", "hashgrid", "tiledgrid", "periodic_volume",
            "blockhash"]


@pytest.mark.parametrize("name", ENCODERS, ids=str)
def test_get_encoder_matches_jax(name):
    """Every name: the same output dim, and the same features on the same
    parameters (the JAX init's, through the port's encode_fn); the port's
    init_fn draws parameters of the JAX shape from a torch.Generator."""
    enc_j, init_j, dim_j = get_encoder_j(name, **ENCODER_KW)
    enc, init, dim = get_encoder(name, **ENCODER_KW)
    assert dim == dim_j
    params_j = init_j(jax.random.PRNGKey(0))
    params = init(torch.Generator().manual_seed(0))
    assert (params is None) == (params_j is None)
    rs = np.random.RandomState(11)
    x = rs.uniform(0.0, 1.0, (300, 3)).astype(np.float32)
    if params_j is not None:
        assert tuple(params.shape) == params_j.shape and params.dtype == torch.float32
        params_j = jnp.asarray(rs.uniform(-1, 1, params_j.shape).astype(np.float32))
    ref = np.asarray(enc_j(jnp.asarray(x), params_j))
    out = enc(torch.from_numpy(x), None if params_j is None else torch.from_numpy(
        np.array(params_j))).numpy()
    assert out.shape == ref.shape == (300, dim)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_get_encoder_refuses_an_unknown_name():
    with pytest.raises(NotImplementedError, match="Unknown encoding"):
        get_encoder("ash")


def test_morton3D_and_its_inverse_match_jax():
    rs = np.random.RandomState(12)
    coords = rs.randint(0, 1024, (2000, 3)).astype(np.int32)
    ref = np.asarray(morton_j.morton3D(jnp.asarray(coords)))
    codes = morton.morton3D(torch.from_numpy(coords))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), ref)
    back = morton.morton3D_invert(codes)
    np.testing.assert_array_equal(back.numpy(), np.asarray(morton_j.morton3D_invert(jnp.asarray(ref))))
    np.testing.assert_array_equal(back.numpy(), coords)
    # codes of the top bit set (coords >= 1024 wrap like uint32 -> int32)
    big = np.array([[2**31 // 3, 5, 7], [1023, 1023, 1023]], np.int32)
    np.testing.assert_array_equal(morton.morton3D(torch.from_numpy(big)).numpy(),
                                  np.asarray(morton_j.morton3D(jnp.asarray(big))))


def test_packbits_matches_jax():
    grid = np.random.RandomState(13).uniform(0, 1, (3, 128)).astype(np.float32)
    np.testing.assert_array_equal(morton.packbits(torch.from_numpy(grid), 0.5).numpy(),
                                  np.asarray(morton_j.packbits(jnp.asarray(grid), 0.5)))


def test_lpips_meter_is_gated_on_the_lpips_package():
    """Neither the `lpips` package nor its weights are installed: the
    constructor raises ImportError, as the JAX package's does."""
    from lidarnerf_tpu.nerf.metrics import LPIPSMeter as LPIPSMeterJ

    for cls in (LPIPSMeter, LPIPSMeterJ):
        with pytest.raises(ImportError, match="optional 'lpips' package"):
            cls()
