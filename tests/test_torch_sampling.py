"""Port parity: samplers and compositors of lidarnerf_tpu_torch vs the JAX package.

Noise and `u` are made with numpy and handed to both sides, since JAX keys
and torch generators give different numbers.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.ops import compositing as cj
from lidarnerf_tpu.ops import sampling as sj
from lidarnerf_tpu_torch.ops import compositing as ct
from lidarnerf_tpu_torch.ops import sampling as st

N, T, TB = 64, 48, 8


def _bounds():
    rs = np.random.RandomState(0)
    nears = rs.uniform(0.01, 0.05, (N, 1)).astype(np.float32)
    fars = (nears * 81.0).astype(np.float32)
    return nears, fars


def test_stratified_z_vals_det_matches_jax():
    nears, fars = _bounds()
    ref = sj.stratified_z_vals(None, jnp.asarray(nears), jnp.asarray(fars), T, False)
    out = st.stratified_z_vals(torch.from_numpy(nears), torch.from_numpy(fars), T)
    # the two linspaces round some inner points one ulp apart, which
    # near + (far - near) * t carries: two fp32 ulps at most
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2.0**-22, atol=0)


def test_stratified_z_vals_injected_noise_matches_jax():
    nears, fars = _bounds()
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, (N, T), dtype=jnp.float32))
    ref = sj.stratified_z_vals(key, jnp.asarray(nears), jnp.asarray(fars), T, True)
    out = st.stratified_z_vals(torch.from_numpy(nears), torch.from_numpy(fars), T,
                               perturb=True, noise=torch.from_numpy(noise))
    assert not np.allclose(np.asarray(ref), np.asarray(
        sj.stratified_z_vals(None, jnp.asarray(nears), jnp.asarray(fars), T, False)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def _pdf_inputs():
    nears, fars = _bounds()
    z = np.asarray(sj.stratified_z_vals(None, jnp.asarray(nears), jnp.asarray(fars), T, False))
    bins = z[:, :-1] + 0.5 * (z[:, 1:] - z[:, :-1])  # [N, T-1]
    rs = np.random.RandomState(1)
    w = rs.exponential(size=(N, T - 2)).astype(np.float32)
    w[:, 10:20] *= 50.0  # a peak, so the samples crowd into a few bins
    w[:4] = 0.0  # all-zero weights: the +1e-5 keeps the cdf increasing
    return bins, w


def test_sample_pdf_det_matches_jax():
    bins, w = _pdf_inputs()
    ref = sj.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), TB, det=True)
    out = st.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), TB, det=True)
    # cumsums of the pdf taken in another order shift the inverse cdf by ulps
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=0)


def test_sample_pdf_injected_u_matches_jax():
    bins, w = _pdf_inputs()
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (N, TB), dtype=jnp.float32))
    ref = sj.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), TB, det=False)
    out = st.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), TB, det=False,
                        u=torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=0)


def _density_lists(ties):
    nears, fars = _bounds()
    rs = np.random.RandomState(7)
    zA = np.array(sj.stratified_z_vals(None, jnp.asarray(nears), jnp.asarray(fars), T, False))
    zB = np.sort(rs.uniform(nears, fars, (N, TB)), axis=-1).astype(np.float32)
    if ties:
        # exact depth ties between the lists, and within the fine list
        zB[:, 2] = zA[:, 5]
        zB[:, 3] = zA[:, 5]
        zB[:, 6] = zA[:, 30]
        zB = np.sort(zB, axis=-1)
    sigA = rs.exponential(30.0, (N, T)).astype(np.float32)
    sigB = rs.exponential(30.0, (N, TB)).astype(np.float32)
    sigA[:, 20] = 1e6  # a saturated step
    dist = ((fars - nears) / T).astype(np.float32)
    return zA, sigA, zB, sigB, dist


def test_composite_weights_matches_jax():
    zA, sigA, _, _, dist = _density_lists(False)
    ref = cj.composite_weights(jnp.asarray(sigA), jnp.asarray(zA), jnp.asarray(dist))
    out = ct.composite_weights(torch.from_numpy(sigA), torch.from_numpy(zA), torch.from_numpy(dist))
    # exp of log-space cumsums: ulp-level differences grow with the sum
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def _check_merged(ties):
    zA, sigA, zB, sigB, dist = _density_lists(ties)
    rA, rB = cj.merged_composite_weights(*map(jnp.asarray, (zA, sigA, zB, sigB, dist)))
    wA, wB = ct.merged_composite_weights(*map(torch.from_numpy, (zA, sigA, zB, sigB, dist)))
    np.testing.assert_allclose(wA.numpy(), np.asarray(rA), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(wB.numpy(), np.asarray(rB), rtol=1e-5, atol=1e-7)
    return zA, sigA, zB, sigB, dist, wA, wB


def test_merged_composite_weights_matches_jax():
    _check_merged(ties=False)


def test_merged_composite_weights_ties_order_coarse_first():
    zA, sigA, zB, sigB, dist, wA, wB = _check_merged(ties=True)
    # and equals compositing the stably sorted merge, coarse before fine
    z = np.concatenate([zA, zB], axis=1)
    s = np.concatenate([sigA, sigB], axis=1)
    order = np.argsort(z, axis=1, kind="stable")
    w = ct.composite_weights(torch.from_numpy(np.take_along_axis(s, order, 1)),
                             torch.from_numpy(np.take_along_axis(z, order, 1)),
                             torch.from_numpy(dist)).numpy()
    merged = np.empty_like(w)
    np.put_along_axis(merged, order, w, axis=1)
    np.testing.assert_allclose(wA.numpy(), merged[:, :T], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(wB.numpy(), merged[:, T:], rtol=1e-5, atol=1e-7)
