"""Port parity: NeRFNetwork of lidarnerf_tpu_torch vs the JAX package, through the weight bridge."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.utils.params import (
    load_jax_checkpoint,
    params_from_jax,
    params_to_jax,
)

CFG = dict(encoding="blockhash", desired_resolution=2048, log2_hashmap_size=14,
           hidden_dim=32, geo_feat_dim=15)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(dtype):
    jdt, tdt = DTYPES[dtype]
    module = FlaxNeRF(compute_dtype=jdt, **CFG)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    params = jax.tree.map(np.array, params)
    # features of order 1 instead of the 1e-4 init, so the MLPs see real inputs
    params["params"]["hash_table"] *= 1e4
    net = NeRFNetwork(compute_dtype=tdt, **CFG)
    net.load_state_dict(params_from_jax(params))
    return module, params, net


def _points(n, seed):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)


def test_weight_bridge_round_trip(tmp_path):
    _, params, net = _pair("fp32")
    sd = net.state_dict()
    assert set(sd) == set(params_from_jax(params))
    back = params_to_jax(sd)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)
    # and through a pickle checkpoint as the JAX trainer writes it
    ckpt = tmp_path / "model.ckpt"
    ckpt.write_bytes(pickle.dumps({"epoch": 3, "model": params, "rng": np.zeros(2, np.uint32)}))
    loaded = load_jax_checkpoint(ckpt)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(loaded))[path], leaf)


# fp32: the same float32 ops, summed in another order. bf16: both sides cast
# to bf16 at the same points, but a sum taken in another order can round a
# layer output one bf16 ulp (2^-8 relative) the other way: 2^-7 relative,
# and 2e-3 absolute (under one ulp at the outputs' scale of ~0.4).
TOL = {"fp32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=2.0**-7, atol=2e-3)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_density_matches_jax(dtype):
    module, params, net = _pair(dtype)
    x = _points(2000, 1)
    sigma_j, geo_j = module.apply(params, jnp.asarray(x), method=module.density)
    with torch.no_grad():
        sigma, geo = net.density(torch.from_numpy(x))
    assert sigma.dtype == geo.dtype == torch.float32
    np.testing.assert_allclose(geo.numpy(), np.asarray(geo_j), **TOL[dtype])
    np.testing.assert_allclose(np.log(sigma.numpy()), np.log(np.asarray(sigma_j)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_color_from_enc_matches_jax(dtype):
    module, params, net = _pair(dtype)
    rs = np.random.RandomState(2)
    d = rs.normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    geo = rs.normal(size=(1000, 15)).astype(np.float32)
    d_enc_j = module.apply(params, jnp.asarray(d), True, method=module.encode_dir)
    ref = module.apply(params, d_enc_j, jnp.asarray(geo), True, method=module.color_from_enc)
    with torch.no_grad():
        d_enc = net.encode_dir(torch.from_numpy(d))
        out = net.color_from_enc(d_enc, torch.from_numpy(geo))
    assert out.dtype == torch.float32 and out.shape == (1000, 2)
    np.testing.assert_allclose(d_enc.numpy(), np.asarray(d_enc_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL[dtype])
