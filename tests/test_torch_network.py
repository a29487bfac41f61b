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


# ------------------------------------------------ every encoding, both heads, the background

# a small field of each encoding (periodic_volume: log2_hashmap_size % 3 == 0)
ENCODINGS = {
    "hashgrid": dict(desired_resolution=2048, log2_hashmap_size=14),
    "tiledgrid": dict(desired_resolution=2048, log2_hashmap_size=14),
    "periodic_volume": dict(desired_resolution=256, log2_hashmap_size=12, num_levels=4),
    "frequency": dict(multires=6),
    "None": {},
    "blockhash": dict(desired_resolution=2048, log2_hashmap_size=14),
    "hashgrid-bg": dict(desired_resolution=2048, log2_hashmap_size=14, bg_radius=4.0,
                        n_features_per_level=4),
}


def _encoding_pair(case, seed=0):
    """(flax module, numpy params, port network with those params, fp32)."""
    kw = dict(ENCODINGS[case], encoding=case.removesuffix("-bg"), hidden_dim=32)
    module = FlaxNeRF(compute_dtype=jnp.float32, **kw)
    params = jax.tree.map(np.array, module.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)),
                                                jnp.zeros((8, 3))))
    p = params["params"]
    for t in ("hash_table", "bg_table"):  # features of order 1
        if t in p:
            p[t] = np.random.RandomState(seed).uniform(-1, 1, p[t].shape).astype(np.float32)
    net = NeRFNetwork(**kw)
    net.load_state_dict(params_from_jax(params))
    return module, params, net


@pytest.mark.parametrize("case", list(ENCODINGS))
def test_every_encoding_matches_jax_through_the_bridge(case):
    """Density, the LiDAR and the RGB head, and with bg_radius > 0 the
    background model, on the same weights (flax init through params_from_jax;
    the bridge's round trip is exact)."""
    module, params, net = _encoding_pair(case)
    sd = net.state_dict()
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(sd)))
    ref_leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(back) == len(ref_leaves) and ("hash_table" in sd) == (
        case not in ("frequency", "None"))
    for path, leaf in ref_leaves:
        np.testing.assert_array_equal(back[path], leaf)
    rs = np.random.RandomState(3)
    x = rs.uniform(-1.0, 1.0, (1500, 3)).astype(np.float32)
    d = rs.normal(size=(1500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sigma_j, geo_j = module.apply(params, jnp.asarray(x), method=module.density)
    with torch.no_grad():
        sigma, geo = net.density(torch.from_numpy(x))
        lidar = net.lidar_color(torch.from_numpy(d), geo)
        rgb = net.rgb_color(torch.from_numpy(d), geo)
        via_enc = net.color_from_enc(net.encode_dir(torch.from_numpy(d), False), geo, False)
    tol = TOL["fp32"]
    np.testing.assert_allclose(geo.numpy(), np.asarray(geo_j), **tol)
    np.testing.assert_allclose(np.log(sigma.numpy()), np.log(np.asarray(sigma_j)), **tol)
    geo_in = jnp.asarray(geo.numpy())  # the heads on the same geo features
    lidar_j = module.apply(params, jnp.asarray(d), geo_in, method=module.lidar_color)
    rgb_j = module.apply(params, jnp.asarray(d), geo_in, method=module.rgb_color)
    assert lidar.shape == (1500, 2) and rgb.shape == (1500, 3) and torch.equal(rgb, via_enc)
    np.testing.assert_allclose(lidar.numpy(), np.asarray(lidar_j), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), **tol)
    if case.endswith("-bg"):
        sph = rs.uniform(-1.0, 1.0, (1500, 2)).astype(np.float32)
        bg_j = module.apply(params, jnp.asarray(sph), jnp.asarray(d), method=module.background)
        with torch.no_grad():
            bg = net.background(torch.from_numpy(sph), torch.from_numpy(d))
        np.testing.assert_allclose(bg.numpy(), np.asarray(bg_j), **tol)


def test_default_encoding_is_hashgrid():
    net = NeRFNetwork(desired_resolution=64, log2_hashmap_size=10)
    assert net.encoding == "hashgrid" and net.grid_spec is not None and net.block_spec is None
    assert net.hash_table.shape == (net.grid_spec.table_rows, 2)


@pytest.mark.parametrize("case", ["frequency", "hashgrid-bg", "periodic_volume"])
def test_optimizer_state_keeps_optax_leaf_order_for_every_encoding(case):
    """Without a table (frequency) or with the background's (bg_table,
    bg_net): DeviceAdam's state through optimizer_to_jax flattens to the
    leaves of optax's state for the flax parameters, in optax's order and
    shapes, and optimizer_from_jax takes it back exactly."""
    import optax

    from lidarnerf_tpu_torch.nerf.train_step import TrainConfig, make_optimizer
    from lidarnerf_tpu_torch.utils.params import optimizer_from_jax, optimizer_to_jax

    _, params, net = _encoding_pair(case)
    adam = make_optimizer(net.named_parameters(), TrainConfig())
    rs = np.random.RandomState(4)
    state = adam.state_dict()
    for kind in ("mu", "nu"):
        for v in state[kind].values():
            v.copy_(torch.from_numpy(rs.normal(size=tuple(v.shape)).astype(np.float32)))
    adam.load_state_dict(state)
    entry = optimizer_to_jax(adam.state_dict())
    ref = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(lambda c: c)).init(
        jax.tree.map(jnp.asarray, params))
    assert [np.shape(x) for x in jax.tree.leaves(entry)] == [
        np.shape(x) for x in jax.tree.leaves(ref)]
    back = optimizer_from_jax(entry)
    for kind in ("mu", "nu"):
        assert back[kind].keys() == state[kind].keys()
        for k, v in state[kind].items():
            assert torch.equal(back[kind][k], v), (kind, k)
