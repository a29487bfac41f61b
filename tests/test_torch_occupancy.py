"""Port parity for occupancy-prior sampling (`--fast`): lidarnerf_tpu_torch.models.occupancy
vs lidarnerf_tpu.models.occupancy, and the grid's way through the checkpoint bridge.

Grids hold 0 or 50 only, as tests/test_occupancy.py's slab grids do: the
occupancy threshold min(mean(grid), density_thresh) is a sum over the grid
that XLA and torch take in another order, and an entry within an ulp of it
could flip between occupied and empty.
"""

import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.models import occupancy as oj
from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
from lidarnerf_tpu_torch.models import occupancy as ot
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
from lidarnerf_tpu_torch.utils.params import (
    load_jax_checkpoint,
    load_jax_occ_grid,
    params_from_jax,
    params_to_jax,
)

G, K, N = 32, 64, 64


def shell_grid(G=G, inner=0.3, outer=0.5):
    """[G, G, G]: 50 in the cells whose centre lies `inner` to `outer` from
    the origin, 0 elsewhere (no entry near the threshold, whatever the mean)."""
    c = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    return np.where((r > inner) & (r < outer), 50.0, 0.0).astype(np.float32)


def _rays(seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nears = rng.uniform(0.01, 0.05, (N, 1)).astype(np.float32)
    fars = (nears * rng.uniform(10.0, 40.0, (N, 1))).astype(np.float32)
    return o, d, nears, fars


def _configs(**kw):
    kw = {"grid_size": G, "bins": K, **kw}
    return oj.OccConfig(**kw), ot.OccConfig(**kw)


@pytest.mark.parametrize("dilate", [0, 1])
def test_occ_bin_pdf_matches_jax(dilate):
    cfg_j, cfg = _configs(dilate=dilate)
    grid = shell_grid()
    arrays = _rays(0)
    ref = np.asarray(oj.occ_bin_pdf(jnp.asarray(grid), *map(jnp.asarray, arrays), cfg_j, 1.0))
    pdf = ot.occ_bin_pdf(torch.from_numpy(grid), *map(torch.from_numpy, arrays), cfg, 1.0)
    # the grid shapes the pdf: rays that cross the shell concentrate on it,
    # the others (far short of it) stay uniform
    uniform = np.ptp(ref, axis=-1) < 1e-6
    assert uniform.any() and not uniform.all()
    np.testing.assert_array_equal(np.ptp(pdf.numpy(), axis=-1) < 1e-6, uniform)
    # float32; the normalising sum of 64 bins in another order
    np.testing.assert_allclose(pdf.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("perturb", [False, True])
def test_occ_z_vals_matches_jax(perturb):
    cfg_j, _ = _configs()
    o, d, nears, fars = _rays(1)
    pdf = oj.occ_bin_pdf(jnp.asarray(shell_grid()), *map(jnp.asarray, (o, d, nears, fars)),
                         cfg_j, 1.0)
    key, T = jax.random.PRNGKey(2), 48
    ref = np.asarray(oj.occ_z_vals(key, jnp.asarray(nears), jnp.asarray(fars), pdf, T, perturb))
    xi = torch.from_numpy(np.array(jax.random.uniform(key, (N, T), dtype=jnp.float32)))
    z = ot.occ_z_vals(torch.from_numpy(nears), torch.from_numpy(fars),
                      torch.from_numpy(np.array(pdf)), T, perturb, xi=xi)
    assert z.shape == (N, T) and (np.diff(z.numpy(), axis=1) >= 0).all()
    assert (z.numpy() >= nears - 1e-7).all() and (z.numpy() <= fars + 1e-6).all()
    # the inverse-CDF cumsum over 64 bins in another order, and (perturb
    # off) the linspace's one-ulp difference: close, not bitwise
    np.testing.assert_allclose(z.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_update_occ_grid_matches_jax():
    """The refresh through a flax-initialised field and the weight bridge,
    with the JAX key's jitter injected; the decay of the old grid too."""
    cfg_j, cfg = _configs(grid_size=16, decay=0.9)
    module = FlaxNeRF(encoding="blockhash", desired_resolution=64, log2_hashmap_size=12,
                      num_levels=4, hidden_dim=16, compute_dtype=jnp.float32)
    params = jax.tree.map(np.array, module.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                                                jnp.zeros((4, 3))))
    params["params"]["hash_table"] *= 1e4  # densities that vary over the volume
    grid0 = np.random.RandomState(3).uniform(0.0, 3.0, (16,) * 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(oj.update_occ_grid(module, jax.tree.map(jnp.asarray, params),
                                        jnp.asarray(grid0), key, cfg_j, 1.0))
    net = NeRFNetwork(desired_resolution=64, log2_hashmap_size=12, num_levels=4, hidden_dim=16)
    net.load_state_dict(params_from_jax(params))
    jitter = torch.from_numpy(np.array(jax.random.uniform(key, (16, 16, 16, 3),
                                                            dtype=jnp.float32)))
    grid = ot.update_occ_grid(net, torch.from_numpy(grid0), cfg, 1.0, jitter=jitter)
    fresh = ref > grid0 * 0.9
    assert 0 < fresh.mean() < 1  # some cells take the field's sigma, some the decay
    np.testing.assert_allclose(grid.numpy(), ref, rtol=1e-5, atol=1e-7)
    # drawn from a generator: the same law
    drawn = ot.update_occ_grid(net, ot.init_occ_grid(cfg), cfg, 1.0,
                               generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (16,) * 3 and (drawn > 0).all()


def test_occ_grid_rides_the_checkpoint(tmp_path):
    """A JAX-layout pickle with `model` and `occ_grid` reads back both; a
    --fast PanoRenderer needs the grid and renders with it."""
    net = NeRFNetwork(desired_resolution=64, log2_hashmap_size=10, hidden_dim=8)
    params = params_to_jax(net.state_dict())
    grid = shell_grid(16)
    path = tmp_path / "fast.ckpt"
    path.write_bytes(pickle.dumps({"model": params, "occ_grid": grid, "epoch": 3}))
    got = load_jax_checkpoint(path)
    assert got.keys() == params.keys()
    np.testing.assert_array_equal(got["params"]["hash_table"], params["params"]["hash_table"])
    back = load_jax_occ_grid(path)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, grid)
    plain = tmp_path / "plain.ckpt"
    plain.write_bytes(pickle.dumps({"model": params}))
    assert load_jax_occ_grid(plain) is None

    opt = SimpleNamespace(
        encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, num_layers=2,
        hidden_dim=8, geo_feat_dim=15, bound=1.0, scale=0.01, num_steps=16, upsample_steps=4,
        max_ray_batch=32, fp16=False, alpha_r=1.0, occ_sampling=True, occ_grid_size=16,
    )
    with pytest.raises(ValueError, match="occupancy grid"):
        PanoRenderer(opt, got, device="cpu")
    with pytest.raises(ValueError, match="occ_grid must be"):
        PanoRenderer(opt, got, device="cpu", occ_grid=shell_grid(8))
    r = PanoRenderer(opt, got, device="cpu", occ_grid=back)
    assert r.cfg.occ == ot.OccConfig(grid_size=16) and r.occ_grid.shape == (16,) * 3
    raydrop, intensity, depth = r.render_frame(np.eye(4), 2, 8, (2.0, 26.9))
    assert depth.shape == (2, 8) and np.isfinite(depth).all()
