"""Port parity for RGB rendering: pinhole rays, the slab test, the background
sphere and `render_rays` with cal_lidar_color=False, lidarnerf_tpu_torch vs the JAX package.

A hash-grid field with structure (flax init through the weight bridge, its
four coarsest levels scaled to O(1), the density channel sharpened) renders
a small pinhole frame (12 x 16, 48 + 8 samples) from cameras inside the
unit box, once over the background model (bg_radius 4) and once over white,
in float32 on the CPU. The whole-render tolerance is the LiDAR render's
(tests/test_torch_render.py): rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.dataset.base import get_rays as get_rays_j
from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
from lidarnerf_tpu.models.renderer import RenderConfig as RenderConfigJ
from lidarnerf_tpu.models.renderer import near_far_from_aabb as near_far_j
from lidarnerf_tpu.models.renderer import render_rays as render_rays_j
from lidarnerf_tpu.models.renderer import render_rays_staged as render_staged_j
from lidarnerf_tpu.models.renderer import sph_from_ray as sph_from_ray_j
from lidarnerf_tpu.ops.hash_grid import make_hash_grid_spec
from lidarnerf_tpu_torch.dataset.base import get_rays
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.renderer import (
    RenderConfig,
    near_far_from_aabb,
    render_rays,
    render_rays_staged,
    sph_from_ray,
)
from lidarnerf_tpu_torch.utils.params import params_from_jax

H, W = 12, 16
INTRINSICS = (10.0, 9.0, 8.0, 6.0)  # fx, fy, cx, cy
NET = dict(encoding="hashgrid", desired_resolution=2048, log2_hashmap_size=14, hidden_dim=32)
T, S = 48, 8
TOL = dict(rtol=1e-4, atol=1e-5)
BG_RADIUS = {"bg": 4.0, "white": -1.0}


def _poses():
    rs = np.random.RandomState(0)
    poses = []
    for k in range(2):
        a = 0.4 * k + 0.2
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = rs.uniform(-0.3, 0.3, 3)
        poses.append(pose)
    return np.stack(poses)


@pytest.fixture(scope="module", params=list(BG_RADIUS))
def field(request):
    """(flax module, numpy params, bg_radius) of a field with structure."""
    bg_radius = BG_RADIUS[request.param]
    module = FlaxNeRF(compute_dtype=jnp.float32, bg_radius=bg_radius, **NET)
    params = jax.tree.map(np.array, module.init(jax.random.PRNGKey(2), jnp.zeros((8, 3)),
                                                jnp.zeros((8, 3))))
    p = params["params"]
    spec = make_hash_grid_spec(num_levels=16, log2_hashmap_size=14, desired_resolution=2048)
    p["hash_table"][: spec.levels[4].offset] *= 1e4
    p["sigma_net"]["Dense_1"]["kernel"][:, 0] *= 8.0
    p["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.3
    p["color_net"]["Dense_2"]["kernel"] *= 10.0
    if bg_radius > 0:
        p["bg_table"] *= 1e4
    return module, params, bg_radius


def _network(params, bg_radius):
    net = NeRFNetwork(bg_radius=bg_radius, **NET)
    net.load_state_dict(params_from_jax(params))
    return net


def test_get_rays_matches_jax():
    poses = _poses()
    ref = get_rays_j(jnp.asarray(poses), INTRINSICS, H, W, N=-1)
    out = get_rays(torch.from_numpy(poses), INTRINSICS, H, W, N=-1)
    np.testing.assert_array_equal(out["inds"].numpy(), np.asarray(ref["inds"]))
    np.testing.assert_array_equal(out["rays_o"].numpy(), np.asarray(ref["rays_o"]))
    np.testing.assert_allclose(out["rays_d"].numpy(), np.asarray(ref["rays_d"]), rtol=0, atol=1e-6)
    assert out["rays_d"].shape == (2, H * W, 3)
    np.testing.assert_allclose(out["rays_d"].norm(dim=-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("patch", [1, 2], ids=["pixels", "patch2"])
def test_get_rays_draws_from_the_generator_or_takes_injected_pixels(patch):
    """N sampled pixels: one draw from the generator shared by the poses (the
    same seed repeats it); injected indices give the JAX rays of those pixels."""
    poses = torch.from_numpy(_poses())
    a = get_rays(poses, INTRINSICS, H, W, N=32, patch_size=patch,
                 generator=torch.Generator().manual_seed(4))
    b = get_rays(poses, INTRINSICS, H, W, N=32, patch_size=patch,
                 generator=torch.Generator().manual_seed(4))
    assert a["inds"].shape == (2, 32) and torch.equal(a["inds"], b["inds"])
    assert torch.equal(a["inds"][0], a["inds"][1]) and int(a["inds"].max()) < H * W
    inds = a["inds"][0].numpy()
    ref = get_rays_j(jnp.asarray(poses.numpy()), INTRINSICS, H, W, N=-1)
    out = get_rays(poses, INTRINSICS, H, W, inds=inds)
    np.testing.assert_array_equal(out["inds"][0].numpy(), inds)
    np.testing.assert_allclose(out["rays_d"].numpy(), np.asarray(ref["rays_d"])[:, inds],
                               rtol=0, atol=1e-6)
    assert torch.equal(out["rays_d"], a["rays_d"])


def test_sph_from_ray_matches_jax():
    rs = np.random.RandomState(5)
    o = rs.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(sph_from_ray_j(jnp.asarray(o), jnp.asarray(d), 4.0))
    out = sph_from_ray(torch.from_numpy(o), torch.from_numpy(d), 4.0).numpy()
    assert out.shape == (512, 2) and (np.abs(out) <= 1.0).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    # the pole (+y) and the equator (+x), as tests/test_extras.py holds them
    poles = sph_from_ray(torch.zeros(2, 3), torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]), 10.0)
    np.testing.assert_allclose(poles.numpy(), [[-1.0, 0.0], [0.0, 0.0]], atol=1e-5)


def test_near_far_of_camera_rays_match_jax():
    rays = get_rays(torch.from_numpy(_poses()), INTRINSICS, H, W)
    o, d = rays["rays_o"].reshape(-1, 3), rays["rays_d"].reshape(-1, 3)
    lo, hi = torch.full((3,), -1.0), torch.full((3,), 1.0)
    near, far = near_far_from_aabb(o, d, lo, hi, 0.05)
    near_j, far_j = near_far_j(*(jnp.asarray(t.numpy()) for t in (o, d, lo, hi)), 0.05)
    np.testing.assert_allclose(near.numpy(), np.asarray(near_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(far.numpy(), np.asarray(far_j), rtol=1e-6, atol=0)
    assert (near.numpy() == 0.05).all() and (far.numpy() > 0.5).all()  # cameras inside the box


def _cfgs(bg_radius, upsample=S):
    kw = dict(num_steps=T, upsample_steps=upsample, min_near=0.05, bound=1.0,
              cal_lidar_color=False, bg_radius=bg_radius)
    return RenderConfigJ(**kw), RenderConfig(**kw)


def test_rgb_frame_matches_jax(field):
    """The served frame (render_rays_staged, 80-ray chunks, the last padded)."""
    module, params, bg_radius = field
    cfg_j, cfg = _cfgs(bg_radius)
    rays = get_rays(torch.from_numpy(_poses()[:1]), INTRINSICS, H, W)
    o, d = rays["rays_o"][0], rays["rays_d"][0]
    ref = render_staged_j(module, jax.tree.map(jnp.asarray, params), jnp.asarray(o.numpy()),
                          jnp.asarray(d.numpy()), cfg_j, chunk=80)
    out = render_rays_staged(_network(params, bg_radius), o, d, cfg, chunk=80)
    assert out["image"].shape == (H * W, 3)
    wsum = out["weights_sum"].numpy()
    assert wsum.min() < 0.9 and wsum.max() > 0.1  # the background shows, and the field
    img = out["image"].numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and (img <= 1.0 + 1e-5).all()
    for k in ("depth", "image", "weights_sum"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)


def test_rgb_training_render_matches_jax(field):
    """train=True with the JAX key's draws injected, and the coarse-only branch;
    the colour's gradient flows to the background table."""
    module, params, bg_radius = field
    cfg_j, cfg = _cfgs(bg_radius)
    rays = get_rays(torch.from_numpy(_poses()[1:]), INTRINSICS, H, W)
    o, d = rays["rays_o"][0, :96], rays["rays_d"][0, :96]
    jparams = jax.tree.map(jnp.asarray, params)
    key = jax.random.PRNGKey(7)
    ref = render_rays_j(module, jparams, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), key,
                        cfg_j, True)
    k_strat, k_pdf = jax.random.split(key)
    noise = np.array(jax.random.uniform(k_strat, (96, T), dtype=jnp.float32))
    u = np.array(jax.random.uniform(k_pdf, (96, S), dtype=jnp.float32))
    net = _network(params, bg_radius)
    out = render_rays(net, o, d, cfg, train=True, noise=torch.from_numpy(noise),
                      u=torch.from_numpy(u))
    for k in ("depth", "image", "weights_sum"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **TOL)
    out["image"].sum().backward()
    assert net.hash_table.grad.abs().max() > 0
    if bg_radius > 0:
        assert net.bg_table.grad.abs().max() > 0
    cfg_j0, cfg0 = _cfgs(bg_radius, upsample=0)
    ref0 = render_rays_j(module, jparams, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), key,
                         cfg_j0, False)
    with torch.no_grad():
        out0 = render_rays(net, o, d, cfg0)
    for k in ("depth", "image", "weights_sum"):
        np.testing.assert_allclose(out0[k].numpy(), np.asarray(ref0[k]), **TOL)
