"""Port parity for the whole slice: full-pano LiDAR rendering, lidarnerf_tpu_torch vs the JAX package.

Flax-initialised parameters go through the weight bridge; both sides render
the same small pano (8 x 64 rays, 64 + 8 samples, 192-ray chunks, so the
last chunk is padded) in float32, on the CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.dataset.base import get_lidar_rays as get_lidar_rays_j
from lidarnerf_tpu.dataset.convert import pano_to_lidar as pano_to_lidar_j
from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
from lidarnerf_tpu.models.occupancy import OccConfig as OccConfigJ
from lidarnerf_tpu.models.renderer import RenderConfig as RenderConfigJ
from lidarnerf_tpu.models.renderer import near_far_from_aabb as near_far_j
from lidarnerf_tpu.models.renderer import render_rays as render_rays_j
from lidarnerf_tpu.models.renderer import render_rays_staged as render_staged_j
from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.occupancy import OccConfig
from lidarnerf_tpu_torch.models.renderer import (
    RenderConfig,
    near_far_from_aabb,
    render_rays,
    render_rays_staged,
)
from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
from lidarnerf_tpu_torch.utils.params import params_from_jax
from test_torch_occupancy import shell_grid

H, W = 8, 64
INTRINSICS = (2.0, 26.9)
OPT = SimpleNamespace(
    encoding="blockhash", desired_resolution=2048, log2_hashmap_size=14,
    num_layers=2, hidden_dim=32, geo_feat_dim=15, bound=1.0,
    scale=0.010784853507573345, num_steps=64, upsample_steps=8,
    max_ray_batch=192, fp16=False, alpha_r=1.0,
)


def _poses():
    rs = np.random.RandomState(0)
    poses = []
    for k in range(2):
        a = 0.3 * k
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        pose[:3, 3] = rs.uniform(-0.1, 0.1, 3)
        poses.append(pose)
    return np.stack(poses)


@pytest.fixture(scope="module")
def field():
    """(flax module, numpy params, JAX RenderConfig) of a field with structure.

    The four coarsest levels of the hash table are scaled to O(1) and the
    sigma head's density channel sharpened, so densities vary along and
    across the rays and the fine samples crowd. The fine levels keep their
    1e-4 init: the block-hash field jumps at block seams, and an O(1) jump at
    a fine level would turn a one-ulp shift of a sample into an O(1) change.
    """
    module = FlaxNeRF(
        encoding=OPT.encoding, desired_resolution=OPT.desired_resolution,
        log2_hashmap_size=OPT.log2_hashmap_size, num_layers=OPT.num_layers,
        hidden_dim=OPT.hidden_dim, geo_feat_dim=OPT.geo_feat_dim, bound=OPT.bound,
        compute_dtype=jnp.float32,
    )
    params = jax.tree.map(
        np.array, module.init(jax.random.PRNGKey(1), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    )
    p = params["params"]
    B = p["hash_table"].shape[0] // 16
    p["hash_table"][: 4 * B] *= 1e4
    p["sigma_net"]["Dense_1"]["kernel"][:, 0] *= 8.0
    p["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.3
    p["lidar_color_net"]["Dense_2"]["kernel"] *= 30.0
    cfg = RenderConfigJ(num_steps=OPT.num_steps, upsample_steps=OPT.upsample_steps,
                        min_near_lidar=OPT.scale, min_near=OPT.scale, bound=OPT.bound)
    return module, params, cfg


@pytest.fixture(scope="module")
def jax_panos(field):
    """The JAX package's render of each pose, as Trainer._render_full_frame makes it."""
    module, params, cfg = field
    jparams = jax.tree.map(jnp.asarray, params)
    out = []
    for pose in _poses():
        rays = get_lidar_rays_j(jnp.asarray(pose[None]), INTRINSICS, H, W, N=-1)
        o = render_staged_j(module, jparams, rays["rays_o"][0], rays["rays_d"][0],
                            cfg, chunk=OPT.max_ray_batch)
        image = np.asarray(o["image"]).reshape(H, W, -1)
        out.append((image[..., 0], image[..., 1], np.asarray(o["depth"]).reshape(H, W),
                    np.asarray(o["weights_sum"]).reshape(H, W)))
    return out


def test_lidar_rays_match_jax():
    poses = _poses()
    ref = get_lidar_rays_j(jnp.asarray(poses), INTRINSICS, H, W, N=-1)
    out = get_lidar_rays(torch.from_numpy(poses), INTRINSICS, H, W, N=-1)
    np.testing.assert_array_equal(out["inds"].numpy(), np.asarray(ref["inds"]))
    np.testing.assert_array_equal(out["rays_o"].numpy(), np.asarray(ref["rays_o"]))
    # float32 trig of two libms, then a 3x3 rotation: a few ulps
    np.testing.assert_allclose(out["rays_d"].numpy(), np.asarray(ref["rays_d"]), rtol=0, atol=1e-6)


def _network(params):
    net = NeRFNetwork(
        encoding=OPT.encoding, desired_resolution=OPT.desired_resolution,
        log2_hashmap_size=OPT.log2_hashmap_size, num_layers=OPT.num_layers,
        hidden_dim=OPT.hidden_dim, geo_feat_dim=OPT.geo_feat_dim, bound=OPT.bound,
    )
    net.load_state_dict(params_from_jax(params))
    return net


def test_render_rays_staged_matches_jax(field, jax_panos):
    _, params, _ = field
    net = _network(params)
    cfg = RenderConfig(num_steps=OPT.num_steps, upsample_steps=OPT.upsample_steps,
                       min_near_lidar=OPT.scale, min_near=OPT.scale, bound=OPT.bound)
    for pose, (rd_j, it_j, dp_j, ws_j) in zip(_poses(), jax_panos):
        rays = get_lidar_rays(torch.from_numpy(pose[None]), INTRINSICS, H, W)
        out = render_rays_staged(net, rays["rays_o"][0], rays["rays_d"][0], cfg,
                                 chunk=OPT.max_ray_batch)
        assert out["depth"].shape == (H * W,) and out["image"].shape == (H * W, 2)
        # the field has structure: opacities and depths spread over the pano
        assert ws_j.std() > 0.01 and dp_j.std() > 0.01
        # float32 both sides; ulp-level differences in the samplers' cumsums
        # and the log-space transmittance move the fine samples and weights
        # by ~1e-6 relative
        tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["depth"].numpy().reshape(H, W), dp_j, **tol)
        np.testing.assert_allclose(out["weights_sum"].numpy().reshape(H, W), ws_j, **tol)
        np.testing.assert_allclose(out["image"][:, 0].numpy().reshape(H, W), rd_j, **tol)
        np.testing.assert_allclose(out["image"][:, 1].numpy().reshape(H, W), it_j, **tol)


def test_pano_to_lidar_matches_jax():
    pano = np.random.RandomState(3).uniform(0, 80, (H, W)).astype(np.float32)
    pano[pano < 20] = 0.0
    np.testing.assert_array_equal(pano_to_lidar(pano, INTRINSICS), pano_to_lidar_j(pano, INTRINSICS))


def test_test_frames_match_trainer_test(field, jax_panos):
    _, params, _ = field
    frames = PanoRenderer(OPT, params, device="cpu").test_frames(_poses(), H, W, INTRINSICS)
    assert len(frames) == 2
    for f, (rd_j, it_j, dp_j, _) in zip(frames, jax_panos):
        # Trainer.test's post-processing (trainer.py:726-736) of the JAX render
        mask = np.where(rd_j > 0.5, 1.0, 0.0)
        # no ray so close to the threshold that ulps could flip its mask
        assert 0 < mask.mean() < 1 and np.abs(rd_j - 0.5).min() > 1e-4
        it_j, dp_j = it_j * mask, dp_j * mask
        pts_j = pano_to_lidar_j(dp_j / OPT.scale, INTRINSICS)
        np.testing.assert_array_equal(f["raydrop"] > 0.5, rd_j > 0.5)
        tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(f["intensity"], it_j, **tol)
        np.testing.assert_allclose(f["depth"], dp_j, **tol)
        assert f["points"].shape == pts_j.shape
        np.testing.assert_allclose(f["points"], pts_j, rtol=1e-4, atol=1e-3)


def test_render_rays_without_upsampling_matches_jax(field):
    """The coarse-only branch (upsample_steps = 0): plain composite_weights."""
    module, params, _ = field
    cfg_j = RenderConfigJ(num_steps=OPT.num_steps, upsample_steps=0,
                          min_near_lidar=OPT.scale, bound=OPT.bound)
    cfg = RenderConfig(num_steps=OPT.num_steps, upsample_steps=0,
                       min_near_lidar=OPT.scale, bound=OPT.bound)
    rays = get_lidar_rays(torch.from_numpy(_poses()[:1]), INTRINSICS, H, W)
    o, d = rays["rays_o"][0, :128], rays["rays_d"][0, :128]
    ref = render_rays_j(module, jax.tree.map(jnp.asarray, params), jnp.asarray(o.numpy()),
                        jnp.asarray(d.numpy()), jax.random.PRNGKey(0), cfg_j, False)
    with torch.no_grad():
        out = render_rays(_network(params), o, d, cfg)
    for k in ("depth", "image", "weights_sum"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5)


def test_near_far_from_aabb_matches_jax():
    rs = np.random.RandomState(4)
    o = rs.uniform(-0.9, 0.9, (256, 3)).astype(np.float32)
    d = rs.normal(size=(256, 3)).astype(np.float32)
    d[:8, 0] = 0.0  # axis-parallel rays take the 1e-15 guard
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    near_j, far_j = near_far_j(*map(jnp.asarray, (o, d, lo, hi)), 0.05)
    near, far = near_far_from_aabb(*map(torch.from_numpy, (o, d, lo, hi)), 0.05)
    np.testing.assert_allclose(near.numpy(), np.asarray(near_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(far.numpy(), np.asarray(far_j), rtol=1e-6, atol=0)
    assert (near.numpy() >= 0.05).all() and (far.numpy() > near.numpy()).all()


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_fast_render_matches_jax(field, jax_panos, train):
    """Occupancy-prior sampling (--fast): the served pano through PanoRenderer
    against render_rays_staged, and the training render with the JAX key's
    draws injected (the stratified draw serves as occ_z_vals' xi)."""
    module, params, _ = field
    occ = dict(grid_size=32, bins=64)
    cfg_j = RenderConfigJ(num_steps=OPT.num_steps, upsample_steps=OPT.upsample_steps,
                          min_near_lidar=OPT.scale, min_near=OPT.scale, bound=OPT.bound,
                          occ=OccConfigJ(**occ))
    grid = shell_grid(32)
    jparams = jax.tree.map(jnp.asarray, params)
    pose = _poses()[0]
    tol = dict(rtol=1e-4, atol=1e-5)  # the whole-render tolerance above
    if not train:
        # the deterministic u is a linspace that XLA and torch round one ulp
        # apart at some entries (ROADMAP.md queue C); inverted through an
        # empty bin (pdf floor / K) that ulp moves z 1 / floor = 20 times as
        # far as in the stratified sampler, and a served raydrop by up to 1.4e-4
        tol = dict(rtol=2e-4, atol=1e-5)
        rays = get_lidar_rays_j(jnp.asarray(pose[None]), INTRINSICS, H, W, N=-1)
        ref = render_staged_j(module, jparams, rays["rays_o"][0], rays["rays_d"][0], cfg_j,
                              chunk=OPT.max_ray_batch, occ_grid=jnp.asarray(grid))
        opt = SimpleNamespace(**vars(OPT), occ_sampling=True, occ_grid_size=32, occ_bins=64)
        raydrop, intensity, depth = PanoRenderer(opt, params, device="cpu", occ_grid=grid
                                                 ).render_frame(pose, H, W, INTRINSICS)
        image = np.asarray(ref["image"]).reshape(H, W, -1)
        dp_j = np.asarray(ref["depth"]).reshape(H, W)
        # the grid moved the samples: not the stratified pano
        assert np.abs(dp_j - jax_panos[0][2]).max() > 1e-3
        np.testing.assert_allclose(depth, dp_j, **tol)
        np.testing.assert_allclose(raydrop, image[..., 0], **tol)
        np.testing.assert_allclose(intensity, image[..., 1], **tol)
        return
    rays = get_lidar_rays(torch.from_numpy(pose[None]), INTRINSICS, H, W)
    o, d = rays["rays_o"][0, :128], rays["rays_d"][0, :128]
    key = jax.random.PRNGKey(5)
    ref = render_rays_j(module, jparams, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), key,
                        cfg_j, True, jnp.asarray(grid))
    k_strat, k_pdf = jax.random.split(key)
    noise = np.array(jax.random.uniform(k_strat, (128, OPT.num_steps), dtype=jnp.float32))
    u = np.array(jax.random.uniform(k_pdf, (128, OPT.upsample_steps), dtype=jnp.float32))
    cfg = RenderConfig(num_steps=OPT.num_steps, upsample_steps=OPT.upsample_steps,
                       min_near_lidar=OPT.scale, min_near=OPT.scale, bound=OPT.bound,
                       occ=OccConfig(**occ))
    with torch.no_grad():
        out = render_rays(_network(params), o, d, cfg, train=True, noise=torch.from_numpy(noise),
                          u=torch.from_numpy(u), occ_grid=torch.from_numpy(grid))
    for k in ("depth", "image", "weights_sum"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **tol)
