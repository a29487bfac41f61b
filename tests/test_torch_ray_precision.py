"""The rotation of the ray directions by the pose, and its precision on a TPU:
the one float32 product outside the MLPs on the JAX package's `--fast`
training and evaluation path (ROADMAP.md C10).

`lidarnerf_tpu/dataset/base.py::rays_from_indices` rotates each pixel's
direction by the pose (`dirs @ pose[:3, :3].T`); the training step calls it
for its rays and `get_lidar_rays` maps it over the poses of the rendered
panos. The JAX package sets no matmul precision, so on a TPU, where its
round-5 runs trained and evaluated, that float32 product is one bfloat16
pass: both operands rounded to bfloat16 (8 significant bits), exact
products, float32 sums. The port rotates in float32 on both devices, as the
JAX package does on the CPU. `tools/torch_c10_bisect.py --arm tpu_rays`
(and `tpu_all`, with the MLPs at the same precision) emulates the TPU's
rotation on the card. The TPU itself is not run here: the emulation is held
against JAX's own bfloat16-operand, float32-result dot on the CPU.

Held here, over every pixel of the full 66 x 1030 pano at the 64 poses of
`data_synth_drive60/`:
- the port's float32 rotation against the JAX package's: on the same
  directions within 1 ulp of the sum of the terms' magnitudes
  (sum_c |d_c| |R_rc|); the whole ray (the libms' directions, up to 2 ulps
  apart, then the rotation) within 4 (3 measured); the pinhole camera's
  rays (`get_rays`, not on the LiDAR path) within 1 (bit-equal measured);
- the tool's emulated rotation (`tpu_rotate`) against `jax.lax.dot_general`
  on bfloat16 operands with float32 results, bit for bit, and the tool's
  arms patching every place that generates LiDAR rays;
- the difference between the two precisions, bounded: the angle between a
  float32 ray and its TPU-precision ray stays under ANGLE_BOUND (3.01e-3 rad
  measured: half a pixel, which spans 6.1e-3 rad across and 7.1e-3 rad up),
  and its length under NORM_BOUND of 1 (4.02e-3 measured: the renderer
  does not normalise a ray, so a TPU's depth along it scales by as much);
- that the JAX package's `--fast` training step and evaluation render hold
  no other float32 product: every `dot_general` of their jaxprs is an MLP
  layer's (forward and backward) or this rotation.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

from lidarnerf_tpu.dataset import base as base_j
from lidarnerf_tpu.models.occupancy import update_occ_grid as update_occ_grid_j
from lidarnerf_tpu.models.renderer import render_rays_staged as render_rays_staged_j
from lidarnerf_tpu.nerf import train_step as tsj
from lidarnerf_tpu_torch.dataset import base
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset
from lidarnerf_tpu_torch.models import network
from lidarnerf_tpu_torch.nerf import train_step
from test_torch_train import SEAMLESS, H, W, _make_field, _scene
from test_torch_epoch import _fast_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data_synth_drive60")
ANGLE_BOUND = 4e-3  # rad; 3.01e-3 measured
NORM_BOUND = 5e-3  # | |d_tpu| / |d| - 1 |; 4.02e-3 measured
# KITTI-360's rectified camera 0 (chip_smoke.py's RGB_INTRINSICS), for get_rays
CAMERA = (552.554261, 552.554261, 682.049453, 238.769549)


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_c10_bisect", os.path.join(ROOT, "tools", "torch_c10_bisect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


c10 = _load_tool()


@pytest.fixture(scope="module")
def drive():
    """(poses [64, 4, 4] of the train, val and test splits, H, W, intrinsics)."""
    with open(os.path.join(DATA, "scene_constants.json")) as f:
        c = json.load(f)
    sets = [KITTI360Dataset(root_path=DATA, split=s, scale=c["scale"], offset=c["offset"])
            for s in ("train", "val", "test")]
    d = sets[0]
    return np.concatenate([s.poses_lidar for s in sets]), d.H_lidar, d.W_lidar, d.intrinsics_lidar


def _pixels(h, w):
    inds = np.arange(h * w)
    return inds, (inds % w).astype(np.float32), (inds // w).astype(np.float32)


def _term_ulp(dirs, rot):
    """float32's spacing at sum_c |d_c| |R_rc|, each ray and row."""
    terms = np.abs(dirs).astype(np.float64) @ np.abs(rot).astype(np.float64).T
    return np.spacing(terms.astype(np.float32))


def test_port_rotation_equals_the_jax_rotation(drive, monkeypatch):
    """On the same directions (the JAX package's), the port's
    `rays_from_indices` and `get_lidar_rays` rotate within 1 ulp of the
    terms' magnitudes; with each package's own directions within 4."""
    poses, h, w, K = drive
    inds, i, j = _pixels(h, w)
    dirs_j = np.array(base_j._pixel_dirs(jnp.asarray(i), jnp.asarray(j), K, h, w))
    dirs_t = base._pixel_dirs(torch.from_numpy(i), torch.from_numpy(j), K, h, w).numpy()
    assert np.abs(dirs_t - dirs_j).max() <= 2 * np.spacing(np.float32(1.0))
    worst_same, worst_own = 0.0, 0.0
    for pose in poses:
        ref = np.asarray(base_j.rays_from_indices(jnp.asarray(pose), jnp.asarray(inds, jnp.int32),
                                                  h, w, K)[1])
        ulp = _term_ulp(dirs_j, pose[:3, :3])
        own = base.rays_from_indices(torch.from_numpy(pose), torch.from_numpy(inds), h, w, K)[1]
        worst_own = max(worst_own, float((np.abs(own.numpy() - ref) / ulp).max()))
        with monkeypatch.context() as m:
            m.setattr(base, "_pixel_dirs", lambda *a: torch.from_numpy(dirs_j))
            same = base.rays_from_indices(torch.from_numpy(pose), torch.from_numpy(inds), h, w, K)
            rays = base.get_lidar_rays(torch.from_numpy(pose[None]), K, h, w)
        worst_same = max(worst_same, float((np.abs(same[1].numpy() - ref) / ulp).max()))
        np.testing.assert_array_equal(rays["rays_d"][0].numpy(), same[1].numpy())
        np.testing.assert_array_equal(rays["rays_o"][0].numpy(), np.broadcast_to(pose[:3, 3], ref.shape))
    assert worst_same <= 1.0, worst_same
    assert worst_own <= 4.0, worst_own


def test_port_camera_rotation_equals_the_jax_rotation(drive):
    """`get_rays` (dataset/base.py's einsum; pinhole RGB rays, not on the
    LiDAR path) against the JAX `get_rays` at a KITTI-360 camera, within 1
    ulp of the terms' magnitudes (bit-equal as measured)."""
    poses = drive[0][::8]
    h, w = 376, 1408
    got = base.get_rays(torch.from_numpy(poses), CAMERA, h, w)["rays_d"].numpy()
    ref = np.asarray(base_j.get_rays(jnp.asarray(poses), CAMERA, h, w)["rays_d"])
    inds, i, j = _pixels(h, w)
    dirs = np.stack([(i + 0.5 - CAMERA[2]) / CAMERA[0], (j + 0.5 - CAMERA[3]) / CAMERA[1],
                     np.ones_like(i)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for b, pose in enumerate(poses):
        assert float((np.abs(got[b] - ref[b]) / _term_ulp(dirs, pose[:3, :3])).max()) <= 1.0


def test_tool_rotation_is_jax_bfloat16_pass(drive):
    """`tpu_rotate` = JAX's dot on bfloat16 operands with float32 results,
    bit for bit, and `tpu_rays_from_indices` is it on the port's directions;
    the operands really are rounded."""
    poses, h, w, K = drive
    inds, i, j = _pixels(h, w)
    dirs = base._pixel_dirs(torch.from_numpy(i), torch.from_numpy(j), K, h, w)
    for pose in poses[::4]:
        got = c10.tpu_rotate(dirs, torch.from_numpy(pose[:3, :3])).numpy()
        want = np.asarray(jax.lax.dot_general(
            jnp.asarray(dirs.numpy(), jnp.bfloat16), jnp.asarray(pose[:3, :3], jnp.bfloat16),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))
        np.testing.assert_array_equal(got, want)
        ro, rd = c10.tpu_rays_from_indices(torch.from_numpy(pose), torch.from_numpy(inds), h, w, K)
        np.testing.assert_array_equal(rd.numpy(), got)
        np.testing.assert_array_equal(ro.numpy(), np.broadcast_to(pose[:3, 3], got.shape))
        assert np.abs(got - (dirs @ torch.from_numpy(pose[:3, :3]).T).numpy()).max() > 1e-3


@pytest.mark.parametrize("arm", ["tpu_rays", "tpu_all"])
def test_tool_arms_patch_every_lidar_ray(drive, monkeypatch, arm):
    """`apply_arm` puts the emulation where the training step and
    `get_lidar_rays` (the trainer's and PanoRenderer's panos) find it; the
    names are restored after the test."""
    for mod, name in ((base, "rays_from_indices"), (train_step, "rays_from_indices"),
                      (network.MLP, "forward")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    c10.apply_arm(arm)
    assert train_step.rays_from_indices is base.rays_from_indices is c10.tpu_rays_from_indices
    assert (network.MLP.forward is c10.tpu_matmul_forward) == (arm == "tpu_all")
    poses, h, w, K = drive
    calls = c10.TPU_ROTATIONS[0]
    rays = base.get_lidar_rays(torch.from_numpy(poses[:2]), K, h, w)
    assert c10.TPU_ROTATIONS[0] == calls + 2
    _, i, j = _pixels(h, w)
    dirs = base._pixel_dirs(torch.from_numpy(i), torch.from_numpy(j), K, h, w)
    for b in range(2):
        np.testing.assert_array_equal(rays["rays_d"][b].numpy(), c10.tpu_rotate(
            dirs, torch.from_numpy(poses[b, :3, :3])).numpy())


def test_tpu_rotation_difference_is_bounded(drive):
    """Every ray of every pose: the angle between the float32 rotation and
    the TPU-precision one under ANGLE_BOUND, their lengths' ratio within
    NORM_BOUND of 1; and the rounding shows (the angle exceeds 1e-3 rad
    somewhere in every pose)."""
    poses, h, w, K = drive
    inds = torch.arange(h * w)
    for pose in poses:
        p = torch.from_numpy(pose)
        a = base.rays_from_indices(p, inds, h, w, K)[1].double()
        b = c10.tpu_rays_from_indices(p, inds, h, w, K)[1].double()
        angle = torch.atan2(torch.linalg.cross(a, b).norm(dim=-1), (a * b).sum(-1))
        ratio = b.norm(dim=-1) / a.norm(dim=-1)
        assert float(angle.max()) <= ANGLE_BOUND
        assert float((ratio - 1).abs().max()) <= NORM_BOUND
        assert float(angle.max()) > 1e-3


def _dots(jaxpr, out):
    """Every dot_general of a jaxpr and its sub-jaxprs: (lhs shape, rhs shape,
    dimension numbers)."""
    for eq in jaxpr.eqns:
        if eq.primitive.name == "dot_general":
            out.append((eq.invars[0].aval.shape, eq.invars[1].aval.shape,
                        eq.params["dimension_numbers"]))
        for v in eq.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dots(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dots(sub, out)
    return out


def _kinds(dots, kernels):
    """Each dot as "mlp" (a Dense layer's forward, input gradient or weight
    gradient: a kernel shape among its operands' trailing dimensions) or
    "rotation" ([..., 3] directions by [..., 3, 3] poses)."""
    kinds = []
    for a, b, ((ca, cb), _) in dots:
        if (len(b) == 2 and b in kernels) or (a[-1], b[-1]) in kernels or (b[-1], a[-1]) in kernels:
            kinds.append("mlp")
        elif b[-2:] == (3, 3) and a[ca[0]] == 3:
            kinds.append("rotation")
        else:
            kinds.append(f"other {a} x {b}")
    return kinds


def test_jax_fast_path_rounds_only_the_mlps_and_the_rotation():
    """The JAX package's `--fast` training step (both patch sizes), its grid
    refresh and its staged evaluation render: every float32 product is an MLP
    layer's or the rotation, one rotation a step and one a pano. (On a TPU
    the block-hash kernels' lane selections add products on bfloat16 halves
    of a split float32, hi + lo: 16 significant bits by construction, not
    the default precision's one pass; they do not appear on the CPU, where
    the encoder is XLA.)"""
    module, params = _make_field(**SEAMLESS)
    tcfg_j, _, rcfg_j, _ = _fast_configs()
    poses, images = _scene()
    p = jax.tree.map(jnp.asarray, params)
    kernels = {tuple(np.shape(v["kernel"])) for net in ("sigma_net", "lidar_color_net")
               for v in params["params"][net].values()}
    grid = jnp.ones((rcfg_j.occ.grid_size,) * 3, jnp.float32)
    vi, vc = jnp.zeros((2, 1), jnp.int32), jnp.full((2,), H * W, jnp.int32)
    opt_state = tsj.make_optimizer(tcfg_j).init(p)
    for patch in (1, [2, 8]):
        step = tsj.make_train_step(module, tcfg_j, rcfg_j, patch, False)
        step = getattr(step, "__wrapped__", step)
        jaxpr = jax.make_jaxpr(lambda q, s, g: step(
            q, s, jnp.asarray(poses), jnp.asarray(images), vi, vc, 0, jax.random.PRNGKey(0), 0,
            occ_grid=g))(p, opt_state, grid)
        kinds = _kinds(_dots(jaxpr.jaxpr, []), kernels)
        assert kinds.count("rotation") == 1 and kinds.count("mlp") == len(kinds) - 1, kinds
    jaxpr = jax.make_jaxpr(lambda q, g: update_occ_grid_j(
        module, q, g, jax.random.PRNGKey(0), rcfg_j.occ, rcfg_j.bound))(p, grid)
    assert set(_kinds(_dots(jaxpr.jaxpr, []), kernels)) == {"mlp"}

    def evaluate(q, pose):
        rays = base_j.get_lidar_rays(pose[None], (2.0, 26.9), H, W, N=-1)
        return render_rays_staged_j(module, q, rays["rays_o"][0], rays["rays_d"][0], rcfg_j,
                                    chunk=256, occ_grid=grid)

    kinds = _kinds(_dots(jax.make_jaxpr(evaluate)(p, jnp.asarray(poses[0])).jaxpr, []), kernels)
    assert kinds.count("rotation") == 1 and kinds.count("mlp") == len(kinds) - 1, kinds
