"""Port parity for the training slice: lidarnerf_tpu_torch's train step vs the JAX package's.

A small blockhash field (4 levels, 2^14 budget, hidden 32, fp32, 64 + 8
samples, 64 rays on an 8 x 64 pano) is flax-initialised and passed through
the weight bridge. Every random draw of the JAX step is derived from its key
exactly as `make_loss_fn` derives it and handed to the port's step, so both
sides train on the same pixels and the same samples.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lidarnerf_tpu.dataset.base import sample_ray_indices as sample_ray_indices_j
from lidarnerf_tpu.dataset.kitti360 import KITTI360Dataset as KITTI360DatasetJ
from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
from lidarnerf_tpu.models.occupancy import OccConfig as OccConfigJ
from lidarnerf_tpu.models.renderer import RenderConfig as RenderConfigJ
from lidarnerf_tpu.nerf import train_step as tsj
from lidarnerf_tpu_torch.dataset.base import get_lidar_rays, rays_from_indices, sample_ray_indices
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.occupancy import OccConfig
from lidarnerf_tpu_torch.models.renderer import RenderConfig
from lidarnerf_tpu_torch.nerf import train_step as tst
from lidarnerf_tpu_torch.nerf.trainer import Trainer
from lidarnerf_tpu_torch.utils.params import params_from_jax, params_to_jax
from test_torch_occupancy import shell_grid

H, W, N = 8, 64, 64
T, S = 64, 8  # coarse + fine samples
SCALE = 0.010784853507573345
NET = dict(encoding="blockhash", desired_resolution=64, log2_hashmap_size=14, num_levels=4,
           hidden_dim=32, geo_feat_dim=15, bound=1.0)
LOSS = dict(scale=SCALE, num_rays_lidar=N, H_lidar=H, W_lidar=W, alpha_i=10.0)
DATA = "data_synth_drive60"


def _scene(n_frames=2):
    """Poses near the origin and (raydrop, intensity, depth * scale) panos.

    Depth is constant over runs of 4 columns, so the patch grad loss's
    0.01 m gt-gradient mask keeps some pixels and drops others.
    """
    rs = np.random.RandomState(0)
    poses, images = [], []
    for k in range(n_frames):
        a = 0.4 * k
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        pose[:3, 3] = rs.uniform(-0.05, 0.05, 3)
        depth_m = np.repeat(rs.uniform(5.0, 60.0, (H, W // 4)), 4, axis=1)
        raydrop = (rs.uniform(size=(H, W)) < 0.85).astype(np.float32)
        intensity = rs.uniform(0.0, 1.0, (H, W))
        images.append(np.stack([raydrop, intensity * raydrop, depth_m * raydrop * SCALE], -1))
        poses.append(pose)
    return np.stack(poses).astype(np.float32), np.stack(images).astype(np.float32)


def _make_field(**net):
    module = FlaxNeRF(compute_dtype=jnp.float32, **{**NET, **net})
    params = jax.tree.map(
        np.array, module.init(jax.random.PRNGKey(1), jnp.zeros((8, 3)), jnp.zeros((8, 3)))
    )
    p = params["params"]
    p["hash_table"] *= 1e4
    p["sigma_net"]["Dense_1"]["kernel"][:, 0] *= 3.0
    p["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.1
    return module, params


@pytest.fixture(scope="module")
def field():
    """(flax module, numpy params) of a field with structure.

    Every level holds O(1) values (all four are coarse: resolution 16 to 64,
    for the block-seam reason tests/test_torch_render.py gives) and the
    density head is sharpened, so densities vary along and across rays.
    The sharpening stays mild: the density gradient is the compositing
    gradient times exp(h), so a sharper head amplifies fp32 rounding in
    the transmittance sums into the table's gradient.
    """
    return _make_field()


# every level one block of 4 x 4 x 4 corners (scales 1 to 2): no block seams
SEAMLESS = dict(base_resolution=2, desired_resolution=3)


@pytest.fixture(scope="module")
def seamless_field():
    """`field`'s construction on a table with no block seams.

    Under --fast the coarse depths come from an inverse-CDF cumsum that XLA
    and torch sum in another order (about 1e-6 apart), and a sample that
    crosses a block seam sends its gradient to another table row; with one
    block per level the table gradient is continuous in the sample positions.
    """
    return _make_field(**SEAMLESS)


# the reference-exact hash grid at the same widths: dense coarse levels,
# hashed fine ones (65^3 corners pass the 2^14 budget)
HASHGRID = dict(encoding="hashgrid")


@pytest.fixture(scope="module")
def hashgrid_field():
    """`field`'s construction under --encoding hashgrid; the hash grid is
    continuous across its cells, so every level holds O(1) values."""
    return _make_field(**HASHGRID)


OCC = dict(grid_size=16, bins=32)  # the --fast sampler at a small grid


def _configs(occ=False, **kw):
    tcfg_j = tsj.TrainConfig(**LOSS, **kw)
    tcfg = tst.TrainConfig(**LOSS, **kw)
    rcfg_j = RenderConfigJ(num_steps=T, upsample_steps=S, min_near_lidar=SCALE, min_near=SCALE,
                           occ=OccConfigJ(**OCC) if occ else None)
    rcfg = RenderConfig(num_steps=T, upsample_steps=S, min_near_lidar=SCALE, min_near=SCALE,
                        occ=OccConfig(**OCC) if occ else None)
    return tcfg_j, tcfg, rcfg_j, rcfg


def _draws(key, patch, masked, vc, n=N, t=T, s=S, h=H, w=W):
    """What make_loss_fn draws from `key` (train_step.py:234-263, renderer.py:115,
    sampling.py:38,68), in the port's `draws` form: n rays of t + s samples
    on an h x w pano."""
    k_pix, k_render = jax.random.split(key)
    k_strat, k_pdf = jax.random.split(k_render)
    d = {"noise": np.asarray(jax.random.uniform(k_strat, (n, t), dtype=jnp.float32)),
         "u": np.asarray(jax.random.uniform(k_pdf, (n, s), dtype=jnp.float32))}
    if masked:
        d["pool_draws"] = np.asarray(jax.random.randint(k_pix, (n,), 0, vc))
    else:
        d["inds"] = np.asarray(sample_ray_indices_j(k_pix, h, w, n, patch))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_grads(net):
    return _flat(params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                for k, p in net.named_parameters()}))


def _grad_tol(name):
    """Tolerance of a parameter's gradient, relative to its largest entry.

    fp32 on both sides, the compositing sums and the table's scatter-add
    taken in another order: 2e-5. The LiDAR head reads the degree-12
    frequency encoding of the ray directions, whose sin(2^11 d) turns the
    two libms' one-ulp difference in d into ~2e-4 of its input, and its
    layers' gradients carry that: 2e-3 there.
    """
    return 2e-3 if name.startswith("params/lidar_color_net/") else 2e-5


CASES = {
    "patch1": dict(patch=1, masked=False, kw={}),
    "patch2x8_grad_loss": dict(patch=[2, 8], masked=False, kw=dict(grad_loss=True)),
    "masked": dict(patch=1, masked=True, kw={}),
    # occupancy-prior sampling on the seamless field: the coarse draw
    # doubles as occ_z_vals' xi
    "fast": dict(patch=1, masked=False, kw={}, occ=True, net=SEAMLESS, field="seamless_field"),
    # the hash grid's order-free table gradient against XLA's scatter-add
    "hashgrid": dict(patch=[2, 8], masked=False, kw=dict(grad_loss=True), net=HASHGRID,
                     field="hashgrid_field"),
}


VARIANT_ENV = {"seg": "LIDARNERF_SEG_KERNELS", "win": "LIDARNERF_WIN_KERNELS"}


@pytest.mark.parametrize(
    "case, variant",
    [pytest.param(c, v, id=c if v == "default" else f"{c}-{v}")
     for v in ("default", "seg", "win") for c in CASES
     if v == "default" or c not in ("fast", "hashgrid")],
)
def test_train_step_matches_jax(field, case, variant, monkeypatch, request):
    """The port's step under each block-hash variant vs the JAX step.

    The variant switch selects the port's table-gradient path (on the CPU
    the variant's plain backward, which sums runs or windows first); the
    JAX step on the CPU ignores it, so both sides hold one function.
    """
    monkeypatch.delenv("LIDARNERF_SEG_KERNELS", raising=False)
    monkeypatch.delenv("LIDARNERF_WIN_KERNELS", raising=False)
    if variant != "default":
        monkeypatch.setenv(VARIANT_ENV[variant], "1")
    net_kw = {**NET, **CASES[case].get("net", {})}
    module, params = request.getfixturevalue(CASES[case].get("field", "field"))
    patch, masked, kw = CASES[case]["patch"], CASES[case]["masked"], CASES[case]["kw"]
    occ = CASES[case].get("occ", False)
    tcfg_j, tcfg, rcfg_j, rcfg = _configs(occ, **kw)
    # every ray (its far end 0.87 away) crosses the shell
    grid = shell_grid(OCC["grid_size"], 0.25, 0.55) if occ else None
    poses, images = _scene()
    frame = 1
    if masked:  # a pool of every third pixel, padded past its count
        pool = np.arange(0, H * W, 3)
        vc = np.array([len(pool) - 40, len(pool) - 7], np.int32)
        vi = np.stack([pool, pool[::-1].copy()]).astype(np.int32)
    else:
        vi, vc = np.zeros((2, 1), np.int32), np.full((2,), H * W, np.int32)
    key = jax.random.PRNGKey(7)

    # the JAX package: gradients of its loss closure, then make_train_step itself
    loss_fn = tsj.make_loss_fn(module, tcfg_j, rcfg_j, patch, masked)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(poses[frame]),
        jnp.asarray(images[frame].reshape(-1, 3)), jnp.asarray(vi[frame]),
        jnp.asarray(vc[frame]), key, None if grid is None else jnp.asarray(grid))
    step_j = tsj.make_train_step(module, tcfg_j, rcfg_j, patch_size=patch, masked_sampling=masked)
    jp = jax.tree.map(jnp.asarray, params)
    new_j, _, m_j = step_j(jp, tsj.make_optimizer(tcfg_j).init(jp), *map(jnp.asarray, (
        poses, images, vi, vc)), frame, key, 0,
        occ_grid=None if grid is None else jnp.asarray(grid))

    # the port, fed the same draws
    net = NeRFNetwork(**net_kw)
    net.load_state_dict(params_from_jax(params))
    step = tst.make_train_step(net, tcfg, rcfg, patch_size=patch, masked_sampling=masked,
                               device="cpu")
    m = step(*map(torch.from_numpy, (poses, images, vi.astype(np.int64), vc.astype(np.int64))),
             frame, draws=_draws(key, patch, masked, int(vc[frame])),
             occ_grid=None if grid is None else torch.from_numpy(grid))

    assert m["skipped_nonfinite"] == 0.0 and float(m_j["skipped_nonfinite"]) == 0.0
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
    for k in ("depth_mae", "raydrop_err"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=1e-7)

    gj, gt = _flat(jax.tree.map(np.asarray, grads_j)), _port_grads(net)
    assert gj.keys() == gt.keys()
    before, after_j = _flat(params), _flat(jax.tree.map(np.asarray, new_j))
    after = _flat(params_to_jax(net.state_dict()))
    for name, ref in gj.items():
        peak = np.abs(ref).max()
        if name.startswith("params/color_net"):  # the RGB head is not on the LiDAR path
            assert peak == 0 and (gt[name] == 0).all()
            continue
        assert peak > 0, name
        np.testing.assert_allclose(gt[name], ref, rtol=0, atol=_grad_tol(name) * peak,
                                   err_msg=name)
        # Adam's first step moves an element by about lr whatever its
        # gradient's size, so only elements above the noise floor must agree
        live = np.abs(ref) > 1e-3 * peak
        assert live.any()
        np.testing.assert_allclose(after[name][live], after_j[name][live], rtol=0, atol=1e-6,
                                   err_msg=name)
        moved = np.abs(after[name][live] - before[name][live])
        np.testing.assert_allclose(moved, tcfg.lr, rtol=1e-3)


def test_adam_and_schedule_match_optax():
    """DeviceAdam against optax.adam with the schedule: the lr of each update
    (a float32 on the device, equal to optax's), the parameters, both
    moments and both counts."""
    cfg_j = tsj.TrainConfig(lr=1e-2, iters=4)
    rs = np.random.RandomState(3)
    p0 = {"a": rs.uniform(-1, 1, (5, 7)).astype(np.float32),
          "b": rs.uniform(-1, 1, (3,)).astype(np.float32)}
    grads = [{k: rs.normal(size=v.shape).astype(np.float32) * 10.0 ** -i for k, v in p0.items()}
             for i in range(3)]
    tx = tsj.make_optimizer(cfg_j)
    pj = jax.tree.map(jnp.asarray, p0)
    state = tx.init(pj)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    adam = tst.make_optimizer(list(tparams.items()), tst.TrainConfig(lr=1e-2, iters=4))
    for i, g in enumerate(grads):
        lr_j = cfg_j.lr * 0.1 ** jnp.minimum(jnp.int32(i) / cfg_j.iters, 1.0)
        assert float(adam.lr_now()) == float(lr_j)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        assert bool(adam.step(torch.tensor(1.0)))
        # the same fp32 Adam step, rounded in another order: ~1 ulp of p
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]), rtol=0, atol=2e-7)
    adam_state, sched_state = state
    assert int(adam.count) == int(adam_state.count) == 3
    assert int(adam.schedule_count) == int(sched_state.count) == 3
    for i, k in enumerate(tparams):  # the fused kernel's fma: a few ulps of the peak
        for got, ref in ((adam.mu[i], adam_state.mu[k]), (adam.nu[i], adam_state.nu[k])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=4e-7 * np.abs(ref).max())


def _small_step(field, images):
    module, params = field
    _, tcfg, _, rcfg = _configs()
    net = NeRFNetwork(**NET)
    net.load_state_dict(params_from_jax(params))
    step = tst.make_train_step(net, tcfg, rcfg, device="cpu")
    poses, _ = _scene()
    vi, vc = torch.zeros((2, 1), dtype=torch.long), torch.full((2,), H * W)
    g = torch.Generator().manual_seed(0)
    return net, step, lambda imgs: step(torch.from_numpy(poses), torch.from_numpy(imgs), vi, vc,
                                        0, generator=g)


def _snapshot(net, step):
    adam = step.optimizer
    state = {f"{kind} {n}": t.clone() for kind, ts in (("mu", adam.mu), ("nu", adam.nu))
             for n, t in zip(adam.names, ts)}
    return ({k: v.clone() for k, v in net.state_dict().items()}, state,
            (adam.count.clone(), adam.schedule_count.clone()))


def test_guarded_update_skips_nan_batch(field):
    """The counterpart of tests/test_train.py::TestNonFiniteGuard::test_nan_batch_skips_update:
    parameters, Adam moments, Adam's step and the schedule count are all kept,
    bit for bit, and the skip flag is a device value."""
    _, images = _scene()
    net, step, run = _small_step(field, images)
    assert run(images)["skipped_nonfinite"] == 0.0  # the Adam state is not zero now
    params0, state0, count0 = _snapshot(net, step)
    bad = images.copy()
    bad[..., 2] = np.nan  # poisoned gt depths -> NaN loss and grads
    m = run(bad)
    assert torch.is_tensor(m["skipped_nonfinite"]) and m["skipped_nonfinite"].dim() == 0
    assert m["skipped_nonfinite"] == 1.0 and not np.isfinite(float(m["loss"]))
    params1, state1, count1 = _snapshot(net, step)
    assert [int(c) for c in count1] == [int(c) for c in count0] == [1, 1]
    for k in params0:
        torch.testing.assert_close(params1[k], params0[k], rtol=0, atol=0)
    assert state1.keys() == state0.keys()
    for k, v in state0.items():
        torch.testing.assert_close(state1[k], v, rtol=0, atol=0)


def test_guarded_update_keeps_healthy_batch(field):
    """The counterpart of TestNonFiniteGuard::test_healthy_batch_not_skipped."""
    _, images = _scene()
    net, step, run = _small_step(field, images)
    params0 = {k: v.clone() for k, v in net.state_dict().items()}
    m = run(images)
    assert m["skipped_nonfinite"] == 0.0 and np.isfinite(float(m["loss"]))
    assert int(step.optimizer.count) == int(step.optimizer.schedule_count) == 1
    assert any(not torch.equal(v, net.state_dict()[k]) for k, v in params0.items())


@pytest.mark.parametrize("num_updates", [0, 5, 200])
def test_ema_update_matches_jax(num_updates):
    rs = np.random.RandomState(num_updates)
    e = {"a": rs.normal(size=(4, 6)).astype(np.float32), "b": rs.normal(size=(9,)).astype(np.float32)}
    p = {k: rs.normal(size=v.shape).astype(np.float32) for k, v in e.items()}
    ref = tsj.ema_update(jax.tree.map(jnp.asarray, e), jax.tree.map(jnp.asarray, p), 0.95,
                         num_updates)
    ema = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    out = tst.ema_update(ema, {k: torch.from_numpy(v) for k, v in p.items()}, 0.95, num_updates)
    assert out is ema
    for k in e:  # fp32 d * e + (1 - d) * p, the decay rounded apart by an ulp
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("patch", [[2, 8], 4, [3]], ids=["2x8", "4", "3"])
def test_sample_ray_indices_with_injected_corners_match_jax(patch):
    key = jax.random.PRNGKey(11)
    px, py = (patch, patch) if isinstance(patch, int) else (patch * 2)[:2]
    ref = np.asarray(sample_ray_indices_j(key, H, W, N, patch))
    # the corners sample_ray_indices draws (dataset/base.py:60-63)
    kx, ky = jax.random.split(key)
    n = N // (px * py)
    ix = np.asarray(jax.random.randint(kx, (n,), 0, H - px))
    iy = np.asarray(jax.random.randint(ky, (n,), 0, W - py))
    out = sample_ray_indices(H, W, N, patch, corners=(ix.copy(), iy.copy()))
    np.testing.assert_array_equal(out.numpy(), ref)
    # drawn from a generator: the same law, whole patches inside the pano
    drawn = sample_ray_indices(H, W, N, patch, generator=torch.Generator().manual_seed(1))
    blocks = drawn.reshape(n, px, py)
    rows, cols = blocks // W, blocks % W
    assert (rows[:, 0, 0] <= H - px - 1).all() and (cols[:, 0, 0] <= W - py - 1).all()
    assert (rows - rows[:, :1, :1] == torch.arange(px)[:, None]).all()
    assert (cols - cols[:, :1, :1] == torch.arange(py)[None, :]).all()


def test_get_lidar_rays_samples_pixels():
    poses = torch.from_numpy(_scene()[0])
    out = get_lidar_rays(poses, (2.0, 26.9), H, W, N=N, generator=torch.Generator().manual_seed(2))
    assert out["rays_o"].shape == out["rays_d"].shape == (2, N, 3)
    inds = out["inds"][0]
    assert (out["inds"] == inds).all() and inds.min() >= 0 and inds.max() < H * W
    for b in range(2):
        o, d = rays_from_indices(poses[b], inds, H, W, (2.0, 26.9))
        torch.testing.assert_close(out["rays_d"][b], d, rtol=0, atol=0)


def test_gumbel_sampling_without_replacement_matches_jax():
    """The gumbel top-k branch of make_loss_fn (train_step.py:235-258), from injected draws."""
    pool, vc = 200, 180
    valid_idx = np.random.RandomState(4).permutation(H * W)[:pool]
    g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(5), (pool,)))
    gm = jnp.where(jnp.arange(pool) < vc, g, -jnp.inf)
    _, top = jax.lax.top_k(gm, N)
    ref = np.asarray(valid_idx)[np.asarray(top)]
    cfg = tst.TrainConfig(num_rays_lidar=N, H_lidar=H, W_lidar=W)
    out = tst.sample_pixels(cfg, 1, True, True, torch.from_numpy(valid_idx), torch.tensor(vc),
                            draws={"gumbel": torch.from_numpy(np.array(g))})
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(set(out.tolist())) == N  # without replacement


def _drive(split="train"):
    import json

    with open(f"{DATA}/scene_constants.json") as f:
        c = json.load(f)
    return c["scale"], c["offset"]


def test_kitti360_dataset_matches_jax_loader():
    scale, offset = _drive()
    ref = KITTI360DatasetJ(root_path=DATA, split="train", scale=scale, offset=offset)
    ds = KITTI360Dataset(root_path=DATA, split="train", scale=scale, offset=offset)
    assert len(ds) == len(ref) == 60 and (ds.H_lidar, ds.W_lidar) == (66, 1030)
    np.testing.assert_array_equal(ds.poses_lidar, ref.poses_lidar)
    np.testing.assert_array_equal(ds.images_lidar, ref.images_lidar)
    assert ds.intrinsics_lidar == ref.intrinsics_lidar
    poses, images = ds.device_arrays("cpu")
    assert poses.shape == (60, 4, 4) and images.shape == (60, 66, 1030, 3)
    assert ds.device_arrays("cpu")[1] is images  # cached
    np.testing.assert_array_equal(images.numpy(), ref.images_lidar)


class _TinyData:
    def __init__(self):
        self.poses, self.images = map(torch.from_numpy, _scene(3))

    def device_arrays(self, device):
        return self.poses.to(device), self.images.to(device)

    def __len__(self):
        return 3


def test_trainer_epochs_follow_the_patch_schedule(field):
    _, params = field
    opt = SimpleNamespace(
        alpha_d=1e3, alpha_r=1.0, alpha_i=10.0, alpha_grad_norm=1.0, alpha_spatial=0.1,
        alpha_tv=1.0, alpha_grad=100.0, depth_loss="l1", depth_grad_loss="l1",
        intensity_loss="mse", raydrop_loss="mse", spatial_smooth=False, grad_norm_smooth=False,
        tv_loss=False, grad_loss=True, sobel_grad=False, scale=SCALE, num_rays_lidar=N,
        H_lidar=H, W_lidar=W, lr=1e-2, iters=30000, num_steps=T, upsample_steps=S,
        min_near_lidar=SCALE, min_near=SCALE, bound=1.0, patch_size_lidar=1,
        change_patch_size_lidar=[2, 8], change_patch_size_epoch=2, seed=0,
    )
    net = NeRFNetwork(**NET)
    net.load_state_dict(params_from_jax(params))
    trainer = Trainer("t", opt, net, device="cpu", ema_decay=0.95, mute=True, workspace=None)
    ema0 = {k: v.clone() for k, v in trainer.ema_params.items()}
    trainer.train(_TinyData(), None, max_epochs=2)
    assert trainer.epoch == 2 and trainer.global_step == 6
    # epoch 1 trains patch 1, epoch 2 the [2, 8] patches (trainer.py:367-378),
    # both with the dense sampler (the epoch functions are keyed as the JAX
    # trainer's: patch size, masked sampling)
    assert set(trainer._epoch_fns) == {(1, False), ((2, 8), False)}
    assert len(trainer.stats["step_loss"]) == 6 and np.isfinite(trainer.stats["step_loss"]).all()
    assert trainer.stats["skipped"] == [0.0] * 6
    assert int(trainer.optimizer.count) == int(trainer.optimizer.schedule_count) == 6
    assert trainer.ema_num_updates == 2
    assert not torch.equal(trainer.ema_params["hash_table"], ema0["hash_table"])
    assert trainer.log_ptr is None and trainer.stats["checkpoints"] == []  # no workspace
    # --fast is ported: the Trainer builds the CLI's default occupancy config and a zero grid
    fast = Trainer("t", SimpleNamespace(**{**vars(opt), "occ_sampling": True}), net,
                   device="cpu", mute=True, workspace=None)
    assert fast.render_cfg.occ == OccConfig() and fast.occ_grid.shape == (128,) * 3
    assert not fast.occ_grid.any() and trainer.occ_grid is None
    # the seam regulariser is ported: a step with alpha_seam > 0 builds and trains
    _, tcfg, _, rcfg = _configs(alpha_seam=0.1)
    step = tst.make_train_step(net, tcfg, rcfg, device="cpu")
    m = step(*_TinyData().device_arrays("cpu"), torch.zeros((3, 1), dtype=torch.long),
             torch.full((3,), H * W), 0, generator=torch.Generator().manual_seed(0))
    assert m["skipped_nonfinite"] == 0.0 and torch.isfinite(m["loss"])


def test_trainer_refreshes_the_occ_grid_every_interval(field, monkeypatch):
    """--fast: the grid is refreshed from the live weights before each step
    whose global step is a multiple of occ_update_interval, from step 0, as
    lidarnerf_tpu/nerf/trainer.py:480-491 does, and each step gets it."""
    _, params = field
    opt = SimpleNamespace(
        alpha_d=1e3, alpha_r=1.0, alpha_i=10.0, alpha_grad_norm=1.0, alpha_spatial=0.1,
        alpha_tv=1.0, alpha_grad=100.0, depth_loss="l1", depth_grad_loss="l1",
        intensity_loss="mse", raydrop_loss="mse", spatial_smooth=False, grad_norm_smooth=False,
        tv_loss=False, grad_loss=False, sobel_grad=False, scale=SCALE, num_rays_lidar=N,
        H_lidar=H, W_lidar=W, lr=1e-2, iters=30000, num_steps=T, upsample_steps=S,
        min_near_lidar=SCALE, min_near=SCALE, bound=1.0, patch_size_lidar=1,
        change_patch_size_lidar=[1], change_patch_size_epoch=2, seed=0,
        occ_sampling=True, occ_grid_size=8, occ_update_interval=2, occ_bins=16,
    )
    net = NeRFNetwork(**NET)
    net.load_state_dict(params_from_jax(params))
    trainer = Trainer("t", opt, net, device="cpu", mute=True, workspace=None)
    assert trainer.render_cfg.occ == OccConfig(grid_size=8, update_interval=2, bins=16)
    refreshed, stepped = [], []
    refresh, make_step = tst.update_occ_grid, tst.make_train_step
    grid = trainer.occ_grid

    def counting_refresh(model, grid, *args, **kw):
        assert model is trainer.model  # the live weights, not the EMA
        refreshed.append(len(stepped))  # the global step of the next step
        return refresh(model, grid, *args, **kw)

    def recording_step(*args, **kw):
        step = make_step(*args, **kw)

        def run(*a, occ_grid=None, **k):
            stepped.append(occ_grid is grid)
            return step(*a, occ_grid=occ_grid, **k)

        return run

    monkeypatch.setattr(tst, "update_occ_grid", counting_refresh)
    monkeypatch.setattr(tst, "make_train_step", recording_step)
    trainer.train(_TinyData(), None, max_epochs=2)  # 2 x 3 steps
    assert trainer.global_step == 6 and refreshed == [0, 2, 4]
    # every step reads the one grid, which the refreshes update in place
    assert stepped == [True] * 6 and trainer.occ_grid is grid
    assert trainer.occ_grid.shape == (8,) * 3 and trainer.occ_grid.any()
    assert np.isfinite(trainer.stats["step_loss"]).all() and not any(trainer.stats["skipped"])
