"""Port parity for the block-hash seam options: `tie_dense_seams`,
`sync_hashed_seams` and `block_hash_seam_loss`, the network's `seam_tie`,
the step's `alpha_seam` and the trainer's `seam_sync_hashed`, against the
JAX package.

The JAX functions draw their seam samples from `jax.random` keys; the tests
rebuild those draws from the same keys (`jax_seam_draws`) and inject them
into the port, which otherwise draws from its torch generator. The tie and
the sync hold bit for bit; the loss at 1e-6 relative and its table gradient
(an order-free fixed-point scatter against XLA's scatter-add) at 1e-6 of
its largest entry.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
from lidarnerf_tpu.nerf import train_step as tsj
from lidarnerf_tpu.ops import block_hash as bhj
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.nerf import train_step as tst
from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
from lidarnerf_tpu_torch.ops import block_hash as bh
from lidarnerf_tpu_torch.utils.params import params_from_jax, params_to_jax
from test_torch_train import H, LOSS, NET, S, T, W, _configs, _draws, _flat, _port_grads, _scene

SPECS = {
    # every level one block per axis (nb < 2): nothing to tie, nothing to sync
    "one-block": dict(num_levels=4, base_resolution=2, log2_hashmap_size=10,
                      desired_resolution=3),
    # dense coarse levels (6^3, 9^3 blocks within 1024) and hashed fine ones
    "dense-hashed": dict(num_levels=4, base_resolution=16, log2_hashmap_size=16,
                         desired_resolution=64),
    # six levels, 2^18 budget: two dense (6^3, 12^3 blocks within 4096), four hashed
    "six-levels": dict(num_levels=6, base_resolution=16, log2_hashmap_size=18,
                       desired_resolution=512),
}


def _specs(name):
    return bhj.make_block_hash_spec(**SPECS[name]), bh.make_block_hash_spec(**SPECS[name])


def _table(spec, seed=0):
    return np.random.RandomState(seed).randn(spec.table_rows, 128).astype(np.float32)


def jax_seam_draws(spec, key, n, hashed_only):
    """The (m, other) samples the JAX seam functions draw from `key`
    (block_hash.py:375-385, 448-457), keyed by (level, axis)."""
    keys = jax.random.split(key, spec.num_levels * 3)
    out = {}
    for li, level in enumerate(spec.levels):
        max_corner = level.max_cell + 1
        n_seams = min(max_corner // 3, level.blocks_axis - 1)
        if n_seams < 1 or (hashed_only and level.dense):
            continue
        for axis in range(3):
            km, ko = jax.random.split(keys[li * 3 + axis])
            m = jax.random.randint(km, (n,), 1, n_seams + 1)
            other = jax.random.randint(ko, (n, 3), 0, max_corner + 1)
            out[(li, axis)] = (torch.from_numpy(np.array(m)).long(),
                               torch.from_numpy(np.array(other)).long())
    return out


def test_spec_cases_cover_dense_hashed_and_single_block_levels():
    for name, want in (("one-block", {(True, 1)}), ("dense-hashed", {True, False}),
                       ("six-levels", {True, False})):
        _, spec = _specs(name)
        if name == "one-block":
            assert {(lv.dense, lv.blocks_axis) for lv in spec.levels} == want
        else:
            assert {lv.dense for lv in spec.levels} == want


@pytest.mark.parametrize("name", ["dense-hashed", "six-levels"])
def test_corner_row_lane_matches_jax(name):
    """(row, lane0) of corners in their blocks at every level, dense and
    hashed (the uint32 prime-XOR, done in int64), equal to `_corner_row_lane`;
    block coordinates up to 2^20 make the hash products wrap."""
    sj, sp = _specs(name)
    rs = np.random.RandomState(4)
    for li, lv in enumerate(sp.levels):
        hi = lv.blocks_axis if lv.dense else 2**20
        block = rs.randint(0, hi, (512, 3))
        g = block * 3 + rs.randint(0, 4, (512, 3))
        row_j, lane_j = bhj._corner_row_lane(jnp.asarray(g, jnp.int32),
                                              jnp.asarray(block, jnp.int32), sj.levels[li], li, sj)
        row, lane = bh.corner_row_lane(torch.from_numpy(g), torch.from_numpy(block), lv, li, sp)
        np.testing.assert_array_equal(row.numpy(), np.asarray(row_j))
        np.testing.assert_array_equal(lane.numpy(), np.asarray(lane_j))


@pytest.mark.parametrize("name", list(SPECS))
def test_tie_dense_seams_matches_jax(name):
    """The tied table bit for bit, and its VJP against jax.vjp bit for bit
    (slices and halvings: no sum in another order)."""
    sj, sp = _specs(name)
    tab = _table(sp)
    ref, vjp = jax.vjp(lambda t: bhj.tie_dense_seams(t, sj), jnp.asarray(tab))
    t = torch.from_numpy(tab.copy()).requires_grad_()
    out = bh.tie_dense_seams(t, sp)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    g = np.random.RandomState(1).randn(*tab.shape).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    if name == "one-block":
        assert out is t  # no dense level has two blocks: the table itself
    else:
        assert not np.array_equal(np.asarray(ref), tab)
        # idempotent: the copies already agree
        np.testing.assert_array_equal(bh.tie_dense_seams(out.detach(), sp).numpy(),
                                      out.detach().numpy())


def test_tie_dense_seams_equalises_the_copies():
    """After the tie, block (bx, .) corner 3 == block (bx + 1, .) corner 0 along
    each axis, at every dense level with two blocks or more."""
    _, sp = _specs("six-levels")
    out = bh.tie_dense_seams(torch.from_numpy(_table(sp)), sp).numpy()
    checked = 0
    for li, lv in enumerate(sp.levels):
        nb = lv.blocks_axis
        if not lv.dense or nb < 2:
            continue
        off = li * sp.blocks_per_level
        t = out[off:off + nb**3].reshape(nb, nb, nb, 4, 4, 4, 2)
        np.testing.assert_array_equal(t[:-1, :, :, 3], t[1:, :, :, 0])
        np.testing.assert_array_equal(t[:, :-1, :, :, 3], t[:, 1:, :, :, 0])
        np.testing.assert_array_equal(t[:, :, :-1, :, :, 3], t[:, :, 1:, :, :, 0])
        checked += 1
    assert checked == 2


@pytest.mark.parametrize("name,n", [("dense-hashed", 256), ("six-levels", 256),
                                    ("dense-hashed", 8192), ("one-block", 64)],
                         ids=["dense-hashed", "six-levels", "collide", "one-block"])
def test_sync_hashed_seams_matches_jax(name, n):
    """The JAX projection with its draws rebuilt, bit for bit. At 8192
    samples per (level, axis) the sampled slots collide (more samples than
    seam corners, and hashed blocks share rows): the last write wins, hi
    copies before lo copies, as XLA's in-order scatter writes them."""
    sj, sp = _specs(name)
    tab = _table(sp)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(bhj.sync_hashed_seams(jnp.asarray(tab), sj, key, n_per_axis=n))
    draws = jax_seam_draws(sj, key, n, hashed_only=True)
    t = torch.from_numpy(tab.copy())
    assert bh.sync_hashed_seams(t, sp, n_per_axis=n, draws=draws) is t  # in place
    np.testing.assert_array_equal(t.numpy(), ref)
    if name == "one-block":
        assert not draws and np.array_equal(ref, tab)
        return
    assert not np.array_equal(ref, tab)
    if n == 8192:
        ia, ib = bh._seam_slots(sp, [next(iter(draws))], draws, "cpu")
        idx = torch.cat([ia, ib])
        assert idx.unique().numel() < 0.7 * idx.numel()  # over 30% of the writes collide


def test_sync_hashed_seams_draws_from_the_generator():
    """Without injected draws the samples come from the generator: the same
    seed syncs the same way; another seed another way; dense levels untouched."""
    _, sp = _specs("six-levels")
    tab = torch.from_numpy(_table(sp))
    a = bh.sync_hashed_seams(tab.clone(), sp, torch.Generator().manual_seed(3), 512)
    b = bh.sync_hashed_seams(tab.clone(), sp, torch.Generator().manual_seed(3), 512)
    c = bh.sync_hashed_seams(tab.clone(), sp, torch.Generator().manual_seed(4), 512)
    assert torch.equal(a, b) and not torch.equal(a, c)
    dense_rows = [li for li, lv in enumerate(sp.levels) if lv.dense]
    B = sp.blocks_per_level
    for li in dense_rows:
        assert torch.equal(a[li * B:(li + 1) * B], tab[li * B:(li + 1) * B])
    draws = bh.seam_draws(sp, 512, torch.Generator().manual_seed(3), hashed_only=True)
    assert set(draws) == {(li, ax) for li, lv in enumerate(sp.levels) if not lv.dense
                          for ax in range(3)}
    for (li, _), (m, other) in draws.items():
        n_seams, max_corner = bh.seam_extent(sp.levels[li])
        assert m.shape == (512,) and other.shape == (512, 3)
        assert 1 <= m.min() and m.max() <= n_seams and 0 <= other.min()
        assert other.max() <= max_corner


@pytest.mark.parametrize("name,n", [("dense-hashed", 512), ("six-levels", 512),
                                    ("dense-hashed", 8192)],
                         ids=["dense-hashed", "six-levels", "collide"])
def test_block_hash_seam_loss_matches_jax(name, n):
    """The loss at 1e-6 relative; its table gradient (colliding samples add)
    at 1e-6 of its largest entry, zero where JAX's is zero."""
    sj, sp = _specs(name)
    tab = _table(sp)
    key = jax.random.PRNGKey(9)
    loss_j, grad_j = jax.value_and_grad(
        lambda t: bhj.block_hash_seam_loss(t, sj, key, n_per_axis=n))(jnp.asarray(tab))
    t = torch.from_numpy(tab.copy()).requires_grad_()
    loss = bh.block_hash_seam_loss(t, sp, n_per_axis=n,
                                   draws=jax_seam_draws(sj, key, n, hashed_only=False))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-6)
    loss.backward()
    grad_j = np.asarray(grad_j)
    peak = np.abs(grad_j).max()
    assert peak > 0
    np.testing.assert_allclose(t.grad.numpy(), grad_j, rtol=0, atol=1e-6 * peak)
    assert ((t.grad.numpy() != 0) == (grad_j != 0)).all()


def test_block_hash_seam_loss_without_seams_is_zero():
    _, sp = _specs("one-block")
    t = torch.from_numpy(_table(sp)).requires_grad_()
    loss = bh.block_hash_seam_loss(t, sp, torch.Generator().manual_seed(0))
    assert loss.shape == () and float(loss) == 0.0


def test_block_hash_seam_loss_gradient_repeats_bit_for_bit():
    _, sp = _specs("six-levels")
    grads = []
    for _ in range(2):
        t = torch.from_numpy(_table(sp)).requires_grad_()
        bh.block_hash_seam_loss(t, sp, torch.Generator().manual_seed(2), 4096).backward()
        grads.append(t.grad)
    assert torch.equal(*grads)


SEAM_NET = dict(NET, log2_hashmap_size=16)  # the two coarse levels dense, two hashed


def _seam_field(**kw):
    module = FlaxNeRF(compute_dtype=jnp.float32, **{**SEAM_NET, "seam_tie": True, **kw})
    params = jax.tree.map(
        np.array, module.init(jax.random.PRNGKey(1), jnp.zeros((8, 3)), jnp.zeros((8, 3))))
    params["params"]["hash_table"] *= 1e4
    return module, params


def _port_net(params, **kw):
    net = NeRFNetwork(**{**SEAM_NET, "seam_tie": True, **kw})
    net.load_state_dict(params_from_jax(params))
    return net


def test_network_seam_tie_matches_jax():
    """`NeRFNetwork(seam_tie=True)` against the JAX module: the density and
    features at 1e-5, the table gradient at the block-hash tolerance (2e-5
    of its largest entry); both differ from the untied network's."""
    module, params = _seam_field()
    x = np.random.RandomState(3).uniform(-1, 1, (4096, 3)).astype(np.float32)
    net = _port_net(params)
    jp = jax.tree.map(jnp.asarray, params)

    def dens(p):
        sigma, geo = module.apply(p, jnp.asarray(x), method=module.density)
        return (sigma * jnp.arange(x.shape[0]) / x.shape[0]).sum() + geo.sum(), (sigma, geo)

    (_, (sigma_j, geo_j)), grads_j = jax.value_and_grad(dens, has_aux=True)(jp)
    sigma, geo = net.density(torch.from_numpy(x))
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(sigma_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(geo.detach().numpy(), np.asarray(geo_j), rtol=1e-5, atol=1e-6)
    ((sigma * torch.arange(x.shape[0]) / x.shape[0]).sum() + geo.sum()).backward()
    g_j = np.asarray(grads_j["params"]["hash_table"])
    peak = np.abs(g_j).max()
    np.testing.assert_allclose(net.hash_table.grad.numpy(), g_j, rtol=0, atol=2e-5 * peak)
    untied = _port_net(params, seam_tie=False)
    assert not torch.allclose(untied.density(torch.from_numpy(x))[0], sigma)


def _seam_key_draws(key, patch, n_seam, spec):
    """The JAX step with alpha_seam splits key -> (key, k_seam) first
    (train_step.py:230-233): the pixel and render draws of that split, and
    the seam samples of k_seam."""
    key, k_seam = jax.random.split(key)
    d = _draws(key, patch, False, H * W)
    d["seam"] = jax_seam_draws(spec, k_seam, n_seam, hashed_only=False)
    return d


@pytest.mark.parametrize("tie", [False, True], ids=["alpha_seam", "alpha_seam-tie"])
def test_train_step_with_alpha_seam_matches_jax(tie):
    """A step with alpha_seam = 100 (the round-4 sweep's value) against JAX
    `make_train_step`, with the seam samples and the other draws of its key:
    loss at 1e-5, gradients at test_torch_train's tolerances, the updated
    live parameters at 1e-6."""
    module, params = _seam_field(seam_tie=tie)
    patch = [2, 8]
    tcfg_j, tcfg, rcfg_j, rcfg = _configs(grad_loss=True, alpha_seam=100.0)
    poses, images = _scene()
    vi, vc = np.zeros((2, 1), np.int32), np.full((2,), H * W, np.int32)
    key = jax.random.PRNGKey(11)
    jp = jax.tree.map(jnp.asarray, params)
    loss_fn = tsj.make_loss_fn(module, tcfg_j, rcfg_j, patch)
    (loss_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jp, jnp.asarray(poses[1]), jnp.asarray(images[1].reshape(-1, 3)), jnp.asarray(vi[1]),
        jnp.asarray(vc[1]), key, None)
    step_j = tsj.make_train_step(module, tcfg_j, rcfg_j, patch_size=patch)
    new_j, _, m_j = step_j(jp, tsj.make_optimizer(tcfg_j).init(jp),
                           *map(jnp.asarray, (poses, images, vi, vc)), 1, key, 0)

    net = _port_net(params, seam_tie=tie)
    draws = _seam_key_draws(key, patch, tst.SEAM_SAMPLES, net.block_spec)
    # the seam term is a sizeable part of the loss
    seam = bh.block_hash_seam_loss(net.hash_table.detach(), net.block_spec, draws=draws["seam"])
    assert 100.0 * float(seam) > 0.01 * float(loss_j)
    step = tst.make_train_step(net, tcfg, rcfg, patch_size=patch, device="cpu")
    m = step(*map(torch.from_numpy, (poses, images, vi.astype(np.int64), vc.astype(np.int64))),
             1, draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(loss_j), rtol=1e-5)
    gj, gt = _flat(jax.tree.map(np.asarray, grads_j)), _port_grads(net)
    after_j, after = _flat(jax.tree.map(np.asarray, new_j)), _flat(params_to_jax(net.state_dict()))
    for name, ref in gj.items():
        peak = np.abs(ref).max()
        if name.startswith("params/color_net"):
            continue
        tol = 2e-3 if name.startswith("params/lidar_color_net/") else 2e-5
        np.testing.assert_allclose(gt[name], ref, rtol=0, atol=tol * peak, err_msg=name)
        live = np.abs(ref) > 1e-3 * peak
        np.testing.assert_allclose(after[name][live], after_j[name][live], rtol=0, atol=1e-6,
                                   err_msg=name)


def _sync_opt(n_sync):
    return SimpleNamespace(
        alpha_d=1e3, alpha_r=1.0, alpha_i=10.0, alpha_grad_norm=1.0, alpha_spatial=0.1,
        alpha_tv=1.0, alpha_grad=100.0, depth_loss="l1", depth_grad_loss="l1",
        intensity_loss="mse", raydrop_loss="mse", spatial_smooth=False, grad_norm_smooth=False,
        tv_loss=False, grad_loss=False, sobel_grad=False, scale=LOSS["scale"],
        num_rays_lidar=16, H_lidar=H, W_lidar=W, lr=1e-2, iters=30000, num_steps=8,
        upsample_steps=2, min_near_lidar=LOSS["scale"], min_near=LOSS["scale"], bound=1.0,
        patch_size_lidar=1, change_patch_size_lidar=[1, 1], change_patch_size_epoch=2, seed=0,
        seam_sync_hashed=n_sync, max_ray_batch=64, dataloader="kitti360")


class _Frames:
    """n frames of `_scene` for both trainers (the JAX one reads device_arrays())."""

    def __init__(self, n):
        self.poses_lidar, self.images_lidar = _scene(n)
        self.H_lidar, self.W_lidar, self.intrinsics_lidar = H, W, (2.0, 26.9)

    def __len__(self):
        return len(self.poses_lidar)

    def device_arrays(self, device=None):
        if device is None:
            return jnp.asarray(self.poses_lidar), jnp.asarray(self.images_lidar)
        return (torch.from_numpy(self.poses_lidar).to(device),
                torch.from_numpy(self.images_lidar).to(device))


def test_trainer_sync_schedule_matches_jax(monkeypatch):
    """--seam_sync_hashed: both trainers sync before the steps whose global
    step is a multiple of 16 (0, 16, 32 over 3 epochs of 12 frames), with
    the option's sample count; the port through the epoch's hook."""
    from lidarnerf_tpu.nerf.trainer import Trainer as TrainerJ
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    data = _Frames(12)
    calls_j = []
    tr_j = TrainerJ("s", _sync_opt(24), FlaxNeRF(**SEAM_NET), workspace=None, mute=True,
                    use_checkpoint="scratch", use_tensorboardX=False)
    monkeypatch.setattr(tr_j, "_seam_sync_fn", lambda n: (
        lambda table, key: (calls_j.append((tr_j.global_step, n)), table)[1]))
    for tr_j.epoch in (1, 2, 3):
        tr_j.train_one_epoch(data, 1)

    calls, steps = [], [0]
    make_step = tst.make_train_step

    def counting(*args, **kwargs):  # counts the steps the port's epochs run
        step = make_step(*args, **kwargs)

        def run(*a, **k):
            steps[0] += 1
            return step(*a, **k)

        run.optimizer = step.optimizer
        return run

    monkeypatch.setattr(tst, "make_train_step", counting)
    monkeypatch.setattr(tst, "sync_model_seams",
                        lambda model, n, generator, draws=None: calls.append((steps[0], n)))
    trainer = Trainer("s", _sync_opt(24), NeRFNetwork(**SEAM_NET), device="cpu", mute=True,
                      workspace=None)
    for trainer.epoch in (1, 2, 3):
        trainer.train_one_epoch(data, 1)
    assert calls_j == [(0, 24), (16, 24), (32, 24)]
    assert calls == calls_j
    assert trainer.global_step == tr_j.global_step == 36


def test_sync_epoch_equals_the_steps_with_the_sync_between():
    """The epoch with the sync in its hook equals its steps run one by one
    with `sync_model_seams` before steps 0 and 16, bit for bit (the eager
    form of the captured epoch, whose hook runs between replays), and two
    runs repeat bit for bit."""
    tcfg = tst.TrainConfig(**{**LOSS, "num_rays_lidar": 16})
    _, _, _, rcfg = _configs()
    rcfg = tst.RenderConfig(num_steps=8, upsample_steps=2, min_near_lidar=rcfg.min_near_lidar,
                            min_near=rcfg.min_near)
    poses, images = map(torch.from_numpy, _scene(4))
    vi, vc = torch.zeros((4, 1), dtype=torch.long), torch.full((4,), H * W)
    order = np.arange(20) % 4
    net0 = NeRFNetwork(**SEAM_NET, generator=torch.Generator().manual_seed(0))
    runs = []
    for how in ("epoch", "epoch", "steps"):
        net = copy.deepcopy(net0)
        gen = torch.Generator().manual_seed(5)
        if how == "epoch":
            fn = tst.make_epoch_step(net, tcfg, rcfg, device="cpu", seam_sync=64)
            loss = fn(poses, images, vi, vc, order, step0=0, generator=gen)["loss"]
        else:
            step = tst.make_train_step(net, tcfg, rcfg, device="cpu")
            loss = []
            for i, f in enumerate(order):
                if i % tst.SEAM_SYNC_EVERY == 0:
                    tst.sync_model_seams(net, 64, gen)
                loss.append(step(poses, images, vi, vc, int(f), generator=gen)["loss"])
            loss = torch.stack(loss)
        runs.append((loss, net.hash_table.detach().clone()))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)
    plain = copy.deepcopy(net0)
    fn = tst.make_epoch_step(plain, tcfg, rcfg, device="cpu")
    fn(poses, images, vi, vc, order, generator=torch.Generator().manual_seed(5))
    assert not torch.equal(plain.hash_table, runs[0][1])  # the sync changed the run


def test_pano_with_seam_tie_matches_jax():
    """A pano served by PanoRenderer from a --seam_tie field equals the JAX
    package's staged render of the tied module (the render tolerance of
    tests/test_torch_render.py), and differs from the untied render."""
    from lidarnerf_tpu.dataset.base import get_lidar_rays as get_lidar_rays_j
    from lidarnerf_tpu.models.renderer import RenderConfig as RenderConfigJ
    from lidarnerf_tpu.models.renderer import render_rays_staged as render_staged_j

    module, params = _seam_field(num_levels=16)  # PanoRenderer builds the CLI's 16 levels
    opt = SimpleNamespace(encoding="blockhash", desired_resolution=SEAM_NET["desired_resolution"],
                          log2_hashmap_size=SEAM_NET["log2_hashmap_size"], num_layers=2,
                          hidden_dim=SEAM_NET["hidden_dim"], geo_feat_dim=15, bound=1.0,
                          scale=LOSS["scale"], num_steps=T, upsample_steps=S, max_ray_batch=128,
                          fp16=False, alpha_r=1.0, seam_tie=1)
    pose = _scene(1)[0][0]
    intr = (2.0, 26.9)
    cfg_j = RenderConfigJ(num_steps=T, upsample_steps=S, min_near_lidar=opt.scale,
                          min_near=opt.scale, bound=1.0)
    rays = get_lidar_rays_j(jnp.asarray(pose[None]), intr, H, W, N=-1)
    o = render_staged_j(module, jax.tree.map(jnp.asarray, params), rays["rays_o"][0],
                        rays["rays_d"][0], cfg_j, chunk=opt.max_ray_batch)
    renderer = PanoRenderer(opt, params, device="cpu")
    assert renderer.network.seam_tie
    raydrop, intensity, depth = renderer.render_frame(pose, H, W, intr)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(depth, np.asarray(o["depth"]).reshape(H, W), **tol)
    np.testing.assert_allclose(raydrop, np.asarray(o["image"])[:, 0].reshape(H, W), **tol)
    np.testing.assert_allclose(intensity, np.asarray(o["image"])[:, 1].reshape(H, W), **tol)
    opt.seam_tie = 0
    assert not np.allclose(PanoRenderer(opt, params, device="cpu").render_frame(
        pose, H, W, intr)[2], depth)
