"""The port's own random draws against the JAX package's draws of the same
role, by distribution (ROADMAP.md C10, suspect (a)).

The parity tests hand the port the JAX package's numbers (`draws=`); these
tests let each package draw its own, at fixed seeds and large counts, and
hold what the port draws to the law the JAX package draws from: pixel
indices over the pano and over a frame's valid pool (with and without
replacement), patch corners, the stratified jitter `noise`, the inverse-CDF
`u`, the `--fast` sampler's depths, the occupancy refresh's jitter and the
trainer's frame order per epoch. They also hold that consecutive steps and
epochs draw afresh, and that the `--fast` refresh lands on the global steps
that are multiples of the update interval, across epochs and a resume.

Bounds: a one-sample Kolmogorov-Smirnov statistic against the uniform law
below 1.95 / sqrt(n), a two-sample one between the packages below
1.95 sqrt(2 / n) (both the 0.1% critical values), and every value of a
discrete range drawn. On the CUDA card the captured epoch's replays draw
afresh too (`tools/torch_c10_bisect.py --measure`, chip_smoke.py's drift
phase).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import main_lidarnerf as cli_j  # noqa: E402
from lidarnerf_tpu.dataset.base import sample_ray_indices as sample_ray_indices_j  # noqa: E402
from lidarnerf_tpu.models import occupancy as occ_j  # noqa: E402
from lidarnerf_tpu.nerf.trainer import Trainer as TrainerJ  # noqa: E402
from lidarnerf_tpu_torch import main_lidarnerf as cli  # noqa: E402
from lidarnerf_tpu_torch.dataset.base import sample_ray_indices  # noqa: E402
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset  # noqa: E402
from lidarnerf_tpu_torch.models import occupancy as occ_t  # noqa: E402
from lidarnerf_tpu_torch.models.renderer import RenderConfig  # noqa: E402
from lidarnerf_tpu_torch.nerf import train_step  # noqa: E402
from lidarnerf_tpu_torch.nerf.trainer import Trainer  # noqa: E402
from lidarnerf_tpu_torch.ops.occ_sample import occ_sample  # noqa: E402
from test_e2e import write_synthetic_kitti  # noqa: E402
from test_torch_occupancy import shell_grid  # noqa: E402
from test_torch_workspace import SCALE, TINY_ARGV, _one_thread  # noqa: E402,F401

KS = 1.95  # the Kolmogorov-Smirnov statistic's 0.1% critical value, times sqrt(n)
H, W = 16, 64


def ks_uniform(u):
    """One-sample KS statistic of values in [0, 1) against U(0, 1)."""
    u = np.sort(np.asarray(u, np.float64).ravel())
    n = u.size
    i = np.arange(1, n + 1)
    return max(np.max(i / n - u), np.max(u - (i - 1) / n))


def ks_discrete(x, n_values):
    """KS statistic of integers in [0, n_values) against the discrete uniform law."""
    x = np.asarray(x).ravel()
    ecdf = np.cumsum(np.bincount(x, minlength=n_values)) / x.size
    return np.max(np.abs(ecdf - np.arange(1, n_values + 1) / n_values))


def ks_two(a, b):
    """Two-sample KS statistic."""
    a, b = np.sort(np.ravel(a)), np.sort(np.ravel(b))
    grid = np.concatenate([a, b])
    return np.max(np.abs(np.searchsorted(a, grid, "right") / a.size
                         - np.searchsorted(b, grid, "right") / b.size))


def assert_uniform_ints(x, n_values):
    x = np.asarray(x).ravel()
    assert x.min() >= 0 and x.max() < n_values
    assert np.all(np.bincount(x, minlength=n_values) > 0), "a value of the range is never drawn"
    assert ks_discrete(x, n_values) < KS / np.sqrt(x.size)


def jax_keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def test_dense_pixels_cover_the_pano_uniformly():
    """Patch 1: N independent pixels a step, uniform over all H * W, as
    `jax.random.randint(key, (N,), 0, H * W)`."""
    steps, N = 200, 1024
    gen = torch.Generator().manual_seed(0)
    port = np.stack([sample_ray_indices(H, W, N, 1, gen).numpy() for _ in range(steps)])
    ref = np.stack([np.asarray(sample_ray_indices_j(k, H, W, N, 1)) for k in jax_keys(steps)])
    for x in (port, ref):
        assert_uniform_ints(x, H * W)
    assert ks_two(port, ref) < KS * np.sqrt(2.0 / port.size)


def test_patch_corners_follow_the_jax_law():
    """Patch [2, 8]: N // 16 top-left corners a step, rows uniform over [0, H - 2),
    columns over [0, W - 8) (randint's exclusive top, in both packages), each
    expanded row offset slowest."""
    steps, N, (px, py) = 2000, 128, (2, 8)
    gen = torch.Generator().manual_seed(1)
    port = np.stack([sample_ray_indices(H, W, N, [px, py], gen).numpy() for _ in range(steps)])
    ref = np.stack([np.asarray(sample_ray_indices_j(k, H, W, N, (px, py)))
                    for k in jax_keys(steps, 1)])
    for x in (port, ref):
        patches = x.reshape(steps, -1, px * py)
        rows, cols = patches[..., 0] // W, patches[..., 0] % W
        assert_uniform_ints(rows, H - px)
        assert_uniform_ints(cols, W - py)
        offs = (np.arange(px)[:, None] * W + np.arange(py)[None, :]).ravel()
        assert np.array_equal(patches - patches[..., :1], np.broadcast_to(offs, patches.shape))
    assert ks_two(port[:, ::16] // W, ref[:, ::16] // W) < KS * np.sqrt(2.0 / (port.size / 16))


def test_masked_pool_draws_with_replacement():
    """NeRF-MVL: positions uniform over the frame's valid prefix of the pool,
    never on its padding, as `jax.random.randint(key, (N,), 0, valid_count)`."""
    steps, N, pool, valid = 200, 1024, 1000, 700
    cfg = train_step.TrainConfig(num_rays_lidar=N, H_lidar=H, W_lidar=W)
    valid_idx = torch.arange(pool) * 3  # any pixel ids; the padding's would be > 3 * valid
    vc = torch.tensor(valid)
    gen = torch.Generator().manual_seed(2)
    port = np.stack([train_step.sample_pixels(cfg, 1, True, False, valid_idx, vc, gen).numpy()
                     for _ in range(steps)]) // 3
    ref = np.stack([np.asarray(jax.random.randint(k, (N,), 0, valid)) for k in jax_keys(steps, 2)])
    for x in (port, ref):
        assert_uniform_ints(x, valid)
    assert ks_two(port, ref) < KS * np.sqrt(2.0 / port.size)


@pytest.mark.parametrize("valid", [500, 100], ids=["pool", "fewer-than-N"])
def test_masked_pool_draws_without_replacement(valid):
    """The Gumbel top-k draw: N distinct valid slots a step, each slot kept
    with probability N / valid, as the JAX loss closure's `jax.random.gumbel`
    + `top_k`; with fewer valid slots than N, every one of them once and the
    rest with replacement over the valid prefix."""
    steps, N, pool = 400, 128, 600
    cfg = train_step.TrainConfig(num_rays_lidar=N, H_lidar=H, W_lidar=W)
    gen = torch.Generator().manual_seed(3)
    port = np.stack([train_step.sample_pixels(cfg, 1, True, True, torch.arange(pool),
                                              torch.tensor(valid), gen).numpy()
                     for _ in range(steps)])

    def jax_draw(k):
        g = jnp.where(jnp.arange(pool) < valid, jax.random.gumbel(k, (pool,)), -jnp.inf)
        top = jax.lax.top_k(g, N)[1]
        return np.asarray(jnp.where(top < valid, top, top % valid))

    ref = np.stack([jax_draw(k) for k in jax_keys(steps, 3)])
    for x in (port, ref):
        assert x.min() >= 0 and x.max() < valid
        if valid >= N:
            assert all(len(set(row)) == N for row in x)
            p = N / valid
            freq = np.bincount(x.ravel(), minlength=valid) / steps
            assert np.max(np.abs(freq - p)) < 5.0 * np.sqrt(p * (1 - p) / steps)
        else:
            assert all(set(row) == set(range(valid)) for row in x)
    if valid >= N:
        assert ks_two(port, ref) < KS * np.sqrt(2.0 / port.size)


def test_render_jitter_and_inverse_cdf_u_are_uniform():
    """The training render's `noise` [N, num_steps] and `u` [N, upsample_steps]:
    U(0, 1) in every column, as `jax.random.uniform`, and fresh at every call."""
    rcfg = RenderConfig(num_steps=48, upsample_steps=8)
    gen = torch.Generator().manual_seed(4)
    N = 4096
    noise, u = train_step.render_draws(rcfg, N, gen, "cpu")
    noise2, u2 = train_step.render_draws(rcfg, N, gen, "cpu")
    assert noise.shape == (N, 48) and u.shape == (N, 8)
    assert not torch.equal(noise, noise2) and not torch.equal(u, u2)
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (N, 48), dtype=jnp.float32))
    for x in (noise.numpy(), u.numpy(), ref):
        assert x.min() >= 0.0 and x.max() < 1.0
        assert ks_uniform(x) < KS / np.sqrt(x.size)
        for col in (0, x.shape[1] // 2, x.shape[1] - 1):
            assert ks_uniform(x[:, col]) < KS / np.sqrt(N)
    assert ks_two(noise.numpy(), ref) < KS * np.sqrt(2.0 / ref.size)


def _fast_rays(n):
    rng = np.random.RandomState(5)
    o = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nears = np.full((n, 1), 0.02, np.float32)
    fars = np.full((n, 1), 1.6, np.float32)
    return o, d, nears, fars


def test_fast_sampler_depths_follow_the_jax_law():
    """`--fast`: the sampler's own stratified draws give depths with the JAX
    sampler's law on each stratum (occ_z_vals with its key), through both
    the composed reference and the fused sampler's plain version, sorted and
    inside [near, far]."""
    G, K, T, n = 16, 32, 24, 2048
    cfg_t, cfg_j = occ_t.OccConfig(grid_size=G, bins=K), occ_j.OccConfig(grid_size=G, bins=K)
    grid = shell_grid(G)
    o, d, nears, fars = _fast_rays(n)
    t = [torch.from_numpy(a) for a in (o, d, nears, fars)]
    pdf_t = occ_t.occ_bin_pdf(torch.from_numpy(grid), *t, cfg_t, 1.0)
    pdf_j = occ_j.occ_bin_pdf(jnp.asarray(grid), o, d, nears, fars, cfg_j, 1.0)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-5, atol=1e-7)
    gen = torch.Generator().manual_seed(6)
    z_ref = occ_t.occ_z_vals(t[2], t[3], pdf_t, T, True, generator=gen).numpy()
    occ3 = occ_t.occupied_volume(torch.from_numpy(grid), cfg_t)
    z_fused = occ_sample(occ3, *t, cfg_t, 1.0, T, True, generator=gen).numpy()
    z_jax = np.asarray(occ_j.occ_z_vals(jax.random.PRNGKey(6), nears, fars, pdf_j, T, True))
    assert not np.array_equal(z_ref, z_fused)  # two calls, two draws
    for z in (z_ref, z_fused, z_jax):
        assert np.all(np.diff(z, axis=1) >= 0.0)
        assert z.min() >= nears.min() and z.max() <= fars.max()
    for j in (0, T // 3, T - 1):
        for z in (z_ref, z_fused):
            assert ks_two(z[:, j], z_jax[:, j]) < KS * np.sqrt(2.0 / n)


class _Recorder(torch.nn.Module):
    """A field whose density records its query points."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def density(self, x):
        self.seen.append(x.clone())
        return torch.zeros(x.shape[:-1]), None


def test_grid_refresh_jitter_is_uniform_and_fresh():
    """The refresh's one point a cell: the cell's corner plus U(0, 1)^3 of a
    cell, as `jax.random.uniform(key, (G, G, G, 3))`, and two refreshes from
    one generator draw two jitters."""
    G, bound = 16, 1.0
    cfg = occ_t.OccConfig(grid_size=G)
    net, gen = _Recorder(), torch.Generator().manual_seed(7)
    grid = occ_t.init_occ_grid(cfg)
    for _ in range(2):
        occ_t.update_occ_grid(net, grid, cfg, bound, generator=gen)
    idx = np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1).reshape(-1, 3)
    jit = [(x.numpy() + bound) / (2 * bound / G) - idx for x in net.seen]
    assert not np.array_equal(jit[0], jit[1])
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (G, G, G, 3))).reshape(-1, 3)
    for j in jit:
        assert j.min() > -1e-4 and j.max() < 1.0 + 1e-4  # the affine map's float rounding
        for axis in range(3):
            assert ks_uniform(np.clip(j[:, axis], 0.0, 1.0 - 1e-7)) < KS / np.sqrt(G ** 3)
            assert ks_two(j[:, axis], ref[:, axis]) < KS * np.sqrt(2.0 / G ** 3)


# ------------------------------------------------------------ the trainers

N_TRAIN = 8


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    write_synthetic_kitti(root, n_train=N_TRAIN, n_val=1, n_test=1)
    return root


def _opt(data, *extra):
    opt = cli.get_arg_parser().parse_args(TINY_ARGV + ["--path", data, *extra])
    opt.enable_lidar = True
    cli.apply_macros(opt)
    opt.H_lidar, opt.W_lidar, opt.intrinsics_lidar = H, W, (2.0, 26.9)
    return opt


def _dataset(data):
    return KITTI360Dataset(split="train", root_path=data, scale=SCALE, offset=[0, 0, 0],
                           num_rays_lidar=128)


def test_frame_order_per_epoch_is_the_jax_trainers(data, tmp_path):
    """Each epoch visits every frame once, in the JAX trainer's order for the
    same seed (both draw `np.random.RandomState(seed).permutation` an epoch),
    and no two of the first epochs repeat an order."""
    epochs, seen_t, seen_j = 5, [], []
    opt = _opt(data, "--seed", "3")
    port = Trainer("lidar_nerf", opt, cli.build_model(opt), device="cpu", mute=True,
                   workspace=None, ema_decay=None)

    def stub_t(*a, **k):
        order = a[4]
        seen_t.append(np.asarray(order).copy())
        z = torch.zeros(len(order))
        return {m: z for m in train_step.METRICS}

    port._get_epoch_fn = lambda *a: stub_t
    port.train(_dataset(data), None, epochs)

    opt_j = cli_j.get_arg_parser().parse_args(TINY_ARGV + ["--path", data, "--seed", "3"])
    opt_j.enable_lidar = True
    opt_j.min_near = opt_j.min_near_lidar = opt_j.scale
    opt_j.H_lidar, opt_j.W_lidar, opt_j.intrinsics_lidar = H, W, (2.0, 26.9)
    jaxt = TrainerJ("lidar_nerf", opt_j, cli_j.build_model(opt_j), mute=True,
                    workspace=str(tmp_path), ema_decay=None, use_checkpoint="scratch",
                    eval_interval=10 ** 6)

    def stub_j(params, opt_state, occ, poses, images, vi, vc, order, *rest):
        seen_j.append(np.asarray(order).copy())
        z = jnp.zeros(order.shape[0])
        return params, opt_state, occ, {"loss": z, "depth_mae": z, "raydrop_err": z,
                                        "skipped_nonfinite": z}

    jaxt._get_epoch_fn = lambda *a: stub_j
    from lidarnerf_tpu.dataset.kitti360 import KITTI360Dataset as KITTI360DatasetJ

    jaxt.train(KITTI360DatasetJ(split="train", root_path=data, scale=SCALE, offset=[0, 0, 0],
                                num_rays_lidar=128), None, epochs)
    assert len(seen_t) == len(seen_j) == epochs
    for a, b in zip(seen_t, seen_j):
        assert np.array_equal(np.sort(a), np.arange(N_TRAIN))
        assert np.array_equal(a, b)
    assert len({tuple(a) for a in seen_t}) == epochs


def _recording_run(data, workspace, epochs, interval, use_checkpoint="scratch"):
    """A `--fast` CPU trainer with recorders on the step's draws and on the
    grid refresh; returns (trainer, pixel rows, noise rows, u rows, the step
    index of each refresh)."""
    opt = _opt(data, "--fast", "--occ_grid_size", "8", "--occ_bins", "16",
               "--occ_update_interval", str(interval))
    rec = {"inds": [], "noise": [], "u": [], "refresh": []}
    trainer = Trainer("lidar_nerf", opt, cli.build_model(opt), device="cpu", mute=True,
                      workspace=str(workspace), ema_decay=0.95, use_checkpoint=use_checkpoint)
    step0 = trainer.global_step
    pixels, draws, refresh = train_step.sample_pixels, train_step.render_draws, \
        train_step.update_occ_grid

    def rec_pixels(*a, **k):
        inds = pixels(*a, **k)
        rec["inds"].append(inds.clone())
        return inds

    def rec_draws(*a, **k):
        noise, u = draws(*a, **k)
        rec["noise"].append(noise.clone())
        rec["u"].append(u.clone())
        return noise, u

    def rec_refresh(*a, **k):
        rec["refresh"].append(step0 + len(rec["inds"]))
        return refresh(*a, **k)

    train_step.sample_pixels, train_step.render_draws = rec_pixels, rec_draws
    train_step.update_occ_grid = rec_refresh
    try:
        trainer.train(_dataset(data), None, epochs)
    finally:
        train_step.sample_pixels, train_step.render_draws = pixels, draws
        train_step.update_occ_grid = refresh
    return trainer, rec


def _rows_distinct(rows):
    flat = [r.numpy().tobytes() for r in rows]
    return len(set(flat)) == len(flat)


def test_steps_and_epochs_draw_afresh_and_refresh_on_schedule(data, tmp_path):
    """Over three epochs of the CPU trainer (patch 1 and [2, 8] alternating)
    no step repeats another's pixels, jitter or u; the `--fast` refresh runs
    before exactly the global steps that are multiples of its interval
    (5: inside epochs, as the JAX epoch's `step % update_interval`); a run
    resumed from epoch 2 draws epoch 3 as the uninterrupted run does, and
    refreshes on the same steps."""
    interval, epochs = 5, 3
    full, rec = _recording_run(data, tmp_path / "full", epochs, interval)
    steps = epochs * N_TRAIN
    assert len(rec["inds"]) == steps
    for kind in ("inds", "noise", "u"):
        assert _rows_distinct(rec[kind]), kind
    assert rec["refresh"] == [s for s in range(steps) if s % interval == 0]

    _, first = _recording_run(data, tmp_path / "resume", 2, interval)
    resumed, rec2 = _recording_run(data, tmp_path / "resume", epochs, interval,
                                   use_checkpoint="latest")
    assert resumed.global_step == steps
    for kind in ("inds", "noise", "u"):
        for a, b in zip(rec2[kind], rec[kind][2 * N_TRAIN:]):
            assert torch.equal(a, b), kind
    assert rec2["refresh"] == [s for s in range(2 * N_TRAIN, steps) if s % interval == 0]
    assert torch.equal(resumed.occ_grid, full.occ_grid)
