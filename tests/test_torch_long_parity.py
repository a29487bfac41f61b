"""Multi-epoch parity of the training loop: the port's `Trainer` against the
JAX package's `Trainer` over three `--fast` epochs of 16 steps each.

One epoch of tests/test_torch_epoch.py is 4 steps: less than one refresh
interval of the real `--fast` schedule (16 steps) and less than one cycle of
the patch-size schedule. Here both trainers run the CLI's `--fast` options on
the config's [2, 8] patch every second epoch, with the real refresh interval:
48 steps cross three grid refreshes (global steps 0, 16, 32), a patch-size
change and back, the per-epoch EMA and a learning rate that decays tenfold
over the run (`--iters 48`). The widths are tests/test_torch_train.py's (a
one-block-per-level table of 4 levels, hidden 32, float32, 64 + 8 samples,
64 rays on an 8 x 64 pano, a 16^3 grid of 32 bins) on 16 frames of its
scene, so that one epoch is one refresh interval.

Each trainer runs its own loop (`train`: the frame order, the keys, the patch
schedule, the refresh, the EMA, the lr); its epoch function is called one step
at a time, so that every step's state can be read; a split JAX epoch equals
the unsplit one bit for bit. The port's steps take the JAX trainer's draws,
derived from the keys each JAX epoch handed its epoch function, as
tests/test_torch_epoch.py's `_epoch_draws` derives them.

The yardstick. The LiDAR head's state drifts apart from the second step on
(tests/test_torch_epoch.py): the degree-12 frequency encoding of the ray
direction reads the two libms' last ulps in the directions, and Adam turns
the gradient differences into moves of the learning rate's size on elements
whose gradients lie near zero. So the port's distance to the JAX run is held
against the JAX package's own sensitivity, two more JAX runs with everything
equal but a start one ulp away (`np.nextafter` on every entry): of the hash
table, and of the frames' poses (hence the ray directions). At every step,
for every parameter group and for the loss, the port-to-JAX distance must
stay within MULTIPLE times the larger JAX-to-JAX distance, plus a floor
(FLOOR for a group's L2 distance, LOSS_RTOL of the loss). Measured: the port
keeps within 1.2 times the pose run's distance in both MLPs from the second
step on and within 0.1 times the table run's in the table; the first step's
distances (at most 8.4e-7) are below the floor. A fault that grows over the
epochs, which no one-epoch test sees, leaves that band. The refreshed grids
occupy the same cells, and the EMA after every epoch is held like the
parameters.
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
from lidarnerf_tpu.nerf.trainer import Trainer as TrainerJ  # noqa: E402
from lidarnerf_tpu_torch import main_lidarnerf as cli  # noqa: E402
from lidarnerf_tpu_torch.models.network import NeRFNetwork  # noqa: E402
from lidarnerf_tpu_torch.models.occupancy import occ_config_from_opt, occupied_volume  # noqa: E402
from lidarnerf_tpu_torch.nerf.trainer import Trainer  # noqa: E402
from lidarnerf_tpu_torch.utils.params import params_from_jax, params_to_jax  # noqa: E402
from test_torch_train import (  # noqa: E402
    NET,
    OCC,
    SCALE,
    SEAMLESS,
    H,
    N,
    S,
    T,
    W,
    _draws,
    _flat,
    _make_field,
)
from test_torch_workspace import _one_thread  # noqa: E402, F401 (autouse)

FRAMES = 16  # one epoch = one refresh interval
EPOCHS = 3
STEPS = FRAMES * EPOCHS
INTERVAL = 16  # the real --occ_update_interval
ARGV = ["--config", "configs/kitti360_1908.txt", "--fast", "--num_steps", str(T),
        "--upsample_steps", str(S), "--num_rays_lidar", str(N),
        "--occ_grid_size", str(OCC["grid_size"]), "--occ_bins", str(OCC["bins"]),
        "--occ_update_interval", str(INTERVAL), "--iters", str(STEPS), "--scale", str(SCALE),
        "--offset", "0", "0", "0", "--path", "unused"]
GROUPS = ("hash_table", "sigma_net", "lidar_color_net")

MULTIPLE = 4.0  # measured at most 1.2 (the LiDAR head, steps 19-41)
FLOOR = 1e-5  # L2 over a group; the first step's measured distances are <= 8.4e-7
LOSS_RTOL = 1e-5  # tests/test_torch_epoch.py's; measured at most 3.0e-6


def _scene():
    """FRAMES frames of tests/test_torch_train.py's `_scene`: poses turning
    by 0.4 rad near the origin, depth constant over runs of 4 columns."""
    rs = np.random.RandomState(0)
    poses, images = [], []
    for k in range(FRAMES):
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


class _Frames:
    """A dense LiDAR dataset as both trainers read it (`device_arrays`)."""

    def __init__(self, poses, images):
        self.poses, self.images = poses, images

    def __len__(self):
        return len(self.poses)

    def device_arrays(self, device=None):
        if device is None:  # the JAX trainer's call
            return jnp.asarray(self.poses), jnp.asarray(self.images)
        return torch.from_numpy(self.poses).to(device), torch.from_numpy(self.images).to(device)


def _options(parser):
    """The CLI's options after main()'s own settings, at the tiny widths."""
    opt = parser.parse_args(ARGV)
    opt.enable_lidar = True
    opt.occ_sampling, opt.num_steps = True, min(opt.num_steps, 192)  # the --fast macro
    opt.min_near = opt.min_near_lidar = opt.scale
    opt.H_lidar, opt.W_lidar, opt.intrinsics_lidar = H, W, (2.0, 26.9)
    return opt


def _record():
    return {"params": [], "loss": [], "grid": [], "ema": [], "epochs": []}


def _jax_run(module, params, data, split=True, compiled=None):
    """The JAX trainer for EPOCHS epochs from `params`; with `split`, its epoch
    function is called one step at a time and every step's state recorded.
    `compiled` shares another run's jitted epoch functions."""
    trainer = TrainerJ("lidar_nerf", _options(cli_j.get_arg_parser()), module, mute=True,
                       workspace=None, ema_decay=0.95, eval_interval=10**6,
                       use_tensorboardX=False)
    trainer.params = jax.tree.map(jnp.asarray, params)
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer.ema_params = jax.tree.map(jnp.copy, trainer.params)
    if compiled is not None:
        trainer._step_fns = compiled
    rec = _record()
    get_epoch_fn = trainer._get_epoch_fn

    def stepwise(patch, masked):
        fn = get_epoch_fn(patch, masked)

        def epoch_fn(p, s, occ, poses, images, vi, vc, order, step_keys, occ_keys, step0):
            rec["epochs"].append({"order": np.array(order), "step_keys": np.array(step_keys),
                                  "occ_keys": np.array(occ_keys), "step0": int(step0),
                                  "patch": patch})
            ms = []
            for i in range(len(order)):
                p, s, occ, m = fn(p, s, occ, poses, images, vi, vc, order[i:i + 1],
                                  step_keys[i:i + 1], occ_keys[i:i + 1], step0 + i)
                rec["params"].append(_flat(jax.tree.map(np.array, p)))
                rec["loss"].append(float(m["loss"][0]))
                rec["grid"].append(np.array(occ))
                ms.append(m)
            return p, s, occ, {k: jnp.concatenate([m[k] for m in ms]) for k in ms[0]}

        return epoch_fn

    if split:
        trainer._get_epoch_fn = stepwise
    for epoch in range(1, EPOCHS + 1):
        trainer.train(data, None, epoch)
        rec["ema"].append(_flat(jax.tree.map(np.array, trainer.ema_params)))
    rec["final"] = _flat(jax.tree.map(np.array, trainer.params))
    rec["epoch_loss"] = list(trainer.stats["loss"])
    return trainer, rec


def _port_state(state):
    return {k: np.array(v) for k, v in _flat(params_to_jax(
        {n: t.detach().clone() for n, t in state.items()})).items()}


def _port_run(params, data, jax_epochs):
    """The port's trainer for EPOCHS epochs from `params`, one step at a time,
    each step on the draws of the JAX epoch's keys."""
    net = NeRFNetwork(**{**NET, **SEAMLESS})
    net.load_state_dict(params_from_jax(params))
    trainer = Trainer("lidar_nerf", _options(cli.get_arg_parser()), net, device="cpu",
                      mute=True, workspace=None, ema_decay=0.95, eval_interval=10**6,
                      use_tensorboardX=False)
    rec = _record()
    get_epoch_fn = trainer._get_epoch_fn
    G = OCC["grid_size"]

    def stepwise(patch, masked):
        fn = get_epoch_fn(patch, masked)

        def epoch_fn(poses, images, vi, vc, order, step0=0, generator=None, occ_grid=None,
                     draws=None):
            keys = jax_epochs[len(rec["epochs"])]
            rec["epochs"].append({"order": np.array(order), "step0": int(step0),
                                  "patch": patch})
            ms = []
            for i in range(len(order)):
                d = _draws(jnp.asarray(keys["step_keys"][i]), patch, False, H * W)
                if (step0 + i) % INTERVAL == 0:  # occupancy.py:74, the refresh's jitter
                    d["occ_jitter"] = torch.from_numpy(np.array(jax.random.uniform(
                        jnp.asarray(keys["occ_keys"][i]), (G,) * 3 + (3,), dtype=jnp.float32)))
                m = fn(poses, images, vi, vc, order[i:i + 1], step0 + i, generator=generator,
                       occ_grid=occ_grid, draws=[d])
                rec["params"].append(_port_state(trainer.model.state_dict()))
                rec["loss"].append(float(m["loss"][0]))
                rec["grid"].append(occ_grid.numpy().copy())
                ms.append(m)
            return {k: torch.cat([m[k] for m in ms]) for k in ms[0]}

        return epoch_fn

    trainer._get_epoch_fn = stepwise
    for epoch in range(1, EPOCHS + 1):
        trainer.train(data, None, epoch)
        rec["ema"].append(_port_state(trainer.ema_params))
    rec["epoch_loss"] = list(trainer.stats["loss"])
    return trainer, rec


@pytest.fixture(scope="module")
def runs():
    """{"jax", "jax_table", "jax_pose", "jax_whole", "port"}: the records of
    the JAX run, its two one-ulp runs, the JAX run with whole epochs, and
    the port's run."""
    module, params = _make_field(**SEAMLESS)
    poses, images = _scene()
    data = _Frames(poses, images)
    tj, base = _jax_run(module, params, data)
    nudged = jax.tree.map(np.array, params)
    nudged["params"]["hash_table"] = np.nextafter(nudged["params"]["hash_table"],
                                                  np.float32(np.inf))
    _, table = _jax_run(module, nudged, data, compiled=tj._step_fns)
    _, pose = _jax_run(module, params, _Frames(np.nextafter(poses, np.float32(np.inf)), images),
                       compiled=tj._step_fns)
    _, whole = _jax_run(module, params, data, split=False)
    _, port = _port_run(params, data, base["epochs"])
    return {"jax": base, "jax_table": table, "jax_pose": pose, "jax_whole": whole, "port": port}


def _dist(a, b, group):
    return float(np.sqrt(sum(((a[n].astype(np.float64) - b[n]) ** 2).sum()
                             for n in a if n.split("/")[1] == group)))


def test_both_loops_take_the_same_schedule(runs):
    """The frame orders, the epochs' first global steps and patch sizes agree;
    the JAX run split into steps equals its whole epochs bit for bit."""
    jax_run, port = runs["jax"], runs["port"]
    assert len(port["loss"]) == len(jax_run["loss"]) == STEPS
    for ej, ep in zip(jax_run["epochs"], port["epochs"], strict=True):
        np.testing.assert_array_equal(ep["order"], ej["order"])
        assert ep["step0"] == ej["step0"]
        assert list(np.atleast_1d(ep["patch"])) == list(np.atleast_1d(ej["patch"]))
    assert [list(np.atleast_1d(e["patch"])) for e in port["epochs"]] == [[1], [2, 8], [1]]
    whole = runs["jax_whole"]
    assert whole["epoch_loss"] == jax_run["epoch_loss"]
    for name, value in whole["final"].items():
        np.testing.assert_array_equal(jax_run["final"][name], value, err_msg=name)
    np.testing.assert_allclose(port["epoch_loss"], jax_run["epoch_loss"], rtol=LOSS_RTOL)


def test_loss_stays_within_the_jax_sensitivity(runs):
    """Every step's loss: |port - JAX| <= MULTIPLE x the larger one-ulp
    JAX-to-JAX difference + LOSS_RTOL x |loss|."""
    ref = np.asarray(runs["jax"]["loss"])
    port = np.abs(np.asarray(runs["port"]["loss"]) - ref)
    yard = np.maximum(*(np.abs(np.asarray(runs[k]["loss"]) - ref)
                        for k in ("jax_table", "jax_pose")))
    bad = np.flatnonzero(port > MULTIPLE * yard + LOSS_RTOL * np.abs(ref))
    assert not bad.size, (bad, port[bad], yard[bad], ref[bad])


@pytest.mark.parametrize("group", GROUPS)
def test_parameters_stay_within_the_jax_sensitivity(runs, group):
    """After every step, a parameter group's L2 distance from the JAX run:
    port <= MULTIPLE x max(table one-ulp, pose one-ulp) + FLOOR."""
    ref = runs["jax"]["params"]
    for step in range(STEPS):
        port = _dist(runs["port"]["params"][step], ref[step], group)
        yard = max(_dist(runs[k]["params"][step], ref[step], group)
                   for k in ("jax_table", "jax_pose"))
        assert port <= MULTIPLE * yard + FLOOR, (step, port, yard)


def test_rgb_head_never_moves(runs):
    """The RGB head has no gradient in LiDAR mode: bit-equal on both sides."""
    ref = runs["jax"]["params"][-1]
    for name, value in runs["port"]["params"][-1].items():
        if name.split("/")[1] == "color_net":
            np.testing.assert_array_equal(value, ref[name], err_msg=name)


@pytest.mark.parametrize("group", GROUPS)
def test_ema_stays_within_the_jax_sensitivity(runs, group):
    """The EMA after every epoch, held like the parameters."""
    ref = runs["jax"]["ema"]
    for epoch in range(EPOCHS):
        port = _dist(runs["port"]["ema"][epoch], ref[epoch], group)
        yard = max(_dist(runs[k]["ema"][epoch], ref[epoch], group)
                   for k in ("jax_table", "jax_pose"))
        assert port <= MULTIPLE * yard + FLOOR, (epoch, port, yard)


def test_refreshed_grids_occupy_the_same_cells(runs):
    """After every step the grids hold the same occupied cells (before and
    after the dilation), and their values agree at the refresh's float32
    rounding; the refreshes at global steps 0, 16 and 32 move them, and the
    occupied share is neither empty nor full."""
    cfg = occ_config_from_opt(_options(cli.get_arg_parser()))
    grids_j, grids_p = runs["jax"]["grid"], runs["port"]["grid"]
    for step in range(STEPS):
        a, b = torch.from_numpy(grids_p[step]), torch.from_numpy(grids_j[step])
        for thresh_a, thresh_b in (
                (a > torch.clamp(a.mean(), max=cfg.density_thresh),
                 b > torch.clamp(b.mean(), max=cfg.density_thresh)),
                (occupied_volume(a, cfg), occupied_volume(b, cfg))):
            assert torch.equal(thresh_a, thresh_b), step
        np.testing.assert_allclose(grids_p[step], grids_j[step], rtol=1e-5, atol=1e-5)
        if step % INTERVAL:
            np.testing.assert_array_equal(grids_p[step], grids_p[step - 1])
        elif step:
            assert not np.array_equal(grids_p[step], grids_p[step - 1])
    share = float((torch.from_numpy(grids_j[-1])
                   > torch.from_numpy(grids_j[-1]).mean()).float().mean())
    assert 0.0 < share < 1.0
