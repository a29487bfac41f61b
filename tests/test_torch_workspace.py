"""The port trainer's workspace on the CPU, at a tiny width: checkpoints and
resume, evaluation, the checkpoint ring and the best checkpoint, and
checkpoints passed between the port and the JAX trainer.

The runs use the CLI's parser on the tiny flow of tests/test_e2e.py
(16 x 64 panos, 16 + 4 samples, 128 rays, a 64-cell 2^10 table, the
config's [2, 8] patch schedule). Everything the port does on the CPU is
deterministic, so resumed and evaluated runs must equal uninterrupted ones
bit for bit. Between the packages, renders agree within the render parity
tolerance of tests/test_torch_render.py (rtol 1e-4, atol 1e-5).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import main_lidarnerf as cli_j  # noqa: E402
from lidarnerf_tpu.dataset.kitti360 import KITTI360Dataset as KITTI360DatasetJ  # noqa: E402
from lidarnerf_tpu.nerf import metrics as metrics_j  # noqa: E402
from lidarnerf_tpu.nerf import train_step as tsj  # noqa: E402
from lidarnerf_tpu.nerf.trainer import Trainer as TrainerJ  # noqa: E402
from lidarnerf_tpu_torch import main_lidarnerf as cli  # noqa: E402
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset  # noqa: E402
from lidarnerf_tpu_torch.nerf import metrics  # noqa: E402
from lidarnerf_tpu_torch.nerf.trainer import Trainer  # noqa: E402
from lidarnerf_tpu_torch.utils.params import params_from_jax, params_to_jax  # noqa: E402
from test_e2e import write_synthetic_kitti  # noqa: E402

RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
FAST = ["--fast", "--occ_grid_size", "16", "--occ_bins", "16", "--occ_update_interval", "2"]
SCALE = 0.05
TINY_ARGV = ["--config", "configs/kitti360_1908.txt", "--iters", "9", "--num_steps", "16",
             "--upsample_steps", "4", "--num_rays_lidar", "128", "--desired_resolution", "64",
             "--log2_hashmap_size", "10", "--max_ray_batch", "512", "--scale", str(SCALE),
             "--offset", "0", "0", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny tensors: one intra-op thread, so that the workers of a parallel
    test run do not oversubscribe the cores (every comparison in this file is
    between runs made under this one setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    write_synthetic_kitti(root, n_train=3, n_val=1, n_test=1)
    return root


def _opt(data, *extra):
    """The CLI's options after main()'s own settings, on the tiny flow."""
    opt = cli.get_arg_parser().parse_args(TINY_ARGV + ["--path", data, *extra])
    opt.enable_lidar = True
    cli.apply_macros(opt)
    opt.H_lidar, opt.W_lidar, opt.intrinsics_lidar = 16, 64, (2.0, 26.9)
    return opt


def _dataset(data, split):
    return KITTI360Dataset(split=split, root_path=data, scale=SCALE, offset=[0, 0, 0],
                           num_rays_lidar=128)


def _meters(opt):
    return [metrics.MAEMeter(intensity_inv_scale=opt.intensity_inv_scale), metrics.RMSEMeter(),
            metrics.DepthMeter(scale=opt.scale),
            metrics.PointsMeter(scale=opt.scale, intrinsics=(2.0, 26.9), device="cpu")]


def _trainer(opt, workspace, **kw):
    kw = {"ema_decay": 0.95, "use_checkpoint": "latest", **kw}
    return Trainer("lidar_nerf", opt, cli.build_model(opt), device="cpu", mute=True,
                   workspace=None if workspace is None else str(workspace), **kw)


def _weights(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _assert_equal_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_checkpoint_round_trips_the_state(data, tmp_path, fast):
    """Weights, EMA, the Adam moments and both counts, the generator, np_rng,
    the counters, the stats and (--fast) the occupancy grid come back from a
    checkpoint exactly; its leaves are numpy, never torch tensors."""
    opt = _opt(data, *(FAST if fast else []))
    a = _trainer(opt, tmp_path)
    a.train(_dataset(data, "train"), None, max_epochs=2)
    b = _trainer(opt, tmp_path)  # a fresh model; loads ep0002
    assert (b.epoch, b.global_step, b.ema_num_updates) == (2, 6, 2)
    _assert_equal_dicts(_weights(a), _weights(b))
    _assert_equal_dicts(a.ema_params, b.ema_params)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (sb["count"], sb["schedule_count"]) == (sa["count"], sa["schedule_count"]) == (6, 6)
    for kind in ("mu", "nu"):
        assert sa[kind].keys() == sb[kind].keys() == dict(a.model.named_parameters()).keys()
        for k in sa[kind]:
            assert torch.equal(sa[kind][k], sb[kind][k]), (kind, k)
    assert sa["mu"]["hash_table"].any()
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    ra, rb = a._np_rng.get_state(), b._np_rng.get_state()
    assert ra[0] == rb[0] and np.array_equal(ra[1], rb[1]) and ra[2:] == rb[2:]
    assert a.stats == b.stats
    if fast:
        assert a.occ_grid.any() and torch.equal(a.occ_grid, b.occ_grid)
    else:
        assert a.occ_grid is None and b.occ_grid is None
    with open(tmp_path / "checkpoints" / "lidar_nerf_ep0002.ckpt", "rb") as f:
        state = pickle.load(f)
    assert not any(isinstance(x, torch.Tensor) for x in _leaves(state))
    # the JAX trainer's keys, "optimizer" in optax's layout, and the port's
    # generator; nothing under the JAX trainer's "rng"
    assert set(state) == {"epoch", "global_step", "stats", "ema_num_updates", "np_rng",
                          "rng_torch", "model", "ema", "optimizer",
                          *(["occ_grid"] if fast else [])}
    assert set(state["model"]["params"]) == {"hash_table", "sigma_net", "color_net",
                                             "lidar_color_net"}


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_resume_equals_an_uninterrupted_run(data, tmp_path, fast):
    """Epochs 1-2, then a new Trainer from the workspace trains epoch 3: its
    step losses and weights equal those of three epochs in one run."""
    opt = _opt(data, *(FAST if fast else []))
    ds = _dataset(data, "train")
    whole = _trainer(opt, tmp_path / "whole")
    whole.train(ds, None, max_epochs=3)
    first = _trainer(opt, tmp_path / "resumed")
    first.train(ds, None, max_epochs=2)
    resumed = _trainer(opt, tmp_path / "resumed")
    assert resumed.epoch == 2
    resumed.train(ds, None, max_epochs=3)
    assert resumed.stats["step_loss"] == whole.stats["step_loss"]
    assert len(whole.stats["step_loss"]) == 9 and not any(whole.stats["skipped"])
    _assert_equal_dicts(_weights(resumed), _weights(whole))
    _assert_equal_dicts(resumed.ema_params, whole.ema_params)


def test_evaluation_leaves_training_unchanged(data, tmp_path):
    """An evaluation every epoch (EMA weights swapped in and back, deterministic
    render) changes no step loss and no weight."""
    opt = _opt(data)
    ds, val = _dataset(data, "train"), _dataset(data, "val")
    quiet = _trainer(opt, None)
    quiet.train(ds, None, max_epochs=3)
    evaluated = _trainer(opt, tmp_path, depth_metrics=_meters(opt), eval_interval=1)
    evaluated.train(ds, val, max_epochs=3)
    assert [e["event"] for e in evaluated.run_log].count("eval") == 3
    assert evaluated.stats["step_loss"] == quiet.stats["step_loss"]
    _assert_equal_dicts(_weights(evaluated), _weights(quiet))
    assert torch.equal(evaluated.generator.get_state(), quiet.generator.get_state())
    assert len(os.listdir(tmp_path / "validation")) == 3 * 4  # 1 frame, 4 files, 3 epochs


def test_checkpoint_ring_and_best_checkpoint(data, tmp_path):
    """max_keep_ckpt=2 keeps the last two full checkpoints; the best one (the
    least Chamfer distance) stores the EMA weights as its model."""
    opt = _opt(data)
    t = _trainer(opt, tmp_path, depth_metrics=_meters(opt), eval_interval=1, max_keep_ckpt=2)
    t.train(_dataset(data, "train"), _dataset(data, "val"), max_epochs=4)
    names = sorted(os.listdir(tmp_path / "checkpoints"))
    assert names == ["lidar_nerf.ckpt", "lidar_nerf_ep0003.ckpt", "lidar_nerf_ep0004.ckpt"]
    assert t.stats["best_result"] == min(t.stats["results"]) and len(t.stats["results"]) == 4
    with open(tmp_path / "checkpoints" / "lidar_nerf.ckpt", "rb") as f:
        best = pickle.load(f)
    assert "optimizer" not in best  # not a full checkpoint
    for net in ("hash_table",):
        np.testing.assert_array_equal(best["model"]["params"][net], best["ema"]["params"][net])
    best_epoch = 1 + t.stats["results"].index(t.stats["best_result"])
    assert best["epoch"] == best_epoch
    if best_epoch == 4:  # the EMA now is the EMA it stored
        np.testing.assert_array_equal(best["model"]["params"]["hash_table"],
                                      t.ema_params["hash_table"].numpy())
    # "best" loads it: the model takes the EMA weights
    b = _trainer(opt, tmp_path, use_checkpoint="best")
    assert torch.equal(b.model.hash_table.detach(),
                       torch.from_numpy(best["ema"]["params"]["hash_table"]))


def test_truncated_latest_checkpoint_is_skipped(data, tmp_path):
    opt = _opt(data)
    t = _trainer(opt, tmp_path)
    t.train(_dataset(data, "train"), None, max_epochs=2)
    latest = tmp_path / "checkpoints" / "lidar_nerf_ep0002.ckpt"
    latest.write_bytes(latest.read_bytes()[: latest.stat().st_size // 2])
    r = _trainer(opt, tmp_path)
    assert (r.epoch, r.global_step) == (1, 3)
    assert "[WARN] corrupt checkpoint" in (tmp_path / "log_lidar_nerf.txt").read_text()


def _keeping(meter):
    """The JAX meter, keeping its last measurement when the trainer clears it."""
    clear = meter.clear

    def keep():
        if meter.N:
            meter.kept = meter.measure()
        clear()

    meter.clear = keep
    return meter


def _jax_trainer(opt, workspace, **kw):
    opt_j = cli_j.get_arg_parser().parse_args(TINY_ARGV + ["--path", opt.path])
    opt_j.enable_lidar = True
    opt_j.min_near = opt_j.min_near_lidar = opt_j.scale
    opt_j.H_lidar, opt_j.W_lidar, opt_j.intrinsics_lidar = 16, 64, (2.0, 26.9)
    return TrainerJ("lidar_nerf", opt_j, cli_j.build_model(opt_j), mute=True,
                    workspace=str(workspace), ema_decay=0.95, **kw)


def test_jax_checkpoint_loads_into_the_port(data, tmp_path):
    """A full checkpoint the JAX Trainer writes loads into the port: weights,
    EMA, counters and stats, and its optax state (both moments, bit for
    bit, and both counts) into the port's Adam. The port's `evaluate` then
    gives the JAX trainer's meters on those weights: the panos agree within
    the render tolerance, and the meters, means over the panos' pixels and
    points, within its rtol 1e-4."""
    opt = _opt(data)
    # a field with structure: the port's weights after three epochs
    src = _trainer(opt, None)
    src.train(_dataset(data, "train"), None, max_epochs=3)
    meters_j = [_keeping(m) for m in (
        metrics_j.MAEMeter(), metrics_j.RMSEMeter(), metrics_j.DepthMeter(scale=SCALE),
        metrics_j.PointsMeter(scale=SCALE, intrinsics=(2.0, 26.9)))]
    tj = _jax_trainer(opt, tmp_path / "jax", depth_metrics=meters_j)
    tj.params = jax.tree.map(jnp.asarray, params_to_jax(src.model.state_dict()))
    tj.ema_params = jax.tree.map(jnp.asarray, params_to_jax(src.ema_params))
    tj.epoch, tj.global_step, tj.ema_num_updates = 3, 9, 3
    # an optax state three updates in, on gradients from a seed
    rs = np.random.RandomState(5)
    tx = tsj.make_optimizer(tj.train_cfg)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(rs.normal(size=p.shape).astype(np.float32)),
                         tj.params)
        _, tj.opt_state = tx.update(g, tj.opt_state, tj.params)
    tj.save_checkpoint(full=True)
    path = tmp_path / "jax" / "checkpoints" / "lidar_nerf_ep0003.ckpt"
    with open(path, "rb") as f:
        assert "optimizer" in pickle.load(f)

    port = _trainer(opt, tmp_path / "port", use_checkpoint=str(path),
                    depth_metrics=_meters(opt))
    assert (port.epoch, port.global_step, port.ema_num_updates) == (3, 9, 3)
    _assert_equal_dicts(_weights(port), _weights(src))
    _assert_equal_dicts(port.ema_params, src.ema_params)
    (count_j, mu_j, nu_j), (sched_j,) = tj.opt_state
    assert int(port.optimizer.count) == int(count_j) == 3
    assert int(port.optimizer.schedule_count) == int(sched_j) == 3
    for kind, tree in (("mu", mu_j), ("nu", nu_j)):
        want = params_from_jax(jax.tree.map(np.asarray, tree))
        got = port.optimizer.state_dict()[kind]
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (kind, k)
    assert "loaded optimizer (Adam step 3, schedule count 3)" in (
        tmp_path / "port" / "log_lidar_nerf.txt").read_text()

    test_j = KITTI360DatasetJ(split="test", root_path=data, scale=SCALE, offset=[0, 0, 0])
    tj.evaluate(test_j)
    port.evaluate(_dataset(data, "test"))
    got = port.run_log[-1]["meters"]
    assert list(got) == [type(m).__name__ for m in meters_j]
    for m in meters_j:
        np.testing.assert_allclose(got[type(m).__name__], m.kept, rtol=1e-4, atol=1e-6)
    for i in range(len(test_j)):
        rd_j, it_j, dp_j = tj._render_full_frame(tj.ema_params, test_j, i)
        held = port._swap_in(port.ema_params)
        rd, it, dp = port._render_full_frame(_dataset(data, "test"), i)
        port.model.load_state_dict(held)
        for x, y in ((rd, rd_j), (it, it_j), (dp, dp_j)):
            np.testing.assert_allclose(x, y, **RENDER_TOL)


def test_port_checkpoint_loads_into_the_jax_trainer(data, tmp_path):
    """The JAX Trainer reads the port's workspace (`use_checkpoint="latest"`):
    weights, EMA, counters; it renders the pano the port renders."""
    opt = _opt(data)
    port = _trainer(opt, tmp_path)
    port.train(_dataset(data, "train"), None, max_epochs=2)
    tj = _jax_trainer(opt, tmp_path)
    assert (tj.epoch, tj.global_step, tj.ema_num_updates) == (2, 6, 2)
    np.testing.assert_array_equal(np.asarray(tj.params["params"]["hash_table"]),
                                  port.model.hash_table.detach().numpy())
    test_j = KITTI360DatasetJ(split="test", root_path=data, scale=SCALE, offset=[0, 0, 0])
    rd_j, it_j, dp_j = tj._render_full_frame(tj.params, test_j, 0)
    rd, it, dp = port._render_full_frame(_dataset(data, "test"), 0)
    for x, y in ((rd, rd_j), (it, it_j), (dp, dp_j)):
        np.testing.assert_allclose(x, y, **RENDER_TOL)


def test_foreign_objects_are_refused(data, tmp_path):
    """An optax state is only dropped from `optimizer`; anywhere else, and a
    JAX array anywhere, the checkpoint is refused."""
    opt = _opt(data)
    tj = _jax_trainer(opt, tmp_path / "jax")
    tj.save_checkpoint(full=True)
    path = tmp_path / "jax" / "checkpoints" / "lidar_nerf_ep0000.ckpt"
    with open(path, "rb") as f:
        state = pickle.load(f)
    state["stats"]["moved"] = state.pop("optimizer")
    bad = tmp_path / "optax_outside.ckpt"
    bad.write_bytes(pickle.dumps(state))
    with pytest.raises(ValueError, match=r"optax\S+ object outside its 'optimizer'"):
        _trainer(opt, tmp_path / "port", use_checkpoint=str(bad))
    state["optimizer"] = {"count": jnp.zeros(())}
    del state["stats"]["moved"]
    bad.write_bytes(pickle.dumps(state))
    with pytest.raises(ValueError, match=r"jax\S*\.\S+ object"):
        _trainer(opt, tmp_path / "port", use_checkpoint=str(bad))


def test_profile_traces_the_first_epoch(data, tmp_path):
    """--profile: a torch.profiler trace of the first epoch in workspace/profile
    (the JAX trainer's jax.profiler trace), and only of the first."""
    opt = _opt(data, "--profile")
    t = _trainer(opt, tmp_path)
    t.train(_dataset(data, "train"), None, max_epochs=2)
    assert os.listdir(tmp_path / "profile") == ["lidar_nerf_ep0001.json"]
    assert (tmp_path / "profile" / "lidar_nerf_ep0001.json").stat().st_size > 0
