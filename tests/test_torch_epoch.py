"""Port parity for the fused training epoch: lidarnerf_tpu_torch's
`make_epoch_step` against the JAX package's, the device-side update guard and
learning rate, the optimizer state carried across packages (C7), and the
CLI's `--fuse_epoch` on the CPU.

The field, the scene and the draws are tests/test_torch_train.py's (4 levels,
hidden 32, fp32, 64 + 8 samples, 64 rays on an 8 x 64 pano). Every step's
draws are derived from the JAX epoch's `step_keys` exactly as its loss
closure derives them, and each occupancy refresh's jitter from its
`occ_keys`, so both epochs train on the same pixels and samples. On the CPU
the port's epoch runs its step body eagerly; the CUDA graph of the same body
is held against it on the card (tests/test_torch_cuda.py).
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

from lidarnerf_tpu.dataset.kitti360 import KITTI360Dataset as KITTI360DatasetJ  # noqa: E402
from lidarnerf_tpu.models.occupancy import OccConfig as OccConfigJ  # noqa: E402
from lidarnerf_tpu.models.renderer import RenderConfig as RenderConfigJ  # noqa: E402
from lidarnerf_tpu.nerf import train_step as tsj  # noqa: E402
from lidarnerf_tpu_torch.models.network import NeRFNetwork  # noqa: E402
from lidarnerf_tpu_torch.models.occupancy import OccConfig  # noqa: E402
from lidarnerf_tpu_torch.models.renderer import RenderConfig  # noqa: E402
from lidarnerf_tpu_torch.nerf import train_step as tst  # noqa: E402
from lidarnerf_tpu_torch.utils.params import (  # noqa: E402
    optimizer_from_jax,
    params_from_jax,
    params_to_jax,
)
from test_torch_occupancy import shell_grid  # noqa: E402
from test_torch_train import (  # noqa: E402
    CASES,
    H,
    NET,
    OCC,
    SCALE,
    S,
    T,
    W,
    _configs,
    _draws,
    _flat,
    _scene,
    field,
    seamless_field,
)
from test_torch_workspace import (  # noqa: E402
    _dataset,
    _jax_trainer,
    _one_thread,  # noqa: F401 (autouse: one intra-op thread here too)
    _opt,
    _trainer,
    data,
)

K = 4  # steps per epoch
ORDER = np.array([1, 0, 0, 1])  # both frames, one twice in a row
# raydrop_err reads the LiDAR head directly, and the head drifts apart from
# its second update on (HEAD_* below): the first three steps keep the single
# step's rtol 1e-5 (the masked case's second step: 7e-6 apart); the fourth is
# held at 1e-4 (the masked case's: 6.6e-5 apart, while its loss stays within
# 3e-6)
HEAD_DRIFT_RTOL = 1e-4
OCC_EVERY = 2  # the --fast case's refresh interval: steps 0 and 2 refresh


def _fast_configs():
    """`_configs(occ=True)` with the grid refreshed every OCC_EVERY steps."""
    tcfg_j, tcfg, _, _ = _configs()
    occ = dict(OCC, update_interval=OCC_EVERY)
    rcfg_j = RenderConfigJ(num_steps=T, upsample_steps=S, min_near_lidar=SCALE, min_near=SCALE,
                           occ=OccConfigJ(**occ))
    rcfg = RenderConfig(num_steps=T, upsample_steps=S, min_near_lidar=SCALE, min_near=SCALE,
                        occ=OccConfig(**occ))
    return tcfg_j, tcfg, rcfg_j, rcfg


def _pools(masked):
    """The masked case's pools (tests/test_torch_train.py's), or the dense dummies."""
    if masked:
        pool = np.arange(0, H * W, 3)
        vc = np.array([len(pool) - 40, len(pool) - 7], np.int32)
        vi = np.stack([pool, pool[::-1].copy()]).astype(np.int32)
    else:
        vi, vc = np.zeros((2, 1), np.int32), np.full((2,), H * W, np.int32)
    return vi, vc


def _epoch_draws(step_keys, occ_keys, order, patch, masked, vc, grid_size=None, step0=0):
    """The port's per-step draws from the JAX epoch's keys."""
    draws = []
    for i, frame in enumerate(order):
        d = _draws(step_keys[i], patch, masked, int(vc[frame]))
        if grid_size and (step0 + i) % OCC_EVERY == 0:  # occupancy.py:74
            d["occ_jitter"] = torch.from_numpy(np.array(jax.random.uniform(
                occ_keys[i], (grid_size,) * 3 + (3,), dtype=jnp.float32)))
        draws.append(d)
    return draws


def _port_net(params, net_kw):
    net = NeRFNetwork(**net_kw)
    net.load_state_dict(params_from_jax(params))
    return net


# Every parameter and both its moments are held. The table and the sigma
# net entry by entry to their gradients' 2e-5 of the peak; the RGB head has
# no gradient. The LiDAR head's gradients carry 2e-3 of their peak
# (test_torch_train.py's `_grad_tol`: the degree-12 frequency encoding reads
# the two libms' ulps in the directions), and Adam's first update turns
# that into moves of lr apart (opposite signs) on elements whose gradients
# lie near zero; the second step's gradients read those weights, so the
# head's state drifts from then on. It is held to what 4 steps measure,
# with headroom: its moments to 0.1 of their peak and its well-set
# parameters to 3 lr (the masked case: 6.6e-2 and 2.1e-2 = 2.1 lr; the other
# cases: 2.8e-3 and 8e-4). Its first step alone is held at the single
# step's tolerances in test_torch_train.py.
MOMENT_TOL = 2 * 2e-5  # the held gradients' 2e-5 of the peak; nu's relative error doubles
HEAD = "params/lidar_color_net/"
HEAD_MOMENT_TOL = 0.1  # after more than one step; one: its gradients' 2e-3, doubled for nu
WELL_SET = 1e-2  # |mu| and sqrt(nu) above this share of their peaks


def _param_tol(name, steps, lr):
    """test_torch_train.py's 1e-6 a step; the LiDAR head's drift after
    more than one step: 3 lr."""
    return 3 * lr if name.startswith(HEAD) and steps > 1 else steps * 1e-6


def _check_opt_state(adam, opt_state_j, count, steps):
    """Both counts exactly; every mu and nu after `steps` updates from the same state, entry by entry, relative to their peak (the
    RGB head's, zero, stay zero)."""
    (count_j, mu_j, nu_j), (sched_j,) = opt_state_j
    assert int(adam.count) == int(count_j) == count
    assert int(adam.schedule_count) == int(sched_j) == count
    state = adam.state_dict()
    for kind, tree in (("mu", mu_j), ("nu", nu_j)):
        ref = _flat(jax.tree.map(np.asarray, tree))
        got = _flat(params_to_jax(state[kind]))
        assert got.keys() == ref.keys()
        for name, r in ref.items():
            peak = np.abs(r).max()  # 0 for the RGB head, unless a checkpoint gave it moments
            tol = MOMENT_TOL
            if name.startswith(HEAD):
                tol = HEAD_MOMENT_TOL if steps > 1 else 2 * 2e-3
            np.testing.assert_allclose(got[name], r, rtol=0, atol=tol * peak,
                                       err_msg=f"{kind} {name}")


def _check_params(net, params_j, opt_state_j, steps, lr):
    """Every parameter after `steps` updates. An element's Adam update is
    mu_hat / sqrt(nu_hat): where either lies near the noise floor of the
    gradients (2e-5 of the peak), rounding moves it by up to lr, so the
    elements whose |mu| and sqrt(nu) stand above WELL_SET of their peaks are
    held, to `_param_tol`. The RGB head without moments never moves."""
    after, after_j = _flat(params_to_jax(net.state_dict())), _flat(params_j)
    mu, nu = (_flat(jax.tree.map(np.asarray, t)) for t in opt_state_j[0][1:])
    for name, ref in after_j.items():
        if not nu[name].any():  # the RGB head without moments never moves
            np.testing.assert_array_equal(after[name], ref, err_msg=name)
            continue
        well = ((np.abs(mu[name]) > WELL_SET * np.abs(mu[name]).max())
                & (nu[name] > WELL_SET**2 * nu[name].max()))
        assert well.any(), name
        np.testing.assert_allclose(after[name][well], ref[well], rtol=0,
                                   atol=_param_tol(name, steps, lr), err_msg=name)


@pytest.mark.parametrize("case", ["patch1", "patch2x8_grad_loss", "masked", "fast"])
def test_epoch_matches_jax_make_epoch_step(field, seamless_field, case):
    """K steps of the port's epoch (eager on the CPU) against JAX
    `make_epoch_step` from the same weights, frame order and keys: each
    step's loss and metrics at test_torch_train.py's rtol 1e-5, then the
    parameters, both Adam moments and both counts."""
    c = CASES[case]
    fast = c.get("occ", False)
    net_kw = {**NET, **c.get("net", {})}
    module, params = seamless_field if fast else field
    patch, masked = c["patch"], c["masked"]
    tcfg_j, tcfg, rcfg_j, rcfg = _fast_configs() if fast else _configs(**c["kw"])
    poses, images = _scene()
    vi, vc = _pools(masked)
    order = ORDER
    key = jax.random.PRNGKey(11)
    step_keys = jax.random.split(jax.random.fold_in(key, 0), K)
    occ_keys = jax.random.split(jax.random.fold_in(key, 1), K)
    grid = shell_grid(OCC["grid_size"], 0.25, 0.55) if fast else np.zeros((1, 1, 1), np.float32)

    epoch_j = tsj.make_epoch_step(module, tcfg_j, rcfg_j, patch, masked)
    jp = jax.tree.map(jnp.asarray, params)
    params_j, opt_j, grid_j, m_j = epoch_j(
        jp, tsj.make_optimizer(tcfg_j).init(jp), jnp.asarray(grid),
        *map(jnp.asarray, (poses, images, vi, vc)), jnp.asarray(order, jnp.int32),
        step_keys, occ_keys, 0)

    net = _port_net(params, net_kw)
    epoch = tst.make_epoch_step(net, tcfg, rcfg, patch, masked, device="cpu")
    occ_grid = torch.from_numpy(grid.copy()) if fast else None
    m = epoch(*map(torch.from_numpy, (poses, images, vi.astype(np.int64), vc.astype(np.int64))),
              order, 0, occ_grid=occ_grid,
              draws=_epoch_draws(step_keys, occ_keys, order, patch, masked, vc,
                                 OCC["grid_size"] if fast else None))

    assert set(m) == set(tst.METRICS) and all(v.shape == (K,) for v in m.values())
    assert not m["skipped_nonfinite"].any() and not np.asarray(m_j["skipped_nonfinite"]).any()
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["depth_mae"].numpy(), np.asarray(m_j["depth_mae"]), rtol=1e-5,
                               atol=1e-7)
    rd, rd_j = m["raydrop_err"].numpy(), np.asarray(m_j["raydrop_err"])
    np.testing.assert_allclose(rd[:3], rd_j[:3], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rd[3:], rd_j[3:], rtol=HEAD_DRIFT_RTOL)
    _check_opt_state(epoch.step.optimizer, opt_j, K, K)
    _check_params(net, jax.tree.map(np.asarray, params_j), opt_j, K, tcfg.lr)
    if fast:  # refreshed in place at steps 0 and 2, from the live weights
        np.testing.assert_allclose(occ_grid.numpy(), np.asarray(grid_j), rtol=1e-5, atol=1e-6)
        assert not np.array_equal(occ_grid.numpy(), grid)


def _nan_scene():
    """_scene's two frames and a third whose gt depths are NaN: a step on it
    has a NaN loss and NaN gradients."""
    poses, images = _scene(3)
    images[2, ..., 2] = np.nan
    return poses, images


def _adam_state(adam):
    return [t.clone() for t in (*adam.mu, *adam.nu, adam.count, adam.schedule_count)]


def test_device_guard_keeps_the_state_through_a_nan_step(field):
    """An epoch [0, NaN frame, 1] against [0, 1] and [0, NaN frame] against
    [0], from the same weights with the same draws: the NaN step is flagged
    on the device, keeps the parameters, both moments, Adam's step and the
    schedule count bit for bit, and the healthy step after it equals the
    same step taken without it, bit for bit."""
    _, params = field
    _, tcfg, _, rcfg = _configs()
    poses, images = _nan_scene()
    vi, vc = torch.zeros((3, 1), dtype=torch.long), torch.full((3,), H * W)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    d0, d_nan, d1 = (_draws(k, 1, False, H * W) for k in keys)

    def run(order, draws):
        net = _port_net(params, NET)
        epoch = tst.make_epoch_step(net, tcfg, rcfg, device="cpu")
        m = epoch(torch.from_numpy(poses), torch.from_numpy(images), vi, vc, np.array(order), 0,
                  draws=draws)
        return m, [p.detach().clone() for p in net.parameters()], _adam_state(epoch.step.optimizer)

    m_a, p_a, s_a = run([0, 2, 1], [d0, d_nan, d1])
    m_b, p_b, s_b = run([0, 1], [d0, d1])
    m_c, p_c, s_c = run([0, 2], [d0, d_nan])
    m_d, p_d, s_d = run([0], [d0])
    assert m_a["skipped_nonfinite"].tolist() == [0.0, 1.0, 0.0]
    assert not np.isfinite(float(m_a["loss"][1]))
    assert int(s_c[-2]) == int(s_c[-1]) == 1  # the NaN step did not count
    for x, y in (*zip(p_c + s_c, p_d + s_d), *zip(p_a + s_a, p_b + s_b)):
        assert torch.equal(x, y)
    assert torch.equal(m_a["loss"][[0, 2]], m_b["loss"])


def test_device_lr_follows_the_optax_schedule():
    """DeviceAdam's lr (a device tensor) against optax's schedule at its count,
    over updates past `iters` (the 0.1 floor) and through a skipped one:
    equal bit for bit, and the counts equal optax's under the JAX guard."""
    cfg = tst.TrainConfig(lr=1e-2, iters=3)
    cfg_j = tsj.TrainConfig(lr=1e-2, iters=3)
    rs = np.random.RandomState(2)
    p0 = {"a": rs.uniform(-1, 1, (4, 5)).astype(np.float32)}
    tx = tsj.make_optimizer(cfg_j)
    pj = jax.tree.map(jnp.asarray, p0)
    state = tx.init(pj)
    param = torch.nn.Parameter(torch.from_numpy(p0["a"].copy()))
    adam = tst.make_optimizer([("a", param)], cfg)
    for k in range(7):
        g = rs.normal(size=(4, 5)).astype(np.float32)
        loss = np.float32(np.nan if k == 2 else 1.0)  # the third update is skipped
        count_j = state[1].count
        lr_j = cfg_j.lr * 0.1 ** jnp.minimum(count_j / cfg_j.iters, 1.0)
        lr = adam.lr_now()
        assert lr.dtype == torch.float32 and lr.dim() == 0
        assert float(lr) == float(lr_j), k
        pj, state, finite = tsj.guarded_update(tx, pj, state, {"a": jnp.asarray(g)},
                                               jnp.asarray(loss))
        param.grad = torch.from_numpy(g)
        assert bool(adam.step(torch.tensor(loss))) == bool(finite)
        assert int(adam.count) == int(state[0].count)
        assert int(adam.schedule_count) == int(state[1].count)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(pj["a"]), rtol=0,
                                   atol=2e-7)  # test_adam_and_schedule_match_optax's ~1 ulp of p
    assert int(adam.schedule_count) == 6 and float(adam.lr_now()) == np.float32(1e-3)


# --- C7: the optimizer state across packages, through checkpoint files ---

TINY = dict(n=128, t=16, s=4, h=16, w=64)  # test_torch_workspace.py's tiny flow


def _resumed_steps(port, tj, data):
    """One patch-1 step on train frame 0 in each package from its loaded
    state, with the draws the JAX step derives from one key. Returns the
    port's metrics and the JAX (params, opt_state, metrics)."""
    ds, ds_j = _dataset(data, "train"), KITTI360DatasetJ(
        split="train", root_path=data, scale=port.opt.scale, offset=[0, 0, 0])
    key = jax.random.PRNGKey(21)
    out_j = tj._get_step_fn(1, False)(tj.params, tj.opt_state, *tj._device_data(ds_j)[:4], 0,
                                      key, tj.global_step)
    poses, images, vi, vc, _ = port._device_data(ds)
    m = port._get_step_fn(1, False)(poses, images, vi, vc, 0,
                                    draws=_draws(key, 1, False, 0, **TINY))
    return m, out_j


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax", "jax_to_port-hashgrid",
                                       "port_to_jax-hashgrid"])
def test_resumed_step_matches_across_packages(data, tmp_path, direction):
    """C7: a full checkpoint of one package resumes in the other with its Adam
    moments and both counts (so its lr); then one step in each package from
    that checkpoint agrees: the loss and metrics at test_torch_train.py's
    rtol 1e-5, the counts exactly, the moments and the well-set parameters
    of the table, the sigma net and the LiDAR head as in the epoch test
    above, at its tolerances for one step. Under the CLI's blockhash, and
    under --encoding hashgrid (its [table_rows, 2] table in optax's leaf
    order)."""
    direction, _, encoding = direction.partition("-")
    opt = _opt(data, "--encoding", encoding or "blockhash")
    ws = tmp_path / "ws"
    if direction == "port_to_jax":
        src = _trainer(opt, ws)
        src.train(_dataset(data, "train"), None, max_epochs=2)  # 6 updates
        state = src.optimizer.state_dict()
    else:  # the port's weights, and an optax state 6 updates in, from the JAX trainer
        src = _trainer(opt, None)
        src.train(_dataset(data, "train"), None, max_epochs=2)
        tj = _jax_trainer(opt, ws, use_checkpoint="scratch")
        tj.params = jax.tree.map(jnp.asarray, params_to_jax(src.model.state_dict()))
        rs, tx = np.random.RandomState(5), tsj.make_optimizer(tj.train_cfg)
        for _ in range(6):
            g = jax.tree.map(lambda p: jnp.asarray(rs.normal(size=p.shape).astype(np.float32)),
                             tj.params)
            _, tj.opt_state = tx.update(g, tj.opt_state, tj.params)
        tj.epoch, tj.global_step = 2, 6
        tj.save_checkpoint(full=True)
        state = optimizer_from_jax(jax.tree.map(np.asarray, tj.opt_state))
    path = str(ws / "checkpoints" / "lidar_nerf_ep0002.ckpt")
    port = _trainer(opt, tmp_path / "port", use_checkpoint=path)
    tj = _jax_trainer(opt, tmp_path / "jax", use_checkpoint=path)
    assert int(port.optimizer.count) == int(port.optimizer.schedule_count) == 6
    assert port.optimizer.state_dict()["count"] == state["count"]
    for kind in ("mu", "nu"):  # loaded bit for bit, either way
        got = port.optimizer.state_dict()[kind]
        want = _flat(params_to_jax(state[kind]))
        assert _flat(params_to_jax(got)).keys() == want.keys()
        for name, w in _flat(jax.tree.map(np.asarray, tj.opt_state[0]._asdict()[kind])).items():
            np.testing.assert_array_equal(w, want[name], err_msg=f"{kind} {name}")
    assert int(tj.opt_state[0].count) == int(tj.opt_state[1].count) == 6

    m, (params_j, opt_j, m_j) = _resumed_steps(port, tj, data)
    for k in ("loss", "depth_mae", "raydrop_err"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    _check_opt_state(port.optimizer, opt_j, 7, 1)
    _check_params(port.model, jax.tree.map(np.asarray, params_j), opt_j, 1, opt.lr)


def test_cli_fuse_epoch_0_and_1_train_alike_on_the_cpu(data, tmp_path, monkeypatch):
    """`--fuse_epoch 1` (the default) and `0` through the port's CLI on the
    CPU, where both run the step body eagerly: the same step losses and
    final weights, bit for bit."""
    import test_torch_cli
    from lidarnerf_tpu_torch import main_lidarnerf as cli

    monkeypatch.setenv("LIDARNERF_PLATFORM", "cpu")
    monkeypatch.chdir(test_torch_cli.REPO)
    runs = [cli.main(test_torch_cli._argv(data, tmp_path / f"fuse{f}", "tiny", "--fuse_epoch", f))
            for f in ("0", "1")]
    assert [t.opt.fuse_epoch for t in runs] == [0, 1]
    assert runs[0].global_step == runs[1].global_step == 6  # --iters 4 on 3 frames: 2 epochs
    assert runs[0].stats["step_loss"] == runs[1].stats["step_loss"]
    for (k, a), b in zip(runs[0].model.state_dict().items(), runs[1].model.state_dict().values()):
        assert torch.equal(a, b), k


def test_older_port_checkpoint_optimizer_loads(data, tmp_path):
    """The `optimizer_torch` entry of the port's earlier checkpoints
    (torch.optim.Adam's and LambdaLR's state dicts, numpy leaves) loads into
    DeviceAdam: exp_avg and exp_avg_sq as the moments bit for bit, Adam's
    step as the count, LambdaLR's last_epoch as the schedule count."""
    opt = _opt(data)
    ws = tmp_path / "ws"
    src = _trainer(opt, ws)
    src.train(_dataset(data, "train"), None, max_epochs=1)
    path = ws / "checkpoints" / "lidar_nerf_ep0001.ckpt"
    with open(path, "rb") as f:
        state = pickle.load(f)
    # the older layout, from an Adam and a LambdaLR stepped five times
    params = [p.detach().clone().requires_grad_() for p in src.model.parameters()]
    adam = torch.optim.Adam(params, lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    sched = torch.optim.lr_scheduler.LambdaLR(adam, lambda k: 0.1 ** min(k / opt.iters, 1.0))
    gen = torch.Generator().manual_seed(4)
    for _ in range(5):
        for p in params[:2]:  # the others take no gradient, so Adam keeps no state for them
            p.grad = torch.randn(p.shape, generator=gen)
        adam.step()
        sched.step()
    adam_sd = adam.state_dict()
    del state["optimizer"]
    state["optimizer_torch"] = {
        "adam": {"state": {i: {k: v.numpy() for k, v in s.items()}
                           for i, s in adam_sd["state"].items()},
                 "param_groups": adam_sd["param_groups"]},
        "schedule": sched.state_dict()}
    old = tmp_path / "older.ckpt"
    old.write_bytes(pickle.dumps(state))
    port = _trainer(opt, tmp_path / "port", use_checkpoint=str(old))
    got = port.optimizer.state_dict()
    assert (got["count"], got["schedule_count"]) == (5, 5)
    names = [n for n, _ in src.model.named_parameters()]
    for i, name in enumerate(names):
        s = adam_sd["state"].get(i)
        for kind, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = torch.zeros_like(params[i]) if s is None else s[key]
            assert torch.equal(got[kind][name], want), (kind, name)
