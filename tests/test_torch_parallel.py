"""Port parity for multi-device training: `parallel/sharding.py`, the
data-parallel trainer and the orbax-format checkpoint store.

The counterparts of tests/test_parallel.py run in gloo worlds on the CPU:
each test spawns its ranks with torch.multiprocessing (one thread each, a
free localhost port), joins them with a time limit (a hung rank fails its
test), and holds a world of 2, or a (data, model) mesh of (1, 2) or (2, 2)
with the row-sharded table, against one rank or the JAX single-device step
at the JAX package's own tolerances (tests/test_parallel.py:48-72: loss rtol
1e-4, parameters rtol 1e-3 / atol 1e-6). Every rank's parameters must be
bit-identical.
"""

import datetime
import inspect
import os
import socket
import time
import traceback
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.occupancy import OccConfig
from lidarnerf_tpu_torch.models.renderer import RenderConfig
from lidarnerf_tpu_torch.nerf import train_step as tst
from lidarnerf_tpu_torch.parallel import sharding
from lidarnerf_tpu_torch.utils import checkpoint_io

H, W = 8, 32
NET = dict(encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, num_levels=4,
           hidden_dim=16, bound=1.0)
LOSS_RTOL = 1e-4  # tests/test_parallel.py:68
PARAM_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_parallel.py:70
WORLD_TIMEOUT_S = 240  # each spawned world's limit, start-up included (~15 s alone)


# ------------------------------------------------------------ the worlds


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(fn, rank, world, port, queue, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=180))
        queue.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the test
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world, *args, timeout=WORLD_TIMEOUT_S):
    """fn(rank, world, *args) on each rank of a gloo world; {rank: result}.

    A rank that raises fails the test with its traceback; a world that has
    not answered within `timeout` seconds is killed and fails it.
    """
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(fn, r, world, port, queue, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"the world of {world} did not finish within {timeout} s")
            try:
                rank, ok, payload = queue.get(timeout=min(left, 5.0))
            except Exception:  # queue.Empty: check for dead ranks
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    pytest.fail(f"a rank died with exit code {dead[0]}")
                continue
            (out.__setitem__(rank, payload) if ok else errors.append(f"rank {rank}:\n{payload}"))
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        pytest.fail("\n".join(errors))
    return out


# ------------------------------------------------------------ the step


def _scene(n_frames=2, seed=0):
    rs = np.random.RandomState(seed)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (n_frames, 4, 4)).copy()
    poses[:, :3, 3] = rs.uniform(-0.05, 0.05, (n_frames, 3))
    images = rs.rand(n_frames, H, W, 3).astype(np.float32)
    images[..., 2] *= 0.5
    return poses, images


def _net(seed=0):
    net = NeRFNetwork(**NET, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net.hash_table.mul_(1e4)  # O(1) features: densities that vary along the rays
    return net


def _cfgs(n_rays=32, occ=None, **kw):
    cfg = tst.TrainConfig(scale=0.05, num_rays_lidar=n_rays, H_lidar=H, W_lidar=W,
                          intrinsics_lidar=(10.0, 30.0), iters=100, **kw)
    rcfg = RenderConfig(num_steps=16, upsample_steps=4, min_near_lidar=0.05, min_near=0.05,
                        bound=1.0, occ=occ)
    return cfg, rcfg


def _pools(masked, n_frames=2):
    if not masked:
        return torch.zeros((n_frames, 1), dtype=torch.long), torch.full((n_frames,), H * W)
    pool = H * W  # the first 3/4 of the pixels valid
    vi = torch.arange(pool).expand(n_frames, pool).contiguous()
    return vi, torch.full((n_frames,), 3 * pool // 4)


def _state(net, adam):
    """Parameters and Adam moments by name, numpy."""
    out = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    for kind, ts in (("mu", adam.mu), ("nu", adam.nu)):
        out.update({f"{kind}/{n}": t.numpy().copy() for n, t in zip(adam.names, ts)})
    return out


FEATURES = {
    "patch1": dict(patch=1, masked=False, swr=False, kw={}),
    "patch2x8-grad": dict(patch=[2, 8], masked=False, swr=False, kw=dict(grad_loss=True)),
    "masked": dict(patch=1, masked=True, swr=False, kw={}),
    "masked-without-replacement": dict(patch=1, masked=True, swr=True, kw={}),
    "alpha_seam": dict(patch=1, masked=False, swr=False, kw=dict(alpha_seam=0.1)),
}


def _step_run(mesh, case, steps=2, shard_table=False, draws=None):
    """`steps` train steps of FEATURES[case] (or the given draws), on a mesh
    or on one rank; returns the metrics and the state after each step."""
    f = FEATURES[case]
    cfg, rcfg = _cfgs(**f["kw"])
    net = _net()
    poses, images = map(torch.from_numpy, _scene())
    vi, vc = _pools(f["masked"])
    if mesh is None:
        step = tst.make_train_step(net, cfg, rcfg, f["patch"], f["masked"], f["swr"],
                                   device="cpu")
    else:
        step = sharding.make_sharded_train_step(net, cfg, rcfg, mesh, f["patch"], f["masked"],
                                                f["swr"], shard_table=shard_table)
    gen = torch.Generator().manual_seed(7)
    ms, states = [], []
    for i in range(steps):
        d = None if draws is None else {k: torch.from_numpy(v) for k, v in draws[i].items()}
        m = step(poses, images, vi, vc, i % 2, draws=d, generator=gen)
        ms.append({k: float(v) for k, v in m.items()})
        states.append(_snapshot(net, step.optimizer, shard_table))
    return ms, states


def _snapshot(net, adam, shard_table):
    state = _state(net, adam)
    if shard_table:
        mesh = net.table_mesh
        state["hash_table_shard_rows"] = np.array(net.hash_table.shape[0])
        state["hash_table"] = sharding.full_state_dict(net)["hash_table"].numpy().copy()
        for kind in ("mu", "nu"):  # the moments' whole table, for the comparison
            t = getattr(adam, kind)[adam.names.index("hash_table")]
            state[f"{kind}/hash_table"] = sharding._all_gather_rows(
                t, mesh.model_group, mesh.n_model).numpy().copy()
    return state


def _world_step(rank, world, case, n_data, n_model, steps, shard_table, draws=None):
    mesh = sharding.make_mesh(world) if n_model == 1 else sharding.make_mesh_2d(n_data, n_model)
    return _step_run(mesh, case, steps, shard_table, draws)


def _same_across_ranks(results):
    """Every rank's parameters and Adam state after every step, bit for bit."""
    runs = [states for _, states in results.values()]
    for other in runs[1:]:
        for st0, st in zip(runs[0], other):
            for k in st0:
                np.testing.assert_array_equal(st[k], st0[k], err_msg=k)


def _close_to(ref, got):
    """Each step's loss and metrics at the JAX tolerances, and the state after
    the first step (Adam's first update is lr * sign(g), so the tolerance
    holds; later updates divide gradients whose noise-floor entries differ
    in rounding)."""
    (ms_ref, st_ref), (ms, st) = ref, got
    for a, b in zip(ms_ref, ms):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
        for k in ("depth_mae", "raydrop_err"):
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL, atol=1e-7)
        assert b["skipped_nonfinite"] == a["skipped_nonfinite"] == 0.0
    for k, v in st_ref[0].items():
        if k != "hash_table_shard_rows":
            np.testing.assert_allclose(st[0][k], v, err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("case", list(FEATURES))
def test_sharded_step_matches_one_rank(case):
    """The feature matrix (tests/test_parallel.py:48, :198): a world of 2 draws
    the global batch from the same seeded generator and keeps half of it; two
    steps match one rank's, and both ranks hold the same bits."""
    out = run_world(_world_step, 2, case, 2, 1, 2, False)
    _same_across_ranks(out)
    _close_to(_step_run(None, case), out[0])


def test_sharded_step_world_of_four_matches_one_rank():
    out = run_world(_world_step, 4, "patch1", 4, 1, 2, False)
    _same_across_ranks(out)
    _close_to(_step_run(None, "patch1"), out[0])


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_row_sharded_table_matches_one_rank(n_data, n_model):
    """shard_table (tests/test_parallel.py:347): the table and its Adam
    moments stay row-sharded over `model` (each rank holds R / n_model rows),
    and the step matches one rank's."""
    out = run_world(_world_step, n_data * n_model, "alpha_seam", n_data, n_model, 2, True)
    rows = _net().hash_table.shape[0]
    for _, states in out.values():
        assert all(int(st["hash_table_shard_rows"]) == rows // n_model for st in states)
    _same_across_ranks(out)
    _close_to(_step_run(None, "alpha_seam"), out[0])


def _world_epoch(rank, world, fast):
    occ = OccConfig(grid_size=8, bins=8, update_interval=2) if fast else None
    cfg, rcfg = _cfgs(occ=occ)
    net = _net()
    mesh = None if world == 1 else sharding.make_mesh()
    poses, images = map(torch.from_numpy, _scene(3))
    vi, vc = _pools(False, 3)
    kw = dict(device="cpu") if mesh is None else {}
    maker = tst.make_epoch_step if mesh is None else sharding.make_sharded_epoch_step
    args = (net, cfg, rcfg) if mesh is None else (net, cfg, rcfg, mesh)
    fn = maker(*args, **kw)
    grid = torch.zeros((8, 8, 8)) if fast else None
    gen = torch.Generator().manual_seed(3)
    ms = fn(poses, images, vi, vc, np.array([2, 0, 1, 2]), step0=0, generator=gen,
            occ_grid=grid)
    state = _state(net, fn.step.optimizer)
    if fast:
        state["occ_grid"] = grid.numpy().copy()
    return [{k: float(v[i]) for k, v in ms.items()} for i in range(4)], [state]


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_sharded_epoch_matches_one_rank(fast):
    """The fused epoch over a world of 2 (tests/test_parallel.py:74), with the
    occupancy refresh inside it under --fast."""
    out = run_world(_world_epoch, 2, fast)
    _same_across_ranks(out)
    (ms_ref, (st_ref,)), (ms, (st,)) = _world_epoch(0, 1, fast), out[0]
    for a, b in zip(ms_ref, ms):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(st["sigma_net.layers.0.weight"],
                               st_ref["sigma_net.layers.0.weight"], **PARAM_TOL)
    if fast:
        assert np.abs(st["occ_grid"]).max() > 0  # the in-epoch refresh fired
        np.testing.assert_allclose(st["occ_grid"], st_ref["occ_grid"], rtol=1e-5)


def test_sharded_step_matches_the_jax_step():
    """A world of 2 fed the JAX single-device step's draws (its pixels and
    render draws, derived from its key) against JAX make_train_step."""
    import jax
    import jax.numpy as jnp

    from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
    from lidarnerf_tpu.models.renderer import RenderConfig as RenderConfigJ
    from lidarnerf_tpu.nerf import train_step as tsj
    from lidarnerf_tpu_torch.utils.params import params_to_jax
    from test_torch_train import _draws, _flat

    module = FlaxNeRF(compute_dtype=jnp.float32, **NET)
    net = _net()
    params = jax.tree.map(np.asarray, params_to_jax(net.state_dict()))
    cfg, _ = _cfgs(grad_loss=True)
    cfg_j = tsj.TrainConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    rcfg_j = RenderConfigJ(num_steps=16, upsample_steps=4, min_near_lidar=0.05, min_near=0.05,
                           bound=1.0)
    poses, images = _scene()
    vi, vc = np.zeros((2, 1), np.int32), np.full((2,), H * W, np.int32)
    key = jax.random.PRNGKey(7)
    step_j = tsj.make_train_step(module, cfg_j, rcfg_j, patch_size=[2, 8])
    jp = jax.tree.map(jnp.asarray, params)
    new_j, _, m_j = step_j(jp, tsj.make_optimizer(cfg_j).init(jp),
                           *map(jnp.asarray, (poses, images, vi, vc)), 0, key, 0)
    draws = _draws(key, [2, 8], False, H * W, n=32, t=16, s=4, h=H, w=W)
    draws = [{k: v.numpy() for k, v in draws.items()}]
    out = run_world(_world_step, 2, "patch2x8-grad", 2, 1, 1, False, draws)
    _same_across_ranks(out)
    ms, (st,) = out[0]
    np.testing.assert_allclose(ms[0]["loss"], float(m_j["loss"]), rtol=LOSS_RTOL)
    after_j = _flat(jax.tree.map(np.asarray, new_j))
    after = _flat(params_to_jax({k: torch.from_numpy(v) for k, v in st.items()
                                 if "/" not in k}))
    for name, ref in after_j.items():
        np.testing.assert_allclose(after[name], ref, err_msg=name, **PARAM_TOL)


def _world_short_pool(rank, world):
    """tests/test_parallel.py:256 over a world of 2: a pool of 40 slots with 5
    valid pixels; the padding's poisoned pixel is never trained on, and a
    pool smaller than the batch raises."""
    mesh = sharding.make_mesh()
    cfg, rcfg = _cfgs(n_rays=32)
    net = _net()
    loss_fn = tst.make_loss_fn(net, cfg, rcfg, 1, True, True, mesh)
    pool = 40
    vi = torch.cat([torch.arange(5), torch.full((pool - 5,), H * W - 1)])
    img = torch.full((H * W, 3), 0.3)
    img[H * W - 1] = float("nan")
    loss, _ = loss_fn(torch.eye(4), img, vi, torch.tensor(5),
                      generator=torch.Generator().manual_seed(3))
    try:
        loss_fn(torch.eye(4), img, torch.zeros(8, dtype=torch.long), torch.tensor(5),
                generator=torch.Generator().manual_seed(3))
        raised = ""
    except ValueError as e:
        raised = str(e)
    return float(loss.detach()), raised


def test_without_replacement_short_pool_never_trains_padding():
    out = run_world(_world_short_pool, 2)
    for loss, raised in out.values():
        assert np.isfinite(loss), "padding pixel index was trained on"
        assert "pool" in raised


def _world_mesh_layout(rank, world):
    mesh = sharding.make_mesh_2d(2, 2)
    try:
        sharding.make_mesh(3)
        wrong = ""
    except ValueError as e:
        wrong = str(e)
    t = torch.tensor([float(rank)])
    sharding.all_reduce_sum(t, mesh.data_group)
    u = torch.tensor([float(rank)])
    sharding.all_reduce_sum(u, mesh.model_group)
    rows = sharding.row_shard(torch.arange(8.0)[:, None], mesh)
    return (mesh.data_rank, mesh.model_rank, float(t), float(u), rows[:, 0].tolist(), wrong,
            str(mesh.device))


def test_mesh_layout_is_the_jax_layout():
    """rank = d * n_model + m (make_mesh_2d's reshape); `data` groups share
    the model coordinate, `model` groups the data one; make_mesh(n) must
    name the world's size."""
    out = run_world(_world_mesh_layout, 4)
    for rank, (d, m, data_sum, model_sum, rows, wrong, dev) in out.items():
        assert (d, m) == divmod(rank, 2)
        assert data_sum == m + (2 + m)  # ranks m and 2 + m
        assert model_sum == 2 * d + (2 * d + 1)
        assert rows == [4.0 * m + i for i in range(4)]
        assert "3" in wrong and "4 ranks" in wrong
        assert dev == "cpu"


def test_sharded_factories_take_the_jax_arguments():
    """make_sharded_train_step / make_sharded_epoch_step keep the JAX names
    and argument order, and take every feature argument of the one-rank
    builders (tests/test_parallel.py:214-218)."""
    from lidarnerf_tpu.parallel import sharding as shj

    for name in ("make_sharded_train_step", "make_sharded_epoch_step"):
        jax_params = list(inspect.signature(getattr(shj, name)).parameters)
        port = list(inspect.signature(getattr(sharding, name)).parameters)
        assert port[1:len(jax_params)] == jax_params[1:]
    single = set(inspect.signature(tst.make_train_step).parameters)
    sharded = set(inspect.signature(sharding.make_sharded_train_step).parameters)
    assert single - {"model", "cfg", "render_cfg", "device", "mesh"} <= sharded
    for name in ("make_mesh", "make_mesh_2d", "shard_params"):
        assert callable(getattr(sharding, name))


# ------------------------------------------------------------ the trainer


def _train_opt(**kw):
    return SimpleNamespace(**{**dict(
        alpha_d=1e3, alpha_r=1.0, alpha_i=1.0, alpha_grad_norm=1.0, alpha_spatial=0.1,
        alpha_tv=1.0, alpha_grad=100.0, depth_loss="l1", depth_grad_loss="l1",
        intensity_loss="mse", raydrop_loss="mse", spatial_smooth=False, grad_norm_smooth=False,
        tv_loss=False, grad_loss=False, sobel_grad=False, scale=0.05, num_rays_lidar=32,
        H_lidar=H, W_lidar=W, intrinsics_lidar=(10.0, 30.0), lr=1e-2, iters=100, num_steps=16,
        upsample_steps=4, min_near_lidar=0.05, min_near=0.05, bound=1.0, seed=0,
        max_ray_batch=64, patch_size_lidar=1, change_patch_size_lidar=[1, 1],
        change_patch_size_epoch=2, dataloader="kitti360"), **kw})


class _Data:
    def __init__(self, n=3):
        self.poses_lidar, self.images_lidar = _scene(n)
        self.H_lidar, self.W_lidar, self.intrinsics_lidar = H, W, (10.0, 30.0)

    def __len__(self):
        return len(self.poses_lidar)

    def device_arrays(self, device):
        return (torch.from_numpy(self.poses_lidar).to(device),
                torch.from_numpy(self.images_lidar).to(device))


def _trainer_run(rank, world, workspace, dp, fmt="pickle", n_rays=32):
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    tr = Trainer("dp", _train_opt(data_parallel=dp, num_rays_lidar=n_rays), _net(),
                 device="cpu", mute=True, workspace=workspace, ema_decay=0.95,
                 use_checkpoint="scratch", use_tensorboardX=False, ckpt_format=fmt)
    tr.train(_Data(), _Data(1), max_epochs=2)
    out = ({k: v.numpy().copy() for k, v in tr.model.state_dict().items()},
           list(tr.stats["step_loss"]), tr.mesh is not None and tr.mesh.n_data)
    tr.close()
    return out


def test_trainer_world_of_two_matches_one_rank(tmp_path):
    """data_parallel=True over a world of 2 (tests/test_parallel.py:156):
    the per-step losses and weights of one rank's run, the same bits on
    both ranks; rank 0 alone writes the workspace (log, checkpoints,
    validation)."""
    out = run_world(_trainer_run, 2, str(tmp_path / "ws"), True)
    ref = _trainer_run(0, 1, str(tmp_path / "one"), False)
    for rank, (sd, losses, n) in out.items():
        assert n == 2
        for k in sd:
            np.testing.assert_array_equal(sd[k], out[0][0][k], err_msg=k)
        np.testing.assert_allclose(losses, ref[1], rtol=LOSS_RTOL)
        for k, v in ref[0].items():
            np.testing.assert_allclose(sd[k], v, err_msg=k, **PARAM_TOL)
    ws = tmp_path / "ws"
    assert sorted(p.name for p in ws.iterdir()) == ["checkpoints", "log_dp.txt", "validation"]
    assert sorted(p.name for p in (ws / "checkpoints").iterdir()) == [
        "dp.ckpt", "dp_ep0001.ckpt", "dp_ep0002.ckpt"]
    assert "data-parallel over 2 ranks" in (ws / "log_dp.txt").read_text()


def _trainer_indivisible(rank, world):
    try:
        _trainer_run(rank, world, None, True, n_rays=33)
    except ValueError as e:
        return str(e)
    return ""


def test_trainer_raises_on_an_indivisible_ray_count():
    """The JAX trainer shrinks its device count until it divides
    num_rays_lidar (trainer.py:243-244); a torch world cannot shrink, so the
    port raises and names both numbers."""
    for msg in run_world(_trainer_indivisible, 2).values():
        assert "num_rays_lidar=33" in msg and "2 ranks" in msg


def test_trainer_auto_stays_on_one_device_without_torchrun(monkeypatch):
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tr = Trainer("dp", _train_opt(), _net(), device="cpu", mute=True, workspace=None)
    assert tr.mesh is None and tr.writer_rank
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert Trainer("dp", _train_opt(), _net(), device="cpu", mute=True,
                   workspace=None).mesh is None


# ------------------------------------------------------------ checkpoints


def test_orbax_format_round_trip(tmp_path):
    """--ckpt_format orbax: a directory with meta.pkl and a
    torch.distributed.checkpoint store; a resumed trainer holds the saved
    weights, EMA, Adam state and counters bit for bit; probe, remove and
    the crash-safe .old rename work on directories."""
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    ws = str(tmp_path / "ws")
    _trainer_run(0, 1, ws, False, fmt="orbax")
    ck = tmp_path / "ws" / "checkpoints"
    assert sorted(p.name for p in ck.iterdir()) == ["dp.ckpt", "dp_ep0001.ckpt", "dp_ep0002.ckpt"]
    latest = ck / "dp_ep0002.ckpt"
    assert latest.is_dir() and (latest / "meta.pkl").is_file()
    assert (latest / "arrays" / ".metadata").is_file()
    assert checkpoint_io.probe(str(latest))
    state = checkpoint_io.load_state(str(latest))
    tr = Trainer("dp", _train_opt(), _net(seed=1), device="cpu", mute=True, workspace=ws,
                 ema_decay=0.95, use_tensorboardX=False, ckpt_format="orbax")
    assert tr.epoch == 2 and tr.global_step == 6
    from lidarnerf_tpu_torch.utils.params import optimizer_to_jax, params_to_jax

    for got, want in ((params_to_jax(tr.model.state_dict()), state["model"]),
                      (params_to_jax(tr.ema_params), state["ema"])):
        for k, v in want["params"].items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(got["params"][k][kk]["kernel"],
                                                  vv["kernel"])
            else:
                np.testing.assert_array_equal(got["params"][k], v)
    opt = optimizer_to_jax(tr.optimizer.state_dict())
    flat_a, flat_b = [], []

    def leaves(t, acc):
        if isinstance(t, dict):
            for v in t.values():
                leaves(v, acc)
        elif isinstance(t, (list, tuple)):
            for v in t:
                leaves(v, acc)
        else:
            acc.append(np.asarray(t))

    leaves(opt, flat_a)
    leaves(state["optimizer"], flat_b)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # a crash between the renames of an overwrite leaves path.old readable
    os.replace(latest, str(latest) + ".old")
    assert checkpoint_io.load_state(str(latest))["epoch"] == 2
    checkpoint_io.remove(str(latest) + ".old")
    assert not os.path.exists(str(latest) + ".old")
    assert checkpoint_io.size_bytes(str(ck / "dp.ckpt")) > 0


def _world_sharded_save(rank, world, path):
    from torch.distributed.tensor import DTensor, Shard

    mesh = sharding.make_mesh_2d(1, 2)
    net = _net()
    full = net.hash_table.detach().clone()
    sharding.shard_params(net, mesh)
    table = DTensor.from_local(net.hash_table.detach(), mesh.device_mesh()["model"], [Shard(0)])
    state = {"model": {"params": {"hash_table": table}}, "epoch": 3,
             "optimizer": (np.int32(4), [np.ones(3, np.float32)])}
    t0 = time.perf_counter()
    checkpoint_io.dump_state(state, path, "orbax")
    return full.numpy(), time.perf_counter() - t0


def test_orbax_format_writes_row_shards_from_each_rank(tmp_path):
    """A table row-sharded over a (1, 2) mesh, given as a DTensor, is written
    by both ranks, each its rows (one store file per rank), and loads whole."""
    path = str(tmp_path / "s.ckpt")
    out = run_world(_world_sharded_save, 2, path)
    files = sorted(p for p in os.listdir(os.path.join(path, "arrays")) if p.endswith(".distcp"))
    assert files == ["__0_0.distcp", "__1_0.distcp"]
    state = checkpoint_io.load_state(path)
    np.testing.assert_array_equal(state["model"]["params"]["hash_table"], out[0][0])
    assert state["epoch"] == 3 and int(state["optimizer"][0]) == 4
    np.testing.assert_array_equal(state["optimizer"][1][0], np.ones(3, np.float32))


def test_jax_orbax_directory_raises_naming_pickle(tmp_path):
    """A JAX-written orbax directory (orbax is a JAX library, absent where
    the port runs) raises and names --ckpt_format pickle; probe says no, so
    the trainer's resume walks past it."""
    import jax.numpy as jnp

    from lidarnerf_tpu.utils import checkpoint_io as cio_j

    path = str(tmp_path / "j.ckpt")
    cio_j.dump_state({"model": {"params": {"hash_table": jnp.ones((4, 128))}}, "epoch": 1},
                     path, "orbax")
    assert os.path.isdir(path) and cio_j.load_state(path)["epoch"] == 1
    with pytest.raises(NotImplementedError, match="--ckpt_format pickle"):
        checkpoint_io.load_state(path)
    assert not checkpoint_io.probe(path)
    empty = tmp_path / "empty.ckpt"
    empty.mkdir()
    with pytest.raises(NotImplementedError, match="--ckpt_format pickle"):
        checkpoint_io.load_state(str(empty))
