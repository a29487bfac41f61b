"""Port parity for the benchmark drivers: `lidarnerf_tpu_torch/bench.py` against
the repo's bench.py and `lidarnerf_tpu_torch/tools/bench_render.py` against
tools/bench_render.py.

Both packages' drivers run with their step or renderer replaced by a
recorder (the JAX `make_train_step` and `render_rays_staged`; the port's
counterparts `make_epoch_step` and `render_rays_staged`), so nothing of the
flagship model runs on the CPU: the tests hold the schedule of calls (patch
size, frame, step index), the synthetic images bit for bit, the rays at the
renderer tests' tolerance, the configs' fields, the chunk and the printed
JSON line's keys, metric and unit.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidarnerf_tpu_torch import bench
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.nerf import train_step
from lidarnerf_tpu_torch.ops.block_hash import make_block_hash_spec
from lidarnerf_tpu_torch.tools import bench_render

REPO = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


def _fields(cfg, skip=()):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in skip}


def _same_model(model, module_j):
    """The port's flagship model is the JAX module's: encoding, bound, block-hash
    spec (levels, resolutions, table) and bf16 compute."""
    assert model.encoding == module_j.encoding == "blockhash"
    assert model.bound == module_j.bound
    assert model.block_spec == make_block_hash_spec(
        num_levels=module_j.num_levels, base_resolution=module_j.base_resolution,
        log2_hashmap_size=module_j.log2_hashmap_size,
        desired_resolution=module_j.desired_resolution)
    assert model.sigma_net.compute_dtype == torch.bfloat16
    assert module_j.compute_dtype == jnp.bfloat16


@pytest.fixture(scope="module")
def jax_bench_calls():
    """The JAX bench's step calls, its configs and its JSON line."""
    import lidarnerf_tpu.nerf.train_step as jts

    mp = pytest.MonkeyPatch()
    calls, made = [], []

    def make_train_step(module, tcfg, rcfg, patch_size=1, **kw):
        made.append((module, tcfg, rcfg, patch_size))

        def step(params, opt_state, poses, images, vi, vc, frame, key, i):
            calls.append((patch_size, int(frame), int(i), np.asarray(images), np.asarray(poses),
                          np.asarray(vc)))
            return params, opt_state, {"loss": jnp.float32(1.0)}

        return step

    mp.setattr(jts, "make_train_step", make_train_step)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _load("jax_bench", "bench.py").main()
    finally:
        mp.undo()
    return calls, made, _json_line(out.getvalue())


def test_bench_schedule_data_and_configs_match_jax(jax_bench_calls, monkeypatch, capsys):
    calls_j, made_j, line_j = jax_bench_calls
    calls, made = [], []

    def make_epoch_step(model, tcfg, rcfg, patch_size=1, optimizer=None, device=None,
                        capture=True, graph_pool=None, **kw):
        made.append((model, tcfg, rcfg, patch_size, optimizer, torch.device(device)))

        def epoch_fn(poses, images, vi, vc, order, step0=0, generator=None, **kw):
            assert len(order) == 1 and isinstance(generator, torch.Generator)
            calls.append((patch_size, int(order[0]), step0, images.numpy(), poses.numpy(),
                          vc.numpy()))
            return {k: torch.ones(1) for k in train_step.METRICS}

        return epoch_fn

    monkeypatch.setattr(train_step, "make_epoch_step", make_epoch_step)
    result, losses = bench.main(device="cpu")
    line = _json_line(capsys.readouterr().out)
    assert losses.tolist() == [1.0] * (bench.WARMUP + bench.TIMED)

    # 3 warm-up + 30 timed steps: (patch size, frame, step index) as the JAX bench's
    assert len(calls) == len(calls_j) == bench.WARMUP + bench.TIMED
    assert [(c[0], c[1], c[2]) for c in calls] == [(c[0], c[1], c[2]) for c in calls_j]
    for c, c_j in zip(calls, calls_j):
        np.testing.assert_array_equal(c[3], c_j[3])  # the images, bit for bit
        np.testing.assert_array_equal(c[4], c_j[4])
        np.testing.assert_array_equal(c[5], c_j[5])
    assert calls[0][3].dtype == np.float32 and calls[0][3].shape == (4, 66, 1030, 3)

    # one epoch function per patch size, both on one DeviceAdam, and the configs' fields
    assert [m[3] for m in made] == [m[3] for m in made_j] == [1, [2, 8]]
    assert made[0][4] is made[1][4] and made[0][5] == torch.device("cpu")
    model, tcfg, rcfg = made[0][:3]
    model_j, tcfg_j, rcfg_j = made_j[0][:3]
    # the JAX TrainConfig also carries the trainer's ema_decay, which its step never reads
    fields, fields_j = _fields(tcfg), _fields(tcfg_j)
    assert set(fields_j) - set(fields) == {"ema_decay"}
    assert fields == {k: fields_j[k] for k in fields}
    assert _fields(rcfg, skip=("occ",)) == _fields(rcfg_j, skip=("occ",))
    assert rcfg.occ is None
    _same_model(model, model_j)

    # the JSON line: the same keys, metric and unit
    assert line == result
    assert line.keys() == line_j.keys()
    assert line["metric"] == line_j["metric"] == "composited_ray_samples_per_sec_per_chip"
    assert line["unit"] == line_j["unit"]
    assert line["vs_baseline"] == round(line["value"] / 5e6, 3)


def test_bench_render_rays_config_and_chunk_match_jax(monkeypatch, capsys):
    jax_tool = _load("jax_bench_render", "tools/bench_render.py")
    calls_j = []

    def staged_j(module, params, ro, rd, cfg, chunk):
        calls_j.append((np.asarray(ro), np.asarray(rd), cfg, chunk, module))
        return {"depth": jnp.zeros(ro.shape[0])}

    monkeypatch.setattr(jax_tool, "render_rays_staged", staged_j)
    jax_tool.main()
    line_j = _json_line(capsys.readouterr().out)

    calls = []

    def staged(model, ro, rd, cfg, chunk=4096, occ_grid=None):
        calls.append((ro.numpy(), rd.numpy(), cfg, chunk, model, occ_grid))
        return {"depth": torch.zeros(ro.shape[0])}

    monkeypatch.setattr(bench_render, "render_rays_staged", staged)
    result = bench_render.main(device="cpu")
    line = _json_line(capsys.readouterr().out)

    # one warm-up frame and 5 timed, each the whole pano at chunk 8192
    assert len(calls) == len(calls_j) == 1 + bench_render.FRAMES
    for (ro, rd, cfg, chunk, model, occ), (ro_j, rd_j, cfg_j, chunk_j, module_j) in zip(
            calls, calls_j):
        assert chunk == chunk_j == 8192 and occ is None
        assert ro.shape == ro_j.shape == (66 * 1030, 3)
        np.testing.assert_array_equal(ro, ro_j)
        # the renderer tests' tolerance: float32 trig of two libms, then a rotation
        np.testing.assert_allclose(rd, rd_j, rtol=0, atol=1e-6)
        assert _fields(cfg, skip=("occ",)) == _fields(cfg_j, skip=("occ",))
        _same_model(model, module_j)
        assert not model.training

    assert line == result
    assert line.keys() == line_j.keys()
    assert line["metric"] == line_j["metric"] == "pano_fps"
    assert line["unit"] == line_j["unit"]
    assert line["vs_baseline"] == round(line["value"] / 10.0, 3)


def test_bench_steps_alternate_on_one_optimizer_on_the_cpu(monkeypatch):
    """The bench's real (eager) epoch functions at a tiny model and pano: the
    two patch sizes alternate on one DeviceAdam, whose count and schedule
    count advance once a step, and the losses come back finite."""
    tcfg, rcfg = bench.configs()
    monkeypatch.setattr(bench, "H", 8)
    monkeypatch.setattr(bench, "W", 32)
    monkeypatch.setattr(bench, "configs", lambda: (
        dataclasses.replace(tcfg, num_rays_lidar=64, H_lidar=8, W_lidar=32),
        dataclasses.replace(rcfg, num_steps=8, upsample_steps=4)))
    monkeypatch.setattr(bench, "flagship", lambda seed=0: NeRFNetwork(
        encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, num_levels=4,
        hidden_dim=16, generator=torch.Generator().manual_seed(seed)))
    b = bench.Bench(device="cpu")
    assert b.images.shape == (4, 8, 32, 3)
    losses = b.run(4)
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    assert int(b.optimizer.count) == 4 and int(b.optimizer.schedule_count) == 4
