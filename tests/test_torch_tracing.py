"""The port's spans and counters (`lidarnerf_tpu_torch/utils/tracing.py`).

Off (no profile recording), `span()` is one shared no-op and no counter
adds. While a CPU profile records, spans nest in its trace and counters add;
a profiled pano holds the program's spans around the aten operations they
launch, a profiled `--fast` epoch holds one `occ.refresh` for each refresh
that `before_step`'s rule makes, and tracing changes no output bit.
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.occupancy import OccConfig, init_occ_grid
from lidarnerf_tpu_torch.models.renderer import RenderConfig
from lidarnerf_tpu_torch.nerf import train_step
from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
from lidarnerf_tpu_torch.utils import tracing
from lidarnerf_tpu_torch.utils.params import params_to_jax

H, W, CHUNK = 4, 40, 64  # 160 rays: 3 chunks, the last one padded by 32
INTRINSICS = (2.0, 26.9)
SCALE = 0.01
NET = dict(encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, hidden_dim=8)
OCC = OccConfig(grid_size=16, bins=16, update_interval=2)
K = 5  # steps in the epoch


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (tiny tensors; every comparison is between runs
    made under this one setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn, tmp_path):
    """fn() under a CPU profile: (its result, the exported trace's complete
    events, the program's spans among them by name)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(e)
    return out, events, spans


def _net(seed=0):
    torch.manual_seed(seed)
    return NeRFNetwork(**NET)


@pytest.fixture(scope="module")
def renderer():
    opt = SimpleNamespace(
        encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, num_layers=2,
        hidden_dim=8, geo_feat_dim=15, bound=1.0, scale=SCALE, num_steps=16, upsample_steps=4,
        max_ray_batch=CHUNK, fp16=False, alpha_r=1.0)
    return PanoRenderer(opt, params_to_jax(_net().state_dict()), device="cpu")


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.05, -0.02, 0.01)
    return pose


def test_off_a_span_is_one_shared_noop_and_nothing_is_kept(renderer):
    assert tracing.span("pano.frame") is tracing.span("render.field")
    before = tracing.counters()
    renderer.render_frame(_pose(), H, W, INTRINSICS)
    tracing.count("pano.rays_rendered")
    assert tracing.counters() == before


def _nest():
    with tracing.span("a"):
        with tracing.span("b"):
            tracing.count("test.n", 2)
        with tracing.span("c"):
            tracing.count("test.n")


@pytest.mark.parametrize("when", ["during", "after"])
def test_a_profile_turns_spans_and_counters_on_while_it_records(when, tmp_path):
    before = tracing.counters().get("test.n", 0)
    if when == "during":
        _, _, spans = _profiled(_nest, tmp_path)
        (a,), (b,), (c,) = spans["a"], spans["b"], spans["c"]
        assert _inside(b, a) and _inside(c, a) and b["ts"] + b["dur"] <= c["ts"]
        assert tracing.counters()["test.n"] == before + 3
    else:
        _profiled(lambda: None, tmp_path)
        assert tracing.span("a") is tracing.span("b")
        _nest()
        assert tracing.counters().get("test.n", 0) == before


def _inside(x, y):
    return y["ts"] <= x["ts"] and x["ts"] + x["dur"] <= y["ts"] + y["dur"]


def test_a_profiled_pano_nests_frame_chunk_field_and_the_aten_ops(renderer, tmp_path):
    before = tracing.counters()
    _, events, spans = _profiled(lambda: renderer.render_frame(_pose(), H, W, INTRINSICS),
                                 tmp_path)
    n_chunks = math.ceil(H * W / CHUNK)
    (frame,) = spans["pano.frame"]
    assert len(spans["pano.chunk"]) == n_chunks
    assert all(_inside(c, frame) for c in spans["pano.chunk"])
    for name in ("render.sample", "render.field", "render.composite"):
        assert all(any(_inside(s, c) for c in spans["pano.chunk"]) for s in spans[name])
    for name in ("pano.rays", "pano.gather", "pano.to_host"):
        assert spans[name] and all(_inside(s, frame) for s in spans[name])
    # the chunks' matmuls are the network's (the rays' rotation runs in pano.rays)
    mms = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"
           and any(_inside(e, c) for c in spans["pano.chunk"])]
    assert mms and all(any(_inside(a, f) for f in spans["render.field"]) for a in mms)
    after = tracing.counters()
    assert {k: after[k] - before.get(k, 0) for k in ("pano.rays_rendered", "pano.rays_padded")} == {
        "pano.rays_rendered": n_chunks * CHUNK, "pano.rays_padded": n_chunks * CHUNK - H * W}


def _scene(n_frames=2):
    rs = np.random.RandomState(0)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n_frames)
    poses[:, :3, 3] = rs.uniform(-0.05, 0.05, (n_frames, 3))
    depth = rs.uniform(5.0, 60.0, (n_frames, H, W))
    raydrop = (rs.uniform(size=(n_frames, H, W)) < 0.85).astype(np.float32)
    images = np.stack([raydrop, rs.uniform(size=(n_frames, H, W)) * raydrop,
                       depth * raydrop * SCALE], -1).astype(np.float32)
    return (torch.from_numpy(poses), torch.from_numpy(images),
            torch.zeros((n_frames, 1), dtype=torch.long), torch.full((n_frames,), H * W))


def _fast_epoch(step0):
    """A fresh net, grid and generator through one eager `--fast` epoch of K
    steps from global step `step0`; returns (metrics, parameters, grid)."""
    net = _net(1)
    tcfg = train_step.TrainConfig(scale=SCALE, num_rays_lidar=32, H_lidar=H, W_lidar=W)
    rcfg = RenderConfig(num_steps=16, upsample_steps=4, min_near_lidar=SCALE, min_near=SCALE,
                        occ=OCC)
    epoch = train_step.make_epoch_step(net, tcfg, rcfg, device="cpu")
    grid = init_occ_grid(OCC)
    m = epoch(*_scene(), np.array([0, 1, 1, 0, 1]), step0,
              generator=torch.Generator().manual_seed(3), occ_grid=grid)
    return m, [p.detach().clone() for p in net.parameters()], grid


@pytest.mark.parametrize("step0", [0, 3])
def test_an_eager_fast_epoch_counts_its_refreshes_by_before_steps_rule(step0, tmp_path):
    _, _, spans = _profiled(lambda: _fast_epoch(step0), tmp_path)
    refreshes = sum((step0 + i) % OCC.update_interval == 0 for i in range(K))
    (epoch,) = spans["train.epoch"]
    assert len(spans["occ.refresh"]) == refreshes
    assert all(_inside(r, epoch) for r in spans["occ.refresh"])
    assert "train.replay" not in spans and "train.capture" not in spans


@pytest.mark.parametrize("path", ["pano", "epoch"])
def test_tracing_changes_no_output_bit(path, renderer, tmp_path):
    def run():
        if path == "pano":
            return list(renderer.render_frame(_pose(), H, W, INTRINSICS))
        m, params, grid = _fast_epoch(0)
        return [v.numpy() for v in m.values()] + [p.numpy() for p in params] + [grid.numpy()]

    off = run()
    on, _, spans = _profiled(run, tmp_path)
    assert spans
    assert len(off) == len(on) and all(np.array_equal(a, b) for a, b in zip(off, on))
