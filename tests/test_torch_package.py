"""Guards of the lidarnerf_tpu_torch package: no JAX, no silent CPU, no CUDA fallback."""

import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lidarnerf_tpu_torch
from lidarnerf_tpu_torch.models.renderer import RenderConfig
from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
from lidarnerf_tpu_torch.nerf.train_step import TrainConfig, make_train_step
from lidarnerf_tpu_torch.nerf.trainer import Trainer
from lidarnerf_tpu_torch.ops import (
    block_hash,
    block_hash_cuda,
    cuda_lib,
    dispatch,
    fused_mlp,
    fused_mlp_cuda,
    occ_lookup,
    occ_lookup_cuda,
    perm_gather_cuda,
    sampling,
)
from lidarnerf_tpu_torch.utils.params import load_jax_checkpoint, params_to_jax
from lidarnerf_tpu_torch.models.network import NeRFNetwork

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lidarnerf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "lidarnerf_tpu")]
print(json.dumps({"names": names, "bad": bad}))
"""
_IMPORT_ALL = "import json\n" + _IMPORT_ALL

# the root drivers' counterparts (bench.py, __graft_entry__.py, tools/bench_render.py,
# tools/ab_run.py, tools/full_run.py, tools/protocol_report.py)
DRIVERS = ["lidarnerf_tpu_torch.bench", "lidarnerf_tpu_torch.graft_entry",
           "lidarnerf_tpu_torch.tools.bench_render", "lidarnerf_tpu_torch.tools.ab_run",
           "lidarnerf_tpu_torch.tools.full_run", "lidarnerf_tpu_torch.tools.protocol_report"]


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = json.loads(subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip().splitlines()[-1])
    assert len(out["names"]) >= 15  # every module of the package was imported
    assert set(DRIVERS) <= set(out["names"])  # the drivers among them
    assert out["bad"] == []


def _tiny_opt():
    return SimpleNamespace(
        encoding="blockhash", desired_resolution=64, log2_hashmap_size=10,
        num_layers=2, hidden_dim=8, geo_feat_dim=15, bound=1.0, scale=0.01,
        num_steps=8, upsample_steps=4, max_ray_batch=16, fp16=False, alpha_r=1.0,
    )


def test_entry_points_do_not_default_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = _tiny_opt()
    params = params_to_jax(
        NeRFNetwork(encoding="blockhash", desired_resolution=64, log2_hashmap_size=10,
                    hidden_dim=8).state_dict()
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PanoRenderer(opt, params)
    net = NeRFNetwork(encoding="blockhash", desired_resolution=64, log2_hashmap_size=10,
                      hidden_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(net, TrainConfig(), RenderConfig())
    train_opt = SimpleNamespace(
        alpha_d=1e3, alpha_r=1.0, alpha_i=1.0, alpha_grad_norm=1.0, alpha_spatial=0.1,
        alpha_tv=1.0, alpha_grad=100.0, depth_loss="l1", depth_grad_loss="l1",
        intensity_loss="mse", raydrop_loss="mse", spatial_smooth=False, grad_norm_smooth=False,
        tv_loss=False, grad_loss=False, sobel_grad=False, scale=0.01, num_rays_lidar=16,
        lr=1e-2, iters=100, num_steps=8, upsample_steps=4, min_near_lidar=0.01, min_near=0.01,
        bound=1.0,
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer("t", train_opt, net, workspace=None)
    assert Trainer("t", train_opt, net, device="cpu", mute=True,
                   workspace=None).device.type == "cpu"
    # asked for explicitly, the CPU runs
    r = PanoRenderer(opt, params, device="cpu")
    raydrop, intensity, depth = r.render_frame(np.eye(4), 2, 8, (2.0, 26.9))
    assert raydrop.shape == intensity.shape == depth.shape == (2, 8)


def test_cuda_table_gradient_not_ported_and_no_fallback(monkeypatch):
    """The table gradient on the kernel path goes through the kernel wrappers
    (B1 forward, B2 backward) and never falls back to the plain versions.

    Checked through a monkeypatched kernel choice, so it runs without a GPU:
    the wrappers take CUDA tensors only and raise on the CPU tensors here.
    """
    spec = block_hash.make_block_hash_spec(num_levels=2, log2_hashmap_size=10,
                                           desired_resolution=64)
    x = torch.rand(10, 3)
    table = torch.zeros(spec.table_rows, 128, requires_grad=True)
    fwd0, bwd0 = block_hash_cuda.launches, block_hash_cuda.bwd_launches
    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: True)
    with pytest.raises(ValueError, match="block_hash_fwd takes CUDA tensors"):
        block_hash.block_hash_encode(x, table, spec)
    with torch.no_grad(), pytest.raises(ValueError, match="block_hash_fwd takes CUDA tensors"):
        block_hash.block_hash_encode(x, table, spec)
    # a forward on the plain path, then a backward on the kernel path: the
    # backward goes to B2's wrapper
    kernel_path = iter([False, True])
    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: next(kernel_path))
    out = block_hash.block_hash_encode(x, table, spec)
    with pytest.raises(ValueError, match="block_hash_bwd takes CUDA tensors"):
        out.sum().backward()
    assert table.grad is None
    assert (block_hash_cuda.launches, block_hash_cuda.bwd_launches) == (fwd0, bwd0)


def test_kernel_wrapper_rejects_cpu_tensors():
    spec = block_hash.make_block_hash_spec(num_levels=2, log2_hashmap_size=10)
    before = block_hash_cuda.launch_counts()
    for variant in block_hash.VARIANTS:  # all six wrappers
        with pytest.raises(ValueError, match="CUDA tensors"):
            block_hash_cuda.FWD[variant](torch.rand(4, 3), torch.zeros(spec.table_rows, 128), spec)
        with pytest.raises(ValueError, match="CUDA tensors"):
            block_hash_cuda.BWD[variant](torch.rand(4, 3), torch.zeros(4, spec.output_dim), spec)
    assert block_hash_cuda.launch_counts() == before


def test_kernel_source_and_build_naming(tmp_path, monkeypatch):
    header = (cuda_lib.CSRC_DIR / block_hash_cuda.HEADER).read_text()
    assert int(re.search(r"#define MAX_LEVELS (\d+)", header).group(1)) == block_hash_cuda.MAX_LEVELS
    # the run structure of the plain versions holds in the kernels' tiles:
    # every tile starts at a multiple of 32 queries and within one 4096-query
    # chunk, so no run crosses a chunk and every window is a slice of a group
    threads = int(re.search(r"#define THREADS (\d+)", header).group(1))
    assert threads % 32 == 0 and block_hash.CHUNK % threads == 0
    for source, macro in (("block_hash_seg_fwd.cu", "SEG_GROUPS"), ("block_hash_win_fwd.cu", "WIN_GROUPS")):
        src = (cuda_lib.CSRC_DIR / source).read_text()
        assert block_hash.CHUNK % (32 * int(re.search(rf"#define {macro} (\d+)", src).group(1))) == 0
    assert all(32 % w == 0 for w in block_hash.WIN_BIT)
    names = ("block_hash_fwd", "block_hash_bwd", "block_hash_seg_fwd", "block_hash_seg_bwd",
             "block_hash_win_fwd", "block_hash_win_bwd")
    assert len(block_hash_cuda.SOURCES) == len(names)
    assert set(block_hash_cuda.launch_counts()) == set(names)
    for source, name in zip(block_hash_cuda.SOURCES, names):
        src = (cuda_lib.CSRC_DIR / source).read_text()
        assert source == f"{name}.cu" and f'extern "C" int {name}(' in src
        assert re.search(r'#include "block_hash_(common|seg)\.cuh"', src)
        lib = cuda_lib.library_path(source)
        assert lib.parent == cuda_lib.BUILD_DIR and lib == cuda_lib.library_path(source)
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
    gitignore = (REPO / ".gitignore").read_text().split()
    assert "lidarnerf_tpu_torch/_build/" in gitignore
    # an edit of the shared header renames (so rebuilds) every kernel's library
    for f in cuda_lib.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", tmp_path)
    before = [cuda_lib.library_path(s) for s in block_hash_cuda.SOURCES]
    (tmp_path / block_hash_cuda.HEADER).write_text(header + "\n// edited\n")
    after = [cuda_lib.library_path(s) for s in block_hash_cuda.SOURCES]
    assert all(a != b for a, b in zip(after, before))


def test_b5_b6_kernel_paths_never_fall_back(monkeypatch):
    """On the kernel path fused_mlp goes to B5's wrapper and sort_merge_z to
    B6's, which take CUDA tensors only: they raise on the CPU tensors here
    instead of falling back to the plain chain or a gather."""
    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: True)
    counts = {**fused_mlp_cuda.launch_counts(), **perm_gather_cuda.launch_counts()}
    x, ws = torch.rand(6, 4), [torch.rand(4, 8), torch.rand(8, 2)]
    with pytest.raises(ValueError, match="fused_mlp_fwd takes CUDA tensors"):
        fused_mlp.fused_mlp(x, ws)
    zc, zf = torch.rand(3, 5).sort(1).values, torch.rand(3, 2).sort(1).values
    with pytest.raises(ValueError, match="perm_gather_fwd takes CUDA tensors"):
        sampling.sort_merge_z(zc, zf, (torch.rand(3, 5), torch.rand(3, 2)))
    assert {**fused_mlp_cuda.launch_counts(), **perm_gather_cuda.launch_counts()} == counts


def test_b5_b6_sources_and_build_naming():
    """B5 and B6 have one source each, built like the block-hash kernels into
    the git-ignored build directory, and are not among the block-hash sources."""
    for module, name in ((fused_mlp_cuda, "fused_mlp"), (perm_gather_cuda, "perm_gather")):
        assert module.SOURCE == f"{name}.cu" and module.SOURCE not in block_hash_cuda.SOURCES
        src = (cuda_lib.CSRC_DIR / module.SOURCE).read_text()
        assert f'extern "C" int {name}(' in src and "lidarnerf_tpu/ops/" in src
        # the limit is the source's or a header's it includes (B5's plan header)
        src += "".join((cuda_lib.CSRC_DIR / h).read_text()
                       for h in re.findall(r'#include "(\w+\.cuh)"', src))
        assert int(re.search(r"#define SMEM_LIMIT (\d+)", src).group(1)) == module.SMEM_LIMIT
        assert cuda_lib.library_path(module.SOURCE).parent == cuda_lib.BUILD_DIR


def test_checkpoint_with_jax_objects_is_refused(tmp_path):
    ckpt = tmp_path / "jax.ckpt"
    ckpt.write_bytes(pickle.dumps({"model": {"params": {"hash_table": jnp.zeros((2, 128))}}}))
    with pytest.raises(ValueError, match=r"jax\S*\.\S+ object"):
        load_jax_checkpoint(ckpt)
    (tmp_path / "orbax.ckpt").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        load_jax_checkpoint(tmp_path / "orbax.ckpt")
    assert lidarnerf_tpu_torch.__version__


def test_occ_lookup_wrapper_rejects_cpu_tensors(monkeypatch):
    """P12's wrapper takes CUDA tensors only, and the entry point on the
    kernel path goes to it: it raises on the CPU tensors here instead of
    falling back to the plain version or torch.take."""
    idx, grid = torch.zeros(8, dtype=torch.int32), torch.rand(4, 4, 4)
    before = occ_lookup_cuda.launch_counts()
    with pytest.raises(ValueError, match="occ_lookup takes CUDA tensors"):
        occ_lookup_cuda.occ_lookup(idx, grid)
    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: True)
    with pytest.raises(ValueError, match="occ_lookup takes CUDA tensors"):
        occ_lookup.occ_lookup(idx, grid)
    assert occ_lookup_cuda.launch_counts() == before


def test_occ_lookup_failed_load_raises(monkeypatch):
    """A kernel library that does not build or load makes the wrapper raise:
    no launch is counted and nothing falls back."""
    def failed(source):
        raise RuntimeError(f"kernel build failed:\n{source}: nvcc exited 1")

    monkeypatch.setattr(cuda_lib, "load", failed)
    monkeypatch.setattr(occ_lookup_cuda, "_fn", None)
    # stand-ins that pass the wrapper's checks as CUDA tensors would
    dev = torch.device("cuda", 0)
    idx = SimpleNamespace(is_cuda=True, device=dev, dtype=torch.int32, shape=(8,),
                          is_contiguous=lambda: True, numel=lambda: 8)
    grid = SimpleNamespace(is_cuda=True, device=dev, dtype=torch.float32, shape=(2, 2, 2),
                           is_contiguous=lambda: True, numel=lambda: 8)
    before = occ_lookup_cuda.launch_counts()
    with pytest.raises(RuntimeError, match="occ_lookup.cu: nvcc exited 1"):
        occ_lookup_cuda.occ_lookup(idx, grid)
    assert occ_lookup_cuda._fn is None and occ_lookup_cuda.launch_counts() == before


def test_occ_lookup_source_and_build_naming():
    """P12 has one source, built like the others into the git-ignored build
    directory under its own name, and names the TPU kernel it replaces."""
    assert occ_lookup_cuda.SOURCE == "occ_lookup.cu"
    src = (cuda_lib.CSRC_DIR / occ_lookup_cuda.SOURCE).read_text()
    assert 'extern "C" int occ_lookup(' in src and "tools/exp_occ_lookup.py::lookup_pallas" in src
    lib = cuda_lib.library_path(occ_lookup_cuda.SOURCE)
    assert lib.parent == cuda_lib.BUILD_DIR and lib.name.startswith("occ_lookup_")
    assert lib.suffix == ".so"
    assert occ_lookup_cuda.SOURCE not in block_hash_cuda.SOURCES
    assert set(occ_lookup_cuda.launch_counts()) == {"occ_lookup"}


# ------------------------------------------------ the subpackages' re-exports

SUBPACKAGES = ("ops", "models", "dataset", "parallel")


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(name):
    """Each subpackage re-exports the JAX subpackage's names, in its order."""
    import importlib

    jax_pkg = importlib.import_module(f"lidarnerf_tpu.{name}")
    port = importlib.import_module(f"lidarnerf_tpu_torch.{name}")
    assert port.__all__ == jax_pkg.__all__
    assert port.__doc__
    for attr in port.__all__:
        assert callable(getattr(port, attr)), attr


_IMPORT_STAR = """
import ctypes, pathlib, subprocess, sys
import torch
package = pathlib.Path("lidarnerf_tpu_torch").resolve()
build_dir, csrc_dir = package / "_build", package / "csrc"
calls = []
_cdll, _popen = ctypes.CDLL.__init__, subprocess.Popen.__init__
def cdll(self, name, *a, **k):
    calls.append(str(name))
    return _cdll(self, name, *a, **k)
def popen(self, args, *a, **k):
    calls.append(str(args))
    return _popen(self, args, *a, **k)
ctypes.CDLL.__init__, subprocess.Popen.__init__ = cdll, popen
assert not [m for m in sys.modules if m.startswith("lidarnerf_tpu_torch")]
before = set(build_dir.glob("*")) if build_dir.exists() else set()
names = {}
for sub in ("ops", "models", "dataset", "parallel"):
    ns = {}
    exec(f"from lidarnerf_tpu_torch.{sub} import *", ns)
    names[sub] = sorted(k for k in ns if not k.startswith("__"))
after = set(build_dir.glob("*")) if build_dir.exists() else set()
kernels = {p.stem for p in csrc_dir.glob("*.cu")}
new = sorted(p.name for p in after - before if any(p.name.startswith(k + "_") for k in kernels))
cuda_lib = sys.modules.get("lidarnerf_tpu_torch.ops.cuda_lib")  # None: not even imported
loaded = {} if cuda_lib is None else cuda_lib._loaded
print(repr((names, calls, sorted(map(str, loaded)), new)))
"""


def test_subpackage_star_imports_build_no_kernel():
    """`from lidarnerf_tpu_torch.<sub> import *` in a fresh process gives the
    JAX __all__s and neither builds nor loads a library: no compiler is
    started, no shared object is opened, cuda_lib has loaded nothing and no
    kernel library appears under _build/."""
    import ast
    import importlib

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_STAR], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    names, calls, loaded, new = ast.literal_eval(out.strip().splitlines()[-1])
    for sub in SUBPACKAGES:
        assert names[sub] == sorted(importlib.import_module(f"lidarnerf_tpu.{sub}").__all__)
    assert (calls, loaded, new) == ([], [], [])


@pytest.mark.parametrize("seed", range(4))
def test_nerf_matrix_to_ngp_equals_jax(seed):
    from lidarnerf_tpu.dataset.base import nerf_matrix_to_ngp as ref
    from lidarnerf_tpu_torch.dataset import nerf_matrix_to_ngp

    rs = np.random.RandomState(seed)
    pose = rs.normal(size=(4, 4)).astype(np.float32 if seed % 2 else np.float64)
    scale = float(rs.uniform(0.01, 2.0))
    offset = tuple(rs.uniform(-3, 3, 3).tolist()) if seed else (0, 0, 0)
    for args in ((pose,), (pose, scale), (pose, scale, offset)):
        out, want = nerf_matrix_to_ngp(*args), ref(*args)
        assert out.dtype == np.float32 and out.shape == (4, 4)
        np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


def test_replicate_and_shard_rays_in_a_world_of_one():
    """With no process group (one rank), both return their input."""
    from lidarnerf_tpu_torch.parallel import replicate, shard_rays
    from lidarnerf_tpu_torch.parallel.sharding import Mesh

    mesh = Mesh(1, 1, 0, 0, 0, torch.device("cpu"))
    t, rays = torch.rand(3, 4), torch.rand(10, 3)
    assert replicate(t, mesh) is t and replicate([t], mesh)[0] is t
    assert shard_rays(rays, mesh) is rays and shard_rays(rays, None) is rays


def _world_replicate_shard(rank, world):
    from lidarnerf_tpu_torch.parallel import make_mesh, replicate, shard_rays

    mesh = make_mesh()
    a, b = torch.full((3,), float(rank)), torch.full((2, 2), 10.0 + rank)
    replicate([a, b], mesh)
    c = replicate(torch.full((1,), float(rank + 5)), mesh)
    block = shard_rays(torch.arange(12.0)[:, None].expand(12, 2), mesh)
    try:
        shard_rays(torch.zeros(5, 3), mesh)
        raised = ""
    except ValueError as e:
        raised = str(e)
    return a.tolist(), b.tolist(), c.tolist(), block[:, 0].tolist(), raised


def test_replicate_and_shard_rays_in_a_gloo_world():
    """Over 2 ranks: replicate gives every rank rank 0's tensors, shard_rays
    each rank its block of the ray axis (local_rays), and an indivisible
    count raises the trainer's ValueError."""
    from test_torch_parallel import run_world

    out = run_world(_world_replicate_shard, 2)
    for rank, (a, b, c, block, raised) in out.items():
        assert a == [0.0] * 3 and b == [[10.0, 10.0]] * 2 and c == [5.0]
        assert block == [6.0 * rank + i for i in range(6)]
        assert "5" in raised and "2 data ranks" in raised
