"""Guards of the lidarnerf_tpu_torch package: no JAX, no silent CPU, no CUDA fallback."""

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
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 15  # every module of the package was imported
    assert out[1].strip() == "[]"


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
