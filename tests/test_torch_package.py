"""Guards of the lidarnerf_tpu_torch package: no JAX, no silent CPU, no CUDA fallback."""

import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lidarnerf_tpu_torch
from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
from lidarnerf_tpu_torch.ops import block_hash, block_hash_cuda, cuda_lib, dispatch
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
    from types import SimpleNamespace

    return SimpleNamespace(
        encoding="blockhash", desired_resolution=64, log2_hashmap_size=10,
        num_layers=2, hidden_dim=8, geo_feat_dim=15, bound=1.0, scale=0.01,
        num_steps=8, upsample_steps=4, max_ray_batch=16, fp16=False, alpha_r=1.0,
    )


def test_entry_points_do_not_default_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = _tiny_opt()
    params = params_to_jax(
        NeRFNetwork(desired_resolution=64, log2_hashmap_size=10, hidden_dim=8).state_dict()
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PanoRenderer(opt, params)
    # asked for explicitly, the CPU runs
    r = PanoRenderer(opt, params, device="cpu")
    raydrop, intensity, depth = r.render_frame(np.eye(4), 2, 8, (2.0, 26.9))
    assert raydrop.shape == intensity.shape == depth.shape == (2, 8)


def test_cuda_table_gradient_not_ported_and_no_fallback(monkeypatch):
    """Checked through a monkeypatched kernel choice, so it runs without a GPU."""
    spec = block_hash.make_block_hash_spec(num_levels=2, log2_hashmap_size=10,
                                           desired_resolution=64)
    x = torch.rand(10, 3)
    table = torch.zeros(spec.table_rows, 128, requires_grad=True)
    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: True)
    with pytest.raises(NotImplementedError, match="training slice"):
        block_hash.block_hash_encode(x, table, spec)
    # without a gradient the call goes to the kernel's wrapper, which takes
    # CUDA tensors only and never falls back to the plain version
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        block_hash.block_hash_encode(x, table, spec)


def test_kernel_wrapper_rejects_cpu_tensors():
    spec = block_hash.make_block_hash_spec(num_levels=2, log2_hashmap_size=10)
    before = block_hash_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        block_hash_cuda.block_hash_fwd(torch.rand(4, 3), torch.zeros(spec.table_rows, 128), spec)
    assert block_hash_cuda.launches == before


def test_kernel_source_and_build_naming():
    src = (cuda_lib.CSRC_DIR / block_hash_cuda.SOURCE).read_text()
    assert int(re.search(r"#define MAX_LEVELS (\d+)", src).group(1)) == block_hash_cuda.MAX_LEVELS
    assert 'extern "C" int block_hash_fwd(' in src
    lib = cuda_lib.library_path(block_hash_cuda.SOURCE)
    assert lib.parent == cuda_lib.BUILD_DIR and lib == cuda_lib.library_path(block_hash_cuda.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
    gitignore = (REPO / ".gitignore").read_text().split()
    assert "lidarnerf_tpu_torch/_build/" in gitignore


def test_checkpoint_with_jax_objects_is_refused(tmp_path):
    ckpt = tmp_path / "jax.ckpt"
    ckpt.write_bytes(pickle.dumps({"model": {"params": {"hash_table": jnp.zeros((2, 128))}}}))
    with pytest.raises(ValueError, match=r"jax\S*\.\S+ object"):
        load_jax_checkpoint(ckpt)
    (tmp_path / "orbax.ckpt").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        load_jax_checkpoint(tmp_path / "orbax.ckpt")
    assert lidarnerf_tpu_torch.__version__
