"""Port parity for B5's module: lidarnerf_tpu_torch.ops.fused_mlp vs lidarnerf_tpu.ops.fused_mlp.

The JAX side runs its Pallas kernel in interpret mode and its plain chain;
the port runs `mlp_reference` and `fused_mlp`, whose CPU path is the plain
version (kernel B5 itself needs the card: tests/test_torch_cuda.py). Inputs
are numpy draws from a seed; the nets are the model's own shapes.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.ops import fused_mlp as fj
from lidarnerf_tpu_torch.ops import cuda_lib, fused_mlp_cuda
from lidarnerf_tpu_torch.ops import fused_mlp as ft

# the model's nets (models/network.py): sigma net, LiDAR head; and a relu head
NETS = {
    "sigma": ([32, 64, 16], "none"),
    "lidar_head": ([90, 64, 64, 2], "sigmoid"),
    "relu": ([16, 32, 8], "relu"),
}
BF16_RTOL = 2.0**-7  # see test_bf16_weights_match_jax


def _case(dims, seed, n=100):
    """n rows (not a multiple of the JAX kernel's 1024-row chunk) and [in, out] weights."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dims[0]).astype(np.float32)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
    return x, ws


@pytest.mark.parametrize("net", list(NETS))
def test_f32_weights_match_jax(net):
    dims, act = NETS[net]
    x, ws = _case(dims, 0)
    want_kernel = fj.fused_mlp_inference(jnp.asarray(x), tuple(map(jnp.asarray, ws)), act,
                                         interpret=True)
    want_plain = fj.mlp_reference(jnp.asarray(x), list(map(jnp.asarray, ws)), act)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    got = ft.mlp_reference(xt, wt, act)
    assert got.dtype == torch.float32 and got.shape == (len(x), dims[-1])
    # float32 on both sides, the sums taken in another order
    for want in (want_kernel, want_plain):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # on a CPU tensor the differentiable entry is the plain version
    assert torch.equal(ft.fused_mlp(xt, wt, act), got)


@pytest.mark.parametrize("net", list(NETS))
def test_bf16_weights_match_jax(net):
    """bfloat16 weights: each layer's input rounds to bfloat16, products are
    exact and sums float32 on both sides. A sum the two frameworks take in
    another order may round to the other neighbouring bfloat16 value as the
    next layer's input, so each entry is held to 2^-7 x S + 1e-6, S the
    chain on |x| and |W| (a bound on the sum of absolute terms)."""
    dims, act = NETS[net]
    x, ws = _case(dims, 1)
    wj = [jnp.asarray(w).astype(jnp.bfloat16) for w in ws]
    wt = [torch.from_numpy(w).to(torch.bfloat16) for w in ws]
    for a, b in zip(wj, wt):  # both round to nearest even: the same weights
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())
    want_kernel = fj.fused_mlp_inference(jnp.asarray(x), tuple(wj), act, interpret=True)
    want_plain = fj.mlp_reference(jnp.asarray(x), wj, act)
    xt = torch.from_numpy(x)
    got = ft.mlp_reference(xt, wt, act)
    assert got.dtype == torch.float32
    S = ft.mlp_reference(xt.abs(), [w.abs() for w in wt], "none").numpy()
    for want in (want_kernel, want_plain):
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= BF16_RTOL * S + 1e-6).all(), err.max()
    # the inputs were rounded: the same weights held as float32 give another chain
    assert not torch.equal(got, ft.mlp_reference(xt, [w.float() for w in wt], act))


@pytest.mark.parametrize("act", ["none", "sigmoid"])
def test_fused_mlp_gradients_match_jax(act):
    x, ws = _case([16, 32, 8], 3, n=32)

    def loss_j(xx, ww):
        return jnp.sum(fj.fused_mlp(xx, ww, act) ** 2)

    gx_j, gw_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), list(map(jnp.asarray, ws)))
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    (ft.fused_mlp(xt, wt, act) ** 2).sum().backward()
    # float32 recompute through the plain chain on both sides (the JAX test's tolerance)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-5)
    for a, b in zip(wt, gw_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # only what needs a gradient gets one
    w_only = [torch.from_numpy(w).requires_grad_() for w in ws]
    ft.fused_mlp(torch.from_numpy(x), w_only, act).sum().backward()
    assert all(w.grad is not None for w in w_only)


def test_b5_entry_points_take_cuda_tensors_only():
    x, ws = _case([32, 64, 16], 4, n=8)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    before = fused_mlp_cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ft.fused_mlp_inference(xt, wt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mlp_cuda.fused_mlp_fwd(xt, wt)
    with pytest.raises(ValueError, match="final_activation"):
        fused_mlp_cuda.fused_mlp_fwd(xt, wt, "tanh")
    assert fused_mlp_cuda.launch_counts() == before == {"fused_mlp": before["fused_mlp"]}


@pytest.fixture(scope="module")
def host_plan(tmp_path_factory):
    """The kernel's launch plan (csrc/fused_mlp_plan.cuh, plain C++), built for
    the host: the library the wrapper's `smem_bytes` asks, on a machine
    without nvcc."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler is needed to build the plan header for the host"
    lib = tmp_path_factory.mktemp("plan") / "fused_mlp_plan.so"
    subprocess.run([cxx, "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    str(cuda_lib.CSRC_DIR / fused_mlp_cuda.PLAN), "-o", str(lib)],
                   check=True, timeout=120, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def plan_smem(host_plan, monkeypatch):
    """fused_mlp_cuda.smem_bytes, bound to the host build of the plan; the
    sources it loaded are appended to `plan_smem.loads`."""
    real_load = cuda_lib.load
    loads = []

    def load(source):
        loads.append(source)
        return host_plan if source == fused_mlp_cuda.SOURCE else real_load(source)

    monkeypatch.setattr(cuda_lib, "load", load)
    monkeypatch.setattr(fused_mlp_cuda, "_smem_fn", None)

    def smem(dims, dtype=torch.float32):
        return fused_mlp_cuda.smem_bytes(dims, dtype)

    smem.loads = loads
    return smem


def test_b5_source_constants_and_shared_memory(plan_smem):
    """The wrapper's limits are the source's, and its shared-memory sizing is
    the source's plan: the model's nets fit, a 256-wide 8-layer chain not, at
    either dtype."""
    src = (cuda_lib.CSRC_DIR / fused_mlp_cuda.PLAN).read_text()
    defines = {m.group(1): int(m.group(2)) for m in re.finditer(r"#define (\w+) (\d+)", src)}
    for name in ("MAX_LAYERS", "MAX_WIDTH", "SMEM_LIMIT"):
        assert defines[name] == getattr(fused_mlp_cuda, name), name
    assert 'extern "C" long long fused_mlp_smem(' in src
    src = (cuda_lib.CSRC_DIR / fused_mlp_cuda.SOURCE).read_text()
    assert 'extern "C" int fused_mlp(' in src and f'#include "{fused_mlp_cuda.PLAN}"' in src
    head = [90, 64, 64, 2]
    w = 90 * 64 + 64 * 64 + 64 * 4  # padded to 4 columns
    assert plan_smem(head) == 4 * (w + 2 * defines["ROWS"] * 91)
    for dtype in (torch.float32, torch.bfloat16):
        assert plan_smem([32, 64, 16], dtype) < fused_mlp_cuda.SMEM_LIMIT
        assert plan_smem(head, dtype) < fused_mlp_cuda.SMEM_LIMIT
        assert plan_smem([256] * 9, dtype) > fused_mlp_cuda.SMEM_LIMIT


# Shared memory of a block, worked out by hand from the layouts that
# csrc/fused_mlp_plan.cuh documents. float32: 4 B x (the weights padded to 4
# columns + 2 buffers of [64, widest | 1]). bfloat16: 256 B a weight fragment
# (K padded to 16, N to 8), and per warp (8 at most) a ring of [16, S] float32
# slots (S = d0, or d0 padded to 8 mod 16 where d0 % 4 == 0; 6 slots at most,
# as many as keep two blocks an SM) plus, for hidden layers wider than 64, one
# [16, pad16(widest) + 8] bf16 buffer, or two for two such layers in a row.
B5_SMEM = {
    # sigma net: weights 32 x 64 + 64 x 16; 24 fragments, 5 slots of [16, 40]
    (32, 64, 16): (4 * (3072 + 2 * 64 * 65), 256 * 24 + 8 * 5 * 16 * 40 * 4),
    # LiDAR head: 84 fragments, 2 slots of [16, 90] (rows packed)
    (90, 64, 64, 2): (4 * (10112 + 2 * 64 * 91), 256 * 84 + 8 * 2 * 16 * 90 * 4),
    # wide: 132 fragments, 2 slots of [16, 264]; only 5 warps fit
    (256, 64, 3): (4 * (16640 + 2 * 64 * 257), 256 * 132 + 5 * 2 * 16 * 264 * 4),
    # wide hidden: 96 fragments, 2 slots of [16, 40] and one [16, 264] buffer
    (32, 256, 16): (4 * (12288 + 2 * 64 * 257), 256 * 96 + 8 * (2 * 16 * 40 * 4 + 16 * 264 * 2)),
    # two wide layers in a row: 134 fragments, 2 slots, two [16, 136] buffers
    (32, 128, 96, 8): (4 * (17152 + 2 * 64 * 129), 256 * 134 + 8 * (2 * 16 * 40 * 4 + 2 * 16 * 136 * 2)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b5_wrapper_shared_memory_is_the_sources(plan_smem, dtype):
    """The shared memory the wrapper checks is the source's figure for each
    route: at the model's nets, `wide` and the nets that take the wide-buffer
    route (one buffer, two in turns). The library is bound once, not at
    each launch's check."""
    for dims, figures in B5_SMEM.items():
        assert plan_smem(list(dims), dtype) == figures[dtype == torch.bfloat16], dims
    assert plan_smem.loads == [fused_mlp_cuda.SOURCE]
