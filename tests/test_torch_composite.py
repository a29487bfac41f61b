"""Merged compositing: the dispatch of ops/compositing.py::merged_composite_weights,
the argument checks of its kernel pair (ops/merged_composite_cuda.py), and
the kernel's merged-order arithmetic, on the CPU.

The kernels themselves run on the card only (tests/test_torch_cuda.py); here
CPU tensors take the plain version, which is held to the JAX package.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidarnerf_tpu.ops import compositing as cj
from lidarnerf_tpu_torch.ops import (
    block_hash_cuda,
    compositing,
    cuda_lib,
    device_counts,
    dispatch,
    merged_composite_cuda,
)

# (TA, TB): the default path's 768 + 64, --fast's 192 + 64, odd lists, one each
SHAPES = [(768, 64), (192, 64), (37, 5), (1, 1)]


def _lists(TA, TB, N=16, seed=0):
    """Sorted coarse and fine depths over LiDAR's [near, 81 near] with ties
    across and within the lists, densities with a saturated step, the base
    bin width: float32 numpy arrays."""
    rs = np.random.RandomState(seed)
    near = 0.0108
    zA = np.sort(rs.uniform(near, 81 * near, (N, TA)), axis=1).astype(np.float32)
    zB = np.sort(rs.uniform(near, 81 * near, (N, TB)), axis=1).astype(np.float32)
    if TA > 6 and TB > 3:
        zB[:, 1] = zA[:, 5]
        zB[:, 2] = zA[:, 5]
        zB = np.sort(zB, axis=1)
    sigA = rs.exponential(30.0, (N, TA)).astype(np.float32)
    sigB = rs.exponential(30.0, (N, TB)).astype(np.float32)
    sigA[:, TA // 2] = 1e6
    dist = np.full((N, 1), 80 * near / TA, np.float32)
    return zA, sigA, zB, sigB, dist


@pytest.mark.parametrize("TA,TB", SHAPES)
def test_cpu_tensors_take_the_plain_version(TA, TB, monkeypatch):
    """A CPU tensor goes to merged_composite_weights_plain: the same weights
    and the same gradients (every input's, the depths' too) bit for bit,
    and no launch counted."""
    calls = []
    plain = compositing.merged_composite_weights_plain
    monkeypatch.setattr(compositing, "merged_composite_weights_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = merged_composite_cuda.launch_counts()
    runs = []
    for fn in (compositing.merged_composite_weights, plain):
        leaves = [torch.from_numpy(v).requires_grad_() for v in _lists(TA, TB)]
        wA, wB = fn(*leaves, 1.5)
        ((wA * 3.0).sum() + (wB ** 2).sum()).backward()
        runs.append([wA.detach(), wB.detach(), *[t.grad for t in leaves]])
    assert calls == [1]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert merged_composite_cuda.launch_counts() == before


@pytest.mark.parametrize("TA,TB", SHAPES)
def test_merged_composite_weights_matches_jax_at_each_shape(TA, TB):
    zA, sigA, zB, sigB, dist = _lists(TA, TB)
    rA, rB = cj.merged_composite_weights(*map(jnp.asarray, (zA, sigA, zB, sigB, dist)))
    wA, wB = compositing.merged_composite_weights(*map(torch.from_numpy, (zA, sigA, zB, sigB, dist)))
    np.testing.assert_allclose(wA.numpy(), np.asarray(rA), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(wB.numpy(), np.asarray(rB), rtol=1e-5, atol=1e-7)


def _merged_order(zA, sigA, zB, sigB, dist, gA, gB, ds):
    """The kernel's arithmetic in numpy, sample by sample in merged order:
    float32 deltas, x and logaddexp as the kernel rounds them, the prefix of
    l and the sum R of g w over the later samples in float64; returns the
    weights and dL/dsigma = (g e T + l'(x) R) delta ds, both split back."""
    TA = zA.shape[1]
    z, s = np.concatenate([zA, zB], 1), np.concatenate([sigA, sigB], 1)
    g = np.concatenate([gA, gB], 1)
    order = np.argsort(z, axis=1, kind="stable")  # equal depths: A first
    z, s, g = (np.take_along_axis(a, order, 1) for a in (z, s, g))
    delta = np.concatenate([z[:, 1:] - z[:, :-1], dist], 1)
    f32 = np.float32
    x = delta * f32(ds) * s
    eps = f32(-34.538776394910684)
    l = np.maximum(-x, eps) + np.log1p(np.exp(-np.abs(-x - eps)))
    prefix = np.cumsum(l.astype(np.float64), 1) - l
    T = np.exp(prefix.astype(f32))
    e = np.exp(-x)
    w = (f32(1) - e) * T
    gw = (g * w).astype(np.float64)
    R = (np.cumsum(gw[:, ::-1], 1)[:, ::-1] - gw).astype(f32)
    dsig = (g * e * T - np.exp(-x - l) * R) * (delta * f32(ds))
    out = []
    for a in (w, dsig):
        back = np.empty_like(a)
        np.put_along_axis(back, order, a, 1)
        out.append((back[:, :TA], back[:, TA:]))
    return out


@pytest.mark.parametrize("TA,TB", SHAPES)
def test_merged_order_arithmetic_matches_the_plain_version(TA, TB):
    """The walk the kernel makes (merged order, float64 sums, the backward
    dL/dx = g e^-x T + l'(x) R) gives the plain version's weights and the
    plain version's autograd gradients. The weights at the JAX tolerance plus
    what numpy's float32 exp may differ from torch's by (one ulp of 1 - e^-x
    in T: 1.2e-7); the gradients within 1e-5 of their largest entry (dL/dx is
    a difference of terms rounded relative to the larger)."""
    zA, sigA, zB, sigB, dist = _lists(TA, TB, N=64, seed=TA)
    rs = np.random.RandomState(1)
    gA, gB = (rs.normal(size=s.shape).astype(np.float32) for s in (sigA, sigB))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (sigA, sigB)]
    wA, wB = compositing.merged_composite_weights_plain(
        torch.from_numpy(zA), leaves[0], torch.from_numpy(zB), leaves[1], torch.from_numpy(dist),
        1.25)
    torch.autograd.backward([wA, wB], [torch.from_numpy(gA), torch.from_numpy(gB)])
    (eA, eB), (dA, dB) = _merged_order(zA, sigA, zB, sigB, dist, gA, gB, 1.25)
    np.testing.assert_allclose(eA, wA.detach().numpy(), rtol=1e-5, atol=2.5e-7)
    np.testing.assert_allclose(eB, wB.detach().numpy(), rtol=1e-5, atol=2.5e-7)
    scale = max(np.abs(leaves[0].grad.numpy()).max(), np.abs(leaves[1].grad.numpy()).max())
    np.testing.assert_allclose(dA, leaves[0].grad.numpy(), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(dB, leaves[1].grad.numpy(), rtol=1e-4, atol=1e-5 * scale)


def _good(N=5, TA=7, TB=3):
    g = torch.Generator().manual_seed(0)
    zA = torch.sort(torch.rand(N, TA, generator=g), 1).values
    zB = torch.sort(torch.rand(N, TB, generator=g), 1).values
    return dict(zA=zA, sigA=torch.rand(N, TA, generator=g), zB=zB,
                sigB=torch.rand(N, TB, generator=g), sample_dist=torch.full((N, 1), 0.1))


def test_check_args_takes_the_kernels_arguments():
    assert merged_composite_cuda.check_args(**_good()) == (5, 7, 3)
    assert merged_composite_cuda.check_args(**_good(N=0)) == (0, 7, 3)
    assert merged_composite_cuda.check_args(**_good(TA=1, TB=1)) == (5, 1, 1)
    most = merged_composite_cuda.MAX_SAMPLES - 64
    assert merged_composite_cuda.check_args(**_good(N=1, TA=most, TB=64)) == (1, most, 64)
    args = _good()
    args["sigA"].requires_grad_()  # the densities are what the backward differentiates
    assert merged_composite_cuda.check_args(**args) == (5, 7, 3)


BAD = {
    "double sigma": (lambda a: {**a, "sigA": a["sigA"].double()}, "sigA must be a contiguous float32"),
    "half depth": (lambda a: {**a, "zB": a["zB"].half()}, "zB must be a contiguous float32"),
    "1-D depths": (lambda a: {**a, "zA": a["zA"][0]}, "takes zA"),
    "3-D depths": (lambda a: {**a, "zB": a["zB"][..., None]}, "takes zA"),
    "sigma of another length": (lambda a: {**a, "sigB": a["sigB"][:, :2].contiguous()},
                                "sigB must be"),
    "sigma of other rays": (lambda a: {**a, "sigA": a["sigA"][:4].contiguous()}, "sigA must be"),
    "flat sample_dist": (lambda a: {**a, "sample_dist": a["sample_dist"][:, 0]},
                         "sample_dist must be"),
    "strided sigma": (lambda a: {**a, "sigA": torch.rand(7, 5).t()}, "not contiguous"),
    "expanded sample_dist": (lambda a: {**a, "sample_dist": torch.full((1, 1), 0.1).expand(5, 1)},
                             "not contiguous"),
    "zA requires grad": (lambda a: {**a, "zA": a["zA"].requires_grad_()}, "no gradient for zA"),
    "zB requires grad": (lambda a: {**a, "zB": a["zB"].requires_grad_()}, "no gradient for zB"),
    "sample_dist requires grad": (lambda a: {**a, "sample_dist": a["sample_dist"].requires_grad_()},
                                  "no gradient for sample_dist"),
    "empty coarse list": (lambda a: {**_good(TA=0)}, "1 <= TA, TB"),
    "empty fine list": (lambda a: {**_good(TB=0)}, "1 <= TA, TB"),
    "too many samples": (lambda a: _good(N=1, TA=merged_composite_cuda.MAX_SAMPLES, TB=1),
                         "TA \\+ TB <= 16384"),
    "another device": (lambda a: {**a, "sigB": a["sigB"].to("meta")}, "on one device"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_check_args_refuses(case):
    """The argument checks the wrapper makes before every launch raise on
    what the kernels do not take; no card is needed to make them."""
    change, message = BAD[case]
    with pytest.raises(ValueError, match=message):
        merged_composite_cuda.check_args(**change(_good()))


def test_kernel_path_never_falls_back(monkeypatch):
    """On the kernel path merged_composite_weights goes to the wrapper,
    which takes CUDA tensors only: on the CPU tensors here it raises, in
    both directions, instead of falling back; and it raises before any
    launch where a depth wants a gradient."""
    before = merged_composite_cuda.launch_counts()
    args = _good()
    with pytest.raises(ValueError, match="merged_composite takes CUDA tensors"):
        merged_composite_cuda.merged_composite_fwd(*args.values(), 1.0)
    with pytest.raises(ValueError, match="merged_composite takes CUDA tensors"):
        merged_composite_cuda.merged_composite_bwd(*args.values(), 1.0, args["sigA"], args["sigB"])
    with pytest.raises(ValueError, match="gA must be"):
        merged_composite_cuda.merged_composite_bwd(*args.values(), 1.0, args["sigB"], args["sigB"])
    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: True)
    with pytest.raises(ValueError, match="merged_composite takes CUDA tensors"):
        compositing.merged_composite_weights(*args.values())
    args["zA"].requires_grad_()
    with pytest.raises(ValueError, match="no gradient for zA"):
        compositing.merged_composite_weights(*args.values())
    assert merged_composite_cuda.launch_counts() == before


def test_source_and_build_naming():
    """One source with both entry points, built like the others into the
    git-ignored build directory; its limit is the wrapper's; its note says
    it replaces no TPU kernel and what bounds it; both directions have a
    slot in the count on the card."""
    src = (cuda_lib.CSRC_DIR / merged_composite_cuda.SOURCE).read_text()
    assert merged_composite_cuda.SOURCE == "merged_composite.cu"
    assert merged_composite_cuda.SOURCE not in block_hash_cuda.SOURCES
    for name in ("merged_composite_fwd", "merged_composite_bwd"):
        assert f'extern "C" int {name}(' in src
    assert int(re.search(r"#define MAX_SAMPLES (\d+)", src).group(1)) == merged_composite_cuda.MAX_SAMPLES
    assert "Replaces no TPU kernel" in src and "Bound: device memory" in src
    assert "lidarnerf_tpu/ops/compositing.py::merged_composite_weights" in src
    assert "atomic" not in src.replace("No atomics", "")
    lib = cuda_lib.library_path(merged_composite_cuda.SOURCE)
    assert lib.parent == cuda_lib.BUILD_DIR and lib.name.startswith("merged_composite_")
    assert set(merged_composite_cuda.launch_counts()) <= set(device_counts.KERNELS)
