"""Determinism of the port: its counterpart of tests/test_determinism.py.

The JAX package's table gradient, training step and render repeat bit for
bit; so do the port's, on the CPU path here (its plain versions) and on the
card (tests/test_torch_cuda.py, chip_smoke.py: the backward kernels add
through an order-free fixed-point accumulator). The block-hash gradient of
1024 copies of one point, the case where racing atomics would differ, is
also held against the JAX package's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarnerf_tpu.ops import block_hash as bhj
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays
from lidarnerf_tpu_torch.nerf import train_step as tst
from lidarnerf_tpu_torch.ops import block_hash as bh

VARIANT_ENV = {"seg": "LIDARNERF_SEG_KERNELS", "win": "LIDARNERF_WIN_KERNELS"}
SPEC = dict(num_levels=4, base_resolution=4, log2_hashmap_size=10, desired_resolution=64)
NET = dict(encoding="blockhash", num_levels=4, base_resolution=4, log2_hashmap_size=10,
           desired_resolution=64, hidden_dim=16)
SCALE = 0.01
H, W, N = 8, 32, 48


def _set_variant(monkeypatch, variant):
    for name in VARIANT_ENV.values():
        monkeypatch.delenv(name, raising=False)
    if variant != "default":
        monkeypatch.setenv(VARIANT_ENV[variant], "1")


def _table_grad(spec, table, x):
    t = table.clone().requires_grad_()
    (bh.block_hash_encode(x, t, spec) ** 2).sum().backward()
    return t.grad


@pytest.mark.parametrize("variant", list(bh.VARIANTS))
def test_block_hash_gradient_bitwise_deterministic(monkeypatch, variant):
    """1024 copies of one point, twice: the same table gradient bit for bit."""
    _set_variant(monkeypatch, variant)
    spec = bh.make_block_hash_spec(**SPEC)
    table = bh.block_hash_init(spec, torch.Generator().manual_seed(0))
    x = torch.tensor([[0.3, 0.5, 0.7]]).repeat(1024, 1)
    a, b = _table_grad(spec, table, x), _table_grad(spec, table, x)
    assert a.abs().max() > 0
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_block_hash_gradient_of_one_point_matches_jax():
    """The same gradient as the JAX package's (XLA branch), to fp32 rounding
    of 1024 equal terms summed in another order."""
    spec = bh.make_block_hash_spec(**SPEC)
    spec_j = bhj.make_block_hash_spec(**SPEC)
    table = bh.block_hash_init(spec, torch.Generator().manual_seed(0))
    x = np.tile(np.array([[0.3, 0.5, 0.7]], np.float32), (1024, 1))
    loss = lambda t: jnp.sum(bhj.block_hash_encode(jnp.asarray(x), t, spec_j, False) ** 2)  # noqa: E731
    ref = jax.grad(loss)(jnp.asarray(table.numpy()))
    got = _table_grad(spec, table, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-9)


def _frame():
    rs = np.random.RandomState(3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = rs.uniform(-0.05, 0.05, 3)
    depth = rs.uniform(5.0, 60.0, (H, W)) * SCALE
    raydrop = (rs.uniform(size=(H, W)) < 0.85).astype(np.float32)
    image = np.stack([raydrop, rs.uniform(size=(H, W)) * raydrop, depth * raydrop], -1)
    return torch.from_numpy(pose[None]), torch.from_numpy(image[None].astype(np.float32))


@pytest.mark.parametrize("variant", list(bh.VARIANTS))
def test_train_step_bitwise_deterministic(monkeypatch, variant):
    """One training step from the same state with the same draws, twice:
    the same loss, gradients, parameters and Adam state bit for bit."""
    _set_variant(monkeypatch, variant)
    net0 = NeRFNetwork(**NET, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        net0.hash_table.mul_(1e4)  # O(1) features: densities that vary along the rays
    cfg = tst.TrainConfig(scale=SCALE, num_rays_lidar=N, H_lidar=H, W_lidar=W, grad_loss=True)
    rcfg = RenderConfig(num_steps=16, upsample_steps=4, min_near_lidar=SCALE, min_near=SCALE)
    poses, images = _frame()
    vi, vc = torch.zeros((1, 1), dtype=torch.long), torch.full((1,), H * W)
    runs = []
    for _ in range(2):
        net = copy.deepcopy(net0)
        step = tst.make_train_step(net, cfg, rcfg, patch_size=[2, 8], device="cpu")
        m = step(poses, images, vi, vc, 0, generator=torch.Generator().manual_seed(7))
        adam = step.optimizer
        state = [*adam.mu, *adam.nu, adam.count, adam.schedule_count]
        grads = [p.grad for p in net.parameters() if p.grad is not None]  # not the RGB head
        runs.append([m["loss"], *grads, *net.parameters(), *state])
    assert m["skipped_nonfinite"] == 0.0
    for a, b in zip(*runs):
        assert torch.equal(a.detach(), b.detach())


def test_render_bitwise_deterministic():
    """A training render (jittered and inverse-CDF samples from one seed), twice."""
    net = NeRFNetwork(**NET, generator=torch.Generator().manual_seed(0))
    cfg = RenderConfig(num_steps=16, upsample_steps=4, min_near_lidar=0.05)
    d = np.random.RandomState(0).randn(64, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.zeros(64, 3), torch.from_numpy(d.astype(np.float32))
    outs = [render_rays(net, o, d, cfg, train=True, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k])


@pytest.mark.parametrize("variant", list(bh.VARIANTS))
def test_seam_epoch_bitwise_deterministic(monkeypatch, variant):
    """The seam options in one run: a tied network (`seam_tie`), the seam
    loss (alpha_seam > 0, its gradient a gather's order-free scatter) and the
    hashed-seam sync before step 0 and 16 of an 18-step epoch, twice from the
    same state and seed: the losses, parameters and Adam state bit for bit."""
    _set_variant(monkeypatch, variant)
    net_kw = {**NET, "log2_hashmap_size": 14}  # dense coarse levels beside hashed ones
    net0 = NeRFNetwork(**net_kw, seam_tie=True, generator=torch.Generator().manual_seed(1))
    assert {lv.dense for lv in net0.block_spec.levels} == {True, False}
    with torch.no_grad():
        net0.hash_table.mul_(1e4)
    cfg = tst.TrainConfig(scale=SCALE, num_rays_lidar=N, H_lidar=H, W_lidar=W, alpha_seam=100.0)
    rcfg = RenderConfig(num_steps=16, upsample_steps=4, min_near_lidar=SCALE, min_near=SCALE)
    poses, images = _frame()
    vi, vc = torch.zeros((1, 1), dtype=torch.long), torch.full((1,), H * W)
    runs = []
    for _ in range(2):
        net = copy.deepcopy(net0)
        fn = tst.make_epoch_step(net, cfg, rcfg, device="cpu", seam_sync=256)
        ms = fn(poses, images, vi, vc, np.zeros(18, np.int64),
                generator=torch.Generator().manual_seed(7))
        adam = fn.step.optimizer
        runs.append([ms["loss"], *net.parameters(), *adam.mu, *adam.nu])
    assert (ms["skipped_nonfinite"] == 0).all()
    for a, b in zip(*runs):
        assert torch.equal(a.detach(), b.detach())
