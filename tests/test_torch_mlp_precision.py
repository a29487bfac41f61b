"""The MLPs' matmul precision, one suspect of ROADMAP.md C10 (cleared).

The JAX package computes each MLP layer as a float32 `nn.Dense` at default
precision (`lidarnerf_tpu/models/network.py::MLP`; `--fp16` off, as in the
30k protocol run). On the CPU that is a float32 product; on a TPU, where
the JAX round-5 runs trained, a default-precision float32 matmul is one
bfloat16 pass: both operands rounded to bfloat16 (8 significant bits), the
products summed in float32, forward and backward. The port computes float32
products on both devices. A card A/B that switched the port's MLPs to the
TPU's precision (`tools/torch_c10_bisect.py --arm tpu_matmul`,
`TpuDefaultLinear`) drifted as the port does at two seeds of three
(PERF.md section 6), so this difference does not explain C10. The TPU
itself is not run here: the emulation is held against JAX's own
bfloat16-operand, float32-accumulation dot on the CPU.

Held here, with the port's sigma net and LiDAR head at seeded weights:
- the port's MLP, forward and both gradients, against float64 within
  float32's rounding, and against the JAX package's MLP on the CPU;
- `TpuDefaultLinear` against `jax.lax.dot_general` on bfloat16 operands
  with float32 results, forward and the backward's two products;
- the difference between the two precisions, bounded: at every output,
  |y_tpu - y| <= L 2^-7 of the chain of |x| |W| over L layers (and 100
  times the float32 MLP's own error somewhere: the TPU's rounding shows);
  the gradients within 2^-3 in norm, where the few hidden units whose
  pre-activation lies within the rounding take the other side of their
  ReLU (at most 2^-9 of them).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.models.network import MLP as FlaxMLP
from lidarnerf_tpu_torch.models.network import MLP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_c10_bisect", os.path.join(ROOT, "tools", "torch_c10_bisect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


c10 = _load_tool()

# (in_dim, num_layers, hidden, out): the protocol model's sigma net (16 levels
# x 2 features -> 1 + 15) and its LiDAR head (frequency(12) 75 + 15 -> 2)
NETS = {"sigma_net": (32, 2, 64, 16), "lidar_color_net": (90, 3, 64, 2)}
EPS32 = 2.0 ** -24


def _mlp(name, seed=0):
    d_in, layers, hidden, out = NETS[name]
    return MLP(d_in, layers, hidden, out, generator=torch.Generator().manual_seed(seed))


def _inputs(name, n=2048, seed=1):
    x = np.random.RandomState(seed).uniform(-1.0, 1.0, (n, NETS[name][0])).astype(np.float32)
    return torch.from_numpy(x).requires_grad_(True)


@torch.no_grad()
def _chain64(net, x):
    """The float64 forward, and the chain of |x| |W| at each output."""
    h, hab = x.double(), x.double().abs()
    for i, lin in enumerate(net.layers):
        w = lin.weight.double()
        h, hab = h @ w.T, hab @ w.abs().T
        if i != len(net.layers) - 1:
            h = h.relu()
    return h, hab


def _grads(fn, net, x, g):
    """(y, dy/dx . g, dy/dW . g for each layer) of `fn(net, x)`."""
    for p in net.parameters():
        p.grad = None
    x.grad = None
    y = fn(net, x)
    y.backward(g)
    return y.detach(), x.grad.clone(), [lin.weight.grad.clone() for lin in net.layers]


@pytest.mark.parametrize("name", sorted(NETS))
def test_port_mlp_is_float32(name):
    """The port's MLP against float64 (forward and gradients) within float32
    rounding, and against the JAX package's MLP on the CPU."""
    net, x = _mlp(name), _inputs(name)
    y64, hab = _chain64(net, x.detach())
    y = net(x).detach()
    d_in = NETS[name][0]
    assert float(((y.double() - y64).abs() / hab).max()) <= 4 * (d_in + 64) * EPS32
    g = torch.from_numpy(np.random.RandomState(2).normal(size=tuple(y.shape)).astype(np.float32))
    _, gx, gw = _grads(MLP.forward, net, x, g)
    x64 = x.detach().double().requires_grad_(True)
    ws64 = [lin.weight.detach().double().requires_grad_(True) for lin in net.layers]
    h = x64
    for i, w in enumerate(ws64):
        h = h @ w.T
        if i != len(ws64) - 1:
            h = h.relu()
    h.backward(g.double())
    for got, want in zip([gx, *gw], [x64.grad, *(w.grad for w in ws64)]):
        scale = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-5 * scale

    d_in, layers, hidden, out = NETS[name]
    flax = FlaxMLP(num_layers=layers, hidden_dim=hidden, out_dim=out)
    params = {"params": {f"Dense_{i}": {"kernel": jnp.asarray(lin.weight.detach().numpy().T)}
                         for i, lin in enumerate(net.layers)}}
    y_j = np.asarray(flax.apply(params, jnp.asarray(x.detach().numpy())))
    np.testing.assert_allclose(y.numpy(), y_j, rtol=1e-5, atol=1e-6)


def test_tpu_default_linear_is_jax_bfloat16_pass():
    """`TpuDefaultLinear` = JAX's dot on bfloat16 operands with float32
    results (forward; the backward's products take the cotangent rounded
    alike), within float32's summation order."""
    rs = np.random.RandomState(3)
    x = rs.normal(size=(512, 90)).astype(np.float32)
    w = rs.normal(size=(64, 90)).astype(np.float32)
    g = rs.normal(size=(512, 64)).astype(np.float32)

    def dot16(a, b):  # a @ b.T, one bfloat16 pass
        return np.asarray(jax.lax.dot_general(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))

    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    y = c10.TpuDefaultLinear.apply(xt, wt)
    y.backward(torch.from_numpy(g))
    for got, want, k in ((y.detach(), dot16(x, w), 90), (xt.grad, dot16(g, w.T), 64),
                         (wt.grad, dot16(g.T, x.T), 512)):
        chain = np.abs(want).max() + 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * k * EPS32 * chain * 8)
    # the operands really are rounded: a float32 product differs
    assert np.abs(y.detach().numpy() - x @ w.T).max() > 1e-3


@pytest.mark.parametrize("name", sorted(NETS))
def test_tpu_precision_difference_is_bounded(name):
    """The port's float32 MLP against the TPU's default precision. Forward:
    within L 2^-7 of the chain of |x| |W| at every output, and 100 times
    the float32 MLP's own error somewhere. Backward: the gradients within
    2^-3 in norm; they differ more than the outputs because a hidden unit
    whose pre-activation lies within the rounding can take the other side
    of its ReLU, and every unit that does lies within l 2^-7 of its chain
    at layer l."""
    net, x = _mlp(name), _inputs(name)
    layers = NETS[name][1]
    y64, hab = _chain64(net, x.detach())
    g = torch.from_numpy(np.random.RandomState(2).normal(size=tuple(y64.shape)).astype(np.float32))
    y, gx, gw = _grads(MLP.forward, net, x, g)
    y_t, gx_t, gw_t = _grads(c10.tpu_matmul_forward, net, x, g)
    rel32 = float(((y.double() - y64).abs() / hab).max())
    rel = float(((y_t.double() - y.double()).abs() / hab).max())
    assert 100 * rel32 <= rel <= layers * 2.0 ** -7, (rel32, rel)
    for a, b in zip([gx_t, *gw_t], [gx, *gw]):
        assert float((a - b).norm() / b.norm()) <= 2.0 ** -3
    h, h_t, hab = x.detach(), x.detach(), x.detach().abs()
    flipped = 0
    with torch.no_grad():
        for i, lin in enumerate(net.layers[:-1]):
            w = lin.weight
            pre, hab = h @ w.T, hab @ w.abs().T
            pre_t = c10.TpuDefaultLinear.apply(h_t, w)
            flip = (pre > 0) != (pre_t > 0)
            flipped += int(flip.sum())
            assert bool((pre[flip].abs() <= (i + 1) * 2.0 ** -7 * hab[flip]).all())
            h, h_t = pre.relu(), pre_t.relu()
    assert flipped <= 2.0 ** -9 * x.shape[0] * NETS[name][2] * (layers - 1)
