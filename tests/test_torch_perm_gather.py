"""Port parity for B6's module and its entry points: lidarnerf_tpu_torch.ops.perm_gather
and ops.sampling.{permutation_gather, sort_merge_z} vs the JAX package.

The JAX side runs `mxu_permutation_gather` (its Pallas kernel in interpret
mode) and its own `sort_merge_z` / `permutation_gather`; the port's CPU path
is B6's plain version (kernel B6 itself needs the card:
tests/test_torch_cuda.py). Every comparison is bit for bit: a permutation
only moves values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.ops import sampling as sj
from lidarnerf_tpu.ops.perm_gather_pallas import mxu_permutation_gather as mxu_j
from lidarnerf_tpu_torch.ops import perm_gather_cuda
from lidarnerf_tpu_torch.ops.perm_gather import mxu_permutation_gather
from lidarnerf_tpu_torch.ops.sampling import inverse_permutation, permutation_gather, sort_merge_z


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _case(N, S, C, seed):
    """Values with the awkward bit patterns (signed zeros, a denormal, inf,
    NaN, extreme magnitudes), a per-ray permutation and its inverse."""
    rng = np.random.RandomState(seed)
    vals = (rng.randn(N, S, C) * 10.0 ** rng.randint(-6, 6, (N, S, C))).astype(np.float32)
    vals.flat[:6] = [-0.0, 0.0, 1e-40, np.inf, -np.inf, np.nan]
    order = np.stack([rng.permutation(S) for _ in range(N)])
    inv = np.argsort(order, axis=1)
    return vals, order, inv


@pytest.mark.parametrize("N,S,C", [(8, 32, 17), (5, 48, 3), (3, 24, 4)])
def test_b6_plain_path_bit_for_bit_vs_interpret(N, S, C):
    vals, order, inv = _case(N, S, C, 0)
    cot = np.random.RandomState(1).randn(N, S, C).astype(np.float32)
    inv_j = jnp.asarray(inv, jnp.int32)
    out_j, vjp = jax.vjp(lambda v: mxu_j(v, inv_j, True), jnp.asarray(vals))
    (g_j,) = vjp(jnp.asarray(cot))

    v = torch.from_numpy(vals).requires_grad_()
    out = mxu_permutation_gather(v, torch.from_numpy(inv))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(_bits(out.detach()), _bits(out_j))
    np.testing.assert_array_equal(_bits(out.detach()), _bits(np.take_along_axis(
        vals, order[..., None], axis=1)))
    np.testing.assert_array_equal(_bits(v.grad), _bits(g_j))


@pytest.mark.parametrize("ndim", [2, 3])
def test_permutation_gather_and_vjp_match_jax(ndim):
    vals, order, inv = _case(4, 20, 5, 2)
    vals = vals[..., 0] if ndim == 2 else vals
    cot = np.random.RandomState(3).randn(*vals.shape).astype(np.float32)
    oj, ij = jnp.asarray(order, jnp.int32), jnp.asarray(inv, jnp.int32)
    out_j, vjp = jax.vjp(lambda v: sj.permutation_gather(v, oj, ij), jnp.asarray(vals))
    (g_j,) = vjp(jnp.asarray(cot))
    v = torch.from_numpy(vals).requires_grad_()
    out = permutation_gather(v, torch.from_numpy(order), torch.from_numpy(inv))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(_bits(out.detach()), _bits(out_j))
    np.testing.assert_array_equal(_bits(v.grad), _bits(g_j))
    # the inverse is argsort(order), as the JAX package takes it
    np.testing.assert_array_equal(inverse_permutation(torch.from_numpy(order)).numpy(), inv)


def test_sort_merge_z_bit_for_bit_with_ties():
    """Fine samples landing exactly on coarse ones (and on each other) keep
    the stable order jnp.argsort gives them, so the extras follow z the
    same way; forward and gradient agree bit for bit."""
    rng = np.random.RandomState(4)
    N, T, t, G = 6, 12, 5, 3
    zc = np.sort(rng.uniform(0.1, 2.0, (N, T)), axis=1).astype(np.float32)
    zf = np.sort(rng.uniform(0.1, 2.0, (N, t)), axis=1).astype(np.float32)
    zf[:, 1] = zc[:, 4]  # ties across the lists
    zf[:, 3] = zf[:, 2]  # and within the fine list
    zf = np.sort(zf, axis=1)
    sc, sf = rng.randn(N, T).astype(np.float32), rng.randn(N, t).astype(np.float32)
    gc, gf = rng.randn(N, T, G).astype(np.float32), rng.randn(N, t, G).astype(np.float32)
    cots = [rng.randn(N, T + t).astype(np.float32), rng.randn(N, T + t, G).astype(np.float32)]

    def merged_j(sc_, sf_, gc_, gf_):
        return sj.sort_merge_z(jnp.asarray(zc), jnp.asarray(zf), (sc_, sf_), (gc_, gf_))

    inputs_j = tuple(map(jnp.asarray, (sc, sf, gc, gf)))
    z_j, order_j, s_j, g_j = merged_j(*inputs_j)
    _, vjp = jax.vjp(lambda *a: merged_j(*a)[2:], *inputs_j)
    grads_j = vjp(tuple(map(jnp.asarray, cots)))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (sc, sf, gc, gf)]
    z, order, s, g = sort_merge_z(torch.from_numpy(zc), torch.from_numpy(zf),
                                  (leaves[0], leaves[1]), (leaves[2], leaves[3]))
    torch.autograd.backward([s, g], [torch.from_numpy(c) for c in cots])

    assert order.dtype == torch.int64 and (np.diff(z.detach().numpy(), axis=1) >= 0).all()
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    for a, b in ((z, z_j), (s, s_j), (g, g_j)):
        np.testing.assert_array_equal(_bits(a.detach()), _bits(b))
    for leaf, ref in zip(leaves, grads_j):
        np.testing.assert_array_equal(_bits(leaf.grad), _bits(ref))


def test_b6_wrappers_take_cuda_tensors_only():
    vals, _, inv = _case(2, 8, 3, 5)
    v, i = torch.from_numpy(vals), torch.from_numpy(inv).int()
    before = perm_gather_cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        perm_gather_cuda.perm_gather_fwd(v, i)
    with pytest.raises(ValueError, match="CUDA tensors"):
        perm_gather_cuda.perm_gather_bwd(v, i)
    assert perm_gather_cuda.launch_counts() == before
    assert set(before) == {"perm_gather_fwd", "perm_gather_bwd"}
