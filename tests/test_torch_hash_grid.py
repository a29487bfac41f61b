"""Port parity: the hash grid and the periodic volume of lidarnerf_tpu_torch vs the JAX package.

Points, tables and feature gradients come from numpy seeds; both sides run
on the CPU. Forward features are held at 1e-6 absolute (tables uniform in
[-1, 1], so a feature is at most 1 and its float32 ulp ~1.2e-7; the JAX
package contracts x * scale + 0.5 into one fused multiply-add, which the
port reproduces, and sums the 2^D corners in another order). Table
gradients are held at 1e-5 x max |grad| + 1e-7: the port rounds each term
to a fixed point and adds them order-free, XLA adds them in float32 in its
order. The port's table gradients repeat bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.ops import hash_grid as hg_j
from lidarnerf_tpu.ops import periodic_volume as pv_j
from lidarnerf_tpu_torch.ops import hash_grid as hg
from lidarnerf_tpu_torch.ops import order_free
from lidarnerf_tpu_torch.ops import periodic_volume as pv

FWD_ATOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7

# the JAX package's own parameters of each case; "kitti" is the KITTI-360
# model's grid at a small budget (desired resolution 32768: dense coarse
# levels, hashed fine ones); "wrap" is a 2-D tiled grid whose index products
# and stride updates pass 2^32 and wrap like uint32
SPECS = {
    "hash3": dict(num_levels=6, log2_hashmap_size=12, desired_resolution=256),
    "tiled3": dict(num_levels=6, log2_hashmap_size=12, desired_resolution=256, gridtype="tiled"),
    "hash2": dict(input_dim=2, num_levels=4, log2_hashmap_size=10, desired_resolution=512),
    "tiled2": dict(input_dim=2, num_levels=4, log2_hashmap_size=10, desired_resolution=512,
                   gridtype="tiled"),
    "align_corners": dict(num_levels=4, log2_hashmap_size=12, desired_resolution=128,
                          align_corners=True),
    "smoothstep": dict(num_levels=4, log2_hashmap_size=12, desired_resolution=128,
                       interpolation="smoothstep"),
    "kitti": dict(num_levels=16, log2_hashmap_size=14, desired_resolution=32768),
    "wrap": dict(input_dim=2, num_levels=2, log2_hashmap_size=19, desired_resolution=131072,
                 gridtype="tiled"),
}


def _specs(name):
    return hg_j.make_hash_grid_spec(**SPECS[name]), hg.make_hash_grid_spec(**SPECS[name])


def _inputs(spec, n, seed, lo=-0.05, hi=1.05):
    """Points (about 10% outside [0, 1]^D), a uniform(-1, 1) table, feature grads."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(lo, hi, (n, spec.input_dim)).astype(np.float32)
    table = rs.uniform(-1.0, 1.0, (spec.table_rows, spec.level_dim)).astype(np.float32)
    g = rs.normal(size=(n, spec.output_dim)).astype(np.float32)
    return x, table, g


def _levels(spec):
    return [(lv.scale, lv.resolution, lv.size, lv.offset, lv.n_dense_dims) for lv in spec.levels]


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_grid_spec_matches_jax(name):
    sj, st = _specs(name)
    assert _levels(st) == _levels(sj)
    assert (st.table_rows, st.output_dim, st.per_level_scale) == (
        sj.table_rows, sj.output_dim, sj.per_level_scale)


def test_kitti_spec_reaches_dense_and_hashed_levels():
    """At desired resolution 32768 the coarse levels index densely, the fine
    ones hash; the wrap spec's index products pass 2^32."""
    _, st = _specs("kitti")
    routes = [lv.n_dense_dims for lv in st.levels]
    assert 3 in routes and -1 in routes
    _, wrap = _specs("wrap")
    fine = wrap.levels[-1]
    corners = fine.resolution + 1
    assert fine.n_dense_dims == 2 and (corners - 1) * corners >= 2**32  # c1 * stride wraps
    assert corners**2 >= 2**32  # the stride update after axis 1 wraps


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_grid_forward_matches_jax(name):
    sj, st = _specs(name)
    x, table, _ = _inputs(sj, 3000, 0)
    ref = np.asarray(hg_j.hash_grid_encode(jnp.asarray(x), jnp.asarray(table), sj))
    out = hg.hash_grid_encode(torch.from_numpy(x), torch.from_numpy(table), st).numpy()
    assert out.shape == ref.shape == (3000, sj.output_dim) and out.dtype == np.float32
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.any() and not np.any(out[oob])  # out-of-range points give zero features
    np.testing.assert_allclose(out, ref, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", ["kitti", "wrap", "hash2", "tiled3"])
def test_level_index_matches_jax(name):
    """Corner rows of integer cells at and far beyond the grid, where every
    product and sum wraps: the uint32 arithmetic bit for bit."""
    sj, st = _specs(name)
    rs = np.random.RandomState(1)
    D = sj.input_dim
    cells = np.concatenate([rs.randint(0, 2**16, (200, D)), rs.randint(0, 2**32 - 1, (200, D),
                                                                        dtype=np.int64)])
    corners = hg_j._corner_offsets(D)
    for lj, lt in zip(sj.levels, st.levels):
        cg = jnp.asarray(cells.astype(np.uint32))[:, None, :] + corners[None]
        ref = np.asarray(hg_j._level_index(cg, lj, sj)).astype(np.int64)
        out = hg.level_index(torch.from_numpy(cells), lt, st).numpy()
        np.testing.assert_array_equal(out, ref)


def _jax_grad(sj, x, table, g):
    return np.asarray(jax.grad(lambda t: jnp.sum(hg_j.hash_grid_encode(jnp.asarray(x), t, sj)
                                                  * g))(jnp.asarray(table)))


def _port_grad(st, x, table, g):
    t = torch.from_numpy(table).requires_grad_()
    (hg.hash_grid_encode(torch.from_numpy(x), t, st) * torch.from_numpy(g)).sum().backward()
    return t.grad.numpy()


def _close_grad(out, ref):
    peak = np.abs(ref[np.isfinite(ref)]).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=GRAD_RTOL * peak + GRAD_ATOL)


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_grid_table_grad_matches_jax(name):
    sj, st = _specs(name)
    x, table, g = _inputs(sj, 2000, 2)
    out, ref = _port_grad(st, x, table, g), _jax_grad(sj, x, table, g)
    _close_grad(out, ref)
    assert np.array_equal(out, _port_grad(st, x, table, g))  # repeats bit for bit


def test_hash_grid_grad_of_one_point_repeated():
    """1024 copies of one point: every term of an entry lands on one row."""
    sj, st = _specs("kitti")
    x, table, g = _inputs(sj, 1, 3, 0.0, 1.0)
    x = np.repeat(x, 1024, 0)
    g = np.random.RandomState(4).normal(size=(1024, sj.output_dim)).astype(np.float32)
    _close_grad(_port_grad(st, x, table, g), _jax_grad(sj, x, table, g))


def test_hash_grid_nonfinite_grads_land_in_the_jax_rows():
    """A NaN and an Inf in g: the same entries are NaN and Inf as in JAX; the
    rest agrees; an out-of-range point's NaN goes nowhere."""
    sj, st = _specs("kitti")
    x, table, g = _inputs(sj, 500, 5)
    inside = np.flatnonzero(((x >= 0) & (x <= 1)).all(-1))
    outside = np.flatnonzero(((x < 0) | (x > 1)).any(-1))
    g[inside[0], 3] = np.nan
    g[inside[1], 30] = np.inf
    g[inside[2], 30] = -np.inf
    g[outside[0], 5] = np.nan
    out, ref = _port_grad(st, x, table, g), _jax_grad(sj, x, table, g)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(out), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    assert np.isnan(out).any() and np.isinf(out).any()
    fin = np.isfinite(ref)
    _close_grad(np.where(fin, out, 0), np.where(fin, ref, 0))
    assert np.array_equal(out, _port_grad(st, x, table, g), equal_nan=True)


def test_hash_grid_encode_chunked_is_the_encoder():
    sj, st = _specs("hash3")
    x, table, _ = _inputs(sj, 700, 6)
    a = hg.hash_grid_encode_chunked(torch.from_numpy(x), torch.from_numpy(table), st, chunk=128)
    b = hg.hash_grid_encode(torch.from_numpy(x), torch.from_numpy(table), st)
    ref = hg_j.hash_grid_encode_chunked(jnp.asarray(x), jnp.asarray(table), sj, chunk=128)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=0, atol=FWD_ATOL)


def test_hash_grid_init_is_uniform_1e4():
    _, st = _specs("kitti")
    t = hg.hash_grid_init(st, torch.Generator().manual_seed(0))
    assert t.shape == (st.table_rows, st.level_dim) and t.dtype == torch.float32
    assert t.abs().max() <= 1e-4 and t.std() > 5e-5
    assert torch.equal(t, hg.hash_grid_init(st, torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("name", ["hash3", "hash2", "tiled3"])
def test_hash_grid_total_variation_matches_jax(name):
    """The same uniform points (the JAX draw, injected): loss and gradient."""
    sj, st = _specs(name)
    _, table, _ = _inputs(sj, 1, 7)
    key = jax.random.PRNGKey(3)
    x = np.array(jax.random.uniform(key, (4000, sj.input_dim)))
    ref, gref = jax.value_and_grad(lambda t: hg_j.hash_grid_total_variation(t, sj, key, 4000))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    loss = hg.hash_grid_total_variation(t, st, x=torch.from_numpy(x))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    _close_grad(t.grad.numpy(), np.asarray(gref))
    drawn = hg.hash_grid_total_variation(t.detach(), st, torch.Generator().manual_seed(0), 500)
    assert drawn.ndim == 0 and torch.isfinite(drawn)


# ------------------------------------------------------------ periodic volume

PV_SPECS = {
    "linear": dict(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=9),
    "smoothstep": dict(num_levels=3, min_res=16, max_res=512, log2_hashmap_size=12,
                       smoothstep=True),
}


def _pv(name, n, seed):
    sj, st = (m.make_periodic_volume_spec(**PV_SPECS[name]) for m in (pv_j, pv))
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)  # periodic: any real input
    table = rs.uniform(-1.0, 1.0, (sj.table_rows, sj.features_per_level)).astype(np.float32)
    g = rs.normal(size=(n, sj.output_dim)).astype(np.float32)
    return sj, st, x, table, g


def test_periodic_volume_spec_matches_jax():
    for kw in PV_SPECS.values():
        assert vars(pv.make_periodic_volume_spec(**kw)) == vars(pv_j.make_periodic_volume_spec(**kw))
    with pytest.raises(ValueError, match="% 3 == 0"):
        pv.make_periodic_volume_spec(log2_hashmap_size=19)


@pytest.mark.parametrize("name", list(PV_SPECS))
def test_periodic_volume_forward_and_grad_match_jax(name):
    sj, st, x, table, g = _pv(name, 2000, 8)
    ref = np.asarray(pv_j.periodic_volume_encode(jnp.asarray(x), jnp.asarray(table), sj))
    t = torch.from_numpy(table).requires_grad_()
    out = pv.periodic_volume_encode(torch.from_numpy(x), t, st)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=FWD_ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    gref = jax.grad(lambda tj: jnp.sum(pv_j.periodic_volume_encode(jnp.asarray(x), tj, sj) * g))(
        jnp.asarray(table))
    _close_grad(t.grad.numpy(), np.asarray(gref))
    first = t.grad.clone()
    t.grad = None
    (pv.periodic_volume_encode(torch.from_numpy(x), t, st) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(first, t.grad)  # repeats bit for bit


def test_periodic_volume_total_variation_matches_jax():
    sj, st, _, table, _ = _pv("linear", 1, 9)
    ref, gref = jax.value_and_grad(lambda t: pv_j.periodic_volume_total_variation(t, sj))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    loss = pv.periodic_volume_total_variation(t, st)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    _close_grad(t.grad.numpy(), np.asarray(gref))


def test_periodic_volume_init_is_scaled_uniform():
    _, st, *_ = _pv("linear", 1, 0)
    t = pv.periodic_volume_init(st, torch.Generator().manual_seed(1))
    assert t.shape == (st.table_rows, st.features_per_level)
    assert t.abs().max() <= st.hash_init_scale and t.std() > 0.4 * st.hash_init_scale


# ------------------------------------------------------------ the order-free add


def test_order_free_add_does_not_depend_on_the_order():
    """The same terms in two orders sum to the same bits; the result is within
    the fixed point's resolution of the float64 sum."""
    rs = np.random.RandomState(10)
    n, rows = 20000, 37
    terms = (rs.normal(size=(n, 2)) * np.exp(rs.uniform(-8, 8, (n, 1)))).astype(np.float32)
    idx = rs.randint(0, rows, n)
    perm = rs.permutation(n)
    t, i = torch.from_numpy(terms), torch.from_numpy(idx)
    m = order_free.max_abs_finite(t)

    def add(order):
        acc = order_free.RowAccumulator(rows, 2, order_free.fixed_point_scale(m, n))
        acc.add(i[order], t[order])
        return acc.result()

    a, b = add(np.arange(n)), add(perm)
    assert torch.equal(a, b)
    exact = np.zeros((rows, 2))
    np.add.at(exact, idx, terms.astype(np.float64))
    np.testing.assert_allclose(a.numpy(), exact, rtol=1e-6, atol=float(m) * 2.0**-30)
