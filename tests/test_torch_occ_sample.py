"""Port parity for the `--fast` sampler (lidarnerf_tpu_torch/ops/occ_sample.py).

`occ_sample_plain`, the plain version of the fused kernel
(`csrc/occ_sample.cu`), against the JAX package's `occ_bin_pdf` followed by
`occ_z_vals` on the same numpy inputs (the JAX key's draw handed to the port
as xi); the kernel's fixed-order normalising sum against torch's; the entry
point and the render on the CPU against the composition they replace; and the
kernel path's refusals. The kernel itself is held against the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py's occ-sample phase).
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.models import occupancy as oj
from lidarnerf_tpu_torch.models import occupancy as ot
from lidarnerf_tpu_torch.models import renderer
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.renderer import RenderConfig, near_far_from_aabb, render_rays
from lidarnerf_tpu_torch.ops import cuda_lib, device_counts, dispatch, occ_sample_cuda
from lidarnerf_tpu_torch.ops.occ_sample import occ_sample, occ_sample_plain
from test_torch_occupancy import shell_grid

G, K, T = 32, 64, 48

# case: (rays, perturb, dilate, grid, bins, floor)
CASES = {
    "perturb-dilate0": ("lidar", True, 0, "shell", K, 0.05),
    "perturb-dilate1": ("lidar", True, 1, "shell", K, 0.05),
    "det-dilate0": ("lidar", False, 0, "shell", K, 0.05),
    "det-dilate1": ("lidar", False, 1, "shell", K, 0.05),
    "ragged": ("ragged", True, 1, "shell", K, 0.05),  # 61 rays: no multiple of 32
    "empty": ("lidar", True, 1, "zero", K, 0.05),  # a cold start: every bin empty
    "full": ("lidar", False, 1, "full", K, 0.05),  # every bin occupied
    "aabb": ("aabb", False, 1, "shell", K, 0.05),  # RGB rays: the slab test's nears and fars
    "bins33": ("lidar", True, 1, "shell", 33, 0.05),
    # below a floor of 2^-29 x bins, and past the shared-memory bins of the kernel:
    # held by the brackets' rule (_held_to_jax_by_brackets)
    "floor0": ("lidar", True, 1, "shell", K, 0.0),
    "floor0-det": ("lidar", False, 1, "shell", K, 0.0),
    "floor1e-12": ("lidar", True, 1, "shell", K, 1e-12),
    "bins40000": ("few", True, 1, "shell", 40000, 0.05),
}
BRACKET_CASES = {"floor0", "floor0-det", "floor1e-12", "bins40000"}


def _rays(kind, seed=1):
    """(o, d, nears, fars) float32: LiDAR-style rays from near the origin with
    per-ray nears and fars (64, or 61 ragged, or 5 few), or rays through the
    unit box with the slab test's."""
    N = {"ragged": 61, "few": 5}.get(kind, 64)
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if kind == "aabb":
        o = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
        lo, hi = torch.full((3,), -1.0), torch.full((3,), 1.0)
        nears, fars = near_far_from_aabb(torch.from_numpy(o), torch.from_numpy(d), lo, hi, 0.05)
        return o, d, nears.numpy(), fars.numpy()
    nears = rng.uniform(0.01, 0.05, (N, 1)).astype(np.float32)
    fars = (nears * rng.uniform(10.0, 40.0, (N, 1))).astype(np.float32)
    return o, d, nears, fars


def _grid(kind):
    return {"shell": shell_grid(G), "zero": np.zeros((G,) * 3, np.float32),
            "full": np.full((G,) * 3, 50.0, np.float32)}[kind]


def _held_to_jax_by_brackets(z, pdf, z_j, pdf_j, key, arrays, xi, perturb):
    """The rule for a floor below 2^-29 x bins, or many bins, fixed from the
    arithmetic before these cases ran. The port's cdf is exact, then rounded
    once (`occ_cdf`); the JAX package's is a float32 cumsum, whose partial
    sums round. Below that floor an empty bin adds less than half an ulp of
    a cdf near 1, so both float32 cdfs have plateaus with their edges in
    other places, and at many bins the cumsum's rounding reaches a bin's
    mass; a u between the two cdfs' values at an edge lies in a different
    bin on each route, and z then differs by up to a run of bins. So:
    - pdf: the port's sum rounds once, the JAX package's float32 sum of K
      terms in any order errs by at most (K - 1) 2^-24 relative, and each
      side divides and mixes with a rounding or two: rtol (K + 2) 2^-24;
    - cdf: |port - JAX| <= (2K + 3) 2^-24 (the cumsum's K roundings below 2,
      the port's one, the pdf's error summed);
    - the bin below u, b = min(count of cdf[1:] <= u, K - 1), on each route
      from its own cdf and u. Where the two agree, z is within the present
      rtol=1e-5, atol=1e-7 plus the bin width times what the bracket's
      inputs move frac = (u - c_b) / (c_a - c_b) by, (|du| + |dc_b| + |dc_a|)
      / min(c_a - c_b) (the whole bin where either denominator falls under
      the 1e-12 guard); where they differ, both z lie between the lower
      bracket's lower edge and the upper bracket's upper edge (within the
      same rtol and atol), and such a sample needs u within |du| + max|dc|
      of one of the port's cdf values: the count of them is asserted below
      that and reported.
    Returns the number of samples in different brackets."""
    _, _, nears, fars = arrays
    N, Kb = pdf.shape
    np.testing.assert_allclose(pdf.numpy(), pdf_j, rtol=(Kb + 2) * 2.0**-24, atol=0)
    cdf = ot.occ_cdf(pdf).double().numpy()
    cdf_j = np.concatenate([np.zeros((N, 1)), np.asarray(jnp.cumsum(jnp.asarray(pdf_j), axis=-1))],
                           axis=-1).astype(np.float64)
    dc = np.abs(cdf - cdf_j)
    assert dc.max() <= (2 * Kb + 3) * 2.0**-24, dc.max()
    if perturb:  # u as each package computes it
        u = ((torch.arange(T, dtype=torch.float32)[None, :] + xi) / T).numpy()
        u_j = np.asarray((jnp.arange(T, dtype=jnp.float32)[None, :]
                          + jax.random.uniform(key, (N, T), dtype=jnp.float32)) / T)
    else:
        u = np.broadcast_to(torch.linspace(0.0, 1.0, T).numpy(), (N, T))
        u_j = np.broadcast_to(np.asarray(jnp.linspace(0.0, 1.0, T, dtype=jnp.float32)), (N, T))
    u, u_j = u.astype(np.float64), u_j.astype(np.float64)
    b = np.minimum((cdf[:, None, 1:] <= u[:, :, None]).sum(-1), Kb - 1)
    b_j = np.minimum((cdf_j[:, None, 1:] <= u_j[:, :, None]).sum(-1), Kb - 1)
    rows = np.arange(N)[:, None]
    bin_w = (fars - nears).astype(np.float64) / Kb
    tol = 1e-7 + 1e-5 * np.abs(z_j)
    same = b == b_j
    d = cdf[rows, b + 1] - cdf[rows, b]
    d_j = cdf_j[rows, b + 1] - cdf_j[rows, b]
    guarded = (d < 1e-12) | (d_j < 1e-12)
    moved = (np.abs(u - u_j) + dc[rows, b] + dc[rows, b + 1]) / np.where(guarded, 1.0,
                                                                         np.minimum(d, d_j))
    moved = np.where(guarded, 1.0, np.minimum(moved, 1.0))
    err = np.abs(z.numpy().astype(np.float64) - z_j)
    assert (err <= tol + bin_w * moved)[same].all(), (err - tol - bin_w * moved)[same].max()
    lo = nears + bin_w * np.minimum(b, b_j) - tol
    hi = nears + bin_w * (np.maximum(b, b_j) + 1) + tol
    for zz in (z.numpy(), z_j):
        assert ((lo <= zz) & (zz <= hi))[~same].all()
    near_edge = (np.abs(u[:, :, None] - cdf[:, None, :]).min(-1)
                 <= np.abs(u - u_j) + dc.max(-1, keepdims=True))
    disputed = int((~same).sum())
    assert disputed <= int(near_edge.sum()), (disputed, int(near_edge.sum()))
    print(f"{disputed} of {N * T} samples in different brackets ({int(near_edge.sum())} near an "
          f"edge); cdf max |port - JAX| {dc.max():.3g}")
    return disputed


@pytest.mark.parametrize("case", list(CASES))
def test_plain_sampler_matches_jax(case):
    rays_kind, perturb, dilate, grid_kind, bins, floor = CASES[case]
    kw = dict(grid_size=G, bins=bins, dilate=dilate, floor=floor)
    cfg_j, cfg = oj.OccConfig(**kw), ot.OccConfig(**kw)
    grid = _grid(grid_kind)
    arrays = _rays(rays_kind)
    N = arrays[0].shape[0]
    pdf_j = oj.occ_bin_pdf(jnp.asarray(grid), *map(jnp.asarray, arrays), cfg_j, 1.0)
    key = jax.random.PRNGKey(2)
    z_j = oj.occ_z_vals(key, jnp.asarray(arrays[2]), jnp.asarray(arrays[3]), pdf_j, T, perturb)
    xi = torch.from_numpy(np.array(jax.random.uniform(key, (N, T), dtype=jnp.float32)))
    occ3 = ot.occupied_volume(torch.from_numpy(grid), cfg)
    z, pdf = occ_sample_plain(occ3, *map(torch.from_numpy, arrays), cfg, 1.0, T, perturb,
                              xi=xi if perturb else None, want_pdf=True)
    assert z.shape == (N, T) and pdf.shape == (N, bins)
    uniform = np.ptp(np.asarray(pdf_j), axis=-1) < 1e-6
    assert uniform.all() == (grid_kind != "shell")  # the shell shapes some rays' pdfs
    assert (np.diff(z.numpy(), axis=1) >= 0).all()
    if case in BRACKET_CASES:
        _held_to_jax_by_brackets(z, pdf, np.asarray(z_j, np.float64), np.asarray(pdf_j), key,
                                 arrays, xi, perturb)
        return
    # float32; the normalising sum in another order (tests/test_torch_occupancy.py)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_j), rtol=1e-6, atol=0)
    # the inverse-CDF cumsum in another order, the linspace's ulp (perturb off)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-7)


def _kernel_sum(w):
    """A warp's normalising sum of one ray's weights w [K] float32: lane l
    adds bins l, l + 32, ... in float64 in that order, then the lanes meet
    in a butterfly (lane i adds lane i ^ 16, ^ 8, ..., ^ 1), rounded once."""
    lanes = np.zeros(32)
    for lane in range(32):
        for k in range(lane, len(w), 32):
            lanes[lane] = lanes[lane] + np.float64(w[k])
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    assert (lanes == lanes[0]).all()  # every lane holds the same sum
    return np.float32(lanes[0])


@pytest.mark.parametrize("bins", [128, 64, 33])
def test_kernel_sum_order_rounds_as_torch(bins):
    """Every weight is 1 or 1e-8f, so the float32 of the float64 sum does not
    depend on the order of the adds: for every count c of occupied bins (m =
    bins - c empty), wherever they lie along the ray, a warp's lane order
    gives torch's w.double().sum().float(), and so does the count form
    c + m * 1e-8f that the kernel and `volume_bin_pdf` take."""
    rs = np.random.RandomState(bins)
    eps = np.float32(1e-8)
    for c in range(bins + 1):
        m = bins - c
        for where in (np.arange(c), np.arange(m, bins), rs.permutation(bins)[:c],
                      np.arange(bins)[::max(1, bins // max(c, 1))][:c]):
            w = np.full(bins, 0.0, np.float32)
            w[where] = 1.0
            w = (torch.from_numpy(w) + 1e-8).numpy()  # as volume_bin_pdf adds it
            assert set(w.tolist()) <= {1.0, float(eps)} and int((w == 1.0).sum()) == c
            torch_sum = torch.from_numpy(w).double().sum().float().item()
            assert _kernel_sum(w) == np.float32(torch_sum), (c, m)
            assert np.float32(np.float64(c) + np.float64(m) * np.float64(eps)) == _kernel_sum(w)


def _float32_of(X):
    """The float32 nearest X * 2^-50 (ties to even), X a non-negative int."""
    shift = X.bit_length() - 24  # keep 24 significant bits
    if shift <= 0:
        return np.float32(X * 2.0**-50)
    q, r = divmod(X, 1 << shift)
    if 2 * r > 1 << shift or (2 * r == 1 << shift and q & 1):
        q += 1
    return np.float32(q * 2.0 ** (shift - 50))


@pytest.mark.parametrize("bins", [33, 128, 1024, 32768, 65536, 2**20])
def test_normalising_sum_rounds_alike_in_every_order(bins):
    """For every count c of occupied bins (the weights c ones and m = bins -
    c 1e-8f): the count form c + m * 1e-8f, one float64 add, rounds to the
    float32 of the exact sum (the kernel's and `volume_bin_pdf`'s sum); and
    the exact sum lies farther from a float32 rounding boundary than the
    worst error of bins - 1 float64 adds in any order, so every order gives
    that float32 too, up to 65,536 bins. At 2^20 bins 12 counts lie nearer:
    there an order of adds could round otherwise, and no route takes one.
    In units of 2^-50 (1e-8f's ulp): the exact sum S; below 2^(p + 1) a
    float64 add errs by at most 2^(p - 2), a float32 ulp is 2^(p + 27)."""
    eps = np.float32(1e-8)
    M = int(np.float64(eps) * 2**50)
    assert M == np.float64(eps) * 2**50  # 1e-8f is a multiple of 2^-50
    assert ot.W_EMPTY == np.float64(eps)
    unproven = []
    for c in range(bins + 1):
        S = c * 2**50 + (bins - c) * M
        count_form = np.float32(np.float64(c) + np.float64(bins - c) * np.float64(eps))
        assert count_form == _float32_of(S), (bins, c)
        if c == 0:  # multiples of 2^-50 below 2^53: every partial sum exact in float64
            assert S < 2**53
            continue
        p = S.bit_length() - 51  # 2^p <= S / 2^50 < 2^(p + 1)
        ulp = 2 ** (p + 27)
        margin = abs(S % ulp - ulp // 2)  # to the nearest rounding boundary
        if not margin > (bins - 1) * 2 ** max(p - 2, 0):
            unproven.append(c)
    assert len(unproven) == (12 if bins == 2**20 else 0), unproven


@pytest.mark.parametrize("bins", [1, 33, 128, 2048, 40000])
def test_cdf_equals_the_float64_cumsum_from_the_exact_floor(bins):
    """From a floor of 2^-29 x bins every pdf entry is at least 2^-29, so on
    the 2^-52 grid, and every partial sum lies below 2: the float64 cumsum is
    exact and rounds once, and `occ_cdf`'s count form equals it bit for bit
    (the cdf before the count form, unchanged at the default floor and
    every floor from 2^-29 x bins to 1), at occupied shares from none to
    all."""
    rng = np.random.RandomState(bins)
    Gv, N = 16, 8
    o = torch.from_numpy(rng.uniform(-0.2, 0.2, (N, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    nears = torch.from_numpy(rng.uniform(0.01, 0.05, (N, 1)).astype(np.float32))
    fars = nears * 40.0
    for floor in (2.0**-29 * bins, 0.05, 1.0):
        cfg = ot.OccConfig(grid_size=Gv, bins=bins, floor=floor)
        for share in (0.0, 0.01, 0.3, 0.9, 1.0):
            occ3 = torch.from_numpy((rng.rand(Gv, Gv, Gv) < share).astype(np.float32))
            pdf = ot.volume_bin_pdf(occ3, o, d, nears, fars, cfg, 1.0)
            assert pdf.min() >= 2.0**-29
            cdf = ot.occ_cdf(pdf)
            assert cdf.shape == (N, bins + 1) and (cdf[:, 0] == 0).all()
            assert torch.equal(cdf[:, 1:], torch.cumsum(pdf.double(), dim=-1).float()), (
                floor, share)


@pytest.mark.parametrize("perturb", [True, False], ids=["perturb", "det"])
def test_entry_on_the_cpu_is_the_composition(perturb):
    """On CPU tensors `occ_sample` is occ_z_vals(occ_bin_pdf(grid)) bit for
    bit, with xi drawn from the generator in the same call (its state after
    the call the same) or the inclusive linspace row."""
    cfg = ot.OccConfig(grid_size=G, bins=K)
    grid = torch.from_numpy(shell_grid(G))
    o, d, nears, fars = map(torch.from_numpy, _rays("lidar", seed=3))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    z, pdf = occ_sample(ot.occupied_volume(grid, cfg), o, d, nears, fars, cfg, 1.0, T, perturb,
                        want_pdf=True, generator=g1)
    ref_pdf = ot.occ_bin_pdf(grid, o, d, nears, fars, cfg, 1.0)
    ref_z = ot.occ_z_vals(nears, fars, ref_pdf, T, perturb, generator=g2)
    assert torch.equal(pdf, ref_pdf) and torch.equal(z, ref_z)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_fast_render_equals_the_composed_sampler(monkeypatch, train):
    """`render_rays` under --fast, on a fixed seed, equals the render whose
    sampler is the composition it had before the fused sampler (occ_bin_pdf
    of the grid, then occ_z_vals with the generator's draw) bit for bit, and
    leaves the generator in the same state."""
    torch.manual_seed(0)
    net = NeRFNetwork(encoding="blockhash", desired_resolution=64, log2_hashmap_size=10,
                      hidden_dim=8)
    with torch.no_grad():
        net.hash_table.mul_(1e4)  # densities that vary along the rays
    occ = ot.OccConfig(grid_size=16, bins=32)
    cfg = RenderConfig(num_steps=24, upsample_steps=8, min_near_lidar=0.05, occ=occ)
    grid = torch.from_numpy(shell_grid(16))
    o, d, _, _ = map(torch.from_numpy, _rays("ragged", seed=4))

    def render():
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            out = render_rays(net, o, d, cfg, train=train, generator=gen, occ_grid=grid)
        return out, gen.get_state()

    fused, fused_gen = render()

    def composed(occ3, rays_o, rays_d, nears, fars, occ_cfg, bound, num_steps, perturb,
                 xi=None, generator=None):
        pdf = ot.occ_bin_pdf(grid, rays_o, rays_d, nears, fars, occ_cfg, bound)
        return ot.occ_z_vals(nears, fars, pdf, num_steps, perturb=perturb, xi=xi,
                             generator=generator)

    monkeypatch.setattr(renderer, "occ_sampler", SimpleNamespace(occ_sample=composed))
    ref, ref_gen = render()
    for k in ("depth", "image", "weights_sum"):
        assert torch.equal(fused[k], ref[k]), k
    assert torch.equal(fused_gen, ref_gen)
    assert fused["depth"].shape == (61,) and torch.isfinite(fused["depth"]).all()


def _stand_in(shape, dtype=torch.float32):
    """A stand-in that passes the wrapper's checks as a CUDA tensor would."""
    return SimpleNamespace(is_cuda=True, device=torch.device("cuda", 0), dtype=dtype,
                           shape=shape, is_contiguous=lambda: True, data_ptr=lambda: 0)


def test_kernel_path_never_falls_back(monkeypatch):
    """The wrapper takes CUDA tensors only, and the entry point on the kernel
    path goes to it: on the CPU tensors here it raises instead of falling
    back to the plain version; nothing is counted."""
    cfg = ot.OccConfig(grid_size=8, bins=16)
    occ3 = torch.zeros(8, 8, 8)
    o, d, nears, fars = map(torch.from_numpy, _rays("lidar"))
    before = occ_sample_cuda.launch_counts()
    with pytest.raises(ValueError, match="occ_sample takes CUDA tensors"):
        occ_sample_cuda.occ_sample(occ3, o, d, nears, fars, 16, T, 1.0, 0.05,
                                   u_row=torch.zeros(T))
    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: True)
    with pytest.raises(ValueError, match="occ_sample takes CUDA tensors"):
        occ_sample(occ3, o, d, nears, fars, cfg, 1.0, T, True)
    assert occ_sample_cuda.launch_counts() == before


def test_failed_load_raises(monkeypatch):
    """A kernel library that does not build or load makes the wrapper raise:
    no launch is counted and nothing falls back."""
    def failed(source):
        raise RuntimeError(f"kernel build failed:\n{source}: nvcc exited 1")

    monkeypatch.setattr(cuda_lib, "load", failed)
    monkeypatch.setattr(occ_sample_cuda, "_fn", None)
    N = 4
    before = occ_sample_cuda.launch_counts()
    with pytest.raises(RuntimeError, match="occ_sample.cu: nvcc exited 1"):
        occ_sample_cuda.occ_sample(_stand_in((8, 8, 8)), _stand_in((N, 3)), _stand_in((N, 3)),
                                   _stand_in((N, 1)), _stand_in((N, 1)), 16, T, 1.0, 0.05,
                                   xi=_stand_in((N, T)))
    assert occ_sample_cuda._fn is None and occ_sample_cuda.launch_counts() == before


@pytest.mark.parametrize("bad", ["bins", "steps", "both draws", "no draws", "xi shape", "dtype",
                                 "grid shape", "floor 0", "floor below", "floor above 1"])
def test_wrapper_limits(bad):
    """Sizes, draws and floors the kernel does not take raise before any
    launch: no bins, no samples, a floor below 0 (the least negative double
    and -0.05) or above 1."""
    N = 4
    args = dict(occ3=_stand_in((8, 8, 8)), rays_o=_stand_in((N, 3)), rays_d=_stand_in((N, 3)),
                nears=_stand_in((N, 1)), fars=_stand_in((N, 1)), bins=16, num_steps=T,
                bound=1.0, floor=0.05, xi=_stand_in((N, T)))
    change = {"bins": dict(bins=0), "steps": dict(num_steps=0),
              "both draws": dict(u_row=_stand_in((T,))), "no draws": dict(xi=None),
              "xi shape": dict(xi=_stand_in((N, T + 1))),
              "dtype": dict(nears=_stand_in((N, 1), torch.float64)),
              "grid shape": dict(occ3=_stand_in((8, 8, 4))), "floor 0": dict(floor=-5e-324),
              "floor below": dict(floor=-0.05), "floor above 1": dict(floor=1.001)}[bad]
    before = occ_sample_cuda.launch_counts()
    with pytest.raises(ValueError):
        occ_sample_cuda.occ_sample(**{**args, **change})
    assert occ_sample_cuda.launch_counts() == before


@pytest.mark.parametrize("bins", [16, 2**16])
def test_wrapper_takes_the_least_floor(monkeypatch, bins):
    """The least floor, 0, passes the wrapper's checks, in shared memory and
    past SMEM_BINS bins (the workspace's route): the launch goes on to load
    the kernel."""
    def failed(source):
        raise RuntimeError("loaded")

    monkeypatch.setattr(cuda_lib, "load", failed)
    monkeypatch.setattr(occ_sample_cuda, "_fn", None)
    N = 4
    assert (bins > occ_sample_cuda.SMEM_BINS) == (bins == 2**16)
    with pytest.raises(RuntimeError, match="loaded"):
        occ_sample_cuda.occ_sample(_stand_in((8, 8, 8)), _stand_in((N, 3)), _stand_in((N, 3)),
                                   _stand_in((N, 1)), _stand_in((N, 1)), bins, T, 1.0, 0.0,
                                   xi=_stand_in((N, T)))


def test_source_and_build_naming():
    """One source, built like the others into the git-ignored build directory
    under its own name; it names the TPU kernel it replaces, and its limits
    are the wrapper's; its launches have a slot on the card."""
    assert occ_sample_cuda.SOURCE == "occ_sample.cu"
    src = (cuda_lib.CSRC_DIR / occ_sample_cuda.SOURCE).read_text()
    assert 'extern "C" int occ_sample(' in src and "tools/exp_occ_lookup.py::lookup_pallas" in src
    assert int(re.search(r"#define MAX_BINS (\d+)", src).group(1)) == occ_sample_cuda.MAX_BINS
    assert int(re.search(r"#define SMEM_BINS (\d+)", src).group(1)) == occ_sample_cuda.SMEM_BINS
    assert "MIN_FLOOR" not in src  # any floor in [0, 1]
    lib = cuda_lib.library_path(occ_sample_cuda.SOURCE)
    assert lib.parent == cuda_lib.BUILD_DIR and lib.name.startswith("occ_sample_")
    assert set(occ_sample_cuda.launch_counts()) == {"occ_sample"}
    assert "occ_sample" in device_counts.KERNELS
