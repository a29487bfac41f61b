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

# case: (rays, perturb, dilate, grid, bins)
CASES = {
    "perturb-dilate0": ("lidar", True, 0, "shell", K),
    "perturb-dilate1": ("lidar", True, 1, "shell", K),
    "det-dilate0": ("lidar", False, 0, "shell", K),
    "det-dilate1": ("lidar", False, 1, "shell", K),
    "ragged": ("ragged", True, 1, "shell", K),  # 61 rays: no multiple of 32
    "empty": ("lidar", True, 1, "zero", K),  # a cold start: every bin empty
    "full": ("lidar", False, 1, "full", K),  # every bin occupied
    "aabb": ("aabb", False, 1, "shell", K),  # RGB rays: the slab test's nears and fars
    "bins33": ("lidar", True, 1, "shell", 33),
}


def _rays(kind, seed=1):
    """(o, d, nears, fars) float32: LiDAR-style rays from near the origin with
    per-ray nears and fars, or rays through the unit box with the slab test's."""
    N = 61 if kind == "ragged" else 64
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


@pytest.mark.parametrize("case", list(CASES))
def test_plain_sampler_matches_jax(case):
    rays_kind, perturb, dilate, grid_kind, bins = CASES[case]
    kw = dict(grid_size=G, bins=bins, dilate=dilate)
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
    # float32; the normalising sum in another order (tests/test_torch_occupancy.py)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_j), rtol=1e-6, atol=0)
    # the inverse-CDF cumsum in another order, the linspace's ulp (perturb off)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-7)
    assert (np.diff(z.numpy(), axis=1) >= 0).all()


def _kernel_sum(w):
    """The kernel's normalising sum of one ray's weights w [K] float32: lane
    l adds bins l, l + 32, ... in float64 in that order, then the lanes meet
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
    bins - c empty), wherever they lie along the ray, the kernel's order
    gives torch's w.double().sum().float()."""
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


@pytest.mark.parametrize("bins", [33, 128, 1024, occ_sample_cuda.MAX_BINS])
def test_normalising_sum_rounds_alike_in_every_order(bins):
    """For every count c of occupied bins (the weights c ones and m = bins - c
    1e-8f), the exact sum lies farther from a float32 rounding boundary than
    the worst error of bins - 1 float64 adds in any order, so every order
    (the kernel's, torch's on either device) gives the same float32. In
    units of 2^-50 (1e-8f's ulp): the exact sum S; below 2^(p + 1) a
    float64 add errs by at most 2^(p - 2), a float32 ulp is 2^(p + 27)."""
    eps = np.float32(1e-8)
    M = int(np.float64(eps) * 2**50)
    assert M == np.float64(eps) * 2**50  # 1e-8f is a multiple of 2^-50
    for c in range(bins + 1):
        S = c * 2**50 + (bins - c) * M
        if c == 0:  # multiples of 2^-50 below 2^3: every partial sum exact in float64
            assert S < 2**53
            continue
        p = S.bit_length() - 51  # 2^p <= S / 2^50 < 2^(p + 1)
        ulp = 2 ** (p + 27)
        margin = abs(S % ulp - ulp // 2)  # to the nearest rounding boundary
        assert margin > (bins - 1) * 2 ** max(p - 2, 0), (bins, c)


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
    """Sizes and draws the kernel does not take raise before any launch."""
    N = 4
    args = dict(occ3=_stand_in((8, 8, 8)), rays_o=_stand_in((N, 3)), rays_d=_stand_in((N, 3)),
                nears=_stand_in((N, 1)), fars=_stand_in((N, 1)), bins=16, num_steps=T,
                bound=1.0, floor=0.05, xi=_stand_in((N, T)))
    change = {"bins": dict(bins=occ_sample_cuda.MAX_BINS + 1), "steps": dict(num_steps=0),
              "both draws": dict(u_row=_stand_in((T,))), "no draws": dict(xi=None),
              "xi shape": dict(xi=_stand_in((N, T + 1))),
              "dtype": dict(nears=_stand_in((N, 1), torch.float64)),
              "grid shape": dict(occ3=_stand_in((8, 8, 4))), "floor 0": dict(floor=0.0),
              "floor below": dict(floor=occ_sample_cuda.MIN_FLOOR_K * 16 * 0.999),
              "floor above 1": dict(floor=1.001)}[bad]
    before = occ_sample_cuda.launch_counts()
    with pytest.raises(ValueError):
        occ_sample_cuda.occ_sample(**{**args, **change})
    assert occ_sample_cuda.launch_counts() == before


@pytest.mark.parametrize("bins", [16, occ_sample_cuda.MAX_BINS])
def test_wrapper_takes_the_least_floor(monkeypatch, bins):
    """The least floor the wrapper takes, 2^-29 * bins, passes its checks up
    to MAX_BINS bins: the launch goes on to load the kernel."""
    def failed(source):
        raise RuntimeError("loaded")

    monkeypatch.setattr(cuda_lib, "load", failed)
    monkeypatch.setattr(occ_sample_cuda, "_fn", None)
    N = 4
    with pytest.raises(RuntimeError, match="loaded"):
        occ_sample_cuda.occ_sample(_stand_in((8, 8, 8)), _stand_in((N, 3)), _stand_in((N, 3)),
                                   _stand_in((N, 1)), _stand_in((N, 1)), bins, T, 1.0,
                                   occ_sample_cuda.MIN_FLOOR_K * bins, xi=_stand_in((N, T)))


def test_source_and_build_naming():
    """One source, built like the others into the git-ignored build directory
    under its own name; it names the TPU kernel it replaces, and its limit
    is the wrapper's; its launches have a slot on the card."""
    assert occ_sample_cuda.SOURCE == "occ_sample.cu"
    src = (cuda_lib.CSRC_DIR / occ_sample_cuda.SOURCE).read_text()
    assert 'extern "C" int occ_sample(' in src and "tools/exp_occ_lookup.py::lookup_pallas" in src
    assert int(re.search(r"#define MAX_BINS (\d+)", src).group(1)) == occ_sample_cuda.MAX_BINS
    floor_k = re.search(r"#define MIN_FLOOR_K (\S+)f", src).group(1)
    assert float.fromhex(floor_k) == occ_sample_cuda.MIN_FLOOR_K
    lib = cuda_lib.library_path(occ_sample_cuda.SOURCE)
    assert lib.parent == cuda_lib.BUILD_DIR and lib.name.startswith("occ_sample_")
    assert set(occ_sample_cuda.launch_counts()) == {"occ_sample"}
    assert "occ_sample" in device_counts.KERNELS
