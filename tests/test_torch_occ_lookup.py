"""Port parity for the occupancy bin lookup (P12): lidarnerf_tpu_torch/ops/occ_lookup.py
and lidarnerf_tpu_torch/tools/exp_occ_lookup.py against tools/exp_occ_lookup.py.

The JAX tool runs a benchmark at import, so it is never imported here: its
`lookup_pallas` and the G, CHUNK, GROUP constants are taken from its source
with `ast` and executed with `pl.pallas_call` in interpret mode, as the JAX
package's own tests run its Pallas kernels on the CPU. Every comparison is
bit for bit (int32 views, so NaN payloads count too).
"""

import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lidarnerf_tpu.models import occupancy as oj
from lidarnerf_tpu_torch.models import occupancy as ot
from lidarnerf_tpu_torch.ops.occ_lookup import occ_lookup, occ_lookup_plain
from lidarnerf_tpu_torch.tools import exp_occ_lookup

JAX_TOOL = Path(__file__).resolve().parent.parent / "tools" / "exp_occ_lookup.py"
G = 128


@pytest.fixture(scope="module")
def pallas_tool():
    """The JAX tool's kernel and constants, with pallas_call in interpret mode."""
    tree = ast.parse(JAX_TOOL.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == "lookup_pallas")
            or (isinstance(n, ast.Assign)
                and {getattr(t, "id", None) for t in n.targets} & {"G", "CHUNK", "GROUP"})]
    assert len(keep) == 4
    pl_interpret = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    pl_interpret.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = {"jax": jax, "jnp": jnp, "pl": pl_interpret, "pltpu": pltpu}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(JAX_TOOL), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def tool_inputs():
    return exp_occ_lookup.inputs()


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _jax_take(grid, idx):
    return np.asarray(jnp.take(jnp.asarray(grid).reshape(-1), jnp.asarray(idx)))


def test_plain_equals_the_pallas_kernel(pallas_tool, tool_inputs):
    """Two of the kernel's 4096-query chunks of the tool's seed-0 draws."""
    grid, idx = tool_inputs
    assert (pallas_tool["G"], pallas_tool["CHUNK"], pallas_tool["GROUP"]) == (G, 4096, 128)
    q = idx[:2 * pallas_tool["CHUNK"]]
    ref = np.asarray(pallas_tool["lookup_pallas"](jnp.asarray(q),
                                                  jnp.asarray(grid.reshape(G * G, G))))
    out = occ_lookup_plain(torch.from_numpy(q), torch.from_numpy(grid).reshape(G * G, G))
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(_bits(ref), _bits(_jax_take(grid, q)))


def _edge_indices(n, rs):
    """In range, the wrapped range [-n, 0), both ends of int32 and just past
    either end of the grid, shuffled among uniform cells."""
    special = np.array([0, n - 1, n, n + 1, -1, -n, -n - 1, 2**31 - 1, -2**31], np.int64)
    idx = np.concatenate([special, rs.randint(-2 * n, 2 * n, 4093)])
    return idx[rs.permutation(idx.size)].astype(np.int32)


@pytest.mark.parametrize("case", ["tool", "edges", "ragged", "empty"])
def test_plain_equals_jnp_take(tool_inputs, case):
    """jnp.take's semantics: values in range, NaN past either end, [-n, 0)
    wrapped; at the tool's 524,288 indices, a count no multiple of 4096, and 0."""
    grid, idx = tool_inputs
    rs = np.random.RandomState(1)
    idx = {"tool": idx, "edges": _edge_indices(G**3, rs), "ragged": idx[:4096 * 3 - 3],
           "empty": idx[:0]}[case]
    out = occ_lookup_plain(torch.from_numpy(idx), torch.from_numpy(grid))
    ref = _jax_take(grid, idx)
    assert out.dtype == torch.float32 and out.shape == idx.shape
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    if case == "edges":
        assert np.isnan(ref).any() and not np.isnan(ref).all()


@pytest.mark.parametrize("shape", ["cube", "rows", "flat"])
def test_entry_takes_each_grid_layout_on_the_cpu(tool_inputs, shape):
    """occ_lookup routes CPU tensors to the plain version, for the [G, G, G]
    volume, its [G*G, G] rows or the flat grid, an index of any shape, and
    builds no graph for a grid that requires grad."""
    grid, idx = tool_inputs
    g = torch.from_numpy(grid).reshape({"cube": (G, G, G), "rows": (G * G, G),
                                        "flat": (-1,)}[shape]).requires_grad_()
    q = torch.from_numpy(idx[:4096 * 2]).reshape(64, 128)
    out = occ_lookup(q, g)
    assert out.shape == (64, 128) and not out.requires_grad
    np.testing.assert_array_equal(_bits(out), _bits(grid.reshape(-1)[idx[:4096 * 2]]).reshape(64, 128))


def test_port_tool_draws_the_jax_tools_inputs(tool_inputs):
    """The JAX tool's module-level draws (tools/exp_occ_lookup.py:69-74),
    reproduced here from its source lines, equal the port tool's."""
    rng = np.random.RandomState(0)
    grid = rng.rand(G, G, G).astype(np.float32)
    idx = rng.randint(0, G**3, size=4096 * 128).astype(np.int32)
    src = JAX_TOOL.read_text()
    assert "grid = jnp.asarray(rng.rand(G, G, G).astype(np.float32))" in src
    assert "idx = rng.randint(0, G ** 3, size=Qp).astype(np.int32)" in src
    assert src.index("rng.rand(G, G, G)") < src.index("rng.randint(")
    np.testing.assert_array_equal(tool_inputs[0], grid)
    np.testing.assert_array_equal(tool_inputs[1], idx)
    assert tool_inputs[1].dtype == np.int32 and tool_inputs[1].shape == (524288,)


def test_port_tool_on_the_cpu(capsys):
    result = exp_occ_lookup.main([], device="cpu")
    assert result["max_abs_diff"] == 0.0 and result["bit_equal"]
    assert result["kernel_ms"] is None and result["device"] == "cpu"
    assert capsys.readouterr().out.splitlines()[0] == "max abs diff: 0.0"


def _shell_grid(Gs, inner=0.3, outer=0.5):
    """0 or 50 (no entry within an ulp of the mean threshold), as
    tests/test_torch_occupancy.py's grids."""
    c = (np.arange(Gs) + 0.5) / Gs * 2.0 - 1.0
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    return np.where((r > inner) & (r < outer), 50.0, 0.0).astype(np.float32)


@pytest.mark.parametrize("dilate", [0, 1])
def test_lookup_in_the_fast_sampler_matches_jax(dilate):
    """The lookup as occ_bin_pdf makes it: the port's occupied volume at the
    bins' cells equals jnp.take of the JAX occ3 (lidarnerf_tpu/models/
    occupancy.py:98-108) at the same cells, on a small --fast config."""
    Gs, K, N, bound = 32, 64, 64, 1.0
    cfg_j = oj.OccConfig(grid_size=Gs, bins=K, dilate=dilate)
    cfg = ot.OccConfig(grid_size=Gs, bins=K, dilate=dilate)
    grid = _shell_grid(Gs)
    rs = np.random.RandomState(3)
    o = rs.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nears = rs.uniform(0.01, 0.05, (N, 1)).astype(np.float32)
    fars = (nears * rs.uniform(10.0, 40.0, (N, 1))).astype(np.float32)
    t = (np.arange(K, dtype=np.float32) + 0.5) / K
    x = o[:, None] + d[:, None] * (nears + (fars - nears) * t)[..., None]
    gi = np.clip(np.floor((x + bound) * (Gs / (2.0 * bound))).astype(np.int64), 0, Gs - 1)
    flat = (gi[..., 0] * Gs + gi[..., 1]) * Gs + gi[..., 2]  # [N, K]

    g = jnp.asarray(grid)
    occ3 = (g > jnp.minimum(jnp.mean(g), cfg_j.density_thresh)).astype(jnp.float32)
    if dilate:
        k = 2 * dilate + 1
        occ3 = jax.lax.reduce_window(occ3, 0.0, jax.lax.max, (k, k, k), (1, 1, 1), "SAME")
    ref = np.asarray(jnp.take(occ3.reshape(-1), jnp.asarray(flat)))
    out = occ_lookup(torch.from_numpy(flat).int(),
                     ot.occupied_volume(torch.from_numpy(grid), cfg))
    assert 0 < ref.mean() < 1  # some bins occupied, some not
    np.testing.assert_array_equal(_bits(out), _bits(ref))
