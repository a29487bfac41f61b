"""Port parity for the driver entry: `lidarnerf_tpu_torch/graft_entry.py`
against the repo's __graft_entry__.py.

- `entry()`: both `_flagship`s replaced by the same small block-hash model
  in float32 (the flagship's 2^19 table and bf16 stay on the card); the
  port's render, given the JAX parameters through the weight bridge and the
  JAX key's draws, against the JAX entry's `fn` at the render tests'
  tolerance, on the JAX entry's example rays.
- `dryrun_multichip`: gloo worlds of 1 and 2 on the CPU, each printing
  "N devices OK"; the world of 2's loss (its default batch, 32 rays a rank)
  against a world of 1 given the same 64-ray global batch, at
  tests/test_torch_parallel.py's loss tolerance.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.models import renderer as jax_renderer
from lidarnerf_tpu.models.network import NeRFNetwork as FlaxNeRF
from lidarnerf_tpu_torch import graft_entry
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.renderer import RenderConfig
from lidarnerf_tpu_torch.utils.params import params_from_jax

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, num_levels=4,
             hidden_dim=16, bound=1.0)
LOSS_RTOL = 1e-4  # tests/test_torch_parallel.py (tests/test_parallel.py:68)


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location("jax_graft_entry", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_matches_the_jax_entry(monkeypatch):
    # Both renders zero a sample's colour where its weight is <= 1e-4
    # (RenderConfig.weight_mask_thresh). Among 832 samples a ray of this
    # diffuse seeded field, some weights lie within rounding of the threshold,
    # and a colour that one package masks and the other keeps moves `image` by
    # up to 1e-4. The threshold is set to 0 in both configs, so the whole render
    # is held at the render tests' tolerance; depth and weights_sum never read it.
    monkeypatch.setattr(jax_renderer, "RenderConfig",
                        functools.partial(jax_renderer.RenderConfig, weight_mask_thresh=0.0))
    monkeypatch.setattr(graft_entry, "RenderConfig",
                        functools.partial(RenderConfig, weight_mask_thresh=0.0))
    jax_entry = _jax_entry_module()
    monkeypatch.setattr(jax_entry, "_flagship", lambda: FlaxNeRF(**SMALL))
    fn_j, (params, ro_j, rd_j, key) = jax_entry.entry()
    out_j = [np.asarray(o) for o in fn_j(params, ro_j, rd_j, key)]

    monkeypatch.setattr(graft_entry, "_flagship",
                        lambda generator=None: NeRFNetwork(**SMALL, generator=generator))
    fn, (state, ro, rd, generator) = graft_entry.entry(device="cpu")
    assert ro.device.type == "cpu" and isinstance(generator, torch.Generator)
    # the example rays: the same numpy draws, cast to float32
    np.testing.assert_array_equal(ro.numpy(), np.asarray(ro_j))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(rd_j))
    assert set(state) == set(params_from_jax(params))

    # the JAX render's draws: its key split into the jitter's and the inverse CDF's
    k_strat, k_pdf = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.uniform(k_strat, (1024, 768), jnp.float32)))
    u = torch.from_numpy(np.array(jax.random.uniform(k_pdf, (1024, 64), jnp.float32)))
    out = fn(params_from_jax(params), ro, rd, generator, noise=noise, u=u)
    assert [tuple(o.shape) for o in out] == [o.shape for o in out_j] == [(1024,), (1024, 2),
                                                                        (1024,)]
    assert out_j[2].min() > 0.1  # the seeded field has density along every ray
    tol = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_render.py's training render
    for o, o_j, name in zip(out, out_j, ("depth", "image", "weights_sum")):
        np.testing.assert_allclose(o.numpy(), o_j, err_msg=name, **tol)

    # with the example generator instead (on 64 of the rays): its own draws,
    # finite, and repeatable
    seed_state = generator.get_state()
    first = fn(state, ro[:64], rd[:64], generator)
    generator.set_state(seed_state)
    again = fn(state, ro[:64], rd[:64], generator)
    for a, b in zip(first, again):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dryrun_multichip_gloo_worlds_of_1_and_2(capsys):
    two = graft_entry.dryrun_multichip(2, device="cpu")  # 32 rays a rank: 64 in all
    one = graft_entry.dryrun_multichip(1, device="cpu", num_rays=64)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"dryrun_multichip: 2 devices OK, loss={two:.4f}",
                     f"dryrun_multichip: 1 devices OK, loss={one:.4f}"]
    assert np.isfinite(one) and np.isfinite(two)
    np.testing.assert_allclose(two, one, rtol=LOSS_RTOL)


def test_dryrun_multichip_needs_the_gpus_it_names(monkeypatch):
    monkeypatch.delenv("LIDARNERF_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 GPUs"):
        graft_entry.dryrun_multichip(2)
