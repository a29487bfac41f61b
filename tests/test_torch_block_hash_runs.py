"""Port parity for the run-collapsing block-hash variants (seg, win) vs the JAX package.

The seg variant walks runs of equal consecutive block rows within 4096-query
chunks, the win variant collapses fixed windows of 8, 4 or 2 queries that
share a row (block_hash_pallas.py, "segmented" and "windowed" sections).
Their run structure (`level_rows_padded`, `seg_next`, `pack_win_flags`) must
equal the JAX prep to the bit; their plain backwards are held against the
TPU kernels run in interpret mode and against `encode_bwd_plain`. Two specs:
the port's SMALL (4 levels, 2^14) and the JAX tests' SPEC (8 levels, 2^17,
desired 4096, whose scales span every window class).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidarnerf_tpu.ops import block_hash as bh
from lidarnerf_tpu.ops import block_hash_pallas as bhp
from lidarnerf_tpu_torch.ops import block_hash as tbh

SPECS = {
    "small": dict(num_levels=4, log2_hashmap_size=14, desired_resolution=32768),
    "jax_tests": dict(num_levels=8, base_resolution=16, log2_hashmap_size=17,
                      desired_resolution=4096),
}


def _specs(name):
    return bh.make_block_hash_spec(**SPECS[name]), tbh.make_block_hash_spec(**SPECS[name])


def _points(stream, n_rays=6, S=832):
    """Samples along rays from the middle of the cube (the JAX tests'
    `coherent_x`), or the same points shuffled."""
    rng = np.random.RandomState(0)
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.linspace(0.01, 0.49, S, dtype=np.float32)
    x = np.clip(0.5 + d[:, None, :] * t[None, :, None], 0.0, 1.0).reshape(-1, 3)
    if stream == "shuffled":
        x = x[np.random.RandomState(1).permutation(x.shape[0])]
    return x.astype(np.float32)


def _grads(Q, spec):
    return (np.random.RandomState(3).rand(Q, spec.output_dim) - 0.5).astype(np.float32)


@pytest.mark.parametrize("stream", ["coherent", "shuffled"])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_run_structure_equals_jax_prep(spec_name, stream):
    """level_rows_padded, seg_next and pack_win_flags equal the JAX prep to the bit."""
    spec_j, spec = _specs(spec_name)
    x = _points(stream)
    x[:2] = [[-0.1, 0.5, 0.5], [0.5, 1.2, 0.5]]  # out of range: rows of the clamped cell
    rows_j, lf, Q = bhp.prep_inputs_padded(jnp.asarray(x), spec_j)
    rows = tbh.level_rows_padded(torch.from_numpy(x), spec)
    assert rows.dtype == torch.int32 and Q == x.shape[0]
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))
    L, Qp = spec.num_levels, lf.shape[-1]
    nxt_j, nseg_j = bhp.seg_next(rows_j, L, Qp)
    nxt, nseg = tbh.seg_next(rows, L, Qp)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_j))
    np.testing.assert_array_equal(nseg.numpy(), np.asarray(nseg_j))
    np.testing.assert_array_equal(tbh.pack_win_flags(rows, L, Qp).numpy(),
                                  np.asarray(bhp.pack_win_flags(rows_j, L, Qp)))
    if stream == "coherent":  # both the walked and the per-query chunk kinds occur
        assert nseg.min() <= tbh.CHUNK // tbh.NSEG_DIV < nseg.max()


def test_seg_next_runs_and_chunk_boundary_equal_jax():
    k = tbh.CHUNK // 8
    runs = np.repeat(np.array([5, 5, 5, 9, 9, 2, 2, 2], np.int32), k)
    one_run = np.zeros(2 * tbh.CHUNK, np.int32)  # each chunk restarts its run
    for rows, L, Qp in ((runs, 1, tbh.CHUNK), (one_run, 1, 2 * tbh.CHUNK),
                        (np.concatenate([runs, one_run]), 3, tbh.CHUNK)):
        nxt_j, nseg_j = bhp.seg_next(jnp.asarray(rows), L, Qp)
        nxt, nseg = tbh.seg_next(torch.from_numpy(rows), L, Qp)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_j))
        np.testing.assert_array_equal(nseg.numpy(), np.asarray(nseg_j))
    nxt, nseg = tbh.seg_next(torch.from_numpy(runs), 1, tbh.CHUNK)
    assert nseg.tolist() == [3] and (nxt[0, : 3 * k] == 3 * k).all()


def test_pack_win_flags_bit_patterns_equal_jax():
    """The bit cases of tests/test_block_hash_win.py: uniform at every
    granularity, only the 4- and 2-windows, a 6-run that no 4-window holds."""
    rows = np.concatenate([
        np.array([5] * 8 + [5, 5, 5, 5, 9, 9, 9, 9] + [5, 9, 9, 9, 9, 9, 9, 2], np.int32),
        np.zeros(tbh.CHUNK - 24, np.int32),
    ])
    f = tbh.pack_win_flags(torch.from_numpy(rows), 1, tbh.CHUNK).numpy()
    np.testing.assert_array_equal(f, np.asarray(bhp.pack_win_flags(jnp.asarray(rows), 1, tbh.CHUNK)))
    assert f[7] & 1 and f[3] & 2 and f[1] & 4 and not f[0] & 4
    assert not f[15] & 1 and f[11] & 2 and f[15] & 2
    assert not f[19] & 2 and not f[23] & 2 and f[19] & 4 and not f[23] & 4


def test_window_classes_equal_jax():
    spec_j, spec = _specs("jax_tests")
    ws = [tbh.win_of_level(lv.scale) for lv in spec.levels]
    assert ws == [bhp._win_of_level(lv.scale) for lv in spec_j.levels]
    assert set(ws) == {8, 4, 2, 1}
    full = tbh.make_block_hash_spec(num_levels=16, log2_hashmap_size=19, desired_resolution=32768)
    assert [tbh.win_of_level(lv.scale) for lv in full.levels] == [8] * 6 + [4] * 2 + [2] * 3 + [1] * 5
    assert [lv.scale <= tbh.SEG_SCALE_MAX for lv in full.levels] == [True] * 11 + [False] * 5
    for name in ("CHUNK", "NSEG_DIV", "SEG_SCALE_MAX", "WIN_SCALE_8", "WIN_SCALE_4", "WIN_SCALE_2"):
        assert getattr(tbh, name) == getattr(bhp, name), name


def _jax_bwd(variant, x, g, spec_j):
    rows, lf, _ = bhp.prep_inputs_padded(jnp.asarray(x), spec_j)
    if variant == "seg":
        nxt, nseg = bhp.seg_next(rows, spec_j.num_levels, lf.shape[-1])
        out = bhp._bwd_seg_from_prep(rows, lf, nxt, nseg, jnp.asarray(g), spec_j, interpret=True)
    else:
        flags = bhp.pack_win_flags(rows, spec_j.num_levels, lf.shape[-1])
        out = bhp._bwd_win_from_prep(rows, lf, flags, jnp.asarray(g), spec_j, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("stream", ["coherent", "shuffled"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_plain_bwd_matches_pallas_interpret(variant, spec_name, stream):
    """encode_bwd_{seg,win}_plain vs _bwd_{seg,win}_from_prep in interpret mode."""
    spec_j, spec = _specs(spec_name)
    x = _points(stream)
    g = _grads(x.shape[0], spec)
    ref = _jax_bwd(variant, x, g, spec_j)
    out = tbh.ENCODE_BWD_PLAIN[variant](torch.from_numpy(x), torch.from_numpy(g), spec).numpy()
    # the kernel broadcasts the lane weights through a split-bf16 product
    # (~2^-17 of each term) and sums runs and windows in another order:
    # 1e-4 of the largest entry
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("stream", ["coherent", "shuffled"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("variant", ["seg", "win"])
def test_plain_bwd_matches_encode_bwd_plain(variant, spec_name, stream):
    _, spec = _specs(spec_name)
    x = _points(stream)
    x[:2] = [[-0.1, 0.5, 0.5], [0.5, 1.2, 0.5]]  # their grads are dropped
    g = torch.from_numpy(_grads(x.shape[0], spec))
    xt = torch.from_numpy(x)
    ref = tbh.encode_bwd_plain(xt, g, spec).numpy()
    out = tbh.ENCODE_BWD_PLAIN[variant](xt, g, spec).numpy()
    if stream == "coherent":  # runs of hundreds pile onto the coarse rows
        assert np.abs(ref).max() > 2
    # fp32 both sides, each run or window summed before its add: 1e-6 of the
    # largest sum of absolute terms (the size before the grads' signs cancel)
    S = tbh.encode_bwd_plain(xt, g.abs(), spec).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * S.max())


@pytest.mark.parametrize("variant", ["seg", "win"])
def test_encode_plain_matches_pallas_fwd_interpret(variant):
    """The variants' forward is B1's function: encode_plain against the TPU
    kernels B3a/B4a in interpret mode."""
    spec_j, spec = _specs("jax_tests")
    x = _points("coherent")
    table = np.random.RandomState(2).randn(spec.table_rows, 128).astype(np.float32)
    rows, lf, Q = bhp.prep_inputs_padded(jnp.asarray(x), spec_j)
    if variant == "seg":
        nxt, nseg = bhp.seg_next(rows, spec_j.num_levels, lf.shape[-1])
        ref = bhp._fwd_seg_from_prep(rows, lf, nxt, nseg, jnp.asarray(table), Q, spec_j,
                                     interpret=True)
    else:
        flags = bhp.pack_win_flags(rows, spec_j.num_levels, lf.shape[-1])
        ref = bhp._fwd_win_from_prep(rows, lf, flags, jnp.asarray(table), Q, spec_j,
                                     interpret=True)
    out = tbh.encode_plain(torch.from_numpy(x), torch.from_numpy(table), spec).numpy()
    # the TPU kernels reduce the lanes through a split-bf16 product: 2^-17
    # of the largest table entry (tests/test_torch_block_hash.py)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=2.0**-17 * np.abs(table).max())


def test_kernel_variant_precedence(monkeypatch):
    monkeypatch.delenv("LIDARNERF_SEG_KERNELS", raising=False)
    monkeypatch.delenv("LIDARNERF_WIN_KERNELS", raising=False)
    assert tbh.kernel_variant() == "default"
    monkeypatch.setenv("LIDARNERF_WIN_KERNELS", "1")
    assert tbh.kernel_variant() == "win"
    monkeypatch.setenv("LIDARNERF_SEG_KERNELS", "1")
    assert tbh.kernel_variant() == "seg"  # seg before win, as in the JAX package
    monkeypatch.setenv("LIDARNERF_SEG_KERNELS", "0")
    assert tbh.kernel_variant() == "win"
    monkeypatch.setenv("LIDARNERF_WIN_KERNELS", "yes")  # only "1" switches
    assert tbh.kernel_variant() == "default"


@pytest.mark.parametrize("variant", ["seg", "win"])
def test_odd_level_count_raises(monkeypatch, variant):
    spec = tbh.make_block_hash_spec(num_levels=3, log2_hashmap_size=12, desired_resolution=256)
    x, g = torch.rand(50, 3), torch.rand(50, spec.output_dim)
    table = torch.zeros(spec.table_rows, 128, requires_grad=True)
    with pytest.raises(ValueError, match="even level count"):
        tbh.ENCODE_BWD_PLAIN[variant](x, g, spec)
    monkeypatch.setenv({"seg": "LIDARNERF_SEG_KERNELS", "win": "LIDARNERF_WIN_KERNELS"}[variant], "1")
    with pytest.raises(ValueError, match="even level count"):
        tbh.block_hash_encode(x, table, spec)
    # the check comes before the device dispatch, so the kernel path raises the same
    from lidarnerf_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "uses_kernel", lambda t: True)
    with pytest.raises(ValueError, match="even level count"):
        tbh.block_hash_encode(x, table, spec)


@pytest.mark.parametrize("variant", ["seg", "win"])
def test_autograd_function_keeps_its_variant_for_the_backward(monkeypatch, variant):
    """The forward reads the switch; the backward runs that variant's plain
    backward even if the switch changed in between."""
    _, spec = _specs("small")
    x = torch.from_numpy(_points("coherent"))
    g = torch.from_numpy(_grads(x.shape[0], spec))
    table = torch.from_numpy(np.random.RandomState(4).randn(spec.table_rows, 128)
                             .astype(np.float32)).requires_grad_(True)
    monkeypatch.setenv({"seg": "LIDARNERF_SEG_KERNELS", "win": "LIDARNERF_WIN_KERNELS"}[variant], "1")
    out = tbh.block_hash_encode(x, table, spec)
    monkeypatch.delenv("LIDARNERF_SEG_KERNELS", raising=False)
    monkeypatch.delenv("LIDARNERF_WIN_KERNELS", raising=False)
    (out * g).sum().backward()
    np.testing.assert_array_equal(table.grad.numpy(), tbh.ENCODE_BWD_PLAIN[variant](x, g, spec).numpy())
    assert not np.array_equal(table.grad.numpy(), tbh.encode_bwd_plain(x, g, spec).numpy())
    with torch.no_grad():
        np.testing.assert_array_equal(out.numpy(), tbh.encode_plain(x, table, spec).numpy())
