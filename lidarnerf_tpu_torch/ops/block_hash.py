"""Block-hash multiresolution grid encoder (counterpart of lidarnerf_tpu/ops/block_hash.py).

Each level's corner grid is tiled into blocks of 3x3x3 cells = 4x4x4 corners;
a block row of the table stores its 64 corners x 2 channels = 128 float32, so
a query's 8 trilinear corners always lie in one row. Coarse levels index
blocks densely, fine levels hash the block coordinate with the prime-XOR of
instant-ngp into 2^log2_hashmap_size / 64 blocks per level.

`block_hash_encode` is the entry point, an autograd Function on both
devices. A CUDA tensor goes through the hand-written kernels
(`block_hash_cuda.py`): the forward `csrc/block_hash_fwd.cu` and, for the
table gradient, the backward `csrc/block_hash_bwd.cu`, whose result is the
same bit for bit from run to run, as the JAX package's. A CPU tensor goes
through their plain versions below: `encode_plain`, the counterpart of
`_encode_xla`, and `encode_bwd_plain`, the counterpart of the XLA branch of
`_encode_bwd`. The plain versions are also the kernels' oracles on the card.

Two run-collapsing variants compute the same function with the work of a
run of equal consecutive block rows done once (`kernel_variant`, switched by
`LIDARNERF_SEG_KERNELS=1` or `LIDARNERF_WIN_KERNELS=1`, read at each call):
"seg" walks runs within 4096-query chunks (kernels B3a/B3b,
`csrc/block_hash_seg_{fwd,bwd}.cu`), "win" collapses fixed windows of 8, 4
or 2 queries that share a row (B4a/B4b, `csrc/block_hash_win_{fwd,bwd}.cu`).
Their forwards equal B1's bit for bit, so `encode_plain` is their plain
version; their backwards sum each run or window before one scatter-add,
`encode_bwd_seg_plain` and `encode_bwd_win_plain` below. The run structure
(`level_rows_padded`, `seg_next`, `pack_win_flags`) is that of
block_hash_pallas.py's prep.

The seam options (`--seam_tie`, `--seam_sync_hashed`, `--alpha_seam`) are
`tie_dense_seams`, `sync_hashed_seams` and `block_hash_seam_loss` at the
end: plain PyTorch on both devices, equal to the JAX package's bit for bit
(the loss to rounding) given the same samples.
"""

import os
from dataclasses import dataclass

import numpy as np
import torch

from lidarnerf_tpu_torch.ops import dispatch

_HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

CELLS_PER_BLOCK = 3  # cells per block axis
CORNERS_PER_BLOCK = 4  # corners per block axis
ROW_WIDTH = 128  # 4^3 corners * 2 channels
LEVEL_DIM = 2

# run structure of the seg and win variants (block_hash_pallas.py:58-73, 778-791)
CHUNK = 4096  # queries per chunk; runs and windows never cross a chunk
NSEG_DIV = 5  # a chunk walks its runs only if it has at most CHUNK // NSEG_DIV of them
SEG_SCALE_MAX = 3000.0  # levels of larger scale take the per-query path
WIN_SCALE_8 = 260.0
WIN_SCALE_4 = 700.0
WIN_SCALE_2 = 2700.0
VARIANTS = ("default", "seg", "win")


@dataclass(frozen=True)
class _Level:
    scale: float
    max_cell: int  # largest cell index reachable from x in [0, 1]
    blocks_axis: int  # dense block-grid extent
    dense: bool


@dataclass(frozen=True)
class BlockHashSpec:
    num_levels: int = 16
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    levels: tuple = ()

    @property
    def blocks_per_level(self) -> int:
        return max(8, 2**self.log2_hashmap_size // (CORNERS_PER_BLOCK**3))

    @property
    def output_dim(self) -> int:
        return self.num_levels * LEVEL_DIM

    @property
    def table_rows(self) -> int:
        return self.num_levels * self.blocks_per_level


def make_block_hash_spec(
    num_levels=16,
    base_resolution=16,
    log2_hashmap_size=19,
    desired_resolution=None,
    per_level_scale=2.0,
) -> BlockHashSpec:
    """Same per-level scale law and levels as the JAX package (block_hash.py:88-125)."""
    if desired_resolution is not None:
        if num_levels > 1:
            per_level_scale = float(
                np.exp2(
                    np.log2(desired_resolution / base_resolution) / (num_levels - 1)
                )
            )
        else:
            per_level_scale = 1.0
    blocks_per_level = BlockHashSpec(log2_hashmap_size=log2_hashmap_size).blocks_per_level
    S = np.log2(per_level_scale)
    levels = []
    for lvl in range(num_levels):
        scale = float(np.exp2(lvl * S) * base_resolution - 1.0)
        max_cell = int(np.floor(scale + 0.5))
        blocks_axis = max_cell // CELLS_PER_BLOCK + 1
        dense = blocks_axis**3 <= blocks_per_level
        levels.append(_Level(scale, max_cell, blocks_axis, dense))
    return BlockHashSpec(
        num_levels=num_levels,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        per_level_scale=per_level_scale,
        levels=tuple(levels),
    )


def block_hash_init(spec: BlockHashSpec, generator=None, device=None):
    """Uniform(-1e-4, 1e-4) table [L*B, 128] float32, drawn from `generator`."""
    t = torch.rand(
        (spec.table_rows, ROW_WIDTH),
        generator=generator,
        device=device,
        dtype=torch.float32,
    )
    return t * 2e-4 - 1e-4


# ---------------------------------------------------------------- indexing


def level_indices_and_weights(x01, level: _Level, level_idx: int, spec: BlockHashSpec):
    """Per-level row index + per-axis interpolation weight vectors.

    Args:
        x01: [Q, 3] in [0, 1].

    Returns:
        rows: [Q] int64 row index into the flat table.
        w: [Q, 12] = concat(wx4, wy4, wz4) per-axis 4-vectors.
    """
    pos = x01.float() * level.scale + 0.5
    cell = torch.floor(pos)
    frac = pos - cell
    cell = torch.clamp(cell.long(), 0, level.max_cell)
    block = torch.div(cell, CELLS_PER_BLOCK, rounding_mode="floor")
    local = cell - block * CELLS_PER_BLOCK  # in [0, 2]

    if level.dense:
        nb = level.blocks_axis
        idx = (block[:, 0] * nb + block[:, 1]) * nb + block[:, 2]
    else:
        # uint32 wraparound of the products, done in int64 and masked
        idx = (
            ((block[:, 0] * _HASH_PRIMES[0]) & _U32)
            ^ ((block[:, 1] * _HASH_PRIMES[1]) & _U32)
            ^ ((block[:, 2] * _HASH_PRIMES[2]) & _U32)
        )
    idx = idx % spec.blocks_per_level
    rows = idx + level_idx * spec.blocks_per_level

    lanes = torch.arange(CORNERS_PER_BLOCK, device=x01.device)[None, :]  # [1, 4]
    ws = []
    for a in range(3):
        lo = local[:, a : a + 1]
        f = frac[:, a : a + 1]
        w4 = torch.where(lanes == lo, 1.0 - f, 0.0) + torch.where(lanes == lo + 1, f, 0.0)
        ws.append(w4)
    return rows, torch.cat(ws, dim=-1)


def lane_weight_row(w12):
    """[Q, 12] per-axis weights -> [Q, 128] per-lane weight row.

    Lane j holds corner (sx, sy, sz) channel c with j = ((sx*4 + sy)*4 + sz)*2 + c.
    """
    wx, wy, wz = w12[:, 0:4], w12[:, 4:8], w12[:, 8:12]
    wx_l = torch.repeat_interleave(wx, 32, dim=1)  # j>>5
    wy_l = torch.repeat_interleave(wy, 8, dim=1).repeat(1, 4)  # (j>>3)&3
    wz_l = torch.repeat_interleave(wz, 2, dim=1).repeat(1, 16)  # (j>>1)&3
    return wx_l * wy_l * wz_l


def rows_to_features(rows128, w12):
    """Contract fetched block rows with trilinear weights -> [Q, 2]."""
    prod = rows128 * lane_weight_row(w12)
    return torch.stack([prod[:, 0::2].sum(dim=1), prod[:, 1::2].sum(dim=1)], dim=-1)


def _out_of_range(x):
    """[Q, 1] bool: the query lies outside [0, 1]^3 (its features are zero)."""
    return ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)


def encode_plain(x, table, spec: BlockHashSpec):
    """Plain PyTorch encoder: [Q, 3] -> [Q, 2L] (`_encode_xla` + the out-of-range zeroing).

    Differentiable w.r.t. the table through autograd's gather backward.
    """
    feats = []
    for li, level in enumerate(spec.levels):
        rows_idx, w12 = level_indices_and_weights(x, level, li, spec)
        feats.append(rows_to_features(table[rows_idx], w12))
    out = torch.cat(feats, dim=-1)
    return torch.where(_out_of_range(x), 0.0, out)


def _level_terms(x, g, li, level, spec):
    """Rows [Q] and the [Q, 128] lane-weight x feature-grad terms of one level."""
    rows_idx, w12 = level_indices_and_weights(x, level, li, spec)
    # lane j holds channel j & 1 -> [g0, g1, g0, g1, ...]
    g_lane = g[:, 2 * li : 2 * li + 2].repeat(1, ROW_WIDTH // LEVEL_DIM)
    return rows_idx, lane_weight_row(w12) * g_lane


def encode_bwd_plain(x, g, spec: BlockHashSpec):
    """Plain table gradient: [Q, 3] points, [Q, 2L] feature grads -> [L*B, 128] float32.

    The XLA branch of the JAX package's `_encode_bwd` (block_hash.py:268-300):
    grads of out-of-range queries are zeroed, then per level each query's
    lane weights times its two feature grads are scatter-added, duplicates
    summed, into a zero table.
    """
    g = torch.where(_out_of_range(x), 0.0, g.float())
    grad = torch.zeros((spec.table_rows, ROW_WIDTH), dtype=torch.float32, device=x.device)
    for li, level in enumerate(spec.levels):
        grad.index_add_(0, *_level_terms(x, g, li, level, spec))
    return grad


# ------------------------------------------------ run-collapsing variants

WIN_BIT = {8: 1, 4: 2, 2: 4}  # pack_win_flags' bit of a uniform window of each size


def kernel_variant() -> str:
    """The encoder variant the environment asks for, read at each call.

    `LIDARNERF_SEG_KERNELS=1` selects "seg", else `LIDARNERF_WIN_KERNELS=1`
    selects "win", else "default": the JAX package's precedence
    (lidarnerf_tpu/ops/block_hash.py:244-253).
    """
    if os.environ.get("LIDARNERF_SEG_KERNELS", "0") == "1":
        return "seg"
    if os.environ.get("LIDARNERF_WIN_KERNELS", "0") == "1":
        return "win"
    return "default"


def check_even_levels(spec: BlockHashSpec, variant: str):
    """The seg and win variants pair levels, as their TPU kernels assert."""
    if variant != "default" and spec.num_levels % 2:
        raise ValueError(f"the {variant} variant needs an even level count, got {spec.num_levels}")


def win_of_level(scale: float) -> int:
    """Window size of a level in the win variant (block_hash_pallas.py:784-791)."""
    if scale <= WIN_SCALE_8:
        return 8
    if scale <= WIN_SCALE_4:
        return 4
    if scale <= WIN_SCALE_2:
        return 2
    return 1


def level_rows_padded(x, spec: BlockHashSpec):
    """[Q, 3] -> [L * Qp] int32 within-level block rows, level-major.

    The queries are padded with zeros to Qp, a multiple of CHUNK, as
    block_hash_pallas.prep_inputs_padded does (:233-239).
    """
    Q = x.shape[0]
    xp = torch.cat([x.float(), x.new_zeros(((-Q) % CHUNK, 3), dtype=torch.float32)])
    B = spec.blocks_per_level
    rows = [level_indices_and_weights(xp, lv, li, spec)[0] - li * B
            for li, lv in enumerate(spec.levels)]
    return torch.cat(rows).to(torch.int32)


def seg_next(rows, L: int, Qp: int):
    """[L * Qp] int32 rows -> (next [L*C, CHUNK] int32, nseg [L*C] int32), C = Qp // CHUNK.

    next[q] is the first q' > q of q's chunk whose row differs from q's, else
    CHUNK; nseg counts each chunk's runs (block_hash_pallas.py:446-465).
    """
    r = rows.reshape(L * (Qp // CHUNK), CHUNK)
    flag = torch.cat([torch.ones_like(r[:, :1], dtype=torch.bool), r[:, 1:] != r[:, :-1]], dim=1)
    q = torch.arange(CHUNK, dtype=torch.int32, device=rows.device)
    c = torch.where(flag, q[None, :], CHUNK)
    nxt = torch.flip(torch.cummin(torch.flip(c, [1]), dim=1).values, [1])
    nxt = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], CHUNK)], dim=1)
    return nxt.to(torch.int32), flag.sum(dim=1, dtype=torch.int32)


def pack_win_flags(rows, L: int, Qp: int):
    """[L * Qp] int32 rows -> [L * Qp] int32 uniformity flags (block_hash_pallas.py:794-821).

    Read at the last index of a window: bit 0 says the 8 queries ending
    there share one row, bit 1 the 4, bit 2 the 2. Windows never straddle a
    chunk.
    """
    r = rows.reshape(L * (Qp // CHUNK), CHUNK)
    e = torch.cat([torch.zeros_like(r[:, :1], dtype=torch.bool), r[:, 1:] == r[:, :-1]], dim=1)

    def sh(m, k):  # m[i - k], False at the chunk start
        return torch.cat([torch.zeros_like(m[:, :k]), m[:, :-k]], dim=1)

    u4 = e & sh(e, 1) & sh(e, 2)
    u8 = u4 & sh(e, 3) & sh(u4, 4)
    return (u8.int() + u4.int() * 2 + e.int() * 4).reshape(-1)


def _collapsed_bwd(x, g, spec, variant, group_of_level):
    """Shared body of the seg and win plain backwards.

    `group_of_level(li, level, rows, Qp)` gives, for the padded stream of
    one level, a group id per query (runs or windows: consecutive, never
    crossing a chunk) and which groups collapse, or None when the whole
    level takes per-query adds. A collapsing group's terms are summed first
    and added once, at its row; every other query adds its own terms.
    """
    check_even_levels(spec, variant)
    Q, L, B = x.shape[0], spec.num_levels, spec.blocks_per_level
    g = torch.where(_out_of_range(x), 0.0, g.float())
    grad = torch.zeros((spec.table_rows, ROW_WIDTH), dtype=torch.float32, device=x.device)
    rows = level_rows_padded(x, spec)
    Qp = rows.numel() // L
    for li, level in enumerate(spec.levels):
        rows_idx, terms = _level_terms(x, g, li, level, spec)
        groups = group_of_level(li, level, rows, Qp)
        if groups is None:
            grad.index_add_(0, rows_idx, terms)
            continue
        gid, collapse = groups  # [Qp] int64 group ids, [n_groups] bool
        gid = gid[:Q]
        m = collapse[gid]
        sums = torch.zeros((collapse.numel(), ROW_WIDTH), dtype=torch.float32, device=x.device)
        sums.index_add_(0, gid[m], terms[m])
        group_row = torch.zeros(collapse.numel(), dtype=torch.int64, device=x.device)
        group_row[gid] = rows_idx  # every query of a group holds the group's row
        grad.index_add_(0, group_row[collapse], sums[collapse])
        grad.index_add_(0, rows_idx[~m], terms[~m])
    return grad


def encode_bwd_seg_plain(x, g, spec: BlockHashSpec):
    """Plain table gradient of the seg variant, B3b's plain version: [L*B, 128] float32.

    The rules of block_hash_pallas.py::_bwd_seg_from_prep (:592): levels of
    scale above SEG_SCALE_MAX, and chunks with more than CHUNK // NSEG_DIV
    runs, add per query; every other run of equal consecutive rows sums its
    terms and adds them once. Out-of-range grads are zeroed first.
    """

    def runs(li, level, rows, Qp):
        if level.scale > SEG_SCALE_MAX:
            return None
        r = rows[li * Qp : (li + 1) * Qp]
        _, nseg = seg_next(r, 1, Qp)
        pos = torch.arange(Qp, device=r.device)
        start = (pos % CHUNK == 0) | torch.cat([r.new_ones(1, dtype=torch.bool), r[1:] != r[:-1]])
        gid = torch.cumsum(start.long(), 0) - 1
        walked = nseg <= CHUNK // NSEG_DIV  # [C], per chunk
        return gid, walked[torch.nonzero(start).squeeze(1) // CHUNK]

    return _collapsed_bwd(x, g, spec, "seg", runs)


def encode_bwd_win_plain(x, g, spec: BlockHashSpec):
    """Plain table gradient of the win variant, B4b's plain version: [L*B, 128] float32.

    The rules of block_hash_pallas.py::_bwd_win_from_prep (:958): level l
    cuts its stream into windows of w = win_of_level(scale) queries; a window
    whose flag (pack_win_flags, read at its last index) says its w rows are
    equal sums its terms and adds them once, every other query (and every
    query of a w = 1 level) adds its own. Out-of-range grads are zeroed first.
    """

    def windows(li, level, rows, Qp):
        w = win_of_level(level.scale)
        if w == 1:
            return None
        flags = pack_win_flags(rows[li * Qp : (li + 1) * Qp], 1, Qp)
        gid = torch.arange(Qp, device=rows.device) // w
        return gid, (flags.reshape(-1, w)[:, -1] & WIN_BIT[w]) != 0

    return _collapsed_bwd(x, g, spec, "win", windows)


ENCODE_BWD_PLAIN = {"default": encode_bwd_plain, "seg": encode_bwd_seg_plain,
                    "win": encode_bwd_win_plain}


# ------------------------------------------------------------- public entry


class BlockHashEncode(torch.autograd.Function):
    """Features of [Q, 3] points, differentiable w.r.t. the table only.

    The forward reads `kernel_variant()` and keeps it for the backward, as
    the JAX package keeps it in its residuals. CUDA tensors run the
    variant's kernels: B1/B2 (default), B3a/B3b (seg) or B4a/B4b (win); CPU
    tensors run `encode_plain` and the variant's plain backward. The points
    get no gradient: the JAX package's VJP returns zeros there and nothing
    upstream needs it.
    """

    @staticmethod
    def forward(ctx, x, table, spec):
        variant = kernel_variant()
        check_even_levels(spec, variant)
        ctx.spec, ctx.variant = spec, variant
        ctx.save_for_backward(x)
        if dispatch.uses_kernel(x):
            from lidarnerf_tpu_torch.ops import block_hash_cuda

            return block_hash_cuda.FWD[variant](x, table, spec)
        return encode_plain(x, table, spec)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (x,) = ctx.saved_tensors
        g = g.float().contiguous()
        if dispatch.uses_kernel(x):
            from lidarnerf_tpu_torch.ops import block_hash_cuda

            return None, block_hash_cuda.BWD[ctx.variant](x, g, ctx.spec), None
        return None, ENCODE_BWD_PLAIN[ctx.variant](x, g, ctx.spec), None


def block_hash_encode(x01, table, spec: BlockHashSpec):
    """Encode [..., 3] points in [0, 1] -> [..., num_levels * 2] features.

    CUDA tensors run the kernels; CPU tensors run the plain versions.
    """
    prefix = x01.shape[:-1]
    x = x01.reshape(-1, 3).float().contiguous()
    out = BlockHashEncode.apply(x, table, spec)
    return out.reshape(*prefix, spec.output_dim)


# ------------------------------------------------- boundary-corner sharing
#
# A corner on a block face is stored twice: block b's local corner 3 along
# an axis and block b+1's local corner 0 are one global corner. The three
# functions below are the JAX package's seam options
# (lidarnerf_tpu/ops/block_hash.py:315-475): the tie averages the copies of
# the dense levels inside the forward, the sync assigns both copies of
# sampled hashed-level corners their mean, and the seam loss penalises the
# copies' difference.


def _row_lane(gcorner, block, dense, nb, row_offset, spec: BlockHashSpec):
    """(row, lane0) of global corners stored in given blocks; `dense`, `nb`
    (the dense block-grid extent) and `row_offset` (the level's first row)
    are a level's, or per-corner tensors of a batch of levels."""
    local = gcorner - block * CELLS_PER_BLOCK  # in [0, 3]
    hashed = (
        ((block[:, 0] * _HASH_PRIMES[0]) & _U32)
        ^ ((block[:, 1] * _HASH_PRIMES[1]) & _U32)
        ^ ((block[:, 2] * _HASH_PRIMES[2]) & _U32)
    )
    lexical = (block[:, 0] * nb + block[:, 1]) * nb + block[:, 2]
    idx = torch.where(torch.as_tensor(dense, device=block.device), lexical, hashed)
    row = idx % spec.blocks_per_level + row_offset
    lane0 = ((local[:, 0] * CORNERS_PER_BLOCK + local[:, 1]) * CORNERS_PER_BLOCK
             + local[:, 2]) * LEVEL_DIM
    return row, lane0


def corner_row_lane(gcorner, block, level: _Level, level_idx: int, spec: BlockHashSpec):
    """(row, lane0) of a global corner stored in a given block (`_corner_row_lane` :404).

    gcorner, block: [Q, 3] int64 with 3 * block <= gcorner <= 3 * block + 3.
    lane0 is the channel-0 lane; channel 1 is lane0 + 1. The hash is the
    uint32 prime-XOR, done in int64 and masked as in `level_indices_and_weights`.
    """
    return _row_lane(gcorner, block, level.dense, level.blocks_axis,
                     level_idx * spec.blocks_per_level, spec)


_SEAM_AXES = "xyz"


def _average_dense_seams(t, spec: BlockHashSpec, axes):
    """In place on a table-shaped `t`: along each axis of `axes` in turn, both
    stored copies of every face corner of every dense level (of two blocks or
    more a side) become their mean, 0.5 * (a + b)."""
    for li, level in enumerate(spec.levels):
        nb = level.blocks_axis
        if not level.dense or nb < 2:
            continue
        off = li * spec.blocks_per_level
        v = t[off : off + nb**3].view(nb, nb, nb, 4, 4, 4, 2)
        for axis in axes:
            d = _SEAM_AXES.index(axis)
            hi = (slice(None),) * d + (slice(None, -1),) + (slice(None),) * 2 + (3,)
            lo = (slice(None),) * d + (slice(1, None),) + (slice(None),) * 2 + (0,)
            m = 0.5 * (v[hi] + v[lo])
            v[hi] = m
            v[lo] = m


class TieDenseSeams(torch.autograd.Function):
    """The tie as one differentiable op. Each axis's averaging is a symmetric
    projection, so the tie's adjoint is the same averaging in the reverse
    axis order (z, y, x) on a copy of the incoming gradient: the sums and
    halvings of JAX's VJP, bit for bit, in two table copies."""

    @staticmethod
    def forward(ctx, table, spec):
        ctx.spec = spec
        out = table.detach().clone()
        _average_dense_seams(out, spec, _SEAM_AXES)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _average_dense_seams(g, ctx.spec, _SEAM_AXES[::-1])
        return g, None


def tie_dense_seams(table, spec: BlockHashSpec):
    """The table with both copies of every shared face corner of the dense
    levels replaced by their mean (`tie_dense_seams` :315), differentiable.

    Dense levels index blocks lexicographically, so the copies pair by static
    slices of a [nb, nb, nb, 4, 4, 4, 2] view, averaged along x, then y, then
    z (edge and vertex corners converge to the mean of all their copies).
    The gradient flows through the means (`TieDenseSeams`): no scatter. A
    spec with no dense level of two blocks returns the table itself.
    """
    if not any(lv.dense and lv.blocks_axis >= 2 for lv in spec.levels):
        return table
    return TieDenseSeams.apply(table, spec)


def seam_extent(level: _Level):
    """(n_seams, max_corner) of a level: seams g = 3m, m in [1, n_seams], on
    corner coordinates in [0, max_corner]."""
    max_corner = level.max_cell + 1
    return min(max_corner // CELLS_PER_BLOCK, level.blocks_axis - 1), max_corner


def seam_draws(spec: BlockHashSpec, n_per_axis, generator=None, device=None, hashed_only=False):
    """{(level, axis): (m [n], other [n, 3])} int64 seam samples, drawn from
    `generator` on `device` with no host read: m uniform in [1, n_seams],
    other uniform in [0, max_corner]. Levels without a seam draw nothing;
    `hashed_only` skips the dense levels too (the sync's)."""
    draws = {}
    for li, level in enumerate(spec.levels):
        n_seams, max_corner = seam_extent(level)
        if n_seams < 1 or (hashed_only and level.dense):
            continue
        for axis in range(3):
            m = torch.randint(1, n_seams + 1, (n_per_axis,), generator=generator, device=device)
            other = torch.randint(0, max_corner + 1, (n_per_axis, 3), generator=generator,
                                  device=device)
            draws[(li, axis)] = (m, other)
    return draws


_SLOT_CONSTANTS = {}  # (spec, keys, sizes, device) -> per-sample level constants


def _slot_constants(spec, keys, sizes, device):
    """Per-sample constants of a batch of (level, axis) keys with `sizes`
    samples each: the axis as a one-hot [n, 3], the largest block index, the
    dense flag, the dense extent and the level's first row. Made at the first
    call on a shape (an eager warm-up, before any capture) and kept."""
    key = (spec, keys, sizes, str(device))
    if key not in _SLOT_CONSTANTS:
        levels = [spec.levels[li] for li, _ in keys]

        def per_sample(values, dtype=np.int64):
            return torch.from_numpy(np.repeat(np.asarray(values, dtype), sizes)).to(device)

        onehot = torch.from_numpy(np.eye(3, dtype=bool)[np.repeat([a for _, a in keys], sizes)])
        _SLOT_CONSTANTS[key] = (
            onehot.to(device),
            per_sample([lv.blocks_axis - 1 for lv in levels]),
            per_sample([lv.dense for lv in levels], bool),
            per_sample([lv.blocks_axis for lv in levels]),
            per_sample([li * spec.blocks_per_level for li, _ in keys]),
        )
    return _SLOT_CONSTANTS[key]


def _seam_slots(spec, keys, draws, device):
    """Flat-table slots (ia, ib), each [sum of the samples], of the two stored
    copies (channel 0) of the sampled seam corners of the (level, axis)
    `keys`, in their order: a corner g with g[axis] = 3m lies in block
    g // 3 (clamped; ia) and in the block before it along the axis (ib).
    One batch of tensor ops for all the keys."""
    m = torch.cat([torch.as_tensor(draws[k][0], device=device).long() for k in keys])
    other = torch.cat([torch.as_tensor(draws[k][1], device=device).long() for k in keys])
    sizes = tuple(int(draws[k][0].shape[0]) for k in keys)
    onehot, bmax, dense, nb, first_row = _slot_constants(spec, tuple(keys), sizes, device)
    g = torch.where(onehot, (m * CELLS_PER_BLOCK)[:, None], other)
    blk_hi = torch.minimum(torch.clamp(torch.div(g, CELLS_PER_BLOCK, rounding_mode="floor"),
                                       min=0), bmax[:, None])
    blk_lo = blk_hi - onehot.long()
    slots = []
    for blk in (blk_hi, blk_lo):
        row, lane0 = _row_lane(g, blk, dense, nb, first_row, spec)
        slots.append(row * ROW_WIDTH + lane0)
    return slots


def _last_writes(idx, vals):
    """(slots, values) that write `vals` [n] at `idx` [n] as in-order writes
    would: every write to a slot carries the value of the last write to it,
    so a scatter of them ends the same on any device and in any order. A
    stable sort groups the equal slots; no host read."""
    order = torch.sort(idx, stable=True).indices
    s, v = idx[order], vals[order]
    start = torch.ones_like(s, dtype=torch.bool)
    start[1:] = s[1:] != s[:-1]
    group = torch.cumsum(start, 0) - 1
    pos = torch.arange(s.numel(), device=s.device)
    last = torch.zeros_like(pos).scatter_reduce_(0, group, pos, "amax")
    return s, v[last[group]]


@torch.no_grad()
def sync_hashed_seams(table, spec: BlockHashSpec, generator=None, n_per_axis=4096, draws=None):
    """Assign both stored copies of sampled hashed-level seam corners their
    mean, in place (`sync_hashed_seams` :361). Returns `table`.

    Per (level, axis), in the JAX order (levels are disjoint, so each axis
    takes every level at once): the means come from the current table, then
    the copies in the hi blocks are written and then those in the lo blocks, so where sampled slots collide the last write wins, as
    XLA's in-order scatter has it: every write to a slot carries the last
    one's value (`_last_writes`), so the card, the CPU and the JAX package
    agree bit for bit. `draws` injects the samples of
    `seam_draws(..., hashed_only=True)`; else they are drawn from
    `generator` on the table's device. No host read: a CUDA graph can
    capture it.
    """
    if draws is None:
        draws = seam_draws(spec, n_per_axis, generator, table.device, hashed_only=True)
    flat = table.view(-1)
    # the levels' slots are disjoint, so each axis syncs every level at once;
    # within a level the axes keep the JAX order
    for axis in range(3):
        keys = [(li, axis) for li, lv in enumerate(spec.levels)
                if not lv.dense and (li, axis) in draws]
        if not keys:
            continue
        ia, ib = _seam_slots(spec, keys, draws, table.device)
        idx = torch.cat([ia, ib, ia + 1, ib + 1])
        mean0 = 0.5 * (flat[ia] + flat[ib])
        mean1 = 0.5 * (flat[ia + 1] + flat[ib + 1])
        slots, vals = _last_writes(idx, torch.cat([mean0, mean0, mean1, mean1]))
        flat[slots] = vals
    return table


def block_hash_seam_loss(table, spec: BlockHashSpec, generator=None, n_per_axis=512,
                         draws=None):
    """Mean squared difference of the two stored copies of sampled seam
    corners, a 0-d tensor (`block_hash_seam_loss` :430).

    Per (level, axis) with a seam: the mean over the samples of
    (fa0 - fb0)^2 + (fa1 - fb1)^2; the result is the mean of those terms.
    The copies are gathered, all in one call, as channel pairs of a
    [rows * 64, 2] view whose gradient adds order-free
    (`order_free.gather_rows`), so a step with the loss repeats bit for bit
    on the card. `draws` injects the samples of
    `seam_draws`; else they are drawn from `generator` on the table's device.
    """
    from lidarnerf_tpu_torch.ops.order_free import gather_rows

    if draws is None:
        draws = seam_draws(spec, n_per_axis, generator, table.device)
    keys = [(li, axis) for li in range(spec.num_levels) for axis in range(3)
            if (li, axis) in draws]
    if not keys:
        return table.new_zeros(())
    ia, ib = _seam_slots(spec, keys, draws, table.device)
    sizes = [int(draws[k][0].shape[0]) for k in keys]
    # one gather of every sampled pair: one order-free accumulator in the backward
    f = gather_rows(table.view(-1, LEVEL_DIM), torch.stack([ia, ib]) // LEVEL_DIM)
    d = f[0] - f[1]  # [sum(sizes), 2]
    sq = d[:, 0] ** 2 + d[:, 1] ** 2
    terms = [torch.mean(x) for x in torch.split(sq, sizes)]
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total / len(terms)
