"""Block-hash multiresolution grid encoder (counterpart of lidarnerf_tpu/ops/block_hash.py).

Each level's corner grid is tiled into blocks of 3x3x3 cells = 4x4x4 corners;
a block row of the table stores its 64 corners x 2 channels = 128 float32, so
a query's 8 trilinear corners always lie in one row. Coarse levels index
blocks densely, fine levels hash the block coordinate with the prime-XOR of
instant-ngp into 2^log2_hashmap_size / 64 blocks per level.

`block_hash_encode` is the entry point, an autograd Function on both
devices. A CUDA tensor goes through the hand-written kernels
(`block_hash_cuda.py`): the forward `csrc/block_hash_fwd.cu` and, for the
table gradient, the backward `csrc/block_hash_bwd.cu`. A CPU tensor goes
through their plain versions below: `encode_plain`, the counterpart of
`_encode_xla`, and `encode_bwd_plain`, the counterpart of the XLA branch of
`_encode_bwd`. The plain versions are also the kernels' oracles on the card.
"""

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
        rows_idx, w12 = level_indices_and_weights(x, level, li, spec)
        # lane j holds channel j & 1 -> [g0, g1, g0, g1, ...]
        g_lane = g[:, 2 * li : 2 * li + 2].repeat(1, ROW_WIDTH // LEVEL_DIM)
        grad.index_add_(0, rows_idx, lane_weight_row(w12) * g_lane)
    return grad


# ------------------------------------------------------------- public entry


class BlockHashEncode(torch.autograd.Function):
    """Features of [Q, 3] points, differentiable w.r.t. the table only.

    CUDA tensors run kernels B1 (forward) and B2 (backward); CPU tensors run
    `encode_plain` and `encode_bwd_plain`. The points get no gradient: the
    JAX package's VJP returns zeros there and nothing upstream needs it.
    """

    @staticmethod
    def forward(ctx, x, table, spec):
        ctx.spec = spec
        ctx.save_for_backward(x)
        if dispatch.uses_kernel(x):
            from lidarnerf_tpu_torch.ops.block_hash_cuda import block_hash_fwd

            return block_hash_fwd(x, table, spec)
        return encode_plain(x, table, spec)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (x,) = ctx.saved_tensors
        g = g.float().contiguous()
        if dispatch.uses_kernel(x):
            from lidarnerf_tpu_torch.ops.block_hash_cuda import block_hash_bwd

            return None, block_hash_bwd(x, g, ctx.spec), None
        return None, encode_bwd_plain(x, g, ctx.spec), None


def block_hash_encode(x01, table, spec: BlockHashSpec):
    """Encode [..., 3] points in [0, 1] -> [..., num_levels * 2] features.

    CUDA tensors run the kernels; CPU tensors run the plain versions.
    """
    prefix = x01.shape[:-1]
    x = x01.reshape(-1, 3).float().contiguous()
    out = BlockHashEncode.apply(x, table, spec)
    return out.reshape(*prefix, spec.output_dim)
