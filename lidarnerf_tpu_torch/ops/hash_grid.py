"""Multiresolution hash-grid encoder (counterpart of lidarnerf_tpu/ops/hash_grid.py).

The reference-exact encoder behind `--encoding hashgrid` and `tiledgrid`,
with the JAX module's semantics:

- per-level scale exp2(level * log2(per_level_scale)) * base - 1 and
  resolution ceil(scale) + 1; per_level_scale from a desired finest
  resolution when one is given;
- per-level table sizes min(2^log2_hashmap_size, corners^D) rounded up to a
  multiple of 8, laid out one after the other;
- corner indexing: a dense strided index while the level fits its table
  (gridtype "tiled": the strided index over the dims that fit), else the
  prime-XOR hash, both in uint32 arithmetic with its wraparound;
- linear (or smoothstep) interpolation over the 2^D corners with
  pos = x * scale + 0.5 (align_corners=False);
- inputs outside [0, 1] give zero features; init uniform(-1e-4, 1e-4).

torch has no usable uint32 arithmetic, so the indices are computed in int64
and masked to 32 bits after each product, sum and stride update (a product
of a 32-bit value and a corner coordinate stays below 2^48).

`hash_grid_encode` is an autograd Function that saves only the points: its
backward recomputes each level's indices and weights, the
counterpart of `hash_grid_encode_chunked`'s rematerialisation (at 3.4M
queries a step would otherwise hold [Q, 2^D] indices and weights per level).
The table gradient adds order-free (`ops/order_free.py`), so it repeats bit
for bit on the card and equals the CPU's. The points get no gradient:
nothing upstream of them is trained. One plain PyTorch path serves both
devices; no TPU kernel stands behind this module (the JAX one is XLA).
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from lidarnerf_tpu_torch.ops.order_free import (
    RowAccumulator,
    fixed_point_scale,
    gather_rows,
    max_abs_finite,
)

# the fast_hash primes of the reference's grid encoder
_HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class _Level:
    scale: float  # continuous grid scale (cells along one axis)
    resolution: int  # integer corner resolution = ceil(scale) + 1
    size: int  # rows allocated for this level (a multiple of 8)
    offset: int  # the level's first row in the flat table
    n_dense_dims: int  # dims indexed densely before the stride exceeds size; -1: hashed


@dataclass(frozen=True)
class HashGridSpec:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    gridtype: str = "hash"  # "hash" | "tiled"
    align_corners: bool = False
    interpolation: str = "linear"  # "linear" | "smoothstep"
    levels: tuple = field(default=())

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def table_rows(self) -> int:
        return self.levels[-1].offset + self.levels[-1].size


def make_hash_grid_spec(
    input_dim: int = 3,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int | None = None,
    per_level_scale: float = 2.0,
    gridtype: str = "hash",
    align_corners: bool = False,
    interpolation: str = "linear",
) -> HashGridSpec:
    """The JAX package's spec (hash_grid.py:77-143): levels follow the
    reference kernel's scale, tables are allocated with its grid.py size law."""
    if desired_resolution is not None:
        per_level_scale = float(
            np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1))
        )
    max_params = 2**log2_hashmap_size
    S = np.log2(per_level_scale)
    levels = []
    offset = 0
    for lvl in range(num_levels):
        scale = float(np.exp2(lvl * S) * base_resolution - 1.0)
        resolution = int(np.ceil(scale)) + 1
        alloc_res = int(np.ceil(base_resolution * per_level_scale**lvl))
        corners = alloc_res if align_corners else alloc_res + 1
        params_in_level = min(max_params, corners**input_dim)
        params_in_level = int(np.ceil(params_in_level / 8) * 8)
        stride = 1
        n_dense = 0
        kernel_corners = resolution if align_corners else resolution + 1
        for _ in range(input_dim):
            if stride > params_in_level:
                break
            n_dense += 1
            stride *= kernel_corners
        if gridtype == "hash" and stride > params_in_level:
            n_dense = -1  # hashed
        levels.append(_Level(scale, resolution, params_in_level, offset, n_dense))
        offset += params_in_level
    return HashGridSpec(
        input_dim=input_dim,
        num_levels=num_levels,
        level_dim=level_dim,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        per_level_scale=per_level_scale,
        gridtype=gridtype,
        align_corners=align_corners,
        interpolation=interpolation,
        levels=tuple(levels),
    )


def hash_grid_init(spec: HashGridSpec, generator=None, device=None):
    """Uniform(-1e-4, 1e-4) table [table_rows, level_dim] float32, drawn from `generator`."""
    t = torch.rand((spec.table_rows, spec.level_dim), generator=generator, device=device,
                   dtype=torch.float32)
    return t * 2e-4 - 1e-4


def _axis_terms(base_d, d, level: _Level, stride):
    """[Q, 2] uint32 contributions of axis d at corner bits 0 and 1."""
    c = base_d[:, None] + torch.arange(2, device=base_d.device)
    if level.n_dense_dims >= 0:
        return (c * stride) & _U32
    return (c * _HASH_PRIMES[d]) & _U32


def level_index(base, level: _Level, spec: HashGridSpec):
    """[Q, 2^D] int64 table rows of the corners of integer cells `base` [Q, D] int64.

    Corner c takes bit d of c along axis d. The reference's get_grid_index
    (the JAX `_level_index`, hash_grid.py:161-180), uint32 wraparound included:
    the dense index sums corner * stride over the first n_dense_dims axes
    (the stride wraps like a uint32), the hash XORs corner * prime.
    """
    D = spec.input_dim
    Q = base.shape[0]
    kernel_corners = level.resolution if spec.align_corners else level.resolution + 1
    hashed = level.n_dense_dims < 0
    dims = range(D) if hashed else range(level.n_dense_dims)
    index = torch.zeros((Q,) + (1,) * D, dtype=torch.int64, device=base.device)
    stride = 1
    for d in dims:
        shape = [Q] + [1] * D
        shape[D - d] = 2  # axis d is bit d of the flattened corner index
        term = _axis_terms(base[:, d], d, level, stride).reshape(shape)
        if hashed:
            index = index ^ term
        else:
            index = (index + term) & _U32
            stride = (stride * kernel_corners) & _U32
    index = index.expand((Q,) + (2,) * D).reshape(Q, 2**D)
    return index % level.size + level.offset


def _cells_and_fracs(x, level: _Level, spec: HashGridSpec):
    # x * scale + 0.5 rounded once, as the JAX package's fused multiply-add
    # computes it: the float32 product is exact in float64
    scale = float(np.float32(level.scale))
    pos = (x.double() * scale + (0.0 if spec.align_corners else 0.5)).float()
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    # a cell below 0 (an input out of range, zeroed later) wraps like a uint32
    return pos_grid.long() & _U32, frac


def corner_weights(frac):
    """[Q, 2^D] products over the axes of (frac if bit d else 1 - frac), axis 0 first."""
    Q, D = frac.shape
    w = None
    for d in range(D):
        shape = [Q] + [1] * D
        shape[D - d] = 2
        wd = torch.stack([1.0 - frac[:, d], frac[:, d]], dim=-1).reshape(shape)
        w = wd if w is None else w * wd
    return w.reshape(Q, 2**D)


def level_rows_and_weights(x, level: _Level, spec: HashGridSpec):
    """[Q, 2^D] table rows and interpolation weights of one level."""
    base, frac = _cells_and_fracs(x, level, spec)
    return level_index(base, level, spec), corner_weights(frac)


def _out_of_range(x):
    return ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)


def encode_plain(x, table, spec: HashGridSpec):
    """[Q, D] points in [0, 1] -> [Q, L * C] features (no autograd: see `HashGridEncode`)."""
    feats = []
    for level in spec.levels:
        rows, w = level_rows_and_weights(x, level, spec)
        feats.append((w[..., None] * table[rows].float()).sum(dim=1))
    return torch.where(_out_of_range(x), 0.0, torch.cat(feats, dim=-1))


def encode_bwd(x, g, spec: HashGridSpec):
    """Table gradient: [Q, D] points, [Q, L * C] feature grads -> [table_rows, C] float32.

    Each level's terms w * g are added order-free; an entry sums at most
    2^D x Q terms (a hashed level can send all corners of a query to one row).
    """
    Q, C = x.shape[0], spec.level_dim
    g = torch.where(_out_of_range(x), 0.0, g.float())
    scale = fixed_point_scale(max_abs_finite(g) if g.numel() else g.new_zeros(()),
                              max(Q * 2**spec.input_dim, 1))
    acc = RowAccumulator(spec.table_rows, C, scale)
    for li, level in enumerate(spec.levels):
        rows, w = level_rows_and_weights(x, level, spec)
        terms = w[..., None] * g[:, None, li * C:(li + 1) * C]  # [Q, 2^D, C]
        acc.add(rows.reshape(-1), terms.reshape(-1, C))
    return acc.result()


class HashGridEncode(torch.autograd.Function):
    """Features of [Q, D] points, differentiable w.r.t. the table; saves only the points."""

    @staticmethod
    def forward(ctx, x, table, spec):
        ctx.spec = spec
        ctx.save_for_backward(x)
        return encode_plain(x, table, spec)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (x,) = ctx.saved_tensors
        return None, encode_bwd(x, g, ctx.spec), None


def hash_grid_encode(x01, table, spec: HashGridSpec):
    """Encode [..., D] points in [0, 1] -> [..., num_levels * level_dim] float32
    features (level-major in the last axis)."""
    prefix = x01.shape[:-1]
    x = x01.reshape(-1, spec.input_dim).float().contiguous()
    out = HashGridEncode.apply(x, table, spec)
    return out.reshape(*prefix, spec.output_dim)


def hash_grid_encode_chunked(x01, table, spec: HashGridSpec, chunk: int = 131072):
    """The counterpart of the JAX `hash_grid_encode_chunked` (hash_grid.py:252-284),
    which rematerialises chunk by chunk to bound a step's memory:
    `hash_grid_encode` already recomputes its indices and weights in the
    backward, so this is the same function (`chunk` is not read)."""
    return hash_grid_encode(x01, table, spec)


def hash_grid_total_variation(table, spec: HashGridSpec, generator=None, n_samples=100000,
                              x=None):
    """Stochastic total-variation loss over the grid (hash_grid.py:183-206):
    at `n_samples` uniform points (drawn from `generator`, or injected as
    `x` [n, D]), per level the mean squared difference between the base
    corner's entry and its +1 neighbour along each axis. Its table gradient
    adds order-free."""
    if x is None:
        x = torch.rand((n_samples, spec.input_dim), generator=generator, device=table.device)
    loss = 0.0
    for level in spec.levels:
        base, _ = _cells_and_fracs(x, level, spec)
        f0 = gather_rows(table, level_index(base, level, spec)[:, 0])
        for d in range(spec.input_dim):
            nb = base.clone()
            nb[:, d] += 1
            f1 = gather_rows(table, level_index(nb, level, spec)[:, 0])
            loss = loss + torch.mean((f1 - f0) ** 2)
    return loss
