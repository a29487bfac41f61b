"""Periodic-volume encoding (counterpart of lidarnerf_tpu/ops/periodic_volume.py).

L levels with scalings floor(min_res * growth**level), growth =
exp((ln max_res - ln min_res) / (L - 1)); each level owns a dense periodic
volume of resolution R = 2**(log2_hashmap_size // 3) (log2_hashmap_size
must be a multiple of 3): integer corner coordinates are taken mod R before
the strided index. Trilinear interpolation over the 8 corners, optional
smoothstep of the offset; init uniform(-1, 1) * hash_init_scale; an exact
total-variation loss over the [L, R, R, R, C] volume.

`periodic_volume_encode` is an autograd Function like the hash grid's: it
saves only the points, recomputes the indices in the backward and
adds the table gradient order-free (`ops/order_free.py`), so it repeats bit
for bit. One plain PyTorch path serves both devices; no TPU kernel stands
behind this module (the JAX one is XLA).
"""

from dataclasses import dataclass

import numpy as np
import torch

from lidarnerf_tpu_torch.ops.order_free import RowAccumulator, fixed_point_scale, max_abs_finite


@dataclass(frozen=True)
class PeriodicVolumeSpec:
    num_levels: int = 16
    min_res: int = 16
    max_res: int = 1024
    log2_hashmap_size: int = 18  # a multiple of 3
    features_per_level: int = 2
    hash_init_scale: float = 0.001
    smoothstep: bool = False
    scalings: tuple = ()

    @property
    def resolution(self) -> int:
        return 2 ** (self.log2_hashmap_size // 3)

    @property
    def level_size(self) -> int:
        return 2**self.log2_hashmap_size

    @property
    def table_rows(self) -> int:
        return self.num_levels * self.level_size

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level


def make_periodic_volume_spec(
    num_levels=16,
    min_res=16,
    max_res=1024,
    log2_hashmap_size=18,
    features_per_level=2,
    hash_init_scale=0.001,
    smoothstep=False,
) -> PeriodicVolumeSpec:
    if log2_hashmap_size % 3 != 0:
        raise ValueError(
            "periodic_volume requires log2_hashmap_size % 3 == 0 "
            "(encoding.py:151 asserts the same)"
        )
    if num_levels > 1:
        growth = np.exp((np.log(max_res) - np.log(min_res)) / (num_levels - 1))
    else:
        growth = 1.0
    scalings = tuple(float(np.floor(min_res * growth**lvl)) for lvl in range(num_levels))
    return PeriodicVolumeSpec(
        num_levels=num_levels,
        min_res=min_res,
        max_res=max_res,
        log2_hashmap_size=log2_hashmap_size,
        features_per_level=features_per_level,
        hash_init_scale=hash_init_scale,
        smoothstep=smoothstep,
        scalings=scalings,
    )


def periodic_volume_init(spec: PeriodicVolumeSpec, generator=None, device=None):
    """uniform(-1, 1) * hash_init_scale, [table_rows, features_per_level] float32."""
    t = torch.rand((spec.table_rows, spec.features_per_level), generator=generator,
                   device=device, dtype=torch.float32)
    return (t * 2.0 - 1.0) * spec.hash_init_scale


def _bits(c):
    return (c >> 2) & 1, (c >> 1) & 1, c & 1  # axes 0, 1, 2


def level_rows_and_weights(x, lvl, spec: PeriodicVolumeSpec):
    """[Q, 8] table rows and trilinear weights of level `lvl`, corner c taking
    bit 2 - a of c along axis a, as the JAX module orders them."""
    R = spec.resolution
    pos = x * spec.scalings[lvl]
    floor = torch.floor(pos)
    offset = pos - floor
    if spec.smoothstep:
        offset = offset * offset * (3.0 - 2.0 * offset)
    base = floor.long()
    # each axis's coordinate mod R at bit 0 and 1
    coord = [[torch.remainder(base[:, a] + bit, R) for bit in (0, 1)] for a in range(3)]
    rows, weights = [], []
    for c in range(8):
        b = _bits(c)
        rows.append((coord[0][b[0]] * R + coord[1][b[1]]) * R + coord[2][b[2]]
                    + lvl * spec.level_size)
        wc = torch.ones_like(offset[:, 0])
        for a, bit in enumerate(b):
            wc = wc * (offset[:, a] if bit else 1.0 - offset[:, a])
        weights.append(wc)
    return torch.stack(rows, dim=1), torch.stack(weights, dim=1)


def encode_plain(x, table, spec: PeriodicVolumeSpec):
    """[Q, 3] -> [Q, L * C] features (no autograd: see `PeriodicVolumeEncode`)."""
    feats = []
    for lvl in range(spec.num_levels):
        rows, w = level_rows_and_weights(x, lvl, spec)
        f = table[rows].float()  # [Q, 8, C]
        acc = 0.0
        for c in range(8):  # corner by corner, as the JAX module sums them
            acc = acc + w[:, c:c + 1] * f[:, c]
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def encode_bwd(x, g, spec: PeriodicVolumeSpec):
    """Table gradient [table_rows, C] float32, added order-free; an entry sums
    at most 8 x Q terms."""
    C = spec.features_per_level
    g = g.float()
    scale = fixed_point_scale(max_abs_finite(g) if g.numel() else g.new_zeros(()),
                              max(8 * x.shape[0], 1))
    acc = RowAccumulator(spec.table_rows, C, scale)
    for lvl in range(spec.num_levels):
        rows, w = level_rows_and_weights(x, lvl, spec)
        terms = w[..., None] * g[:, None, lvl * C:(lvl + 1) * C]
        acc.add(rows.reshape(-1), terms.reshape(-1, C))
    return acc.result()


class PeriodicVolumeEncode(torch.autograd.Function):
    """Features of [Q, 3] points, differentiable w.r.t. the table; saves only the points."""

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


def periodic_volume_encode(x, table, spec: PeriodicVolumeSpec):
    """[..., 3] coordinates (any real: the volume is periodic) -> [..., L * C] float32."""
    prefix = x.shape[:-1]
    xf = x.reshape(-1, 3).float().contiguous()
    return PeriodicVolumeEncode.apply(xf, table, spec).reshape(*prefix, spec.output_dim)


def periodic_volume_total_variation(table, spec: PeriodicVolumeSpec):
    """Exact TV loss over the dense volumes (periodic_volume.py:152-163): per
    level the mean |adjacent difference| along each axis, summed over the
    axes, averaged over the levels."""
    R = spec.resolution
    vol = table.reshape(spec.num_levels, R, R, R, spec.features_per_level)
    resx = (vol[:, 1:] - vol[:, :-1]).abs().mean(dim=(1, 2, 3, 4))
    resy = (vol[:, :, 1:] - vol[:, :, :-1]).abs().mean(dim=(1, 2, 3, 4))
    resz = (vol[:, :, :, 1:] - vol[:, :, :, :-1]).abs().mean(dim=(1, 2, 3, 4))
    return (resx + resy + resz).mean()
