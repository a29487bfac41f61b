"""Morton (Z-order) codes and occupancy bit packing (counterpart of lidarnerf_tpu/ops/morton.py).

The reference's raymarching utilities morton3D, morton3D_invert and
packbits, vectorised. The uint32 bit arithmetic runs in int64 masked to 32
bits (torch has no usable uint32 arithmetic). Nothing in the port calls them
yet; they stay available for occupancy-grid work.
"""

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of each value so they occupy every 3rd bit."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3D(coords):
    """[N, 3] int coords (< 1024) -> [N] int32 Morton codes."""
    c = coords.long() & _U32
    code = (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2)) & _U32
    return _as_int32(code)


def _compact_bits(v):
    v = v & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def morton3D_invert(codes):
    """[N] Morton codes -> [N, 3] int32 coords."""
    c = codes.long() & _U32
    return torch.stack([_compact_bits(c), _compact_bits(c >> 1), _compact_bits(c >> 2)],
                       dim=-1).int()


def _as_int32(v):
    """uint32 values in int64 -> the int32 with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).int()


def packbits(density_grid, density_thresh):
    """Pack density > thresh into a uint8 bitfield (8 cells per byte, low bit first).

    density_grid: [..., N] with N % 8 == 0.
    """
    occ = (density_grid > density_thresh).to(torch.int64)
    occ = occ.reshape(*occ.shape[:-1], -1, 8)
    weights = 2 ** torch.arange(8, device=occ.device)
    return (occ * weights).sum(dim=-1).to(torch.uint8)
