"""The yardstick's arithmetic: the H100's published peaks, the least time of
each kernel's work (frozen from `chip_smoke.py`'s `bound_of`, `fwd_bound`,
`bwd_bound`, `touched_rows` and its count of the fused sampler's bytes) and
the model's matmul operations.

A bound is the larger of bytes over the memory rate and operations over
the compute rate: each input byte read once, each output byte written once.
"""

import torch

from benchmark import reference as ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense


def bound_ms(bytes_moved, flops, peak=FP32_FLOPS):
    return max(bytes_moved / HBM_BYTES_PER_S, flops / peak) * 1e3


def touched_rows(x01, levels, blocks):
    """Distinct table rows that the in-range queries x01 [Q, 3] touch."""
    x = x01[~ref.outside(x01)]
    rows = [ref.level_rows(x, lv, li, blocks)[0] for li, lv in enumerate(levels)]
    return torch.unique(torch.cat(rows)).numel()


def fwd_ms(x01, levels, blocks):
    """B1's bound on queries x01: x read once, the [Q, 2L] features written
    once, each touched 512-byte row read once; ~60 operations a query-level."""
    Q, L = x01.shape[0], len(levels)
    n_bytes = Q * 12 + Q * 2 * L * 4 + touched_rows(x01, levels, blocks) * 512
    return bound_ms(n_bytes, Q * L * 60)


def bwd_ms(Q, L, table_rows):
    """B2's bound: x and the feature gradient read once, the whole table
    gradient [rows, 128] written once; ~80 operations a query-level."""
    return bound_ms(Q * 12 + Q * 2 * L * 4 + table_rows * 128 * 4, Q * L * 80)


def occ_sample_ms(rays_o, rays_d, near, far, occ, bound, T, draws=True):
    """The fused `--fast` sampler's bound: a ray batch's origin (12 B when the
    rays share it), 20 B of direction, near and far a ray, T draws read and T
    depths written (4 B each), and each distinct 32-byte sector of the
    occupied volume its bins look up."""
    K, G = occ["bins"], occ["grid_size"]
    t = (torch.arange(K, dtype=torch.float32, device=rays_o.device) + 0.5) / K
    z = near + (far - near) * t
    x = rays_o[:, None, :] + rays_d[:, None, :] * z[None, :, None]
    gi = torch.clamp(torch.floor((x + bound) * (G / (2.0 * bound))).long(), 0, G - 1)
    sectors = torch.unique(((gi[..., 0] * G + gi[..., 1]) * G + gi[..., 2]) >> 3).numel()
    n = rays_o.shape[0]
    origin = 12 if bool((rays_o == rays_o[:1]).all()) else 12 * n
    return (origin + n * 20 + n * T * 4 * (2 if draws else 1) + sectors * 32) / HBM_BYTES_PER_S * 1e3


def sample_flops(cfg):
    """Matmul operations of one sample's forward: the sigma net and the LiDAR head."""
    def chain(d_in, layers, hidden, d_out):
        dims = [d_in] + [hidden] * (layers - 1) + [d_out]
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))

    geo = cfg["geo_feat_dim"]
    return (chain(2 * cfg["num_levels"], cfg["num_layers"], cfg["hidden_dim"], 1 + geo)
            + chain(3 + 2 * 3 * ref.LIDAR_DIR_DEGREE + geo, cfg["num_layers_color"],
                    cfg["hidden_dim_color"], 2))
