"""Closed-form encoders (counterpart of lidarnerf_tpu/ops/encoders.py): frequency and
real spherical harmonics.

- Frequency (NeRF positional) encoding: output layout [x, sin(2^0 x),
  cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], the D input dims kept together
  in each block, C = D + 2*D*degree.
- Real spherical harmonics of a direction, degrees 1-8, degree**2 outputs:
  degrees 1-4 the reference shencoder's hard-coded polynomials, 5-8 the
  Cartesian monomial tables of `_sh_coeffs.py`.
"""

import torch

from lidarnerf_tpu_torch.ops._sh_coeffs import SH_MONOMIALS


def frequency_encoding_dim(input_dim: int, degree: int) -> int:
    return input_dim + 2 * input_dim * degree


def frequency_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """[..., D] -> [..., D + 2*D*degree]."""
    outs = [x]
    for f in range(degree):
        scaled = x * (2.0**f)
        outs.append(torch.sin(scaled))
        outs.append(torch.cos(scaled))
    return torch.cat(outs, dim=-1)


def sh_encoding_dim(degree: int) -> int:
    return degree * degree


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[..., 3] directions (roughly unit-norm) -> [..., degree**2], degree in [1, 8]."""
    if not 1 <= degree <= 8:
        raise NotImplementedError(f"sh_encode supports degree 1..8 (got {degree})")
    if degree > 4:
        return _sh_encode_table(d, degree)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        comps += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        comps += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(comps, dim=-1)


def _sh_encode_table(d, degree: int):
    """Degrees 5-8 through the monomial tables: sum of c * x^px * y^py * z^pz."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xp, yp, zp = [torch.ones_like(x)], [torch.ones_like(y)], [torch.ones_like(z)]
    for _ in range(degree):  # monomial powers never exceed l
        xp.append(xp[-1] * x)
        yp.append(yp[-1] * y)
        zp.append(zp[-1] * z)
    comps = []
    for l in range(degree):
        for m in range(2 * l + 1):
            acc = None
            for c, px, py, pz in SH_MONOMIALS[l][m]:
                term = c * xp[px] * yp[py] * zp[pz]
                acc = term if acc is None else acc + term
            comps.append(acc)
    return torch.stack(comps, dim=-1)
