"""The plain reference: LiDAR-NeRF's field, render, losses and Adam in float32 PyTorch.

Written from the semantics of the configuration (the LiDAR-NeRF model under
`configs/*.txt -L` with the block-hash encoder), with no kernel, no graph
and nothing of the program under test: it imports neither `jax` nor
`lidarnerf_tpu_torch`. The benchmark hands it the same inputs it hands the
program (weights and data drawn from the seed, and the training draws,
which it draws again from a generator of the same seed in the program's
order), and it works out everything else itself.

Every product runs in float32 with TF32 off (`float32_matmuls`). The
control (`Precision`) lowers each stated precision one step: the MLPs'
bfloat16 to float8 e4m3 with a per-tensor scale, and the float32 table to
bfloat16.
"""

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

HASH_PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
LOG_EPS = math.log(1e-15)  # the transmittance floor of cumprod(1 - alpha + 1e-15)
LIDAR_DIR_DEGREE = 12
WEIGHT_MASK = 1e-4  # colours of samples whose weight is at most this count as 0
FAR_MULT = 81.0  # the LiDAR far plane, 81 x the near one


@dataclass(frozen=True)
class Precision:
    """What the reference computes in: `mlp` "fp32" or "fp8" (e4m3, scaled
    per tensor), `table` "fp32" or "bf16"."""
    mlp: str = "fp32"
    table: str = "fp32"


FP32 = Precision()
CONTROL = Precision(mlp="fp8", table="bf16")


@contextlib.contextmanager
def float32_matmuls():
    """Full float32 products (no TF32) inside; the previous flags after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ------------------------------------------------------------------ encoder


@dataclass(frozen=True)
class Level:
    scale: float
    max_cell: int
    blocks_axis: int
    dense: bool


def block_levels(num_levels, base_resolution, log2_hashmap_size, desired_resolution):
    """(levels, blocks per level) of the block-hash grid: level l has scale
    base * b^l - 1 with b = (desired / base)^(1 / (L - 1)); its corner grid
    is tiled into blocks of 3^3 cells (4^3 corners x 2 features = one
    128-float table row); a level whose block grid fits the level's
    2^log2 / 64 rows is indexed densely, the others by the prime-XOR hash."""
    per_level = 2.0 ** (np.log2(desired_resolution / base_resolution) / (num_levels - 1))
    blocks = max(8, 2 ** log2_hashmap_size // 64)
    s = np.log2(per_level)
    levels = []
    for lvl in range(num_levels):
        scale = float(np.exp2(lvl * s) * base_resolution - 1.0)
        max_cell = int(np.floor(scale + 0.5))
        axis = max_cell // 3 + 1
        levels.append(Level(scale, max_cell, axis, axis ** 3 <= blocks))
    return levels, blocks


def level_rows(x01, level, li, blocks):
    """(row [Q] int64 into the flat table, local cell [Q, 3] in 0..2, frac [Q, 3])."""
    pos = x01 * level.scale + 0.5
    cell = torch.floor(pos)
    frac = pos - cell
    cell = torch.clamp(cell.long(), 0, level.max_cell)
    block = cell // 3
    local = cell - 3 * block
    if level.dense:
        nb = level.blocks_axis
        idx = (block[:, 0] * nb + block[:, 1]) * nb + block[:, 2]
    else:
        idx = (((block[:, 0] * HASH_PRIMES[0]) & U32) ^ ((block[:, 1] * HASH_PRIMES[1]) & U32)
               ^ ((block[:, 2] * HASH_PRIMES[2]) & U32))
    return idx % blocks + li * blocks, local, frac


_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def corner_terms(x01, level, li, blocks):
    """The 8 trilinear corners of each query at one level: flat table
    indices [Q, 8, 2] (both features) and weights [Q, 8]."""
    row, local, frac = level_rows(x01, level, li, blocks)
    idx, w = [], []
    for dx, dy, dz in _CORNERS:
        corner = ((local[:, 0] + dx) * 4 + local[:, 1] + dy) * 4 + local[:, 2] + dz
        lane = row * 128 + 2 * corner
        idx.append(torch.stack([lane, lane + 1], -1))
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
        wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
        w.append(wx * wy * wz)
    return torch.stack(idx, 1), torch.stack(w, 1)


def outside(x01):
    return ((x01 < 0.0) | (x01 > 1.0)).any(-1)


class BlockHashRef(torch.autograd.Function):
    """Trilinear interpolation of the 8 corners at every level, [Q, 3] ->
    [Q, 2L]; a query outside [0, 1]^3 gives 0 and takes no gradient. The
    table's gradient adds each corner's weight x feature gradient at its
    entry. Nothing of size [Q, 128] is kept: the backward recomputes the
    corners level by level."""

    @staticmethod
    def forward(ctx, x01, table, levels, blocks):
        ctx.save_for_backward(x01)
        ctx.levels, ctx.blocks, ctx.table_shape = levels, blocks, table.shape
        flat = table.reshape(-1)
        feats = []
        for li, level in enumerate(levels):
            idx, w = corner_terms(x01, level, li, blocks)
            feats.append((flat[idx] * w[..., None]).sum(1))
        out = torch.cat(feats, -1)
        return torch.where(outside(x01)[:, None], 0.0, out)

    @staticmethod
    def backward(ctx, g):
        (x01,) = ctx.saved_tensors
        g = torch.where(outside(x01)[:, None], 0.0, g.float())
        grad = torch.zeros(ctx.table_shape, dtype=torch.float32, device=g.device).reshape(-1)
        for li, level in enumerate(ctx.levels):
            idx, w = corner_terms(x01, level, li, ctx.blocks)
            grad.index_add_(0, idx.reshape(-1), (w[..., None] * g[:, None, 2 * li:2 * li + 2]).reshape(-1))
        return None, grad.reshape(ctx.table_shape), None, None


def quantize(t, kind):
    """t rounded to `kind` ("fp32" keeps it; "bf16"; "fp8": e4m3 at a per-tensor scale)."""
    if kind == "fp32":
        return t
    if kind == "bf16":
        return t.to(torch.bfloat16).float()
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Round(torch.autograd.Function):
    """Rounds in the forward; the gradient passes through (straight-through)."""

    @staticmethod
    def forward(ctx, t, kind):
        return quantize(t, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TruncExp(torch.autograd.Function):
    """exp(min(x, 80)); its gradient g * exp(clamp(x, -15, 15))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=80.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def frequency(x, degree):
    out = [x]
    for f in range(degree):
        out += [torch.sin(x * 2.0 ** f), torch.cos(x * 2.0 ** f)]
    return torch.cat(out, -1)


class Field:
    """The LiDAR field: block-hash features -> sigma net (2 bias-free ReLU
    layers, 1 + geo_feat outputs, sigma = trunc_exp) and the LiDAR head
    (frequency(12) direction ++ geo_feat -> 3 layers -> sigmoid: ray-drop,
    intensity). `weights` holds float32 tensors under the names
    `hash_table`, `sigma_net.layers.i.weight`, `lidar_color_net.layers.i.weight`."""

    def __init__(self, weights, cfg, precision=FP32):
        self.w = weights
        self.levels, self.blocks = block_levels(cfg["num_levels"], cfg["base_resolution"],
                                                cfg["log2_hashmap_size"], cfg["desired_resolution"])
        self.bound = cfg["bound"]
        self.p = precision
        self.sigma_layers = [k for k in sorted(weights) if k.startswith("sigma_net.")]
        self.head_layers = [k for k in sorted(weights) if k.startswith("lidar_color_net.")]

    def mlp(self, h, names):
        for i, n in enumerate(names):
            W = self.w[n]
            if self.p.mlp != "fp32":
                h, W = _Round.apply(h, self.p.mlp), _Round.apply(W, self.p.mlp)
            h = h @ W.T
            if i != len(names) - 1:
                h = torch.relu(h)
        return h

    def encode(self, xyz):
        x01 = ((xyz + self.bound) / (2.0 * self.bound)).reshape(-1, 3)
        table = self.w["hash_table"]
        if self.p.table != "fp32":
            table = _Round.apply(table, self.p.table)
        return BlockHashRef.apply(x01, table, self.levels, self.blocks).reshape(*xyz.shape[:-1], -1)

    def density(self, xyz):
        h = self.mlp(self.encode(xyz), self.sigma_layers)
        return _TruncExp.apply(h[..., 0]), h[..., 1:]

    def lidar_color(self, d_enc, geo):
        d = d_enc[:, None, :].expand(*geo.shape[:-1], d_enc.shape[-1])
        return torch.sigmoid(self.mlp(torch.cat([d, geo], -1), self.head_layers))


# ------------------------------------------------------------------- render


def pixel_dirs(inds, H, W, intrinsics):
    """Sensor-frame directions of flat pixel indices of the (fov_up, fov) pano."""
    fov_up, fov = intrinsics
    i = (inds % W).float()
    j = torch.div(inds, W, rounding_mode="floor").float()
    beta = -(i - W / 2) / W * 2 * math.pi
    alpha = (fov_up - j / H * fov) / 180 * math.pi
    return torch.stack([torch.cos(alpha) * torch.cos(beta), torch.cos(alpha) * torch.sin(beta),
                        torch.sin(alpha)], -1)


def pixel_rays(pose, inds, H, W, intrinsics):
    d = pixel_dirs(inds, H, W, intrinsics) @ pose[:3, :3].T
    return pose[:3, 3].expand_as(d), d


def composite(z, sigma, last_dist):
    """Weights of depth-sorted samples: alpha = 1 - exp(-delta sigma), the
    transmittance the product of (1 - alpha + 1e-15) over earlier samples
    (in log space); the last sample's delta is the ray's bin width."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], last_dist.expand(-1, 1)], -1)
    x = delta * sigma
    log_t = torch.logaddexp(-x, torch.full_like(x, LOG_EPS))
    excl = torch.cumsum(log_t, -1) - log_t
    return (1.0 - torch.exp(-x)) * torch.exp(excl)


def sample_pdf(bins, weights, n, u):
    """Inverse-CDF samples [B, n] of the piecewise-linear cdf of weights + 1e-5
    over `bins`, at the uniform numbers u [B, n]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    T = cdf.shape[-1]
    inds = torch.searchsorted(cdf, u, right=True)
    lo = torch.clamp(inds - 1, min=0)
    hi = torch.clamp(inds, max=T - 1)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    b0, b1 = bins.gather(1, lo), bins.gather(1, hi)
    den = torch.where(c1 - c0 < 1e-5, 1.0, c1 - c0)
    return b0 + (u - c0) / den * (b1 - b0)


def render(field, rays_o, rays_d, cfg, noise=None, u=None, z_coarse=None, keep=None):
    """LiDAR rays -> (depth [N], image [N, 2]). Without `noise` the coarse
    depths are the stratified grid and the fine ones the midpoint inverse
    CDF (serving); with it they are jittered and `u` draws the fine ones
    (training). `z_coarse` replaces the coarse depths (the `--fast`
    sampler's). `keep`, a dict, receives the sample positions."""
    N, dev = rays_o.shape[0], rays_o.device
    near = cfg["scale"]
    far = near * FAR_MULT
    T, S = cfg["num_steps"], cfg["upsample_steps"]
    dist = torch.full((N, 1), (far - near) / T, device=dev)
    if z_coarse is None:
        t = torch.linspace(0.0, 1.0, T, device=dev)
        z_coarse = (near + (far - near) * t).expand(N, T)
        if noise is not None:
            z_coarse = z_coarse + (noise - 0.5) * dist
    lo = torch.full((3,), -field.bound, device=dev)
    hi = torch.full((3,), field.bound, device=dev)

    def points(z):
        return torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * z[..., None], lo, hi)

    xc = points(z_coarse)
    sig_c, geo_c = field.density(xc)
    w_c = composite(z_coarse, sig_c.detach(), dist)
    mid = z_coarse[:, :-1] + 0.5 * (z_coarse[:, 1:] - z_coarse[:, :-1])
    if u is None:
        u = torch.linspace(0.5 / S, 1.0 - 0.5 / S, S, device=dev).expand(N, S).contiguous()
    z_fine = torch.sort(sample_pdf(mid, w_c[:, 1:-1], S, u).detach(), -1).values
    xf = points(z_fine)
    sig_f, geo_f = field.density(xf)
    if keep is not None:
        keep["coarse"], keep["fine"] = xc.detach(), xf.detach()

    z = torch.cat([z_coarse, z_fine], 1)
    order = torch.argsort(z, dim=1, stable=True)  # a fine depth equal to a coarse one after it
    z = z.gather(1, order)
    sig = torch.cat([sig_c, sig_f], 1).gather(1, order)
    geo = torch.cat([geo_c, geo_f], 1)
    geo = geo.gather(1, order[..., None].expand(-1, -1, geo.shape[-1]))
    w = composite(z, sig, dist)
    col = field.lidar_color(frequency(rays_d, LIDAR_DIR_DEGREE), geo)
    col = torch.where((w > WEIGHT_MASK)[..., None], col, 0.0)
    return (w * z).sum(-1), (w[..., None] * col).sum(1)


# -------------------------------------------------------------------- losses


def patch_dims(p):
    return (p, p) if isinstance(p, int) else (p[0], p[-1])


def step_loss(cfg, depth, image, gt, patch):
    """The LiDAR loss of one step: alpha_d l1(depth) + alpha_r mse(ray-drop)
    + alpha_i mse(intensity), depth and intensity masked by the ray-drop
    truth, their means over the rays; with a patch and grad_loss, alpha_grad
    x the mean l1 of the x-gradients of the depth patches where the truth's
    gradient is under 0.01 and both pixels return."""
    drop = gt[:, 0]
    gi, gd = gt[:, 1] * drop, gt[:, 2] * drop
    pd, pi = depth * drop, image[:, 1] * drop
    loss = (cfg["alpha_d"] * (pd - gd).abs() + cfg["alpha_r"] * (image[:, 0] - drop) ** 2
            + cfg["alpha_i"] * (pi - gi) ** 2).mean()
    px, py = patch_dims(patch)
    if px > 1 and cfg["grad_loss"]:
        def pat(v):
            return v.reshape(-1, px, py)
        d, g, r = pat(pd) / cfg["scale"], pat(gd) / cfg["scale"], pat(drop)
        pred_gx = (d[:, :, :-1] - d[:, :, 1:]).abs()
        gt_gx = g[:, :, :-1] - g[:, :, 1:]
        mask = r[:, :, :-1] * (gt_gx.abs() < 0.01).float()
        loss = loss + cfg["alpha_grad"] * ((pred_gx * mask - gt_gx * mask).abs()).mean()
    return loss


# ---------------------------------------------------------------- occupancy


def occ_refresh(field, grid, occ, bound, jitter):
    """max(grid x decay, sigma at one jittered point of each cell)."""
    G = occ["grid_size"]
    idx = torch.arange(G, dtype=torch.float32, device=grid.device)
    cell = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1)
    x = -bound + (cell + jitter) * (2.0 * bound / G)
    sig = torch.cat([field.density(c)[0] for c in x.reshape(-1, 3).split(1 << 20)])
    return torch.maximum(grid * occ["decay"], sig.reshape(G, G, G))


def occupied(grid, occ):
    """Cells within `dilate` cells of one above min(mean, density_thresh)."""
    o = (grid > torch.clamp(grid.mean(), max=occ["density_thresh"])).float()
    k = occ["dilate"]
    if k > 0:
        o = torch.nn.functional.max_pool3d(o[None, None], 2 * k + 1, 1, k)[0, 0]
    return o


def occ_depths(occ3, rays_o, rays_d, near, far, occ, bound, T, xi):
    """Coarse depths [N, T] by stratified inverse CDF of the per-ray pdf over
    `bins` depth bins: (1 - floor) of the mass on the bins whose midpoint's
    nearest cell is occupied (each weighted 1, an empty one 1e-8), the rest
    uniform; u = (j + xi_j) / T. The cdf is summed in float64."""
    K, G = occ["bins"], occ["grid_size"]
    N, dev = rays_o.shape[0], rays_o.device
    t = (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
    zb = near + (far - near) * t
    x = rays_o[:, None, :] + rays_d[:, None, :] * zb[None, :, None]
    gi = torch.clamp(torch.floor((x + bound) * (G / (2.0 * bound))).long(), 0, G - 1)
    w = occ3.reshape(-1)[(gi[..., 0] * G + gi[..., 1]) * G + gi[..., 2]].double() + 1e-8
    pdf = (1.0 - occ["floor"]) * w / w.sum(-1, keepdim=True) + occ["floor"] / K
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1).float()
    u = (torch.arange(T, dtype=torch.float32, device=dev)[None, :] + xi) / T
    below = torch.clamp(torch.searchsorted(cdf[:, 1:].contiguous(), u, right=True), max=K - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, below + 1)
    den = torch.where(c1 - c0 < 1e-12, 1.0, c1 - c0)
    frac = torch.clamp((u - c0) / den, 0.0, 1.0)
    bw = (far - near) / K
    return near + bw * below.float() + frac * bw
