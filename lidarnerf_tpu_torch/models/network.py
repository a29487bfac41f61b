"""LiDAR-NeRF field network (counterpart of lidarnerf_tpu/models/network.py).

- sigma net: position encoding(x) -> num_layers bias-free Linear(hidden) ->
  [1 sigma | geo_feat]; sigma = trunc_exp(h[..., 0]). The position encodings
  are the JAX module's: hashgrid (the default, `ops/hash_grid.py`),
  tiledgrid, blockhash (`ops/block_hash.py`, kernels B1-B4),
  periodic_volume (`ops/periodic_volume.py`), frequency and None.
- LiDAR color net: frequency(degree 12) direction encoding ++ geo_feat ->
  3 layers -> sigmoid 2 = (ray-drop prob, intensity).
- RGB color net: SH(degree 4) direction encoding ++ geo_feat -> 3 layers ->
  sigmoid 3.
- background (bg_radius > 0): a 4-level 2-D hash grid over the background
  sphere's (theta, phi) ++ the SH direction encoding -> bg_net -> sigmoid 3.

Precision follows flax `Dense(dtype=compute_dtype, param_dtype=float32)`:
parameters are float32; each layer casts its input and weight to
`compute_dtype` (bfloat16 under --fp16) and accumulates in float32;
activations stay in `compute_dtype` between layers; the head output is cast
to float32 before trunc_exp / sigmoid. Positions, sigma and compositing stay
float32.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from lidarnerf_tpu_torch.ops import block_hash as bhash
from lidarnerf_tpu_torch.ops import hash_grid as hg
from lidarnerf_tpu_torch.ops import periodic_volume as pv
from lidarnerf_tpu_torch.ops.activation import trunc_exp
from lidarnerf_tpu_torch.ops.encoders import (
    frequency_encode,
    frequency_encoding_dim,
    sh_encode,
    sh_encoding_dim,
)

LIDAR_DIR_DEGREE = 12  # frequency degree of the LiDAR direction encoding
RGB_DIR_DEGREE = 4  # SH degree of the RGB and background direction encoding


class MLP(nn.Module):
    """Bias-free ReLU MLP; weights init Uniform(+-1/sqrt(fan_in)) like torch nn.Linear."""

    def __init__(self, in_dim, num_layers, hidden_dim, out_dim,
                 compute_dtype=torch.float32, generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            lin = nn.Linear(d_in, d_out, bias=False)
            bound = 1.0 / math.sqrt(d_in)
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
            self.layers.append(lin)

    def forward(self, x):
        h = x.to(self.compute_dtype)
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            h = F.linear(h, lin.weight.to(self.compute_dtype))
            if i != last:
                h = F.relu(h)
        return h


class NeRFNetwork(nn.Module):
    """The JAX module's fields, in its order and with its defaults, then
    `generator` (the init's random stream). Under blockhash, `seam_tie`
    averages the two stored copies of every dense-level seam corner inside
    each encode (`block_hash.tie_dense_seams`), and n_features_per_level != 2
    raises: the table rows hold 2 features per level. `encoding_dir` is not read, as in the JAX
    module (directions take the frequency or SH encoding of their head);
    `multires` only with the frequency encoding and `num_layers_bg`,
    `hidden_dim_bg` only with the background sphere (bg_radius > 0)."""

    def __init__(
        self,
        encoding="hashgrid",
        encoding_dir="sphere_harmonics",
        multires=6,
        desired_resolution=2048,
        log2_hashmap_size=19,
        n_features_per_level=2,
        num_levels=16,
        base_resolution=16,
        num_layers=2,
        hidden_dim=64,
        geo_feat_dim=15,
        num_layers_color=3,
        hidden_dim_color=64,
        out_color_dim=3,
        out_lidar_color_dim=2,
        num_layers_bg=2,
        hidden_dim_bg=64,
        bg_radius=-1.0,
        bound=1.0,
        compute_dtype=torch.float32,
        seam_tie=False,
        generator=None,
    ):
        super().__init__()
        if encoding == "blockhash" and n_features_per_level != 2:
            raise NotImplementedError(
                f"n_features_per_level={n_features_per_level}: the block-hash table "
                "stores 2 features per level"
            )
        self.encoding = encoding
        self.seam_tie = bool(seam_tie)
        self.table_mesh = None  # a Mesh when the table is row-sharded (parallel/sharding.py)
        self.multires = multires
        self.bound = bound
        self.bg_radius = bg_radius
        self.block_spec = self.grid_spec = self.pv_spec = None
        if encoding == "blockhash":
            self.block_spec = bhash.make_block_hash_spec(
                num_levels=num_levels,
                base_resolution=base_resolution,
                log2_hashmap_size=log2_hashmap_size,
                desired_resolution=desired_resolution,
            )
            table = bhash.block_hash_init(self.block_spec, generator)
            in_dim = self.block_spec.output_dim
        elif encoding in ("hashgrid", "tiledgrid"):
            self.grid_spec = hg.make_hash_grid_spec(
                input_dim=3,
                num_levels=num_levels,
                level_dim=n_features_per_level,
                base_resolution=base_resolution,
                log2_hashmap_size=log2_hashmap_size,
                desired_resolution=desired_resolution,
                gridtype="hash" if encoding == "hashgrid" else "tiled",
            )
            table = hg.hash_grid_init(self.grid_spec, generator)
            in_dim = self.grid_spec.output_dim
        elif encoding == "periodic_volume":
            self.pv_spec = pv.make_periodic_volume_spec(
                num_levels=num_levels,
                min_res=base_resolution,
                max_res=desired_resolution,
                log2_hashmap_size=log2_hashmap_size,
                features_per_level=n_features_per_level,
            )
            table = pv.periodic_volume_init(self.pv_spec, generator)
            in_dim = self.pv_spec.output_dim
        elif encoding == "frequency":
            table, in_dim = None, frequency_encoding_dim(3, multires)
        elif encoding in ("None", "none", None):
            table, in_dim = None, 3
        else:
            raise NotImplementedError(f"encoding '{encoding}'")
        if table is not None:
            self.hash_table = nn.Parameter(table)

        lidar_dir_dim = frequency_encoding_dim(3, LIDAR_DIR_DEGREE)
        rgb_dir_dim = sh_encoding_dim(RGB_DIR_DEGREE)
        self.sigma_net = MLP(in_dim, num_layers, hidden_dim, 1 + geo_feat_dim,
                             compute_dtype, generator)
        self.color_net = MLP(rgb_dir_dim + geo_feat_dim, num_layers_color, hidden_dim_color,
                             out_color_dim, compute_dtype, generator)
        self.lidar_color_net = MLP(lidar_dir_dim + geo_feat_dim, num_layers_color,
                                   hidden_dim_color, out_lidar_color_dim,
                                   compute_dtype, generator)
        if bg_radius > 0:
            # the background model: a small 2-D hash grid over sphere coords
            self.bg_grid_spec = hg.make_hash_grid_spec(
                input_dim=2,
                num_levels=4,
                level_dim=n_features_per_level,
                base_resolution=base_resolution,
                log2_hashmap_size=19,
                desired_resolution=2048,
            )
            self.bg_table = nn.Parameter(hg.hash_grid_init(self.bg_grid_spec, generator))
            self.bg_net = MLP(rgb_dir_dim + self.bg_grid_spec.output_dim, num_layers_bg,
                              hidden_dim_bg, 3, compute_dtype, generator)

    def encode_pos(self, x):
        """x in [-bound, bound]^3 -> position features [..., in_dim] float32."""
        x01 = (x + self.bound) / (2.0 * self.bound)
        if self.block_spec is not None:
            table = self.hash_table
            if self.table_mesh is not None:
                from lidarnerf_tpu_torch.parallel.sharding import gather_table

                table = gather_table(table, self.table_mesh)
            if self.seam_tie:
                table = bhash.tie_dense_seams(table, self.block_spec)
            return bhash.block_hash_encode(x01, table, self.block_spec)
        if self.grid_spec is not None:
            return hg.hash_grid_encode_chunked(x01, self.hash_table, self.grid_spec)
        if self.pv_spec is not None:
            return pv.periodic_volume_encode(x01, self.hash_table, self.pv_spec)
        if self.encoding == "frequency":
            return frequency_encode(x, self.multires)
        return x

    def density(self, x):
        """x: [..., 3] in [-bound, bound] -> (sigma [...], geo_feat [..., G]) float32."""
        h = self.sigma_net(self.encode_pos(x)).float()
        return trunc_exp(h[..., 0]), h[..., 1:]

    def encode_dir(self, d, cal_lidar_color=True):
        """Direction encoding, computed once per ray: LiDAR frequency(12)
        [..., 75], or RGB SH(4) [..., 16]."""
        if cal_lidar_color:
            return frequency_encode(d, LIDAR_DIR_DEGREE)
        return sh_encode(d, RGB_DIR_DEGREE)

    def color_from_enc(self, d_enc, geo_feat, cal_lidar_color=True):
        """A colour head on a precomputed direction encoding: (raydrop,
        intensity) or RGB, in [0, 1]."""
        net = self.lidar_color_net if cal_lidar_color else self.color_net
        h = net(torch.cat([d_enc, geo_feat], dim=-1))
        return torch.sigmoid(h.float())

    def lidar_color(self, d, geo_feat):
        """(raydrop, intensity) in [0, 1]; d: [..., 3] directions."""
        return self.color_from_enc(self.encode_dir(d), geo_feat)

    def rgb_color(self, d, geo_feat):
        """RGB in [0, 1]; d: [..., 3] directions."""
        return self.color_from_enc(self.encode_dir(d, False), geo_feat, False)

    def color(self, d, geo_feat, cal_lidar_color=True):
        if cal_lidar_color:
            return self.lidar_color(d, geo_feat)
        return self.rgb_color(d, geo_feat)

    def background(self, x_sph, d):
        """Background RGB from the background sphere's coordinates x_sph
        [..., 2] in [-1, 1] (theta, phi) and the directions d [..., 3]."""
        h = hg.hash_grid_encode((x_sph + 1.0) / 2.0, self.bg_table, self.bg_grid_spec)
        h = self.bg_net(torch.cat([sh_encode(d, RGB_DIR_DEGREE), h], dim=-1))
        return torch.sigmoid(h.float())
