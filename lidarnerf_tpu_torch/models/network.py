"""LiDAR-NeRF field network, blockhash branch (counterpart of lidarnerf_tpu/models/network.py).

- sigma net: block-hash encoding(x) -> num_layers bias-free Linear(hidden) ->
  [1 sigma | geo_feat]; sigma = trunc_exp(h[..., 0]).
- LiDAR color net: frequency(degree 12) direction encoding ++ geo_feat ->
  3 layers -> sigmoid 2 = (ray-drop prob, intensity).
- RGB color net: built so every JAX parameter has a home; RGB rendering is
  not ported yet.

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
from lidarnerf_tpu_torch.ops.activation import trunc_exp
from lidarnerf_tpu_torch.ops.encoders import frequency_encode, frequency_encoding_dim

LIDAR_DIR_DEGREE = 12  # frequency degree of the LiDAR direction encoding


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
    def __init__(
        self,
        encoding="blockhash",
        desired_resolution=2048,
        log2_hashmap_size=19,
        num_levels=16,
        base_resolution=16,
        num_layers=2,
        hidden_dim=64,
        geo_feat_dim=15,
        num_layers_color=3,
        hidden_dim_color=64,
        out_color_dim=3,
        out_lidar_color_dim=2,
        bound=1.0,
        compute_dtype=torch.float32,
        generator=None,
    ):
        super().__init__()
        if encoding != "blockhash":
            raise NotImplementedError(
                f"encoding {encoding!r}: only 'blockhash' is ported so far"
            )
        self.bound = bound
        self.block_spec = bhash.make_block_hash_spec(
            num_levels=num_levels,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
        )
        self.hash_table = nn.Parameter(bhash.block_hash_init(self.block_spec, generator))
        in_dim = self.block_spec.output_dim
        dir_dim = frequency_encoding_dim(3, LIDAR_DIR_DEGREE)
        self.sigma_net = MLP(in_dim, num_layers, hidden_dim, 1 + geo_feat_dim,
                             compute_dtype, generator)
        # the RGB head's input is SH degree 4 (16 dims) ++ geo_feat
        self.color_net = MLP(16 + geo_feat_dim, num_layers_color, hidden_dim_color,
                             out_color_dim, compute_dtype, generator)
        self.lidar_color_net = MLP(dir_dim + geo_feat_dim, num_layers_color,
                                   hidden_dim_color, out_lidar_color_dim,
                                   compute_dtype, generator)

    def encode_pos(self, x):
        """x in [-bound, bound]^3 -> block-hash features [..., 2L] float32."""
        x01 = (x + self.bound) / (2.0 * self.bound)
        return bhash.block_hash_encode(x01, self.hash_table, self.block_spec)

    def density(self, x):
        """x: [..., 3] in [-bound, bound] -> (sigma [...], geo_feat [..., G]) float32."""
        h = self.sigma_net(self.encode_pos(x)).float()
        return trunc_exp(h[..., 0]), h[..., 1:]

    def encode_dir(self, d):
        """LiDAR direction encoding, computed once per ray: [..., 3] -> [..., 75]."""
        return frequency_encode(d, LIDAR_DIR_DEGREE)

    def color_from_enc(self, d_enc, geo_feat):
        """LiDAR head on a precomputed direction encoding -> (raydrop, intensity) in [0, 1]."""
        h = self.lidar_color_net(torch.cat([d_enc, geo_feat], dim=-1))
        return torch.sigmoid(h.float())

    def lidar_color(self, d, geo_feat):
        """(raydrop, intensity) in [0, 1]; d: [..., 3] directions."""
        return self.color_from_enc(self.encode_dir(d), geo_feat)
