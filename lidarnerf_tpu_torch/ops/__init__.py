"""ops"""

from lidarnerf_tpu_torch.ops.activation import trunc_exp
from lidarnerf_tpu_torch.ops.encoders import (
    frequency_encode,
    frequency_encoding_dim,
    sh_encode,
    sh_encoding_dim,
)
from lidarnerf_tpu_torch.ops.hash_grid import HashGridSpec, hash_grid_encode, hash_grid_init
from lidarnerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from lidarnerf_tpu_torch.ops.compositing import composite_weights
from lidarnerf_tpu_torch.ops.chamfer import chamfer_distance, fscore

__all__ = [
    "trunc_exp",
    "frequency_encode",
    "frequency_encoding_dim",
    "sh_encode",
    "sh_encoding_dim",
    "HashGridSpec",
    "hash_grid_encode",
    "hash_grid_init",
    "sample_pdf",
    "stratified_z_vals",
    "composite_weights",
    "chamfer_distance",
    "fscore",
]
