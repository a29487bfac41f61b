"""Encoder factory (counterpart of lidarnerf_tpu/ops/factory.py::get_encoder).

`get_encoder(name, ...)` returns (encode_fn(x, params), init_fn(generator),
output_dim), the JAX triple in torch idiom: `init_fn` draws the encoder's
parameter tensor (None for the parameter-free encodings) from a
`torch.Generator`. Names: None | frequency | sphere_harmonics | hashgrid |
tiledgrid | periodic_volume | blockhash (`ops/block_hash.py`, the block-hash
grid of kernels B1-B4).
"""

from lidarnerf_tpu_torch.ops import block_hash as bhash
from lidarnerf_tpu_torch.ops import hash_grid as hg
from lidarnerf_tpu_torch.ops import periodic_volume as pv
from lidarnerf_tpu_torch.ops.encoders import (
    frequency_encode,
    frequency_encoding_dim,
    sh_encode,
    sh_encoding_dim,
)


def get_encoder(
    encoding,
    input_dim=3,
    multires=6,
    degree=4,
    num_levels=16,
    level_dim=2,
    base_resolution=16,
    log2_hashmap_size=19,
    desired_resolution=2048,
    align_corners=False,
    **kwargs,
):
    """Returns (encode_fn(x, params), init_fn(generator) -> params, output_dim)."""
    if encoding in ("None", "none", None):
        return (lambda x, params=None: x), (lambda generator=None: None), input_dim

    if encoding == "frequency":
        return (
            lambda x, params=None: frequency_encode(x, multires),
            lambda generator=None: None,
            frequency_encoding_dim(input_dim, multires),
        )

    if encoding == "sphere_harmonics":
        return (
            lambda x, params=None: sh_encode(x, degree),
            lambda generator=None: None,
            sh_encoding_dim(degree),
        )

    if encoding in ("hashgrid", "tiledgrid"):
        spec = hg.make_hash_grid_spec(
            input_dim=input_dim,
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            align_corners=align_corners,
        )
        return (
            lambda x, params: hg.hash_grid_encode(x, params, spec),
            lambda generator=None: hg.hash_grid_init(spec, generator),
            spec.output_dim,
        )

    if encoding == "periodic_volume":
        pspec = pv.make_periodic_volume_spec(
            num_levels=num_levels,
            min_res=base_resolution,
            max_res=desired_resolution,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=level_dim,
            smoothstep=kwargs.get("smoothstep", False),
        )
        return (
            lambda x, params: pv.periodic_volume_encode(x, params, pspec),
            lambda generator=None: pv.periodic_volume_init(pspec, generator),
            pspec.output_dim,
        )

    if encoding == "blockhash":
        spec = bhash.make_block_hash_spec(
            num_levels=num_levels,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
        )
        return (
            lambda x, params: bhash.block_hash_encode(x, params, spec),
            lambda generator=None: bhash.block_hash_init(spec, generator),
            spec.output_dim,
        )

    raise NotImplementedError(
        "Unknown encoding mode, choose from [None, frequency, "
        "sphere_harmonics, hashgrid, tiledgrid, blockhash, periodic_volume]"
    )
