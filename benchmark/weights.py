"""The field's weights, drawn from the seed on the device in one call per tensor.

Names and shapes are those of the port's `NeRFNetwork` state_dict (and the
reference's `Field`): the block-hash table [L * 2^log2 / 64, 128] and the
bias-free layers `[out, in]` of the sigma net, the RGB head (held but not
run on LiDAR rays) and the LiDAR head. The training cells start where the
CLI starts: the table uniform in +-1e-4, each layer uniform in
+-1 / sqrt(fan_in). A served field is a trained one, so the serving cells
draw a table uniform in +-`table` and each net's layers uniform in
+-gain / sqrt(fan_in), which gives densities that end rays inside the scene.
"""

import math

import torch

SH_DIM = 16  # degree-4 spherical harmonics of the RGB head's direction
LIDAR_DIR_DIM = 3 + 2 * 3 * 12  # frequency(12) of the LiDAR head's direction


# What the harness and the reference implement, for the configuration's keys
# that choose a path: a configuration that asks for another is refused.
SUPPORTED = {"encoding": "blockhash", "n_features_per_level": 2, "depth_loss": "l1",
             "depth_grad_loss": "l1", "intensity_loss": "mse", "raydrop_loss": "mse"}


def check_supported(cfg):
    wrong = {k: cfg.get(k) for k, v in SUPPORTED.items() if cfg.get(k) != v}
    if wrong:
        raise ValueError(f"the benchmark implements {SUPPORTED}; the configuration asks {wrong}")


def shapes(cfg):
    """{name: shape} of every weight of the configuration's field."""
    check_supported(cfg)
    rows = cfg["num_levels"] * max(8, 2 ** cfg["log2_hashmap_size"] // 64)
    out = {"hash_table": (rows, 128)}

    def net(name, d_in, layers, hidden, d_out):
        dims = [d_in] + [hidden] * (layers - 1) + [d_out]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"{name}.layers.{i}.weight"] = (b, a)

    geo = cfg["geo_feat_dim"]
    net("sigma_net", 2 * cfg["num_levels"], cfg["num_layers"], cfg["hidden_dim"], 1 + geo)
    net("color_net", SH_DIM + geo, cfg["num_layers_color"], cfg["hidden_dim_color"], 3)
    net("lidar_color_net", LIDAR_DIR_DIM + geo, cfg["num_layers_color"], cfg["hidden_dim_color"], 2)
    return out


def draw(cfg, seed, device, table=1e-4, gain=None):
    """{name: float32 tensor} on `device`, from a generator seeded with `seed`;
    `gain` maps a net's name to its layers' gain (1 where absent)."""
    gen = torch.Generator(device).manual_seed(seed)
    gain = gain or {}
    out = {}
    for name, shape in shapes(cfg).items():
        net = name.partition(".")[0]
        bound = table if name == "hash_table" else gain.get(net, 1.0) / math.sqrt(shape[1])
        out[name] = torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound
    return out
