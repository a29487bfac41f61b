"""Tiny sizes of every cell, for the harness's CPU tests: the same code paths
at shapes a CPU run holds in seconds."""

import copy

TINY_CONFIG = {"log2_hashmap_size": 10, "desired_resolution": 64, "num_steps": 16,
               "upsample_steps": 8, "num_rays_lidar": 256}
TINY_HW = {"street": [16, 64], "car": [24, 96]}
TINY_TRAFFIC = {"warm_epochs": 1, "trace_epochs": 1, "max_ray_batch": 512, "warm_panos": 1,
                "trace_panos": 2, "check_panos": 2}
TINY_FAST = {"num_steps": 8, "grid_size": 16, "bins": 16, "update_interval": 5}


def tiny(config, traffic):
    """(config, traffic) cut to tiny sizes."""
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config.update(TINY_CONFIG)
    config["scene"].update(train_frames=4, hw=TINY_HW[config["scene"]["generator"]])
    traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
    if traffic.get("fast"):
        traffic["fast"].update(TINY_FAST)
    return config, traffic
