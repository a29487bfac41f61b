"""The `serve` entry: one client in a closed loop calling the port's serving
entry, `lidarnerf_tpu_torch/nerf/infer.py::PanoRenderer.render_frame`, which
returns the (ray-drop, intensity, depth) panos as numpy arrays on the host.

Set-up draws the served field's weights from the seed on the device, hands
them to `PanoRenderer` in the flax layout a checkpoint carries, and renders
`warm_panos` panos. The window then renders the configuration's novel
poses (between the training poses) in a seeded order, cycling, until
`--seconds` have passed; a pano's latency runs from the call to its
return. Every pano's output is kept for the check.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function as span

from benchmark import reference as ref
from benchmark import scenes, weights
from benchmark.common import sub_seed, sync


def flax_tree(w):
    """{name: tensor} -> the flax parameter tree (numpy leaves) a checkpoint holds."""
    p = {"hash_table": w["hash_table"].cpu().numpy()}
    for name, t in w.items():
        net, _, rest = name.partition(".layers.")
        if rest:
            i = int(rest.removesuffix(".weight"))
            p.setdefault(net, {})[f"Dense_{i}"] = {"kernel": t.T.cpu().numpy()}
    return {"params": p}


class ServeCell:
    def __init__(self, cfg, traffic, seed, device):
        from lidarnerf_tpu_torch.nerf.infer import PanoRenderer

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.data = scenes.make(cfg, sub_seed(seed, 1), device)
        w = weights.draw(cfg, sub_seed(seed, 0), device, **traffic["weights"])
        opt = SimpleNamespace(
            encoding=cfg["encoding"], desired_resolution=cfg["desired_resolution"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            n_features_per_level=cfg["n_features_per_level"],
            num_layers=cfg["num_layers"], hidden_dim=cfg["hidden_dim"],
            geo_feat_dim=cfg["geo_feat_dim"], bound=cfg["bound"], scale=self.data["scale"],
            num_steps=cfg["num_steps"], upsample_steps=cfg["upsample_steps"],
            max_ray_batch=traffic["max_ray_batch"], fp16=cfg["compute_dtype"] == "bfloat16",
            alpha_r=cfg["alpha_r"])
        self.renderer = PanoRenderer(opt, flax_tree(w), device=device)
        del w
        self.poses = self.data["serve_poses"].cpu().numpy()
        self.order = np.random.default_rng(sub_seed(seed, 4)).permutation(len(self.poses))
        self.served = []  # (pose index, raydrop, intensity, depth)
        self.latency_ms = []
        self.failed = 0

    def pano(self, i):
        H, W = self.data["hw"]
        return self.renderer.render_frame(self.poses[i], H, W, self.data["intrinsics"])

    def setup(self):
        for k in range(self.traffic["warm_panos"]):
            self.pano(self.order[k % len(self.order)])
        sync(self.device)
        self.program = None

    def window(self, seconds, traced=None):
        """Panos until `seconds` have passed; the traced sub-window (if any)
        covers `trace_panos` panos from a third of the window on."""
        t0 = time.perf_counter()
        n, done_trace = 0, traced is None
        while time.perf_counter() - t0 < seconds or not done_trace:
            count = 1
            ctx = None
            if not done_trace and time.perf_counter() - t0 >= seconds / 3:
                count, ctx, done_trace = self.traffic["trace_panos"], traced.window(), True
                ctx.__enter__()
            for _ in range(count):
                i = int(self.order[n % len(self.order)])
                a = time.perf_counter()
                with span("bench.pano"):
                    out = self.pano(i)
                self.latency_ms.append((time.perf_counter() - a) * 1e3)
                if not all(np.isfinite(o).all() for o in out):
                    self.failed += 1
                self.served.append((i, *out))
                n += 1
            if ctx is not None:
                ctx.__exit__(None, None, None)
                traced.units = count
        return n, time.perf_counter() - t0

    def release(self):
        self.renderer = None
        return None


def reference_pano(cfg, traffic, seed, data, pose, device, precision=ref.FP32, keep=None,
                   block=4096):
    """The reference's (raydrop, intensity, depth) [H, W] of a served pose,
    rendered in blocks of `block` rays; `keep` (a list) receives each
    block's sample positions."""
    w = weights.draw(cfg, sub_seed(seed, 0), device, **traffic["weights"])
    field = ref.Field(w, cfg, precision)
    rc = dict(cfg, scale=data["scale"])
    H, W = data["hw"]
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    outs = []
    with torch.no_grad(), ref.float32_matmuls():
        for start in range(0, H * W, block):
            inds = torch.arange(start, min(start + block, H * W), device=device)
            ro, rd = ref.pixel_rays(pose, inds, H, W, data["intrinsics"])
            kept = {} if keep is not None else None
            depth, image = ref.render(field, ro, rd, rc, keep=kept)
            if keep is not None:
                keep.append(kept)
            outs.append(torch.cat([image, depth[:, None]], -1))
    pano = torch.cat(outs).reshape(H, W, 3).cpu().numpy()
    return pano[..., 0], pano[..., 1], pano[..., 2]
