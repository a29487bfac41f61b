"""The `train` entry: the CLI's training epochs through the port's captured
epoch functions (`lidarnerf_tpu_torch/nerf/train_step.py::make_epoch_step`).

Set-up builds one trainer state (the model with fixed initial weights, one
DeviceAdam, one epoch function per patch size sharing a graph pool, the
EMA shadow, the generator of the step draws) and drives it through the
check: one eager step of each patch size the schedule uses (the epoch
functions' own step; the first one's gradient and the parameters' change
after them are kept), then the first epoch of the schedule, which captures
the epoch-long graph that the window replays. The losses of its first
steps, read from the epoch's metrics, are kept too, and under `--fast` the
grid after it, which the refreshes between its replays made in place. Then the
other warm epochs capture the other graphs. The window runs epochs of the
schedule (the training frames in a seeded order; the patch size
alternating by epoch as `Trainer.train` alternates it; one host fetch of
the epoch's metrics; the EMA update) until `--seconds` have passed.
"""

import time

import numpy as np
import torch
from torch.profiler import record_function as span

from benchmark import reference as ref
from benchmark import scenes, weights
from benchmark.common import sub_seed, sync

METRIC_KEYS = ("loss", "depth_mae", "raydrop_err", "skipped_nonfinite")


def patch_of_epoch(cfg, epoch):
    """The patch size of epoch `epoch` (from 1), as `Trainer.train` picks it."""
    change = cfg["change_patch_size_lidar"]
    if change[0] > 1:
        return list(change) if epoch % cfg["change_patch_size_epoch"] == 0 else 1
    return cfg["patch_size_lidar"]


# Every training run starts from the same initial weights, and the seed draws
# the steps' pixels, jitter and frame orders: with weights drawn from the seed,
# nerfmvl's rays/s moved ~1.5% from seed to seed against ~0.3% between two runs
# of one seed, as B2's contention follows where the weights put the samples.
WEIGHTS_SEED = sub_seed(0, 0)


def eager_patches(cfg):
    """The patch sizes of the schedule's first two epochs, each once, in order:
    the check's eager steps."""
    out = []
    for epoch in (1, 2):
        if patch_of_epoch(cfg, epoch) not in out:
            out.append(patch_of_epoch(cfg, epoch))
    return out


def check_plan(cfg, traffic, seed, n_frames):
    """[(frame, patch, global step)] of the check: the eager steps on distinct
    frames, then the first `check_steps` steps of the first epoch (the frames
    of its seeded order).

    Under `--fast` no compared step follows a refresh made inside the epoch:
    on the untrained field the cells' densities lie within their rounding of
    the occupancy threshold (their mean), so the occupied cells after the
    second refresh are decided by rounding, and no reference can follow the
    samples drawn from them. `grid_unchanged` holds that refresh instead."""
    patches = eager_patches(cfg)
    e = len(patches)
    frames = np.random.default_rng(sub_seed(seed, 5)).permutation(n_frames)[:e]
    plan = [(int(f), p, i) for i, (f, p) in enumerate(zip(frames, patches))]
    order = first_order(seed, n_frames)[:traffic["check_steps"]]
    fast = traffic.get("fast")
    if fast and any(g % fast["update_interval"] == 0 for g in range(e, e + len(order))):
        raise ValueError("a compared step of the check follows a refresh inside the epoch")
    return plan + [(int(f), patch_of_epoch(cfg, 1), e + i) for i, f in enumerate(order)]


def first_order(seed, n_frames):
    """The frame order of the first epoch (the first draw of the orders' stream)."""
    return np.random.default_rng(sub_seed(seed, 3)).permutation(n_frames)


def render_cfg(cfg, traffic):
    """The render settings of the cell: the config's, under `--fast` the traffic's."""
    out = dict(cfg)
    fast = traffic.get("fast")
    if fast:
        out["num_steps"] = fast["num_steps"]
    return out


class TrainCell:
    def __init__(self, cfg, traffic, seed, device):
        from lidarnerf_tpu_torch.models.network import NeRFNetwork
        from lidarnerf_tpu_torch.models.occupancy import OccConfig, init_occ_grid, update_occ_grid
        from lidarnerf_tpu_torch.models.renderer import RenderConfig
        from lidarnerf_tpu_torch.nerf import train_step

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        t0 = time.perf_counter()
        self.rcfg_d = render_cfg(cfg, traffic)
        self.data = scenes.make(cfg, sub_seed(seed, 1), device)
        self.w0 = weights.draw(cfg, WEIGHTS_SEED, device)
        sync(device)
        self.phases = {"scene_and_weights": time.perf_counter() - t0}
        H, W = self.data["hw"]
        model = NeRFNetwork(
            encoding=cfg["encoding"], desired_resolution=cfg["desired_resolution"],
            log2_hashmap_size=cfg["log2_hashmap_size"], num_levels=cfg["num_levels"],
            n_features_per_level=cfg["n_features_per_level"],
            base_resolution=cfg["base_resolution"], num_layers=cfg["num_layers"],
            hidden_dim=cfg["hidden_dim"], geo_feat_dim=cfg["geo_feat_dim"],
            num_layers_color=cfg["num_layers_color"], hidden_dim_color=cfg["hidden_dim_color"],
            bound=cfg["bound"], compute_dtype=getattr(torch, cfg["compute_dtype"]))
        model.to(device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(self.w0[name])
        self.model = model
        self.phases["model"] = time.perf_counter() - t0
        scale = self.data["scale"]
        self.tcfg = train_step.TrainConfig(
            alpha_d=cfg["alpha_d"], alpha_r=cfg["alpha_r"], alpha_i=cfg["alpha_i"],
            alpha_grad=cfg["alpha_grad"], grad_loss=cfg["grad_loss"],
            depth_loss=cfg["depth_loss"], depth_grad_loss=cfg["depth_grad_loss"],
            intensity_loss=cfg["intensity_loss"], raydrop_loss=cfg["raydrop_loss"],
            scale=scale, num_rays_lidar=cfg["num_rays_lidar"], H_lidar=H, W_lidar=W,
            intrinsics_lidar=tuple(self.data["intrinsics"]), lr=cfg["lr"], iters=cfg["iters"])
        fast = traffic.get("fast")
        self.occ = None if not fast else OccConfig(
            grid_size=fast["grid_size"], update_interval=fast["update_interval"],
            density_thresh=fast["density_thresh"], floor=fast["floor"], bins=fast["bins"],
            dilate=fast["dilate"])
        self.rcfg = RenderConfig(num_steps=self.rcfg_d["num_steps"],
                                 upsample_steps=cfg["upsample_steps"], min_near_lidar=scale,
                                 min_near=scale, bound=cfg["bound"], occ=self.occ)
        self.grid = None if self.occ is None else init_occ_grid(self.occ, device)
        self.adam = train_step.make_optimizer(model.named_parameters(), self.tcfg)
        self.pool = train_step.GraphPool(device) if device.type == "cuda" else None
        self.fns = {}
        self.make_epoch_step = train_step.make_epoch_step
        self.update_occ_grid = update_occ_grid
        self.ema_update = train_step.ema_update
        self.gen = torch.Generator(device).manual_seed(sub_seed(seed, 2))
        self.order_rng = np.random.default_rng(sub_seed(seed, 3))  # first draw: first_order()
        self.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.ema_updates = 0
        self.epoch = 0
        self.global_step = 0
        self.n_frames = self.data["poses"].shape[0]
        self.failed = 0
        sync(device)
        self.phases["optimizer_and_state"] = time.perf_counter() - t0

    def epoch_fn(self, patch):
        key = str(patch)
        if key not in self.fns:
            self.fns[key] = self.make_epoch_step(
                self.model, self.tcfg, self.rcfg, patch_size=patch,
                masked_sampling=self.data["masked"], optimizer=self.adam, device=self.device,
                capture=True, graph_pool=self.pool)
        return self.fns[key]

    def _call(self, patch, order):
        d = self.data
        return self.epoch_fn(patch)(d["poses"], d["images"], d["valid_idx"], d["valid_counts"],
                                    np.asarray(order), self.global_step, generator=self.gen,
                                    occ_grid=self.grid)

    # ------------------------------------------------------------ set-up

    def check_plan(self):
        return check_plan(self.cfg, self.traffic, self.seed, self.n_frames)

    def eager_step(self, frame, patch):
        """One step of the epoch function's own step, eagerly, after the grid
        refresh that the epoch would make before it; returns its loss."""
        d = self.data
        if self.occ is not None and self.global_step % self.occ.update_interval == 0:
            self.grid.copy_(self.update_occ_grid(self.model, self.grid, self.occ,
                                                 self.cfg["bound"], generator=self.gen))
        m = self.epoch_fn(patch).step(d["poses"], d["images"], d["valid_idx"],
                                      d["valid_counts"], frame, generator=self.gen,
                                      occ_grid=self.grid)
        self.global_step += 1
        return m["loss"]

    def run_check(self, plan):
        """Drive the state through the check's eager steps and first epoch;
        returns the program's readings."""
        eager = [(f, p) for f, p, _ in plan[:len(eager_patches(self.cfg))]]
        losses, first_grad = [], None
        for frame, patch in eager:
            losses.append(self.eager_step(frame, patch))
            if first_grad is None:  # Adam's first moment after one step is (1 - b1) g
                first_grad = {n: (mu / (1.0 - self.adam.betas[0])).cpu()
                              for n, mu in zip(self.adam.names, self.adam.mu)}
        change = {n: float((p.detach().double() - self.w0[n].double()).norm())
                  for n, p in self.model.named_parameters()}
        out = {"first_grad": {k: float(v.double().norm()) for k, v in first_grad.items()},
               "first_grad_full": first_grad, "change": change}
        if self.grid is not None:
            out["grid"] = self.grid.detach().clone()
        self.run_epoch()
        if self.grid is not None:
            out["grid_epoch"] = self.grid.detach().clone()
        if not np.array_equal(self.last_order, first_order(self.seed, self.n_frames)):
            raise RuntimeError("the first epoch's frame order is not the check's")
        n = len(plan) - len(eager)
        out["losses"] = [float(x) for x in torch.stack(losses).reshape(-1).cpu()] + [
            float(x) for x in self.last_losses[:n]]
        return out

    def run_epoch(self):
        """One epoch of the schedule with its metrics fetch and EMA update;
        returns its step count."""
        self.epoch += 1
        order = self.order_rng.permutation(self.n_frames)
        with span("bench.epoch"):
            ms = self._call(patch_of_epoch(self.cfg, self.epoch), order)
        with span("bench.metrics_fetch"):
            fetched = torch.stack([ms[k] for k in METRIC_KEYS]).cpu().numpy()
        bad = ~np.isfinite(fetched[0]) | (fetched[3] != 0)
        self.failed += int(bad.sum())
        self.last_order, self.last_losses = order, fetched[0]
        self.global_step += len(order)
        with span("bench.ema"):
            self.ema_update(self.ema, self.model.state_dict(), self.cfg["ema_decay"],
                            self.ema_updates)
        self.ema_updates += 1
        return len(order)

    def setup(self):
        t0 = time.perf_counter()
        self.program = self.run_check(self.check_plan())
        self.phases["check"] = time.perf_counter() - t0
        for _ in range(self.traffic["warm_epochs"] - 1):
            self.run_epoch()
        sync(self.device)
        self.phases["warm_epochs"] = time.perf_counter() - t0

    # ------------------------------------------------------------ window

    def window(self, seconds, traced=None):
        """Epochs until `seconds` have passed; the traced sub-window (if any)
        covers `trace_epochs` epochs from a third of the window on.
        Returns (steps, seconds)."""
        sync(self.device)
        t0 = time.perf_counter()
        steps, done_trace = 0, traced is None
        self.epoch_ends = []  # (steps, seconds) at each epoch's end: the rate's drift
        while time.perf_counter() - t0 < seconds or not done_trace:
            if steps:
                self.epoch_ends.append((steps, time.perf_counter() - t0))
            if not done_trace and time.perf_counter() - t0 >= seconds / 3:
                g0 = self.global_step
                with traced.window():
                    for _ in range(self.traffic["trace_epochs"]):
                        steps += self.run_epoch()
                traced.units = self.global_step - g0
                interval = self.occ.update_interval if self.occ else 0
                traced.extra["refreshes"] = sum(1 for g in range(g0, self.global_step)
                                                if interval and g % interval == 0)
                done_trace = True
                continue
            steps += self.run_epoch()
        sync(self.device)
        return steps, time.perf_counter() - t0

    def drift(self):
        """Rays/s over the window's first third and over its last third, from
        the epochs' ends (each after the epoch's host fetch)."""
        ends = [(0, 0.0)] + self.epoch_ends
        total = ends[-1][1]
        first = max((e for e in ends if e[1] <= total / 3), key=lambda e: e[1])
        last = min((e for e in ends if e[1] >= 2 * total / 3), key=lambda e: e[1])
        rays = self.cfg["num_rays_lidar"]
        if first[1] <= 0 or last[1] >= total:
            return None
        return (first[0] * rays / first[1],
                (ends[-1][0] - last[0]) * rays / (total - last[1]))

    def release(self):
        """Free the program's state before the reference runs."""
        keep = getattr(self, "program", None)
        for name in ("model", "fns", "adam", "pool", "ema", "grid"):
            setattr(self, name, None)
        return keep


# ------------------------------------------------------------ the reference


def reference_run(cfg, traffic, seed, data, plan, device, precision=ref.FP32, grid=None,
                  fault=None, keep=None):
    """The reference over the check's steps from the same weights and draws.

    Draws in the program's order from a generator of the same seed: before a
    step whose global step is a multiple of the refresh interval (`--fast`)
    the refresh's jitter, then the pixels (uniform, patch corners, or pool
    positions as 62-bit integers modulo the pool's count), the jitter and
    the inverse-CDF numbers. Under `--fast` the grid refreshes are the
    reference's own, the first one's result returned for the check; the
    coarse depths follow the occupied cells of `grid`, the program's grid
    after its first refresh (the stage past the refresh's threshold), or of
    the reference's own where `grid` is None, and from the next refresh on,
    the reference's refresh of that grid. `fault` "half_batch" takes the
    loss over the first half of the rays; "epoch_unchanged" leaves the state
    as it was from the first step after the eager ones. Returns {"losses",
    "first_grad" (each leaf's norm), "first_grad_full" (each leaf), "change"
    (after the eager steps)[, "grid"]}.
    """
    rc = render_cfg(cfg, traffic)
    rc["scale"] = data["scale"]
    w = weights.draw(cfg, WEIGHTS_SEED, device)
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    field = ref.Field(params, cfg, precision)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 2))
    H, W = data["hw"]
    N, T, S = cfg["num_rays_lidar"], rc["num_steps"], cfg["upsample_steps"]
    fast = traffic.get("fast")
    n_eager = len(eager_patches(cfg))
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    b1, b2, eps = 0.9, 0.99, 1e-15
    losses, first_grad, out = [], None, {}
    stage = None if not fast else torch.zeros((fast["grid_size"],) * 3, device=device)
    with ref.float32_matmuls():
        for k, (frame, patch, gstep) in enumerate(plan):
            if k == n_eager:
                out["change"] = {n: float((params[n].detach().double() - w[n].double()).norm())
                                 for n in params}
            if fast and gstep % fast["update_interval"] == 0:
                G = fast["grid_size"]
                jitter = torch.rand((G, G, G, 3), generator=gen, device=device)
                with torch.no_grad():
                    stage = ref.occ_refresh(field, stage, fast, cfg["bound"], jitter)
                if "grid" not in out:
                    out["grid"] = stage
                    stage = stage if grid is None else grid.to(device)
            px, py = ref.patch_dims(patch)
            if data["masked"]:
                raw = torch.randint(0, 2 ** 62, (N,), generator=gen, device=device)
                pos = raw % torch.clamp(data["valid_counts"][frame], min=1)
                inds = data["valid_idx"][frame][pos]
            elif px > 1 or py > 1:
                ix = torch.randint(0, H - px, (N // (px * py),), generator=gen, device=device)
                iy = torch.randint(0, W - py, (N // (px * py),), generator=gen, device=device)
                pi, pj = torch.meshgrid(torch.arange(px, device=device),
                                        torch.arange(py, device=device), indexing="ij")
                inds = (ix[:, None] + pi.reshape(1, -1)).reshape(-1) * W + (
                    iy[:, None] + pj.reshape(1, -1)).reshape(-1)
            else:
                inds = torch.randint(0, H * W, (N,), generator=gen, device=device)
            noise = torch.rand((N, T), generator=gen, device=device)
            u = torch.rand((N, S), generator=gen, device=device)
            pose = data["poses"][frame]
            ro, rd = ref.pixel_rays(pose, inds, H, W, data["intrinsics"])
            gt = data["images"][frame].reshape(-1, 3)[inds]
            z0 = None
            if fast:
                near = data["scale"]
                z0 = ref.occ_depths(ref.occupied(stage, fast), ro, rd, near, near * ref.FAR_MULT,
                                    fast, cfg["bound"], T, noise)
            kept = {} if (keep is not None and k == 0) else None
            depth, image = ref.render(field, ro, rd, rc, noise=None if fast else noise, u=u,
                                      z_coarse=z0, keep=kept)
            if kept is not None:
                keep.update(kept)
                keep["rays"] = (ro.detach(), rd.detach())
            h = N // 2 if fault == "half_batch" else N
            loss = ref.step_loss(rc, depth[:h], image[:h], gt[:h], patch)
            losses.append(float(loss.detach()))
            if k == len(plan) - 1 or (fault == "epoch_unchanged" and k >= n_eager):
                continue  # the last step's update reaches no compared number
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            with torch.no_grad():
                lr = cfg["lr"] * 0.1 ** min(gstep / cfg["iters"], 1.0)
                for (name, p), g in zip(params.items(), grads):
                    g = torch.zeros_like(p) if g is None else g
                    mu[name].mul_(b1).add_(g, alpha=1 - b1)
                    nu[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = mu[name] / (1 - b1 ** (k + 1))
                    vhat = nu[name] / (1 - b2 ** (k + 1))
                    p.sub_(lr * mhat / (vhat.sqrt() + eps))
                if first_grad is None:
                    full = {n: torch.zeros_like(params[n]) if g is None else g.detach()
                            for n, g in zip(params, grads)}
                    first_grad = {n: float(g.double().norm()) for n, g in full.items()}
                    out["first_grad_full"] = full
    out.update(losses=losses, first_grad=first_grad)
    out.setdefault("change", {n: float((params[n].detach().double() - w[n].double()).norm())
                              for n in params})
    return out
