#!/usr/bin/env python3
"""Bisect the port's long-run `--fast` drift (ROADMAP.md C10) on one GPU.

    python3 tools/torch_c10_bisect.py --arm port --seed 0 --stop_epoch 600 \
        --out c10/port.json [--measure] [-- EXTRA CLI FLAGS]

Trains the port through its `Trainer` API exactly as `python -m
lidarnerf_tpu_torch.tools.full_run --arm fast_dil1 --iters 30000
--eval_interval 50` does (the same argv, built by `full_run.train_argv`, plus
`--seed`), but stops after `--stop_epoch` epochs of the 30k schedule: the lr
still decays over --iters. Each arm switches one difference from the JAX
package on or off:

- `port`: the port as it is (the captured epoch, the kernels);
- `eager`: `--fuse_epoch 0`, the same step without the CUDA graph;
- `plain_bwd`: the table gradient through the plain version
  (`block_hash.encode_bwd_plain`: float32 `index_add_` terms, as the JAX
  package's scatter-add sums them) instead of kernel B2 (diagnostic only);
- `tpu_matmul`: every MLP product, forward and backward, as a TPU computes
  a float32 matmul at its default precision, where the JAX package's runs
  trained: operands rounded to bfloat16, float32 sums (`TpuDefaultLinear`;
  emulated, diagnostic only); `tpu_matmul_cast`: an earlier emulation that
  rounds each gradient after its product instead (diagnostic only);
- `tf32`: every float32 matmul of the step with TF32 inputs (10 significant
  bits; the meter keeps float32), diagnostic only;
- `tpu_rays`: the rotation of the pixel directions by the pose, the one
  float32 product of the JAX package's LiDAR ray generation
  (`lidarnerf_tpu/dataset/base.py::rays_from_indices`, `dirs @
  pose[:3, :3].T`, which its `get_lidar_rays` maps over the poses), as a
  TPU computes it at default precision: both operands rounded to bfloat16,
  exact products, float32 sums (`tpu_rotate`), for the training step and
  every rendered pano alike; no gradient flows through the directions
  (emulated, diagnostic only);
- `tpu_all`: `tpu_rays` and `tpu_matmul` together: every float32 product
  of the JAX package's `--fast` training and evaluation path that a TPU
  rounds to one bfloat16 pass at default precision, as far as the port can
  emulate it (the meter's is the second meter below).

Every evaluation's meters go to the JSON at --out with every epoch's loss,
the wall time and the card's name and power limit; and for each pano it
renders (val at each evaluation, test at the end with `--test`): the rays
the ray-drop mask keeps (pred > 0.5), those it keeps where the ground truth
dropped, those it drops where the ground truth kept, the kept rays whose
depth misses by more than 1 m, and the pano's Chamfer and F@0.05 twice: as
the port's meter computes them (`ops/chamfer.py`, float32 products) and with
the meter's cross product a.b^T at a TPU's default float32 matmul
precision, one bfloat16 pass with float32 sums, as the JAX package's meter
(`lidarnerf_tpu/ops/chamfer.py`, `ac @ b.T`) computed them in its TPU runs
(an emulation, unverified against a TPU; diagnostic only). `--test` then evaluates the test split with the final
weights and with the best-by-val-Chamfer checkpoint, as `full_run
--best_eval` does.

`--measure` then measures at the final state (the run's epoch-600 state by
default), on one training batch of frame 0 (4096 rays, patch 1):
- (c) the table gradient of B2 against a float64 reference (`index_add_` in
  float64 on the card) and the float32 plain version: entries B2 zeroes
  where the reference is not, the reverse, sign flips, a histogram by
  decade of the reference's magnitude of the entries B2 zeroes, and the
  norm of the Adam update (the trainer's moments and step count) over the
  entries below 1e-6 of the peak, with each gradient;
- (b) the occupancy refresh on the card against the CPU port at the same
  parameters and jitter: the grids' largest difference and occupied shares;
- (d) the loss, each parameter group's gradient and the ray-drop head's
  output on the card against the CPU port, on the same injected draws;
- (a) the captured epoch's draws: 2 epochs of 16 replays record their pixel
  indices and jitter rows, which must all differ.

`chip_smoke.py`'s drift phase runs `measure_table_grad` and
`measure_replay_draws` at its trained `--fast` state.

Needs a GPU for every arm (LIDARNERF_PLATFORM=cpu runs it on the CPU, for a
rehearsal at a tiny size given through the extra CLI flags). Imports no JAX.
"""

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lidarnerf_tpu_torch import main_lidarnerf as cli  # noqa: E402
from lidarnerf_tpu_torch.dataset import base  # noqa: E402
from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices  # noqa: E402
from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar  # noqa: E402
from lidarnerf_tpu_torch.models import network, occupancy  # noqa: E402
from lidarnerf_tpu_torch.models.renderer import render_rays  # noqa: E402
from lidarnerf_tpu_torch.nerf import train_step  # noqa: E402
from lidarnerf_tpu_torch.ops import block_hash  # noqa: E402
from lidarnerf_tpu_torch.ops.chamfer import _fp32_matmul, chamfer_and_fscore, fscore  # noqa: E402
from lidarnerf_tpu_torch.tools import ab_run, full_run  # noqa: E402

ARMS = ("port", "eager", "plain_bwd", "tpu_matmul", "tpu_matmul_cast", "tf32", "tpu_rays",
        "tpu_all")
TPU_ROTATIONS = [0]  # calls of `tpu_rays_from_indices` (each capture counts once)


def gpu_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


class TpuDefaultLinear(torch.autograd.Function):
    """x @ w.T as a TPU computes a float32 `jnp.dot` at default precision,
    forward and backward: one bfloat16 pass (both operands rounded to
    bfloat16, 8 significant bits), exact products, float32 sums and a
    float32 result. The backward's two products take the incoming gradient
    rounded alike, as XLA's transposed dots keep the forward's precision."""

    @staticmethod
    def forward(ctx, x, w):
        x16, w16 = x.bfloat16().float(), w.bfloat16().float()
        ctx.save_for_backward(x16, w16)
        return x16 @ w16.T

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        g16 = g.bfloat16().float()
        return g16 @ w16, g16.T @ x16


def tpu_matmul_forward(self, x):
    """MLP.forward with each layer's float32 product at a TPU's default
    precision (`TpuDefaultLinear`)."""
    h = x.float()
    last = len(self.layers) - 1
    for i, lin in enumerate(self.layers):
        h = TpuDefaultLinear.apply(h.reshape(-1, h.shape[-1]), lin.weight).reshape(
            *h.shape[:-1], -1)
        if i != last:
            h = F.relu(h)
    return h


def tpu_matmul_cast_forward(self, x):
    """The first emulation of the TPU's precision, kept to reproduce its
    runs: each layer's input and weight cast to bfloat16 and back inside
    autograd, so the backward rounds each gradient to bfloat16 after its
    float32 product instead of rounding the incoming gradient before it."""
    h = x.float()
    last = len(self.layers) - 1
    for i, lin in enumerate(self.layers):
        h = F.linear(h.bfloat16().float(), lin.weight.bfloat16().float())
        if i != last:
            h = F.relu(h)
    return h


def tpu_rotate(dirs, rot):
    """dirs [N, 3] @ rot[3, 3].T as a TPU computes a float32 product at
    default precision: both operands rounded to bfloat16 (round to nearest
    even), the products exact (8 x 8 significant bits fit float32's 24) and
    summed in float32 in index order. No gradient flows."""
    d16, r16 = dirs.detach().bfloat16().float(), rot.detach().bfloat16().float()
    return d16[:, :1] * r16[:, 0] + d16[:, 1:2] * r16[:, 1] + d16[:, 2:] * r16[:, 2]


def tpu_rays_from_indices(pose, inds, H, W, intrinsics):
    """`dataset/base.py::rays_from_indices` with its rotation at a TPU's
    default precision (`tpu_rotate`)."""
    TPU_ROTATIONS[0] += 1
    i = (inds % W).float()
    j = torch.div(inds, W, rounding_mode="floor").float()
    rays_d = tpu_rotate(base._pixel_dirs(i, j, intrinsics, H, W), pose[:3, :3])
    return pose[:3, 3].expand_as(rays_d), rays_d


def apply_arm(arm):
    """Switch the arm's differences on (process-wide), before the trainer
    is built, so that every captured step records them."""
    from lidarnerf_tpu_torch.ops import block_hash_cuda

    if arm in ("tpu_rays", "tpu_all"):
        # train_step imported the name by value; get_lidar_rays (the
        # trainer's and PanoRenderer's panos) looks it up in base
        base.rays_from_indices = train_step.rays_from_indices = tpu_rays_from_indices
    if arm == "plain_bwd":
        block_hash_cuda.BWD["default"] = block_hash.encode_bwd_plain
    elif arm in ("tpu_matmul", "tpu_all"):
        network.MLP.forward = tpu_matmul_forward
    elif arm == "tpu_matmul_cast":
        network.MLP.forward = tpu_matmul_cast_forward
    elif arm == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True


def make_trainer(arm, seed, workspace, extra):
    """The CLI's training setup (`main_lidarnerf.main`) on the protocol's argv."""
    argv, _ = full_run.train_argv(argparse.Namespace(
        workspace=workspace, iters=30000, eval_interval=50, arm="fast_dil1"))
    argv = argv[len(ab_run.CLI):] + ["--seed", str(seed)] + list(extra)
    if arm == "eager":
        argv += ["--fuse_epoch", "0"]
    opt = cli.get_arg_parser().parse_args(argv)
    opt.enable_lidar = True
    device = cli.device_from_env()
    cli.apply_macros(opt)
    model = cli.build_model(opt)
    train = cli.build_dataset(opt, "train", device)
    cli.attach_dims(opt, train)
    trainer = cli.build_trainer(opt, model, train, device, mute=True)
    valid = cli.build_dataset(opt, "val", device)
    return opt, trainer, train, valid


def sq_dists_tpu(a, b, device):
    """Each point of a [N, 3]'s least squared distance to b [M, 3] (numpy, in
    metres), as the meter takes it (`ops/chamfer.py`: |a|^2 + |b|^2 - 2 a.b,
    clamped at 0) with a.b at a TPU's default float32 matmul precision: both
    operands rounded to bfloat16, float32 products (exact) and sums."""
    a = torch.from_numpy(np.asarray(a, np.float32)).to(device)
    b = torch.from_numpy(np.asarray(b, np.float32)).to(device)
    b_sq, b16, mins = (b * b).sum(-1), b.bfloat16().float(), []
    with _fp32_matmul():
        for ac in a.split(1024):
            cross = ac.bfloat16().float() @ b16.T
            mins.append(((ac * ac).sum(-1, keepdim=True) - 2.0 * cross + b_sq[None]).amin(-1))
    return torch.clamp(torch.cat(mins), min=0.0).cpu().numpy().astype(np.float64)


def meters_tpu(pred, gt, device):
    """(Chamfer, F@0.05) as `chamfer_and_fscore` gives them, at the TPU's precision."""
    d1, d2 = sq_dists_tpu(pred, gt, device), sq_dists_tpu(gt, pred, device)
    return float(d1.mean() + d2.mean()), float(fscore(d1[None], d2[None], 0.05)[0][0])


def watch_panos(trainer, record):
    """Record each rendered pano's ray-drop mask counts and both meters."""
    render = trainer._render_full_frame
    scale = trainer.opt.scale

    def wrapped(dataset, i):
        raydrop, inten, depth = render(dataset, i)
        gt = dataset.images_lidar[i]
        keep, gt_keep = raydrop > 0.5, gt[..., 0] > 0.5
        miss = np.abs(depth - gt[..., 2]) / scale > 1.0
        pred_depth = depth * keep if trainer.opt.alpha_r > 0 and keep.any() else depth
        pred_pts = pano_to_lidar(pred_depth / scale, dataset.intrinsics_lidar)
        gt_pts = pano_to_lidar(gt[..., 2] * gt[..., 0] / scale, dataset.intrinsics_lidar)
        exact = chamfer_and_fscore(pred_pts, gt_pts, threshold=0.05, device=trainer.device)
        record.append({"split": dataset.split, "tag": trainer.c10_tag, "epoch": trainer.epoch,
                       "frame": i, "kept": int(keep.sum()), "gt_kept": int(gt_keep.sum()),
                       "kept_gt_dropped": int((keep & ~gt_keep).sum()),
                       "dropped_gt_kept": int((~keep & gt_keep).sum()),
                       "kept_depth_miss_1m": int((keep & gt_keep & miss).sum()),
                       "meter": list(exact),
                       "meter_tpu": list(meters_tpu(pred_pts, gt_pts, trainer.device))})
        return raydrop, inten, depth

    trainer._render_full_frame = wrapped
    trainer.c10_tag = "train"


def eval_meters(panos):
    """{(split, tag, epoch): the frames' mean (chamfer, F) by each meter}."""
    out = {}
    for p in panos:
        out.setdefault((p["split"], p["tag"], p["epoch"]), []).append(p)
    return [{"split": s, "tag": t, "epoch": e,
             "meter": np.mean([p["meter"] for p in ps], 0).tolist(),
             "meter_tpu": np.mean([p["meter_tpu"] for p in ps], 0).tolist()}
            for (s, t, e), ps in out.items()]


def batch_draws(trainer, dataset, seed):
    """One batch's draws on the trainer's device: frame 0's pixels (patch 1),
    the jitter and the inverse-CDF u."""
    cfg, rcfg = trainer.train_cfg, trainer.render_cfg
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    inds = sample_ray_indices(cfg.H_lidar, cfg.W_lidar, cfg.num_rays_lidar, 1, gen, trainer.device)
    noise, u = train_step.render_draws(rcfg, cfg.num_rays_lidar, gen, trainer.device)
    return {"inds": inds, "noise": noise, "u": u}


def loss_and_grads(model, trainer, dataset, draws, occ_grid, device):
    """(loss, {parameter name: grad}, raydrop head output) of one batch."""
    poses, images = (t.to(device) for t in dataset.device_arrays(trainer.device)[:2])
    loss_fn = train_step.make_loss_fn(model, trainer.train_cfg, trainer.render_cfg, 1)
    d = {k: v.to(device) for k, v in draws.items()}
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(poses[0], images[0].reshape(-1, images.shape[-1]),
                      torch.zeros(1, dtype=torch.long, device=device),
                      torch.tensor(images.shape[1] * images.shape[2], device=device),
                      draws=d, occ_grid=occ_grid)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    cfg = trainer.train_cfg
    with torch.no_grad():
        ro, rd = rays_from_indices(poses[0], d["inds"], cfg.H_lidar, cfg.W_lidar,
                                   cfg.intrinsics_lidar)
        out = render_rays(model, ro, rd, trainer.render_cfg, train=True, noise=d["noise"],
                          u=d["u"], occ_grid=occ_grid)
    return float(loss.detach()), grads, out["image"][..., 0].detach()


def ref_table_grad(x, g, spec, dtype):
    """encode_bwd_plain's sum in `dtype` (float64: the reference)."""
    g = torch.where(block_hash._out_of_range(x), 0.0, g.to(dtype))
    grad = torch.zeros((spec.table_rows, 128), dtype=dtype, device=x.device)
    for li, level in enumerate(spec.levels):
        rows, terms = block_hash._level_terms(x, g, li, level, spec)
        grad.index_add_(0, rows, terms.to(dtype))
    return grad


def adam_update(trainer, g):
    """The next Adam update of the table for gradient g, from the trainer's
    moments and step count (optax's bias-corrected step)."""
    opt = trainer.optimizer
    i = opt.names.index("hash_table")
    b1, b2 = opt.betas
    m = b1 * opt.mu[i].double() + (1 - b1) * g
    v = b2 * opt.nu[i].double() + (1 - b2) * g * g
    t = float(opt.count) + 1
    lr = float(opt.lr_now())
    return lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + opt.eps), lr


def measure_table_grad(trainer, dataset):
    """Suspect (c): B2 against float64 and float32 references on one batch."""
    from lidarnerf_tpu_torch.ops import block_hash_cuda

    calls = []
    tables = (block_hash_cuda.BWD, block_hash.ENCODE_BWD_PLAIN)  # the card's, the CPU's
    origs = [t["default"] for t in tables]

    def recorder(orig):
        def rec(x, g, spec):
            out = orig(x, g, spec)
            calls.append((x.detach().clone(), g.detach().clone(), out.detach().clone()))
            return out
        return rec

    for t, orig in zip(tables, origs):
        t["default"] = recorder(orig)
    try:
        draws = batch_draws(trainer, dataset, 1234)
        loss_and_grads(trainer.model, trainer, dataset, draws, trainer.occ_grid, trainer.device)
    finally:
        for t, orig in zip(tables, origs):
            t["default"] = orig
    spec = trainer.model.block_spec
    b2 = sum(c[2] for c in calls).double()
    ref64 = sum(ref_table_grad(c[0], c[1], spec, torch.float64) for c in calls)
    ref32 = sum(ref_table_grad(c[0], c[1], spec, torch.float32) for c in calls).double()
    res = {"calls": [{"queries": int(c[0].shape[0]),
                      "max_abs_g": float(c[1].abs().max())} for c in calls]}
    nz = ref64 != 0
    peak = float(ref64.abs().max())
    for name, t in (("b2", b2), ("ref32", ref32)):
        flipped = (t != 0) & nz & (torch.sign(t) != torch.sign(ref64))
        res[name] = {
            "zero_where_ref_nonzero": int(((t == 0) & nz).sum()),
            "nonzero_where_ref_zero": int(((t != 0) & ~nz).sum()),
            "sign_differs": int(flipped.sum()),
            "sign_differs_above_1e-12": int((flipped & (ref64.abs() >= 1e-12)).sum()),
        }
    lost = (b2 == 0) & nz
    mag = ref64.abs()
    res["ref_nonzero"] = int(nz.sum())
    res["peak"] = peak
    res["b2_zeroed_by_decade"] = {
        f"1e{e}": int((lost & (mag >= 10.0 ** e) & (mag < 10.0 ** (e + 1))).sum())
        for e in range(-24, 0)}
    res["ref_nonzero_by_decade"] = {
        f"1e{e}": int((nz & (mag >= 10.0 ** e) & (mag < 10.0 ** (e + 1))).sum())
        for e in range(-24, 0)}
    small = nz & (mag < 1e-6 * peak)
    res["below_1e-6_peak"] = int(small.sum())
    for name, t in (("b2", b2), ("ref64", ref64), ("ref32", ref32)):
        upd, lr = adam_update(trainer, t)
        res[f"adam_update_norm_below_1e-6_peak_{name}"] = float(upd[small].norm())
        res[f"adam_update_mean_abs_over_lr_below_1e-6_peak_{name}"] = float(
            upd[small].abs().mean() / lr) if bool(small.any()) else 0.0
    res["lr"] = lr
    return res


def measure_grid(trainer):
    """Suspect (b): the refresh on the card against the CPU port."""
    occ = trainer.render_cfg.occ
    G = occ.grid_size
    gen = torch.Generator(device=trainer.device).manual_seed(7)
    jitter = torch.rand((G, G, G, 3), generator=gen, device=trainer.device)
    dev_grid = occupancy.update_occ_grid(trainer.model, trainer.occ_grid, occ,
                                         trainer.render_cfg.bound, jitter=jitter)
    cpu_model = copy.deepcopy(trainer.model).cpu()
    cpu_grid = occupancy.update_occ_grid(cpu_model, trainer.occ_grid.cpu(), occ,
                                         trainer.render_cfg.bound, jitter=jitter.cpu())
    a, b = dev_grid.cpu(), cpu_grid
    va, vb = occupancy.occupied_volume(a, occ), occupancy.occupied_volume(b, occ)
    return {"max_abs_diff": float((a - b).abs().max()), "max_abs": float(b.abs().max()),
            "occupied_share_card": float(va.mean()), "occupied_share_cpu": float(vb.mean()),
            "occupied_share_trainer_grid": float(
                occupancy.occupied_volume(trainer.occ_grid, occ).float().mean()),
            "cells_flipped": int((va != vb).sum()), "cells": G ** 3}


def measure_card_vs_cpu(trainer, dataset):
    """Suspect (d): loss, gradients and the ray-drop head, card vs CPU port."""
    draws = batch_draws(trainer, dataset, 4321)
    ld, gd, rd = loss_and_grads(trainer.model, trainer, dataset, draws, trainer.occ_grid,
                                trainer.device)
    cpu_model = copy.deepcopy(trainer.model).cpu()
    lc, gc, rc = loss_and_grads(cpu_model, trainer, dataset, draws, trainer.occ_grid.cpu(),
                                torch.device("cpu"))
    groups = {}
    for n, g in gc.items():
        a = gd[n].cpu().double()
        groups[n] = {"rel_l2": float((a - g.double()).norm() / max(g.double().norm(), 1e-30)),
                     "norm_cpu": float(g.norm())}
    rd = rd.cpu()
    return {"loss_card": ld, "loss_cpu": lc, "grads": groups,
            "raydrop_max_abs_diff": float((rd - rc).abs().max()),
            "raydrop_kept_card": int((rd > 0.5).sum()), "raydrop_kept_cpu": int((rc > 0.5).sum())}


def measure_replay_draws(trainer, dataset, epochs=2):
    """Suspect (a) on the card: the captured epoch draws afresh at every
    replay. `epochs` patch-1 epochs are recaptured with recorders on the
    step's pixel and jitter draws; the trainer's state is restored after."""
    model, adam = trainer.model, trainer.optimizer
    held = ({k: v.detach().clone() for k, v in model.state_dict().items()},
            [t.clone() for t in (*adam.mu, *adam.nu, *adam._steps, adam.schedule_count)],
            trainer.generator.get_state(), trainer.occ_grid.clone(),
            (trainer.epoch, trainer.global_step, trainer.ema_num_updates,
             {k: list(v) if isinstance(v, list) else v for k, v in trainer.stats.items()}),
            {k: v.clone() for k, v in (trainer.ema_params or {}).items()},
            trainer._np_rng.get_state())
    K, dev = len(dataset) * epochs, trainer.device
    rec_inds = torch.zeros((K, trainer.train_cfg.num_rays_lidar), dtype=torch.long, device=dev)
    rec_noise = torch.zeros((K, 16), dtype=torch.float32, device=dev)
    pos = torch.zeros(1, dtype=torch.long, device=dev)
    sample_pixels, render_draws = train_step.sample_pixels, train_step.render_draws

    def rec_pixels(*a, **k):
        inds = sample_pixels(*a, **k)
        rec_inds.index_copy_(0, pos, inds[None])
        return inds

    def rec_render(*a, **k):
        noise, u = render_draws(*a, **k)
        rec_noise.index_copy_(0, pos, noise[:1, :16])
        pos.add_(1)
        return noise, u

    train_step.sample_pixels, train_step.render_draws = rec_pixels, rec_render
    trainer._epoch_fns.clear()  # capture anew, with the recorders inside the graph
    try:
        for _ in range(epochs):
            trainer.epoch += 1
            trainer.train_one_epoch(dataset, 1)
    finally:
        train_step.sample_pixels, train_step.render_draws = sample_pixels, render_draws
        trainer._epoch_fns.clear()
        state, moments, gen_state, grid, counters, ema, np_state = held
        with torch.no_grad():
            model.load_state_dict(state)
            for t, v in zip((*adam.mu, *adam.nu, *adam._steps, adam.schedule_count), moments):
                t.copy_(v)
            trainer.occ_grid.copy_(grid)
            for k, v in ema.items():
                trainer.ema_params[k].copy_(v)
        trainer.generator.set_state(gen_state)
        trainer.epoch, trainer.global_step, trainer.ema_num_updates, trainer.stats = counters
        trainer._np_rng.set_state(np_state)
    steps = int(pos.item())
    ri, rn = rec_inds[:steps].cpu().numpy(), rec_noise[:steps].cpu().numpy()
    return {"steps": steps, "distinct_pixel_rows": len({r.tobytes() for r in ri}),
            "distinct_jitter_rows": len({r.tobytes() for r in rn}),
            "inds_range": [int(ri.min()), int(ri.max())],
            "noise_range": [float(rn.min()), float(rn.max())]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", choices=ARMS, default="port")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop_epoch", type=int, default=600)
    ap.add_argument("--out", required=True)
    ap.add_argument("--measure", action="store_true")
    ap.add_argument("--test", action="store_true",
                    help="evaluate the test split with the final weights and the best checkpoint")
    ap.add_argument("extra", nargs="*", help="CLI flags appended to the run's argv (after --)")
    args = ap.parse_args(argv)
    apply_arm(args.arm)
    ws = tempfile.mkdtemp(prefix=f"c10_{args.arm}_")
    opt, trainer, train, valid = make_trainer(args.arm, args.seed, ws, args.extra)
    panos = []
    watch_panos(trainer, panos)
    t0 = time.time()
    trainer.train(train, valid, args.stop_epoch)
    wall = time.time() - t0
    if args.test:
        test = cli.build_dataset(opt, "test", trainer.device)
        trainer.c10_tag = "final"
        trainer.evaluate(test)
        trainer.c10_tag = "best"
        trainer.load_checkpoint(trainer.best_path)
        trainer.evaluate(test)
    evals = [{"epoch": e["epoch"], **{k: np.asarray(v).tolist() for k, v in e["meters"].items()}}
             for e in trainer.run_log if e["event"] == "eval"]
    res = {"arm": args.arm, "seed": args.seed, "stop_epoch": args.stop_epoch, "gpu": gpu_line(),
           "wall_s": wall, "tpu_rotations": TPU_ROTATIONS[0], "epoch_loss": trainer.stats["loss"],
           "skipped": int(sum(trainer.stats["skipped"])), "evals": evals, "panos": panos,
           "meters": eval_meters(panos)}
    if args.measure:
        res["table_grad"] = measure_table_grad(trainer, train)
        res["grid"] = measure_grid(trainer)
        res["card_vs_cpu"] = measure_card_vs_cpu(trainer, train)
        if trainer.device.type == "cuda" and getattr(opt, "fuse_epoch", 1):
            res["replay_draws"] = measure_replay_draws(trainer, train)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    for m in res["meters"]:
        print(f"{args.arm} seed {args.seed} {m['split']} {m['tag']} ep {m['epoch']}: Chamfer, "
              f"F@0.05 {m['meter']}, at the TPU's matmul precision {m['meter_tpu']}", flush=True)
    trainer.close()
    shutil.rmtree(ws, ignore_errors=True)


if __name__ == "__main__":
    main()
