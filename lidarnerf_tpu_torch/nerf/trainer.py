"""Training loop (counterpart of the training part of lidarnerf_tpu/nerf/trainer.py).

`Trainer` holds the model, the Adam state and schedule, the EMA shadow and,
under `opt.occ_sampling` (`--fast`), the occupancy grid (trainer.py:98-165);
`train` runs epochs under the per-epoch patch-size schedule (:367-378);
`train_one_epoch` visits every frame once in a seeded order with one
optimisation step each, the per-step path of the JAX trainer's epoch
(:426-562), refreshes the occupancy grid every `occ_update_interval` steps,
updates the EMA once and logs rays/s and samples/s.

Only `workspace=None` runs so far: checkpoints, eval, test, the tensorboard
writer and resume come with ROADMAP.md queue A item 3.
"""

import time

import numpy as np
import torch

from lidarnerf_tpu_torch.models.network import check_seam_flags
from lidarnerf_tpu_torch.models.occupancy import init_occ_grid, occ_config_from_opt, update_occ_grid
from lidarnerf_tpu_torch.models.renderer import RenderConfig
from lidarnerf_tpu_torch.nerf.train_step import (
    TrainConfig,
    ema_update,
    make_optimizer,
    make_train_step,
)
from lidarnerf_tpu_torch.ops.dispatch import resolve_device

_NOT_PORTED = "(ROADMAP.md, queue A item 3: checkpoints, eval, test and resume)"
# the defaults of the JAX trainer's parameters that are not ported yet
# (workspace: None until the workspace is)
_DEFAULTS = dict(metrics=None, depth_metrics=None, eval_interval=1, ckpt_interval=1,
                 max_keep_ckpt=2, workspace=None, best_mode="min", use_checkpoint="latest",
                 use_tensorboardX=True, ckpt_format="pickle")


def _patch_key(p):
    return p if isinstance(p, int) else tuple(p)


class Trainer:
    """Trains a NeRFNetwork in place.

    The parameters are the JAX trainer's, in its order
    (lidarnerf_tpu/nerf/trainer.py:60-78). Those of what is not ported yet
    (metrics, eval, checkpoints, the workspace, tensorboard: ROADMAP.md,
    queue A item 3) raise when given a value other than their default;
    `workspace` defaults to None here until then.

    Args:
        name: run name, used in the log.
        opt: options object with the CLI's field names (main_lidarnerf.py):
            the TrainConfig fields, num_steps, upsample_steps,
            min_near_lidar, min_near, bound, patch_size_lidar,
            change_patch_size_lidar, change_patch_size_epoch, seed; for
            `--fast`, occ_sampling and occ_grid_size, occ_update_interval,
            density_thresh, occ_floor, occ_bins, occ_dilate. The seam
            options `seam_tie` and `seam_sync_hashed` raise when set.
        module: the NeRFNetwork, moved to `device` and trained in place (the
            JAX trainer takes an unbound flax module and makes its
            parameters; a torch module holds its own).
        device: None runs on CUDA and raises if there is none; pass "cpu"
            to run the plain PyTorch path on the CPU.
        mute: no log lines.
        ema_decay: keep an EMA shadow of the parameters, updated per epoch.
    """

    def __init__(self, name, opt, module, device=None, mute=False, metrics=None,
                 depth_metrics=None, ema_decay=None, eval_interval=1, ckpt_interval=1,
                 max_keep_ckpt=2, workspace=None, best_mode="min", use_checkpoint="latest",
                 use_tensorboardX=True, ckpt_format="pickle"):
        given = dict(metrics=metrics or None, depth_metrics=depth_metrics or None,
                     eval_interval=eval_interval, ckpt_interval=ckpt_interval,
                     max_keep_ckpt=max_keep_ckpt, workspace=workspace, best_mode=best_mode,
                     use_checkpoint=use_checkpoint, use_tensorboardX=use_tensorboardX,
                     ckpt_format=ckpt_format)
        unported = [k for k, v in given.items() if v != _DEFAULTS[k]]
        if unported:
            raise NotImplementedError(f"Trainer({', '.join(unported)}=...) is not ported yet "
                                      f"{_NOT_PORTED}")
        check_seam_flags(opt)
        self.device = resolve_device(device)
        self.name = name
        self.opt = opt
        self.mute = mute
        self.ema_decay = ema_decay
        self.train_cfg = TrainConfig(
            alpha_d=opt.alpha_d,
            alpha_r=opt.alpha_r,
            alpha_i=opt.alpha_i,
            alpha_grad_norm=opt.alpha_grad_norm,
            alpha_spatial=opt.alpha_spatial,
            alpha_tv=opt.alpha_tv,
            alpha_grad=opt.alpha_grad,
            depth_loss=opt.depth_loss,
            depth_grad_loss=opt.depth_grad_loss,
            intensity_loss=opt.intensity_loss,
            raydrop_loss=opt.raydrop_loss,
            spatial_smooth=opt.spatial_smooth,
            grad_norm_smooth=opt.grad_norm_smooth,
            tv_loss=opt.tv_loss,
            grad_loss=opt.grad_loss,
            sobel_grad=opt.sobel_grad,
            scale=opt.scale,
            num_rays_lidar=opt.num_rays_lidar,
            H_lidar=getattr(opt, "H_lidar", 66),
            W_lidar=getattr(opt, "W_lidar", 1030),
            intrinsics_lidar=getattr(opt, "intrinsics_lidar", (2.0, 26.9)),
            lr=opt.lr,
            iters=opt.iters,
            alpha_seam=getattr(opt, "alpha_seam", 0.0),
        )
        occ_cfg = occ_config_from_opt(opt)
        self.render_cfg = RenderConfig(
            num_steps=opt.num_steps,
            upsample_steps=opt.upsample_steps,
            min_near_lidar=opt.min_near_lidar,
            min_near=opt.min_near,
            density_scale=1.0,
            bound=opt.bound,
            occ=occ_cfg,
        )
        self.occ_grid = None if occ_cfg is None else init_occ_grid(occ_cfg, self.device)

        seed = getattr(opt, "seed", 0)
        self.model = module.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), self.train_cfg)
        self.ema_params = (
            {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            if ema_decay is not None else None
        )
        self.ema_num_updates = 0
        # the step draws (pixels, jitter, inverse-CDF u) and the occupancy
        # refresh's jitter come from this stream, on the device; the frame
        # order from a numpy stream, as in the JAX trainer
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._np_rng = np.random.RandomState(seed)
        self._step_fns = {}

        self.epoch = 0
        self.global_step = 0
        self.local_step = 0
        self.stats = {"loss": [], "step_loss": [], "skipped": []}

        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"[INFO] Trainer: {self.name} | {self.device}")
        self.log(f"[INFO] #parameters: {n_params}")

    def log(self, *args):
        if not self.mute:
            print(*args, flush=True)

    def _get_step_fn(self, patch_size):
        key = _patch_key(patch_size)
        if key not in self._step_fns:
            self._step_fns[key] = make_train_step(
                self.model, self.train_cfg, self.render_cfg, patch_size=patch_size,
                optimizer=self.optimizer, device=self.device,
            )
        return self._step_fns[key]

    def _device_data(self, dataset):
        """Frames on the device with the dense datasets' dummy valid-pixel pools
        (the masked NeRF-MVL pools come with its dataset: ROADMAP.md queue A
        item 2)."""
        poses, images = dataset.device_arrays(self.device)
        F = poses.shape[0]
        vi = torch.zeros((F, 1), dtype=torch.long, device=self.device)
        vc = torch.full((F,), images.shape[1] * images.shape[2], dtype=torch.long,
                        device=self.device)
        return poses, images, vi, vc

    def train(self, train_dataset, valid_dataset, max_epochs):
        """Epochs self.epoch + 1 .. max_epochs under the patch-size schedule."""
        if valid_dataset is not None:
            raise NotImplementedError(f"evaluation is not ported yet {_NOT_PORTED}")
        change_dataloader = self.opt.change_patch_size_lidar[0] > 1
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            if change_dataloader:
                if self.epoch % self.opt.change_patch_size_epoch == 0:
                    patch = self.opt.change_patch_size_lidar
                else:
                    patch = 1
            else:
                patch = self.opt.patch_size_lidar
            self.train_one_epoch(train_dataset, patch)

    def _refresh_occ_grid(self):
        """Before a step whose global_step is a multiple of the update interval
        (step 0 first), refresh the grid from the live weights (trainer.py:480-491)."""
        occ = self.render_cfg.occ
        if occ is not None and self.global_step % occ.update_interval == 0:
            self.occ_grid = update_occ_grid(self.model, self.occ_grid, occ,
                                            self.render_cfg.bound, generator=self.generator)

    def train_one_epoch(self, dataset, patch_size):
        lr_now = self.train_cfg.lr * 0.1 ** min(self.global_step / self.train_cfg.iters, 1.0)
        self.log(f"==> Start Training Epoch {self.epoch}, lr={lr_now:.6f} ...")
        poses, images, vi, vc = self._device_data(dataset)
        step_fn = self._get_step_fn(patch_size)

        order = self._np_rng.permutation(len(dataset))
        self.local_step = 0
        pending = []
        t0 = time.perf_counter()
        for frame_idx in order:
            self._refresh_occ_grid()
            self.local_step += 1
            self.global_step += 1
            pending.append(step_fn(poses, images, vi, vc, int(frame_idx),
                                   generator=self.generator, occ_grid=self.occ_grid))

        losses = [float(m["loss"]) for m in pending]  # ends on the host
        skips = [m["skipped_nonfinite"] for m in pending]
        if any(skips):
            first = self.global_step - len(skips) + 1
            bad = [first + i for i, s in enumerate(skips) if s]
            self.log(f"[WARN] guarded_update skipped non-finite step(s) at global step(s) "
                     f"{bad} (params/opt state kept)")
        self.stats["step_loss"].extend(losses)
        self.stats["skipped"].extend(skips)

        if self.ema_params is not None:
            ema_update(self.ema_params, self.model.state_dict(), self.ema_decay,
                       self.ema_num_updates)
            self.ema_num_updates += 1

        dt = time.perf_counter() - t0
        average_loss = float(np.sum(losses)) / max(self.local_step, 1)
        self.stats["loss"].append(average_loss)
        rays = self.local_step * self.train_cfg.num_rays_lidar
        samples = rays * (self.render_cfg.num_steps + self.render_cfg.upsample_steps)
        self.log(
            f"==> Finished Epoch {self.epoch}. loss={average_loss:.4f} "
            f"({rays / dt:.0f} rays/s, {samples / dt / 1e6:.2f}M samples/s)"
        )
