"""Training engine (counterpart of lidarnerf_tpu/nerf/trainer.py).

`Trainer` holds the model, the Adam state and schedule, the EMA shadow and,
under `opt.occ_sampling` (`--fast`), the occupancy grid (trainer.py:98-165),
and keeps the JAX trainer's workspace (:183-217): `log_{name}.txt`,
`checkpoints/` (a ring of `max_keep_ckpt` full checkpoints and the best one
by the Chamfer result, which stores the EMA weights as the model),
`validation/`, `results/`, `meshes/`, the tensorboardX run when that package
is installed, and under `opt.profile` a torch.profiler trace of the first
epoch in `profile/`, which carries the program's spans (`utils/tracing.py`:
`train.epoch`, `train.capture`, `train.replay`, `occ.refresh`,
`train.seam_sync`, `train.metrics_fetch`, `train.ema`, the render's stages).

`train` runs epochs under the per-epoch patch-size schedule, with a full
checkpoint every `ckpt_interval` epochs and an evaluation every
`eval_interval` epochs (:341-394); `train_one_epoch` visits every frame once
in a seeded order with one optimisation step each through
`make_epoch_step` (:426-562): on CUDA under `opt.fuse_epoch` (default 1)
each step replays a captured CUDA graph, else, and on the CPU, the same
step body runs eagerly. The occupancy grid is refreshed in place every
`occ_update_interval` steps; the epoch's metrics come back to the host in
one fetch; then the EMA is updated once and rays/s logged.
`evaluate_one_epoch` renders every frame with the EMA weights (swapped into
the model and back; it draws nothing from the training generator) and feeds
the depth meters (:566-706); `test` and `save_mesh` use the raw weights
(:710-823). On NeRF-MVL (`opt.dataloader == "nerf_mvl"`) training draws
its pixels from each frame's unmasked pool (the dataset's `device_arrays`),
evaluation takes the intensity and depth meters on the unmasked rectangle
(the crop), and `test` crops each cloud to the frame's OBB.

Under `opt.seam_sync_hashed` (blockhash) the hashed levels' seam corners are
synced before each step whose global step is a multiple of 16 (:492-509),
through the epoch's `before_step` hook, in place and eagerly between
replays.

Several GPUs (:229-326): with `opt.data_parallel` "auto" (the default) the
trainer trains data-parallel when it runs under `torchrun` with WORLD_SIZE >
1 (True forces it, False keeps one device): one rank per GPU, each on
`cuda:LOCAL_RANK`, the parameters replicated and kept bit-identical, every
step's rays split over the ranks (`parallel/sharding.py`). num_rays_lidar
must divide over the world: the JAX trainer shrinks its device count until
it does, a torch world cannot shrink, so it raises. Only rank 0 writes the
log, checkpoints, evaluation, test and mesh; the other ranks wait at a
barrier after each.

A checkpoint holds numpy leaves only, with `model` and `ema` in the flax
layout (`utils/params.py`), so each package loads the other's: the JAX
trainer's keys (`epoch`, `global_step`, `stats`, `ema_num_updates`,
`np_rng`, `occ_grid`, and `optimizer`: the Adam moments and both counts as
optax's leaves), and the port's generator state under `rng_torch`. A JAX
checkpoint's `rng` (a JAX key) is not carried across; the `optimizer_torch`
entry of older port checkpoints still loads. `ckpt_format="orbax"` writes
the sharded directory store of `utils/checkpoint_io.py`.
"""

import functools
import glob
import os
import time

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar
from lidarnerf_tpu_torch.models.occupancy import init_occ_grid, occ_config_from_opt
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays_staged
from lidarnerf_tpu_torch.nerf.train_step import (
    METRICS,
    GraphPool,
    TrainConfig,
    ema_update,
    make_epoch_step,
    make_optimizer,
)
from lidarnerf_tpu_torch.ops import losses as L
from lidarnerf_tpu_torch.ops.dispatch import resolve_device
from lidarnerf_tpu_torch.parallel import sharding
from lidarnerf_tpu_torch.utils import checkpoint_io, tracing
from lidarnerf_tpu_torch.utils.geometry import filter_bbox_dataset
from lidarnerf_tpu_torch.utils.image_io import COLORMAP_BONE, COLORMAP_HSV, apply_color_map, imwrite
from lidarnerf_tpu_torch.utils.params import (
    optimizer_from_jax,
    optimizer_from_torch_adam,
    optimizer_to_jax,
    params_from_jax,
    params_to_jax,
)


def is_ali_cluster():
    """Cluster sniff for the alternate summary path (as the JAX trainer's)."""
    import socket

    return "auto-drive" in socket.gethostname()


def _rank0(method):
    """Run `method` on rank 0 only; then every rank meets at a barrier."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        try:
            if self.writer_rank:
                return method(self, *args, **kwargs)
        finally:
            self._barrier()

    return run


def _patch_key(p):
    return p if isinstance(p, int) else tuple(p)


class Trainer:
    """Trains, evaluates, tests and checkpoints a NeRFNetwork.

    The parameters are the JAX trainer's, in its order and with its
    defaults (lidarnerf_tpu/nerf/trainer.py:60-78).

    Args:
        name: run name: the log file, the checkpoint and result names.
        opt: options object with the CLI's field names (main_lidarnerf.py):
            the TrainConfig fields, num_steps, upsample_steps,
            min_near_lidar, min_near, bound, max_ray_batch,
            patch_size_lidar, change_patch_size_lidar,
            change_patch_size_epoch, seed, and optionally profile,
            dataloader, cluster_summary_path, seam_sync_hashed (0 = off)
            and data_parallel ("auto", True or False); for `--fast`,
            occ_sampling and the occ_* fields.
        module: the NeRFNetwork, moved to `device` and trained in place (the
            JAX trainer takes an unbound flax module and makes its
            parameters; a torch module holds its own).
        device: None runs on CUDA and raises if there is none; pass "cpu"
            to run the plain PyTorch path on the CPU. Data-parallel, each
            rank runs on its own device (`cuda:LOCAL_RANK`, or the CPU
            under gloo).
        mute: no log lines on stdout (the log file still gets them).
        metrics: RGB meters, kept and not read, as in the JAX trainer.
        depth_metrics: the LiDAR meters, in the CLI's order (MAE and RMSE
            on intensity, then depth, then points: the last one's first
            value decides the best checkpoint).
        ema_decay: keep an EMA shadow of the parameters, updated per epoch.
        workspace: the run directory; None keeps no files (no log file,
            no checkpoints, no validation images).
        use_checkpoint: "scratch", "latest", "latest_model", "best" or a
            checkpoint path; read only with a workspace.
        ckpt_format: "pickle" (both packages read it) or "orbax" (the
            sharded directory store; the JAX package's cannot be read here).
    """

    def __init__(self, name, opt, module, device=None, mute=False, metrics=None,
                 depth_metrics=None, ema_decay=None, eval_interval=1, ckpt_interval=1,
                 max_keep_ckpt=2, workspace="workspace", best_mode="min",
                 use_checkpoint="latest", use_tensorboardX=True, ckpt_format="pickle"):
        checkpoint_io.check_format(ckpt_format)
        self.device = resolve_device(device)
        self.mesh = self._data_mesh(opt)
        if self.mesh is not None:
            self.device = self.mesh.device
        self.writer_rank = self.mesh is None or self.mesh.rank == 0
        mute = mute or not self.writer_rank
        self.name = name
        self.opt = opt
        self.mute = mute
        self.metrics = metrics or []
        self.depth_metrics = depth_metrics or []
        self.ema_decay = ema_decay
        self.eval_interval = eval_interval
        self.ckpt_interval = max(1, ckpt_interval)
        self.max_keep_ckpt = max_keep_ckpt
        self.workspace = workspace
        self.best_mode = best_mode
        self.use_tensorboardX = use_tensorboardX
        self.ckpt_format = ckpt_format
        self.time_stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
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
        if self.mesh is not None:  # every rank starts from rank 0's weights
            sharding.broadcast_state(self.model.parameters())
        self.optimizer = make_optimizer(self.model.named_parameters(), self.train_cfg)
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
        self._epoch_fns = {}
        self._graph_pool = None
        self._data = None  # (dataset, its arrays on the device)
        self.writer = None

        self.epoch = 0
        self.global_step = 0
        self.local_step = 0
        # the JAX trainer's stats, and the port's per-step losses and skips
        self.stats = {"loss": [], "valid_loss": [], "results": [], "checkpoints": [],
                      "best_result": None, "step_loss": [], "skipped": []}
        # one dict per epoch, evaluation, test, mesh export, checkpoint save
        # and load: what it measured and how long it took (not saved)
        self.run_log = []

        self.log_ptr = None
        if self.workspace is not None:
            self.ckpt_path = os.path.join(self.workspace, "checkpoints")
            self.best_path = f"{self.ckpt_path}/{self.name}.ckpt"
        if self.workspace is not None and self.writer_rank:
            os.makedirs(self.workspace, exist_ok=True)
            self.log_path = os.path.join(workspace, f"log_{self.name}.txt")
            self.log_ptr = open(self.log_path, "a+")
            os.makedirs(self.ckpt_path, exist_ok=True)
        self._barrier()

        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"[INFO] Trainer: {self.name} | {self.time_stamp} | {self.device.type} | "
                 f"{self.workspace}")
        self.log(f"[INFO] #parameters: {n_params}")
        if self.mesh is not None:
            self.log(f"[INFO] data-parallel over {self.mesh.n_data} ranks")

        if self.workspace is not None:
            if use_checkpoint == "scratch":
                self.log("[INFO] Training from scratch ...")
            elif use_checkpoint == "latest":
                self.log("[INFO] Loading latest checkpoint ...")
                self.load_checkpoint()
            elif use_checkpoint == "latest_model":
                self.log("[INFO] Loading latest checkpoint (model only)...")
                self.load_checkpoint(model_only=True)
            elif use_checkpoint == "best":
                if os.path.exists(self.best_path):
                    self.log("[INFO] Loading best checkpoint ...")
                    self.load_checkpoint(self.best_path)
                else:
                    self.log(f"[INFO] {self.best_path} not found, loading latest ...")
                    self.load_checkpoint()
            else:
                self.log(f"[INFO] Loading {use_checkpoint} ...")
                self.load_checkpoint(use_checkpoint)

    # ------------------------------------------------------------------ utils

    def log(self, *args):
        if not self.mute:
            print(*args, flush=True)
        if self.log_ptr:
            print(*args, file=self.log_ptr)
            self.log_ptr.flush()

    def close(self):
        """Close the log file and the tensorboard writer."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        if self.log_ptr:
            self.log_ptr.close()
            self.log_ptr = None

    def _data_mesh(self, opt):
        """The `data` mesh of the joined process group, or None on one device
        (`_mesh` :229-255): "auto" shards under torchrun with WORLD_SIZE > 1."""
        dp = getattr(opt, "data_parallel", "auto")
        if dp == "auto":
            dp = sharding.env_world_size() > 1
        if not dp:
            return None
        sharding.init_from_env(self.device.type)
        mesh = sharding.make_mesh()
        if opt.num_rays_lidar % mesh.n_data:
            raise ValueError(
                f"num_rays_lidar={opt.num_rays_lidar} does not divide over the {mesh.n_data} "
                f"ranks of the world (the JAX trainer shrinks its device count until it "
                f"does; a torch world cannot shrink)")
        return mesh

    def _barrier(self):
        """All ranks meet here (one device: nothing)."""
        if self.mesh is not None:
            import torch.distributed as dist

            if self.device.type == "cuda":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def _get_epoch_fn(self, patch_size, masked_sampling):
        """The epoch function of (patch size, sampler); all of them share the
        DeviceAdam and, on CUDA, one graph memory pool."""
        key = (_patch_key(patch_size), masked_sampling)
        if key not in self._epoch_fns:
            capture = bool(getattr(self.opt, "fuse_epoch", 1)) and self.device.type == "cuda"
            if capture and self._graph_pool is None:
                self._graph_pool = GraphPool(self.device)
            self._epoch_fns[key] = make_epoch_step(
                self.model, self.train_cfg, self.render_cfg, patch_size=patch_size,
                masked_sampling=masked_sampling, optimizer=self.optimizer, device=self.device,
                capture=capture, graph_pool=self._graph_pool, mesh=self.mesh,
                seam_sync=getattr(self.opt, "seam_sync_hashed", 0),
            )
        return self._epoch_fns[key]

    def _get_step_fn(self, patch_size, masked_sampling):
        """The one-step function of (patch size, sampler) on the trainer's
        state: the eager body that the epoch function runs or captures."""
        return self._get_epoch_fn(patch_size, masked_sampling).step

    def _device_data(self, dataset):
        """(poses, images, valid_idx, valid_counts, masked) on the device: a
        masked dataset's (NeRF-MVL's) four arrays, or a dense one's two with
        dummy valid-pixel pools. Kept for the last dataset, so that a
        captured step finds the same tensors every epoch."""
        if self._data is None or self._data[0] is not dataset:
            arrs = dataset.device_arrays(self.device)
            if len(arrs) == 4:
                out = (*arrs, True)
            else:
                poses, images = arrs
                F = poses.shape[0]
                vi = torch.zeros((F, 1), dtype=torch.long, device=self.device)
                vc = torch.full((F,), images.shape[1] * images.shape[2], dtype=torch.long,
                                device=self.device)
                out = (poses, images, vi, vc, False)
            self._data = (dataset, out)
        return self._data[1]

    def _is_mvl(self):
        return getattr(self.opt, "dataloader", "kitti360") == "nerf_mvl"

    # ------------------------------------------------------------------ train

    def train(self, train_dataset, valid_dataset, max_epochs):
        """Epochs self.epoch + 1 .. max_epochs under the patch-size schedule.

        With a workspace, a full checkpoint every `ckpt_interval` epochs and
        after the last; an evaluation of `valid_dataset` (skipped when it is
        None) every `eval_interval` epochs, then the best checkpoint.
        """
        writer = None
        if self.use_tensorboardX and self.workspace is not None and self.writer_rank:
            try:
                import tensorboardX

                if is_ali_cluster() and getattr(self.opt, "cluster_summary_path", None):
                    summary_path = self.opt.cluster_summary_path
                else:
                    summary_path = os.path.join(self.workspace, "run", self.name)
                writer = tensorboardX.SummaryWriter(summary_path)
            except ImportError:
                pass
        self.writer = writer

        # --profile: a torch.profiler trace of the first epoch under
        # workspace/profile (the JAX trainer's jax.profiler trace)
        prof = None
        if getattr(self.opt, "profile", None) and self.workspace is not None and self.writer_rank:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()

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

            if prof is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                prof.stop()
                trace_dir = os.path.join(self.workspace, "profile")
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir, f"{self.name}_ep{epoch:04d}.json"))
                prof = None
                self.log(f"[INFO] profiler trace written to {trace_dir}")

            if self.workspace is not None and (
                self.epoch % self.ckpt_interval == 0 or self.epoch == max_epochs
            ):
                self.save_checkpoint(full=True, best=False)

            if valid_dataset is not None and self.epoch % self.eval_interval == 0:
                self.evaluate_one_epoch(valid_dataset)
                if self.workspace is not None:
                    self.save_checkpoint(full=False, best=True)

        if writer is not None:
            writer.close()
            self.writer = None

    def train_one_epoch(self, dataset, patch_size):
        lr_now = self.train_cfg.lr * 0.1 ** min(self.global_step / self.train_cfg.iters, 1.0)
        self.log(f"==> Start Training Epoch {self.epoch}, lr={lr_now:.6f} ...")
        poses, images, vi, vc, masked = self._device_data(dataset)
        epoch_fn = self._get_epoch_fn(patch_size, masked)

        order = self._np_rng.permutation(len(dataset))
        t0 = time.perf_counter()
        # the grid is refreshed before each step whose global step is a
        # multiple of the update interval, step 0 first (trainer.py:480-491)
        ms = epoch_fn(poses, images, vi, vc, order, self.global_step, generator=self.generator,
                      occ_grid=self.occ_grid)
        with tracing.span("train.metrics_fetch"):  # the epoch's one fetch
            fetched = torch.stack([ms[k] for k in METRICS]).cpu().numpy()
        losses = [float(x) for x in fetched[METRICS.index("loss")]]
        skips = [float(x) for x in fetched[METRICS.index("skipped_nonfinite")]]
        self.local_step = len(order)
        self.global_step += len(order)
        first = self.global_step - len(skips) + 1
        if any(skips):
            bad = [first + i for i, s in enumerate(skips) if s]
            self.log(f"[WARN] guarded_update skipped non-finite step(s) at global step(s) "
                     f"{bad} (params/opt state kept)")
        self.stats["step_loss"].extend(losses)
        self.stats["skipped"].extend(skips)
        if self.writer is not None:
            for i, lv in enumerate(losses):
                self.writer.add_scalar("train/loss", lv, first + i)
            self.writer.add_scalar("train/lr", lr_now, self.global_step)

        if self.ema_params is not None:
            ema_update(self.ema_params, self.model.state_dict(), self.ema_decay,
                       self.ema_num_updates)
            self.ema_num_updates += 1

        dt = time.perf_counter() - t0
        self.run_log.append({"event": "epoch", "epoch": self.epoch, "steps": self.local_step,
                             "seconds": dt})
        average_loss = float(np.sum(losses)) / max(self.local_step, 1)
        self.stats["loss"].append(average_loss)
        rays = self.local_step * self.train_cfg.num_rays_lidar
        samples = rays * (self.render_cfg.num_steps + self.render_cfg.upsample_steps)
        self.log(
            f"==> Finished Epoch {self.epoch}. loss={average_loss:.4f} "
            f"({rays / dt:.0f} rays/s, {samples / dt / 1e6:.2f}M samples/s)"
        )

    # ------------------------------------------------------------------- eval

    def evaluate(self, dataset, name=None):
        """evaluate_one_epoch with the tensorboard writer off."""
        use_tb, self.use_tensorboardX = self.use_tensorboardX, False
        self.writer = None
        self.evaluate_one_epoch(dataset, name)
        self.use_tensorboardX = use_tb

    def _render_full_frame(self, dataset, frame_idx):
        """Render all H*W rays of one frame with the model's current weights
        -> numpy (raydrop, intensity, depth), each [H, W]."""
        H, W = dataset.H_lidar, dataset.W_lidar
        pose = torch.as_tensor(dataset.poses_lidar[frame_idx : frame_idx + 1],
                               dtype=torch.float32, device=self.device)
        rays = get_lidar_rays(pose, dataset.intrinsics_lidar, H, W, N=-1)
        out = render_rays_staged(
            self.model, rays["rays_o"][0], rays["rays_d"][0], self.render_cfg,
            chunk=self.opt.max_ray_batch, occ_grid=self.occ_grid,
        )
        # one host copy of the whole pano: (raydrop, intensity, depth)
        pano = torch.cat([out["image"], out["depth"][:, None]], -1).reshape(H, W, 3).cpu().numpy()
        return pano[..., 0], pano[..., 1], pano[..., 2]

    def _criterion_means(self, pred_depth, gt_depth, pred_raydrop, gt_raydrop,
                         pred_int, gt_int):
        cfg = self.train_cfg
        cd = L.make_criterion(cfg.depth_loss, cfg.scale)
        cr = L.make_criterion(cfg.raydrop_loss, cfg.scale)
        ci = L.make_criterion(cfg.intensity_loss, cfg.scale)

        def t(x):  # float32, as the JAX trainer's jnp criteria compute
            return torch.from_numpy(np.asarray(x, dtype=np.float32))

        return float(
            cfg.alpha_d * np.mean(cd(t(pred_depth), t(gt_depth)).numpy())
            + cfg.alpha_r * np.mean(cr(t(pred_raydrop), t(gt_raydrop)).numpy())
            + cfg.alpha_i * np.mean(ci(t(pred_int), t(gt_int)).numpy())
        )

    def _swap_in(self, state):
        """Load `state` into the model in place; return the weights it held."""
        held = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(state)
        return held

    @_rank0
    def evaluate_one_epoch(self, dataset, name=None):
        """Render every frame of `dataset` with the EMA weights (the raw ones
        without an EMA) and feed the depth meters; with a workspace, write
        the validation panos and point clouds.

        On NeRF-MVL the masked pixels (-1) count as dropped in the gt and in
        the prediction, and the intensity meters and the DepthMeter read the
        unmasked rectangle only (the crop); the PointsMeter reads the whole
        masked pano. The meters' measurements and the times are appended to
        `run_log`.
        """
        is_mvl = self._is_mvl()
        self.log(f"++> Evaluate at epoch {self.epoch} ...")
        t_eval0 = time.perf_counter()
        if name is None:
            name = f"{self.name}_ep{self.epoch:04d}"

        for metric in self.depth_metrics:
            metric.clear()

        total_loss = 0.0
        render_s = meters_s = 0.0
        self.local_step = 0
        held = self._swap_in(self.ema_params) if self.ema_params is not None else None
        try:
            for i in range(len(dataset)):
                self.local_step += 1
                gt = dataset.images_lidar[i]  # [H, W, 3]
                gt_raydrop = gt[..., 0].copy()
                if is_mvl:
                    # the unmasked pixels form a rectangle: its size is the crop's
                    valid_crop = gt_raydrop != -1
                    ys, xs = np.nonzero(valid_crop)
                    crop_h = ys.max() - ys.min() + 1
                    crop_w = xs.max() - xs.min() + 1
                    valid_mask = np.where(gt_raydrop == -1, 0.0, 1.0)
                    gt_raydrop = gt_raydrop * valid_mask
                gt_intensity = gt[..., 1] * gt_raydrop
                gt_depth = gt[..., 2] * gt_raydrop

                t0 = time.perf_counter()
                pred_raydrop, pred_intensity, pred_depth = self._render_full_frame(dataset, i)
                t1 = time.perf_counter()
                render_s += t1 - t0
                raydrop_mask = np.where(pred_raydrop > 0.5, 1.0, 0.0)
                if is_mvl:
                    raydrop_mask = raydrop_mask * valid_mask
                if self.opt.alpha_r > 0 and raydrop_mask.any():
                    pred_intensity = pred_intensity * raydrop_mask
                    pred_depth = pred_depth * raydrop_mask

                total_loss += self._criterion_means(
                    pred_depth, gt_depth, pred_raydrop, gt_raydrop,
                    pred_intensity, gt_intensity,
                )
                if is_mvl:
                    pi = pred_intensity[valid_crop].reshape(1, crop_h, crop_w)
                    gi = gt_intensity[valid_crop].reshape(1, crop_h, crop_w)
                    pd_crop = pred_depth[valid_crop].reshape(1, crop_h, crop_w)
                    gd_crop = gt_depth[valid_crop].reshape(1, crop_h, crop_w)
                else:
                    pi, gi = pred_intensity[None], gt_intensity[None]
                pd, gd = pred_depth[None], gt_depth[None]
                for mi, metric in enumerate(self.depth_metrics):
                    if mi < 2:  # MAE, RMSE on intensity
                        metric.update(pi, gi)
                    elif is_mvl and mi == 2:  # DepthMeter on the crop
                        metric.update(pd_crop, gd_crop)
                    else:
                        metric.update(pd, gd)
                meters_s += time.perf_counter() - t1

                if self.workspace is not None:
                    vdir = os.path.join(self.workspace, "validation")
                    os.makedirs(vdir, exist_ok=True)
                    tag = f"{name}_{self.local_step:04d}"
                    rd_img = (np.where(pred_raydrop > 0.5, 1.0, 0.0) * 255).astype(np.uint8)
                    it_img = (pred_intensity * 255).astype(np.uint8)
                    dp_img = (pred_depth * 255).astype(np.uint8)
                    imwrite(os.path.join(vdir, f"{tag}_rarydrop.png"), rd_img)
                    imwrite(os.path.join(vdir, f"{tag}_intensity.png"),
                            apply_color_map(it_img, COLORMAP_BONE))
                    imwrite(os.path.join(vdir, f"{tag}_depth.png"),
                            apply_color_map(dp_img, COLORMAP_HSV))
                    pred_lidar = pano_to_lidar(pred_depth / self.opt.scale,
                                               dataset.intrinsics_lidar)
                    np.save(os.path.join(vdir, f"{tag}_lidar.npy"), pred_lidar)
        finally:
            if held is not None:
                self.model.load_state_dict(held)

        average_loss = total_loss / max(self.local_step, 1)
        self.stats["valid_loss"].append(average_loss)

        if len(self.depth_metrics) > 0:
            result = self.depth_metrics[-1].measure()[0]  # Chamfer
            self.stats["results"].append(result if self.best_mode == "min" else -result)
        else:
            self.stats["results"].append(average_loss)

        measured = {}
        for metric in self.depth_metrics:
            measured[type(metric).__name__] = metric.measure()
            self.log(metric.report())
            if self.use_tensorboardX and self.writer is not None:
                metric.write(self.writer, self.epoch, prefix="LiDAR_evaluate")
            metric.clear()

        self.run_log.append({"event": "eval", "name": name, "epoch": self.epoch,
                             "frames": self.local_step, "meters": measured,
                             "render_s": render_s, "meters_s": meters_s})
        self.log(
            f"++> Evaluate epoch {self.epoch} Finished "
            f"({time.perf_counter() - t_eval0:.1f}s, {self.local_step} frames)."
        )

    # ------------------------------------------------------------------- test

    @_rank0
    def test(self, dataset, save_path=None, name=None, write_video=True):
        """Render every frame with the raw weights; write the point clouds
        (on NeRF-MVL cropped to the frame's OBB), and the panos as PNGs (or
        two mp4s when `write_video` and imageio with its ffmpeg backend are
        installed)."""
        is_mvl = self._is_mvl()
        if save_path is None:
            save_path = os.path.join(self.workspace, "results")
        if name is None:
            name = f"{self.name}_ep{self.epoch:04d}"
        os.makedirs(save_path, exist_ok=True)
        self.log(f"==> Start Test, save results to {save_path}")
        t_test0 = time.perf_counter()
        all_preds, all_preds_depth = [], []

        for i in range(len(dataset)):
            pred_raydrop, pred_intensity, pred_depth = self._render_full_frame(dataset, i)
            raydrop_mask = np.where(pred_raydrop > 0.5, 1.0, 0.0)
            if self.opt.alpha_r > 0:
                pred_intensity = pred_intensity * raydrop_mask
                pred_depth = pred_depth * raydrop_mask

            rd_img = (raydrop_mask * 255).astype(np.uint8)
            it_img = (pred_intensity * 255).astype(np.uint8)

            pred_lidar = pano_to_lidar(pred_depth / self.opt.scale, dataset.intrinsics_lidar)
            if is_mvl:
                pred_lidar = filter_bbox_dataset(pred_lidar, dataset.OBB_local[i][:, :3])
            np.save(os.path.join(save_path, f"test_{name}_{i:04d}_depth_lidar.npy"), pred_lidar)

            dp_img = (pred_depth * 255).astype(np.uint8)
            if write_video:
                all_preds.append(apply_color_map(it_img, COLORMAP_BONE))
                all_preds_depth.append(apply_color_map(dp_img, COLORMAP_HSV))
            else:
                imwrite(os.path.join(save_path, f"test_{name}_{i:04d}_raydrop.png"), rd_img)
                imwrite(os.path.join(save_path, f"test_{name}_{i:04d}_intensity.png"),
                        apply_color_map(it_img, COLORMAP_BONE))
                imwrite(os.path.join(save_path, f"test_{name}_{i:04d}_depth.png"),
                        apply_color_map(dp_img, COLORMAP_HSV))

        if write_video and all_preds:
            try:
                import imageio

                imageio.mimwrite(
                    os.path.join(save_path, f"{name}_lidar_rgb.mp4"),
                    np.stack(all_preds, axis=0), fps=25, quality=8, macro_block_size=1,
                )
                imageio.mimwrite(
                    os.path.join(save_path, f"{name}_depth.mp4"),
                    np.stack(all_preds_depth, axis=0), fps=25, quality=8, macro_block_size=1,
                )
            except (ValueError, ImportError, OSError) as e:
                # no ffmpeg backend available: per-frame PNGs
                self.log(f"[WARN] mp4 export unavailable ({e}); writing PNG frames")
                for i, (im, dp) in enumerate(zip(all_preds, all_preds_depth)):
                    imwrite(os.path.join(save_path, f"test_{name}_{i:04d}_intensity.png"), im)
                    imwrite(os.path.join(save_path, f"test_{name}_{i:04d}_depth.png"), dp)
        seconds = time.perf_counter() - t_test0
        self.run_log.append({"event": "test", "frames": len(dataset), "seconds": seconds})
        self.log("==> Finished Test.")

    # ------------------------------------------------------------------- mesh

    @_rank0
    def save_mesh(self, save_path=None, resolution=256, threshold=10):
        """Export the raw weights' density isosurface at `threshold` as a PLY:
        the density queries run on the device (`NeRFNetwork.density`), the
        marching tetrahedra and the PLY writer on the host."""
        from lidarnerf_tpu_torch.utils.mesh import export_ply, extract_geometry

        if save_path is None:
            save_path = os.path.join(self.workspace, "meshes", f"{self.name}_{self.epoch}.ply")
        self.log(f"==> Saving mesh to {save_path}")
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        query_s = [0.0]

        @torch.no_grad()
        def query_func(pts):
            t0 = time.perf_counter()
            sigma, _ = self.model.density(torch.from_numpy(pts).to(self.device))
            sigma = sigma.cpu().numpy()
            query_s[0] += time.perf_counter() - t0
            return sigma

        bound = self.opt.bound
        t0 = time.perf_counter()
        vertices, triangles = extract_geometry(
            np.full(3, -bound), np.full(3, bound), resolution=resolution,
            threshold=threshold, query_func=query_func,
        )
        t1 = time.perf_counter()
        export_ply(save_path, vertices, triangles)
        t2 = time.perf_counter()
        self.run_log.append({"event": "mesh", "resolution": resolution,
                             "triangles": len(triangles), "query_s": query_s[0],
                             "tetrahedra_s": t1 - t0 - query_s[0], "ply_s": t2 - t1})
        self.log("==> Finished saving mesh.")

    # ------------------------------------------------------------- checkpoint

    def _state_dict(self, full):
        state = {
            "epoch": self.epoch,
            "global_step": self.global_step,
            "stats": self.stats,
            "ema_num_updates": self.ema_num_updates,
            # the frame order's stream (the JAX trainer's) and the step draws'
            # stream, so a resumed run continues the exact sample sequence
            "np_rng": self._np_rng.get_state(),
            "rng_torch": {"device": self.device.type,
                          "state": self.generator.get_state().numpy()},
        }
        state["model"] = params_to_jax(self.model.state_dict())
        if self.ema_params is not None:
            state["ema"] = params_to_jax(self.ema_params)
        if self.occ_grid is not None:
            state["occ_grid"] = self.occ_grid.cpu().numpy()
        if full:
            # optax's leaves, which the JAX trainer unflattens into its state
            state["optimizer"] = optimizer_to_jax(self.optimizer.state_dict())
        return state

    @_rank0
    def save_checkpoint(self, name=None, full=False, best=False, remove_old=True):
        if name is None:
            name = f"{self.name}_ep{self.epoch:04d}"

        if not best:
            file_path = f"{self.ckpt_path}/{name}.ckpt"
            if remove_old:
                self.stats["checkpoints"].append(file_path)
                if len(self.stats["checkpoints"]) > self.max_keep_ckpt:
                    checkpoint_io.remove(self.stats["checkpoints"].pop(0))
            self._atomic_dump(self._state_dict(full), file_path)
        else:
            if len(self.stats["results"]) > 0:
                if (
                    self.stats["best_result"] is None
                    or self.stats["results"][-1] < self.stats["best_result"]
                ):
                    self.log(
                        f"[INFO] New best result: {self.stats['best_result']} --> "
                        f"{self.stats['results'][-1]}"
                    )
                    self.stats["best_result"] = self.stats["results"][-1]
                    state = self._state_dict(full)
                    # the best checkpoint stores the EMA weights as the model
                    if self.ema_params is not None:
                        state["model"] = params_to_jax(self.ema_params)
                    self._atomic_dump(state, self.best_path)
            else:
                self.log("[WARN] no evaluated results found, skip saving best checkpoint.")

    def _atomic_dump(self, state, path):
        t0 = time.perf_counter()
        checkpoint_io.dump_state(state, path, self.ckpt_format)
        self.run_log.append({"event": "save", "path": path,
                             "bytes": checkpoint_io.size_bytes(path),
                             "seconds": time.perf_counter() - t0})

    def _load_weights(self, tree):
        self.model.load_state_dict(params_from_jax(tree))

    def load_checkpoint(self, checkpoint=None, model_only=False):
        if checkpoint is None:
            ckpts = sorted(glob.glob(f"{self.ckpt_path}/{self.name}_ep*.ckpt"))
            # walk back over unreadable checkpoints (e.g. files truncated by
            # a kill before the atomic write)
            while ckpts:
                checkpoint = ckpts.pop()
                if checkpoint_io.probe(checkpoint):
                    break
                self.log(f"[WARN] corrupt checkpoint {checkpoint}, skipping.")
                checkpoint = None
            if checkpoint:
                self.log(f"[INFO] Latest checkpoint is {checkpoint}")
            else:
                self.log("[WARN] No checkpoint found, model randomly initialized.")
                return

        t0 = time.perf_counter()
        ckpt = checkpoint_io.load_state(checkpoint)

        if "model" not in ckpt:
            self._load_weights(ckpt)
            self.log("[INFO] loaded model.")
            return

        self._load_weights(ckpt["model"])
        self.log("[INFO] loaded model.")
        if self.ema_params is not None and "ema" in ckpt:
            for k, v in params_from_jax(ckpt["ema"]).items():
                self.ema_params[k].copy_(v)
        # a load replaces state that captured steps point to: the next epoch
        # captures its graphs anew
        self._epoch_fns.clear()
        if self.occ_grid is not None and "occ_grid" in ckpt:
            self.occ_grid = torch.as_tensor(ckpt["occ_grid"], dtype=torch.float32,
                                            device=self.device)
        if model_only:
            return

        self.stats = {**{"step_loss": [], "skipped": []}, **ckpt["stats"]}
        self.epoch = ckpt["epoch"]
        self.global_step = ckpt["global_step"]
        self.ema_num_updates = ckpt.get("ema_num_updates", 0)
        if "np_rng" in ckpt:
            self._np_rng.set_state(ckpt["np_rng"])
        rng = ckpt.get("rng_torch")
        if rng is not None and rng["device"] == self.device.type:
            self.generator.set_state(torch.from_numpy(np.array(rng["state"])))
        else:
            self.log(f"[WARN] the checkpoint holds no {self.device.type} generator state; "
                     "the step draws restart from the seed.")
        self.log(f"[INFO] load at epoch {self.epoch}, global step {self.global_step}")

        if "optimizer" in ckpt or "optimizer_torch" in ckpt:
            try:
                if "optimizer" in ckpt:
                    self.optimizer.load_state_dict(optimizer_from_jax(ckpt["optimizer"]))
                else:  # the port's layout before the optax one (torch.optim.Adam, LambdaLR)
                    self.optimizer.load_state_dict(optimizer_from_torch_adam(
                        ckpt["optimizer_torch"], self.optimizer.names))
                self.log(f"[INFO] loaded optimizer (Adam step {int(self.optimizer.count)}, "
                         f"schedule count {int(self.optimizer.schedule_count)}).")
            except (KeyError, ValueError, IndexError, RuntimeError) as e:
                self.log(f"[WARN] Failed to load optimizer ({e}); Adam and its schedule "
                         "start afresh.")
                self.optimizer.load_state_dict({"count": 0, "schedule_count": 0, "mu": {},
                                                "nu": {}})
        else:
            self.log("[WARN] the checkpoint holds no optimizer state: Adam and its schedule "
                     "start afresh.")
        self.run_log.append({"event": "load", "path": checkpoint,
                             "seconds": time.perf_counter() - t0})
