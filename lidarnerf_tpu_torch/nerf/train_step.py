"""Training step: ray sampling -> render -> loss stack -> guarded Adam update
(counterpart of lidarnerf_tpu/nerf/train_step.py:36-371,475-478).

One step draws the frame's training pixels, renders them with the training
randomness (`render_rays(train=True)`), takes the alpha_d/alpha_r/alpha_i
LiDAR losses and the patch-based structural regularisers, backpropagates
(the block-hash table's gradient goes through kernel B2 on CUDA) and applies
Adam unless the loss or a gradient is non-finite. Every random draw of a
step comes from a `torch.Generator` or is injected through `draws`, so a
test can hand the port the JAX package's numbers. The model and optimizer
are updated in place.

`make_epoch_step` of the JAX package, a `lax.scan` over an epoch to save
dispatches, is not ported: its counterpart here would be CUDA-graph capture
of the step.
"""

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices, patch_dims
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays
from lidarnerf_tpu_torch.ops import losses as L
from lidarnerf_tpu_torch.ops.dispatch import resolve_device


@dataclass(frozen=True)
class TrainConfig:
    # loss weights (main_lidarnerf.py:46-52)
    alpha_d: float = 1e3
    alpha_r: float = 1.0
    alpha_i: float = 1.0
    alpha_grad_norm: float = 1.0
    alpha_spatial: float = 0.1
    alpha_tv: float = 1.0
    alpha_grad: float = 1e2
    # loss selection
    depth_loss: str = "l1"
    depth_grad_loss: str = "l1"
    intensity_loss: str = "mse"
    raydrop_loss: str = "mse"
    # structural regularizer switches
    spatial_smooth: bool = False
    grad_norm_smooth: bool = False
    tv_loss: bool = False
    grad_loss: bool = False
    sobel_grad: bool = False
    # geometry / sampling
    scale: float = 1.0
    num_rays_lidar: int = 4096
    H_lidar: int = 66
    W_lidar: int = 1030
    intrinsics_lidar: tuple = (2.0, 26.9)
    # optimisation (main_lidarnerf.py:389-410)
    lr: float = 1e-2
    iters: int = 30000
    # blockhash seam-consistency regularizer, 0 = off (not ported)
    alpha_seam: float = 0.0


_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
_SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], np.float32)


def _conv2d_same(img, kernel):
    """[P, 1, H, W] 3x3 cross-correlation with padding 1 (F.conv2d does not flip)."""
    w = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)[None, None]
    return F.conv2d(img, w, padding=1)


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in full fp32 (not TF32) for the forward and backward within."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def make_optimizer(params, cfg: TrainConfig):
    """Adam(betas=(0.9, 0.99), eps=1e-15) and a per-step LambdaLR of 0.1 ** min(step / iters, 1).

    The k-th update (from 0) uses lr * 0.1 ** min(k / iters, 1), as the JAX
    package's optax schedule does. Returns (optimizer, scheduler).
    """
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.99), eps=1e-15)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.1 ** min(step / cfg.iters, 1.0))
    return opt, sched


def lidar_losses(cfg: TrainConfig, pred_depth, pred_image, gt):
    """Depth/raydrop/intensity loss terms [N] plus masked preds for metrics."""
    crit_d = L.make_criterion(cfg.depth_loss, cfg.scale)
    crit_r = L.make_criterion(cfg.raydrop_loss, cfg.scale)
    crit_i = L.make_criterion(cfg.intensity_loss, cfg.scale)

    gt_raydrop = gt[..., 0]
    gt_intensity = gt[..., 1] * gt_raydrop
    gt_depth = gt[..., 2] * gt_raydrop

    pred_raydrop = pred_image[..., 0]
    pred_intensity = pred_image[..., 1] * gt_raydrop
    pred_depth = pred_depth * gt_raydrop

    lidar_loss = (
        cfg.alpha_d * crit_d(pred_depth, gt_depth)
        + cfg.alpha_r * crit_r(pred_raydrop, gt_raydrop)
        + cfg.alpha_i * crit_i(pred_intensity, gt_intensity)
    )
    return lidar_loss, pred_depth, gt_depth, gt_raydrop


def _patches(v, px, py):
    """[P*px*py] patch-flattened values -> [P, 1, px, py]."""
    return v.reshape(-1, px, py, 1).permute(0, 3, 1, 2)


def patch_regularizers(cfg: TrainConfig, patch_size, pred_depth, gt_depth, gt_raydrop):
    """Structural losses over [N] = P*px*py patch-flattened depths (utils.py:748-876)."""
    px, py = patch_dims(patch_size)
    if px <= 1:
        return 0.0

    d = _patches(pred_depth, px, py) / cfg.scale
    if cfg.sobel_grad:
        pred_gx = _conv2d_same(d, _SOBEL_X)
        pred_gy = _conv2d_same(d, _SOBEL_Y)
    else:
        pred_gy = torch.abs(d[:, :, :-1, :] - d[:, :, 1:, :])
        pred_gx = torch.abs(d[:, :, :, :-1] - d[:, :, :, 1:])
    dy = torch.abs(pred_gy)
    dx = torch.abs(pred_gx)

    loss = 0.0
    if cfg.grad_norm_smooth:
        loss += cfg.alpha_grad_norm * (torch.mean(torch.exp(-dx)) + torch.mean(torch.exp(-dy)))
    if cfg.spatial_smooth:
        loss += cfg.alpha_spatial * (torch.mean(dx**2) + torch.mean(dy**2))
    if cfg.tv_loss:
        loss += cfg.alpha_tv * (torch.mean(dx) + torch.mean(dy))

    if cfg.grad_loss:
        g = _patches(gt_depth, px, py) / cfg.scale
        rd = _patches(gt_raydrop, px, py)
        if cfg.sobel_grad:
            gt_gx = _conv2d_same(g, _SOBEL_X)
        else:
            gt_gx = g[:, :, :, :-1] - g[:, :, :, 1:]  # signed (utils.py:851-852)
        # only the x-gradient is masked and used (utils.py:865-876)
        grad_mask_x = torch.where(torch.abs(gt_gx) < 0.01, 1.0, 0.0)
        mask_dx = rd * grad_mask_x if cfg.sobel_grad else rd[:, :, :, :-1] * grad_mask_x

        crit_g = L.make_criterion(cfg.depth_grad_loss, cfg.scale)
        if cfg.depth_grad_loss == "cos":
            P = pred_gx.shape[0]
            grad_loss = 1.0 - crit_g((pred_gx * mask_dx).reshape(P, -1),
                                     (gt_gx * mask_dx).reshape(P, -1))
        else:
            grad_loss = crit_g(pred_gx * mask_dx, gt_gx * mask_dx)
        loss += cfg.alpha_grad * torch.mean(grad_loss)
    return loss


def sample_pixels(cfg: TrainConfig, patch_size, masked_sampling, sample_without_replacement,
                  valid_idx, valid_count, generator=None, draws=None):
    """A step's [N] flat training pixel indices (train_step.py:234-263).

    Dense datasets draw `sample_ray_indices`; masked ones (NeRF-MVL) draw
    positions in the frame's valid-index pool, with replacement, or without
    it through a gumbel top-k. `draws` may inject `inds` (the result),
    `pool_draws` ([N] pool positions) or `gumbel` ([pool] values).
    """
    draws = draws or {}
    N = cfg.num_rays_lidar
    dev = valid_idx.device
    if "inds" in draws:
        return torch.as_tensor(draws["inds"], device=dev).long()
    if masked_sampling and sample_without_replacement:
        pool = valid_idx.shape[0]
        if pool < N:
            raise ValueError(
                "sample_without_replacement needs a valid-index pool of at "
                f"least num_rays_lidar slots (pool={pool} < N={N})"
            )
        g = draws.get("gumbel")
        if g is None:
            g = -torch.log(torch.empty(pool, device=dev).exponential_(generator=generator))
        g = torch.as_tensor(g, device=dev)
        slots = torch.arange(pool, device=dev)
        g = torch.where(slots < valid_count, g, float("-inf"))
        top = torch.topk(g, N).indices
        # fewer valid pixels than N: the -inf padding slots are remapped to
        # with-replacement draws over the valid prefix
        vc = torch.clamp(valid_count, min=1)
        top = torch.where(top < vc, top, top % vc)
        return valid_idx[top]
    if masked_sampling:
        pos = draws.get("pool_draws")
        if pos is None:
            pos = torch.randint(0, int(valid_count), (N,), generator=generator, device=dev)
        return valid_idx[torch.as_tensor(pos, device=dev).long()]
    return sample_ray_indices(cfg.H_lidar, cfg.W_lidar, N, patch_size, generator, dev)


def make_loss_fn(model, cfg: TrainConfig, render_cfg: RenderConfig, patch_size=1,
                 masked_sampling=False, sample_without_replacement=False):
    """The per-step loss closure.

    loss_fn(pose, image_flat, valid_idx, valid_count, draws=None, generator=None)
    -> (loss, aux): pose [4, 4], image_flat [H*W, 3], valid_idx [P] and
    valid_count [] of the frame; `draws` may inject the pixel draws (see
    `sample_pixels`) and the render's `noise` [N, num_steps] and
    `u` [N, upsample_steps].
    """

    def loss_fn(pose, image_flat, valid_idx, valid_count, draws=None, generator=None):
        draws = draws or {}
        inds = sample_pixels(cfg, patch_size, masked_sampling, sample_without_replacement,
                             valid_idx, valid_count, generator, draws)
        gt = image_flat[inds]  # [N, 3]
        rays_o, rays_d = rays_from_indices(pose, inds, cfg.H_lidar, cfg.W_lidar,
                                           cfg.intrinsics_lidar)
        out = render_rays(model, rays_o, rays_d, render_cfg, train=True, generator=generator,
                          noise=draws.get("noise"), u=draws.get("u"))
        lidar_loss, pred_depth_m, gt_depth, gt_raydrop = lidar_losses(
            cfg, out["depth"], out["image"], gt
        )
        loss = torch.mean(lidar_loss)
        loss = loss + patch_regularizers(cfg, patch_size, pred_depth_m, gt_depth, gt_raydrop)
        aux = {
            "depth_mae": torch.mean(torch.abs(pred_depth_m - gt_depth)).detach(),
            "raydrop_err": torch.mean(torch.abs(out["image"][..., 0] - gt_raydrop)).detach(),
        }
        return loss, aux

    return loss_fn


def guarded_update(optimizer, scheduler, loss) -> bool:
    """Apply the Adam update and advance the schedule unless loss or a gradient is non-finite.

    The counterpart of the reference's AMP GradScaler skip: on a non-finite
    step the parameters, the Adam state and the schedule count all stay as
    they were (the JAX package rolls its schedule count back with the opt
    state). Reads one flag back to the host. Returns whether it updated.
    """
    grads = [p.grad for group in optimizer.param_groups for p in group["params"]
             if p.grad is not None]
    flags = [torch.isfinite(loss).all()] + [torch.isfinite(g).all() for g in grads]
    finite = bool(torch.stack(flags).all())
    if finite:
        optimizer.step()
        scheduler.step()
    return finite


def make_train_step(model, cfg: TrainConfig, render_cfg: RenderConfig, patch_size=1,
                    masked_sampling=False, sample_without_replacement=False,
                    optimizer=None, device=None):
    """Build the train step for one (patch_size, sampling-mode) configuration.

    Args:
        model: NeRFNetwork; moved to `device` and updated in place.
        optimizer: (optimizer, scheduler) from `make_optimizer`, shared by
            the step functions of several patch sizes; made here if None.
        device: None runs on CUDA and raises if there is none; pass "cpu"
            to run the plain PyTorch path on the CPU.

    Returns:
        step(poses, images, valid_idx, valid_counts, frame_idx, draws=None,
        generator=None) -> metrics dict (loss, depth_mae, raydrop_err as
        0-d tensors; skipped_nonfinite as a float). poses [F, 4, 4] and
        images [F, H, W, 3] lie on the device; valid_idx [F, P] and
        valid_counts [F] are the masked-sampling pools (zeros and H*W for
        dense datasets). `step.optimizer` is the (optimizer, scheduler) pair.
    """
    device = resolve_device(device)
    if cfg.alpha_seam > 0.0:
        raise NotImplementedError(
            "the block-hash seam regulariser (alpha_seam > 0) is not ported yet "
            "(ROADMAP.md, queue A item 5: off-main-path options)"
        )
    model.to(device)
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), cfg)
    adam, sched = optimizer
    loss_fn = make_loss_fn(model, cfg, render_cfg, patch_size, masked_sampling,
                           sample_without_replacement)

    def step(poses, images, valid_idx, valid_counts, frame_idx, draws=None, generator=None):
        pose = poses[frame_idx]
        image_flat = images[frame_idx].reshape(-1, images.shape[-1])
        adam.zero_grad(set_to_none=True)
        with _fp32_convolutions():  # the sobel regulariser's forward and backward
            loss, aux = loss_fn(pose, image_flat, valid_idx[frame_idx], valid_counts[frame_idx],
                                draws, generator)
            loss.backward()
        finite = guarded_update(adam, sched, loss)
        return {"loss": loss.detach(), **aux, "skipped_nonfinite": 0.0 if finite else 1.0}

    step.optimizer = optimizer
    return step


@torch.no_grad()
def ema_update(ema_params, params, decay, num_updates):
    """torch_ema semantics, in place: e = d * e + (1 - d) * p with d = min(decay, (1+n)/(10+n)).

    ema_params, params: dicts of tensors with the same keys. Returns ema_params.
    """
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    for k, e in ema_params.items():
        e.mul_(d).add_(params[k], alpha=1.0 - d)
    return ema_params
