"""Training step and fused epoch: ray sampling -> render -> loss stack ->
guarded Adam update (counterpart of lidarnerf_tpu/nerf/train_step.py).

One step draws the frame's training pixels, renders them with the training
randomness (`render_rays(train=True)`), takes the alpha_d/alpha_r/alpha_i
LiDAR losses and the patch-based structural regularisers, backpropagates
(the block-hash table's gradient goes through kernel B2 on CUDA) and applies
optax's Adam unless the loss or a gradient is non-finite. The Adam state,
its step count, the schedule count and the update guard live on the device
(`DeviceAdam`), so a step reads nothing back to the host. Every random draw
of a step comes from a `torch.Generator` or is injected through `draws`, so
a test can hand the port the JAX package's numbers. The model and optimizer
are updated in place.

`make_train_step` takes one step. `make_epoch_step`, the counterpart of the
JAX package's `lax.scan` epoch, takes K steps over a frame order, with the
occupancy refreshes that fall inside them, and returns the K metrics on the
device. Both run one step body. On CUDA the epoch captures that body as a
CUDA graph at its first step and replays it for every later step; the CPU,
and CUDA with `capture=False`, run it eagerly.
"""

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices, patch_dims
from lidarnerf_tpu_torch.models.occupancy import update_occ_grid
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays
from lidarnerf_tpu_torch.ops import losses as L
from lidarnerf_tpu_torch.ops.block_hash import block_hash_seam_loss, kernel_variant, sync_hashed_seams
from lidarnerf_tpu_torch.ops.dispatch import resolve_device
from lidarnerf_tpu_torch.parallel import sharding
from lidarnerf_tpu_torch.utils import tracing


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
    # blockhash seam-consistency regularizer (ops/block_hash.py
    # block_hash_seam_loss), 0 = off
    alpha_seam: float = 0.0


_SOBEL = {"x": np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32),
          "y": np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], np.float32)}
_sobel_cache = {}  # (axis, device, dtype) -> [1, 1, 3, 3] weights, uploaded once


def _conv2d_same(img, axis):
    """[P, 1, H, W] 3x3 Sobel cross-correlation along `axis` ("x" or "y"),
    padding 1 (F.conv2d does not flip). The weights are uploaded at the first
    call on a device, never inside a captured step."""
    key = (axis, img.device, img.dtype)
    if key not in _sobel_cache:
        _sobel_cache[key] = torch.as_tensor(_SOBEL[axis], dtype=img.dtype,
                                            device=img.device)[None, None]
    return F.conv2d(img, _sobel_cache[key], padding=1)


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in full fp32 (not TF32) for the forward and backward within."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


INT32_MAX = 2**31 - 1


class DeviceAdam:
    """optax.adam(lr * 0.1 ** min(count / iters, 1), b1=0.9, b2=0.99, eps=1e-15)
    with its whole state and its update guard on the device.

    The state is optax's: the moments `mu` and `nu` (one per parameter),
    `count` (ScaleByAdamState's, the bias correction's step) and
    `schedule_count` (ScaleByScheduleState's); the k-th update (from 0)
    uses lr(k) (main_lidarnerf.py:389-410 with a per-step schedule). The
    update is PyTorch's fused Adam kernel (`torch.optim.Adam(fused=True)`:
    optax's bias-corrected step, rounded in another order), given the lr as
    a device tensor and the guard's flag as its `found_inf`: when the loss
    or a gradient is non-finite, the kernel leaves the parameters and both
    moments as they were, Adam undoes its step count, and the schedule count
    stays (lidarnerf_tpu/nerf/train_step.py:290-313). Nothing is read back
    to the host. A parameter without a gradient takes a zero one, as optax
    updates every leaf.

    Args:
        params: parameters, or (name, parameter) pairs (`named_parameters()`);
            the names key `state_dict`.
        cfg: the TrainConfig (lr, iters).
    """

    betas, eps = (0.9, 0.99), 1e-15

    def __init__(self, params, cfg):
        pairs = [p if isinstance(p, tuple) else (str(i), p) for i, p in enumerate(params)]
        self.names = [n for n, _ in pairs]
        self.params = [p for _, p in pairs]
        self.lr, self.iters = cfg.lr, cfg.iters
        dev = self.params[0].device
        self._lr = torch.full((), cfg.lr, dtype=torch.float32, device=dev)
        self.found_inf = torch.zeros((), dtype=torch.float32, device=dev)
        self._one = torch.ones((), dtype=torch.float32, device=dev)
        self._zero_grads = [torch.zeros_like(p) for p in self.params]
        self.schedule_count = torch.zeros((), dtype=torch.int32, device=dev)
        self._adam = torch.optim.Adam(self.params, lr=self._lr, betas=self.betas, eps=self.eps,
                                      fused=True, capturable=dev.type == "cuda")
        self._adam.found_inf = self.found_inf
        for p in self.params:  # the state exists from the start: loads and captures see it
            self._adam.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=dev),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        state = [self._adam.state[p] for p in self.params]
        self.mu = [s["exp_avg"] for s in state]
        self.nu = [s["exp_avg_sq"] for s in state]
        self._steps = [s["step"] for s in state]

    @property
    def count(self):
        """Adam's step count, a 0-d tensor on the device (every parameter's)."""
        return self._steps[0]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def lr_now(self):
        """The lr of the next update, a 0-d float32 tensor on the device."""
        frac = torch.clamp(self.schedule_count.float() / self.iters, max=1.0)
        return self.lr * torch.pow(0.1, frac)

    @torch.no_grad()
    def step(self, loss):
        """Update from the parameters' `.grad` unless `loss` or a gradient is
        non-finite. Returns that flag, a 0-d bool tensor on the device."""
        missing = [p for p in self.params if p.grad is None]
        for p, z in zip(self.params, self._zero_grads):
            if p.grad is None:
                p.grad = z
        # the guard: one pass over the gradients (scaled by 1, unchanged)
        self.found_inf.copy_((~torch.isfinite(loss)).float())
        torch._amp_foreach_non_finite_check_and_unscale_(
            [p.grad for p in self.params], self.found_inf, self._one)
        finite = self.found_inf == 0
        self._lr.copy_(self.lr_now())
        self._adam.step()
        for p in missing:  # as the backward left them
            p.grad = None
        self.schedule_count.copy_(torch.where(
            finite & (self.schedule_count < INT32_MAX), self.schedule_count + 1,
            self.schedule_count))
        return finite

    def state_dict(self):
        """{"count", "schedule_count": ints, "mu", "nu": {name: CPU tensor}}."""
        return {"count": int(self.count), "schedule_count": int(self.schedule_count),
                "mu": {n: m.detach().cpu() for n, m in zip(self.names, self.mu)},
                "nu": {n: v.detach().cpu() for n, v in zip(self.names, self.nu)}}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy `state_dict()`'s layout into the state tensors (a name missing
        from mu/nu loads zeros)."""
        for t in self._steps:
            t.fill_(int(state["count"]))
        self.schedule_count.fill_(int(state["schedule_count"]))
        for n, mu, nu in zip(self.names, self.mu, self.nu):
            for dst, src in ((mu, state["mu"]), (nu, state["nu"])):
                if n in src:
                    dst.copy_(torch.as_tensor(src[n]).reshape(dst.shape))
                else:
                    dst.zero_()


def make_optimizer(params, cfg: TrainConfig):
    """The DeviceAdam of `params` (parameters or `named_parameters()` pairs)."""
    return DeviceAdam(params, cfg)


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
        pred_gx = _conv2d_same(d, "x")
        pred_gy = _conv2d_same(d, "y")
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
            gt_gx = _conv2d_same(g, "x")
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


def pool_draws(valid_count, n, generator=None):
    """[n] positions uniform over [0, valid_count), drawn on valid_count's device.

    valid_count is a 0-d integer tensor that stays on its device: each
    position is a 62-bit draw reduced modulo the count (a bias below
    count / 2^62), so no bound is read back to the host.
    """
    raw = torch.randint(0, 2**62, (n,), generator=generator, device=valid_count.device)
    return raw % torch.clamp(valid_count, min=1)


def sample_pixels(cfg: TrainConfig, patch_size, masked_sampling, sample_without_replacement,
                  valid_idx, valid_count, generator=None, draws=None):
    """A step's [N] flat training pixel indices (train_step.py:234-263).

    Dense datasets draw `sample_ray_indices`; masked ones (NeRF-MVL) draw
    positions in the frame's valid-index pool, with replacement
    (`pool_draws`), or without it through a gumbel top-k; neither reads the
    device. `draws` may inject `inds` (the result),
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
            pos = pool_draws(valid_count, N, generator)
        return valid_idx[torch.as_tensor(pos, device=dev).long()]
    return sample_ray_indices(cfg.H_lidar, cfg.W_lidar, N, patch_size, generator, dev)


def render_draws(render_cfg: RenderConfig, n, generator, device, noise=None, u=None):
    """The training render's draws of n rays that are not given, in
    `render_rays`' order: the jitter `noise` [n, num_steps], then the
    inverse-CDF `u` [n, upsample_steps] (None without upsampling)."""
    if noise is None:
        noise = torch.rand((n, render_cfg.num_steps), generator=generator, dtype=torch.float32,
                           device=device)
    if u is None and render_cfg.upsample_steps > 0:
        u = torch.rand((n, render_cfg.upsample_steps), generator=generator,
                       dtype=torch.float32, device=device)
    return noise, u


SEAM_SAMPLES = 512  # seam corners sampled per (level, axis) by the loss (block_hash.py:430)


def make_loss_fn(model, cfg: TrainConfig, render_cfg: RenderConfig, patch_size=1,
                 masked_sampling=False, sample_without_replacement=False, mesh=None):
    """The per-step loss closure, one body for one device and a mesh
    (train_step.py:162-283, whose `constrain` hook the mesh replaces).

    loss_fn(pose, image_flat, valid_idx, valid_count, draws=None, generator=None,
    occ_grid=None) -> (loss, aux): pose [4, 4], image_flat [H*W, 3], valid_idx
    [P] and valid_count [] of the frame; `draws` may inject the pixel draws
    (see `sample_pixels`), the render's `noise` [N, num_steps] and `u`
    [N, upsample_steps], and under `alpha_seam` the seam loss's samples
    `seam` (`block_hash.seam_draws`); `occ_grid` goes to the render
    (`--fast`). The draws are the global batch's, in the JAX step's order
    (pixels, render, seam); on a mesh each rank keeps its N / n_data rays
    (`sharding.local_rays`) and scales its loss and metrics by 1 / n_data,
    so that their sums over `data` are the global batch's.
    """
    N = cfg.num_rays_lidar
    rays = sharding.local_rays(mesh, N)
    n_data = 1 if mesh is None else mesh.n_data
    px, py = patch_dims(patch_size)
    if (rays.stop - rays.start) % (px * py):
        raise ValueError(f"{N} rays over {n_data} data ranks split a {px} x {py} patch")
    seam = cfg.alpha_seam > 0.0 and getattr(model, "encoding", None) == "blockhash"

    def loss_fn(pose, image_flat, valid_idx, valid_count, draws=None, generator=None,
                occ_grid=None):
        draws = draws or {}
        dev = image_flat.device
        inds = sample_pixels(cfg, patch_size, masked_sampling, sample_without_replacement,
                             valid_idx, valid_count, generator, draws)
        noise, u = render_draws(render_cfg, N, generator, dev, draws.get("noise"),
                                draws.get("u"))
        noise = torch.as_tensor(noise, device=dev)[rays]
        u = None if u is None else torch.as_tensor(u, device=dev)[rays]
        inds = inds[rays]
        gt = image_flat[inds]  # [n, 3]
        rays_o, rays_d = rays_from_indices(pose, inds, cfg.H_lidar, cfg.W_lidar,
                                           cfg.intrinsics_lidar)
        out = render_rays(model, rays_o, rays_d, render_cfg, train=True, generator=generator,
                          noise=noise, u=u, occ_grid=occ_grid)
        lidar_loss, pred_depth_m, gt_depth, gt_raydrop = lidar_losses(
            cfg, out["depth"], out["image"], gt
        )
        loss = torch.mean(lidar_loss)
        loss = loss + patch_regularizers(cfg, patch_size, pred_depth_m, gt_depth, gt_raydrop)
        if seam:
            table = sharding.gather_table(model.hash_table, getattr(model, "table_mesh", None))
            loss = loss + cfg.alpha_seam * block_hash_seam_loss(
                table, model.block_spec, generator, SEAM_SAMPLES, draws.get("seam"))
        aux = {
            "depth_mae": torch.mean(torch.abs(pred_depth_m - gt_depth)).detach(),
            "raydrop_err": torch.mean(torch.abs(out["image"][..., 0] - gt_raydrop)).detach(),
        }
        if n_data > 1:
            loss = loss / n_data
            aux = {k: v / n_data for k, v in aux.items()}
        return loss, aux

    return loss_fn


METRICS = ("loss", "depth_mae", "raydrop_err", "skipped_nonfinite")


def make_train_step(model, cfg: TrainConfig, render_cfg: RenderConfig, patch_size=1,
                    masked_sampling=False, sample_without_replacement=False,
                    optimizer=None, device=None, mesh=None):
    """Build the train step for one (patch_size, sampling-mode) configuration.

    Args:
        model: NeRFNetwork; moved to `device` and updated in place.
        optimizer: the `DeviceAdam` of `make_optimizer`, shared by the step
            functions of several patch sizes; made here if None.
        device: None runs on CUDA and raises if there is none; pass "cpu"
            to run the plain PyTorch path on the CPU.
        mesh: a `parallel.sharding.Mesh` to train data-parallel on (each
            rank its N / n_data rays; the gradients, loss and metrics summed
            over `data` in one all-reduce before the guard), or None.

    Returns:
        step(poses, images, valid_idx, valid_counts, frame_idx, draws=None,
        generator=None, occ_grid=None) -> {"loss", "depth_mae",
        "raydrop_err", "skipped_nonfinite"}, 0-d float32 tensors on the
        device. poses [F, 4, 4] and images [F, H, W, 3] lie on the device;
        valid_idx [F, P] and valid_counts [F] are the masked-sampling pools
        (zeros and H*W for dense datasets); frame_idx is an int or a [1]
        int64 device tensor (read on the device); occ_grid is the `--fast`
        occupancy grid. The step reads nothing back to the host.
        `step.optimizer` is the DeviceAdam.
    """
    device = resolve_device(device)
    model.to(device)
    adam = make_optimizer(model.named_parameters(), cfg) if optimizer is None else optimizer
    loss_fn = make_loss_fn(model, cfg, render_cfg, patch_size, masked_sampling,
                           sample_without_replacement, mesh)
    group = None if mesh is None else mesh.data_group

    def step(poses, images, valid_idx, valid_counts, frame_idx, draws=None, generator=None,
             occ_grid=None):
        if torch.is_tensor(frame_idx):
            def pick(t):
                return t.index_select(0, frame_idx)[0]
        else:
            def pick(t):
                return t[frame_idx]
        image_flat = pick(images).reshape(-1, images.shape[-1])
        adam.zero_grad()
        with _fp32_convolutions():  # the sobel regulariser's forward and backward
            loss, aux = loss_fn(pick(poses), image_flat, pick(valid_idx), pick(valid_counts),
                                draws, generator, occ_grid)
            loss.backward()
        loss = loss.detach()
        if mesh is not None:
            loss, aux = _all_reduce_step(adam.params, loss, aux, group)
        finite = adam.step(loss)
        return {"loss": loss, **aux, "skipped_nonfinite": 1.0 - finite.float()}

    step.optimizer = adam
    return step


def _all_reduce_step(params, loss, aux, group):
    """Sum the gradients, the loss and the metrics over `group` in one
    all-reduce of a flat buffer; the gradients are written back in place.
    Returns the summed (loss, aux)."""
    grads = [p.grad for p in params if p.grad is not None]
    stats = torch.stack([loss, *aux.values()]).float()
    flat = torch.cat([g.reshape(-1) for g in grads] + [stats])
    sharding.all_reduce_sum(flat, group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    out = flat[off:]
    return out[0], dict(zip(aux, out[1:]))


class GraphPool:
    """The memory pool and side stream that all graphs of one trainer share.
    Their replays never overlap: the epochs run one after another."""

    def __init__(self, device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)


class _CapturedStep:
    """One step of `make_train_step` captured as a CUDA graph and replayed.

    Static buffers hold the epoch's frame order (uploaded once an epoch), a
    device step counter that picks each step's frame, and the metrics [4, K]
    that each replay writes at its step. The graph also holds pointers to
    poses, images, the pools, the occupancy grid, the model's parameters and
    the DeviceAdam state, so these are updated in place; other input
    tensors, another generator or another K capture anew.

    The first step of the first epoch is the warm-up: it runs eagerly on the
    side stream (building the kernels' libraries and every lazy state), and
    is a real training step. Capture follows (`torch.cuda.graph` empties the
    allocator's cache first, so the warm-up's blocks, cached for the side
    stream, go back to the card), then one replay per step. A later graph's
    warm-up runs while the pool holds the earlier graphs' memory.

    Launch counts: the CUDA wrappers count where Python calls them, so at
    the warm-up and at the capture (which records the launch into the
    graph); a replay runs no Python and counts nothing. Its launches are
    seen on the device, in a profile of the replayed steps.
    """

    def __init__(self, step, pool):
        self.step, self.pool = step, pool
        self.graph, self.key = None, None

    def _one_step(self, poses, images, valid_idx, valid_counts, generator, occ_grid):
        fi = self.order.index_select(0, self.pos)
        m = self.step(poses, images, valid_idx, valid_counts, fi, generator=generator,
                      occ_grid=occ_grid)
        self.metrics.index_copy_(1, self.pos, torch.stack([m[k] for k in METRICS])[:, None])
        self.pos.add_(1)

    def _capture(self, args):
        with tracing.span("train.capture"):
            side, cur = self.pool.stream, torch.cuda.current_stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):  # the warm-up: a real step
                self._one_step(*args)
            cur.wait_stream(side)
            generator = args[4]
            graph = torch.cuda.CUDAGraph()
            if generator is not None:  # each replay draws afresh from it
                graph.register_generator_state(generator)
            with torch.cuda.graph(graph, pool=self.pool.handle, stream=side):
                self._one_step(*args)
        self.graph = graph

    def epoch(self, poses, images, valid_idx, valid_counts, order, generator, occ_grid,
              before_step):
        """K = len(order) steps; before_step(i) runs eagerly before step i.
        Returns the metrics [4, K] on the device."""
        K, dev = len(order), poses.device
        with tracing.span("train.epoch"):
            key = (K, generator) + tuple(
                None if t is None else (t.data_ptr(), tuple(t.shape))
                for t in (poses, images, valid_idx, valid_counts, occ_grid))
            if key != self.key:
                self.graph, self.key = None, key
                self.order = torch.zeros(K, dtype=torch.long, device=dev)
                self.pos = torch.zeros(1, dtype=torch.long, device=dev)
                self.metrics = torch.zeros((len(METRICS), K), dtype=torch.float32, device=dev)
            self.order.copy_(torch.as_tensor(np.asarray(order), dtype=torch.long))
            self.pos.zero_()
            args = (poses, images, valid_idx, valid_counts, generator, occ_grid)
            first = 0
            if self.graph is None:
                before_step(0)
                self._capture(args)
                first = 1
            for i in range(first, K):
                before_step(i)
                with tracing.span("train.replay"):
                    self.graph.replay()
            return self.metrics.clone()


def make_epoch_step(model, cfg: TrainConfig, render_cfg: RenderConfig, patch_size=1,
                    masked_sampling=False, sample_without_replacement=False,
                    optimizer=None, device=None, capture=True, graph_pool=None, mesh=None,
                    seam_sync=0):
    """Build the fused epoch for one (patch_size, sampling-mode) configuration
    (lidarnerf_tpu/nerf/train_step.py:374-470).

    Args:
        model, optimizer, device, mesh: as `make_train_step`.
        capture: on CUDA, capture the step as a CUDA graph (the CLI's
            `--fuse_epoch 1`); False, and always on the CPU, runs it eagerly.
            A capture or replay that fails raises.
        graph_pool: the `GraphPool` the graphs share (one per trainer); made
            here if None.
        seam_sync: `--seam_sync_hashed`: under blockhash, before each step
            whose global step is a multiple of SEAM_SYNC_EVERY, the hashed
            levels' seam corners of `seam_sync` samples per (level, axis)
            are synced in place, eagerly (`sync_model_seams`;
            lidarnerf_tpu/nerf/trainer.py:492-509), after the grid refresh.
            The JAX trainer runs its per-step path then; here the graph
            stays, as for the grid refresh, with the same results.

    Returns:
        epoch_fn(poses, images, valid_idx, valid_counts, order, step0=0,
        generator=None, occ_grid=None, draws=None) -> {"loss", "depth_mae",
        "raydrop_err", "skipped_nonfinite"}, each [K] float32 on the device.
        An epoch is K = len(order) steps on the frames `order` (numpy ints),
        the first at global step `step0`. Under `--fast` (render_cfg.occ)
        the grid is refreshed in place, eagerly, before each step whose
        global step is a multiple of the update interval. `draws` (eager
        only) is a list of K per-step draws as `make_train_step` takes them;
        an "occ_jitter" entry [G, G, G, 3] is that step's refresh jitter, a
        "seam_sync" entry its sync's samples (`block_hash.seam_draws`).
        A blockhash model keeps one graph per block-hash variant
        (`kernel_variant()`, which a graph freezes); any other encoding
        reads no variant and keeps one graph, whatever the switch says.
        `epoch_fn.step` is the step function.
    """
    device = resolve_device(device)
    step = make_train_step(model, cfg, render_cfg, patch_size, masked_sampling,
                           sample_without_replacement, optimizer, device, mesh)
    seam_sync = seam_sync if getattr(model, "encoding", None) == "blockhash" else 0
    capture = capture and device.type == "cuda"
    if capture and graph_pool is None:
        graph_pool = GraphPool(device)
    occ = render_cfg.occ
    graphs = {}  # kernel variant -> _CapturedStep

    def before_step(global_step, occ_grid, generator, d=None):
        d = d or {}
        if occ is not None and occ_grid is not None and global_step % occ.update_interval == 0:
            with tracing.span("occ.refresh"):
                occ_grid.copy_(update_occ_grid(model, occ_grid, occ, render_cfg.bound,
                                               generator=generator, jitter=d.get("occ_jitter")))
        if seam_sync > 0 and global_step % SEAM_SYNC_EVERY == 0:
            with tracing.span("train.seam_sync"):
                sync_model_seams(model, seam_sync, generator, d.get("seam_sync"))

    def epoch_fn(poses, images, valid_idx, valid_counts, order, step0=0, generator=None,
                 occ_grid=None, draws=None):
        if capture:
            if draws is not None:
                raise ValueError("injected draws need the eager epoch (capture=False)")
            variant = kernel_variant() if model.encoding == "blockhash" else "default"
            if variant not in graphs:
                graphs[variant] = _CapturedStep(step, graph_pool)
            m = graphs[variant].epoch(poses, images, valid_idx, valid_counts, order, generator,
                                      occ_grid, lambda i: before_step(step0 + i, occ_grid,
                                                                      generator))
            return dict(zip(METRICS, m))
        with tracing.span("train.epoch"):
            ms = []
            for i, frame in enumerate(order):
                d = draws[i] if draws is not None else None
                before_step(step0 + i, occ_grid, generator, d)
                ms.append(step(poses, images, valid_idx, valid_counts, int(frame), draws=d,
                               generator=generator, occ_grid=occ_grid))
            return {k: torch.stack([m[k] for m in ms]) for k in METRICS}

    epoch_fn.step = step
    epoch_fn.graphs = graphs
    return epoch_fn


SEAM_SYNC_EVERY = 16  # steps between hashed-seam syncs (lidarnerf_tpu/nerf/trainer.py:496)


@torch.no_grad()
def sync_model_seams(model, n_per_axis, generator=None, draws=None):
    """`sync_hashed_seams` on a blockhash model's table, in place; a
    row-sharded table is gathered, synced alike on every rank, and each
    rank keeps its rows."""
    mesh = getattr(model, "table_mesh", None)
    table = model.hash_table.data
    if mesh is None or mesh.n_model == 1:
        sync_hashed_seams(table, model.block_spec, generator, n_per_axis, draws)
        return
    full = sharding.gather_table(table, mesh)
    sync_hashed_seams(full, model.block_spec, generator, n_per_axis, draws)
    table.copy_(sharding.row_shard(full, mesh))


@torch.no_grad()
def ema_update(ema_params, params, decay, num_updates):
    """torch_ema semantics, in place: e = d * e + (1 - d) * p with d = min(decay, (1+n)/(10+n)).

    ema_params, params: dicts of tensors with the same keys. Returns ema_params.
    """
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    with tracing.span("train.ema"):
        for k, e in ema_params.items():
            e.mul_(d).add_(params[k], alpha=1.0 - d)
    return ema_params
