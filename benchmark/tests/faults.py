"""Faults planted in the program's timed path, for the tests that see the
check come out false. Each takes the cell after its construction and before
its set-up."""

import torch


def unchanged(cell):
    """Training: the optimizer's step leaves the state as it was."""
    cell.adam.step = lambda loss: torch.ones((), dtype=torch.bool, device=loss.device)


def epoch_unchanged(cell):
    """Training: the steps of the epochs leave the state as it was; the eager
    steps before them update it."""
    from benchmark.train import eager_patches

    step, calls, n = cell.adam.step, [0], len(eager_patches(cell.cfg))

    def frozen(loss):
        calls[0] += 1
        return step(loss) if calls[0] <= n else torch.ones((), dtype=torch.bool,
                                                           device=loss.device)

    cell.adam.step = frozen


def stale_grid(cell):
    """Training under `--fast`: the refreshes inside the epochs leave the grid
    as the first refresh made it."""
    from lidarnerf_tpu_torch.nerf import train_step

    train_step.update_occ_grid = lambda model, grid, *a, **k: grid


def half_batch(cell):
    """Training: the loss leaves out half of the batch, its mean over the rest."""
    from lidarnerf_tpu_torch.nerf import train_step

    full = train_step.lidar_losses

    def half(cfg, pred_depth, pred_image, gt):
        loss, *rest = full(cfg, pred_depth, pred_image, gt)
        keep = (torch.arange(loss.shape[0], device=loss.device) < loss.shape[0] // 2).float()
        return (loss * keep * 2.0, *rest)

    train_step.lidar_losses = half


def altered(cell):
    """Serving: the first chunk's depths altered by 1% where the render produces them."""
    from lidarnerf_tpu_torch.nerf import infer

    staged = infer.render_rays_staged

    def altered_staged(network, rays_o, rays_d, cfg, chunk=4096, occ_grid=None):
        out = staged(network, rays_o, rays_d, cfg, chunk, occ_grid)
        out["depth"][:chunk] *= 1.01
        return out

    infer.render_rays_staged = altered_staged


FAULTS = {"unchanged": unchanged, "epoch_unchanged": epoch_unchanged, "stale_grid": stale_grid,
          "half_batch": half_batch, "altered": altered}
