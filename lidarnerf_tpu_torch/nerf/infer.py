"""Full-pano LiDAR inference: the port's serving entry point.

`PanoRenderer` is the counterpart of lidarnerf_tpu/nerf/trainer.py's
`Trainer._render_full_frame` (:572-588) plus the per-frame post-processing
of `Trainer.test` (:718-736): it renders every ray of a LiDAR pano in
`max_ray_batch`-ray chunks and turns the depth pano into a point cloud.

`opt` carries the JAX CLI's field names (main_lidarnerf.py): encoding,
desired_resolution, log2_hashmap_size, num_layers, hidden_dim, geo_feat_dim,
bound, scale, num_steps, upsample_steps, max_ray_batch, fp16, alpha_r,
n_features_per_level (2 if absent), and for `--fast` occ_sampling with the
occ_* fields (models/occupancy.py), and `seam_tie` (False if absent). Every
encoding of the CLI is served; a field trained with `--seam_tie` is served
with the tie, as the JAX model applies it in every encode. As in the CLI,
min_near_lidar = scale.
"""

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.occupancy import occ_config_from_opt
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays_staged
from lidarnerf_tpu_torch.ops.dispatch import resolve_device
from lidarnerf_tpu_torch.utils import tracing
from lidarnerf_tpu_torch.utils.params import params_from_jax


class PanoRenderer:
    """Renders LiDAR panos from a trained field.

    Args:
        opt: options object with the CLI's field names (module docstring).
        params: flax parameter tree with numpy leaves, e.g. from
            `utils.params.load_jax_checkpoint`.
        device: None runs on CUDA and raises if there is none; pass "cpu" to
            run the plain PyTorch path on the CPU.
        occ_grid: the [G, G, G] occupancy grid the field was trained with
            (e.g. `utils.params.load_jax_occ_grid`); needed, and used, when
            `opt.occ_sampling` is set.
    """

    def __init__(self, opt, params, device=None, occ_grid=None):
        self.device = resolve_device(device)
        self.opt = opt
        self.network = NeRFNetwork(
            encoding=opt.encoding,
            desired_resolution=opt.desired_resolution,
            log2_hashmap_size=opt.log2_hashmap_size,
            n_features_per_level=getattr(opt, "n_features_per_level", 2),
            num_layers=opt.num_layers,
            hidden_dim=opt.hidden_dim,
            geo_feat_dim=opt.geo_feat_dim,
            bound=opt.bound,
            compute_dtype=torch.bfloat16 if opt.fp16 else torch.float32,
            seam_tie=bool(getattr(opt, "seam_tie", False)),
        )
        self.network.load_state_dict(params_from_jax(params))
        self.network.to(self.device).eval()
        occ = occ_config_from_opt(opt)
        self.occ_grid = None
        if occ is not None:
            if occ_grid is None:
                raise ValueError("opt.occ_sampling is set: pass the occupancy grid the field "
                                 "was trained with (occ_grid=)")
            self.occ_grid = torch.as_tensor(occ_grid, dtype=torch.float32, device=self.device)
            if self.occ_grid.shape != (occ.grid_size,) * 3:
                raise ValueError(f"occ_grid must be {[occ.grid_size] * 3}, got "
                                 f"{list(self.occ_grid.shape)}")
        self.cfg = RenderConfig(
            num_steps=opt.num_steps,
            upsample_steps=opt.upsample_steps,
            min_near_lidar=opt.scale,
            min_near=opt.scale,
            bound=opt.bound,
            occ=occ,
        )

    def render_frame(self, pose, H, W, intrinsics):
        """One full pano -> (raydrop, intensity, depth), each a [H, W] float32 numpy array.

        pose: [4, 4] lidar2world (numpy or tensor).
        """
        with tracing.span("pano.frame"):
            with tracing.span("pano.rays"):
                pose = torch.as_tensor(np.asarray(pose, dtype=np.float32), device=self.device)
                rays = get_lidar_rays(pose[None], intrinsics, H, W, N=-1)
            out = render_rays_staged(
                self.network, rays["rays_o"][0], rays["rays_d"][0], self.cfg,
                chunk=self.opt.max_ray_batch, occ_grid=self.occ_grid,
            )
            # one host copy of the whole pano: (raydrop, intensity, depth)
            with tracing.span("pano.gather"):
                pano = torch.cat([out["image"], out["depth"][:, None]], -1).reshape(H, W, 3)
            with tracing.span("pano.to_host"):
                pano = pano.cpu().numpy()
        return pano[..., 0], pano[..., 1], pano[..., 2]

    def test_frames(self, poses, H, W, intrinsics):
        """Render each pose and post-process as `Trainer.test` does.

        With alpha_r > 0, intensity and depth are zeroed where raydrop <= 0.5.
        Returns one dict per pose: raydrop, intensity, depth ([H, W]) and
        points, the depth pano in sensor-frame metres as [P, 3].
        """
        frames = []
        for pose in poses:
            raydrop, intensity, depth = self.render_frame(pose, H, W, intrinsics)
            if self.opt.alpha_r > 0:
                mask = np.where(raydrop > 0.5, 1.0, 0.0)
                intensity = intensity * mask
                depth = depth * mask
            frames.append({
                "raydrop": raydrop,
                "intensity": intensity,
                "depth": depth,
                "points": pano_to_lidar(depth / self.opt.scale, intrinsics),
            })
        return frames
