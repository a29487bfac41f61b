"""models"""

from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays, render_rays_staged

__all__ = ["NeRFNetwork", "RenderConfig", "render_rays", "render_rays_staged"]
