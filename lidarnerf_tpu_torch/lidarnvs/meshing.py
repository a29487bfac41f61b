"""Meshing-based NVS baselines (LidarSim-style): Poisson and NKSR
(counterpart of lidarnerf_tpu/lidarnvs/meshing.py).

Host tooling built on open3d's Poisson reconstruction and BVH raycasting,
and on the nksr package. Both are imported inside the functions that need
them: without open3d, `fit` raises an ImportError that names it, and
without nksr the NKSR baseline raises at construction. NKSR reconstructs
on the card unless `device="cpu"`; the UNet ray-drop net (with
`ckpt_path`) predicts there too.
"""

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.convert import pano_dirs, pano_to_lidar_with_intensities
from lidarnerf_tpu_torch.lidarnvs.base import LidarNVSBase
from lidarnerf_tpu_torch.lidarnvs.loader import extract_dataset_frame, homo_project
from lidarnerf_tpu_torch.ops.dispatch import resolve_device


def _require_open3d():
    try:
        import open3d as o3d  # noqa

        return o3d
    except ImportError as e:
        raise ImportError(
            "open3d is required for the meshing baselines (Poisson/NKSR). "
            "Use `--method pcgen` for a dependency-free baseline."
        ) from e


class LidarNVSMeshing(LidarNVSBase):
    """Base: accumulate points -> mesh -> raycast."""

    def __init__(self, k=9, ckpt_path=None, device=None):
        self.k = k  # kNN neighbours for intensity interpolation
        self.ckpt_path = ckpt_path
        self.device = device
        self.raydrop = None
        if ckpt_path is not None:
            from lidarnerf_tpu_torch.lidarnvs.raydrop_unet import UNetRaydropTrainer

            self.raydrop = UNetRaydropTrainer(device=device)
            self.raydrop.load_checkpoint(ckpt_path)

    def meshing_func(self, pcd):
        raise NotImplementedError

    def fit(self, dataset) -> None:
        o3d = _require_open3d()
        all_points, all_intensities = [], []
        for frame_idx in range(len(dataset)):
            frame = extract_dataset_frame(dataset, frame_idx)
            all_points.append(frame["points"])
            all_intensities.append(frame["point_intensities"])
        points = np.vstack(all_points)
        intensities = np.hstack(all_intensities)

        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(points)
        pcd.estimate_normals()
        self.mesh = self.meshing_func(pcd)

        # KDTree over source points for intensity interpolation
        self.points = points
        self.point_intensities = intensities
        self.kdtree = o3d.geometry.KDTreeFlann(pcd)

        # BVH raycasting scene
        self.scene = o3d.t.geometry.RaycastingScene()
        self.scene.add_triangles(o3d.t.geometry.TriangleMesh.from_legacy(self.mesh))

    def _intersect_rays(self, rays):
        """rays [N, 6] -> dict(hit_mask, depths, normals)."""
        o3d = _require_open3d()
        ans = self.scene.cast_rays(
            o3d.core.Tensor(rays.astype(np.float32))
        )
        depths = ans["t_hit"].numpy()
        hit_mask = np.isfinite(depths)
        normals = ans["primitive_normals"].numpy()
        depths = np.where(hit_mask, depths, 0.0)
        return {"hit_mask": hit_mask, "depths": depths, "normals": normals}

    def _interp_intensity(self, world_points):
        """kNN(k) inverse-uniform average of source intensities."""
        out = np.zeros(len(world_points))
        for i, p in enumerate(world_points):
            _, idx, _ = self.kdtree.search_knn_vector_3d(p, self.k)
            out[i] = self.point_intensities[np.asarray(idx)].mean()
        return out

    def predict_frame(self, lidar_K, lidar_pose, lidar_H, lidar_W) -> dict:
        dirs = pano_dirs(lidar_H, lidar_W, lidar_K).reshape(-1, 3)
        world_dirs = dirs @ np.asarray(lidar_pose)[:3, :3].T
        origins = np.broadcast_to(lidar_pose[:3, 3], world_dirs.shape)
        rays = np.concatenate([origins, world_dirs], axis=-1)

        hit = self._intersect_rays(rays)
        pano = hit["depths"].reshape(lidar_H, lidar_W)

        hit_world = origins + world_dirs * hit["depths"][:, None]
        intensities = np.zeros(len(rays))
        intensities[hit["hit_mask"]] = self._interp_intensity(
            hit_world[hit["hit_mask"]]
        )
        intensities = intensities.reshape(lidar_H, lidar_W)
        return self._pack(pano, intensities, lidar_K, lidar_pose, hit)

    def predict_frame_with_raydrop(self, lidar_K, lidar_pose, lidar_H, lidar_W) -> dict:
        if self.raydrop is None:
            raise RuntimeError("no UNet ray-drop checkpoint loaded")
        frame = self.predict_frame(lidar_K, lidar_pose, lidar_H, lidar_W)
        features = self._raydrop_features(frame, lidar_K, lidar_pose, lidar_H, lidar_W)
        prob = self.raydrop.predict(features[None])[0]
        mask = np.where(prob > 0.5, 1.0, 0.0)
        pano = frame["pano"] * mask
        intensities = frame["intensities"] * mask
        return self._pack(pano, intensities, lidar_K, lidar_pose, frame["_hit"])

    def _raydrop_features(self, frame, lidar_K, lidar_pose, lidar_H, lidar_W):
        """10-channel input image (RaydropDataset.collate's layout)."""
        hit = frame["_hit"]
        dirs = pano_dirs(lidar_H, lidar_W, lidar_K).reshape(-1, 3)
        world_dirs = dirs @ np.asarray(lidar_pose)[:3, :3].T
        normals = hit["normals"]
        incidence = np.abs(np.sum(world_dirs * normals, axis=-1))
        H, W = lidar_H, lidar_W
        return np.concatenate(
            [
                hit["hit_mask"].reshape(H, W, 1).astype(np.float32),
                hit["depths"].reshape(H, W, 1),
                normals.reshape(H, W, 3),
                incidence.reshape(H, W, 1),
                frame["intensities"].reshape(H, W, 1),
                world_dirs.reshape(H, W, 3),
            ],
            axis=-1,
        ).astype(np.float32)

    def _pack(self, pano, intensities, lidar_K, lidar_pose, hit=None):
        pts_i = pano_to_lidar_with_intensities(pano, intensities, lidar_K)
        local_points = pts_i[:, :3]
        points = homo_project(local_points, lidar_pose)
        return {
            "pano": pano,
            "intensities": intensities,
            "points": points,
            "point_intensities": pts_i[:, 3],
            "local_points": local_points,
            "local_point_intensities": pts_i[:, 3],
            "_hit": hit,
        }


class LidarNVSPoisson(LidarNVSMeshing):
    """Poisson reconstruction (depth 11) + density-quantile filter."""

    def __init__(self, depth=11, min_density=0.3, k=9, ckpt_path=None, device=None):
        super().__init__(k=k, ckpt_path=ckpt_path, device=device)
        self.depth = depth
        self.min_density = min_density

    def meshing_func(self, pcd):
        o3d = _require_open3d()
        mesh, densities = o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(
            pcd, depth=self.depth
        )
        densities = np.asarray(densities)
        keep = densities >= np.quantile(densities, self.min_density)
        mesh.remove_vertices_by_mask(~keep)
        return mesh


class LidarNVSNKSR(LidarNVSMeshing):
    """Neural-kernel surface reconstruction."""

    def __init__(self, k=9, ckpt_path=None, device=None):
        super().__init__(k=k, ckpt_path=ckpt_path, device=device)
        try:
            import nksr  # noqa
        except ImportError as e:
            raise ImportError("nksr package required for the NKSR baseline") from e

    def meshing_func(self, pcd):
        import nksr

        o3d = _require_open3d()
        device = resolve_device(self.device)
        reconstructor = nksr.Reconstructor(device)
        pts = torch.from_numpy(np.asarray(pcd.points)).float().to(device)
        nrm = torch.from_numpy(np.asarray(pcd.normals)).float().to(device)
        field = reconstructor.reconstruct(pts, nrm)
        mesh_t = field.extract_dual_mesh(mise_iter=1)
        mesh = o3d.geometry.TriangleMesh(
            o3d.utility.Vector3dVector(mesh_t.v.cpu().numpy()),
            o3d.utility.Vector3iVector(mesh_t.f.cpu().numpy()),
        )
        return mesh


def generate_raydrop_data_meshing(dataset, nvs: LidarNVSMeshing, rm_pano_mask=True):
    """Per-frame UNet training dicts (RaydropDataset's pickle layout)."""
    out = []
    for frame_idx in range(len(dataset)):
        gt = extract_dataset_frame(dataset, frame_idx, rm_pano_mask=rm_pano_mask)
        pred = nvs.predict_frame(
            gt["lidar_K"], gt["lidar_pose"], gt["lidar_H"], gt["lidar_W"]
        )
        feats = nvs._raydrop_features(
            pred, gt["lidar_K"], gt["lidar_pose"], gt["lidar_H"], gt["lidar_W"]
        )
        out.append(
            {
                "hit_masks": feats[..., 0],
                "hit_depths": feats[..., 1],
                "hit_normals": feats[..., 2:5],
                "hit_incidences": feats[..., 5],
                "intensities": feats[..., 6],
                "rays_d": feats[..., 7:10],
                "raydrop_masks": (gt["pano"] > 0).astype(np.float32),
            }
        )
    return out
