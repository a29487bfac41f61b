"""Abstract interface of the classical LiDAR novel-view-synthesis baselines
(counterpart of lidarnerf_tpu/lidarnvs/base.py)."""

from abc import ABC, abstractmethod

import numpy as np


class LidarNVSBase(ABC):
    @abstractmethod
    def fit(self, dataset) -> None:
        """Fit the model to the given train dataset."""

    @abstractmethod
    def predict_frame(
        self,
        lidar_K: np.ndarray,  # (2,)
        lidar_pose: np.ndarray,  # (4, 4)
        lidar_H: int,
        lidar_W: int,
    ) -> dict:
        """Synthesise a frame; returns dict with pano/intensities/points keys."""

    @abstractmethod
    def predict_frame_with_raydrop(
        self,
        lidar_K: np.ndarray,
        lidar_pose: np.ndarray,
        lidar_H: int,
        lidar_W: int,
    ) -> dict:
        """Synthesise a frame and apply the learned ray-drop mask."""
