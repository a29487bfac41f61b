"""Packaging for lidarnerf_tpu (twin of the reference's setup.py:1-35)."""

import os
import re

from setuptools import find_packages, setup


def read_version():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "lidarnerf_tpu", "__init__.py")) as f:
        m = re.search(r'__version__ = "(.*?)"', f.read())
    return m.group(1)


setup(
    name="lidarnerf_tpu",
    version=read_version(),
    description="TPU-native (JAX/XLA/Pallas) LiDAR novel-view-synthesis framework",
    packages=find_packages(
        include=["lidarnerf_tpu", "lidarnerf_tpu.*", "lidarnvs",
                 "lidarnerf_tpu_torch", "lidarnerf_tpu_torch.*"]
    ),
    package_data={"lidarnerf_tpu.native": ["*.cpp"], "lidarnerf_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "opencv-python",
        "imageio",
    ],
    extras_require={
        "dev": ["pytest"],
        "logging": ["tensorboardX"],
        "baselines-meshing": ["open3d"],
        "lpips": ["lpips", "torch"],
    },
)
