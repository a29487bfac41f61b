"""Host C++ range-view projection, bound with ctypes (counterpart of
lidarnerf_tpu/native; the source is the port's own copy, `rangeview.cpp`).

The library is built with g++ at first use, never when this module is
imported, into `lidarnerf_tpu_torch/_build/` (git-ignored), named by a hash
of the source, the flags and the CPU it is built for (`-march=native`): an
edited source is rebuilt, and a tree copied to another machine does not
load a library built for another CPU. This is host code, not a device
kernel: where no library can be built, `available()` is False, the callers
(`preprocess/rangeview.py`) take the numpy projection of
`dataset/convert.py`, `route()` says which of the two runs and
`build_error()` why the library is missing.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rangeview.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_state = {}  # "lib": the loaded library or None, "error": why it is None; set at first use


def _cpu() -> str:
    """The model name and flags of this machine's CPU, what -march=native builds for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.readlines()
    except OSError:
        return platform.machine() + platform.processor()
    return "".join(next((l for l in lines if l.startswith(k)), "") for k in ("model name", "flags"))


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu().encode())
    return BUILD_DIR / f"rangeview_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError with the compiler's output when g++ fails, OSError when
    there is no g++."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")  # concurrent builds each rename a whole file
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib):
    lib.lidar_to_pano_with_intensities.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.lidar_to_pano_with_intensities.restype = None
    lib.pano_to_lidar_with_intensities.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.pano_to_lidar_with_intensities.restype = ctypes.c_int64
    return lib


def load():
    """The bound library, built first if needed; None when it cannot be
    built or loaded (`build_error()` then says why). Tried once per process."""
    if "lib" not in _state:
        try:
            _state["lib"], _state["error"] = _bind(ctypes.CDLL(str(build()))), None
        except (OSError, RuntimeError) as e:
            _state["lib"], _state["error"] = None, f"{type(e).__name__}: {e}"
    return _state["lib"]


def available() -> bool:
    return load() is not None


def route() -> str:
    """"native" where the library serves the projection, else "numpy"."""
    return "native" if available() else "numpy"


def build_error():
    """Why the library is unavailable (the compiler's or loader's message), or None."""
    load()
    return _state["error"]


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError(f"native rangeview library unavailable: {_state['error']}")
    return lib


def lidar_to_pano_with_intensities(points, lidar_H, lidar_W, lidar_K, max_depth=80):
    """Native scatter-min projection; same contract as convert.py's version."""
    lib = _require()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be [N, 4] (x, y, z, intensity), got {pts.shape}")
    pano = np.zeros((lidar_H, lidar_W), np.float64)
    inten = np.zeros((lidar_H, lidar_W), np.float64)
    fov_up, fov = lidar_K
    lib.lidar_to_pano_with_intensities(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(pts)),
        lidar_H, lidar_W,
        ctypes.c_double(fov_up), ctypes.c_double(fov), ctypes.c_double(max_depth),
        pano.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        inten.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return pano, inten


def pano_to_lidar_with_intensities(pano, intensities, lidar_K):
    """Native inverse projection with compaction; returns [N, 4] float32."""
    lib = _require()
    pano = np.ascontiguousarray(pano, dtype=np.float64)
    inten = np.ascontiguousarray(intensities, dtype=np.float64)
    if pano.ndim != 2 or inten.shape != pano.shape:
        raise ValueError(f"pano {pano.shape} and intensities {inten.shape} must be one [H, W]")
    H, W = pano.shape
    out = np.empty((H * W, 4), np.float32)
    fov_up, fov = lidar_K
    n = lib.pano_to_lidar_with_intensities(
        pano.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        inten.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        H, W, ctypes.c_double(fov_up), ctypes.c_double(fov),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[:n].copy()
