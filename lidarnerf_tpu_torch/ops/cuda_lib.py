"""Build and load the package's CUDA kernels (plain C interface, bound with ctypes).

Each `csrc/*.cu` file is compiled by `nvcc` for sm_90a into a shared library
under `lidarnerf_tpu_torch/_build/`, named by a hash of its source, every
`csrc/*.cuh` header and the flags, so an edited source or shared header is
rebuilt and an unchanged one is reused. Nothing is
built when this module is imported: `load` builds at first use, and `build`
compiles several sources at once (one `nvcc` each, all started together).
The compiler's report (`-Xptxas -v`: registers, spills) is kept beside each
library in a `.log` file. `launch` calls a bound entry point on a device's
current stream, the one host path of every kernel wrapper.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded = {}  # library path -> ctypes.CDLL, one per process


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build(sources) -> dict:
    """Compile every source that has no current library, in parallel.

    Returns {source: library path}. Raises with the compiler's output if any
    build fails.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not paths[s].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for s in todo:
        tmp = paths[s].with_suffix(f".{os.getpid()}.tmp")
        with open(paths[s].with_suffix(".log"), "w") as log:  # the child keeps its own fd
            procs[s] = (
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)],
                                 stdout=log, stderr=subprocess.STDOUT),
                tmp,
            )
    failed = []
    for s, (proc, tmp) in procs.items():
        rc = proc.wait()
        if rc == 0:
            os.replace(tmp, paths[s])
        else:
            failed.append(f"{s}: nvcc exited {rc}\n{paths[s].with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    lib = build([source])[source]
    if lib not in _loaded:
        _loaded[lib] = ctypes.CDLL(str(lib))
    return _loaded[lib]


def launch(fn, device: torch.device, *args) -> int:
    """fn(*args, stream): a C entry point called with `device` (a CUDA
    tensor's device) current and its current stream's handle last; returns
    fn's error code. Enters `torch.cuda.device` only when another device is
    current, so a launch on the current device (the usual case) costs a
    `current_device()` and a `current_stream()`, and a launch on another
    card still lands on that card."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(index).cuda_stream)
    with torch.cuda.device(index):
        return fn(*args, torch.cuda.current_stream(index).cuda_stream)
