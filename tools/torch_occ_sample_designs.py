#!/usr/bin/env python3
"""Time two designs of the port's fused `--fast` sampler kernel on one GPU, in turns.

    python3 tools/torch_occ_sample_designs.py OLD_CSRC

OLD_CSRC is a `lidarnerf_tpu_torch/csrc` directory of another tree (for
example an earlier commit unpacked with `git archive` into a git-ignored
directory). Its `occ_sample.cu` and this tree's are built with the port's
nvcc flags and called through their C entry point `occ_sample`: a source
that defines SMEM_BINS takes a workspace pointer after the pdf's, an older
one does not (and takes a floor of 2^-29 x bins or more). The inputs are the
`--fast` step's traffic as `chip_smoke.py`'s occ-sample phase makes it, in
the dilated occupied volume of `data_synth_drive60/` frame 0's returns (a
128^3 grid): 4096 rays of frame 0 with the step's draws, and a served
chunk (the pano's first 4096 rays, no draws), 128 bins, 192 samples, at the
default floor 0.05 and at the least floor both designs take, 2^-29 x 128.
At each, the two builds' z and pdf must equal each other and
`occ_sample_plain` bit for bit; then each build's device ms a call, the
kernel alone (contiguous inputs, no entry point around it): CUDA-graph
replays of 100 calls, old, new, new, old, and CUDA events over 20
back-to-back calls in the same order. Prints each build's ptxas report
(registers, spills). Needs a GPU and nvcc; imports no JAX.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices  # noqa: E402
from lidarnerf_tpu_torch.models.occupancy import OccConfig, occupied_volume  # noqa: E402
from lidarnerf_tpu_torch.models.renderer import RenderConfig  # noqa: E402
from lidarnerf_tpu_torch.ops import cuda_lib, occ_sample_cuda  # noqa: E402
from lidarnerf_tpu_torch.ops.occ_sample import occ_sample_plain  # noqa: E402
from lidarnerf_tpu_torch.tools.exp_occ_lookup import device_ms  # noqa: E402

RAYS, BINS, STEPS = 4096, 128, 192
FLOORS = {"floor 0.05": 0.05, "floor 2^-29 x 128": 2.0**-29 * BINS}


def build(trees, out_dir: Path) -> dict:
    """{tag: (library, ptxas report, takes a workspace)} of each (tag, csrc)
    tree's occ_sample.cu, one nvcc each, all started together."""
    procs = {}
    for tag, csrc in trees:
        lib = out_dir / f"{tag}_occ_sample.so"
        src = csrc / occ_sample_cuda.SOURCE
        procs[tag] = (lib, src, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (lib, src, proc) in procs.items():
        output = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{output}")
        built[tag] = (lib, [ln.strip() for ln in output.splitlines()
                            if "registers" in ln or "spill" in ln],
                      "#define SMEM_BINS" in src.read_text())
    return built


def caller(lib: Path, takes_work: bool):
    """A call of the library's `occ_sample` with the wrapper's scalars, its
    outputs allocated as the wrapper allocates them (no workspace at these
    bins)."""
    fn = ctypes.CDLL(str(lib)).occ_sample
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 8,
                   *([ctypes.c_void_p] if takes_work else []), ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, *[ctypes.c_float] * 7, ctypes.c_void_p]

    def call(occ3, o, d, nears, fars, floor, xi, u_row, want_pdf=False):
        N, G = o.shape[0], occ3.shape[0]
        z = torch.empty((N, STEPS), device=o.device)
        pdf = torch.empty((N, BINS), device=o.device) if want_pdf else None
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(occ3.data_ptr(), G, o.data_ptr(), d.data_ptr(), nears.data_ptr(),
                 fars.data_ptr(), ptr(xi), ptr(u_row), z.data_ptr(), ptr(pdf),
                 *([None] if takes_work else []), N, BINS, STEPS, 1.0, G / 2.0, 1.0 - floor,
                 floor / BINS, 1e-12, 1.0 / BINS, 1.0 / STEPS,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"occ_sample launch failed: cudaError {err}")
        return z, pdf

    return call


def inputs():
    """(occ3, {shape: (o, d, nears, fars, xi, u_row)}) on the card."""
    ds = cs.synth_drive()
    occ = OccConfig()
    occ3 = occupied_volume(cs.hit_grid(ds, occ.grid_size).cuda(), occ)
    cfg = RenderConfig(min_near_lidar=ds.scale)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    poses, _ = ds.device_arrays("cuda")
    frame = (ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    o, d = rays_from_indices(poses[0], sample_ray_indices(*frame[:2], RAYS, 1, gen, "cuda"),
                             *frame)
    so, sd = rays_from_indices(poses[0], torch.arange(RAYS, device="cuda"), *frame)
    nears = torch.full((RAYS, 1), cfg.min_near_lidar, device="cuda")
    fars = torch.full((RAYS, 1), cfg.min_near_lidar * cfg.far_mult, device="cuda")
    xi = torch.rand((RAYS, STEPS), generator=gen, device="cuda")
    u_row = torch.linspace(0.0, 1.0, STEPS, device="cuda")
    return occ3, {"step": (o.contiguous(), d, nears, fars, xi, None),
                  "serving chunk": (so.contiguous(), sd, nears, fars, None, u_row)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old_csrc", type=Path)
    args = parser.parse_args()
    print(f"gpu: {cs.gpu_line()}; torch {torch.__version__}, cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        built = build([("old", args.old_csrc), ("new", cuda_lib.CSRC_DIR)], Path(tmp))
        for tag, (_, report, takes_work) in built.items():
            print(f"{tag} ({'workspace' if takes_work else 'no workspace'}): {'; '.join(report)}")
        calls = {tag: caller(lib, takes_work) for tag, (lib, _, takes_work) in built.items()}
        occ3, shapes = inputs()
        print(f"occupied volume: {100 * float(occ3.mean()):.2f}% of {occ3.shape[0]}^3")
        for shape, (o, d, nears, fars, xi, u_row) in shapes.items():
            for name, floor in FLOORS.items():
                cfg = OccConfig(floor=floor)
                z_ref, pdf_ref = occ_sample_plain(occ3, o, d, nears, fars, cfg, 1.0, STEPS,
                                                  xi is not None, xi=xi, want_pdf=True)
                for tag, call in calls.items():
                    z, pdf = call(occ3, o, d, nears, fars, floor, xi, u_row, want_pdf=True)
                    if not (cs.bit_equal(z, z_ref) and cs.bit_equal(pdf, pdf_ref)):
                        raise AssertionError(f"{shape}, {name}: {tag} differs from the plain "
                                             f"sampler")
                fns = {tag: (lambda call=call, floor=floor: call(occ3, o, d, nears, fars, floor,
                                                                   xi, u_row))
                       for tag, call in calls.items()}
                order = ("old", "new", "new", "old")
                graph = [device_ms(fns[tag]) for tag in order]
                events = [cs.cuda_ms(fns[tag], reps=20) for tag in order]
                print(f"{shape}, {name}: old and new z, pdf bit-equal to the plain sampler; "
                      f"ms a call, old / new / new / old: CUDA-graph replays "
                      f"{' / '.join(f'{t:.5f}' for t in graph)}, CUDA events "
                      f"{' / '.join(f'{t:.5f}' for t in events)}")
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
