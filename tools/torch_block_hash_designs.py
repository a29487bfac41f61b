#!/usr/bin/env python3
"""Time two designs of the port's block-hash kernels on one GPU, in turns.

    python3 tools/torch_block_hash_designs.py OLD_CSRC [--seg-groups 1,2,4,8] [--level-probe]

OLD_CSRC is a `lidarnerf_tpu_torch/csrc` directory of another tree (for
example an earlier commit unpacked with `git archive` into a git-ignored
directory). Its B1 (`block_hash_fwd.cu`), B2 (`block_hash_bwd.cu`), B3a
(`block_hash_seg_fwd.cu`), B3b (`block_hash_seg_bwd.cu`) and B4b
(`block_hash_win_bwd.cu`) are built with the port's nvcc flags beside this
tree's, and both are called through their C entry points on the same
inputs, at the main paths' shapes: the coarse call of a served chunk
(forwards) or a training chunk (backwards), 4096 rays x 768 samples; the
fine call's 262,144 queries; the `--fast` coarse call, 4096 x 192;
3,145,728 uniform points; the `--fast` grid refresh, 128^3 points in grid
order. Each shape is timed old, new, new, old. A forward's two outputs must
be equal bit for bit, and each backward within 1e-5 S + 1e-7 of its plain
version (S its sum of absolute terms); a backward of this tree must repeat
bit for bit. Backwards whose sources lack `block_hash_scatter.cuh` (the
fp32-atomic designs) take no scratch argument.

`--seg-groups` also builds this tree's B3a at each tile width (32-query
groups per block, the SEG_GROUPS macro) and times each in turns with B1 at
the coarse and uniform shapes. `--level-probe` times this tree's B2 on the
coarse call's levels 11-15 in one call and in two or three calls of fewer
levels each (each call zeroes, accumulates and converts only its levels'
rows): whether the int64 sums' working set, larger than the L2 in one
call, sets the fine levels' pace. Needs a GPU and nvcc; imports no JAX.
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
from lidarnerf_tpu_torch.ops import block_hash as bh  # noqa: E402
from lidarnerf_tpu_torch.ops import block_hash_cuda as bhc  # noqa: E402
from lidarnerf_tpu_torch.ops import cuda_lib  # noqa: E402

N_FINE = cs.FULL.max_ray_batch * cs.FULL.upsample_steps
FAST_STEPS = cs.FAST["num_steps"]
# name -> (forward?, variant)
KERNELS = {
    "block_hash_fwd": (True, "default"),
    "block_hash_seg_fwd": (True, "seg"),
    "block_hash_bwd": (False, "default"),
    "block_hash_seg_bwd": (False, "seg"),
    "block_hash_win_bwd": (False, "win"),
}


def build(csrc: Path, names, out_dir: Path, tag: str, defines=()) -> dict:
    """{name: library path} of csrc's sources `names`, one nvcc each, all started together."""
    procs = {}
    for name in names:
        lib = out_dir / f"{tag}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *defines, "-o", str(lib),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{out}")
    return {name: lib for name, (lib, _) in procs.items()}


def caller(lib: Path, name, spec, scratch):
    """A call of C entry point `name` of `lib` that allocates its output (and
    scratch) as the wrapper does; fp32-atomic backwards get a zeroed output."""
    forward, variant = KERNELS[name]
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.restype = ctypes.c_int
    ptrs = 4 if scratch else 3
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + \
        [ctypes.POINTER(ctypes.c_float)] + [ctypes.POINTER(ctypes.c_int)] * (
            3 + (variant != "default")) + [ctypes.c_void_p]
    arrays = bhc._level_arrays(spec, variant)

    def call(x, other):
        if forward:
            out = torch.empty((x.shape[0], spec.output_dim), device=x.device)
        elif scratch:
            out = torch.empty((spec.table_rows, 128), device=x.device)
        else:
            out = torch.zeros((spec.table_rows, 128), device=x.device)
        extra = (torch.empty(bhc.scratch_words(spec), dtype=torch.int64, device=x.device).data_ptr(),
                 ) if scratch else ()
        err = fn(x.data_ptr(), other.data_ptr(), out.data_ptr(), *extra, x.shape[0],
                 spec.num_levels, spec.blocks_per_level, *arrays,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        return out

    return call


def refresh_points(dev, gen, G=128):
    idx = torch.arange(G, dtype=torch.float32, device=dev)
    cell = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    return ((cell + torch.rand(cell.shape, generator=gen, device=dev)) / G).contiguous()


def in_turns(a, b, *args):
    """(a ms, b ms, b ms, a ms) of one call each on the same inputs."""
    return [cs.cuda_ms(lambda: fn(*args), reps=10) for fn in (a, b, b, a)]


def ms_line(t):
    return " / ".join(f"{v:.4f}" for v in t)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old_csrc", type=Path)
    parser.add_argument("--seg-groups", default="", help="B3a tile widths to time, e.g. 1,2,4,8")
    parser.add_argument("--level-probe", action="store_true",
                        help="time B2's fine levels in one call and in level ranges")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_block_hash_designs: no CUDA device is available", file=sys.stderr)
        return 1
    old_csrc, new_csrc = args.old_csrc.resolve(), cuda_lib.CSRC_DIR
    dev = torch.device("cuda")
    spec = bh.make_block_hash_spec(log2_hashmap_size=cs.FULL.log2_hashmap_size,
                                   desired_resolution=cs.FULL.desired_resolution)
    groups = [int(v) for v in args.seg_groups.split(",") if v]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        libs = {"old": build(old_csrc, KERNELS, tmp, "old"), "new": build(new_csrc, KERNELS, tmp, "new")}
        seg_libs = {G: build(new_csrc, ["block_hash_seg_fwd"], tmp, f"g{G}", (f"-DSEG_GROUPS={G}",))
                    for G in groups}
        has_scratch = {"old": (old_csrc / "block_hash_scatter.cuh").exists(), "new": True}
        fns = {tree: {name: caller(libs[tree][name], name, spec,
                                   has_scratch[tree] and not KERNELS[name][0])
                      for name in KERNELS} for tree in libs}
        print(f"gpu: {cs.gpu_line()}; old sources {old_csrc}", flush=True)

        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 13)
        table = torch.randn((spec.table_rows, 128), generator=gen, device=dev)
        served = cs.serving_chunk_queries(dev)
        uniform = torch.rand((served.shape[0], 3), generator=gen, device=dev) * 1.1 - 0.05
        refresh = refresh_points(dev, gen)
        fwd_shapes = {"coarse": served, "fine": served[:N_FINE],
                      "fast": cs.serving_chunk_queries(dev, FAST_STEPS), "uniform": uniform,
                      "refresh": refresh}
        for name in ("block_hash_fwd", "block_hash_seg_fwd"):
            fo, fn = fns["old"][name], fns["new"][name]
            for shape, x in fwd_shapes.items():
                b1 = fns["new"]["block_hash_fwd"](x, table)
                same = torch.equal(fo(x, table), b1) and torch.equal(fn(x, table), b1)
                print(f"{name} {shape} Q={x.shape[0]}: old / new / new / old "
                      f"{ms_line(in_turns(fo, fn, x, table))} ms; both equal to B1 bit for bit: "
                      f"{same}", flush=True)
                if not same:
                    raise AssertionError(f"a {name} design disagrees with B1 ({shape})")
        for G, lib in seg_libs.items():
            fg = caller(lib["block_hash_seg_fwd"], "block_hash_seg_fwd", spec, False)
            for shape in ("coarse", "uniform"):
                x = fwd_shapes[shape]
                b1 = fns["new"]["block_hash_fwd"]
                if not torch.equal(fg(x, table), b1(x, table)):
                    raise AssertionError(f"B3a with SEG_GROUPS={G} disagrees with B1 ({shape})")
                print(f"block_hash_seg_fwd SEG_GROUPS={G} ({32 * G}-query tile) {shape}: "
                      f"B1 / B3a / B3a / B1 {ms_line(in_turns(b1, fg, x, table))} ms", flush=True)

        ds = cs.synth_drive()
        train_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
        training = cs.training_chunk_queries(ds, dev, train_gen)
        bwd_shapes = {"coarse": training, "fine": training[:N_FINE],
                      "fast": cs.training_chunk_queries(ds, dev, train_gen, FAST_STEPS),
                      "uniform": uniform, "refresh": refresh}
        if args.level_probe:
            g = torch.randn((training.shape[0], spec.output_dim), generator=gen, device=dev)
            for split in ([(11, 16)], [(11, 14), (14, 16)], [(11, 13), (13, 15), (15, 16)]):
                calls = [(cs.level_range(spec, lo, hi), g[:, 2 * lo: 2 * hi].contiguous())
                         for lo, hi in split]

                def run(calls=calls):
                    for sp, gr in calls:
                        bhc.block_hash_bwd(training, gr, sp)

                t = [cs.cuda_ms(run, reps=10) for _ in range(2)]
                print(f"block_hash_bwd coarse call, levels 11-15 as {split}: "
                      f"{ms_line(t)} ms", flush=True)
            del g
        for shape, x in bwd_shapes.items():
            g = torch.randn((x.shape[0], spec.output_dim), generator=gen, device=dev)
            slack = cs.BWD_RTOL * bh.encode_bwd_plain(x, g.abs(), spec) + cs.BWD_ATOL
            for name in ("block_hash_bwd", "block_hash_seg_bwd", "block_hash_win_bwd"):
                bo, bn = fns["old"][name], fns["new"][name]
                ref = bh.ENCODE_BWD_PLAIN[KERNELS[name][1]](x, g, spec)
                new = bn(x, g)
                worst = [((out - ref).abs() / slack).max().item() for out in (bo(x, g), new)]
                repeats = torch.equal(new.view(torch.int32), bn(x, g).view(torch.int32))
                del ref
                print(f"{name} {shape} Q={x.shape[0]}: old / new / new / old "
                      f"{ms_line(in_turns(bo, bn, x, g))} ms; worst err / (1e-5 S + 1e-7): old "
                      f"{worst[0]:.3f}, new {worst[1]:.3f}; new repeats bit for bit: {repeats}",
                      flush=True)
                if not (max(worst) <= 1.0 and repeats):
                    raise AssertionError(f"a {name} design disagrees or does not repeat ({shape})")
            del slack
    return 0


if __name__ == "__main__":
    sys.exit(main())
