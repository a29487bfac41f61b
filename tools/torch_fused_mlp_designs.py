#!/usr/bin/env python3
"""Time two designs of the port's fused-MLP kernel (B5) on one GPU, in turns.

    python3 tools/torch_fused_mlp_designs.py OLD_CSRC [--patch TREE:FROM=>TO ...]

OLD_CSRC is a `lidarnerf_tpu_torch/csrc` directory of another tree (for
example an earlier commit unpacked with `git archive` into a git-ignored
directory). Its `fused_mlp.cu` and this tree's are built with the port's
nvcc flags and called through their C entry point `fused_mlp` (whose
signature both keep) on the same inputs, at the model's shapes: the sigma
net, 3,145,728 x [32, 64, 16] (a served chunk's coarse samples), and the
LiDAR head, 3,407,872 x [90, 64, 64, 2] with a sigmoid (its 832 samples),
with bfloat16 and float32 weights. With bfloat16 weights it also times the
tensor-core route's generic instance (GenericChain, widths known at run
time): the sigma net with a ReLU after its last layer and the head with no
final activation (the model's nets are compiled for theirs), and the
wide-buffer route, 3,145,728 x [32, 256, 16]. Each shape is timed old, new,
new, old; each output is held against `mlp_reference` (|k - p| <= r S +
1e-6, S the chain on |x| and |W|, r = 2^-7 for bf16 and 1e-5 for float32
weights), and this tree's must repeat bit for bit. For each build it prints
the ptxas report (registers, spills) and the count of HMMA instructions
(tensor-core mma) in its SASS; for this tree, each instance's registers and
blocks per SM.

`--patch TREE:FROM=>TO` (repeatable; TREE is `old` or `new`) also builds a
copy of that tree's sources, in a temporary directory, with every FROM in
its fused_mlp.cu replaced by TO, and times it in turns with the unpatched
build at every shape, with the same checks. Needs a GPU and nvcc; imports
no JAX.
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from lidarnerf_tpu_torch.ops import cuda_lib, fused_mlp_cuda  # noqa: E402
from lidarnerf_tpu_torch.ops.fused_mlp import mlp_reference  # noqa: E402

SIGMA_Q = cs.FULL.max_ray_batch * cs.FULL.num_steps
HEAD_Q = cs.FULL.max_ray_batch * (cs.FULL.num_steps + cs.FULL.upsample_steps)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# name -> (rows, dims, final activation, weight dtypes)
SHAPES = {
    "sigma net": (SIGMA_Q, [32, 64, 16], "none", ("bf16", "f32")),
    "LiDAR head": (HEAD_Q, [90, 64, 64, 2], "sigmoid", ("bf16", "f32")),
    "sigma net, relu out (GenericChain)": (SIGMA_Q, [32, 64, 16], "relu", ("bf16",)),
    "LiDAR head, no final activation (GenericChain)": (HEAD_Q, [90, 64, 64, 2], "none", ("bf16",)),
    "wide hidden (GenericChain, one buffer)": (SIGMA_Q, [32, 256, 16], "none", ("bf16",)),
}


def build(trees, out_dir: Path) -> dict:
    """{tag: (library, ptxas report)} of each (tag, csrc) tree's fused_mlp.cu,
    built with the port's flags, one nvcc each, all started together."""
    procs = {}
    for tag, csrc in trees:
        lib = out_dir / f"{tag}_fused_mlp.so"
        procs[tag] = (lib, csrc, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(csrc / fused_mlp_cuda.SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (lib, csrc, proc) in procs.items():
        output = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / fused_mlp_cuda.SOURCE}:\n{output}")
        built[tag] = lib, [ln.strip() for ln in output.splitlines()
                           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return built


def hmma_count(lib: Path) -> int:
    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return sum("HMMA" in ln for ln in sass.splitlines())


def caller(lib: Path):
    """A call of the library's `fused_mlp` that allocates its output as the wrapper does."""
    fn = ctypes.CDLL(str(lib)).fused_mlp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def call(x, ws, act):
        L = len(ws)
        dims = [x.shape[1]] + [w.shape[1] for w in ws]
        out = torch.empty((x.shape[0], dims[-1]), device=x.device)
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0],
                 (ctypes.c_void_p * L)(*[w.data_ptr() for w in ws]),
                 (ctypes.c_int * (L + 1))(*dims), L, int(ws[0].dtype == torch.bfloat16),
                 fused_mlp_cuda.ACTIVATIONS[act], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fused_mlp launch failed: cudaError {err}")
        return out

    return call


def patch_arg(text):
    """TREE:FROM=>TO -> (tree, from, to)."""
    tree, _, rest = text.partition(":")
    old, sep, new = rest.partition("=>")
    if tree not in ("old", "new") or not old or not sep:
        raise argparse.ArgumentTypeError(f"expected old|new:FROM=>TO, got {text!r}")
    return tree, old, new


def patched(csrc: Path, tmp: Path, tag: str, old: str, new: str) -> Path:
    """A copy of csrc in tmp with every `old` of its fused_mlp.cu replaced by `new`."""
    dst = tmp / f"{tag}_csrc"
    shutil.copytree(csrc, dst)
    src = (dst / fused_mlp_cuda.SOURCE).read_text()
    if old not in src:
        raise ValueError(f"{old!r} is not in {csrc / fused_mlp_cuda.SOURCE}")
    (dst / fused_mlp_cuda.SOURCE).write_text(src.replace(old, new))
    return dst


def in_turns(a, b, *args):
    """(a ms, b ms, b ms, a ms) of one call each on the same inputs."""
    return [cs.cuda_ms(lambda: fn(*args), reps=10) for fn in (a, b, b, a)]


def ms_line(t):
    return " / ".join(f"{v:.4f}" for v in t)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old_csrc", type=Path)
    parser.add_argument("--patch", type=patch_arg, action="append", default=[],
                        help="TREE:FROM=>TO: also time TREE's kernel with FROM replaced by TO")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_mlp_designs: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    old_csrc = args.old_csrc.resolve()
    dev = torch.device("cuda")
    print(f"gpu: {cs.gpu_line()}; old sources {old_csrc}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        trees = [("old", old_csrc), ("new", cuda_lib.CSRC_DIR)]
        for i, (tree, a, b) in enumerate(args.patch):
            name = f"{tree}+patch{i}"
            trees.append((name, patched(old_csrc if tree == "old" else cuda_lib.CSRC_DIR, tmp,
                                        name, a, b)))
        built = build(trees, tmp)
        fns = {tag: caller(lib) for tag, (lib, _) in built.items()}
        for tag, (lib, report) in built.items():
            print(f"{tag} build: HMMA instructions in SASS: {hmma_count(lib)}; ptxas: "
                  + " | ".join(report), flush=True)
        variants = [(f"{tree}+patch{i}", tree, fns[f"{tree}+patch{i}"])
                    for i, (tree, _, _) in enumerate(args.patch)]
        for i, (_, a, b) in enumerate(args.patch):
            print(f"patch{i}: {a!r} => {b!r}", flush=True)
        for name, (_, dims, act, tags) in SHAPES.items():
            for tag in tags:
                occ = fused_mlp_cuda.occupancy(dims, DTYPES[tag], act)
                print(f"new {name} {tag}: {occ}", flush=True)

        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
        for name, (Q, dims, act, tags) in SHAPES.items():
            x = torch.randn((Q, dims[0]), generator=gen, device=dev)
            w32 = [torch.randn((a, b), generator=gen, device=dev) / a**0.5
                   for a, b in zip(dims[:-1], dims[1:])]
            for tag in tags:
                ws = [w.to(DTYPES[tag]) for w in w32]
                bound, by = cs.mlp_bound(x, ws, cs.BF16_FLOPS if tag == "bf16" else cs.FP32_FLOPS)
                worst = [cs.mlp_worst(fns[t](x, ws, act), x, ws, act)[1] for t in ("old", "new")]
                new = fns["new"](x, ws, act)
                repeats = torch.equal(new.view(torch.int32), fns["new"](x, ws, act).view(torch.int32))
                print(f"fused_mlp {name} {tag} Q={Q} {dims} {act}: old / new / new / old "
                      f"{ms_line(in_turns(fns['old'], fns['new'], x, ws, act))} ms; bound "
                      f"{bound:.4f} ms by {by}; worst err / (r S + 1e-6): old {worst[0]:.3f}, "
                      f"new {worst[1]:.3f}; new repeats bit for bit: {repeats}", flush=True)
                if not (max(worst) <= 1.0 and repeats):
                    raise AssertionError(f"a fused_mlp design disagrees or does not repeat "
                                         f"({name} {tag})")
                del new
                for vname, base, fv in variants:
                    w = cs.mlp_worst(fv(x, ws, act), x, ws, act)[1]
                    print(f"fused_mlp {name} {tag} {vname}: {base} / {vname} / {vname} / {base} "
                          f"{ms_line(in_turns(fns[base], fv, x, ws, act))} ms; worst err / "
                          f"(r S + 1e-6) {w:.3f}", flush=True)
                    if not w <= 1.0:
                        raise AssertionError(f"fused_mlp {vname} disagrees ({name} {tag})")
            del x, w32
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
