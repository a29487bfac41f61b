#!/usr/bin/env python3
"""Time two designs of the port's block-hash kernels B1 and B2 on one GPU, in turns.

    python3 tools/torch_block_hash_designs.py OLD_CSRC

OLD_CSRC is a `lidarnerf_tpu_torch/csrc` directory of another tree (for
example an earlier commit unpacked with `git archive` into a git-ignored
directory). Its `block_hash_fwd.cu` and `block_hash_bwd.cu` are built with
the port's nvcc flags beside this tree's, and both are called through their
C entry points on the same inputs, at the main paths' shapes: the coarse
call of a served chunk (B1) or a training chunk (B2), 4096 rays x 768
samples; the fine call's 262,144 queries; the `--fast` coarse call, 4096 x
192; 3,145,728 uniform points; the `--fast` grid refresh, 128^3 points in
grid order. Each shape is timed old, new, new, old; B1's two outputs must
be equal bit for bit, and each B2 within 1e-5 S + 1e-7 of `encode_bwd_plain`
(S its sum of absolute terms). Needs a GPU and nvcc; imports no JAX.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from lidarnerf_tpu_torch.ops import block_hash_cuda as bhc  # noqa: E402
from lidarnerf_tpu_torch.ops import cuda_lib  # noqa: E402
from lidarnerf_tpu_torch.ops.block_hash import encode_bwd_plain, make_block_hash_spec  # noqa: E402

N_FINE = cs.FULL.max_ray_batch * cs.FULL.upsample_steps
FAST_STEPS = cs.FAST["num_steps"]


def build_old(csrc: Path, out_dir: Path) -> dict:
    """{name: C entry point} of OLD_CSRC's B1 and B2, built like cuda_lib.build."""
    fns = {}
    for name in ("block_hash_fwd", "block_hash_bwd"):
        lib = out_dir / f"old_{name}.so"
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib),
                        str(csrc / f"{name}.cu")], check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(str(lib)), name)
        new = bhc._kernel(bhc.SOURCE if name == "block_hash_fwd" else bhc.BWD_SOURCE, name)
        fn.restype, fn.argtypes = new.restype, new.argtypes
        fns[name] = fn
    return fns


def caller(fn, spec, fwd):
    """A call of C entry point `fn` that allocates its output as the wrapper does."""
    arrays = bhc._level_arrays(spec)

    def call(x, other):
        out = (torch.empty((x.shape[0], spec.output_dim), device=x.device) if fwd
               else torch.zeros((spec.table_rows, 128), device=x.device))
        err = fn(x.data_ptr(), other.data_ptr(), out.data_ptr(), x.shape[0], spec.num_levels,
                 spec.blocks_per_level, *arrays, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    return call


def refresh_points(dev, gen, G=128):
    idx = torch.arange(G, dtype=torch.float32, device=dev)
    cell = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    return ((cell + torch.rand(cell.shape, generator=gen, device=dev)) / G).contiguous()


def in_turns(old, new, *args):
    """(old ms, new ms, new ms, old ms) of one call each on the same inputs."""
    t = []
    for fn in (old, new, new, old):
        t.append(cs.cuda_ms(lambda: fn(*args), reps=10))
    return t


def main():
    if not torch.cuda.is_available():
        print("torch_block_hash_designs: no CUDA device is available", file=sys.stderr)
        return 1
    old_csrc = Path(sys.argv[1]).resolve()
    dev = torch.device("cuda")
    spec = make_block_hash_spec(log2_hashmap_size=cs.FULL.log2_hashmap_size,
                                desired_resolution=cs.FULL.desired_resolution)
    with tempfile.TemporaryDirectory() as tmp:
        old = build_old(old_csrc, Path(tmp))
        print(f"gpu: {cs.gpu_line()}; old sources {old_csrc}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 13)
        table = torch.randn((spec.table_rows, 128), generator=gen, device=dev)
        served = cs.serving_chunk_queries(dev)
        uniform = torch.rand((served.shape[0], 3), generator=gen, device=dev) * 1.1 - 0.05
        refresh = refresh_points(dev, gen)
        fwd_shapes = {"coarse": served, "fine": served[:N_FINE],
                      "fast": cs.serving_chunk_queries(dev, FAST_STEPS), "uniform": uniform,
                      "refresh": refresh}
        fo, fn = (caller(old["block_hash_fwd"], spec, True),
                  caller(bhc._kernel(bhc.SOURCE, "block_hash_fwd"), spec, True))
        for name, x in fwd_shapes.items():
            same = torch.equal(fo(x, table), fn(x, table))
            t = in_turns(fo, fn, x, table)
            print(f"B1 {name} Q={x.shape[0]}: old / new / new / old "
                  f"{' / '.join(f'{v:.4f}' for v in t)} ms; equal bit for bit: {same}", flush=True)
            if not same:
                raise AssertionError(f"the two B1 designs disagree ({name})")

        ds = cs.synth_drive()
        train_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
        training = cs.training_chunk_queries(ds, dev, train_gen)
        bwd_shapes = {"coarse": training, "fine": training[:N_FINE],
                      "fast": cs.training_chunk_queries(ds, dev, train_gen, FAST_STEPS),
                      "uniform": uniform, "refresh": refresh}
        bo, bn = (caller(old["block_hash_bwd"], spec, False),
                  caller(bhc._kernel(bhc.BWD_SOURCE, "block_hash_bwd"), spec, False))
        for name, x in bwd_shapes.items():
            g = torch.randn((x.shape[0], spec.output_dim), generator=gen, device=dev)
            ref = encode_bwd_plain(x, g, spec)
            slack = cs.BWD_RTOL * encode_bwd_plain(x, g.abs(), spec) + cs.BWD_ATOL
            worst = [((f(x, g) - ref).abs() / slack).max().item() for f in (bo, bn)]
            del ref, slack
            t = in_turns(bo, bn, x, g)
            print(f"B2 {name} Q={x.shape[0]}: old / new / new / old "
                  f"{' / '.join(f'{v:.4f}' for v in t)} ms; worst err / (1e-5 S + 1e-7): "
                  f"old {worst[0]:.3f}, new {worst[1]:.3f}", flush=True)
            if not max(worst) <= 1.0:
                raise AssertionError(f"a B2 design disagrees with encode_bwd_plain ({name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
