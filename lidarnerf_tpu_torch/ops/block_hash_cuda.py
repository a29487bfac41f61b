"""Wrappers of the block-hash kernels (`csrc/block_hash_*.cu`).

Each replaces a TPU kernel of lidarnerf_tpu/ops/block_hash_pallas.py together
with its XLA prep, and has a plain PyTorch version in `block_hash.py`:

| wrapper | kernel | replaces | plain version |
|---|---|---|---|
| `block_hash_fwd` | B1 | `_fwd_from_prep` | `encode_plain` |
| `block_hash_bwd` | B2 | `_bwd_from_prep` | `encode_bwd_plain` |
| `block_hash_seg_fwd` | B3a | `_fwd_seg_from_prep` + `seg_next` | `encode_plain` |
| `block_hash_seg_bwd` | B3b | `_bwd_seg_from_prep` | `encode_bwd_seg_plain` |
| `block_hash_win_fwd` | B4a | `_fwd_win_from_prep` + `pack_win_flags` | `encode_plain` |
| `block_hash_win_bwd` | B4b | `_bwd_win_from_prep` | `encode_bwd_win_plain` |

The backward wrappers' table gradient is the same bit for bit from run to
run: their kernels add through an order-free fixed-point accumulator in a
scratch buffer the wrapper allocates (`csrc/block_hash_scatter.cuh`). The
wrappers never fall back to the plain versions: they launch the kernel
or raise. Each has its own launch count (`launches`, `bwd_launches`,
`seg_fwd_launches`, `seg_bwd_launches`, `win_fwd_launches`,
`win_bwd_launches`; `launch_counts()` reads all six), so a run can show that
its main path went through the kernels; `device_counts` counts them on the
card, graph replays included.
"""

import ctypes

import torch

from lidarnerf_tpu_torch.ops import block_hash, cuda_lib, device_counts

SOURCE = "block_hash_fwd.cu"
BWD_SOURCE = "block_hash_bwd.cu"
SEG_FWD_SOURCE = "block_hash_seg_fwd.cu"
SEG_BWD_SOURCE = "block_hash_seg_bwd.cu"
WIN_FWD_SOURCE = "block_hash_win_fwd.cu"
WIN_BWD_SOURCE = "block_hash_win_bwd.cu"
SOURCES = (SOURCE, BWD_SOURCE, SEG_FWD_SOURCE, SEG_BWD_SOURCE, WIN_FWD_SOURCE, WIN_BWD_SOURCE)
HEADER = "block_hash_common.cuh"
MAX_LEVELS = 32  # csrc/block_hash_common.cuh MAX_LEVELS

launches = 0  # block_hash_fwd (B1)
bwd_launches = 0  # block_hash_bwd (B2)
seg_fwd_launches = 0  # block_hash_seg_fwd (B3a)
seg_bwd_launches = 0  # block_hash_seg_bwd (B3b)
win_fwd_launches = 0  # block_hash_win_fwd (B4a)
win_bwd_launches = 0  # block_hash_win_bwd (B4b)
_COUNTERS = {"block_hash_fwd": "launches", "block_hash_bwd": "bwd_launches",
             "block_hash_seg_fwd": "seg_fwd_launches", "block_hash_seg_bwd": "seg_bwd_launches",
             "block_hash_win_fwd": "win_fwd_launches", "block_hash_win_bwd": "win_bwd_launches"}

_fns = {}  # C entry point name -> bound function, loaded (and built) at first launch
_c_levels = {}  # (spec, variant) -> ctypes per-level arrays, kept alive while in use


def launch_counts() -> dict:
    """{kernel name: launches so far} for all six wrappers."""
    return {name: globals()[var] for name, var in _COUNTERS.items()}


def reset_counts():
    for var in _COUNTERS.values():
        globals()[var] = 0


def _kernel(source, name, runs=False, scratch=False):
    if name in _fns:
        return _fns[name]
    fn = getattr(cuda_lib.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x [Q, 3] f32
        ctypes.c_void_p,  # fwd: table [L*B, 128] f32; bwd: g [Q, 2L] f32
        ctypes.c_void_p,  # fwd: out [Q, 2L] f32; bwd: grad [L*B, 128] f32
        *([ctypes.c_void_p] if scratch else []),  # bwd: the accumulator's scratch
        ctypes.c_longlong,  # Q
        ctypes.c_int,  # L
        ctypes.c_int,  # B, blocks per level
        ctypes.POINTER(ctypes.c_float),  # scale [L] (host)
        ctypes.POINTER(ctypes.c_int),  # max_cell [L] (host)
        ctypes.POINTER(ctypes.c_int),  # blocks_axis [L] (host)
        ctypes.POINTER(ctypes.c_int),  # dense [L] (host)
        *([ctypes.POINTER(ctypes.c_int)] if runs else []),  # runs [L] (host), seg/win only
        ctypes.c_void_p,  # cudaStream_t
    ]
    _fns[name] = fn
    return fn


def _level_arrays(spec, variant="default"):
    """The per-level host arrays of a launch; seg and win add each level's
    run mode: 1 if the level walks runs (scale <= SEG_SCALE_MAX) for seg,
    its window size for win."""
    key = (spec, variant)
    if key not in _c_levels:
        L = spec.num_levels
        arrays = [
            (ctypes.c_float * L)(*[lv.scale for lv in spec.levels]),
            (ctypes.c_int * L)(*[lv.max_cell for lv in spec.levels]),
            (ctypes.c_int * L)(*[lv.blocks_axis for lv in spec.levels]),
            (ctypes.c_int * L)(*[int(lv.dense) for lv in spec.levels]),
        ]
        if variant == "seg":
            arrays.append((ctypes.c_int * L)(
                *[int(lv.scale <= block_hash.SEG_SCALE_MAX) for lv in spec.levels]))
        elif variant == "win":
            arrays.append((ctypes.c_int * L)(
                *[block_hash.win_of_level(lv.scale) for lv in spec.levels]))
        _c_levels[key] = tuple(arrays)
    return _c_levels[key]


def _check(name, x, other, other_name, other_shape, spec):
    """The checks all wrappers share: device, dtype, shape, contiguity, levels."""
    if not (x.is_cuda and other.is_cuda and x.device == other.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 (got {x.dtype}, {other.dtype})")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [Q, 3], got {tuple(x.shape)}")
    if tuple(other.shape) != other_shape:
        raise ValueError(f"{other_name} must be {list(other_shape)}, got {tuple(other.shape)}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if spec.num_levels > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {spec.num_levels}")


def _launch(name, source, variant, x, other, out, spec, scratch=None):
    """Launch kernel `name` of `source` on the current stream; raise on failure."""
    fn = _kernel(source, name, runs=variant != "default", scratch=scratch is not None)
    extra = () if scratch is None else (scratch.data_ptr(),)
    err = cuda_lib.launch(fn, x.device, x.data_ptr(), other.data_ptr(), out.data_ptr(), *extra,
                          x.shape[0], spec.num_levels, spec.blocks_per_level,
                          *_level_arrays(spec, variant))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    device_counts.add(name, x.device)


def _fwd(name, source, variant, x, table, spec):
    """The forward wrappers' shared body; returns (out, launched)."""
    _check(name, x, table, "table", (spec.table_rows, 128), spec)
    if table.data_ptr() % 16:
        raise ValueError(f"{name} reads the table as float4s: it must be 16-byte aligned")
    block_hash.check_even_levels(spec, variant)
    out = torch.empty((x.shape[0], spec.output_dim), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out, False
    _launch(name, source, variant, x, table, out, spec)
    return out, True


def scratch_words(spec) -> int:
    """int64 words of a backward call's scratch (block_hash_scatter.cuh
    fixed_scratch_bytes): the fixed-point sums of the table, M and a flag."""
    return spec.table_rows * 128 + 2


def _bwd(name, source, variant, x, g, spec):
    """The backward wrappers' shared body: the kernel call zeroes the output
    and the scratch itself. Returns (grad, launched)."""
    _check(name, x, g, "g", (x.shape[0], spec.output_dim), spec)
    if g.data_ptr() % 8:
        raise ValueError(f"{name} reads g as float2s: it must be 8-byte aligned")
    block_hash.check_even_levels(spec, variant)
    if x.shape[0] == 0:
        return torch.zeros((spec.table_rows, 128), dtype=torch.float32, device=x.device), False
    grad = torch.empty((spec.table_rows, 128), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_words(spec), dtype=torch.int64, device=x.device)
    _launch(name, source, variant, x, g, grad, spec, scratch)
    return grad, True


def block_hash_fwd(x: torch.Tensor, table: torch.Tensor, spec) -> torch.Tensor:
    """B1: [Q, 3] float32 points, [L*B, 128] float32 table -> [Q, 2L] float32 features.

    Points outside [0, 1]^3 give zero features. Launches on the current stream.
    """
    global launches
    out, launched = _fwd("block_hash_fwd", SOURCE, "default", x, table, spec)
    launches += launched
    return out


def block_hash_bwd(x: torch.Tensor, g: torch.Tensor, spec) -> torch.Tensor:
    """B2: [Q, 3] float32 points, [Q, 2L] float32 feature grads -> [L*B, 128] table gradient.

    Points outside [0, 1]^3 contribute nothing. The same inputs give the
    same gradient bit for bit. Launches on the current stream.
    """
    global bwd_launches
    grad, launched = _bwd("block_hash_bwd", BWD_SOURCE, "default", x, g, spec)
    bwd_launches += launched
    return grad


def block_hash_seg_fwd(x: torch.Tensor, table: torch.Tensor, spec) -> torch.Tensor:
    """B3a: `block_hash_fwd`'s function, one table-row load per run of equal rows.

    Equal to `block_hash_fwd` bit for bit. Needs an even level count.
    """
    global seg_fwd_launches
    out, launched = _fwd("block_hash_seg_fwd", SEG_FWD_SOURCE, "seg", x, table, spec)
    seg_fwd_launches += launched
    return out


def block_hash_seg_bwd(x: torch.Tensor, g: torch.Tensor, spec) -> torch.Tensor:
    """B3b: `block_hash_bwd`'s function, one set of adds per run of equal rows."""
    global seg_bwd_launches
    grad, launched = _bwd("block_hash_seg_bwd", SEG_BWD_SOURCE, "seg", x, g, spec)
    seg_bwd_launches += launched
    return grad


def block_hash_win_fwd(x: torch.Tensor, table: torch.Tensor, spec) -> torch.Tensor:
    """B4a: `block_hash_fwd`'s function, one table-row load per uniform window.

    Equal to `block_hash_fwd` bit for bit. Needs an even level count.
    """
    global win_fwd_launches
    out, launched = _fwd("block_hash_win_fwd", WIN_FWD_SOURCE, "win", x, table, spec)
    win_fwd_launches += launched
    return out


def block_hash_win_bwd(x: torch.Tensor, g: torch.Tensor, spec) -> torch.Tensor:
    """B4b: `block_hash_bwd`'s function, one set of adds per uniform window."""
    global win_bwd_launches
    grad, launched = _bwd("block_hash_win_bwd", WIN_BWD_SOURCE, "win", x, g, spec)
    win_bwd_launches += launched
    return grad


# the kernels of each encoder variant (block_hash.VARIANTS)
FWD = {"default": block_hash_fwd, "seg": block_hash_seg_fwd, "win": block_hash_win_fwd}
BWD = {"default": block_hash_bwd, "seg": block_hash_seg_bwd, "win": block_hash_win_bwd}
