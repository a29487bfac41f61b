#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lidarnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the ported paths from `lidarnerf_tpu_torch/csrc`
(the block-hash forward B1 and backward B2, their run-collapsing variants:
segmented B3a/B3b and windowed B4a/B4b, the fused MLP B5 and the
permutation gather B6), holds each against its plain PyTorch version on the
card at the main paths' shapes, then drives the main paths at the full width
of the KITTI-360 model (16-level 2^19 block-hash grid, width-64 bf16 MLPs,
768 + 64 samples, 4096-ray chunks, 66 x 1030 panos):
  - fused-mlp: `fused_mlp` on the model's own sigma net and LiDAR head at a
    served chunk's shapes, f32 and bf16, and one backward (B5);
  - sort-merge: `sort_merge_z` forward and backward on a training chunk's
    768 + 64 and --fast 192 + 64 samples (B6, both directions);
  - serving: full-pano LiDAR rendering through `PanoRenderer`, with weights
    made from a seed;
  - training: `Trainer` on the synthetic KITTI-360-format drive in
    `data_synth_drive60/` for three epochs (patch 1, patch [2, 8], patch 1),
    from the port's seeded init, then a render of a training frame from the
    trained weights;
  - serving-seg, serving-win, training-seg, training-win: one pano and one
    60-step epoch under each variant switch (`LIDARNERF_SEG_KERNELS=1`,
    `LIDARNERF_WIN_KERNELS=1`), held against the default variant;
  - training-fast, serving-fast: `Trainer` with occupancy-prior sampling
    (`--fast`: 192 + 64 samples, a 128^3 grid refreshed every 16 steps) for
    the same three epochs, then `PanoRenderer` on frame 0 with its grid.
It checks that each path went through its kernels and that its output is
right, and profiles one render chunk and one training step per variant.
B1 and B2 are also checked on adversarial point sets (one cell, runs
crossing warp and tile ends, reversed and permuted orders, samples on the
faces of the unit cube, one query) and timed in turns with the
run-collapsing kernels that compute the same functions. A determinism
phase calls each backward kernel (B2, B3b, B4b) twice on a training chunk,
1024 copies of one point and the adversarial sets, and with non-finite
grads, and takes one full-width training step twice per variant from the
same state and draws, comparing each pair bit for bit.
Prints one JSON line of per-kernel numbers and ends with a JSON status line.
Exits non-zero, with no result, when there is no GPU or when any phase fails.
"""

import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

SEED = 0
H, W = 66, 1030
INTRINSICS = (2.0, 26.9)
FULL = SimpleNamespace(
    encoding="blockhash", desired_resolution=32768, log2_hashmap_size=19,
    num_layers=2, hidden_dim=64, geo_feat_dim=15, bound=1.0,
    scale=0.010784853507573345, num_steps=768, upsample_steps=64,
    max_ray_batch=4096, fp16=True, alpha_r=1.0,
)
N_PANOS = 2
DATA = "data_synth_drive60"  # 60 train frames of a synthetic KITTI-360-format drive
TRAIN_EPOCHS = 3  # 60 steps each: patch 1, patch [2, 8], patch 1
TRAIN_OPT = dict(  # configs/kitti360_1908.txt under the -L CLI defaults (main_lidarnerf.py)
    alpha_d=1000.0, alpha_r=1.0, alpha_i=10.0, alpha_grad_norm=1.0, alpha_spatial=0.1,
    alpha_tv=1.0, alpha_grad=100.0, depth_loss="l1", depth_grad_loss="l1",
    intensity_loss="mse", raydrop_loss="mse", spatial_smooth=False, grad_norm_smooth=False,
    tv_loss=False, grad_loss=True, sobel_grad=False, num_rays_lidar=4096, lr=1e-2,
    iters=30000, patch_size_lidar=1, change_patch_size_lidar=[2, 8],
    change_patch_size_epoch=2, seed=SEED,
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
KERNEL_ATOL = 1e-5  # fp32, the same products, 8 corners summed in another order
# B5 vs its plain version, entry by entry: |k - p| <= MLP_RTOL * S + 1e-6 with S
# the plain chain on |x| and |W| (a bound on the sum of absolute terms). bf16
# weights: a sum taken in another order may round an intermediate to the other
# neighbouring bf16 value
MLP_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
# the --fast macro (main_lidarnerf.py:282-284) at the CLI's occupancy defaults
FAST = dict(occ_sampling=True, num_steps=192, occ_grid_size=128, occ_update_interval=16,
            occ_bins=128, occ_floor=0.05, occ_dilate=1, density_thresh=10.0)
ADVERSARIAL_Q = 20013  # the adversarial point sets' size: no multiple of 32 or of a tile
# B2 vs its plain version, entry by entry: |k - p| <= BWD_RTOL * S + BWD_ATOL with
# S the plain version on |g|: the trilinear weights are non-negative, so S is
# the sum of the absolute terms of each entry, a bound on any summation order
BWD_RTOL, BWD_ATOL = 1e-5, 1e-7
# one fp32 training step on the GPU (kernels, atomics) vs the CPU (plain
# versions), same weights and draws: the loss, and each gradient relative to
# its tensor's largest entry. The sums over samples and the table's duplicate
# rows run in another order; the LiDAR head reads the degree-12 frequency
# encoding of the directions, whose sin(2^11 d) carries the two libms' ulp
# differences in the trig into its input at ~1e-4
TRAIN_REF_LOSS_RTOL = 1e-4
TRAIN_REF_GRAD_TOL = {"lidar_color_net": 5e-3, "default": 1e-3}
# fp32 GPU vs fp32 CPU render of the same rays: the log-transmittance is an
# exclusive cumsum of 768 terms of up to ~35 in size, taken in another order
# on each device, which moves the weights by up to ~1e-3 relative
REF_RTOL, REF_ATOL = 1e-3, 1e-5
VARIANT_ENV = {"seg": "LIDARNERF_SEG_KERNELS", "win": "LIDARNERF_WIN_KERNELS"}
# the variant kernels: name -> (variant, source, TPU kernel it replaces)
VARIANT_KERNELS = {
    "block_hash_seg_fwd": ("seg", "block_hash_seg_fwd.cu", "block_hash_pallas.py:479"),
    "block_hash_seg_bwd": ("seg", "block_hash_seg_bwd.cu", "block_hash_pallas.py:592"),
    "block_hash_win_fwd": ("win", "block_hash_win_fwd.cu", "block_hash_pallas.py:875"),
    "block_hash_win_bwd": ("win", "block_hash_win_bwd.cu", "block_hash_pallas.py:958"),
}


def log(msg):
    print(msg, flush=True)


def set_variant(variant):
    """Set the block-hash variant switches as `variant` ("default", "seg" or "win") needs."""
    for name in VARIANT_ENV.values():
        os.environ.pop(name, None)
    if variant != "default":
        os.environ[VARIANT_ENV[variant]] = "1"


def launch_counts():
    """{kernel name: launches so far} of every kernel wrapper of the port."""
    from lidarnerf_tpu_torch.ops import block_hash_cuda, fused_mlp_cuda, perm_gather_cuda

    return {**block_hash_cuda.launch_counts(), **fused_mlp_cuda.launch_counts(),
            **perm_gather_cuda.launch_counts()}


def reset_counts():
    from lidarnerf_tpu_torch.ops import block_hash_cuda, fused_mlp_cuda, perm_gather_cuda

    for module in (block_hash_cuda, fused_mlp_cuda, perm_gather_cuda):
        module.reset_counts()


def only_launches(counts, expected):
    """Raise unless `counts` (launch_counts()) holds exactly `expected`
    launches and none of any other kernel."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, batches=5, warmup=2):
    """Device time of one fn() call: the median over `batches` of the mean of
    `reps` back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def smooth_dense_levels(table, spec):
    """Write a smooth O(1) field into the dense levels of a block-hash table.

    Each corner of a dense level gets a smooth function of its position, so
    the corners that neighbouring blocks both store agree and the encoded
    field is continuous: densities then vary across the scene without the
    jumps that random O(1) rows would put at every block seam.
    """
    lane = np.arange(128)
    s = np.stack([lane >> 5, (lane >> 3) & 3, (lane >> 1) & 3], -1)  # corner in block
    ch = lane & 1
    for li, level in enumerate(spec.levels):
        if not level.dense:
            continue
        nb = level.blocks_axis
        blk = np.stack(np.unravel_index(np.arange(nb**3), (nb, nb, nb)), -1)
        corner = 3 * blk[:, None, :] + s[None]  # [rows, 128, 3] global corner
        p = 2.0 * (corner - 0.5) / level.scale - 1.0  # its position in [-1, 1]^3
        v = np.where(ch == 0, np.sin(4 * p[..., 0] + 3 * p[..., 1]) + np.cos(5 * p[..., 2]),
                     np.cos(3 * p[..., 0] - 4 * p[..., 2]) * np.sin(2 * p[..., 1]))
        off = li * spec.blocks_per_level
        table[off: off + nb**3] = v.astype(np.float32)


def flax_layout_params(seed, opt):
    """A parameter tree in the JAX package's flax layout, drawn from `seed`.

    Distributions follow the JAX package's init (table Uniform(+-1e-4),
    Dense kernels [in, out] Uniform(+-1/sqrt(in))), except that the dense
    table levels hold a smooth field and the density output is sharpened, so
    the rendered geometry varies from ray to ray.
    """
    from lidarnerf_tpu_torch.ops.block_hash import make_block_hash_spec

    rng = np.random.default_rng(seed)
    spec = make_block_hash_spec(log2_hashmap_size=opt.log2_hashmap_size,
                                desired_resolution=opt.desired_resolution)

    def mlp(dims):
        return {
            f"Dense_{i}": {"kernel": rng.uniform(-1, 1, (a, b)).astype(np.float32) / np.sqrt(a)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
        }

    g, hd = opt.geo_feat_dim, opt.hidden_dim
    table = rng.uniform(-1e-4, 1e-4, (spec.table_rows, 128)).astype(np.float32)
    smooth_dense_levels(table, spec)
    sigma_net = mlp([spec.output_dim] + [hd] * (opt.num_layers - 1) + [1 + g])
    sigma_net[f"Dense_{opt.num_layers - 1}"]["kernel"][:, 0] *= 8.0
    return {"params": {
        "hash_table": table,
        "sigma_net": sigma_net,
        "color_net": mlp([16 + g, 64, 64, 3]),
        "lidar_color_net": mlp([75 + g, 64, 64, 2]),
    }}


def drive_poses(n):
    """Lidar2world poses along a short straight drive with a slow yaw."""
    poses = []
    for k in range(n):
        a = 0.05 * k
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        pose[:3, 3] = [0.02 * k - 0.01, 0.003 * k, 0.0]
        poses.append(pose)
    return poses


def synth_drive():
    """The training set: KITTI360Dataset on data_synth_drive60 with its scene constants."""
    from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset

    with open(f"{DATA}/scene_constants.json") as f:
        c = json.load(f)
    return KITTI360Dataset(root_path=DATA, split="train", scale=c["scale"], offset=c["offset"])


def touched_rows(x, spec):
    """The number of distinct table rows the in-range queries of x touch."""
    from lidarnerf_tpu_torch.ops.block_hash import level_indices_and_weights

    inside = ~((x < 0) | (x > 1)).any(-1)
    rows = [level_indices_and_weights(x[inside], lv, li, spec)[0]
            for li, lv in enumerate(spec.levels)]
    return torch.unique(torch.cat(rows)).numel()


def bound_of(bytes_moved, flops):
    """(least ms, "bytes" or "operations") at the H100's memory and fp32 rates."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fwd_bound(x, spec, n_rows):
    """B1's function (also B3a's, B4a's): x read once, the features written
    once, each touched 512-byte table row read once; ~60 flops per query-level."""
    Q, L = x.shape[0], spec.num_levels
    bytes_moved = Q * 12 + Q * 2 * L * 4 + n_rows * 512
    return (*bound_of(bytes_moved, Q * L * 60), bytes_moved)


def bwd_bound(x, spec):
    """B2's function (also B3b's, B4b's): x and g read once, the whole
    [L*B, 128] gradient written once; ~80 flops per query-level (cell, hash
    and weights, 8 corners x (weight, 2 products, 2 adds))."""
    Q, L = x.shape[0], spec.num_levels
    bytes_moved = Q * 12 + Q * 2 * L * 4 + spec.table_rows * 128 * 4
    return (*bound_of(bytes_moved, Q * L * 80), bytes_moved)


def serving_chunk_queries(dev, steps=FULL.num_steps):
    """The coarse queries of the first 4096-ray chunk of a served pano, at
    `steps` samples per ray (768, or 192 under --fast)."""
    from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
    from lidarnerf_tpu_torch.ops.sampling import stratified_z_vals

    pose = torch.from_numpy(drive_poses(1)[0]).to(dev)
    rays = get_lidar_rays(pose[None], INTRINSICS, H, W)
    o = rays["rays_o"][0, : FULL.max_ray_batch]
    d = rays["rays_d"][0, : FULL.max_ray_batch]
    near = torch.full((o.shape[0], 1), FULL.scale, device=dev)
    z = stratified_z_vals(near, near * 81.0, steps)
    xyz = torch.clamp(o[:, None] + d[:, None] * z[..., None], -FULL.bound, FULL.bound)
    return ((xyz + FULL.bound) / (2 * FULL.bound)).reshape(-1, 3).contiguous()


def adversarial_points(dev, seed=SEED + 11):
    """The point sets of tests/test_torch_cuda.py that the tile layout of B1
    and B2 must not be fooled by: every query in one cell (the worst
    contention), rays of 333 samples (runs crossing warp and tile ends, Q no
    multiple of 32), the same in reverse and in a random order (no runs of
    lanes), rays clamped onto the faces of [0, 1]^3 with some left outside,
    and a single query."""
    rs = np.random.RandomState(seed)
    Q, per = ADVERSARIAL_Q, 333
    n = -(-Q // per)
    o = rs.uniform(0.3, 0.7, (n, 1, 3))
    d = rs.normal(size=(n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = (o + d * np.linspace(0.0, 0.5, per)[None, :, None]).reshape(-1, 3)[:Q]
    faces = (o + d * np.linspace(0.0, 1.5, per)[None, :, None]).reshape(-1, 3)[:Q]
    clamped = np.repeat(rs.uniform(size=n) < 0.9, per)[:Q]
    faces[clamped] = np.clip(faces[clamped], 0.0, 1.0)
    sets = {"one cell": np.repeat(rs.uniform(size=(1, 3)), Q, axis=0), "ray runs": rays,
            "reversed": rays[::-1], "permuted": rays[rs.permutation(Q)], "faces": faces,
            "one query": rs.uniform(size=(1, 3))}
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(dev)
            for k, v in sets.items()}


def in_turns(fns, reps=10):
    """Device ms of each of `fns` ({name: fn}) timed in turns, a b c c b a:
    {name: (first, second)}."""
    order = list(fns) + list(fns)[::-1]
    times = {}
    for name in order:
        times.setdefault(name, []).append(cuda_ms(fns[name], reps=reps))
    return {k: tuple(v) for k, v in times.items()}


def turns_line(times):
    return ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items())


def level_range(spec, lo, hi):
    """The spec of levels lo ... hi - 1 alone, with their scales and block
    grids: a kernel launched with it does exactly those levels' work."""
    return replace(spec, num_levels=hi - lo, levels=spec.levels[lo:hi])


FINE_LEVEL0 = 11  # levels from here on rarely repeat a row along a ray (run structure phase)


def block_hash_phase(spec):
    """B1 vs its plain version on the coarse queries of one real chunk, on
    uniform ones and on the adversarial point sets (there also bit for bit
    against B3a and B4a); timed in turns with B3a and B4a at the coarse, fine,
    --fast coarse and uniform shapes. Returns the kernel's `kernels` entry
    (launches filled later)."""
    from lidarnerf_tpu_torch.ops import block_hash_cuda
    from lidarnerf_tpu_torch.ops.block_hash import encode_plain

    dev = torch.device("cuda")
    coarse = serving_chunk_queries(dev)
    Q = coarse.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    uniform = torch.rand((Q, 3), generator=g, device=dev) * 1.1 - 0.05
    table = torch.randn((spec.table_rows, 128), generator=g, device=dev)

    max_err = 0.0
    for name, x in (("ray chunk", coarse), ("uniform", uniform)):
        out = block_hash_cuda.block_hash_fwd(x, table, spec)
        torch.cuda.synchronize()
        ref = encode_plain(x, table, spec)
        err = (out - ref).abs().max().item()
        rel = ((out - ref).abs() / ref.abs().clamp_min(1e-3)).max().item()
        log(f"block_hash_fwd vs plain ({name}, Q={Q}): max_abs_err={err:.3e} "
            f"max_rel_err(|ref|>=1e-3)={rel:.3e} (tol abs {KERNEL_ATOL})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"block_hash_fwd disagrees with its plain version: {err}")
        max_err = max(max_err, err)
        del out, ref
    for name, x in adversarial_points(dev).items():
        out = block_hash_cuda.block_hash_fwd(x, table, spec)
        same = [torch.equal(out, f(x, table, spec)) for f in (block_hash_cuda.block_hash_seg_fwd,
                                                              block_hash_cuda.block_hash_win_fwd)]
        torch.cuda.synchronize()
        err = (out - encode_plain(x, table, spec)).abs().max().item()
        log(f"block_hash_fwd ({name}, Q={x.shape[0]}): max_abs_err={err:.3e} vs plain; equal to "
            f"block_hash_seg_fwd / block_hash_win_fwd bit for bit: {same[0]} / {same[1]}")
        if not (err <= KERNEL_ATOL and all(same)):
            raise AssertionError(f"block_hash_fwd disagrees on the {name} points")
        max_err = max(max_err, err)

    n_rows = touched_rows(coarse, spec)
    bound_ms, bound_by, bytes_moved = fwd_bound(coarse, spec, n_rows)
    plain_ms = cuda_ms(lambda: encode_plain(coarse, table, spec), reps=1, batches=3, warmup=1)
    n_fine = FULL.max_ray_batch * FULL.upsample_steps
    shapes = {"coarse": coarse, "fine": coarse[:n_fine],
              "--fast coarse": serving_chunk_queries(dev, FAST["num_steps"]), "uniform": uniform}
    bh = block_hash_cuda
    for name, x in shapes.items():
        times = in_turns({k: (lambda f=f: f(x, table, spec)) for k, f in (
            ("block_hash_fwd", bh.block_hash_fwd), ("block_hash_seg_fwd", bh.block_hash_seg_fwd),
            ("block_hash_win_fwd", bh.block_hash_win_fwd))})
        b, by, nbytes = fwd_bound(x, spec, touched_rows(x, spec))
        log(f"block_hash_fwd {name} call Q={x.shape[0]} in turns (ms): {turns_line(times)}; "
            f"bound {b:.4f} ms by {by}: {nbytes / 1e6:.1f} MB")
        if name == "coarse":
            ms = times["block_hash_fwd"][0]
    L, B, f0 = spec.num_levels, spec.blocks_per_level, FINE_LEVEL0
    split = {f"levels 0-{f0 - 1}": (0, f0), f"levels {f0}-{L - 1}": (f0, L)}
    by_range = {}
    for k, (lo, hi) in split.items():
        table_range, spec_range = table[lo * B: hi * B], level_range(spec, lo, hi)
        by_range[k] = cuda_ms(lambda: bh.block_hash_fwd(coarse, table_range, spec_range), reps=10)
    log(f"block_hash_fwd coarse call Q={Q}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by}: {bytes_moved / 1e6:.1f} MB incl. "
        f"{n_rows} table rows); each level range alone: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in by_range.items()))
    return {
        "name": "block_hash_fwd",
        "route": "cuda",
        "source": "lidarnerf_tpu_torch/csrc/block_hash_fwd.cu",
        "replaces": "lidarnerf_tpu/ops/block_hash_pallas.py:250",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this encoder
    }


def training_chunk_queries(ds, dev, generator, steps=FULL.num_steps):
    """The perturbed coarse queries of one 4096-ray training chunk of frame 0,
    as the training step forms them, at `steps` samples per ray."""
    from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices
    from lidarnerf_tpu_torch.ops.sampling import stratified_z_vals

    poses, _ = ds.device_arrays(dev)
    n = FULL.max_ray_batch
    inds = sample_ray_indices(ds.H_lidar, ds.W_lidar, n, 1, generator, dev)
    o, d = rays_from_indices(poses[0], inds, ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    near = torch.full((n, 1), ds.scale, device=dev)
    z = stratified_z_vals(near, near * 81.0, steps, perturb=True, generator=generator)
    xyz = torch.clamp(o[:, None] + d[:, None] * z[..., None], -FULL.bound, FULL.bound)
    return ((xyz + FULL.bound) / (2 * FULL.bound)).reshape(-1, 3).contiguous()


def block_hash_bwd_phase(spec, ds):
    """B2 vs its plain version on the coarse queries of one real training
    chunk, on uniform ones and on the adversarial point sets; timed in turns
    with B3b and B4b at the coarse, fine, --fast coarse and uniform shapes.
    Returns the kernel's `kernels` entry."""
    from lidarnerf_tpu_torch.ops import block_hash_cuda
    from lidarnerf_tpu_torch.ops.block_hash import encode_bwd_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    coarse = training_chunk_queries(ds, dev, gen)
    Q = coarse.shape[0]
    uniform = torch.rand((Q, 3), generator=gen, device=dev) * 1.1 - 0.05
    g = torch.randn((Q, spec.output_dim), generator=gen, device=dev)

    max_err = 0.0
    cases = {"training chunk": (coarse, g), "uniform": (uniform, g)}
    for name, x in adversarial_points(dev).items():
        cases[name] = (x, torch.randn((x.shape[0], spec.output_dim), generator=gen, device=dev))
    for name, (x, gx) in cases.items():
        out = block_hash_cuda.block_hash_bwd(x, gx, spec)
        torch.cuda.synchronize()
        ref = encode_bwd_plain(x, gx, spec)
        err = (out - ref).abs()
        slack = BWD_RTOL * encode_bwd_plain(x, gx.abs(), spec) + BWD_ATOL
        worst = (err / slack).max().item()
        log(f"block_hash_bwd vs plain ({name}, Q={x.shape[0]}): max_abs_err={err.max().item():.3e} "
            f"(largest entry {ref.abs().max().item():.3e}), worst err / (1e-5 S + 1e-7) = "
            f"{worst:.3f}")
        if not worst <= 1.0:
            raise AssertionError(f"block_hash_bwd disagrees with its plain version ({name})")
        max_err = max(max_err, err.max().item())
        del out, ref, err, slack

    n_rows = touched_rows(coarse, spec)
    bound_ms, bound_by, bytes_moved = bwd_bound(coarse, spec)
    plain_ms = cuda_ms(lambda: encode_bwd_plain(coarse, g, spec), reps=1, batches=3, warmup=1)
    n_fine = FULL.max_ray_batch * FULL.upsample_steps
    fast = training_chunk_queries(ds, dev, gen, FAST["num_steps"])
    shapes = {"coarse": (coarse, g), "fine": (coarse[:n_fine], g[:n_fine]),
              "--fast coarse": (fast, g[: fast.shape[0]]), "uniform": (uniform, g)}
    bh = block_hash_cuda
    for name, (x, gx) in shapes.items():
        times = in_turns({k: (lambda f=f: f(x, gx, spec)) for k, f in (
            ("block_hash_bwd", bh.block_hash_bwd), ("block_hash_seg_bwd", bh.block_hash_seg_bwd),
            ("block_hash_win_bwd", bh.block_hash_win_bwd))})
        b, by, nbytes = bwd_bound(x, spec)
        log(f"block_hash_bwd {name} call Q={x.shape[0]} in turns (ms, zero fill included): "
            f"{turns_line(times)}; bound {b:.4f} ms by {by}: {nbytes / 1e6:.1f} MB")
        if name == "coarse":
            ms = times["block_hash_bwd"][0]
    L, f0 = spec.num_levels, FINE_LEVEL0
    split = {f"levels 0-{f0 - 1}": (0, f0), f"levels {f0}-{L - 1}": (f0, L)}
    by_range = {}
    for k, (lo, hi) in split.items():
        g_range, spec_range = g[:, 2 * lo: 2 * hi].contiguous(), level_range(spec, lo, hi)
        by_range[k] = cuda_ms(lambda: bh.block_hash_bwd(coarse, g_range, spec_range), reps=10)
    log(f"block_hash_bwd coarse call Q={Q}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}: {bytes_moved / 1e6:.1f} MB; the chunk touches "
        f"{n_rows} table rows); each level range alone (zero fill of its rows included): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in by_range.items()))
    return {
        "name": "block_hash_bwd",
        "route": "cuda",
        "source": "lidarnerf_tpu_torch/csrc/block_hash_bwd.cu",
        "replaces": "lidarnerf_tpu/ops/block_hash_pallas.py:387",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this gradient
    }


def reference_phase(params):
    """fp32 render of a small pano on the GPU (kernel path) vs on the CPU (plain path)."""
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer

    opt = SimpleNamespace(**{**vars(FULL), "fp16": False, "max_ray_batch": 512})
    pose = drive_poses(2)[1]
    gpu = PanoRenderer(opt, params).render_frame(pose, 4, 128, INTRINSICS)
    cpu = PanoRenderer(opt, params, device="cpu").render_frame(pose, 4, 128, INTRINSICS)
    for name, a, b in zip(("raydrop", "intensity", "depth"), gpu, cpu):
        err = float(np.abs(a - b).max())
        log(f"reference: {name} fp32 GPU vs CPU on 4x128 rays: max_abs_err={err:.3e}")
        np.testing.assert_allclose(a, b, rtol=REF_RTOL, atol=REF_ATOL)


def check_pano(frame, near, far):
    """A served pano is finite, [H, W], raydrop and intensity in [0, 1], depth in [near, far]."""
    raydrop, intensity, depth = frame
    for name, a in (("raydrop", raydrop), ("intensity", intensity), ("depth", depth)):
        if a.shape != (H, W) or not np.isfinite(a).all():
            raise AssertionError(f"{name} pano is not a finite {H}x{W} array")
    if not (raydrop.min() >= 0 and raydrop.max() <= 1 and intensity.min() >= 0
            and intensity.max() <= 1):
        raise AssertionError("raydrop/intensity outside [0, 1]")
    # depth = sum(w z) with z in [near, far]; the seeded field is dense
    # enough that every ray's weights sum to nearly 1, so depth >= near
    if not (near <= depth.min() and depth.max() <= far):
        raise AssertionError(f"depth outside [near, far]: {depth.min()} {depth.max()}")
    log(f"pano: depth in [{depth.min():.5f}, {depth.max():.5f}] (near {near:.5f}, "
        f"far {far:.5f}), raydrop mean {raydrop.mean():.4f}, intensity mean "
        f"{intensity.mean():.4f}")


def slice_phase(renderer):
    """The main path: full-width panos through PanoRenderer.

    Returns (launch counts, the first pano)."""
    near, far = FULL.scale, FULL.scale * renderer.cfg.far_mult
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    frames = []
    for pose in drive_poses(N_PANOS):
        t0 = time.perf_counter()
        frames.append(renderer.render_frame(pose, H, W, INTRINSICS))  # ends on the host
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    chunks = -(-H * W // FULL.max_ray_batch)
    for frame in frames:
        check_pano(frame, near, far)
    only_launches(launches, {"block_hash_fwd": 2 * chunks * N_PANOS})
    rays = H * W
    log(f"slice on {gpu_line()}: {N_PANOS} panos of {H}x{W} rays, {FULL.num_steps}+{FULL.upsample_steps} "
        f"samples, chunk {FULL.max_ray_batch}: ms/pano {', '.join(f'{t:.1f}' for t in times)}; "
        f"rays/s (last pano) {rays / (times[-1] / 1e3):.0f}; peak memory "
        f"{peak / 2**30:.2f} GiB; block_hash_fwd launches {launches['block_hash_fwd']}")
    return launches, frames[0]


def train_opt(ds, **kw):
    """Trainer options: the full-width KITTI-360 training config on `ds`."""
    return SimpleNamespace(**{
        **vars(FULL), **TRAIN_OPT, "scale": ds.scale, "min_near_lidar": ds.scale,
        "min_near": ds.scale, "H_lidar": ds.H_lidar, "W_lidar": ds.W_lidar,
        "intrinsics_lidar": ds.intrinsics_lidar, **kw,
    })


def new_model(opt, fp16):
    from lidarnerf_tpu_torch.models.network import NeRFNetwork

    return NeRFNetwork(
        encoding=opt.encoding, desired_resolution=opt.desired_resolution,
        log2_hashmap_size=opt.log2_hashmap_size, num_layers=opt.num_layers,
        hidden_dim=opt.hidden_dim, geo_feat_dim=opt.geo_feat_dim, bound=opt.bound,
        compute_dtype=torch.bfloat16 if fp16 else torch.float32,
        generator=torch.Generator().manual_seed(SEED),
    )


def hit_grid(ds, G):
    """A [G, G, G] occupancy grid of frame 0's returns: 50 in every cell that
    holds one, 0 elsewhere, so no entry lies near the occupancy threshold
    (the mean, which the two devices sum in another order)."""
    from lidarnerf_tpu_torch.dataset.base import get_lidar_rays

    rays = get_lidar_rays(torch.from_numpy(ds.poses_lidar[0])[None], ds.intrinsics_lidar,
                          ds.H_lidar, ds.W_lidar)
    image = torch.from_numpy(ds.images_lidar[0]).reshape(-1, 3)
    hit = image[:, 0] == 1.0
    pts = rays["rays_o"][0][hit] + rays["rays_d"][0][hit] * image[hit, 2:3]
    cell = torch.clamp(torch.floor((pts + 1.0) * (G / 2.0)).long(), 0, G - 1)
    grid = torch.zeros((G,) * 3)
    grid[cell[:, 0], cell[:, 1], cell[:, 2]] = 50.0
    return grid


def train_reference_phase(ds, variant="default", fast=False):
    """One fp32 training step of a small config on the GPU (the variant's
    kernels) vs the CPU (its plain versions), from the same weights with the
    same draws; `fast` samples by occupancy, with one grid (frame 0's
    returns) on both devices.

    The small field's finest level has 64 cells a side: at the full width's
    32768, the devices' one-ulp differences in sample positions (trig,
    sums) move samples across block seams, which routes their gradient to
    other table rows, and the comparison would measure that, not the kernels.
    """
    from lidarnerf_tpu_torch.dataset.base import sample_ray_indices
    from lidarnerf_tpu_torch.models.network import NeRFNetwork
    from lidarnerf_tpu_torch.models.occupancy import OccConfig
    from lidarnerf_tpu_torch.models.renderer import RenderConfig
    from lidarnerf_tpu_torch.nerf.train_step import TrainConfig, make_train_step

    n, T, S, patch = 64, 64, 8, [2, 8]
    opt = train_opt(ds, num_rays_lidar=n)
    cfg = TrainConfig(**{k: getattr(opt, k) for k in TrainConfig.__dataclass_fields__
                         if hasattr(opt, k)})
    occ = OccConfig() if fast else None
    rcfg = RenderConfig(num_steps=T, upsample_steps=S, min_near_lidar=ds.scale,
                        min_near=ds.scale, occ=occ)
    grid = hit_grid(ds, occ.grid_size) if fast else None
    gen = torch.Generator().manual_seed(SEED + 3)
    draws = {"inds": sample_ray_indices(ds.H_lidar, ds.W_lidar, n, patch, gen),
             "noise": torch.rand((n, T), generator=gen), "u": torch.rand((n, S), generator=gen)}
    results = {}
    set_variant(variant)
    for dev in ("cuda", "cpu"):
        net = NeRFNetwork(num_levels=4, log2_hashmap_size=14, desired_resolution=64,
                          hidden_dim=32, generator=torch.Generator().manual_seed(SEED))
        step = make_train_step(net, cfg, rcfg, patch_size=patch, device=dev)
        poses, images = ds.device_arrays(dev)
        vi = torch.zeros((len(ds), 1), dtype=torch.long, device=dev)
        vc = torch.full((len(ds),), ds.H_lidar * ds.W_lidar, device=dev)
        m = step(poses, images, vi, vc, 3, draws={k: v.to(dev) for k, v in draws.items()},
                 occ_grid=None if grid is None else grid.to(dev))
        grads = {k: p.grad.cpu() for k, p in net.named_parameters() if p.grad is not None}
        results[dev] = (float(m["loss"]), m["skipped_nonfinite"], grads)
    set_variant("default")
    (loss_g, skip_g, grads_g), (loss_c, skip_c, grads_c) = results["cuda"], results["cpu"]
    sampler = f"--fast, {100 * float((grid > 0).float().mean()):.2f}% of a 128^3 grid hit" \
        if fast else "stratified"
    log(f"train reference ({variant} variant, {sampler}): fp32 step of {n} rays, {T}+{S} "
        f"samples, patch {patch}, 4-level 2^14 table: loss GPU {loss_g:.6f} CPU {loss_c:.6f}")
    if skip_g or skip_c or grads_g.keys() != grads_c.keys():
        raise AssertionError("train reference: a step was skipped or the gradients differ in kind")
    failed = []
    for k, ref in grads_c.items():
        peak = ref.abs().max().item()
        rel = (grads_g[k] - ref).abs().max().item() / peak
        tol = TRAIN_REF_GRAD_TOL["lidar_color_net" if k.startswith("lidar_color_net")
                                 else "default"]
        log(f"  grad {k}: max |GPU - CPU| / max |CPU| = {rel:.3e} (tol {tol})")
        if not (peak > 0 and rel <= tol):
            failed.append(k)
    np.testing.assert_allclose(loss_g, loss_c, rtol=TRAIN_REF_LOSS_RTOL)
    if failed:
        raise AssertionError(f"train reference: the gradients of {failed} disagree")


def train_slice_phase(ds):
    """The training path: Trainer at full width on the synthetic drive.

    Returns (trainer, initial state_dict on the host, launch counts, warm ms/step)."""
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    opt = train_opt(ds)
    model = new_model(opt, fp16=FULL.fp16)
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer("chip_smoke", opt, model, ema_decay=0.95)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    epoch_s = []
    for epoch in range(1, TRAIN_EPOCHS + 1):
        t0 = time.perf_counter()
        trainer.train(ds, None, max_epochs=epoch)  # ends on the host (loss fetch)
        epoch_s.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    losses, steps = trainer.stats["step_loss"], trainer.global_step
    if steps != TRAIN_EPOCHS * len(ds) or len(losses) != steps:
        raise AssertionError(f"trained {steps} steps, expected {TRAIN_EPOCHS * len(ds)}")
    if not np.isfinite(losses).all() or any(trainer.stats["skipped"]):
        raise AssertionError("a training loss was non-finite or a step was skipped")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    log(f"train: loss mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
        f"({100 * (1 - last / first):.1f}% lower); per-epoch mean {trainer.stats['loss']}")
    if not last <= 0.75 * first:
        raise AssertionError("training lowered the loss by less than 25%")
    only_launches(launches, {"block_hash_fwd": 2 * steps, "block_hash_bwd": 2 * steps})
    n, samples = opt.num_rays_lidar, opt.num_steps + opt.upsample_steps
    per_step = [1e3 * t / len(ds) for t in epoch_s]
    warm = per_step[-1]  # epoch 3: patch 1, warm
    log(f"train slice on {gpu_line()}: {steps} steps of {n} rays, {opt.num_steps}+"
        f"{opt.upsample_steps} samples, {trainer.model.block_spec.num_levels}-level "
        f"2^{opt.log2_hashmap_size} table, bf16 MLPs; ms/step by epoch "
        f"(patch 1, [2, 8], 1): {', '.join(f'{t:.2f}' for t in per_step)}; warm "
        f"{warm:.2f} ms/step = {n / warm * 1e3:.0f} rays/s = "
        f"{n * samples / warm / 1e3:.1f}M composited ray-samples/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    return trainer, init_sd, launches, warm


def train_to_serve_phase(ds, trainer, init_sd):
    """Render training frame 0 from the trained and from the initial weights
    through PanoRenderer; the trained field must fit the frame's depth better."""
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
    from lidarnerf_tpu_torch.utils.params import params_to_jax

    opt = train_opt(ds)
    gt = ds.images_lidar[0]
    hit = gt[..., 0] == 1.0
    reset_counts()
    maes = {}
    for name, sd in (("initial", init_sd), ("trained", trainer.model.state_dict())):
        renderer = PanoRenderer(opt, params_to_jax(sd))
        _, _, depth = renderer.render_frame(ds.poses_lidar[0], ds.H_lidar, ds.W_lidar,
                                            ds.intrinsics_lidar)
        if depth.shape != (ds.H_lidar, ds.W_lidar) or not np.isfinite(depth).all():
            raise AssertionError(f"the {name} render is not a finite pano")
        maes[name] = float(np.abs(depth - gt[..., 2])[hit].mean())
    launches = launch_counts()
    chunks = -(-ds.H_lidar * ds.W_lidar // FULL.max_ray_batch)
    log(f"train-to-serve: depth MAE on the {int(hit.sum())} returning rays of frame 0: "
        f"initial {maes['initial']:.5f}, trained {maes['trained']:.5f} (scaled units; "
        f"{maes['trained'] / ds.scale:.3f} m); launches {launches}")
    if not maes["trained"] < maes["initial"]:
        raise AssertionError("the trained field renders its training frame no better")
    only_launches(launches, {"block_hash_fwd": 2 * 2 * chunks})
    return launches


def profile_summary(prof, wall_ms, what, top):
    """Device time of `prof` by kernel and by operator, and the device's idle share."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device time of the kernels themselves, then of the operators that
    # launched them (each kernel's time is counted once in each list)
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    ops = [e for e in averages if e.device_type == DeviceType.CPU and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"profile of {what}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall under "
        f"the profiler (idle {100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%)")
    for title, events in (("kernels", kernels), ("operators", ops)):
        log(f" by {title}:")
        for e in sorted(events, key=dev_us, reverse=True)[:top]:
            log(f"  {dev_us(e) / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:100]}")
    return {e.key: dev_us(e) / 1e3 for e in kernels}


def profile_train_step(ds, trainer, top=15):
    """Device time by kernel and operator of one full-width training step;
    returns {kernel: device ms}."""
    from torch.profiler import ProfilerActivity, profile

    from lidarnerf_tpu_torch.nerf.train_step import make_train_step
    from lidarnerf_tpu_torch.ops.block_hash import kernel_variant

    step = make_train_step(trainer.model, trainer.train_cfg, trainer.render_cfg,
                           optimizer=trainer.optimizer)
    poses, images = ds.device_arrays("cuda")
    vi = torch.zeros((len(ds), 1), dtype=torch.long, device="cuda")
    vc = torch.full((len(ds),), ds.H_lidar * ds.W_lidar, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    step(poses, images, vi, vc, 0, generator=gen, occ_grid=trainer.occ_grid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        # ends on the host (update guard)
        step(poses, images, vi, vc, 1, generator=gen, occ_grid=trainer.occ_grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sampler = ", --fast" if trainer.occ_grid is not None else ""
    return profile_summary(prof, wall_ms, f"one {trainer.train_cfg.num_rays_lidar}-ray training "
                           f"step ({kernel_variant()} variant{sampler})", top)


def kernel_ms(profiled, name):
    """Device ms of kernel `name` (a CUDA function name) in a profile's {kernel: ms}."""
    return sum(ms for key, ms in profiled.items() if key.startswith(name + "_kernel"))


def profile_phase(renderer, top=12):
    """Device time by operator for one chunk of `renderer`'s serving path (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    pose = drive_poses(1)[0]
    h, w = 4, FULL.max_ray_batch // 4  # exactly one chunk of rays
    renderer.render_frame(pose, h, w, INTRINSICS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_frame(pose, h, w, INTRINSICS)
        wall_ms = (time.perf_counter() - t0) * 1e3
    sampler = ", --fast" if renderer.occ_grid is not None else ""
    profile_summary(prof, wall_ms, f"one {FULL.max_ray_batch}-ray render chunk{sampler}", top)


def run_structure_phase(spec, ds):
    """The run structure of the training chunk that the seg and win kernels
    exploit: per level, the mean run of equal consecutive rows, the share of
    4096-query chunks that seg walks by runs, and the share of win's windows
    that are uniform."""
    from lidarnerf_tpu_torch.ops import block_hash as bh

    dev = torch.device("cuda")
    x = training_chunk_queries(ds, dev, torch.Generator(device=dev).manual_seed(SEED + 2))
    L = spec.num_levels
    rows = bh.level_rows_padded(x, spec)
    Qp = rows.numel() // L
    _, nseg = bh.seg_next(rows, L, Qp)
    nseg = nseg.view(L, -1)
    flags = bh.pack_win_flags(rows, L, Qp).view(L, -1)
    log(f"run structure of the training chunk (Q={x.shape[0]}): level, scale, mean run, "
        f"share of chunks seg walks, win window, share of windows uniform")
    for li, lv in enumerate(spec.levels):
        w = bh.win_of_level(lv.scale)
        walked = float((nseg[li] <= bh.CHUNK // bh.NSEG_DIV).float().mean()) \
            if lv.scale <= bh.SEG_SCALE_MAX else 0.0
        uniform = float(((flags[li].view(-1, w)[:, -1] & bh.WIN_BIT[w]) != 0)
                        .float().mean()) if w > 1 else 0.0
        log(f"  level {li:2d} scale {lv.scale:8.1f}: mean run {Qp / float(nseg[li].sum()):7.2f}, "
            f"seg walks {100 * walked:5.1f}%, w={w} uniform {100 * uniform:5.1f}%")


def variant_kernel_phase(spec, ds, variant):
    """The variant's forward (B3a or B4a) and backward (B3b or B4b) against B1
    and B2 and against the plain versions, on the coarse queries of a served
    chunk and of a training chunk and on uniform ones; returns their two
    `kernels` entries (launches filled later)."""
    from lidarnerf_tpu_torch.ops import block_hash as bh
    from lidarnerf_tpu_torch.ops import block_hash_cuda as bhc

    dev = torch.device("cuda")
    fwd, bwd = bhc.FWD[variant], bhc.BWD[variant]
    serving = serving_chunk_queries(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    training = training_chunk_queries(ds, dev, gen)  # the B2 phase's chunk
    Q = training.shape[0]
    uniform = torch.rand((Q, 3), generator=gen, device=dev) * 1.1 - 0.05
    g = torch.randn((Q, spec.output_dim), generator=gen, device=dev)
    table = torch.randn((spec.table_rows, 128), generator=gen, device=dev)

    fwd_err = 0.0
    for name, x in (("serving chunk", serving), ("training chunk", training), ("uniform", uniform)):
        out = fwd(x, table, spec)
        b1 = bhc.block_hash_fwd(x, table, spec)
        torch.cuda.synchronize()
        same = torch.equal(out, b1)
        err = (out - bh.encode_plain(x, table, spec)).abs().max().item()
        log(f"{fwd.__name__} ({name}, Q={x.shape[0]}): equal to block_hash_fwd bit for bit: "
            f"{same}; vs plain max_abs_err={err:.3e} (tol abs {KERNEL_ATOL})")
        if not (same and err <= KERNEL_ATOL):
            raise AssertionError(f"{fwd.__name__} disagrees with B1 or its plain version ({name})")
        fwd_err = max(fwd_err, err)
        del out, b1

    bwd_err = 0.0
    for name, x in (("training chunk", training), ("uniform", uniform)):
        out = bwd(x, g, spec)
        torch.cuda.synchronize()
        slack = BWD_RTOL * bh.encode_bwd_plain(x, g.abs(), spec) + BWD_ATOL
        ref = bh.encode_bwd_plain(x, g, spec)
        worst = ((out - ref).abs() / slack).max().item()
        err = (out - ref).abs().max().item()
        del ref
        own = bh.ENCODE_BWD_PLAIN[variant](x, g, spec)
        worst_own = ((out - own).abs() / slack).max().item()
        log(f"{bwd.__name__} ({name}, Q={Q}): max_abs_err vs encode_bwd_plain {err:.3e} "
            f"(largest entry {own.abs().max().item():.3e}); worst err / (1e-5 S + 1e-7): "
            f"{worst:.3f} vs encode_bwd_plain, {worst_own:.3f} vs its own plain version")
        if not (worst <= 1.0 and worst_own <= 1.0):
            raise AssertionError(f"{bwd.__name__} disagrees with a plain version ({name})")
        bwd_err = max(bwd_err, err)
        del out, own, slack

    n_fine = FULL.max_ray_batch * FULL.upsample_steps
    # in turns with B1/B2 on the same inputs: base, variant, variant, base
    b1 = [cuda_ms(lambda: bhc.block_hash_fwd(serving, table, spec), reps=10)]
    f_ms = [cuda_ms(lambda: fwd(serving, table, spec), reps=10) for _ in range(2)]
    b1.append(cuda_ms(lambda: bhc.block_hash_fwd(serving, table, spec), reps=10))
    f_fine = cuda_ms(lambda: fwd(serving[:n_fine], table, spec), reps=10)
    f_plain = cuda_ms(lambda: bh.encode_plain(serving, table, spec), reps=1, batches=3, warmup=1)
    b2 = [cuda_ms(lambda: bhc.block_hash_bwd(training, g, spec), reps=10)]
    b_ms = [cuda_ms(lambda: bwd(training, g, spec), reps=10) for _ in range(2)]
    b2.append(cuda_ms(lambda: bhc.block_hash_bwd(training, g, spec), reps=10))
    b_fine = cuda_ms(lambda: bwd(training[:n_fine], g[:n_fine], spec), reps=10)
    b_plain = cuda_ms(lambda: bh.ENCODE_BWD_PLAIN[variant](training, g, spec), reps=1,
                      batches=3, warmup=1)
    f_bound, f_by, f_bytes = fwd_bound(serving, spec, touched_rows(serving, spec))
    b_bound, b_by, b_bytes = bwd_bound(training, spec)
    log(f"{fwd.__name__} coarse call Q={serving.shape[0]}: {f_ms[0]:.4f} / {f_ms[1]:.4f} ms "
        f"(block_hash_fwd before and after: {b1[0]:.4f} / {b1[1]:.4f} ms; plain {f_plain:.3f} ms; "
        f"bound {f_bound:.4f} ms by {f_by}: {f_bytes / 1e6:.1f} MB); fine-call shape Q={n_fine}: "
        f"{f_fine:.4f} ms; run structure found in the kernel, no device prep")
    log(f"{bwd.__name__} coarse call Q={Q}: {b_ms[0]:.4f} / {b_ms[1]:.4f} ms "
        f"(block_hash_bwd before and after: {b2[0]:.4f} / {b2[1]:.4f} ms; own plain version "
        f"{b_plain:.3f} ms; bound {b_bound:.4f} ms by {b_by}: {b_bytes / 1e6:.1f} MB); "
        f"fine-call shape Q={n_fine}: {b_fine:.4f} ms; no device prep")
    entries = []
    for k, err, ms, plain, bound, by in ((fwd.__name__, fwd_err, f_ms[0], f_plain, f_bound, f_by),
                                         (bwd.__name__, bwd_err, b_ms[0], b_plain, b_bound, b_by)):
        _, source, replaces = VARIANT_KERNELS[k]
        entries.append({
            "name": k, "route": "cuda", "source": f"lidarnerf_tpu_torch/csrc/{source}",
            "replaces": f"lidarnerf_tpu/ops/{replaces}", "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,  # no single PyTorch call computes this encoder or gradient
        })
    return entries


def bit_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def determinism_phase(spec, ds):
    """The table gradient is the same bit for bit from run to run (the JAX
    package's is): two calls of each backward kernel (B2, B3b, B4b) on the
    training chunk, 1024 copies of one point and the adversarial sets, each
    pair compared bitwise and each call held within its slack of its plain
    versions; a NaN and Infs in g give non-finite entries where the plain
    version has them. Then two whole full-width training steps per variant
    from the same state and draws, compared bitwise: it prints what repeats
    and what does not, and fails only on the kernels."""
    from lidarnerf_tpu_torch.nerf.trainer import Trainer
    from lidarnerf_tpu_torch.ops import block_hash as bh
    from lidarnerf_tpu_torch.ops import block_hash_cuda as bhc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    training = training_chunk_queries(ds, dev, torch.Generator(device=dev).manual_seed(SEED + 2))
    sets = {"training chunk": training,
            "one point x 1024": torch.tensor([[0.3, 0.5, 0.7]], device=dev).repeat(1024, 1),
            **adversarial_points(dev)}
    failed = []
    for variant in bh.VARIANTS:
        kernel, own_plain = bhc.BWD[variant], bh.ENCODE_BWD_PLAIN[variant]
        for name, x in sets.items():
            g = torch.randn((x.shape[0], spec.output_dim), generator=gen, device=dev)
            first, second = kernel(x, g, spec), kernel(x, g, spec)
            torch.cuda.synchronize()
            repeats = bit_equal(first, second)
            slack = BWD_RTOL * bh.encode_bwd_plain(x, g.abs(), spec) + BWD_ATOL
            worst = max(((first - ref(x, g, spec)).abs() / slack).max().item()
                        for ref in (bh.encode_bwd_plain, own_plain))
            log(f"determinism: {kernel.__name__} ({name}, Q={x.shape[0]}): two calls equal bit "
                f"for bit: {repeats}; worst err / (1e-5 S + 1e-7) vs its plain versions {worst:.3f}")
            if not (repeats and worst <= 1.0):
                failed.append(f"{kernel.__name__} ({name})")
            del first, second, slack
        g = torch.randn((training.shape[0], spec.output_dim), generator=gen, device=dev)
        Q = training.shape[0]  # a coarse level early in a ray, the finest level late in one
        g[100, 1], g[Q // 15, 0], g[Q - 1000, -1] = float("nan"), float("inf"), float("-inf")
        out, again = kernel(training, g, spec), kernel(training, g, spec)
        ref = own_plain(training, g, spec)
        same_set = torch.equal(out.isfinite(), ref.isfinite())
        log(f"determinism: {kernel.__name__} with a NaN, an Inf and a -Inf in g (training chunk): "
            f"{int((~out.isfinite()).sum())} non-finite entries, the plain version "
            f"{int((~ref.isfinite()).sum())}, the same entries: {same_set}; two calls equal bit "
            f"for bit: {bit_equal(out, again)}")
        if not (same_set and (~ref.isfinite()).any() and bit_equal(out, again)):
            failed.append(f"{kernel.__name__} (non-finite g)")
        del out, again, ref

    # two whole training steps from the same state and draws
    poses, images = ds.device_arrays(dev)
    vi = torch.zeros((len(ds), 1), dtype=torch.long, device=dev)
    vc = torch.full((len(ds),), ds.H_lidar * ds.W_lidar, device=dev)
    opt = train_opt(ds)
    for variant in bh.VARIANTS:
        set_variant(variant)
        runs = []
        for _ in range(2):
            trainer = Trainer("chip_smoke", opt, new_model(opt, fp16=FULL.fp16), mute=True)
            step = trainer._get_step_fn(1)
            draws = torch.Generator(device=dev).manual_seed(SEED + 9)
            m = step(poses, images, vi, vc, 0, generator=draws)
            adam = trainer.optimizer[0]
            named = dict(trainer.model.named_parameters())
            state = {f"{k} {s}": v for k, p in named.items() for s, v in adam.state.get(p, {}).items()}
            runs.append({"loss": m["loss"], **{f"{k} grad": p.grad for k, p in named.items()
                                               if p.grad is not None},
                         **{k: p.detach() for k, p in named.items()}, **state})
            del trainer, step
        set_variant("default")
        differ = {k: (runs[0][k].float() - runs[1][k].float()).abs().max().item()
                  for k in runs[0] if not bit_equal(runs[0][k], runs[1][k])}
        log(f"determinism: one full-width training step ({variant} variant), twice from the same "
            f"state and draws: {len(runs[0]) - len(differ)} of {len(runs[0])} tensors (loss, "
            f"gradients, parameters, Adam state) equal bit for bit"
            + (f"; differ (max |a - b|): {differ}" if differ else ""))
    if failed:
        raise AssertionError(f"backward kernels that do not repeat or disagree: {failed}")


def variant_serving_phase(renderer, variant, default_frame):
    """The serving path under a variant switch: one full-width pano, which
    must equal the default variant's pano of the same pose. Returns the
    launch counts."""
    pose = drive_poses(1)[0]  # the default path's first pose
    set_variant(variant)
    renderer.render_frame(pose, 4, 8, INTRINSICS)  # loads the variant's kernel
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    frame = renderer.render_frame(pose, H, W, INTRINSICS)  # ends on the host
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    set_variant("default")

    check_pano(frame, FULL.scale, FULL.scale * renderer.cfg.far_mult)
    chunks = -(-H * W // FULL.max_ray_batch)
    only_launches(launches, {f"block_hash_{variant}_fwd": 2 * chunks})
    names = ("raydrop", "intensity", "depth")
    equal = all(np.array_equal(a, b) for a, b in zip(frame, default_frame))
    gaps = ", ".join(f"{n} {float(np.abs(a - b).max()):.3e}"
                     for n, a, b in zip(names, frame, default_frame))
    log(f"serving-{variant} on {gpu_line()}: one {H}x{W} pano in {ms:.1f} ms; equal to the "
        f"default variant's pano bit for bit: {equal} (max gaps: {gaps}); launches "
        f"{launches[f'block_hash_{variant}_fwd']} block_hash_{variant}_fwd")
    if not equal:  # the forward kernels are bit-exact; bound whatever else moved
        for a, b in zip(frame, default_frame):
            np.testing.assert_allclose(a, b, rtol=REF_RTOL, atol=REF_ATOL)
    return launches


def variant_train_phase(ds, variant, default_epoch_loss):
    """The training path under a variant switch: one 60-step patch-1 epoch
    from the default path's seeded init and frame order. Returns (launch
    counts, ms/step, the variant backward's device ms in one profiled step)."""
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    set_variant(variant)
    opt = train_opt(ds)
    trainer = Trainer("chip_smoke", opt, new_model(opt, fp16=FULL.fp16), ema_decay=0.95)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(ds, None, max_epochs=1)  # ends on the host (loss fetch)
    epoch_s = time.perf_counter() - t0
    launches = launch_counts()

    losses, steps = trainer.stats["step_loss"], trainer.global_step
    if steps != len(ds) or len(losses) != steps:
        raise AssertionError(f"training-{variant}: {steps} steps, expected {len(ds)}")
    if not np.isfinite(losses).all() or any(trainer.stats["skipped"]):
        raise AssertionError(f"training-{variant}: a loss was non-finite or a step was skipped")
    only_launches(launches, {f"block_hash_{variant}_fwd": 2 * steps,
                             f"block_hash_{variant}_bwd": 2 * steps})
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    step_ms = 1e3 * epoch_s / steps
    profiled = profile_train_step(ds, trainer, top=6)
    bwd_ms = kernel_ms(profiled, f"block_hash_{variant}_bwd")
    set_variant("default")
    log(f"training-{variant} on {gpu_line()}: {steps} steps, {step_ms:.2f} ms/step; loss mean of "
        f"the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
        f"({100 * (1 - last / first):.1f}% lower); epoch mean {trainer.stats['loss'][0]:.4f} "
        f"(default variant's first epoch {default_epoch_loss:.4f}); block_hash_{variant}_bwd "
        f"{bwd_ms:.3f} ms of device time per step; launches {launches}")
    if not last <= 0.75 * first:
        raise AssertionError(f"training-{variant} lowered the loss by less than 25%")
    return launches, step_ms, bwd_ms


def full_network(params):
    """The full-width model (bf16 policy) with `params` through the weight bridge, on the card."""
    from lidarnerf_tpu_torch.utils.params import params_from_jax

    net = new_model(FULL, fp16=FULL.fp16)
    net.load_state_dict(params_from_jax(params))
    return net.to("cuda").eval()


def jax_layout(mlp, dtype):
    """An MLP's weights as fused_mlp takes them: [d_in, d_out], as `dtype`."""
    return [lin.weight.detach().t().contiguous().to(dtype) for lin in mlp.layers]


@torch.no_grad()
def chunk_samples(net, o, d, T, near, generator=None):
    """A 4096-ray chunk's samples as the renderer forms them over
    [near, 81 near]: coarse z [N, T] (jittered when a generator is given, as
    in training), fine z [N, 64] by inverse CDF, and the sigma and 15-wide
    geo of both."""
    from lidarnerf_tpu_torch.ops.compositing import composite_weights
    from lidarnerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals

    train = generator is not None
    near = torch.full((o.shape[0], 1), near, device=o.device)
    far = near * 81.0
    z = stratified_z_vals(near, far, T, perturb=train, generator=generator)

    def density(zz):
        xyz = torch.clamp(o[:, None] + d[:, None] * zz[..., None], -FULL.bound, FULL.bound)
        return net.density(xyz)

    sigma, geo = density(z)
    w = composite_weights(sigma, z, (far - near) / T, 1.0)
    z_mid = z[..., :-1] + 0.5 * (z[..., 1:] - z[..., :-1])
    new_z = sample_pdf(z_mid, w[:, 1:-1], FULL.upsample_steps, det=not train, generator=generator)
    new_z = torch.sort(new_z, dim=-1).values
    new_sigma, new_geo = density(new_z)
    return z, new_z, sigma, new_sigma, geo, new_geo


def head_input(net, o, d):
    """The LiDAR head's input of a served chunk, as the renderer forms it:
    [N * (768 + 64), 75 + 15] = the direction encoding broadcast ++ the geo
    features of the coarse and the fine samples."""
    *_, geo_c, geo_f = chunk_samples(net, o, d, FULL.num_steps, FULL.scale)
    geo = torch.cat([geo_c, geo_f], dim=1)  # [N, 832, 15]
    d_enc = net.encode_dir(d)[:, None, :].expand(*geo.shape[:-1], -1)
    return torch.cat([d_enc, geo], dim=-1).reshape(-1, d_enc.shape[-1] + geo.shape[-1])


def mlp_bound(x, weights, peak):
    """(least ms, by) of the chain on x: x read and the output written once,
    2 flops per multiply-add, at `peak` flop/s."""
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    Q = x.shape[0]
    bytes_moved = Q * (dims[0] + dims[-1]) * 4 + sum(w.numel() * w.element_size() for w in weights)
    flops = 2 * Q * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mlp_worst(out, x, weights, act):
    """(max |kernel - plain|, worst err / (r S + 1e-6)) of B5's output."""
    from lidarnerf_tpu_torch.ops.fused_mlp import mlp_reference

    err = (out - mlp_reference(x, weights, act)).abs()
    S = mlp_reference(x.abs(), [w.abs() for w in weights], "none")
    return err.max().item(), (err / (MLP_RTOL[weights[0].dtype] * S + 1e-6)).max().item()


def fused_mlp_phase(params, ds):
    """The fused-mlp path: `fused_mlp` on the model's own nets at a served
    chunk's shapes, f32 and bf16, and one backward on a training chunk's
    sigma-net input; each held against the plain chain. Returns (launch
    counts, the B5 `kernels` entry)."""
    from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
    from lidarnerf_tpu_torch.ops.block_hash_cuda import block_hash_fwd
    from lidarnerf_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_inference, mlp_reference

    dev = torch.device("cuda")
    net = full_network(params)
    table, spec = net.hash_table.detach(), net.block_spec
    enc = block_hash_fwd(serving_chunk_queries(dev), table, spec)  # [3,145,728, 32]
    rays = get_lidar_rays(torch.from_numpy(drive_poses(1)[0]).to(dev)[None], INTRINSICS, H, W)
    head_x = head_input(net, rays["rays_o"][0, :FULL.max_ray_batch],
                        rays["rays_d"][0, :FULL.max_ray_batch])  # [3,407,872, 90]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    train_x = block_hash_fwd(training_chunk_queries(ds, dev, gen), table, spec)
    cases = [(f"{name} {str(dtype).split('.')[-1]}", x, jax_layout(mlp, dtype), act)
             for name, x, mlp, act in (("sigma net", enc, net.sigma_net, "none"),
                                       ("LiDAR head", head_x, net.lidar_color_net, "sigmoid"))
             for dtype in (torch.float32, torch.bfloat16)]
    cot = torch.randn((train_x.shape[0], 16), generator=gen, device=dev)
    xg = train_x.requires_grad_()
    wg = [w.requires_grad_() for w in jax_layout(net.sigma_net, torch.float32)]

    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        outs = [fused_mlp(x, ws, act) for _, x, ws, act in cases]
    fused_mlp(xg, wg).backward(cot)
    torch.cuda.synchronize()
    launches = launch_counts()
    only_launches(launches, {"fused_mlp": len(cases) + 1})

    max_err, timed = 0.0, {}
    for (name, x, ws, act), out in zip(cases, outs):
        err, worst = mlp_worst(out, x, ws, act)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: fused_mlp_inference(x, ws, act), reps=5)
        plain_ms = cuda_ms(lambda: mlp_reference(x, ws, act), reps=3)
        cuda_bound, cuda_by = mlp_bound(x, ws, FP32_FLOPS)
        tc_bound, tc_by = mlp_bound(x, ws, BF16_FLOPS)
        timed[name] = (ms, plain_ms, tc_bound if ws[0].dtype == torch.bfloat16 else cuda_bound,
                       tc_by if ws[0].dtype == torch.bfloat16 else cuda_by)
        log(f"fused_mlp {name} Q={x.shape[0]} {list(x.shape[1:]) + [w.shape[1] for w in ws]}: "
            f"max_abs_err={err:.3e}, worst err / ({MLP_RTOL[ws[0].dtype]:.3g} S + 1e-6) = "
            f"{worst:.3f}; {ms:.4f} ms (plain chain, cuBLAS GEMMs: {plain_ms:.4f} ms); bound "
            f"{cuda_bound:.4f} ms by {cuda_by} on fp32 CUDA cores, {tc_bound:.4f} ms by {tc_by} "
            f"on bf16 tensor cores")
        if not worst <= 1.0:
            raise AssertionError(f"fused_mlp disagrees with mlp_reference ({name})")
    del outs, cases, head_x, enc

    xr = xg.detach().clone().requires_grad_()
    wr = [w.detach().clone().requires_grad_() for w in wg]
    mlp_reference(xr, wr, "none").backward(cot)
    gaps = [(a.grad - b.grad).abs().max().item() / b.grad.abs().max().item()
            for a, b in zip((xg, *wg), (xr, *wr))]
    log(f"fused_mlp backward (training chunk's sigma-net input, Q={xg.shape[0]}, f32): "
        f"max |grad - autograd of mlp_reference| / max |grad| per input: "
        f"{', '.join(f'{g:.3e}' for g in gaps)}")
    if not max(gaps) <= 1e-5:
        raise AssertionError("fused_mlp's gradient disagrees with autograd of mlp_reference")
    ms, plain_ms, bound_ms, bound_by = timed["sigma net bfloat16"]
    return launches, {
        "name": "fused_mlp", "route": "cuda", "source": "lidarnerf_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "lidarnerf_tpu/ops/fused_mlp.py:57", "launches": None,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the fused chain
    }


def training_samples(net, ds, T, gen):
    """A training chunk's samples (chunk_samples) at T coarse samples, on
    frame 0's rays at training pixels."""
    from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices

    poses, _ = ds.device_arrays("cuda")
    inds = sample_ray_indices(ds.H_lidar, ds.W_lidar, FULL.max_ray_batch, 1, gen, "cuda")
    o, d = rays_from_indices(poses[0], inds, ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    return chunk_samples(net, o, d, T, ds.scale, generator=gen)


def perm_gather_phase(params, ds):
    """The sort-merge path: `sort_merge_z` forward and backward on a training
    chunk's samples at 768 + 64 and at the --fast 192 + 64, through B6 both
    ways; bit for bit against the plain versions and torch.gather. Returns
    (launch counts, the two B6 `kernels` entries)."""
    from lidarnerf_tpu_torch.ops import perm_gather_cuda as pgc
    from lidarnerf_tpu_torch.ops.perm_gather import gather_by_inverse, scatter_by_inverse
    from lidarnerf_tpu_torch.ops.sampling import inverse_permutation, sort_merge_z

    dev = torch.device("cuda")
    net = full_network(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    chunks = {T: training_samples(net, ds, T, gen) for T in (FULL.num_steps, FAST["num_steps"])}
    del net
    runs = {}
    torch.cuda.synchronize()
    reset_counts()
    for T, (zc, zf, sc, sf, gc, gf) in chunks.items():
        leaves = [t.detach().clone().requires_grad_() for t in (sc, sf, gc, gf)]
        z, order, s, geo = sort_merge_z(zc, zf, (leaves[0], leaves[1]), (leaves[2], leaves[3]))
        cots = [torch.randn(s.shape, generator=gen, device=dev),
                torch.randn(geo.shape, generator=gen, device=dev)]
        torch.autograd.backward([s, geo], cots)
        runs[T] = (zc, zf, sc, sf, gc, gf, z, order, s, geo, cots, leaves)
    torch.cuda.synchronize()
    launches = launch_counts()
    only_launches(launches, {"perm_gather_fwd": len(chunks), "perm_gather_bwd": len(chunks)})

    entries = {}
    for T, (zc, zf, sc, sf, gc, gf, z, order, s, geo, cots, leaves) in runs.items():
        fused = torch.cat([torch.cat([zc, zf], 1)[..., None], torch.cat([sc, sf], 1)[..., None],
                           torch.cat([gc, gf], 1)], dim=-1)  # as sort_merge_z fuses them
        N, S, C = fused.shape
        inv = inverse_permutation(order)
        inv32 = inv.int()
        idx_order, idx_inv = order[..., None].expand_as(fused), inv[..., None].expand_as(fused)
        out = torch.cat([z[..., None], s[..., None], geo], dim=-1).detach()
        gcot = torch.cat([torch.zeros_like(z)[..., None], cots[0][..., None], cots[1]], dim=-1)
        grad = torch.cat([torch.cat([leaves[0].grad, leaves[1].grad], 1)[..., None],
                          torch.cat([leaves[2].grad, leaves[3].grad], 1)], dim=-1)
        bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
        checks = {
            "z sorted": bool((z[:, 1:] >= z[:, :-1]).all()),
            "forward == plain": torch.equal(bits(out), bits(scatter_by_inverse(fused, inv))),
            "forward == torch.gather": torch.equal(bits(out), bits(torch.gather(fused, 1, idx_order))),
            "gradient == gather by inv_order": torch.equal(
                grad, gather_by_inverse(gcot, inv)[..., 1:]),
        }
        # each direction in turns with torch.gather: gather, B6, B6, gather
        ms, turns = {}, []
        for d, kernel, library, plain in (
                ("fwd", lambda: pgc.perm_gather_fwd(fused, inv32),
                 lambda: torch.gather(fused, 1, idx_order), lambda: scatter_by_inverse(fused, inv)),
                ("bwd", lambda: pgc.perm_gather_bwd(gcot, inv32),
                 lambda: torch.gather(gcot, 1, idx_inv), lambda: gather_by_inverse(gcot, inv))):
            t = [cuda_ms(fn, reps=10) for fn in (library, kernel, kernel, library)]
            ms[d], ms[f"gather {d}"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            ms[f"plain {d}"] = cuda_ms(plain, reps=10)
            turns.append(f"{d} " + " / ".join(f"{x:.4f}" for x in t))
        bytes_moved = 2 * N * S * C * 4 + N * S * 4
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        log(f"sort-merge [{N}, {S}, {C}] ({T} + {S - T} samples): {checks}; B6 forward "
            f"{ms['fwd']:.4f} ms, backward {ms['bwd']:.4f} ms (plain {ms['plain fwd']:.4f} / "
            f"{ms['plain bwd']:.4f}, torch.gather {ms['gather fwd']:.4f} / {ms['gather bwd']:.4f}; "
            f"in turns gather, B6, B6, gather: {'; '.join(turns)}); bound {bound_ms:.4f} ms by "
            f"bytes ({bytes_moved / 1e6:.1f} MB)")
        if not all(checks.values()):
            raise AssertionError(f"sort_merge_z through B6 is not bit-exact at S={S}: {checks}")
        if T == FULL.num_steps:
            for d in ("fwd", "bwd"):
                entries[d] = {
                    "name": f"perm_gather_{d}", "route": "cuda",
                    "source": "lidarnerf_tpu_torch/csrc/perm_gather.cu",
                    "replaces": "lidarnerf_tpu/ops/perm_gather_pallas.py:65", "launches": None,
                    "max_abs_err": 0.0, "ms": ms[d], "plain_ms": ms[f"plain {d}"],
                    "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": ms[f"gather {d}"],
                }
    return launches, [entries["fwd"], entries["bwd"]]


def train_fast_phase(ds, default_ms):
    """The training-fast path: Trainer with occupancy-prior sampling (--fast)
    at full width, the training path's three epochs. Returns (trainer,
    initial state_dict, launch counts)."""
    from lidarnerf_tpu_torch.models.occupancy import occupied_volume, update_occ_grid
    from lidarnerf_tpu_torch.nerf.trainer import Trainer
    from lidarnerf_tpu_torch.ops import block_hash_cuda

    opt = train_opt(ds, **FAST)
    model = new_model(opt, fp16=FULL.fp16)
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer("chip_smoke_fast", opt, model, ema_decay=0.95)
    occ = trainer.render_cfg.occ
    torch.cuda.synchronize()
    reset_counts()
    epoch_s = []
    for epoch in range(1, TRAIN_EPOCHS + 1):
        t0 = time.perf_counter()
        trainer.train(ds, None, max_epochs=epoch)  # ends on the host (loss fetch)
        epoch_s.append(time.perf_counter() - t0)
    launches = launch_counts()

    losses, steps = trainer.stats["step_loss"], trainer.global_step
    refreshes = len(range(0, steps, occ.update_interval))
    if steps != TRAIN_EPOCHS * len(ds) or len(losses) != steps:
        raise AssertionError(f"training-fast: {steps} steps, expected {TRAIN_EPOCHS * len(ds)}")
    if not np.isfinite(losses).all() or any(trainer.stats["skipped"]):
        raise AssertionError("training-fast: a loss was non-finite or a step was skipped")
    only_launches(launches, {"block_hash_fwd": 2 * steps + refreshes,
                             "block_hash_bwd": 2 * steps})
    if not trainer.occ_grid.any():
        raise AssertionError("training-fast: the occupancy grid is all zero after its refreshes")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    per_step = [1e3 * t / len(ds) for t in epoch_s]
    share = float(occupied_volume(trainer.occ_grid, replace(occ, dilate=0)).mean())
    dilated = float(occupied_volume(trainer.occ_grid, occ).mean())

    # one refresh, and B1 alone at its shape: G^3 points over the whole volume
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    refresh_ms = cuda_ms(lambda: update_occ_grid(trainer.model, trainer.occ_grid, occ, FULL.bound,
                                                 generator=gen), reps=1, batches=3)
    G = occ.grid_size
    idx = torch.arange(G, dtype=torch.float32, device="cuda")
    cell = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    x01 = (cell + torch.rand(cell.shape, generator=gen, device="cuda")) / G
    spec, table = trainer.model.block_spec, trainer.model.hash_table.detach()
    b1_ms = cuda_ms(lambda: block_hash_cuda.block_hash_fwd(x01, table, spec), reps=5)
    b1_bound, b1_by, b1_bytes = fwd_bound(x01, spec, touched_rows(x01, spec))
    log(f"training-fast on {gpu_line()}: {steps} steps of {opt.num_rays_lidar} rays, "
        f"{opt.num_steps}+{opt.upsample_steps} samples, a {G}^3 grid refreshed {refreshes} times "
        f"(every {occ.update_interval} steps from step 0); ms/step by epoch "
        f"{', '.join(f'{t:.2f}' for t in per_step)} (default path warm {default_ms:.2f}); loss "
        f"mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
        f"({100 * (1 - last / first):.1f}% lower); grid occupied {100 * share:.2f}% "
        f"({100 * dilated:.2f}% dilated), max {trainer.occ_grid.max().item():.1f}; launches "
        f"{launches}")
    log(f"occupancy refresh: {refresh_ms:.3f} ms each (B1 alone at Q={x01.shape[0]} uniform "
        f"points: {b1_ms:.4f} ms, bound {b1_bound:.4f} ms by {b1_by}: {b1_bytes / 1e6:.1f} MB)")
    if not last <= 0.75 * first:
        raise AssertionError("training-fast lowered the loss by less than 25%")
    profile_train_step(ds, trainer)
    return trainer, init_sd, launches


def serve_fast_phase(ds, trainer, init_sd):
    """The serving-fast path: training frame 0 through PanoRenderer with the
    --fast weights and grid; its depth error must beat the initial weights'
    (on a zero grid, their state before any refresh). The default-sampling
    render of the same weights is logged beside it. Returns launch counts."""
    from lidarnerf_tpu_torch.models.occupancy import init_occ_grid
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
    from lidarnerf_tpu_torch.utils.params import params_to_jax

    opt = train_opt(ds, **FAST)
    occ = trainer.render_cfg.occ
    trained = params_to_jax(trainer.model.state_dict())
    gt = ds.images_lidar[0]
    hit = gt[..., 0] == 1.0
    frame = (ds.poses_lidar[0], ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    renderer = PanoRenderer(opt, trained, occ_grid=trainer.occ_grid)
    torch.cuda.synchronize()
    reset_counts()
    raydrop, intensity, depth = renderer.render_frame(*frame)  # ends on the host
    launches = launch_counts()
    fast_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        renderer.render_frame(*frame)
        fast_ms.append((time.perf_counter() - t0) * 1e3)
    profile_phase(renderer)  # one --fast render chunk: device busy vs host

    far = ds.scale * renderer.cfg.far_mult
    for name, a in (("raydrop", raydrop), ("intensity", intensity), ("depth", depth)):
        if a.shape != (ds.H_lidar, ds.W_lidar) or not np.isfinite(a).all():
            raise AssertionError(f"serving-fast: the {name} pano is not a finite pano")
    if not (0 <= raydrop.min() and raydrop.max() <= 1 and 0 <= intensity.min()
            and intensity.max() <= 1 and 0 <= depth.min() and depth.max() <= far):
        raise AssertionError("serving-fast: a pano lies outside its range")
    chunks = -(-ds.H_lidar * ds.W_lidar // FULL.max_ray_batch)
    only_launches(launches, {"block_hash_fwd": 2 * chunks})
    maes = {"fast": float(np.abs(depth - gt[..., 2])[hit].mean())}
    _, _, d0 = PanoRenderer(opt, params_to_jax(init_sd), occ_grid=init_occ_grid(occ)
                            ).render_frame(*frame)
    maes["initial"] = float(np.abs(d0 - gt[..., 2])[hit].mean())
    default = PanoRenderer(train_opt(ds), trained)
    default.render_frame(*frame)
    t0 = time.perf_counter()
    _, _, dd = default.render_frame(*frame)
    default_ms = (time.perf_counter() - t0) * 1e3
    maes["default sampling"] = float(np.abs(dd - gt[..., 2])[hit].mean())
    log(f"serving-fast on {gpu_line()}: frame 0 ({ds.H_lidar}x{ds.W_lidar}) from the --fast "
        f"weights and grid, {opt.num_steps}+{opt.upsample_steps} samples: "
        f"{', '.join(f'{t:.1f}' for t in fast_ms)} ms/pano (3 warm renders) "
        f"(default sampling, {FULL.num_steps}+{FULL.upsample_steps}, of the same weights: "
        f"{default_ms:.1f} ms); depth MAE on the {int(hit.sum())} returning rays: "
        + ", ".join(f"{k} {v:.5f}" for k, v in maes.items()) + f"; launches {launches}")
    if not maes["fast"] < maes["initial"]:
        raise AssertionError("serving-fast: the trained field renders frame 0 no better")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from lidarnerf_tpu_torch.ops import block_hash_cuda, cuda_lib, fused_mlp_cuda, perm_gather_cuda
    from lidarnerf_tpu_torch.ops.block_hash import make_block_hash_spec
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer

    set_variant("default")  # the default paths first; each variant phase sets its switch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    # all eight sources, one nvcc each, started together
    libs = cuda_lib.build(block_hash_cuda.SOURCES + (fused_mlp_cuda.SOURCE, perm_gather_cuda.SOURCE))
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        report = lib.with_suffix(".log")
        if report.exists():
            log(report.read_text().strip())

    spec = make_block_hash_spec(log2_hashmap_size=FULL.log2_hashmap_size,
                                desired_resolution=FULL.desired_resolution)
    ds = synth_drive()
    kernels = [block_hash_phase(spec), block_hash_bwd_phase(spec, ds)]
    run_structure_phase(spec, ds)
    for variant in VARIANT_ENV:
        kernels += variant_kernel_phase(spec, ds, variant)
    determinism_phase(spec, ds)

    # serving
    params = flax_layout_params(SEED, FULL)
    reference_phase(params)
    renderer = PanoRenderer(FULL, params)
    paths = {}
    paths["serving"], default_frame = slice_phase(renderer)
    profile_phase(renderer)
    for variant in VARIANT_ENV:
        paths[f"serving-{variant}"] = variant_serving_phase(renderer, variant, default_frame)
    del renderer

    # the entry points of B5 and B6 at the model's shapes
    paths["fused-mlp"], b5 = fused_mlp_phase(params, ds)
    paths["sort-merge"], b6 = perm_gather_phase(params, ds)
    kernels += [b5, *b6]
    torch.cuda.empty_cache()

    # training
    trainer, init_sd, paths["training"], default_step_ms = train_slice_phase(ds)
    paths["train-to-serve"] = train_to_serve_phase(ds, trainer, init_sd)
    b2_ms = kernel_ms(profile_train_step(ds, trainer), "block_hash_bwd")
    default_epoch_loss = trainer.stats["loss"][0]
    del trainer, init_sd
    summary = [f"default: block_hash_bwd {b2_ms:.3f} ms"]
    for variant in VARIANT_ENV:
        paths[f"training-{variant}"], step_ms, bwd_ms = variant_train_phase(
            ds, variant, default_epoch_loss)
        summary.append(f"{variant}: {step_ms:.2f} ms/step, block_hash_{variant}_bwd {bwd_ms:.3f} ms")
    log(f"table-gradient kernel device ms per training step on {gpu_line()}: "
        + "; ".join(summary))

    # --fast: occupancy-prior sampling, training then serving
    trainer, init_sd, paths["training-fast"] = train_fast_phase(ds, default_step_ms)
    paths["serving-fast"] = serve_fast_phase(ds, trainer, init_sd)
    del trainer, init_sd

    for variant in ("default", *VARIANT_ENV):
        train_reference_phase(ds, variant)
    train_reference_phase(ds, fast=True)

    for k in kernels:
        k["launches"] = sum(counts.get(k["name"], 0) for counts in paths.values())
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on the main paths")
    log(f"launches by path: {paths}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    # every phase runs on the current device only
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
