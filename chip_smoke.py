#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lidarnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the ported paths from `lidarnerf_tpu_torch/csrc`
(the block-hash forward B1 and backward B2, their run-collapsing variants:
segmented B3a/B3b and windowed B4a/B4b, the fused MLP B5, the permutation
gather B6 and the occupancy bin lookup P12), holds each against its plain
PyTorch version on the card at the main paths' shapes, then drives the main
paths at the full width of the KITTI-360 model (16-level 2^19 block-hash
grid, width-64 bf16 MLPs, 768 + 64 samples, 4096-ray chunks, 66 x 1030
panos):
  - fused-mlp: `fused_mlp` on the model's own sigma net and LiDAR head at a
    served chunk's shapes, f32 and bf16, and one backward (B5), with each
    instance's registers and blocks per SM, the spills ptxas reports and the
    tensor-core mma (HMMA) count of the built library;
  - sort-merge: `sort_merge_z` forward and backward on a training chunk's
    768 + 64 and --fast 192 + 64 samples (B6, both directions);
  - serving: full-pano LiDAR rendering through `PanoRenderer`, with weights
    made from a seed;
  - training: `Trainer` on the synthetic KITTI-360-format drive in
    `data_synth_drive60/` for three epochs (patch 1, patch [2, 8], patch 1),
    from the port's seeded init, then a render of a training frame from the
    trained weights. Every training path trains through the fused epoch
    (`--fuse_epoch 1`): each step replays a CUDA graph of the step, and its
    launches are counted on the card by ops/device_counts.py (a replay
    runs no Python, so the wrappers count only the warm-up and capture);
  - training-graph: the default, --fast, seg and win steps (the last two on
    20-frame epochs; and, in the mvl phase, the masked one), eager and
    captured from the same state in turns:
    ms/step, the device's idle share of a replayed step, peak allocated and
    reserved memory, the kernels on the card per replayed step, the update
    guard's cost; losses and final state bit-equal;
  - serving-seg, serving-win, training-seg, training-win: one pano and one
    60-step epoch under each variant switch (`LIDARNERF_SEG_KERNELS=1`,
    `LIDARNERF_WIN_KERNELS=1`), held against the default variant;
  - training-fast, serving-fast: `Trainer` with occupancy-prior sampling
    (`--fast`: 192 + 64 samples, a 128^3 grid refreshed every 16 steps) for
    the same three epochs, then `PanoRenderer` on frame 0 with its grid;
  - occ-lookup: the occupancy bin lookup (P12) through the port's tool
    (`python -m lidarnerf_tpu_torch.tools.exp_occ_lookup`: 524,288 uniform
    cells of a seeded 128^3 grid) and on the --fast step's real bin cells
    in the trained grid, bit-exact, timed in turns with the port's index,
    then by CUDA-graph replays and the profiler at both shapes;
  - cli: the CLI (`python -m lidarnerf_tpu_torch.main_lidarnerf`) with
    configs/kitti360_1908.txt -L on the drive: train -> evaluate -> test ->
    mesh, `--test_eval`, a resume, the device Chamfer;
  - mvl: the CLI with configs/nerf_mvl.txt -L (256 x 1800 panos) on a
    synthetic car that `lidarnerf_tpu_torch.tools.make_synth_mvl` traces on
    the card: masked training, crop meters, OBB-cropped test clouds, mesh,
    `--test_eval`, B1 and B2 on an MVL training chunk, one masked step with
    no host read (`set_sync_debug_mode("error")`), the masked step eager and
    captured, a pano through `PanoRenderer`;
  - onramp: the data on-ramp with no JAX: a raw KITTI-360 tree of sequence
    1908's 64 frames (HDL-64 sweeps of ~131k points cast from the synthetic
    street) through the host C++ projection (held against its numpy
    version) and the port's check_dataset (its stage 5 a smoke train on the
    card; B1 and B2 on one of its training chunks, at its 2^15 table), the
    built dataset trained at configs/kitti360_1908.txt -L width with the
    computed scale and offset, `--test_eval`, epochs of graph replay
    untraced and traced; a raw NeRF-MVL `car`
    tree through create_nerf_mvl_rangeview's calls and nerfmvl_to_nerf into a few
    masked steps at 256 x 1800;
  - encodings: the CLI with configs/kitti360_1908.txt -L --encoding hashgrid
    (the reference-exact hash grid, plain PyTorch with an order-free table
    gradient: no kernel of the port runs) on the drive: train, evaluate every
    epoch, test, mesh, `--test_eval`; a warm pano; the encoder at a training
    chunk's shape (two table gradients bit-equal, the card against the CPU);
    the step eager and captured in turns; two captured runs bit-equal; 20
    steps each of tiledgrid, periodic_volume and frequency at full width;
  - rgb: an RGB frame at KITTI-360's perspective size (376 x 1408) through
    the full-width hashgrid model in fp32, over the background sphere and
    over white, held against the CPU on a subset of its rays;
  - baselines: the classical LiDAR-NVS baselines (lidarnerf_tpu_torch/lidarnvs)
    on the drive at full width: PCGen fitted on the 60 train frames (~4M
    points), both test frames by cp and fpa, evaluated with the Chamfer on
    the card; the ray-drop MLP of lidarnvs/configs/pcgen_kitti360_raydrop.txt
    trained on PCGen's ray-drop data (2,000 of its 10,000 iterations) and
    applied; the UNet ray-drop net (64-...-1024) trained 2 epochs at batch 2
    on 66 x 1030 frames built from PCGen's panos; both nets held against the
    CPU; the baseline CLIs (`run` evaluating and collecting,
    `raydrop_train_pcgen`, `raydrop_train_poisson`), and `run --method
    poisson` raising open3d's ImportError. No kernel of the port runs;
  - seams: the block-hash seam options (`--seam_tie 1 --alpha_seam 100
    --seam_sync_hashed 4096`) through the CLI on the drive (train, evaluate,
    test, mesh, `--test_eval`), the tied copies equal, the sync lowering the
    seam loss, the three functions at the full table against the CPU, the
    step eager and captured, two captured runs, ms/step of each option in
    turns with the default, and a served pano with the tie (B1, B2);
  - parallel: an NCCL group of every GPU (one process each, started here):
    the captured data-parallel epoch against one GPU, the ranks' weights
    bit-identical, two runs bit-equal, the table row-sharded over `model`,
    the orbax-format checkpoint, ms/step with and without the group (B1,
    B2). On a machine with one GPU the group is a world of one.
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

import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
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
    from lidarnerf_tpu_torch.ops import (block_hash_cuda, fused_mlp_cuda, occ_lookup_cuda,
                                         perm_gather_cuda)

    return {**block_hash_cuda.launch_counts(), **fused_mlp_cuda.launch_counts(),
            **perm_gather_cuda.launch_counts(), **occ_lookup_cuda.launch_counts()}


def reset_counts():
    """Zero the wrappers' counters and turn on the count on the card
    (device_launches), so that the graphs captured from here on count their
    replays."""
    from lidarnerf_tpu_torch.ops import (block_hash_cuda, device_counts, fused_mlp_cuda,
                                         occ_lookup_cuda, perm_gather_cuda)

    for module in (block_hash_cuda, fused_mlp_cuda, perm_gather_cuda, occ_lookup_cuda):
        module.reset_counts()
    device_counts.enable("cuda")


def only_launches(counts, expected):
    """Raise unless `counts` (launch_counts()) holds exactly `expected`
    launches and none of any other kernel."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")


# torch.profiler's trace loses the records of kernels that it receives after
# it stops, even when they ran before (on the H100 up to ~35 ms of the last
# kernels); waiting this long after the last synchronize lets them in
TRACE_TAIL_S = 0.5


@contextlib.contextmanager
def device_launches():
    """Count the port's kernels that run on the card within the block
    (ops/device_counts.py: each wrapper adds one to its kernel's slot on the
    card right after its launch, on its stream, so a replayed CUDA graph adds
    once per launch it holds), while the wrappers' own counters, which count
    where Python calls a wrapper, see no replay. Counting is on from
    reset_counts(), so graphs captured before the block count too. Yields
    {kernel name: kernels that ran}, filled when the block ends."""
    from lidarnerf_tpu_torch.ops import device_counts

    device_counts.enable("cuda")
    torch.cuda.synchronize()
    device_counts.reset()
    counts = {}
    yield counts
    torch.cuda.synchronize()
    counts.update(device_counts.counts())


def training_launches(per_step, steps, extra=None):
    """{kernel: launches} of `steps` training steps that launch `per_step`
    each, plus `extra` (launches outside the steps)."""
    extra = extra or {}
    return {k: per_step.get(k, 0) * steps + extra.get(k, 0) for k in {*per_step, *extra}}


def check_graphed_launches(what, counts, device, trainer, per_step, extra=None):
    """The launches of a graphed training run (`--fuse_epoch 1`, the
    default) that trained trainer.global_step steps: on the card (`device`,
    a profile's records) `per_step` at every step; at the wrappers
    (`counts`) only at the two steps per captured graph that Python ran
    (the graph's eager warm-up and its capture, which records the launches);
    `extra` in both. Returns the number of graphs."""
    graphs = sum(len(f.graphs) for f in trainer._epoch_fns.values())
    if not graphs:
        raise AssertionError(f"{what}: the run captured no graph")
    only_launches(device, training_launches(per_step, trainer.global_step, extra))
    only_launches(counts, training_launches(per_step, 2 * graphs, extra))
    return graphs


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, batches=5, warmup=2):
    """Device time of one fn() call: the median over `batches` of the mean of
    `reps` back-to-back calls between two CUDA events. The count on the card
    is paused: a wrapper timed here launches its kernel alone."""
    from lidarnerf_tpu_torch.ops import device_counts

    with device_counts.paused():
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
        seam_tie=bool(getattr(opt, "seam_tie", 0)),
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
        net = NeRFNetwork(encoding="blockhash", num_levels=4, log2_hashmap_size=14,
                          desired_resolution=64, hidden_dim=32,
                          generator=torch.Generator().manual_seed(SEED))
        step = make_train_step(net, cfg, rcfg, patch_size=patch, device=dev)
        poses, images = ds.device_arrays(dev)
        vi = torch.zeros((len(ds), 1), dtype=torch.long, device=dev)
        vc = torch.full((len(ds),), ds.H_lidar * ds.W_lidar, device=dev)
        m = step(poses, images, vi, vc, 3, draws={k: v.to(dev) for k, v in draws.items()},
                 occ_grid=None if grid is None else grid.to(dev))
        grads = {k: p.grad.cpu() for k, p in net.named_parameters() if p.grad is not None}
        results[dev] = (float(m["loss"]), float(m["skipped_nonfinite"]), grads)
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
    trainer = Trainer("chip_smoke", opt, model, ema_decay=0.95, workspace=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    epoch_s = []
    with device_launches() as device:
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
    graphs = check_graphed_launches("train", launches, device, trainer,
                                    {"block_hash_fwd": 2, "block_hash_bwd": 2})
    n, samples = opt.num_rays_lidar, opt.num_steps + opt.upsample_steps
    per_step = [1e3 * t / len(ds) for t in epoch_s]
    warm = per_step[-1]  # epoch 3: patch 1, warm
    log(f"train slice on {gpu_line()}: {steps} steps of {n} rays, {opt.num_steps}+"
        f"{opt.upsample_steps} samples, {trainer.model.block_spec.num_levels}-level "
        f"2^{opt.log2_hashmap_size} table, bf16 MLPs; ms/step by epoch "
        f"(patch 1, [2, 8], 1): {', '.join(f'{t:.2f}' for t in per_step)}; warm "
        f"{warm:.2f} ms/step = {n / warm * 1e3:.0f} rays/s = "
        f"{n * samples / warm / 1e3:.1f}M composited ray-samples/s; peak memory {peak / 2**30:.2f} GiB; {graphs} graphs; launches at the "
        f"wrappers {launches}, on the card {device}")
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


def dev_us(e):
    """A profiler event's own device time in microseconds (the name differs across torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile_summary(prof, wall_ms, what, top):
    """Device time of `prof` by kernel and by operator, and the device's idle share."""
    from torch.autograd import DeviceType

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
        # one eager step (it reads nothing back: the synchronize ends it)
        step(poses, images, vi, vc, 1, generator=gen, occ_grid=trainer.occ_grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_TAIL_S)
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
        time.sleep(TRACE_TAIL_S)
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
            trainer = Trainer("chip_smoke", opt, new_model(opt, fp16=FULL.fp16), mute=True,
                              workspace=None)
            step = trainer._get_step_fn(1, False)
            draws = torch.Generator(device=dev).manual_seed(SEED + 9)
            m = step(poses, images, vi, vc, 0, generator=draws)
            adam = trainer.optimizer
            named = dict(trainer.model.named_parameters())
            state = {f"{k} {kind}": v for kind, ts in (("mu", adam.mu), ("nu", adam.nu))
                     for k, v in zip(adam.names, ts)}
            state["count"], state["schedule count"] = adam.count, adam.schedule_count
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
    trainer = Trainer("chip_smoke", opt, new_model(opt, fp16=FULL.fp16), ema_decay=0.95,
                      workspace=None)
    torch.cuda.synchronize()
    reset_counts()
    with device_launches() as device:
        t0 = time.perf_counter()
        trainer.train(ds, None, max_epochs=1)  # ends on the host (loss fetch)
        epoch_s = time.perf_counter() - t0
    launches = launch_counts()

    losses, steps = trainer.stats["step_loss"], trainer.global_step
    if steps != len(ds) or len(losses) != steps:
        raise AssertionError(f"training-{variant}: {steps} steps, expected {len(ds)}")
    if not np.isfinite(losses).all() or any(trainer.stats["skipped"]):
        raise AssertionError(f"training-{variant}: a loss was non-finite or a step was skipped")
    check_graphed_launches(f"training-{variant}", launches, device, trainer,
                           {f"block_hash_{variant}_fwd": 2, f"block_hash_{variant}_bwd": 2})
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    step_ms = 1e3 * epoch_s / steps
    profiled = profile_train_step(ds, trainer, top=6)
    bwd_ms = kernel_ms(profiled, f"block_hash_{variant}_bwd")
    set_variant("default")
    log(f"training-{variant} on {gpu_line()}: {steps} steps, {step_ms:.2f} ms/step; loss mean of "
        f"the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
        f"({100 * (1 - last / first):.1f}% lower); epoch mean {trainer.stats['loss'][0]:.4f} "
        f"(default variant's first epoch {default_epoch_loss:.4f}); block_hash_{variant}_bwd "
        f"{bwd_ms:.3f} ms of device time per step; launches at the wrappers {launches}, on the "
        f"card {device}")
    if not last <= 0.75 * first:
        raise AssertionError(f"training-{variant} lowered the loss by less than 25%")
    return launches, step_ms, bwd_ms


# the training-graph phase: each training path eager (--fuse_epoch 0) and
# captured (1) from one seeded state, epochs in turns
GRAPH_EPOCHS = 4  # 1-2 capture the patch-1 and [2, 8] graphs; 3-4 are timed in turns
VARIANT_GRAPH_FRAMES = 20  # the seg and win runs' epoch length (the default's is the drive's 60)


def same_training_state(a, b):
    """{what: max |a - b|} of everything two trainers hold that differs:
    the step losses, weights, EMA, Adam moments and counts, the generator
    and the occupancy grid; empty when all are equal bit for bit."""
    differ = {}
    la, lb = np.array(a.stats["step_loss"]), np.array(b.stats["step_loss"])
    if la.shape != lb.shape or not np.array_equal(la, lb):
        differ["step losses"] = float(np.abs(la - lb).max()) if la.shape == lb.shape else "length"
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    pairs = [*((f"weight {k}", v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items()),
             *((f"ema {k}", v, b.ema_params[k]) for k, v in a.ema_params.items()),
             *((f"{kind} {k}", v, sb[kind][k]) for kind in ("mu", "nu") for k, v in sa[kind].items()),
             ("generator", a.generator.get_state(), b.generator.get_state())]
    if a.occ_grid is not None:
        pairs.append(("occ grid", a.occ_grid, b.occ_grid))
    for what, x, y in pairs:
        if not torch.equal(x, y):
            differ[what] = (x.float() - y.float()).abs().max().item()
    if (sa["count"], sa["schedule_count"]) != (sb["count"], sb["schedule_count"]):
        differ["counts"] = ((sa["count"], sa["schedule_count"]), (sb["count"], sb["schedule_count"]))
    return differ


def busy_ms_per_step(trainer, ds, epoch):
    """One more epoch under torch.profiler: (device busy ms per step, the
    device timeline's span per step from its first kernel to its last,
    kernels, {kernel name: the port's kernels that ran on the card}
    (device_launches)). Busy is the union of the kernels' intervals, so the
    idle share 1 - busy / span counts the gaps between kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with device_launches() as launched, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(ds, None, max_epochs=epoch)
        torch.cuda.synchronize()
        time.sleep(TRACE_TAIL_S)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return busy / 1e3 / len(ds), span / 1e3 / len(ds), len(spans), launched


def graph_pool_bytes(handle=None):
    """Bytes reserved in the CUDA graph memory pool `handle` (None: in every
    pool outside the default one), or None if the allocator snapshot does
    not say."""
    try:
        segments = torch.cuda.memory._snapshot()["segments"]
        return sum(seg["total_size"] for seg in segments
                   if (tuple(seg["segment_pool_id"]) == tuple(handle) if handle is not None
                       else tuple(seg["segment_pool_id"]) != (0, 0)))
    except (KeyError, TypeError, RuntimeError):
        return None


def guard_cost(trainer):
    """Device ms of the DeviceAdam step (PyTorch's fused Adam with the update
    guard) on the trainer's gradients, of the guard's own pass in it (the
    finite flag of the loss and of every gradient, through the AMP non-finite
    check), and of a plain fused Adam step on the same tensors for scale.
    Returns (step ms, guard ms, plain ms, bytes of the weights and moments)."""
    adam = trainer.optimizer
    loss = torch.ones((), device="cuda")
    grads = [z if p.grad is None else p.grad for p, z in zip(adam.params, adam._zero_grads)]

    def guard():
        adam.found_inf.copy_((~torch.isfinite(loss)).float())
        torch._amp_foreach_non_finite_check_and_unscale_(grads, adam.found_inf, adam._one)

    step_ms = cuda_ms(lambda: adam.step(loss), reps=10)
    guard_ms = cuda_ms(guard, reps=10)
    plain = torch.optim.Adam(adam.params, lr=adam._lr, betas=adam.betas, eps=adam.eps, fused=True,
                             capturable=True)
    plain_ms = cuda_ms(plain.step, reps=10)
    nbytes = sum(t.numel() * t.element_size() for t in (*adam.params, *adam.mu, *adam.nu))
    return step_ms, guard_ms, plain_ms, nbytes


def training_graph_phase(name, make_trainer, ds, per_step, refresh_every=None,
                         epochs=GRAPH_EPOCHS, extra=None):
    """One training path eager (--fuse_epoch 0) and captured (1), two
    trainers from one seeded state: epochs 1-2 each (the captures), then
    epochs in turns (eager, graph; graph, eager), then one profiled epoch
    each. Their losses and final state must be equal bit for bit. Launches:
    each step launches `per_step`, and the occupancy refresh every
    `refresh_every` steps one B1 forward. The eager run's wrappers count
    every step, the graphed run's the warm-up and the capture of each graph;
    on the card, in the profiled epoch, both runs launch what the eager
    wrappers count. Returns the graphed run's wrapper counts."""
    runs = {"eager": make_trainer(0), "graph": make_trainer(1)}
    secs = {m: {} for m in runs}
    counts = {m: {} for m in runs}
    peak = {m: 0 for m in runs}
    reserved = {m: 0 for m in runs}
    order = [(m, e) for e in (1, 2) for m in ("eager", "graph")]
    for e in range(3, epochs + 1):
        order += [(m, e) for m in (("eager", "graph") if e % 2 else ("graph", "eager"))]
    for mode, epoch in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        runs[mode].train(ds, None, max_epochs=epoch)  # ends on the host: the epoch's one fetch
        secs[mode][epoch] = time.perf_counter() - t0
        for k, v in launch_counts().items():
            counts[mode][k] = counts[mode].get(k, 0) + v
        peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated())
        reserved[mode] = max(reserved[mode], torch.cuda.max_memory_reserved())

    def refreshes(first, n):  # one B1 forward before each step that refreshes
        return {"block_hash_fwd": sum(1 for s in range(first, first + n)
                                      if refresh_every and s % refresh_every == 0)}

    steps = epochs * len(ds)
    graphs = [g for f in runs["graph"]._epoch_fns.values() for g in f.graphs.values()]
    only_launches(counts["eager"], training_launches(per_step, steps, refreshes(0, steps)))
    only_launches(counts["graph"], training_launches(per_step, 2 * len(graphs),
                                                     refreshes(0, steps)))
    busy, wrappers = {}, {}
    for m in runs:
        reset_counts()
        busy[m] = busy_ms_per_step(runs[m], ds, epochs + 1)
        wrappers[m] = launch_counts()
    # the profiled epoch: the graph replays every step, Python runs only the refreshes
    epoch_launches = training_launches(per_step, len(ds), refreshes(steps, len(ds)))
    for m in runs:
        only_launches(busy[m][3], epoch_launches)
    only_launches(wrappers["eager"], epoch_launches)
    only_launches(wrappers["graph"], refreshes(steps, len(ds)))
    differ = same_training_state(runs["eager"], runs["graph"])
    gpu = gpu_line()
    ms = {m: {e: 1e3 * t / len(ds) for e, t in secs[m].items()} for m in runs}
    timed = list(range(3, epochs + 1))
    line = {m: ", ".join(f"{ms[m][e]:.2f}" for e in sorted(ms[m])) for m in runs}
    warm = {m: float(np.mean([ms[m][e] for e in timed])) for m in runs}
    idle = {m: 100 * (1 - busy[m][0] / busy[m][1]) for m in runs}
    pool = graph_pool_bytes(runs["graph"]._graph_pool.handle)
    replayed = {k: n / len(ds) for k, n in busy["graph"][3].items() if n}
    log(f"training-graph {name} on {gpu}: {steps} steps each, eager / graph ms/step by epoch "
        f"{line['eager']} / {line['graph']}; epochs {timed[0]}-{timed[-1]} in turns: eager "
        f"{warm['eager']:.2f}, graph {warm['graph']:.2f} ms/step; a profiled epoch: device busy "
        f"{busy['eager'][0]:.2f} / {busy['graph'][0]:.2f} ms/step of a device span of "
        f"{busy['eager'][1]:.2f} / {busy['graph'][1]:.2f} ms/step ({busy['eager'][2]} / "
        f"{busy['graph'][2]} kernels), idle {idle['eager']:.1f}% / {idle['graph']:.1f}%; the "
        f"port's kernels on the card per step of the profiled epoch {replayed} (wrapper counts "
        f"there: eager {wrappers['eager']}, graph {wrappers['graph']}); peak allocated "
        f"{peak['eager'] / 2**30:.2f} / {peak['graph'] / 2**30:.2f} GiB, peak reserved "
        f"{reserved['eager'] / 2**30:.2f} / {reserved['graph'] / 2**30:.2f} GiB (the process, "
        f"both trainers alive), the graphed trainer's pool "
        f"{'not measured' if pool is None else f'{pool / 2**30:.2f} GiB'}; {len(graphs)} graphs; "
        f"wrapper launches over the timed epochs eager {counts['eager']}, graph "
        f"{counts['graph']}; losses and final state (weights, EMA, Adam moments and counts, "
        f"generator{', grid' if runs['graph'].occ_grid is not None else ''}) equal bit for bit: "
        f"{not differ}" + (f"; differ: {differ}" if differ else ""))
    if differ:
        raise AssertionError(f"training-graph {name}: the captured run differs from the eager "
                             f"one: {differ}")
    if extra is not None:
        extra(runs["graph"])
    return counts["graph"]


def trainer_maker(ds, **kw):
    """fuse -> a full-width Trainer on `ds` (train_opt(ds, **kw)) from the seeded
    init, its step eager (fuse 0) or captured (1)."""
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    opt = train_opt(ds, **kw)
    return lambda fuse: Trainer("chip_smoke", SimpleNamespace(**vars(opt), fuse_epoch=fuse),
                                new_model(opt, fp16=FULL.fp16), ema_decay=0.95,
                                workspace=None, mute=True)


def first_frames(ds, n):
    """A view of the training set `ds` that holds its first n frames."""
    import copy

    view = copy.copy(ds)
    view.poses_lidar, view.images_lidar = ds.poses_lidar[:n], ds.images_lidar[:n]
    view._device_cache = {}
    return view


def training_graph_phases(ds):
    """The training-graph phase on the default, --fast, seg and win steps of
    the training cell. Returns {path: launch counts of the graphed run}."""
    def trainer_of(**kw):
        return trainer_maker(ds, **kw)

    def guard(trainer):
        step_ms, guard_ms, plain_ms, nbytes = guard_cost(trainer)
        log(f"update guard on {gpu_line()}: the DeviceAdam step {step_ms:.3f} ms (weights and "
            f"both moments {nbytes / 2**20:.1f} MiB), of which the guard's pass over the "
            f"gradients {guard_ms:.3f} ms; a plain fused Adam step {plain_ms:.3f} ms")

    b1b2 = {"block_hash_fwd": 2, "block_hash_bwd": 2}
    paths = {"training-graph": training_graph_phase("default", trainer_of(), ds, b1b2,
                                                    extra=guard)}
    paths["training-graph-fast"] = training_graph_phase("--fast", trainer_of(**FAST), ds, b1b2,
                                                        FAST["occ_update_interval"])
    # the variants on the first VARIANT_GRAPH_FRAMES frames: 20-step epochs
    for variant in VARIANT_ENV:
        set_variant(variant)
        paths[f"training-graph-{variant}"] = training_graph_phase(
            variant, trainer_of(), first_frames(ds, VARIANT_GRAPH_FRAMES),
            {f"block_hash_{variant}_fwd": 2, f"block_hash_{variant}_bwd": 2})
        set_variant("default")
    return paths


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


def b5_build_report(cases):
    """Log what each B5 instance of `cases` gets (registers, local bytes,
    blocks per SM), the spills ptxas reported and the HMMA (tensor-core mma)
    count of the built library's SASS; raise on a spill or on a library
    without HMMA (its bf16 route would not be on tensor cores)."""
    import re

    from lidarnerf_tpu_torch.ops import cuda_lib, fused_mlp_cuda

    for name, x, ws, act in cases:
        occ = fused_mlp_cuda.occupancy([x.shape[1]] + [w.shape[1] for w in ws], ws[0].dtype, act)
        log(f"fused_mlp {name} instance: {occ['registers']} registers/thread, "
            f"{occ['local_bytes']} B local (stack frame), {occ['threads']} threads and "
            f"{occ['smem_bytes']} B of shared memory a block, {occ['blocks_per_sm']} blocks/SM")
    lib = cuda_lib.library_path(fused_mlp_cuda.SOURCE)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        lib.with_suffix(".log").read_text())
    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    hmma = sum("HMMA" in ln for ln in sass.splitlines())
    log(f"fused_mlp library {lib.name}: ptxas spills (stores, loads) per kernel {spills}; "
        f"{hmma} HMMA instructions in its SASS")
    if not spills or any(a != "0" or b != "0" for a, b in spills):
        raise AssertionError(f"a fused_mlp kernel spills registers: {spills}")
    if not hmma:
        raise AssertionError("the fused_mlp library issues no HMMA: bf16 is not on tensor cores")


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
    b5_build_report(cases)

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
    trainer = Trainer("chip_smoke_fast", opt, model, ema_decay=0.95, workspace=None)
    occ = trainer.render_cfg.occ
    torch.cuda.synchronize()
    reset_counts()
    epoch_s = []
    with device_launches() as device:
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
    check_graphed_launches("training-fast", launches, device, trainer,
                           {"block_hash_fwd": 2, "block_hash_bwd": 2},
                           {"block_hash_fwd": refreshes})
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
        f"({100 * dilated:.2f}% dilated), max {trainer.occ_grid.max().item():.1f}; launches at the wrappers {launches}, on the card {device}")
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


OCC_RAYS = 4096  # the --fast step's rays: x 128 bins = 524,288 lookups
OCC_EDGES = (0, 1, -1, 2, -2)  # x G^3 offsets: the grid's ends, past them and the wrapped range


def occ_lookup_phase(ds, trainer):
    """The occ-lookup path (P12): the port's tool
    (`python -m lidarnerf_tpu_torch.tools.exp_occ_lookup`) at its shape, then
    the kernel on the real --fast traffic: the occupied volume of the trained
    grid at the bin cells that occ_bin_pdf computes for 4096 training rays of
    frame 0, bit-equal to the plain version and to the port's index, also
    on a ragged count, a view at an odd offset, indices past the grid's ends
    and in the wrapped range, and none. Then the port's index, the kernel,
    the kernel, the index in turns by CUDA events, the plain version, the
    whole occ_bin_pdf, then the device time a call without the host:
    CUDA-graph replays and a profiler pass per function, at the --fast
    traffic and at the tool's shape. Returns (launch counts, the `kernels`
    entry)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices
    from lidarnerf_tpu_torch.models.occupancy import bin_cells, occ_bin_pdf, occupied_volume
    from lidarnerf_tpu_torch.ops import device_counts
    from lidarnerf_tpu_torch.ops.occ_lookup import occ_lookup, occ_lookup_plain
    from lidarnerf_tpu_torch.tools import exp_occ_lookup

    occ, cfg = trainer.render_cfg.occ, trainer.render_cfg
    occ3 = occupied_volume(trainer.occ_grid, occ)
    n = occ3.numel()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    poses, _ = ds.device_arrays("cuda")
    inds = sample_ray_indices(ds.H_lidar, ds.W_lidar, OCC_RAYS, 1, gen, "cuda")
    o, d = rays_from_indices(poses[0], inds, ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    nears = torch.full((OCC_RAYS, 1), cfg.min_near_lidar, device="cuda")
    fars = torch.full((OCC_RAYS, 1), cfg.min_near_lidar * cfg.far_mult, device="cuda")
    flat_long = bin_cells(o, d, nears, fars, occ, FULL.bound)  # [4096, 128] int64
    flat = flat_long.int()
    edges = torch.tensor([n * k + j for k in OCC_EDGES for j in (-1, 0, 1)] + [2**31 - 1, -2**31],
                         dtype=torch.int32, device="cuda")
    wild = torch.cat([flat.reshape(-1)[:20000], edges])[
        torch.randperm(20000 + edges.numel(), generator=gen, device="cuda")]
    tool_grid, tool_idx = (torch.from_numpy(a).cuda() for a in exp_occ_lookup.inputs())
    tool_grid2d = tool_grid.reshape(-1, tool_grid.shape[-1])
    cases = {  # name: (idx, grid)
        "tool": (tool_idx, tool_grid2d),
        "fast": (flat, occ3),
        "fast ragged": (flat.reshape(-1)[:-3], occ3),
        "fast odd offset": (flat.reshape(-1)[1:], occ3.reshape(-1)),
        "out of range": (wild, occ3),
        "empty": (flat.reshape(-1)[:0], occ3),
    }

    torch.cuda.synchronize()
    reset_counts()
    with device_launches() as device:
        tool = exp_occ_lookup.main([])
        outs = {k: occ_lookup(idx, grid) for k, (idx, grid) in cases.items()}
    launches = launch_counts()
    checked = sum(idx.numel() > 0 for idx, _ in cases.values())
    only_launches(launches, {"occ_lookup": tool["launches"] + checked})
    # on the card: the tool's check; its timed graphs run with the count paused
    only_launches(device, {"occ_lookup": 1 + checked})

    checks = {"tool: max abs diff 0 and bit-equal to torch.take":
              tool["max_abs_diff"] == 0.0 and tool["bit_equal"]}
    err = 0.0
    for k, (idx, grid) in cases.items():
        plain = occ_lookup_plain(idx, grid)
        checks[f"{k} == plain"] = bit_equal(outs[k], plain)
        if k != "out of range":
            index = grid.reshape(-1)[idx.long()]
            checks[f"{k} == index"] = bit_equal(outs[k], index)
            if idx.numel():
                err = max(err, float((outs[k] - plain).abs().max()))
    inside = (wild >= -n) & (wild < n)
    checks["NaN exactly past the ends"] = torch.equal(torch.isnan(outs["out of range"]), ~inside)
    checks["tool: torch.take"] = bit_equal(outs["tool"], torch.take(tool_grid, tool_idx.long()))
    log(f"occ-lookup checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"occ-lookup: the kernel is not bit-exact: {checks}")

    # the port's index (the library call), the kernel, the kernel, the index
    occ_flat = occ3.reshape(-1)
    fns = {"index": lambda: occ_flat[flat_long], "kernel": lambda: occ_lookup(flat, occ3)}
    turns = [cuda_ms(fns[k], reps=20) for k in ("index", "kernel", "kernel", "index")]
    kernel_ms, index_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain_ms = cuda_ms(lambda: occ_lookup_plain(flat, occ3), reps=20)
    pdf_ms = cuda_ms(lambda: occ_bin_pdf(trainer.occ_grid, o, d, nears, fars, occ, FULL.bound),
                     reps=10)
    host_us = {}  # the host's enqueue time a call (the synchronize after the loop not counted)
    with device_counts.paused():
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                fn()
            host_us[k] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
    sectors = torch.unique(flat_long >> 3).numel()  # distinct 32-byte sectors of the grid
    bytes_moved = flat.numel() * 8 + sectors * 32
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3

    # the device time of a call at both shapes without the host: CUDA-graph
    # replays (the tool's method; its own shape's are in `tool`), and the
    # kernels' own durations from one profiler pass of 50 calls per function
    graph_ms = {k: exp_occ_lookup.device_ms(fn) for k, fn in fns.items()}
    tool_long = tool_idx.long()
    fns_at = {"--fast index": fns["index"], "--fast kernel": fns["kernel"],
              "tool kernel": lambda: occ_lookup(tool_idx, tool_grid2d),
              "tool torch.take": lambda: torch.take(tool_grid, tool_long)}
    profiled = {}
    with device_counts.paused():
        for label, fn in fns_at.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                time.sleep(TRACE_TAIL_S)
            profiled[label] = {e.key: (e.count, dev_us(e) / max(e.count, 1))
                               for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA and dev_us(e) > 0}
    log(f"occ-lookup on {gpu_line()}: tool {tool}; --fast traffic [{OCC_RAYS}, {occ.bins}] = "
        f"{flat.numel()} lookups into the trained {occ.grid_size}^3 volume "
        f"({100 * float(occ3.mean()):.2f}% occupied), {sectors} distinct 32-byte sectors; "
        f"in turns index, kernel, kernel, index: {' / '.join(f'{t:.4f}' for t in turns)} ms "
        f"(CUDA events, 20 calls a batch); host enqueue a call: kernel "
        f"{host_us['kernel']:.2f} us, index {host_us['index']:.2f} us; plain {plain_ms:.4f} ms; "
        f"the whole occ_bin_pdf {pdf_ms:.4f} ms, the index {100 * index_ms / pdf_ms:.1f}% of it; bound "
        f"{bound_ms:.5f} ms by bytes ({bytes_moved / 1e6:.2f} MB); CUDA-graph replays ms a "
        f"call: kernel {graph_ms['kernel']:.5f}, index {graph_ms['index']:.5f}; profiler "
        f"device us a call: " + "; ".join(
            f"{label}: " + ", ".join(f"{k[:60]} {us:.2f} x{c}" for k, (c, us) in ks.items())
            for label, ks in profiled.items()))
    entry = {
        "name": "occ_lookup", "route": "cuda", "source": "lidarnerf_tpu_torch/csrc/occ_lookup.cu",
        "replaces": "tools/exp_occ_lookup.py:29", "launches": None, "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": index_ms,
    }
    return launches, entry


# the cli phase: the port's CLI at full width on the synthetic drive, as a
# user runs it (main_lidarnerf.py with configs/kitti360_1908.txt -L: 768 + 64
# samples, a 2^19 table at 32768, 4096 rays and 4096-ray render chunks, the
# [2, 8] patch schedule, a 128^3 mesh query), three 60-step epochs with an
# evaluation after each
CLI_ARGV = ["--config", "configs/kitti360_1908.txt", "-L", "--path", DATA, "--iters", "180",
            "--eval_interval", "1", "--mesh_resolution", "128"]
CHAMFER_ULPS = 16  # the Chamfer rounding bound of tests/test_torch_metrics.py


def cli_argv(workspace, *extra, base=CLI_ARGV):
    with open(f"{DATA}/scene_constants.json") as f:
        c = json.load(f)
    # positional notation: argparse takes "-5.5e-09" for an option, "-0.0000000055" not
    num = np.format_float_positional
    return [*base, "--workspace", workspace, "--scale", num(c["scale"]),
            "--offset", *map(num, c["offset"]), *extra]


def same_meters(a, b):
    """True iff two evaluations' meters are equal bit for bit."""
    return a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def events(trainer, kind):
    return [e for e in trainer.run_log if e["event"] == kind]


def check_cli_run(what, trainer, launches, device, steps, evals_at):
    """A CLI run's steps, finite losses, evaluations (`evals_at`: their
    epochs), its one test and mesh, and its launches: B1 and B2 twice a step,
    B1 twice per render chunk (max_ray_batch rays) of every evaluated or
    tested pano and once per 128^3 mesh block (extract_fields' blocks), on
    the card and at the wrappers (check_graphed_launches). Returns the means of the
    first and the last 10 step losses."""
    losses = trainer.stats["step_loss"]
    if trainer.global_step != steps or len(losses) != steps:
        raise AssertionError(f"{what}: trained {trainer.global_step} steps, expected {steps}")
    if not np.isfinite(losses).all() or any(trainer.stats["skipped"]):
        raise AssertionError(f"{what}: a training loss was non-finite or a step was skipped")
    evals, test, mesh = events(trainer, "eval"), events(trainer, "test"), events(trainer, "mesh")
    if [e["epoch"] for e in evals] != evals_at or len(test) != 1 or len(mesh) != 1:
        raise AssertionError(f"{what}: evaluations {[e['epoch'] for e in evals]}, tests "
                             f"{len(test)}, meshes {len(mesh)}")
    for e in evals:
        if not all(np.isfinite(v).all() for v in e["meters"].values()):
            raise AssertionError(f"{what}: a meter of {e['name']} is not finite: {e['meters']}")
    opt = trainer.opt
    chunks = -(-opt.H_lidar * opt.W_lidar // opt.max_ray_batch)
    panos = sum(e["frames"] for e in evals) + test[0]["frames"]
    queries = (-(-opt.mesh_resolution // 128)) ** 3
    check_graphed_launches(what, launches, device, trainer,
                           {"block_hash_fwd": 2, "block_hash_bwd": 2},
                           {"block_hash_fwd": 2 * chunks * panos + queries})
    return float(np.mean(losses[:10])), float(np.mean(losses[-10:]))


def loss_fell(what, first, last):
    """Log the means of the first and last 10 step losses; raise unless the
    last is at least 25% below the first."""
    log(f"{what}: loss mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
        f"({100 * (1 - last / first):.1f}% lower)")
    if not last <= 0.75 * first:
        raise AssertionError(f"{what}: training lowered the loss by less than 25%")


def check_test_eval(what, cli, argv, trained):
    """The CLI with `argv` and --test_eval on the trained run's workspace
    (evaluate the test split, test, a 128^3 mesh): its meters equal the
    trained run's last evaluation bit for bit, and only B1 ran, twice per
    render chunk and once for the mesh. Returns its launch counts."""
    torch.cuda.synchronize()
    reset_counts()
    again = cli.main([*argv, "--test_eval"])
    launches = launch_counts()
    got, want = events(again, "eval"), events(trained, "eval")[-1]
    opt = again.opt
    chunks = -(-opt.H_lidar * opt.W_lidar // opt.max_ray_batch)
    panos = got[0]["frames"] + events(again, "test")[0]["frames"]
    only_launches(launches, {"block_hash_fwd": 2 * chunks * panos + 1})
    if len(got) != 1 or not same_meters(got[0]["meters"], want["meters"]):
        raise AssertionError(f"{what} --test_eval: meters {got[0]['meters']} differ from the "
                             f"trained run's {want['meters']}")
    log(f"{what} --test_eval: the test-split meters equal the trained run's bit for bit")
    return launches


def cli_train_phase(cli, ws):
    """Phase 1: train -> evaluate (val each epoch, then test) -> test -> mesh.
    Returns (trainer, launch counts, (peak bytes allocated, reserved))."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with device_launches() as device:
        trainer = cli.main(cli_argv(ws))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()

    loss_fell("cli", *check_cli_run("cli", trainer, launches, device, 180, [1, 2, 3, 3]))
    log(f"cli launches: at the wrappers {launches}, on the card {device}")
    evals, test = events(trainer, "eval"), events(trainer, "test")
    files = {p.relative_to(ws).as_posix() for p in Path(ws).rglob("*") if p.is_file()}
    tag = f"lidar_nerf_ep{trainer.epoch:04d}"
    want = {"args.txt", "log_lidar_nerf.txt", "checkpoints/lidar_nerf.ckpt",
            "checkpoints/lidar_nerf_ep0002.ckpt", "checkpoints/lidar_nerf_ep0003.ckpt",
            f"meshes/lidar_nerf_{trainer.epoch}.ply"}
    for i in range(test[0]["frames"]):
        want |= {f"results/test_{tag}_{i:04d}_{k}" for k in
                 ("depth_lidar.npy", "intensity.png", "depth.png")}
    for e in evals:
        for i in range(1, e["frames"] + 1):
            want |= {f"validation/{e['name']}_{i:04d}_{k}" for k in
                     ("rarydrop.png", "intensity.png", "depth.png", "lidar.npy")}
    if not want <= files or "checkpoints/lidar_nerf_ep0001.ckpt" in files:
        raise AssertionError(f"cli: missing {sorted(want - files)}; files {sorted(files)}")
    return trainer, launches, peak


def cli_test_eval_phase(cli, ws, trained):
    """Phase 2: --test_eval on the same workspace reproduces the meters of the
    last evaluation of the test split, then of the val split, bit for bit.
    Returns (trainer, launch counts)."""
    torch.cuda.synchronize()
    reset_counts()
    again = cli.main(cli_argv(ws, "--test_eval"))
    launches = launch_counts()
    evals = events(trained, "eval")
    got = events(again, "eval")
    H, W = again.opt.H_lidar, again.opt.W_lidar
    chunks = -(-H * W // again.opt.max_ray_batch)
    panos = got[0]["frames"] + events(again, "test")[0]["frames"]
    queries = (-(-again.opt.mesh_resolution // 128)) ** 3
    only_launches(launches, {"block_hash_fwd": 2 * chunks * panos + queries})
    if len(got) != 1 or not same_meters(got[0]["meters"], evals[-1]["meters"]):
        raise AssertionError(f"cli --test_eval: meters {got[0]['meters']} differ from the "
                             f"trained run's {evals[-1]['meters']}")
    again.evaluate(cli.build_dataset(again.opt, "val", "cuda"))
    if not same_meters(again.run_log[-1]["meters"], evals[-2]["meters"]):
        raise AssertionError(f"cli --test_eval: val meters {again.run_log[-1]['meters']} differ "
                             f"from epoch 3's {evals[-2]['meters']}")
    log("cli --test_eval: the test-split and val-split meters equal the trained run's last "
        "evaluations bit for bit")
    return again, launches


def cli_resume_phase(cli, ws, uninterrupted):
    """Phase 3: epochs 1-2, then a new Trainer from the workspace (latest
    checkpoint) trains epoch 3; its 180 step losses must equal the
    uninterrupted CLI run's bit for bit (same iters, hence the same schedule)."""
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    opt = cli.get_arg_parser().parse_args(cli_argv(ws))
    opt.enable_lidar = True
    cli.apply_macros(opt)
    ds = cli.build_dataset(opt, "train", "cuda")
    cli.attach_dims(opt, ds)

    def trainer():
        return Trainer("lidar_nerf", opt, cli.build_model(opt), ema_decay=0.95, mute=True,
                       workspace=ws)

    first = trainer()
    first.train(ds, None, max_epochs=2)
    del first
    resumed = trainer()
    if (resumed.epoch, resumed.global_step) != (2, 120):
        raise AssertionError(f"cli resume: loaded epoch {resumed.epoch}, step {resumed.global_step}")
    resumed.train(ds, None, max_epochs=3)
    a, b = resumed.stats["step_loss"], uninterrupted.stats["step_loss"]
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    if len(a) != len(b) or differ:
        raise AssertionError(f"cli resume: step losses differ at steps {differ[:10]} "
                             f"(resumed {len(a)}, uninterrupted {len(b)})")
    log("cli resume: epoch 3 after a resume from epoch 2's checkpoint repeats the "
        "uninterrupted run's 60 step losses bit for bit (and epochs 1-2 theirs)")
    return resumed


def chamfer_phase(cli, trained, ws):
    """Phase 4: the device Chamfer and F-score on test frame 0 (the test run's
    predicted cloud against the frame's) match the CPU's within the rounding
    bound of tests/test_torch_metrics.py. Returns (ms per call, points)."""
    from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar
    from lidarnerf_tpu_torch.ops.chamfer import chamfer_and_fscore, chamfer_distance

    opt = trained.opt
    ds = cli.build_dataset(opt, "test", "cuda")
    gt_depth = ds.images_lidar[0][..., 2] * ds.images_lidar[0][..., 0]
    gt = pano_to_lidar(gt_depth / opt.scale, ds.intrinsics_lidar)
    pred = np.load(f"{ws}/results/test_lidar_nerf_ep{trained.epoch:04d}_0000_depth_lidar.npy")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cd_g, f_g = chamfer_and_fscore(pred, gt, device="cuda")  # ends on the host
        ms.append((time.perf_counter() - t0) * 1e3)
    cd_c, f_c = chamfer_and_fscore(pred, gt, device="cpu")
    args = [torch.from_numpy(x.astype(np.float32)) for x in (pred, gt)]
    d_g = [d.cpu().numpy() for d in chamfer_distance(*(x.cuda() for x in args))]
    d_c = [d.numpy() for d in chamfer_distance(*args)]
    eps, near = 2.0**-23, 0
    for g, c, a, b in zip(d_g, d_c, (pred, gt), (gt, pred)):
        bound = CHAMFER_ULPS * eps * ((a**2).sum(-1) + (b**2).sum(-1).max())
        if not np.all(np.abs(g - c) <= bound):
            raise AssertionError(f"chamfer: a distance differs beyond its bound "
                                 f"(max |GPU - CPU| {np.abs(g - c).max():.3e})")
        near = max(near, int((np.abs(c - 0.05) <= bound).sum()))
    p, g = (pred**2).sum(-1), (gt**2).sum(-1)
    cd_bound = CHAMFER_ULPS * eps * (p.mean() + g.max() + g.mean() + p.max())
    log(f"chamfer on test frame 0 ({len(pred)} and {len(gt)} points): GPU {cd_g:.6f} / "
        f"F {f_g:.6f}, CPU {cd_c:.6f} / F {f_c:.6f}; |dCD| {abs(cd_g - cd_c):.3e} (bound "
        f"{cd_bound:.3e}), points within the bound of the threshold {near}")
    if abs(cd_g - cd_c) > cd_bound or abs(f_g - f_c) > 2 * near / min(len(pred), len(gt)) + 1e-12:
        raise AssertionError("chamfer: the device Chamfer or F-score disagrees with the CPU's")
    return float(np.median(ms)), (len(pred), len(gt))


def cli_phase():
    """The cli phases in a temporary workspace outside the repo, removed
    afterwards. Returns the launch counts of phase 1 and phase 2."""
    import shutil
    import tempfile

    from lidarnerf_tpu_torch import main_lidarnerf as cli

    root = tempfile.mkdtemp(prefix="lidarnerf_cli_")
    try:
        ws = os.path.join(root, "run")
        trained, launches, peak = cli_train_phase(cli, ws)
        again, test_launches = cli_test_eval_phase(cli, ws, trained)
        resumed = cli_resume_phase(cli, os.path.join(root, "resume"), trained)
        loads = events(again, "load") + events(resumed, "load")
        del again, resumed
        chamfer_ms, points = chamfer_phase(cli, trained, ws)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    gpu = gpu_line()
    epochs, evals = events(trained, "epoch"), events(trained, "eval")
    per_step = [1e3 * e["seconds"] / e["steps"] for e in epochs]
    log(f"cli train on {gpu}: ms/step by epoch (patch 1, [2, 8], 1): "
        f"{', '.join(f'{t:.2f}' for t in per_step)}; peak "
        f"memory of train -> evaluate -> test -> mesh (captured steps) {peak[0] / 2**30:.2f} GiB "
        f"allocated, {peak[1] / 2**30:.2f} GiB reserved")
    frames = sum(e["frames"] for e in evals)
    render = 1e3 * sum(e["render_s"] for e in evals) / frames
    meters = 1e3 * sum(e["meters_s"] for e in evals) / frames
    log(f"cli eval on {gpu}: {render + meters:.1f} ms/frame over {frames} frames = render "
        f"{render:.1f} + meters {meters:.1f} (of which Chamfer, both directions at "
        f"{points[0]} x {points[1]} points: {chamfer_ms:.1f} ms)")
    saves = events(trained, "save")
    full = [e for e in saves if "_ep" in os.path.basename(e["path"])]
    best = [e for e in saves if "_ep" not in os.path.basename(e["path"])]
    def secs(evs):
        return ", ".join(f"{e['seconds']:.2f}" for e in evs)

    log(f"cli checkpoints on {gpu}: full {full[-1]['bytes']} B ({full[-1]['bytes'] / 2**20:.1f} "
        f"MiB), written in {secs(full)} s; best {best[-1]['bytes']} B "
        f"({best[-1]['bytes'] / 2**20:.1f} MiB), written in {secs(best)} s; a full one loaded "
        f"in {secs(loads)} s")
    test = events(trained, "test")[0]
    mesh = events(trained, "mesh")[0]
    log(f"cli test on {gpu}: {1e3 * test['seconds'] / test['frames']:.1f} ms/frame "
        f"({test['frames']} frames, render and files)")
    log(f"cli mesh on {gpu}: {mesh['resolution']}^3 density query {mesh['query_s']:.2f} s, "
        f"marching tetrahedra {mesh['tetrahedra_s']:.2f} s, PLY write {mesh['ply_s']:.2f} s, "
        f"{mesh['triangles']} triangles")
    for e in evals:
        log(f"cli meters {e['name']} ({e['frames']} frames) on {gpu}: " + "; ".join(
            f"{k} {np.asarray(v).tolist()}" for k, v in e["meters"].items()))
    return launches, test_launches


# the mvl phase: the NeRF-MVL object path at full width (configs/nerf_mvl.txt
# -L: 768 + 64 samples, a 2^19 table at 32768, 4096 rays and 4096-ray render
# chunks, 256 x 1800 panos at (15, 40)) on a synthetic car traced on the card,
# 12 train and 2 val / 2 test frames; ten 12-step epochs (30,000 steps in the
# config's use) with the config's evaluation every 5 epochs, a 128^3 mesh.
# --scale 0.1 puts the 5-7 m orbit inside bound 1 (the offset is the OBB's mean)
MVL_FRAMES = (12, 2)  # train, val (= test)
MVL_ARGV = ["--config", "configs/nerf_mvl.txt", "-L", "--iters", "120", "--scale", "0.1",
            "--mesh_resolution", "128"]


def mvl_argv(data, workspace, *extra):
    return [*MVL_ARGV, "--path", data, "--workspace", workspace, *extra]


def inside_obb(points, obb_local):
    """Per point: within the OBB's z range and inside (or on) the convex
    quadrilateral of its four lowest corners in the xy plane, the region
    `filter_bbox_dataset` keeps, tested here by half-planes."""
    z = obb_local[:, 2]
    low = obb_local[np.argsort(z, kind="stable")[:4], :2]
    ring = low[np.argsort(np.arctan2(*(low - low.mean(0)).T[::-1]))]  # counter-clockwise
    edges = np.roll(ring, -1, axis=0) - ring
    rel = points[:, None, :2] - ring[None]
    cross = edges[None, :, 0] * rel[..., 1] - edges[None, :, 1] * rel[..., 0]
    tol = 1e-9 * max(1.0, np.abs(obb_local).max()) ** 2
    return ((points[:, 2] >= z.min()) & (points[:, 2] <= z.max())
            & (cross >= -tol).all(axis=1))


def mvl_train_phase(cli, data, ws):
    """train (masked sampling) -> evaluate (crop meters; val every 5 epochs,
    then test) -> test (OBB-cropped clouds) -> mesh. Returns (trainer,
    launch counts, (peak bytes allocated, reserved))."""
    from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with device_launches() as device:
        trainer = cli.main(mvl_argv(data, ws))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()

    opt = trainer.opt
    if (opt.H_lidar, opt.W_lidar, tuple(opt.intrinsics_lidar)) != (256, 1800, (15, 40)):
        raise AssertionError(f"mvl: pano {opt.H_lidar} x {opt.W_lidar} {opt.intrinsics_lidar}")
    loss_fell("mvl", *check_cli_run("mvl", trainer, launches, device, 120, [5, 10, 10]))
    log(f"mvl launches: at the wrappers {launches}, on the card {device}")
    ds = NeRFMVLDataset(split="test", root_path=data, scale=opt.scale)
    counts = []
    for i in range(len(ds)):
        cloud = np.load(f"{ws}/results/test_lidar_nerf_ep{trainer.epoch:04d}_{i:04d}"
                        "_depth_lidar.npy")
        counts.append(len(cloud))
        outside = int((~inside_obb(cloud, ds.OBB_local[i][:, :3])).sum())
        if not (len(cloud) and np.isfinite(cloud).all()) or outside:
            raise AssertionError(f"mvl: test cloud {i} has {len(cloud)} points, {outside} "
                                 "outside its frame's OBB")
    log(f"mvl test clouds: {counts} points, every one inside its frame's OBB")
    return trainer, launches, peak


def trainer_kernel_phase(what, trainer, seed):
    """B1 and B2 against their plain versions on the coarse queries of one
    training chunk of the trainer's own data (the CLI's train split of its
    options): num_rays_lidar rays of train frame 0, drawn from the frame's
    valid-pixel pool where the dataset has one (NeRF-MVL), with the trained
    table at the trainer's block spec, at the B1 and B2 phases' tolerances.
    Returns (B1 error, B2 worst error / slack)."""
    from lidarnerf_tpu_torch import main_lidarnerf as cli
    from lidarnerf_tpu_torch.dataset.base import rays_from_indices, sample_ray_indices
    from lidarnerf_tpu_torch.nerf.train_step import pool_draws
    from lidarnerf_tpu_torch.ops import block_hash_cuda
    from lidarnerf_tpu_torch.ops.block_hash import encode_bwd_plain, encode_plain
    from lidarnerf_tpu_torch.ops.sampling import stratified_z_vals

    dev = torch.device("cuda")
    opt, cfg = trainer.opt, trainer.render_cfg
    ds = cli.build_dataset(opt, "train", dev)
    arrays = ds.device_arrays(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = opt.num_rays_lidar
    if len(arrays) == 4:  # (poses, images, valid-pixel pools, pool sizes)
        inds = arrays[2][0][pool_draws(arrays[3][0], n, gen)]
    else:
        inds = sample_ray_indices(ds.H_lidar, ds.W_lidar, n, 1, gen, dev)
    o, d = rays_from_indices(arrays[0][0], inds, ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    near = torch.full((n, 1), cfg.min_near_lidar, device=dev)
    z = stratified_z_vals(near, near * cfg.far_mult, cfg.num_steps, perturb=True, generator=gen)
    xyz = torch.clamp(o[:, None] + d[:, None] * z[..., None], -cfg.bound, cfg.bound)
    x = ((xyz + cfg.bound) / (2 * cfg.bound)).reshape(-1, 3).contiguous()
    spec, table = trainer.model.block_spec, trainer.model.hash_table.detach()
    out = block_hash_cuda.block_hash_fwd(x, table, spec)
    err_f = (out - encode_plain(x, table, spec)).abs().max().item()
    g = torch.randn((x.shape[0], spec.output_dim), generator=gen, device=dev)
    grad = block_hash_cuda.block_hash_bwd(x, g, spec)
    ref = encode_bwd_plain(x, g, spec)
    slack = BWD_RTOL * encode_bwd_plain(x, g.abs(), spec) + BWD_ATOL
    worst = ((grad - ref).abs() / slack).max().item()
    log(f"{what} kernels on a training chunk (2^{opt.log2_hashmap_size} table, resolution "
        f"{opt.desired_resolution}, Q={x.shape[0]}, {touched_rows(x, spec)} table rows): "
        f"block_hash_fwd max_abs_err={err_f:.3e} (tol {KERNEL_ATOL}); block_hash_bwd "
        f"max_abs_err={(grad - ref).abs().max().item():.3e}, worst err / (1e-5 S + 1e-7) = "
        f"{worst:.3f}")
    if not (err_f <= KERNEL_ATOL and worst <= 1.0):
        raise AssertionError(f"{what}: a kernel disagrees with its plain version on its inputs")
    return err_f, worst


def mvl_sync_phase(trainer, data):
    """One whole masked training step (sampler, render, loss, backward, the
    guarded Adam update) under torch.cuda.set_sync_debug_mode("error"): no
    host read. The step trains the trainer it is given."""
    from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset

    ds = NeRFMVLDataset(split="train", root_path=data, scale=trainer.opt.scale)
    poses, images, vi, vc, masked = trainer._device_data(ds)
    step = trainer._get_step_fn(1, masked)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = step(poses, images, vi, vc, 3, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loss, skipped = float(m["loss"]), float(m["skipped_nonfinite"])
    if not (masked and np.isfinite(loss) and skipped == 0.0):
        raise AssertionError(f"mvl sync: masked {masked}, loss {loss}, skipped {skipped}")
    log("mvl sync: a whole masked step (sampler, render, loss, backward, guarded update) ran "
        "under set_sync_debug_mode('error') with no host read")


def mvl_pano_phase(trainer, data):
    """PanoRenderer.render_frame at 256 x 1800, (15, 40) from the trained
    weights: equal to the trainer's render of the same frame bit for bit;
    ms per warm pano (the median of 3, ending on the host)."""
    from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
    from lidarnerf_tpu_torch.utils.params import params_to_jax

    ds = NeRFMVLDataset(split="test", root_path=data, scale=trainer.opt.scale)
    renderer = PanoRenderer(trainer.opt, params_to_jax(trainer.model.state_dict()))
    pose = ds.poses_lidar[0]
    frame = renderer.render_frame(pose, 256, 1800, (15, 40))
    same = trainer._render_full_frame(ds, 0)
    if not all(np.array_equal(a, b) for a, b in zip(frame, same)):
        raise AssertionError("mvl: PanoRenderer's pano differs from the trainer's")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render_frame(pose, 256, 1800, (15, 40))  # ends on the host
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), ms


def mvl_graph_phase(cli, trained):
    """The training-graph phase on the masked (NeRF-MVL) step: the mvl
    CLI's options and training set, six 12-step epochs each way."""
    from lidarnerf_tpu_torch.nerf.trainer import Trainer

    opt = trained.opt
    ds = cli.build_dataset(opt, "train", "cuda")

    def make(fuse):
        return Trainer("chip_smoke_mvl", SimpleNamespace(**{**vars(opt), "fuse_epoch": fuse}),
                       cli.build_model(opt), ema_decay=0.95, workspace=None, mute=True)

    return training_graph_phase("masked (NeRF-MVL)", make, ds,
                                {"block_hash_fwd": 2, "block_hash_bwd": 2}, epochs=6)


def mvl_phase():
    """The mvl phases in a temporary directory outside the repo, removed
    afterwards. Returns the launch counts of the training run, of
    --test_eval and of the masked training-graph run."""
    import shutil
    import tempfile

    from lidarnerf_tpu_torch import main_lidarnerf as cli
    from lidarnerf_tpu_torch.tools import make_synth_mvl

    gpu = gpu_line()
    root = tempfile.mkdtemp(prefix="lidarnerf_mvl_")
    try:
        data, ws = os.path.join(root, "data"), os.path.join(root, "run")
        n_train, n_val = MVL_FRAMES
        secs = make_synth_mvl.main(data, n_train, n_val)
        log(f"mvl data on {gpu}: {len(secs)} frames of {make_synth_mvl.H} x {make_synth_mvl.W} "
            f"traced and written, {np.mean(secs):.3f} s/frame (first {secs[0]:.3f}, median "
            f"{np.median(secs):.3f})")
        trained, launches, peak = mvl_train_phase(cli, data, ws)

        test_launches = check_test_eval("mvl", cli, mvl_argv(data, ws), trained)

        trainer_kernel_phase("mvl", trained, SEED + 12)
        mvl_sync_phase(trained, data)
        pano_ms, pano_all = mvl_pano_phase(trained, data)
        graph_launches = mvl_graph_phase(cli, trained)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    epochs, evals = events(trained, "epoch"), events(trained, "eval")
    per_step = [1e3 * e["seconds"] / e["steps"] for e in epochs]
    log(f"mvl train on {gpu}: ms/step by epoch: {', '.join(f'{t:.2f}' for t in per_step)}; "
        f"peak memory of train -> evaluate -> test -> mesh "
        f"(captured steps) {peak[0] / 2**30:.2f} GiB allocated, {peak[1] / 2**30:.2f} GiB reserved")
    frames = sum(e["frames"] for e in evals)
    render = 1e3 * sum(e["render_s"] for e in evals) / frames
    meters = 1e3 * sum(e["meters_s"] for e in evals) / frames
    log(f"mvl eval on {gpu}: {render + meters:.1f} ms/frame over {frames} frames = render "
        f"{render:.1f} + meters {meters:.1f}")
    log(f"mvl pano on {gpu}: PanoRenderer.render_frame 256 x 1800 (460,800 rays, 768 + 64 "
        f"samples, 4096-ray chunks) {pano_ms:.1f} ms (runs {', '.join(f'{t:.1f}' for t in pano_all)})")
    test, mesh = events(trained, "test")[0], events(trained, "mesh")[0]
    log(f"mvl test on {gpu}: {1e3 * test['seconds'] / test['frames']:.1f} ms/frame "
        f"({test['frames']} frames, render, crop and files)")
    log(f"mvl mesh on {gpu}: {mesh['resolution']}^3 density query {mesh['query_s']:.2f} s, "
        f"marching tetrahedra {mesh['tetrahedra_s']:.2f} s, PLY write {mesh['ply_s']:.2f} s, "
        f"{mesh['triangles']} triangles")
    for e in evals:
        log(f"mvl meters {e['name']} ({e['frames']} frames) on {gpu}: " + "; ".join(
            f"{k} {np.asarray(v).tolist()}" for k, v in e["meters"].items()))
    return launches, test_launches, graph_launches


# the onramp phase: the port's data on-ramp on this machine, with no JAX. A raw
# KITTI-360 tree of sequence 1908's 64-frame window (calibration, poses,
# cam0_to_world.txt, one HDL-64 sweep of ~131k points a frame, cast from the
# street of tools/make_synth_drive.py) -> the port's check_dataset with no
# --max_frames (its stage 5 the check's reduced smoke train on the card) -> the
# CLI at the full width of configs/kitti360_1908.txt -L on the built dataset,
# with the scale and offset that stage 4 computed, two epochs (--iters 120;
# 30,000 in use), then --test_eval. Then a raw NeRF-MVL tree of one class
# (`car`: make_synth_mvl's traced panos turned into point clouds) ->
# compute_dataset_bbox and generate_mvl_rangeviews (create_nerf_mvl_rangeview's
# calls, on the one class) -> nerfmvl_to_nerf -> a few masked steps at
# 256 x 1800 and one test frame. Cut to keep the script inside its time: the
# MVL tree's 24 frames (the class's stride 3 keeps 8 for training, val and
# test frame 0) and its 40 steps (5 epochs, evaluated after the 5th as the
# config says; 8 steps on 4 frames left the test cloud empty).
ONRAMP_ITERS = 120
ONRAMP_MVL_FRAMES = (22, 1)  # make_synth_mvl's train, val (= test): 24 raw frames
ONRAMP_MVL_ITERS = 40
NATIVE_RTOL = 1e-6  # tests/test_native.py's: the library's double against numpy's float32 ranges


def onramp_native_phase(root, frame_ids):
    """The host projection of every raw frame through the native library and
    through its numpy version, in turns, held as tests/test_native.py holds
    them. Returns (native ms/frame, numpy ms/frame, worst relative depth
    difference)."""
    from lidarnerf_tpu_torch import native
    from lidarnerf_tpu_torch.dataset import convert
    from lidarnerf_tpu_torch.preprocess.kitti360_loader import KITTI360Loader

    k3 = KITTI360Loader(root)
    scans = [k3.load_lidar_points("2013_05_28_drive_0000", f) for f in frame_ids]
    args = (66, 1030, INTRINSICS, 80.0)
    ms = {"native": [], "numpy": []}
    worst = 0.0
    for pts in scans:
        t0 = time.perf_counter()
        pano_n, inten_n = native.lidar_to_pano_with_intensities(pts, *args)
        t1 = time.perf_counter()
        pano_p, inten_p = convert.lidar_to_pano_with_intensities(pts, *args)
        t2 = time.perf_counter()
        ms["native"].append(1e3 * (t1 - t0))
        ms["numpy"].append(1e3 * (t2 - t1))
        same = pano_n == pano_p
        if not (np.allclose(pano_n, pano_p, rtol=NATIVE_RTOL, atol=1e-9)
                and np.allclose(inten_n[same], inten_p[same], rtol=NATIVE_RTOL)):
            raise AssertionError("onramp: the native projection disagrees with numpy's")
        worst = max(worst, float((np.abs(pano_n - pano_p) / np.maximum(pano_p, 1e-9)).max()))
    return float(np.median(ms["native"])), float(np.median(ms["numpy"])), worst


def write_mvl_raw(traced, raw):
    """The raw NeRF-MVL tree of make_synth_mvl's traced frames: per frame (in
    train, val, test order) the hits of its pano as a [N, 4] float32 cloud
    (intensity x 255, NeRF-MVL's units) in `raw/car/<i>.npy`, and the poses
    in `raw/car/lidar2world.txt`. Returns the points per frame."""
    from lidarnerf_tpu_torch.dataset.convert import pano_to_lidar_with_intensities
    from lidarnerf_tpu_torch.tools import make_synth_mvl

    frames = []
    for split in ("train", "val", "test"):
        with open(os.path.join(traced, f"transforms_car_{split}.json")) as f:
            frames += json.load(f)["frames"]
    os.makedirs(os.path.join(raw, "car"))
    counts = []
    for i, fr in enumerate(frames):
        data = np.load(os.path.join(traced, fr["lidar_file_path"]))["data"]
        depth = np.where(data[..., 2] > 0, data[..., 2], 0.0)
        pts = pano_to_lidar_with_intensities(depth, 255.0 * data[..., 1], make_synth_mvl.K_LIDAR)
        np.save(os.path.join(raw, "car", f"{i}.npy"), pts.astype(np.float32))
        counts.append(len(pts))
    np.savetxt(os.path.join(raw, "car", "lidar2world.txt"),
               np.stack([np.asarray(fr["lidar2world"]).ravel() for fr in frames]))
    return counts


def onramp_mvl_phase(cli, root, gpu):
    """The NeRF-MVL on-ramp: traced frames -> a raw `car` tree -> the port's
    compute_dataset_bbox, generate_mvl_rangeviews and nerfmvl_to_nerf -> the CLI with
    configs/nerf_mvl.txt -L for a few steps, its test frame's cloud inside
    the OBB. Returns the run's launch counts."""
    from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset
    from lidarnerf_tpu_torch.preprocess import nerfmvl_to_nerf
    from lidarnerf_tpu_torch.preprocess import rangeview as rv
    from lidarnerf_tpu_torch.tools import make_synth_mvl

    seconds = {}
    t0 = time.perf_counter()
    make_synth_mvl.main(os.path.join(root, "traced"), *ONRAMP_MVL_FRAMES)
    parent = os.path.join(root, "mvl", "data", "nerf_mvl")
    counts = write_mvl_raw(os.path.join(root, "traced"), os.path.join(parent, "nerf_mvl_7k"))
    seconds["trace and raw tree"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # create_nerf_mvl_rangeview's two calls, on the tree's one class
    bbox = rv.compute_dataset_bbox(["car"], os.path.join(parent, "nerf_mvl_7k"), parent)
    rv.generate_mvl_rangeviews(["car"], bbox, parent, os.path.join(parent, "nerf_mvl_7k_pano"))
    seconds["compute_dataset_bbox and generate_mvl_rangeviews"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nerfmvl_to_nerf.main(["--path", parent, "--classes", "car"])
    seconds["nerfmvl_to_nerf"] = time.perf_counter() - t0
    bbox = np.load(os.path.join(parent, "dataset_bbox_7k.npy"), allow_pickle=True).item()
    panos = sorted(Path(parent, "nerf_mvl_7k_pano", "car").glob("*.npz"))
    pano = np.load(panos[0])["data"]
    if list(bbox) != ["car"] or len(panos) != len(counts) or pano.shape != (256, 1800, 3):
        raise AssertionError(f"onramp mvl: bbox {list(bbox)}, {len(panos)} panos, {pano.shape}")
    hits = int((pano[..., 2] > 0).sum())
    if not hits > 0.5 * counts[0]:
        raise AssertionError(f"onramp mvl: frame 0 has {hits} hits in its pano of {counts[0]} points")

    ws = os.path.join(root, "mvl_run")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with device_launches() as device:
        trainer = cli.main(["--config", "configs/nerf_mvl.txt", "-L", "--path", parent,
                            "--workspace", ws, "--iters", str(ONRAMP_MVL_ITERS), "--scale", "0.1"])
    seconds["train, evaluate, test, mesh"] = time.perf_counter() - t0
    launches = launch_counts()
    n_train = len(range(0, len(counts), 3))  # the class's stride: every third frame
    epochs = -(-ONRAMP_MVL_ITERS // n_train)
    first, last = check_cli_run("onramp mvl", trainer, launches, device, epochs * n_train,
                                [*range(5, epochs + 1, 5), epochs])
    loss_fell("onramp mvl", first, last)
    ds = NeRFMVLDataset(split="test", root_path=parent, scale=trainer.opt.scale)
    cloud = np.load(f"{ws}/results/test_lidar_nerf_ep{trainer.epoch:04d}_0000_depth_lidar.npy")
    outside = int((~inside_obb(cloud, ds.OBB_local[0][:, :3])).sum())
    if not (len(cloud) and np.isfinite(cloud).all()) or outside:
        raise AssertionError(f"onramp mvl: test cloud of {len(cloud)} points, {outside} outside the OBB")
    epochs = events(trainer, "epoch")
    log(f"onramp mvl on {gpu}: {len(counts)} raw frames of {min(counts)}-{max(counts)} points -> "
        f"{len(panos)} panos of 256 x 1800 (frame 0 {hits} hits); seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + f"; {trainer.global_step} masked steps, ms/step by epoch "
        + ", ".join(f"{1e3 * e['seconds'] / e['steps']:.2f}" for e in epochs)
        + f", loss mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f}; "
        f"test cloud {len(cloud)} points, all inside the OBB; launches at the wrappers "
        f"{launches}, on the card {device}")
    for e in events(trainer, "eval"):
        log(f"onramp mvl meters {e['name']} ({e['frames']} frames) on {gpu}: " + "; ".join(
            f"{k} {np.asarray(v).tolist()}" for k, v in e["meters"].items()))
    return launches


def onramp_replay_phase(trainer):
    """Four more epochs of the trained run, each a replay of the graph that
    the run captured for its patch size (1 in odd epochs, 2 x 8 in even
    ones): two untraced, then two under torch.profiler (busy_ms_per_step),
    which must run B1 and B2 twice a step on the card and neither at the
    wrappers. No checkpoint is written: the trace's span holds the steps
    alone. Returns [(epoch, patch, traced, ms/step, device busy ms/step,
    span ms/step)], busy and span None where untraced."""
    ds = trainer._data[0]  # the run's train split: its graphs read that split's tensors
    trainer.workspace = None
    graphs = sum(len(f.graphs) for f in trainer._epoch_fns.values())
    reset_counts()
    rows = []
    for traced in (False, False, True, True):
        busy = span = None
        if traced:
            busy, span, _, records = busy_ms_per_step(trainer, ds, trainer.epoch + 1)
            only_launches(records, training_launches({"block_hash_fwd": 2, "block_hash_bwd": 2},
                                                     len(ds)))
        else:
            trainer.train(ds, None, max_epochs=trainer.epoch + 1)
        e = events(trainer, "epoch")[-1]
        patch = "2 x 8" if e["epoch"] % trainer.opt.change_patch_size_epoch == 0 else "1"
        rows.append((e["epoch"], patch, traced, 1e3 * e["seconds"] / e["steps"], busy, span))
    if sum(len(f.graphs) for f in trainer._epoch_fns.values()) != graphs:
        raise AssertionError("onramp replay: an epoch captured a new graph")
    only_launches(launch_counts(), {})
    return rows


def onramp_phase():
    """The onramp phases in a temporary directory outside the repo, removed
    afterwards. Returns the launch counts of the check's smoke train, the
    full-width run, its --test_eval and the MVL run."""
    import shutil
    import tempfile

    from lidarnerf_tpu_torch import main_lidarnerf as cli
    from lidarnerf_tpu_torch import native
    from lidarnerf_tpu_torch.preprocess.to_nerf import KITTI_SEQUENCES
    from lidarnerf_tpu_torch.tools.check_dataset import check_dataset
    from lidarnerf_tpu_torch.tools.make_synth_drive import write_kitti360_raw

    gpu = gpu_line()
    t0 = time.perf_counter()
    native.build()  # the phase needs the native route: a failed build raises here
    if native.route() != "native":
        raise AssertionError(f"onramp: the native library did not load: {native.build_error()}")
    build_s = time.perf_counter() - t0
    seq = KITTI_SEQUENCES["1908"]
    frame_ids = list(range(seq["start"], seq["end"] + 1))
    root = tempfile.mkdtemp(prefix="lidarnerf_onramp_")
    try:
        raw, out = os.path.join(root, "KITTI-360"), os.path.join(root, "kitti360")
        t0 = time.perf_counter()
        counts = write_kitti360_raw(raw, frame_ids)
        raw_s = time.perf_counter() - t0
        native_ms, numpy_ms, worst = onramp_native_phase(raw, frame_ids)
        log(f"onramp raw tree on {gpu}: {len(counts)} frames of {min(counts)}-{max(counts)} "
            f"points (mean {np.mean(counts):.0f}, {16 * sum(counts) / 2**20:.1f} MiB of scans) "
            f"cast in {raw_s:.2f} s; native library built or found in {build_s:.2f} s; "
            f"projection per frame native {native_ms:.2f} ms ({1e3 / native_ms:.1f} panos/s), "
            f"numpy {numpy_ms:.2f} ms ({1e3 / numpy_ms:.1f} panos/s), worst relative depth "
            f"difference {worst:.3e} (rtol {NATIVE_RTOL})")

        # the check: stages 1-4 on the host, stage 5 the smoke train on the card
        torch.cuda.synchronize()
        reset_counts()
        with device_launches() as check_device:
            res = check_dataset(raw, out, sequence_id="1908",
                                workspace=os.path.join(root, "check_ws"))
        check_launches = launch_counts()
        if res["route"] != "native":
            raise AssertionError(f"onramp: stage 2 projected through {res['route']}")
        loss_fell("onramp check", *check_cli_run("onramp check", res["trainer"], check_launches,
                                                 check_device, len(frame_ids) - len(seq["val"]),
                                                 [1]))
        trainer_kernel_phase("onramp check", res["trainer"], SEED + 14)
        secs = res["seconds"]
        log(f"onramp check on {gpu}: seconds by stage " + ", ".join(
            f"{k} {v:.2f}" for k, v in secs.items())
            + f"; stage 2 {len(frame_ids) / secs[2]:.1f} panos/s (read, {res['route']} "
            f"projection, write); last frame fill rate {res['fill_rate']:.3f}; computed scale "
            f"{res['scale']!r} against the baked {res['baked_scale']!r} (ratio "
            f"{res['scale'] / res['baked_scale']:.3f}), offset {[float(v) for v in res['offset']]}, "
            f"near {res['near']:.3f}, far {res['far']:.3f}; smoke train "
            f"{res['trainer'].global_step} steps; "
            f"launches at the wrappers {check_launches}, on the card {check_device}")
        offset, scale = res["offset"], res["scale"]
        del res

        # the built dataset at full width, with the constants stage 4 computed
        num = np.format_float_positional
        with open(os.path.join(out, "transforms_1908_train.json")) as f:
            n_train = len(json.load(f)["frames"])
        argv = ["--config", "configs/kitti360_1908.txt", "-L", "--path", out, "--workspace",
                os.path.join(root, "run"), "--iters", str(ONRAMP_ITERS), "--scale", num(scale),
                "--offset", *map(num, offset)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_counts()
        with device_launches() as device:
            trained = cli.main(argv)
        train_launches = launch_counts()
        epochs = -(-ONRAMP_ITERS // n_train)
        loss_fell("onramp train", *check_cli_run("onramp train", trained, train_launches, device,
                                                 epochs * n_train, [epochs]))
        test_launches = check_test_eval("onramp", cli, argv, trained)
        want = events(trained, "eval")[-1]
        per_step = [1e3 * e["seconds"] / e["steps"] for e in events(trained, "epoch")]
        replay = onramp_replay_phase(trained)
        log(f"onramp train on {gpu}: {epochs * n_train} steps at "
            f"configs/kitti360_1908.txt -L width, ms/step by epoch "
            f"{', '.join(f'{t:.2f}' for t in per_step)} (each the first epoch of its patch size, "
            f"its graph's eager warm-up and capture included); launches at "
            f"the wrappers {train_launches}, on the card {device}; --test_eval {test_launches}")
        log(f"onramp train on {gpu}: epochs of graph replay only: " + "; ".join(
            f"epoch {e} (patch {p}, {'traced' if t else 'untraced'}) {ms:.2f} ms/step"
            + (f", device busy {busy:.2f} of a {span:.2f} ms/step span (idle share "
               f"{1 - busy / span:.3f})" if t else "")
            for e, p, t, ms, busy, span in replay))
        log(f"onramp meters {want['name']} ({want['frames']} frames) on {gpu}: " + "; ".join(
            f"{k} {np.asarray(v).tolist()}" for k, v in want["meters"].items()))
        del trained
        torch.cuda.empty_cache()

        mvl_launches = onramp_mvl_phase(cli, root, gpu)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return check_launches, train_launches, test_launches, mvl_launches


# the encodings phase: the reference-exact hash grid (`--encoding hashgrid`,
# ops/hash_grid.py: plain PyTorch, no TPU kernel behind it) at the KITTI-360
# model's full width (16 levels, base 16, 2^19 budget, desired resolution
# 32768, hidden 64, bf16, 768 + 64 samples, 4096 rays) through the CLI on the
# drive, --iters 120 with an evaluation every epoch, then --test_eval; then
# the step eager and captured in turns, and 20 steps of each other encoding
ENC_ARGV = ["--config", "configs/kitti360_1908.txt", "-L", "--path", DATA, "--iters", "120",
            "--eval_interval", "1", "--encoding", "hashgrid"]
OTHER_ENCODINGS = {"tiledgrid": {}, "periodic_volume": {"log2_hashmap_size": 18},
                   "frequency": {}}
OTHER_STEPS = 20
# the hash grid's forward on the card vs the CPU: the same float32 products
# (positions rounded once through float64 on both), the 8 corners summed in
# another order; relative to the table's largest entry, which bounds a feature
HASHGRID_RTOL = 1e-6
CAPTURE_FRAMES = 10  # the steps of each of the two captured runs held bit-equal
GRAPH_FRAMES = 10  # the steps of an epoch of the hashgrid training-graph run


def hashgrid_kernel_phase(trainer, ds):
    """The hash grid's encoder on one 4096-ray training chunk's coarse
    queries (Q = 4096 x 768) with the trained table: the table gradient twice
    on the card, bit-equal; forward and table gradient timed; the forward and
    the table gradient on 131,072 of those queries on the card against the
    CPU. Returns (forward ms, table-gradient ms, queries)."""
    from lidarnerf_tpu_torch.ops import hash_grid as hg

    spec, table = trainer.model.grid_spec, trainer.model.hash_table.detach()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x = training_chunk_queries(ds, "cuda", gen)
    g = torch.randn((x.shape[0], spec.output_dim), generator=gen, device="cuda")
    a, b = hg.encode_bwd(x, g, spec), hg.encode_bwd(x, g, spec)
    if not bit_equal(a, b):
        raise AssertionError("hashgrid: two table-gradient calls on one input differ")
    fwd_ms = cuda_ms(lambda: hg.hash_grid_encode(x, table, spec), reps=3)
    bwd_ms = cuda_ms(lambda: hg.encode_bwd(x, g, spec), reps=3)
    sub = slice(0, 131072)
    gpu = hg.hash_grid_encode(x[sub], table, spec).cpu()
    cpu = hg.hash_grid_encode(x[sub].cpu(), table.cpu(), spec)
    scale = float(table.abs().max())
    err = float((gpu - cpu).abs().max())
    grad_g = hg.encode_bwd(x[sub], g[sub], spec).cpu()
    grad_c = hg.encode_bwd(x[sub].cpu(), g[sub].cpu(), spec)
    slack = BWD_RTOL * hg.encode_bwd(x[sub].cpu(), g[sub].abs().cpu(), spec) + BWD_ATOL
    worst = float(((grad_g - grad_c).abs() / slack).max())
    log(f"hashgrid encoder on {gpu_line()}: Q = {x.shape[0]} training-chunk queries, "
        f"{spec.num_levels} levels, {spec.table_rows} x {spec.level_dim} table: forward "
        f"{fwd_ms:.3f} ms, table gradient {bwd_ms:.3f} ms (two calls bit-equal); on "
        f"{sub.stop} of them the card vs the CPU: forward max |diff| {err:.3e} (table scale "
        f"{scale:.3e}), table gradient bit-equal {bit_equal(grad_g, grad_c)}, worst |diff| / "
        f"slack {worst:.3e}")
    if err > HASHGRID_RTOL * max(scale, 1.0) or worst > 1.0:
        raise AssertionError("hashgrid: the card's encoder disagrees with the CPU's")
    return fwd_ms, bwd_ms, x.shape[0]


def encodings_cli_phase(cli, ws):
    """The CLI with --encoding hashgrid at full width: train (120 steps, an
    evaluation every epoch) -> evaluate -> test -> mesh, then --test_eval,
    whose meters equal the trained run's bit for bit. No kernel of the port
    is launched. Returns (trainer, (peak bytes
    allocated, reserved), the --test_eval trainer)."""
    argv = cli_argv(ws, base=ENC_ARGV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer = cli.main(argv)
    peak = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    # a captured step's launches are counted at its capture: none here means
    # none in any replay (the profiled epoch of the training-graph run below
    # counts them on the card too)
    only_launches(launch_counts(), {})
    losses = trainer.stats["step_loss"]
    if trainer.global_step != 120 or len(losses) != 120:
        raise AssertionError(f"encodings: trained {trainer.global_step} steps, expected 120")
    if not np.isfinite(losses).all() or any(trainer.stats["skipped"]):
        raise AssertionError("encodings: a training loss was non-finite or a step was skipped")
    if trainer.model.grid_spec is None or sum(len(f.graphs) for f in
                                              trainer._epoch_fns.values()) != 2:
        raise AssertionError("encodings: the run did not train a hash grid through two graphs")
    evals = events(trainer, "eval")
    if [e["epoch"] for e in evals] != [1, 2, 2] or len(events(trainer, "test")) != 1 or len(
            events(trainer, "mesh")) != 1:
        raise AssertionError(f"encodings: evaluations {[e['epoch'] for e in evals]}")
    for e in evals:
        if not all(np.isfinite(v).all() for v in e["meters"].values()):
            raise AssertionError(f"encodings: a meter of {e['name']} is not finite")
    loss_fell("encodings (hashgrid)", float(np.mean(losses[:10])), float(np.mean(losses[-10:])))
    reset_counts()
    again = cli.main([*argv, "--test_eval"])
    only_launches(launch_counts(), {})
    got = events(again, "eval")
    if len(got) != 1 or not same_meters(got[0]["meters"], evals[-1]["meters"]):
        raise AssertionError(f"encodings --test_eval: meters {got[0]['meters']} differ from "
                             f"the trained run's {evals[-1]['meters']}")
    log("encodings (hashgrid) --test_eval: the test-split meters equal the trained run's bit "
        "for bit; no kernel of the port ran (B1-B6: 0 launches at the wrappers, warm-ups and "
        "captures included)")
    return trainer, peak, again


def warm_pano_ms(trainer, ds):
    """ms of a warm full-width pano of frame 0 through PanoRenderer from the
    trained EMA weights (the second of two renders), and its launches."""
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
    from lidarnerf_tpu_torch.utils.params import params_to_jax

    renderer = PanoRenderer(trainer.opt, params_to_jax(trainer.ema_params))
    reset_counts()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = renderer.render_frame(ds.poses_lidar[0], ds.H_lidar, ds.W_lidar,
                                      ds.intrinsics_lidar)  # ends on the host
        times.append(1e3 * (time.perf_counter() - t0))
    for name, a in zip(("raydrop", "intensity", "depth"), frame):
        if a.shape != (ds.H_lidar, ds.W_lidar) or not np.isfinite(a).all():
            raise AssertionError(f"encodings: the served {name} pano is not finite")
    only_launches(launch_counts(), {})
    return times


def two_captured_runs_phase(ds):
    """Two captured hashgrid trainers from one seeded state, CAPTURE_FRAMES
    steps each: losses and final state bit-equal."""
    make = trainer_maker(ds, encoding="hashgrid")
    sub = first_frames(ds, CAPTURE_FRAMES)
    runs = []
    for _ in range(2):
        t = make(1)
        t.train(sub, None, max_epochs=1)
        runs.append(t)
    differ = same_training_state(*runs)
    log(f"encodings (hashgrid): two captured runs of {CAPTURE_FRAMES} steps from one seeded "
        f"state equal bit for bit (losses, weights, EMA, Adam, generator): {not differ}")
    if differ:
        raise AssertionError(f"encodings: two captured runs differ: {differ}")


def other_encodings_phase(ds):
    """OTHER_STEPS captured steps at full width under each other encoding:
    ms/step (the graph's warm-up and capture included), finite losses, no
    kernel of the port. Returns {encoding: ms/step}."""
    sub = first_frames(ds, OTHER_STEPS)
    out = {}
    for name, kw in OTHER_ENCODINGS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = trainer_maker(ds, encoding=name, **kw)(1)
        t0 = time.perf_counter()
        t.train(sub, None, max_epochs=1)  # ends on the host (the epoch's one fetch)
        out[name] = 1e3 * (time.perf_counter() - t0) / OTHER_STEPS
        losses = t.stats["step_loss"]
        only_launches(launch_counts(), {})
        if len(losses) != OTHER_STEPS or not np.isfinite(losses).all() or any(t.stats["skipped"]):
            raise AssertionError(f"encodings ({name}): a loss was non-finite or a step skipped")
        log(f"encodings ({name}{', ' + str(kw) if kw else ''}) on {gpu_line()}: {OTHER_STEPS} "
            f"captured steps at full width, {out[name]:.2f} ms/step (warm-up and capture "
            f"included); losses first {losses[0]:.4f}, last {losses[-1]:.4f}, all finite; peak "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del t
        torch.cuda.empty_cache()
    return out


def encodings_phase(ds):
    """The encodings phases in a temporary workspace outside the repo,
    removed afterwards. Returns the launch counts (none) of the CLI run."""
    import shutil
    import tempfile

    from lidarnerf_tpu_torch import main_lidarnerf as cli

    root = tempfile.mkdtemp(prefix="lidarnerf_enc_")
    try:
        trained, peak, again = encodings_cli_phase(cli, os.path.join(root, "run"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gpu = gpu_line()
    epochs = events(trained, "epoch")
    per_step = [1e3 * e["seconds"] / e["steps"] for e in epochs]
    evals = events(trained, "eval")
    frames = sum(e["frames"] for e in evals)
    render = 1e3 * sum(e["render_s"] for e in evals) / frames
    test, mesh = events(again, "test")[0], events(trained, "mesh")[0]
    log(f"encodings (hashgrid) cli on {gpu}: ms/step by epoch (patch 1, [2, 8]; capture "
        f"included) {', '.join(f'{t:.2f}' for t in per_step)};"
        f" peak memory of train -> evaluate -> test -> mesh {peak[0] / 2**30:.2f} GiB allocated, "
        f"{peak[1] / 2**30:.2f} GiB reserved; eval render {render:.1f} ms/frame over {frames} "
        f"frames; test {1e3 * test['seconds'] / test['frames']:.1f} ms/frame; mesh "
        f"{mesh['resolution']}^3 query {mesh['query_s']:.2f} s")
    for e in (evals[-1], *events(again, "eval")):
        log(f"encodings (hashgrid) meters {e['name']} ({e['frames']} frames) on {gpu}: " + "; ".join(
            f"{k} {np.asarray(v).tolist()}" for k, v in e["meters"].items()))
    pano = warm_pano_ms(trained, ds)
    log(f"encodings (hashgrid) serving on {gpu}: a full-width {ds.H_lidar}x{ds.W_lidar} pano "
        f"of frame 0 from the trained EMA weights {pano[0]:.1f} ms cold, {pano[1]:.1f} ms warm")
    fwd_ms, bwd_ms, q = hashgrid_kernel_phase(trained, ds)
    del trained, again
    torch.cuda.empty_cache()
    # eager and captured in turns on the first GRAPH_FRAMES frames: epochs 1-2
    # capture the patch-1 and [2, 8] graphs, epochs 3-4 are timed in turns, a
    # fifth profiled (no kernel of the port on the card)
    training_graph_phase("hashgrid", trainer_maker(ds, encoding="hashgrid"),
                         first_frames(ds, GRAPH_FRAMES), {})
    torch.cuda.empty_cache()
    two_captured_runs_phase(ds)
    torch.cuda.empty_cache()
    other = other_encodings_phase(ds)
    log(f"encodings summary on {gpu}: hashgrid encoder forward {fwd_ms:.3f} ms and table "
        f"gradient {bwd_ms:.3f} ms at Q = {q}; the other encodings' ms/step "
        + ", ".join(f"{k} {v:.2f}" for k, v in other.items()))
    return {k: 0 for k in launch_counts()}


# the rgb phase: RGB rendering (cal_lidar_color=False) of a pinhole frame at
# KITTI-360's perspective size with the rectified camera 0's intrinsics
# (perspective.txt P_rect_00, as tools/make_synth_drive.py writes it), through
# the full-width hashgrid model in fp32 with seeded weights in the JAX layout,
# once over the background sphere and once over white; a subset of the rays
# rendered on the CPU from the same weights
RGB_H, RGB_W = 376, 1408
RGB_INTRINSICS = (552.554261, 552.554261, 682.049453, 238.769549)  # fx, fy, cx, cy
RGB_BG_RADIUS = 32.0
RGB_CPU_RAYS = 1024
RGB_RTOL, RGB_ATOL = 2.5e-4, 1e-5


def smooth_hash_levels(table, spec):
    """Write a smooth O(1) field into the dense levels of a hash-grid table
    (each corner row a smooth function of its position), as
    smooth_dense_levels does for the block hash."""
    for level in spec.levels:
        if level.n_dense_dims != 3:
            continue
        k = level.resolution + 1  # corners per axis
        c = np.stack(np.meshgrid(*[np.arange(k)] * 3, indexing="ij"), -1).reshape(-1, 3)
        rows = (c[:, 0] + c[:, 1] * k + c[:, 2] * k * k) % level.size + level.offset
        p = 2.0 * (c - 0.5) / level.scale - 1.0
        table[rows, 0] = np.sin(4 * p[:, 0] + 3 * p[:, 1]) + np.cos(5 * p[:, 2])
        table[rows, 1] = np.cos(3 * p[:, 0] - 4 * p[:, 2]) * np.sin(2 * p[:, 1])


def hashgrid_flax_params(seed, bg_radius):
    """The full-width hashgrid model's parameters in the JAX package's flax
    layout, drawn from `seed` (JAX init laws; the dense levels smooth, the
    density output sharpened, the background grid's coarsest level O(1))."""
    from lidarnerf_tpu_torch.ops.hash_grid import make_hash_grid_spec

    rng = np.random.default_rng(seed)
    spec = make_hash_grid_spec(log2_hashmap_size=FULL.log2_hashmap_size,
                               desired_resolution=FULL.desired_resolution)

    def mlp(dims):
        return {f"Dense_{i}": {"kernel": rng.uniform(-1, 1, (a, b)).astype(np.float32)
                               / np.sqrt(a)} for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}

    g, hd = FULL.geo_feat_dim, FULL.hidden_dim
    table = rng.uniform(-1e-4, 1e-4, (spec.table_rows, 2)).astype(np.float32)
    smooth_hash_levels(table, spec)
    sigma_net = mlp([spec.output_dim, hd, 1 + g])
    sigma_net["Dense_1"]["kernel"][:, 0] *= 8.0
    p = {"hash_table": table, "sigma_net": sigma_net, "color_net": mlp([16 + g, 64, 64, 3]),
         "lidar_color_net": mlp([75 + g, 64, 64, 2])}
    if bg_radius > 0:
        bg = make_hash_grid_spec(input_dim=2, num_levels=4, log2_hashmap_size=19,
                                 desired_resolution=2048)
        p["bg_table"] = rng.uniform(-1e-4, 1e-4, (bg.table_rows, 2)).astype(np.float32)
        p["bg_table"][: bg.levels[1].offset] = rng.uniform(-1, 1, (bg.levels[1].offset, 2))
        p["bg_net"] = mlp([16 + bg.output_dim, 64, 3])
    return {"params": p}


def rgb_network(params, bg_radius, device):
    from lidarnerf_tpu_torch.models.network import NeRFNetwork
    from lidarnerf_tpu_torch.utils.params import params_from_jax

    net = NeRFNetwork(encoding="hashgrid", desired_resolution=FULL.desired_resolution,
                      log2_hashmap_size=FULL.log2_hashmap_size, hidden_dim=FULL.hidden_dim,
                      geo_feat_dim=FULL.geo_feat_dim, bg_radius=bg_radius, bound=FULL.bound)
    net.load_state_dict(params_from_jax(params))
    return net.to(device).eval()


def rgb_phase():
    """One RGB frame per background on the card, timed, held against the CPU
    on RGB_CPU_RAYS of its rays. Returns the launch counts (none)."""
    from lidarnerf_tpu_torch.dataset.base import get_rays
    from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays_staged

    pose = np.eye(4, dtype=np.float32)
    a = 0.3
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    pose[:3, 3] = [0.1, -0.05, 0.2]
    pick = torch.linspace(0, RGB_H * RGB_W - 1, RGB_CPU_RAYS).long()
    gpu = gpu_line()
    reset_counts()
    for name, bg_radius in (("background sphere", RGB_BG_RADIUS), ("white", -1.0)):
        params = hashgrid_flax_params(SEED + 31, bg_radius)
        cfg = RenderConfig(num_steps=FULL.num_steps, upsample_steps=FULL.upsample_steps,
                           min_near=FULL.scale, bound=FULL.bound, cal_lidar_color=False,
                           bg_radius=bg_radius)
        net = rgb_network(params, bg_radius, "cuda")
        rays = get_rays(torch.from_numpy(pose[None]).cuda(), RGB_INTRINSICS, RGB_H, RGB_W)
        o, d = rays["rays_o"][0], rays["rays_d"][0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = render_rays_staged(net, o, d, cfg, chunk=FULL.max_ray_batch)
        image = out["image"].cpu()  # ends on the host
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if image.shape != (RGB_H * RGB_W, 3) or not torch.isfinite(image).all() or not (
                image.min() >= 0 and image.max() <= 1 + 1e-5):
            raise AssertionError(f"rgb ({name}): the frame is not finite RGB in [0, 1]")
        cpu = render_rays_staged(rgb_network(params, bg_radius, "cpu"), o[pick].cpu(),
                                 d[pick].cpu(), cfg, chunk=FULL.max_ray_batch)
        wsum = out["weights_sum"].cpu()
        err = {k: float((out[k].cpu()[pick] - cpu[k]).abs().max()) for k in cpu}
        rel = float(((image[pick] - cpu["image"]).abs() / cpu["image"].abs().clamp(min=1e-12))
                    .max())
        log(f"rgb ({name}) on {gpu}: a {RGB_H}x{RGB_W} pinhole frame (fx, fy, cx, cy = "
            f"{RGB_INTRINSICS}), {FULL.num_steps}+{FULL.upsample_steps} samples, 4096-ray "
            f"chunks, fp32: {ms:.1f} ms/frame, peak allocated {peak / 2**30:.2f} GiB; weights "
            f"sum in [{float(wsum.min()):.4f}, {float(wsum.max()):.4f}], mean "
            f"{float(wsum.mean()):.4f}; vs the CPU on {RGB_CPU_RAYS} rays: max |diff| "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) + f", image max rel {rel:.3e}")
        for k in cpu:
            np.testing.assert_allclose(out[k].cpu()[pick].numpy(), cpu[k].numpy(),
                                       rtol=RGB_RTOL, atol=RGB_ATOL, err_msg=f"rgb {name} {k}")
        del net, out
        torch.cuda.empty_cache()
    only_launches(launch_counts(), {})
    return launch_counts()


# the baselines phase: the classical LiDAR-NVS baselines of lidarnerf_tpu_torch/lidarnvs/
# on the drive at full width (66 x 1030 panos, the UNet 64-...-1024, the MLP of
# the repo's KITTI-360 ray-drop config), cut in length only
BASELINE_CONFIG = "lidarnvs/configs/pcgen_kitti360_raydrop.txt"  # D 4, W 128, i_embed -1, lrate 5e-3
BASELINE_COLLECT_EVERY = 5  # the ray-drop data: every 5th train frame (12 of 60), both test frames
BASELINE_MLP_ITERS = 2000  # of the config's 10,000
BASELINE_UNET_EPOCHS = 2
BASELINE_UNET_BATCH = 2  # raydrop_train_poisson's default
BASELINE_CLI_FRAMES = (6, 2)  # the CLI's collect mode and its Poisson check: train, test frames
BASELINE_MLP_ATOL = 1e-5  # x max|logit|: card vs CPU, fp32, TF32 off
BASELINE_UNET_ATOL = 1e-4  # x max|logit|: card vs CPU, fp32 cuDNN, TF32 off


class FrameSubset:
    """The frames `idx` of a dataset, with the fields the baselines read."""

    def __init__(self, ds, idx):
        self.poses_lidar, self.images_lidar = ds.poses_lidar[idx], ds.images_lidar[idx]
        self.intrinsics_lidar, self.H_lidar, self.W_lidar = ds.intrinsics_lidar, ds.H_lidar, ds.W_lidar

    def __len__(self):
        return len(self.poses_lidar)


def baseline_datasets(root):
    """The train and test splits of `root` as `python -m lidarnerf_tpu_torch.lidarnvs.run` loads them."""
    from lidarnerf_tpu_torch.lidarnvs import run

    return run.build_datasets(run.build_parser().parse_args(["--path", root]))


def cut_drive(root, n_train, n_test):
    """A copy of DATA with its first n_train train and n_test test frames."""
    import shutil

    os.makedirs(root)
    for split, n in (("train", n_train), ("test", n_test)):
        with open(f"{DATA}/transforms_1908_{split}.json") as f:
            meta = json.load(f)
        meta["frames"] = meta["frames"][:n]
        for fr in meta["frames"]:
            shutil.copy(f"{DATA}/{fr['lidar_file_path']}", root)
        with open(f"{root}/transforms_1908_{split}.json", "w") as f:
            json.dump(meta, f)


def timed(fn):
    """(fn(), seconds) on the host clock, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_calls(fn, what, top=8):
    """Device time by kernel and operator, and the idle share, of fn() (ending
    on a synchronize), under torch.profiler; fn is called once before, warm."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_TAIL_S)
    return profile_summary(prof, wall_ms, what, top)


def metrics_line(m):
    return ", ".join(f"{k} {float(v):.4f}" for k, v in m.items())


def pcgen_phase(train, test, gpu):
    """PCGen fitted on the 60 train frames; both test frames predicted by cp
    and fpa, evaluated with the Chamfer on the card. Returns the fitted model
    (set to cp) and cp's mean metrics."""
    from lidarnerf_tpu_torch.lidarnvs.eval import eval_points_and_pano
    from lidarnerf_tpu_torch.lidarnvs.loader import extract_dataset_frame
    from lidarnerf_tpu_torch.lidarnvs.pcgen import LidarNVSPCGen

    gts = [extract_dataset_frame(test, i) for i in range(len(test))]
    nvs = LidarNVSPCGen()
    _, fit_s = timed(lambda: nvs.fit(train))
    means = {}
    for rc in ("fpa", "cp"):
        nvs.raycasting = rc
        pred_s = eval_s = 0.0
        ms = []
        for gt in gts:
            pd, s = timed(lambda: nvs.predict_frame(gt["lidar_K"], gt["lidar_pose"],
                                                    gt["lidar_H"], gt["lidar_W"]))
            pred_s += s
            m, s = timed(lambda: eval_points_and_pano(
                gt["local_points"], pd["local_points"], gt["intensities"], pd["intensities"],
                gt["pano"], pd["pano"]))
            eval_s += s
            if pd["pano"].shape != (H, W) or not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"baselines pcgen {rc}: a pano or a metric is wrong: {m}")
            ms.append(m)
        means[rc] = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
        log(f"baselines pcgen ({rc}) on {gpu}: fit {fit_s:.2f} s ({len(nvs.points)} world points "
            f"from {len(train)} frames); predict {1e3 * pred_s / len(gts):.1f} ms/frame, eval "
            f"(Chamfer on the card) {1e3 * eval_s / len(gts):.1f} ms/frame; mean over "
            f"{len(gts)} test frames: {metrics_line(means[rc])}")
    if not 0.5 < means["cp"]["f_score"] <= 1.0:
        raise AssertionError(f"baselines pcgen: cp's F-score {means['cp']['f_score']} is no fit")
    return nvs, means["cp"]


def mlp_phase(nvs, train, test, cp_mean, work, gpu):
    """The ray-drop MLP: PCGen's ray-drop data (every 5th train frame, both
    test frames) packed, trained on the card with the repo's config cut to
    BASELINE_MLP_ITERS, its loss falling 25%; the masked prediction of the
    test frames; the card against the CPU on a test frame's rays. Returns the
    train and test data."""
    from lidarnerf_tpu_torch.lidarnvs import raydrop_train_pcgen
    from lidarnerf_tpu_torch.lidarnvs.eval import eval_points_and_pano
    from lidarnerf_tpu_torch.lidarnvs.loader import extract_dataset_frame
    from lidarnerf_tpu_torch.lidarnvs.pcgen import LidarNVSPCGen, generate_raydrop_data_pcgen
    from lidarnerf_tpu_torch.lidarnvs.raydrop_pcgen import RayDropTrainer, pack_rays, run_network

    sub = FrameSubset(train, slice(None, None, BASELINE_COLLECT_EVERY))
    data, collect_s = timed(lambda: {"train": generate_raydrop_data_pcgen(sub, nvs),
                                     "test": generate_raydrop_data_pcgen(test, nvs)})
    rays_all = pack_rays(*data["train"])
    args = raydrop_train_pcgen.build_parser().parse_args(
        ["--config", BASELINE_CONFIG, "--N_iters", str(BASELINE_MLP_ITERS),
         "--basedir", work, "--expname", "mlp"])
    trainer = RayDropTrainer(
        netdepth=args.netdepth, netwidth=args.netwidth, multires=args.multires,
        multires_views=args.multires_views, i_embed=args.i_embed, lrate=args.lrate,
        lrate_decay=args.lrate_decay, n_iters=args.N_iters, cos_lr=args.cosLR,
        loss=args.rgb_loss_type, basedir=args.basedir, expname=args.expname)
    on_card = torch.from_numpy(rays_all).cuda()
    with torch.no_grad():
        before = float(trainer.loss_fn(on_card))
    _, train_s = timed(lambda: trainer.train(rays_all, N_rand=args.N_rand, verbose=False))
    with torch.no_grad():
        after = float(trainer.loss_fn(on_card))
    losses = trainer.loss_log.cpu().numpy()
    ms_it = 1e3 * train_s / args.N_iters
    hits = float(rays_all[:, 5].mean())
    log(f"baselines ray-drop MLP on {gpu}: D {args.netdepth}, W {args.netwidth}, i_embed "
        f"{args.i_embed} ({trainer.input_ch} inputs), {len(rays_all)} rays from "
        f"{len(sub)} frames (collected in {collect_s:.1f} s with the test frames; "
        f"{100 * hits:.2f}% returns), {args.N_iters} iterations of {args.N_rand}: "
        f"{ms_it:.3f} ms/iteration, {args.N_rand * args.N_iters / train_s:.3e} rays/s")
    # the whole training set's loss before and after: the seeded init
    # already predicts a return for nearly every ray with a depth, and the
    # MLP learns the no-depth rays within a few steps, so the batch losses'
    # first and last 10 differ by their sampling noise only
    log(f"baselines ray-drop MLP: loss of the whole training set {before:.5f} at init, "
        f"{after:.5f} trained ({100 * (1 - after / before):.1f}% lower; a constant "
        f"{hits:.4f} would score {hits * (1 - hits):.5f}); batch losses, mean of the first "
        f"10 {losses[:10].mean():.5f}, of the last 10 {losses[-10:].mean():.5f}")
    if not np.isfinite(losses).all() or not after <= 0.75 * before:
        raise AssertionError("baselines ray-drop MLP: training lowered the loss by less than 25%")

    ckpt = trainer.save_checkpoint(args.N_iters)
    masked = LidarNVSPCGen(raycasting="cp", ckpt_path=ckpt)
    masked.points, masked.point_intensities = nvs.points, nvs.point_intensities
    ms, pred_s = [], 0.0
    for i in range(len(test)):
        gt = extract_dataset_frame(test, i)
        pd, s = timed(lambda: masked.predict_frame_with_raydrop(
            gt["lidar_K"], gt["lidar_pose"], gt["lidar_H"], gt["lidar_W"]))
        pred_s += s
        ms.append(eval_points_and_pano(gt["local_points"], pd["local_points"], gt["intensities"],
                                       pd["intensities"], gt["pano"], pd["pano"]))
    mean = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
    if not all(np.isfinite(v) for v in mean.values()):
        raise AssertionError(f"baselines ray-drop MLP: a masked metric is not finite: {mean}")
    log(f"baselines pcgen (cp) + ray-drop MLP on {gpu}: predict with the mask "
        f"{1e3 * pred_s / len(test):.1f} ms/frame; mean over {len(test)} test frames with the "
        f"mask: {metrics_line(mean)}; without: {metrics_line(cp_mean)}")

    # card against CPU on one test frame's rays
    x = torch.from_numpy(pack_rays(*(d[:1] for d in data["test"]))[:, :5])
    cpu = RayDropTrainer(netdepth=args.netdepth, netwidth=args.netwidth, i_embed=args.i_embed,
                         device="cpu")
    cpu.load_checkpoint(ckpt)
    with torch.no_grad():
        want = run_network(x, cpu.model, cpu.embed_fn, cpu.embeddirs_fn)
        got = run_network(x.cuda(), trainer.model, trainer.embed_fn, trainer.embeddirs_fn).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"baselines ray-drop MLP card vs CPU ({len(x)} rays, fp32, TF32 off): max |logit diff| "
        f"{err:.3e} of max |logit| {scale:.3e} (bound {BASELINE_MLP_ATOL} x max)")
    if not err <= BASELINE_MLP_ATOL * scale:
        raise AssertionError("baselines ray-drop MLP: the card disagrees with the CPU")
    batches = on_card[:10 * args.N_rand].split(args.N_rand)
    profile_calls(lambda: [trainer.step(b) for b in batches],
                  f"10 ray-drop MLP iterations of {args.N_rand} rays")
    return data


def unet_frames(data, split_ds):
    """The UNet's frames (RaydropDataset's pickle layout) from PCGen's ray-drop
    data: hit_masks, hit_depths and intensities from PCGen's predicted pano,
    rays_d the world ray directions, hit_normals and hit_incidences zeros
    (no mesh, so no normals), raydrop_masks the ground truth's pano > 0."""
    dirs, panos, intensities, gt_panos = data
    frames = []
    for k, (d, pano, inten, gt) in enumerate(zip(dirs, panos, intensities, gt_panos)):
        rot = np.asarray(split_ds.poses_lidar[k])[:3, :3]
        frames.append({
            "hit_masks": (pano > 0).astype(np.float32), "hit_depths": pano.astype(np.float32),
            "hit_normals": np.zeros((H, W, 3), np.float32),
            "hit_incidences": np.zeros((H, W), np.float32),
            "intensities": inten.astype(np.float32), "rays_d": (d @ rot.T).astype(np.float32),
            "raydrop_masks": (gt > 0).astype(np.float32)})
    return frames


def unet_phase(data, train, test, work, gpu):
    """UNetRaydropTrainer at the CLI's batch 2 for BASELINE_UNET_EPOCHS epochs
    on the card, its epoch loss falling; ms/step, the test dice, peak memory;
    the card against the CPU on one frame in evaluation mode; the CLI resuming
    from its checkpoint for one epoch."""
    import pickle

    from lidarnerf_tpu_torch.lidarnvs import raydrop_train_poisson
    from lidarnerf_tpu_torch.lidarnvs.raydrop_unet import RaydropDataset, UNetRaydropTrainer

    root = os.path.join(work, "unet_data")
    os.makedirs(root)
    sub = FrameSubset(train, slice(None, None, BASELINE_COLLECT_EVERY))
    for split, ds in (("train", sub), ("test", test)):
        with open(f"{root}/{split}_data.pkl", "wb") as f:
            pickle.dump(unet_frames(data[split], ds), f)
    trainer = UNetRaydropTrainer()
    torch.cuda.reset_peak_memory_stats()
    hist, train_s = timed(lambda: trainer.train(root, f"{work}/unet_ckpt",
                                                epochs=BASELINE_UNET_EPOCHS,
                                                batch_size=BASELINE_UNET_BATCH, verbose=False))
    peak = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    images, masks = RaydropDataset.collate(RaydropDataset(root, "train")[:BASELINE_UNET_BATCH])
    on_card = torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda()
    step_ms = cuda_ms(lambda: trainer.step(*on_card, trainer._lr_scale), reps=5, batches=3,
                      warmup=1)
    profile_calls(lambda: trainer.step(*on_card, trainer._lr_scale),
                  f"one UNet ray-drop step (batch {BASELINE_UNET_BATCH}, {H}x{W})")
    steps = sum(len(h["losses"]) for h in hist)
    log(f"baselines UNet ray-drop on {gpu}: {len(sub)} train frames of {H}x{W}, batch "
        f"{BASELINE_UNET_BATCH}, {BASELINE_UNET_EPOCHS} epochs = {steps} steps in {train_s:.2f} s "
        f"(first-call cuDNN set-up and test evaluations included); {step_ms:.2f} ms/step warm; "
        f"epoch losses {[round(h['loss'], 5) for h in hist]}, test dice "
        f"{[round(h['dice'], 5) for h in hist]}; peak {peak[0] / 2**30:.2f} GiB allocated, "
        f"{peak[1] / 2**30:.2f} GiB reserved")
    finite = all(np.isfinite(h["losses"]).all() for h in hist)
    if not finite or not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"baselines UNet: the epoch loss did not fall: {hist}")

    cpu = UNetRaydropTrainer(device="cpu")
    cpu.load_checkpoint(f"{work}/unet_ckpt/checkpoint_epoch{BASELINE_UNET_EPOCHS}.ckpt")
    x = torch.from_numpy(images[:1])
    with torch.no_grad():
        trainer.load_checkpoint(f"{work}/unet_ckpt/checkpoint_epoch{BASELINE_UNET_EPOCHS}.ckpt")
        trainer.model.eval()
        got = trainer.model.predict_nhwc(x.cuda()).cpu()
        want = cpu.model.eval().predict_nhwc(x)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    log(f"baselines UNet card vs CPU (one {H}x{W} frame, evaluation mode, fp32, TF32 off): max "
        f"|logit diff| {err:.3e} of max |logit| {scale:.3e} (bound {BASELINE_UNET_ATOL} x max)")
    if not err <= BASELINE_UNET_ATOL * scale:
        raise AssertionError("baselines UNet: the card disagrees with the CPU")
    del trainer
    torch.cuda.empty_cache()
    hist = raydrop_train_poisson.main(
        ["--data_dir", root, "--ckpt_dir", f"{work}/unet_cli", "--epochs", "1", "--load",
         f"{work}/unet_ckpt/checkpoint_epoch{BASELINE_UNET_EPOCHS}.ckpt"])
    if len(hist) != 1 or not os.path.exists(f"{work}/unet_cli/checkpoint_epoch1.ckpt"):
        raise AssertionError("baselines: raydrop_train_poisson did not train and save an epoch")


def baseline_cli_phase(pcgen_mean, work, gpu):
    """The baseline CLIs on the card: `run` in the eval mode on the drive (its
    mean metrics those of the pcgen phase's cp), in the collect mode on a cut
    copy, `raydrop_train_pcgen` with the repo's config on those pickles, and
    `--method poisson`, which must raise open3d's ImportError."""
    from lidarnerf_tpu_torch.lidarnvs import raydrop_train_pcgen, run
    from lidarnerf_tpu_torch.lidarnvs.pcgen import LidarNVSPCGen

    os.environ.pop("LIDARNERF_PLATFORM", None)  # the CLIs' device: the card
    mean, eval_s = timed(lambda: run.main(["--method", "pcgen", "--path", DATA]))
    for k, v in pcgen_mean.items():
        if not np.isclose(mean[k], v, rtol=1e-6, atol=0):
            raise AssertionError(f"baselines cli: run's mean {k} {mean[k]} != the phase's {v}")
    cut = os.path.join(work, "cut")
    cut_drive(cut, *BASELINE_CLI_FRAMES)
    _, collect_s = timed(lambda: run.main(["--method", "pcgen", "--path", cut,
                                           "--enable_collect_raydrop_dataset",
                                           "--raydrop_data_dir", f"{work}/raydrop"]))
    pkl = f"{work}/raydrop/pcgen/kitti360_1908"
    trainer, mlp_s = timed(lambda: raydrop_train_pcgen.main(
        ["--config", BASELINE_CONFIG, "--datadir", pkl, "--basedir", f"{work}/log",
         "--N_iters", "200", "--i_print", "100"]))
    LidarNVSPCGen(ckpt_path=f"{work}/log/raysdrop/000200.ckpt")
    try:
        run.main(["--method", "poisson", "--path", cut])
    except ImportError as e:
        if "open3d" not in str(e):
            raise
        log(f"baselines cli: --method poisson raised, as it must without open3d: {e}")
    else:
        raise AssertionError("baselines cli: --method poisson ran without open3d")
    log(f"baselines cli on {gpu}: run --method pcgen (fit the train split, evaluate the test "
        f"split) {eval_s:.1f} s, the same mean metrics; the collect mode on "
        f"{BASELINE_CLI_FRAMES[0]} + {BASELINE_CLI_FRAMES[1]} frames {collect_s:.1f} s; raydrop_train_pcgen with "
        f"{BASELINE_CONFIG} for 200 iterations {mlp_s:.1f} s (loss "
        f"{float(trainer.loss_log[:10].mean()):.4f} -> {float(trainer.loss_log[-10:].mean()):.4f})")


def baselines_phase():
    """The classical baselines at full width in a temporary directory outside
    the repo, removed afterwards; no kernel of the port runs (B1-B6: 0 on the
    card and at the wrappers). Returns the wrappers' launch counts."""
    import shutil
    import tempfile

    gpu = gpu_line()
    train, test = baseline_datasets(DATA)
    work = tempfile.mkdtemp(prefix="lidarnerf_baselines_")
    reset_counts()
    try:
        with device_launches() as on_card:
            nvs, cp_mean = pcgen_phase(train, test, gpu)
            data = mlp_phase(nvs, train, test, cp_mean, work, gpu)
            del nvs
            unet_phase(data, train, test, work, gpu)
            baseline_cli_phase(cp_mean, work, gpu)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    only_launches(launch_counts(), {})
    only_launches(on_card, {})
    log(f"baselines: B1-B6 launches on the card {on_card}, at the wrappers {launch_counts()}")
    return launch_counts()


# the seams phase: the block-hash seam options at full width on the drive,
# --alpha_seam at the round-4 sweep's 100 (VALIDATION.md), the sync at the
# JAX CLI's 4096 samples per (hashed level, axis)
SEAM_OPTIONS = {"seam_tie": {"seam_tie": 1}, "alpha_seam": {"alpha_seam": 100.0},
                "seam_sync_hashed": {"seam_sync_hashed": 4096}}
SEAM_ALL = {k: v for o in SEAM_OPTIONS.values() for k, v in o.items()}
SEAM_ARGV = ["--config", "configs/kitti360_1908.txt", "-L", "--path", DATA, "--iters", "120",
             "--eval_interval", "1", "--mesh_resolution", "128", "--seam_tie", "1",
             "--alpha_seam", "100", "--seam_sync_hashed", "4096"]
SEAM_FRAMES = 20  # the steps of an epoch of the seams graph and timing runs
SEAM_LOSS_RTOL = 1e-6  # the seam loss, card vs CPU: its means summed in another order


def tied_levels(table, spec):
    """The dense levels (of two blocks or more a side) whose face-corner copies
    are equal in `table`, bit for bit; raises at the first that differs."""
    checked = 0
    for li, lv in enumerate(spec.levels):
        nb = lv.blocks_axis
        if not lv.dense or nb < 2:
            continue
        off = li * spec.blocks_per_level
        t = table[off:off + nb**3].view(nb, nb, nb, 4, 4, 4, 2)
        for a, b in ((t[:-1, :, :, 3], t[1:, :, :, 0]), (t[:, :-1, :, :, 3], t[:, 1:, :, :, 0]),
                     (t[:, :, :-1, :, :, 3], t[:, :, 1:, :, :, 0])):
            if not torch.equal(a, b):
                raise AssertionError(f"seams: level {li}'s tied copies differ by "
                                     f"{(a - b).abs().max().item()}")
        checked += 1
    return checked


def seam_functions_phase(table, spec):
    """Check 4: the tie (and its gradient), the sync and the seam loss (and
    its gradient) at the full table on the card against the CPU on the same
    table and draws, with the card's ms of each."""
    from lidarnerf_tpu_torch.ops import block_hash as bh

    g = torch.Generator().manual_seed(SEED + 5)
    up = torch.randn(table.shape, generator=g)
    sync_draws = bh.seam_draws(spec, 4096, g, hashed_only=True)
    loss_draws = bh.seam_draws(spec, 512, g)
    out = {}
    for dev in ("cpu", "cuda"):
        on = {k: (m.to(dev), o.to(dev)) for k, (m, o) in sync_draws.items()}
        lon = {k: (m.to(dev), o.to(dev)) for k, (m, o) in loss_draws.items()}
        t = table.detach().to(dev).clone().requires_grad_()
        tied = bh.tie_dense_seams(t, spec)
        (tied * up.to(dev)).sum().backward()
        synced = bh.sync_hashed_seams(table.to(dev).clone(), spec, draws=on)
        t2 = table.detach().to(dev).clone().requires_grad_()
        loss = bh.block_hash_seam_loss(t2, spec, draws=lon)
        loss.backward()
        out[dev] = [x.detach().cpu() for x in (tied, t.grad, synced, loss, t2.grad)]
        if dev == "cuda":
            tab, upc = table.cuda(), up.cuda()

            def tie_step():
                x = tab.clone().requires_grad_()
                (bh.tie_dense_seams(x, spec) * upc).sum().backward()

            def loss_step():
                x = tab.clone().requires_grad_()
                bh.block_hash_seam_loss(x, spec, draws=lon).backward()

            ms = {"tie forward + backward": cuda_ms(tie_step, reps=5),
                  "sync (4096 a level and axis)": cuda_ms(
                      lambda: bh.sync_hashed_seams(tab.clone(), spec, draws=on), reps=5),
                  "seam loss forward + backward (512)": cuda_ms(loss_step, reps=5),
                  "a table copy": cuda_ms(lambda: tab.clone(), reps=5)}
    cpu, gpu = out["cpu"], out["cuda"]
    names = ("the tied table", "the tie's gradient", "the synced table", "the seam loss",
             "the seam loss's gradient")
    exact = {n: torch.equal(a, b) for n, a, b in zip(names, gpu, cpu)}
    rel = abs(float(gpu[3]) - float(cpu[3])) / abs(float(cpu[3]))
    log(f"seams: the three functions at the full table ({table.shape[0]} x 128) on the card vs "
        f"the CPU on the same draws, bit for bit: {exact}; the loss {float(gpu[3]):.9e} vs "
        f"{float(cpu[3]):.9e} ({rel:.2e} relative); card ms on {gpu_line()}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    if not all(v for n, v in exact.items() if n != "the seam loss") or rel > SEAM_LOSS_RTOL:
        raise AssertionError(f"seams: the card differs from the CPU: {exact}, loss {rel:.2e}")
    if torch.equal(gpu[2], table) or torch.equal(gpu[0], table):
        raise AssertionError("seams: the tie or the sync left the table as it was")
    return ms


def seam_sync_lowers_the_loss(table, spec):
    """Check 3: the seam loss on the sync's own samples, before and after the
    sync (the sampled copies become equal, but where a later sample of the
    same level overwrites one)."""
    from lidarnerf_tpu_torch.ops import block_hash as bh

    t = table.detach().clone()
    draws = bh.seam_draws(spec, 4096, torch.Generator(device="cuda").manual_seed(SEED + 6),
                          "cuda", hashed_only=True)
    before = float(bh.block_hash_seam_loss(t, spec, draws=draws))
    bh.sync_hashed_seams(t, spec, draws=draws)
    after = float(bh.block_hash_seam_loss(t, spec, draws=draws))
    log(f"seams: the seam loss on the sync's samples of the trained table {before:.6e} before "
        f"the sync, {after:.6e} after ({100 * (1 - after / before):.2f}% lower)")
    if not after < before:
        raise AssertionError("seams: the sync did not lower the seam loss")


def seam_timing_phase(ds):
    """Check 7: captured ms/step of each seam option, and of all three, each
    against the default step in turns (epoch 1 captures, epochs 2-3 in turns),
    with each graphed trainer's pool. Returns {option: (ms, default ms, pool)}."""
    sub = first_frames(ds, SEAM_FRAMES)
    base = trainer_maker(ds)(1)
    base.train(sub, None, max_epochs=1)
    out = {}
    for name, kw in (*SEAM_OPTIONS.items(), ("all", SEAM_ALL)):
        other = trainer_maker(ds, **kw)(1)
        other.train(sub, None, max_epochs=1)
        secs = {"default": [], name: []}
        for turn in range(2):
            pair = ((name, other), ("default", base)) if turn else (("default", base),
                                                                     (name, other))
            for who, t in pair:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.train(sub, None, max_epochs=t.epoch + 1)  # ends on the host
                secs[who].append(time.perf_counter() - t0)
        losses = other.stats["step_loss"]
        if not np.isfinite(losses).all() or any(other.stats["skipped"]):
            raise AssertionError(f"seams ({name}): a loss was non-finite or a step skipped")
        ms = {k: 1e3 * float(np.mean(v)) / SEAM_FRAMES for k, v in secs.items()}
        pool = graph_pool_bytes(other._graph_pool.handle)
        out[name] = (ms[name], ms["default"], pool)
        del other
        torch.cuda.empty_cache()
    base_pool = graph_pool_bytes(base._graph_pool.handle)
    gib = (lambda b: "not measured" if b is None else f"{b / 2**30:.2f} GiB")
    log(f"seams on {gpu_line()}: captured ms/step in turns with the default step (epochs 2-3 "
        f"of {SEAM_FRAMES} steps): " + "; ".join(
            f"{k} {v[0]:.2f} vs {v[1]:.2f} (pool {gib(v[2])})" for k, v in out.items())
        + f"; the default trainer's pool {gib(base_pool)}")
    return out, base_pool


def seams_cli_phase(cli, ws):
    """Check 1: the CLI with the three seam options at full width: train (120
    steps, an evaluation every epoch) -> evaluate -> test -> mesh, launches
    counted on the card; then --test_eval (meters bit-equal). Returns
    (trainer, its launch counts, --test_eval's launch counts)."""
    argv = cli_argv(ws, base=SEAM_ARGV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with device_launches() as device:
        trainer = cli.main(argv)
    launches = launch_counts()
    if not (trainer.model.seam_tie and trainer.train_cfg.alpha_seam == 100.0
            and trainer.opt.seam_sync_hashed == 4096):
        raise AssertionError("seams: the CLI run did not take the three seam options")
    loss_fell("seams cli", *check_cli_run("seams cli", trainer, launches, device, 120, [1, 2, 2]))
    log(f"seams cli launches: at the wrappers {launches}, on the card {device}; peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
    again = check_test_eval("seams cli", cli, argv, trainer)
    return trainer, launches, again


def seam_pano_phase(trainer, ds):
    """Check 8: a warm full-width pano through PanoRenderer with seam_tie from
    the trained EMA weights; it equals, bit for bit, the pano of an untied
    network whose table was tied once beforehand (the tie is idempotent)."""
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
    from lidarnerf_tpu_torch.ops.block_hash import tie_dense_seams
    from lidarnerf_tpu_torch.utils.params import params_to_jax

    params = params_to_jax(trainer.ema_params)
    renderer = PanoRenderer(trainer.opt, params)
    if not renderer.network.seam_tie:
        raise AssertionError("seams: the renderer did not take seam_tie")
    reset_counts()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = renderer.render_frame(ds.poses_lidar[0], ds.H_lidar, ds.W_lidar,
                                      ds.intrinsics_lidar)  # ends on the host
        times.append(1e3 * (time.perf_counter() - t0))
    launches = launch_counts()
    chunks = -(-ds.H_lidar * ds.W_lidar // trainer.opt.max_ray_batch)
    only_launches(launches, {"block_hash_fwd": 2 * 2 * chunks})
    table = torch.from_numpy(params["params"]["hash_table"])
    params["params"]["hash_table"] = tie_dense_seams(table, renderer.network.block_spec).numpy()
    untied = PanoRenderer(SimpleNamespace(**{**vars(trainer.opt), "seam_tie": 0}), params)
    ref = untied.render_frame(ds.poses_lidar[0], ds.H_lidar, ds.W_lidar, ds.intrinsics_lidar)
    same = all(np.array_equal(a, b) for a, b in zip(frame, ref))
    log(f"seams serving on {gpu_line()}: a full-width {ds.H_lidar}x{ds.W_lidar} pano with the "
        f"tie {times[0]:.1f} ms cold, {times[1]:.1f} ms warm ({launches['block_hash_fwd']} B1 "
        f"launches for two panos); equal to the pretied untied pano bit for bit: {same}")
    if not same or not all(np.isfinite(a).all() for a in frame):
        raise AssertionError("seams: the tied pano is not finite or differs from the pretied one")
    return launches


def two_captured_runs(what, make, sub):
    """Two captured trainers from one seeded state, an epoch of sub each:
    losses and final state bit-equal."""
    runs = []
    for _ in range(2):
        t = make(1)
        t.train(sub, None, max_epochs=1)
        runs.append(t)
    differ = same_training_state(*runs)
    log(f"{what}: two captured runs of {len(sub)} steps from one seeded state equal bit for "
        f"bit (losses, weights, EMA, Adam, generator): {not differ}")
    if differ:
        raise AssertionError(f"{what}: two captured runs differ: {differ}")


def seams_phase(ds):
    """The seams phase (checks 1-8) in a temporary workspace outside the repo,
    removed afterwards. Returns {path: wrapper launch counts}."""
    import shutil
    import tempfile

    from lidarnerf_tpu_torch import main_lidarnerf as cli

    root = tempfile.mkdtemp(prefix="lidarnerf_seams_")
    try:
        trainer, launches, again = seams_cli_phase(cli, os.path.join(root, "run"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    spec = trainer.model.block_spec
    table = trainer.model.hash_table.detach()
    from lidarnerf_tpu_torch.ops.block_hash import tie_dense_seams

    n = tied_levels(tie_dense_seams(table, spec), spec)
    log(f"seams: the tied trained table's face-corner copies are equal at all {n} dense levels "
        f"of two blocks or more")
    seam_sync_lowers_the_loss(table, spec)
    paths = {"seams-cli": launches, "seams-test-eval": again,
             "seams-serving": seam_pano_phase(trainer, ds)}
    ms = seam_functions_phase(table.cpu(), spec)
    del trainer
    torch.cuda.empty_cache()
    sub = first_frames(ds, SEAM_FRAMES)
    paths["training-graph-seams"] = training_graph_phase(
        "seams", trainer_maker(ds, **SEAM_ALL), sub,
        {"block_hash_fwd": 2, "block_hash_bwd": 2})
    torch.cuda.empty_cache()
    two_captured_runs("seams", trainer_maker(ds, **SEAM_ALL), sub)
    torch.cuda.empty_cache()
    timing, base_pool = seam_timing_phase(ds)
    torch.cuda.empty_cache()
    return paths


# the parallel phase: an NCCL group of every GPU of the machine, one process
# per GPU started here with torch.multiprocessing (torchrun's layout: RANK,
# WORLD_SIZE, LOCAL_RANK), each on the first PARALLEL_FRAMES frames
PARALLEL_FRAMES = 16
PARALLEL_TIMEOUT_S = 420
PARALLEL_LOSS_RTOL = 1e-4  # tests/test_parallel.py:68
PARALLEL_PARAM_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_parallel.py:70


def _params(model):
    from lidarnerf_tpu_torch.parallel import sharding

    return {k: v.detach().clone() for k, v in sharding.full_state_dict(model).items()}


def _differ(a, b):
    return {k: (a[k].float() - b[k].float()).abs().max().item() for k in a
            if not torch.equal(a[k], b[k])}


def parallel_checks(rank, world, dev, tmp):
    """Checks 1-6 of the parallel phase on this rank. Returns what it measured."""
    import torch.distributed as dist

    from lidarnerf_tpu_torch.nerf import train_step as tst
    from lidarnerf_tpu_torch.nerf.trainer import Trainer
    from lidarnerf_tpu_torch.parallel import sharding
    from lidarnerf_tpu_torch.utils import checkpoint_io
    from lidarnerf_tpu_torch.utils.params import params_to_jax

    ds = first_frames(synth_drive(), PARALLEL_FRAMES)
    opt = train_opt(ds)
    cfgs = Trainer("p", SimpleNamespace(**vars(opt), data_parallel=False),
                   new_model(opt, FULL.fp16), device=dev, mute=True, workspace=None)
    cfg, rcfg = cfgs.train_cfg, cfgs.render_cfg
    del cfgs
    poses, images = ds.device_arrays(dev)
    F = poses.shape[0]
    vi = torch.zeros((F, 1), dtype=torch.long, device=dev)
    vc = torch.full((F,), ds.H_lidar * ds.W_lidar, dtype=torch.long, device=dev)
    order = np.arange(F)
    out = {"world": world}

    def epoch(fn, seed=SEED + 9):
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ms = fn(poses, images, vi, vc, order, 0, gen)
        losses = ms["loss"].cpu().numpy()  # the epoch's one fetch
        return losses, time.perf_counter() - t0

    mesh = sharding.make_mesh()
    # check 1: the captured sharded epoch against the one-GPU epoch, one seeded state
    ref_model = new_model(opt, FULL.fp16)
    ref_fn = tst.make_epoch_step(ref_model, cfg, rcfg, device=dev)
    ref_losses, _ = epoch(ref_fn)
    ref_params = _params(ref_model)
    reset_counts()
    with device_launches() as device:
        model = new_model(opt, FULL.fp16)
        fn = sharding.make_sharded_epoch_step(model, cfg, rcfg, mesh)
        losses, _ = epoch(fn)
    out["launches"], out["device"] = launch_counts(), dict(device)
    params = _params(model)
    # a world of W > 1 sums each step's gradients in another order: the
    # first two losses (the same weights, then one Adam update of lr * sign(g))
    # agree at the JAX tolerance; later ones drift with the noise-floor entries
    np.testing.assert_allclose(losses[:2], ref_losses[:2], rtol=PARALLEL_LOSS_RTOL)
    out["epoch_equal"] = world == 1 and np.array_equal(losses, ref_losses) and not _differ(
        params, ref_params)
    if world == 1 and not out["epoch_equal"]:
        raise AssertionError(f"parallel: a world of one differs from one GPU: "
                             f"{_differ(params, ref_params)}")
    out["graphs"] = sum(1 for g in fn.graphs.values() if g.graph is not None)
    # one eager step each: the gradients at 2e-5 of each tensor's peak (B2's
    # fixed-point sum on one GPU against W float32 partial sums), the weights
    # at the JAX tolerances where the gradient is live (above 1e-3 of its
    # peak: Adam's first update lr * g / (|g| + eps) moves a noise-floor
    # entry by up to lr whatever its size, as tests/test_torch_train.py has it)
    one = [new_model(opt, FULL.fp16) for _ in range(2)]
    steps = [tst.make_train_step(one[0], cfg, rcfg, device=dev),
             sharding.make_sharded_train_step(one[1], cfg, rcfg, mesh)]
    for st in steps:
        st(poses, images, vi, vc, 0, generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    out["noise_floor"] = 0
    for (k, pa), pb in zip(one[0].named_parameters(), one[1].parameters()):
        if pa.grad is None:
            continue
        ga, gb = pa.grad.float().cpu().numpy(), pb.grad.float().cpu().numpy()
        peak = np.abs(ga).max()
        np.testing.assert_allclose(gb, ga, rtol=0, atol=2e-5 * peak, err_msg=k)
        live = np.abs(ga) > 1e-3 * peak
        wa, wb = pa.detach().float().cpu().numpy(), pb.detach().float().cpu().numpy()
        np.testing.assert_allclose(wb[live], wa[live], err_msg=k, **PARALLEL_PARAM_TOL)
        out["noise_floor"] += int((~np.isclose(wb, wa, **PARALLEL_PARAM_TOL)).sum())
    del one, steps
    # check 2: every rank holds the same bits
    flat = torch.cat([v.reshape(-1).float() for v in params.values()])
    parts = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(parts, flat)
    out["ranks_equal"] = all(torch.equal(p, flat) for p in parts)
    if not out["ranks_equal"]:
        raise AssertionError("parallel: the ranks' parameters differ")
    # check 3: a second run from the same seeded state repeats bit for bit
    model2 = new_model(opt, FULL.fp16)
    losses2, _ = epoch(sharding.make_sharded_epoch_step(model2, cfg, rcfg, mesh))
    out["runs_equal"] = np.array_equal(losses, losses2) and not _differ(params, _params(model2))
    if not out["runs_equal"]:
        raise AssertionError("parallel: two captured runs differ")
    del model2
    # check 4: the table row-sharded over `model` = every rank
    mesh2 = sharding.make_mesh_2d(1, world)
    model_s = new_model(opt, FULL.fp16)
    fn_s = sharding.make_sharded_epoch_step(model_s, cfg, rcfg, mesh2, shard_table=True)
    losses_s, _ = epoch(fn_s)
    np.testing.assert_allclose(losses_s[:2], ref_losses[:2], rtol=PARALLEL_LOSS_RTOL)
    out["shard_rows"] = model_s.hash_table.shape[0]
    params_s = _params(model_s)
    out["shard_equal"] = np.array_equal(losses_s, ref_losses) and not _differ(params_s,
                                                                               ref_params)
    if world == 1 and not out["shard_equal"]:
        raise AssertionError("parallel: the shard_table run of one rank differs from one GPU")
    # check 5: the orbax-format store, each rank writing its rows
    table = model_s.hash_table.detach()
    if world > 1:
        from torch.distributed.tensor import DTensor, Shard

        table = DTensor.from_local(table, mesh2.device_mesh()["model"], [Shard(0)])
    sd = {k: v.detach().cpu().numpy() for k, v in params_s.items()}
    state = {"model": params_to_jax({k: torch.from_numpy(v) for k, v in sd.items()}),
             "epoch": 1, "global_step": F}
    state["model"]["params"]["hash_table"] = table
    path = os.path.join(tmp, "parallel.ckpt")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    checkpoint_io.dump_state(state, path, "orbax")
    out["save_s"] = time.perf_counter() - t0
    out["ckpt_bytes"] = checkpoint_io.size_bytes(path)
    t0 = time.perf_counter()
    back = checkpoint_io.load_state(path)
    out["load_s"] = time.perf_counter() - t0
    want = params_to_jax({k: torch.from_numpy(v) for k, v in sd.items()})["params"]
    got = back["model"]["params"]
    out["ckpt_equal"] = np.array_equal(got["hash_table"], want["hash_table"]) and all(
        np.array_equal(got[n][d]["kernel"], want[n][d]["kernel"])
        for n in want if n != "hash_table" for d in want[n]) and back["epoch"] == 1
    if not out["ckpt_equal"]:
        raise AssertionError("parallel: the orbax-format checkpoint did not load back bit-equal")
    del model_s, fn_s
    # check 6: ms/step with the group against without it, captured, in turns
    secs = {"one GPU": [], "group": []}
    for turn in range(6):
        pair = (("group", fn), ("one GPU", ref_fn)) if turn % 2 else (("one GPU", ref_fn),
                                                                       ("group", fn))
        for who, f in pair:
            secs[who].append(epoch(f, SEED + 20 + turn)[1])
    out["ms"] = {k: 1e3 * float(np.mean(v)) / F for k, v in secs.items()}
    # the step's one collective alone: the flat buffer of the gradients, loss and metrics
    n = sum(p.numel() for p in model.parameters() if p.grad is not None) + 3
    buf = torch.zeros(n, device=dev)
    out["allreduce"] = (n * 4 / 2**20, cuda_ms(lambda: dist.all_reduce(buf, group=mesh.data_group),
                                               reps=20))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def parallel_rank(rank, world, port, queue, tmp):
    """One rank of the parallel phase's NCCL group (the target of each process)."""
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        import torch.distributed as dist

        from lidarnerf_tpu_torch.parallel import sharding

        dev = sharding.init_from_env("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        reset_counts()
        queue.put((rank, True, parallel_checks(rank, world, dev, tmp)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which fails the phase
        queue.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def parallel_phase():
    """The parallel phase: an NCCL group of torch.cuda.device_count() ranks,
    started here (one process per GPU), joined with a time limit. Returns
    rank 0's wrapper launch counts of the sharded epoch."""
    import queue as queues
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    log(f"parallel: an NCCL group of {world} rank(s), one process per GPU "
        f"(torch.cuda.device_count() = {world})")
    if world == 1:
        log("parallel: one GPU: the group is a world of one, so the cross-rank reduction was "
            "not exercised (its all-reduce runs through NCCL over one rank)")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="lidarnerf_parallel_")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=parallel_rank, args=(r, world, port, results, tmp))
             for r in range(world)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        while len(out) + len(errors) < world:
            left = PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)
            if left <= 0:
                raise AssertionError(f"parallel: the group did not finish in {PARALLEL_TIMEOUT_S} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 10.0))
            except queues.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"parallel: a rank died with exit code {dead[0]}")
                continue
            if ok:
                out[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise AssertionError("parallel: " + "\n".join(errors))
    r0 = out[0]
    gpu = gpu_line()
    log(f"parallel on {gpu}: {world} rank(s), {time.perf_counter() - t0:.1f} s with start-up; "
        f"check 1: the captured sharded epoch ({PARALLEL_FRAMES} steps, {r0['graphs']} graph) "
        f"against one GPU from one seeded state: the first two losses within "
        f"{PARALLEL_LOSS_RTOL} relative"
        + (", and bit for bit with the weights" if r0["epoch_equal"] else "")
        + f"; one eager step: gradients within 2e-5 of their peak, the weights of live "
        f"gradients within rtol 1e-3 / atol 1e-6 ({r0['noise_floor']} noise-floor weights "
        f"outside it); check 2: every rank's "
        f"weights the same bits: {all(o['ranks_equal'] for o in out.values())}; check 3: two "
        f"runs bit-equal: {r0['runs_equal']}; check 4: shard_table over a (1, {world}) mesh, "
        f"{r0['shard_rows']} table rows a rank, equal to one GPU bit for bit: "
        f"{r0['shard_equal']}; check 5: the orbax-format checkpoint ({r0['ckpt_bytes'] / 2**20:.1f}"
        f" MiB) saved in {r0['save_s']:.3f} s, loaded in {r0['load_s']:.3f} s, bit-equal: "
        f"{r0['ckpt_equal']}; check 6: captured ms/step in turns, one GPU "
        f"{r0['ms']['one GPU']:.2f}, the group {r0['ms']['group']:.2f} (epochs of "
        f"{PARALLEL_FRAMES} steps, host included), the all-reduce of the step's "
        f"{r0['allreduce'][0]:.1f} MiB buffer alone {r0['allreduce'][1]:.3f} ms; peak allocated "
        f"{r0['peak_gib']:.2f} GiB a rank; the sharded epoch's launches at rank 0's wrappers "
        f"{r0['launches']}, on its card {r0['device']}")
    per_step = {"block_hash_fwd": 2, "block_hash_bwd": 2}
    only_launches(r0["device"], training_launches(per_step, PARALLEL_FRAMES))
    only_launches(r0["launches"], training_launches(per_step, 2 * r0["graphs"]))
    return r0["launches"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from lidarnerf_tpu_torch.ops import (block_hash_cuda, cuda_lib, fused_mlp_cuda,
                                         occ_lookup_cuda, perm_gather_cuda)
    from lidarnerf_tpu_torch.ops.block_hash import make_block_hash_spec
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer

    set_variant("default")  # the default paths first; each variant phase sets its switch
    reset_counts()  # the count on the card is on from here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()

    def phase_done(name):  # the script's clock at the end of each group of phases
        log(f"[{time.perf_counter() - t0:.1f} s] {name} done")

    # all nine sources, one nvcc each, started together
    libs = cuda_lib.build(block_hash_cuda.SOURCES + (fused_mlp_cuda.SOURCE, perm_gather_cuda.SOURCE,
                                                     occ_lookup_cuda.SOURCE))
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
    phase_done("kernel checks and determinism")

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
    phase_done("serving")

    # the entry points of B5 and B6 at the model's shapes
    paths["fused-mlp"], b5 = fused_mlp_phase(params, ds)
    paths["sort-merge"], b6 = perm_gather_phase(params, ds)
    kernels += [b5, *b6]
    torch.cuda.empty_cache()
    phase_done("fused-mlp and sort-merge")

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
    phase_done("training and its variants")

    # --fast: occupancy-prior sampling, training then serving
    trainer, init_sd, paths["training-fast"] = train_fast_phase(ds, default_step_ms)
    paths["serving-fast"] = serve_fast_phase(ds, trainer, init_sd)
    paths["occ-lookup"], p12 = occ_lookup_phase(ds, trainer)
    kernels.append(p12)
    del trainer, init_sd

    for variant in ("default", *VARIANT_ENV):
        train_reference_phase(ds, variant)
    train_reference_phase(ds, fast=True)
    phase_done("--fast and the fp32 reference steps")

    # each training path eager and captured, in turns
    torch.cuda.empty_cache()
    paths.update(training_graph_phases(ds))
    phase_done("training-graph")

    # the CLI and the trainer's workspace
    torch.cuda.empty_cache()
    paths["cli"], paths["cli-test-eval"] = cli_phase()
    phase_done("cli")

    # the NeRF-MVL object path
    torch.cuda.empty_cache()
    paths["mvl"], paths["mvl-test-eval"], paths["training-graph-masked"] = mvl_phase()
    phase_done("mvl")

    # the data on-ramp: raw trees -> panos, transforms, scene constants -> training
    torch.cuda.empty_cache()
    (paths["onramp-check"], paths["onramp-train"], paths["onramp-test-eval"],
     paths["onramp-mvl"]) = onramp_phase()
    phase_done("onramp")

    # the other position encodings, then RGB rendering: no kernel of the port
    torch.cuda.empty_cache()
    paths["encodings"] = encodings_phase(ds)
    phase_done("encodings")
    torch.cuda.empty_cache()
    paths["rgb"] = rgb_phase()
    phase_done("rgb")

    # the classical baselines: PCGen, the ray-drop MLP and UNet, the baseline CLIs
    torch.cuda.empty_cache()
    paths["baselines"] = baselines_phase()
    phase_done("baselines")

    # the block-hash seam options, then training over an NCCL group of every GPU
    torch.cuda.empty_cache()
    paths.update(seams_phase(ds))
    phase_done("seams")
    torch.cuda.empty_cache()
    paths["parallel"] = parallel_phase()
    phase_done("parallel")

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
