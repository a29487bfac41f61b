#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lidarnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the ported path from `lidarnerf_tpu_torch/csrc`,
holds each against its plain PyTorch version on the card at the main path's
shapes, then drives the main path — full-pano LiDAR rendering through
`PanoRenderer` at the full width of the KITTI-360 model (16-level 2^19
block-hash grid, width-64 bf16 MLPs, 768 + 64 samples, 4096-ray chunks,
66 x 1030 panos) with weights made from a seed — and checks that the path
went through the kernels and that its output is right. Prints one JSON line
of per-kernel numbers and ends with a JSON status line. Exits non-zero, with
no result, when there is no GPU or when any phase fails.
"""

import json
import subprocess
import sys
import time
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_ATOL = 1e-5  # fp32, the same products, 8 corners summed in another order
# fp32 GPU vs fp32 CPU render of the same rays: the log-transmittance is an
# exclusive cumsum of 768 terms of up to ~35 in size, taken in another order
# on each device, which moves the weights by up to ~1e-3 relative
REF_RTOL, REF_ATOL = 1e-3, 1e-5


def log(msg):
    print(msg, flush=True)


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


def block_hash_phase(spec):
    """B1 vs its plain version on the coarse queries of one real chunk and on
    uniform ones; returns the kernel's `kernels` entry (launches filled later)."""
    from lidarnerf_tpu_torch.dataset.base import get_lidar_rays
    from lidarnerf_tpu_torch.ops import block_hash_cuda
    from lidarnerf_tpu_torch.ops.block_hash import encode_plain, level_indices_and_weights
    from lidarnerf_tpu_torch.ops.sampling import stratified_z_vals

    dev = torch.device("cuda")
    pose = torch.from_numpy(drive_poses(1)[0]).to(dev)
    rays = get_lidar_rays(pose[None], INTRINSICS, H, W)
    o = rays["rays_o"][0, : FULL.max_ray_batch]
    d = rays["rays_d"][0, : FULL.max_ray_batch]
    near = torch.full((o.shape[0], 1), FULL.scale, device=dev)
    z = stratified_z_vals(near, near * 81.0, FULL.num_steps)
    xyz = torch.clamp(o[:, None] + d[:, None] * z[..., None], -FULL.bound, FULL.bound)
    coarse = ((xyz + FULL.bound) / (2 * FULL.bound)).reshape(-1, 3).contiguous()
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

    L = spec.num_levels
    rows = []
    inside = ~((coarse < 0) | (coarse > 1)).any(-1)
    for li, level in enumerate(spec.levels):
        rows.append(level_indices_and_weights(coarse[inside], level, li, spec)[0])
    n_rows = torch.unique(torch.cat(rows)).numel()
    bytes_moved = Q * 12 + Q * 2 * L * 4 + n_rows * 512
    flops = Q * L * 60  # scale/floor/frac per axis, 8 corners x 2 channels, weights
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations"

    ms = cuda_ms(lambda: block_hash_cuda.block_hash_fwd(coarse, table, spec), reps=10)
    plain_ms = cuda_ms(lambda: encode_plain(coarse, table, spec), reps=1, batches=3, warmup=1)
    fine = coarse[: FULL.max_ray_batch * FULL.upsample_steps]
    fine_ms = cuda_ms(lambda: block_hash_cuda.block_hash_fwd(fine, table, spec), reps=10)
    log(f"block_hash_fwd coarse call Q={Q}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by}: {bytes_moved / 1e6:.1f} MB incl. "
        f"{n_rows} table rows); fine-call shape Q={fine.shape[0]}: {fine_ms:.4f} ms")
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


def slice_phase(renderer):
    """The main path: full-width panos through PanoRenderer; returns launch counts."""
    from lidarnerf_tpu_torch.ops import block_hash_cuda

    near, far = FULL.scale, FULL.scale * renderer.cfg.far_mult
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_hash_cuda.launches = 0
    times = []
    frames = []
    for pose in drive_poses(N_PANOS):
        t0 = time.perf_counter()
        frames.append(renderer.render_frame(pose, H, W, INTRINSICS))  # ends on the host
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"block_hash_fwd": block_hash_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    chunks = -(-H * W // FULL.max_ray_batch)
    for raydrop, intensity, depth in frames:
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
    if launches["block_hash_fwd"] != 2 * chunks * N_PANOS:
        raise AssertionError(
            f"block_hash_fwd launched {launches['block_hash_fwd']} times, "
            f"expected {2 * chunks * N_PANOS}")
    rays = H * W
    log(f"slice on {gpu_line()}: {N_PANOS} panos of {H}x{W} rays, {FULL.num_steps}+{FULL.upsample_steps} "
        f"samples, chunk {FULL.max_ray_batch}: ms/pano {', '.join(f'{t:.1f}' for t in times)}; "
        f"rays/s (last pano) {rays / (times[-1] / 1e3):.0f}; peak memory "
        f"{peak / 2**30:.2f} GiB; block_hash_fwd launches {launches['block_hash_fwd']}")
    return launches


def profile_phase(renderer, top=12):
    """Device time by operator for one chunk of the main path (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pose = drive_poses(1)[0]
    h, w = 4, FULL.max_ray_batch // 4  # exactly one chunk of rays
    renderer.render_frame(pose, h, w, INTRINSICS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_frame(pose, h, w, INTRINSICS)
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device time of the kernels themselves, then of the operators that
    # launched them (each kernel's time is counted once in each list)
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    ops = [e for e in averages if e.device_type == DeviceType.CPU and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"profile of one {FULL.max_ray_batch}-ray chunk: device busy {busy_ms:.2f} ms "
        f"of {wall_ms:.2f} ms wall under the profiler")
    for title, events in (("kernels", kernels), ("operators", ops)):
        log(f" by {title}:")
        for e in sorted(events, key=dev_us, reverse=True)[:top]:
            log(f"  {dev_us(e) / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:100]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from lidarnerf_tpu_torch.ops import block_hash_cuda, cuda_lib
    from lidarnerf_tpu_torch.ops.block_hash import make_block_hash_spec
    from lidarnerf_tpu_torch.nerf.infer import PanoRenderer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = cuda_lib.build([block_hash_cuda.SOURCE])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        report = lib.with_suffix(".log")
        if report.exists():
            log(report.read_text().strip())

    spec = make_block_hash_spec(log2_hashmap_size=FULL.log2_hashmap_size,
                                desired_resolution=FULL.desired_resolution)
    kernels = [block_hash_phase(spec)]
    params = flax_layout_params(SEED, FULL)
    reference_phase(params)
    renderer = PanoRenderer(FULL, params)
    launches = slice_phase(renderer)
    profile_phase(renderer)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
