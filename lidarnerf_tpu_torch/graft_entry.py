"""Driver entry points: the flagship forward render and a multi-device dry run
(counterpart of the repo's __graft_entry__.py).

    python -m lidarnerf_tpu_torch.graft_entry

`entry()` returns the flagship model's training render with its example
rays; `dryrun_multichip(n)` takes one data-parallel [2, 8]-patch training
step of a small model over a world of n ranks, one process each, started
here: NCCL over n GPUs, or gloo over n CPU processes when the CPU is asked
for. Both run on CUDA unless LIDARNERF_PLATFORM=cpu or `device="cpu"` asks
for the CPU; without either a GPU is needed. Run as a module, it renders
`entry()`'s rays, then dry-runs a world of every GPU.
"""

import os
import socket
import time
import traceback

import numpy as np
import torch

from lidarnerf_tpu_torch.bench import driver_device
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.models.renderer import RenderConfig, render_rays

DRYRUN_TIMEOUT_S = 600  # the world's limit, its start-up included (sharding.TIMEOUT's)
DRYRUN_RAYS_PER_RANK = 32


def _flagship(generator=None):
    """KITTI-360-class model: block-hash grid desired_res=32768, 2^19 table."""
    return NeRFNetwork(
        encoding="blockhash",  # kernel B1 on CUDA
        desired_resolution=32768,
        log2_hashmap_size=19,
        bound=1.0,
        compute_dtype=torch.bfloat16,
        generator=generator,
    )


def entry(device=None):
    """(forward-render fn, example_args) on the flagship model.

    fn(state, rays_o, rays_d, generator, noise=None, u=None) loads `state`
    (the model's state dict, in place) and returns (depth [N], image [N, 2],
    weights_sum [N]) of `render_rays(..., train=True)` without a gradient: the
    stratified jitter and the inverse-CDF draws come from `generator`, or
    from `noise` [N, 768] and `u` [N, 64] when given. The example arguments
    are the seed-0 weights, the JAX entry's 1024 rays from
    `np.random.RandomState(0)` and a generator seeded with 1, on the device.
    """
    device = driver_device(device)
    model = _flagship(torch.Generator().manual_seed(0)).to(device)
    cfg = RenderConfig(num_steps=768, upsample_steps=64, min_near_lidar=0.01, bound=1.0)
    state = model.state_dict()

    n_rays = 1024
    rng = np.random.RandomState(0)
    rays_o = torch.as_tensor(rng.uniform(-0.1, 0.1, (n_rays, 3)), dtype=torch.float32,
                             device=device)
    d = rng.randn(n_rays, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays_d = torch.as_tensor(d, dtype=torch.float32, device=device)
    generator = torch.Generator(device).manual_seed(1)

    @torch.no_grad()
    def fn(state, rays_o, rays_d, generator, noise=None, u=None):
        model.load_state_dict(state)
        out = render_rays(model, rays_o, rays_d, cfg, train=True, generator=generator,
                          noise=noise, u=u)
        return out["depth"], out["image"], out["weights_sum"]

    return fn, (state, rays_o, rays_d, generator)


def dryrun_multichip(n_devices, device=None, num_rays=None):
    """One sharded [2, 8]-patch training step of the small model over a world
    of `n_devices` ranks; prints and returns rank 0's loss.

    The world is started here, one process a rank (torch.multiprocessing
    spawn, a free localhost port): NCCL with rank r on GPU r, or gloo on the
    CPU. The step is `parallel/sharding.make_sharded_train_step` over
    `make_mesh(n)`, the weights and Adam state made equal on every rank with
    `replicate`. `num_rays` is the global batch (the JAX dry run's 32 a rank
    by default); each rank renders its share of it.
    """
    import queue as queues

    import torch.multiprocessing as mp

    dev_type = driver_device(device).type
    if dev_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} GPUs; "
                           f"{torch.cuda.device_count()} are visible")
    if num_rays is None:
        num_rays = DRYRUN_RAYS_PER_RANK * n_devices
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_dryrun_rank,
                         args=(r, n_devices, port, dev_type, num_rays, results))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    try:
        while len(out) + len(errors) < n_devices:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"the dry run's world did not finish in {DRYRUN_TIMEOUT_S} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 5.0))
            except queues.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank of the dry run died with exit code {dead[0]}")
                continue
            (out.__setitem__(rank, payload) if ok else errors.append(f"rank {rank}:\n{payload}"))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(errors))
    loss = out[0]
    print(f"dryrun_multichip: {n_devices} devices OK, loss={loss:.4f}")
    return loss


def _dryrun_rank(rank, world, port, dev_type, num_rays, results):
    """One rank of dryrun_multichip's world (the target of each process)."""
    import torch.distributed as dist

    from lidarnerf_tpu_torch.parallel.sharding import init_from_env

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        if dev_type == "cpu":
            torch.set_num_threads(1)
        init_from_env(dev_type)  # NCCL with rank r on GPU r, or gloo
        results.put((rank, True, _dryrun_body(world, num_rays)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dryrun_body(n_devices, num_rays):
    """The step on this rank (__graft_entry__.py:86-139); returns its loss."""
    from lidarnerf_tpu_torch.nerf.train_step import TrainConfig
    from lidarnerf_tpu_torch.parallel.sharding import (
        make_mesh,
        make_sharded_train_step,
        replicate,
    )

    mesh = make_mesh(n_devices)
    dev = mesh.device
    H, W = 16, 64

    model = NeRFNetwork(desired_resolution=256, log2_hashmap_size=12, num_levels=8, bound=1.0,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    tcfg = TrainConfig(
        scale=0.05,
        num_rays_lidar=num_rays,
        H_lidar=H,
        W_lidar=W,
        intrinsics_lidar=(10.0, 30.0),
        grad_loss=True,
        iters=100,
    )
    rcfg = RenderConfig(num_steps=32, upsample_steps=8, min_near_lidar=0.05, bound=1.0)

    # patch-mode step exercises the structural regularizer's sharding too
    step = make_sharded_train_step(model, tcfg, rcfg, mesh, patch_size=[2, 8])
    replicate([p.data for p in model.parameters()], mesh)
    replicate(step.optimizer.mu + step.optimizer.nu, mesh)

    F = 2
    rng = np.random.RandomState(0)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (F, 4, 4)).copy()
    images = rng.rand(F, H, W, 3).astype(np.float32)
    images[..., 2] *= 0.5  # depths within the [near, far] band
    poses_d = replicate(torch.from_numpy(poses).to(dev), mesh)
    images_d = replicate(torch.from_numpy(images).to(dev), mesh)
    vi = torch.zeros((F, 1), dtype=torch.long, device=dev)
    vc = torch.full((F,), H * W, dtype=torch.long, device=dev)

    metrics = step(poses_d, images_d, vi, vc, 0, generator=torch.Generator(dev).manual_seed(1))
    loss = float(metrics["loss"])  # a host read: the step has finished
    if not np.isfinite(loss):
        raise FloatingPointError(f"the dry run's loss is {loss}")
    return loss


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    device = args[1].device
    dryrun_multichip(torch.cuda.device_count() if device.type == "cuda" else 1,
                     device=device.type)
