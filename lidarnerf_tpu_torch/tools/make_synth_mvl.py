"""Full-size synthetic NeRF-MVL object dataset, traced on the GPU
(counterpart of tools/make_synth_mvl.py, the same scene and files).

    python -m lidarnerf_tpu_torch.tools.make_synth_mvl OUT [n_train]

Writes the NeRF-MVL layout at its real size: 256 x 1800 panos at
(fov_up, fov) = (15, 40) degrees as `car/*.npz` frames whose depth channel
is -1 outside a rectangle around the object's hits (the bbox mask, a
4-pixel margin), `dataset_bbox_7k.npy` (the object's OBB) and
`transforms_car_{train,val,test}.json` (n_train, 2 and 2 frames). The scene
is an analytic car (a box body and a cabin box) at 6 m, sphere-traced in
256 steps from t = 0.5 along each of a pano's 460,800 rays; the sensor
orbits it at 5-7 m on poses drawn from `np.random.RandomState(0)`.
Suggested CLI: `--config configs/nerf_mvl.txt --path OUT --scale 0.1`
(the offset is the OBB's mean). Runs on CUDA unless `device="cpu"` is passed
to `main`; the command line, as the CLI, unless LIDARNERF_PLATFORM=cpu.
"""

import json
import os
import sys
import time

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.convert import pano_dirs
from lidarnerf_tpu_torch.ops.dispatch import resolve_device

H, W = 256, 1800
K_LIDAR = (15.0, 40.0)
CENTER = np.array([6.0, 0.0, 0.0])


def sdf_hits(o, d, n_steps=256, t_max=16.0):
    """Sphere-trace the analytic car along rays o + t d ([N, 3] float32 tensors).

    Returns (depth [N], 0 where a ray misses; intensity [N], 0.25 + 0.6 |cos|
    of the incidence angle clipped to [0, 1] on a hit, 0 elsewhere), on o's
    device.
    """
    dev, f32 = o.device, torch.float32

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), dtype=f32, device=dev)

    body_c, body_h = vec(CENTER + np.array([0.0, 0.0, -0.25])), vec([2.2, 0.95, 0.65])
    cab_c, cab_h = vec(CENTER + np.array([-0.3, 0.0, 0.55])), vec([1.1, 0.8, 0.45])

    def box(p, c, h):
        q = torch.abs(p - c) - h
        return torch.linalg.vector_norm(torch.clamp(q, min=0), dim=-1) + torch.clamp(
            q.amax(dim=-1), max=0)

    def sdf(p):
        return torch.minimum(box(p, body_c, body_h), box(p, cab_c, cab_h))

    o64, d64 = o.double(), d.double()

    def point(t):
        # o + t d rounded once to float32, as a fused multiply-add rounds it
        # (and as XLA compiles the JAX tool's): t d is exact in float64
        return (o64 + d64 * t.double()[:, None]).float()

    t = torch.full(o.shape[:1], 0.5, dtype=f32, device=dev)
    for _ in range(n_steps):
        dist = sdf(point(t))
        t = torch.where(t < t_max, t + torch.clamp(dist, 1e-4, 1.0), t)
    p = point(t)
    hit = (t < t_max) & (sdf(p) < 1e-2)
    e = [vec(v) for v in np.eye(3) * 1e-3]
    n = torch.stack([sdf(p + ei) - sdf(p - ei) for ei in e], dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    cosi = torch.abs(torch.sum(n * d, dim=-1))
    inten = torch.where(hit, torch.clamp(0.25 + 0.6 * cosi, 0, 1), 0.0)
    return torch.where(hit, t, 0.0), inten


def main(out_dir="data_synth_mvl", n_train=12, n_val=2, cls="car", device=None):
    """Write the dataset; returns the seconds each frame took (trace and file)."""
    dev = resolve_device(device)
    os.makedirs(os.path.join(out_dir, cls), exist_ok=True)
    dirs_l = pano_dirs(H, W, K_LIDAR).reshape(-1, 3)

    # OBB with some margin around the car (world frame)
    hx, hy, hz = 2.6, 1.4, 1.5
    obb = np.array([CENTER + [sx * hx, sy * hy, sz * hz - 0.2]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    np.save(os.path.join(out_dir, "dataset_bbox_7k.npy"), {cls: obb}, allow_pickle=True)

    rng = np.random.RandomState(0)
    total = n_train + 2 * n_val
    angles = np.linspace(0, 2 * np.pi, total, endpoint=False)
    rng.shuffle(angles)
    seconds = []

    def make_frame(i, ang):
        t0 = time.perf_counter()
        # the sensor orbits the object at 5-7 m, its x axis towards the
        # object; the pose rotates the sensor frame into the world
        r = rng.uniform(5.0, 7.0)
        eye = CENTER + np.array([-r * np.cos(ang), -r * np.sin(ang), rng.uniform(-0.3, 0.8)])
        fwd = CENTER - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        R = np.stack([fwd, -right, up2], axis=1)  # sensor x -> fwd, y -> left, z -> up
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = eye

        d_world = dirs_l @ R.T
        o_world = np.broadcast_to(eye, d_world.shape)
        depth, inten = sdf_hits(torch.as_tensor(np.ascontiguousarray(o_world), dtype=torch.float32,
                                                device=dev),
                                torch.as_tensor(d_world, dtype=torch.float32, device=dev))
        pano = depth.cpu().numpy().reshape(H, W)
        intens = inten.cpu().numpy().reshape(H, W)
        hm = pano > 0
        # -1 outside a rectangle around the object's hits (the bbox mask)
        pano2d = np.full((H, W), -1.0)
        if hm.any():
            ys, xs = np.nonzero(hm)
            r0, r1 = max(ys.min() - 4, 0), min(ys.max() + 5, H)
            c0, c1 = max(xs.min() - 4, 0), min(xs.max() + 5, W)
            rect = np.zeros((H, W), bool)
            rect[r0:r1, c0:c1] = True
            pano2d[rect] = np.where(hm[rect], pano[rect], 0.0)
        data = np.stack([np.zeros((H, W)), intens, pano2d], axis=-1).astype(np.float32)
        fn = f"{cls}/{i:010d}.npz"
        np.savez_compressed(os.path.join(out_dir, fn), data=data)
        seconds.append(time.perf_counter() - t0)
        return {"lidar_file_path": fn, "lidar2world": pose.tolist()}

    idx = 0
    for split, n in [("train", n_train), ("val", n_val), ("test", n_val)]:
        frames = []
        for _ in range(n):
            frames.append(make_frame(idx, angles[idx]))
            idx += 1
            print(f"{split} frame {idx}/{total}", flush=True)
        meta = {"w_lidar": W, "h_lidar": H, "aabb_scale": 2, "frames": frames}
        with open(os.path.join(out_dir, f"transforms_{cls}_{split}.json"), "w") as f:
            json.dump(meta, f)
    print("done:", out_dir)
    return seconds


if __name__ == "__main__":
    from lidarnerf_tpu_torch.main_lidarnerf import device_from_env

    out = sys.argv[1] if len(sys.argv) > 1 else "data_synth_mvl"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    main(out, n, device=device_from_env())
