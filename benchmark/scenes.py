"""The cells' data, made at set-up from the seed (frozen copies of the repo's
synthetic-data generators, moved onto the device).

- `street`: the analytic street of `lidarnerf_tpu_torch/tools/make_synth_drive.py`
  (a ground plane, two building walls, six pillars) cast into KITTI-360
  format panos (66 x 1030, (fov_up, fov) = (2, 26.9)) from poses 3 m apart
  along +x, with the drive's ray drop; the seed draws the ray drop. The
  scene's normalisation (offset, scale) is computed from its points as the
  preprocessing computes a sequence's (`cal_centerpose_bound`).
- `car`: the analytic car of `lidarnerf_tpu_torch/tools/make_synth_mvl.py`
  (two boxes) sphere-traced into NeRF-MVL panos (256 x 1800, (15, 40)) from
  the tool's poses orbiting it at 5-7 m, the depth -1 outside a rectangle
  around the object's hits (the bbox mask). The scene is the same for every
  seed: where the rays concentrate sets the table gradient's contention, so
  a seed that moved the orbit would change the work.

A dataset is a dict of device tensors: poses [F, 4, 4] and images
[F, H, W, 3] = (ray drop, intensity, depth x scale) as the port's datasets
hold them, valid_idx [F, P] / valid_counts [F] (the masked pools, or a dummy
pool), and `serve_poses` [P, 4, 4] (novel poses, between the training ones).
"""

import math

import numpy as np
import torch

STREET_HW, STREET_K = (66, 1030), (2.0, 26.9)
SENSOR_Z = 1.7
PILLARS = [(8, 4, 0.4), (16, -5, 0.5), (26, 3, 0.4), (36, -4, 0.6), (47, 5, 0.5), (58, -3, 0.4)]
CAR_HW, CAR_K = (256, 1800), (15.0, 40.0)
CAR_CENTER = np.array([6.0, 0.0, 0.0])


def pano_dirs(H, W, K, device, dtype=torch.float64):
    """[H * W, 3] unit directions of the pano grid, row-major."""
    fov_up, fov = K
    j, i = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device), indexing="ij")
    beta = -(i - W / 2) / W * 2 * math.pi
    alpha = (fov_up - j / H * fov) / 180 * math.pi
    return torch.stack([torch.cos(alpha) * torch.cos(beta), torch.cos(alpha) * torch.sin(beta),
                        torch.sin(alpha)], -1).reshape(-1, 3)


def street_pose(i, spacing=3.0):
    t = np.array([i * spacing, 0.3 * np.sin(i * 0.4), SENSOR_Z])
    yaw = 0.05 * np.sin(i * 0.3)
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    pose[:3, 3] = t
    return pose


def street_depth(o, d):
    """Nearest hit of the street along rays o + t d ([F, N, 3] float64): (depth, hit)."""
    inf = 1e9
    safe = torch.where(d[..., 2] == 0, 1.0, d[..., 2])
    tz = torch.where(d[..., 2] < -1e-6, -o[..., 2] / safe, inf)
    depth = torch.where(tz > 0, tz, inf)
    for wy in (12.0, -12.0):
        dy = torch.where(d[..., 1].abs() < 1e-9, 1e-9, d[..., 1])
        t = (wy - o[..., 1]) / dy
        z = o[..., 2] + t * d[..., 2]
        depth = torch.minimum(depth, torch.where((t > 0) & (z > 0) & (z < 8.0), t, inf))
    for px, py, r in PILLARS:
        ox, oy = o[..., 0] - px, o[..., 1] - py
        b = 2 * (ox * d[..., 0] + oy * d[..., 1])
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        c = ox ** 2 + oy ** 2 - r * r
        disc = b * b - 4 * a * c
        t = torch.where(disc > 0, (-b - torch.sqrt(disc.clamp(min=0))) / (2 * a.clamp(min=1e-9)), inf)
        z = o[..., 2] + t * d[..., 2]
        depth = torch.minimum(depth, torch.where((t > 0) & (z > 0) & (z < 6.0), t, inf))
    hit = depth < 75.0
    return torch.where(hit, depth, 0.0), hit


def street(n_train, device, generator, hw=STREET_HW):
    """The street dataset: n_train training poses, and n_train - 1 novel
    poses halfway between them. The ray drop draws come from `generator`."""
    H, W = hw
    dirs = pano_dirs(H, W, STREET_K, device)
    poses = torch.as_tensor(np.stack([street_pose(i) for i in range(n_train)]), device=device)
    d = dirs[None] @ poses[:, :3, :3].transpose(1, 2)
    o = poses[:, None, :3, 3].expand_as(d)
    depth, hit = street_depth(o, d)
    drop_p = ((depth - 40) / 80).clamp(0, 0.35)
    u = torch.rand(depth.shape, generator=generator, device=device, dtype=torch.float64)
    hit = hit & ~(hit & (u < drop_p))
    depth = torch.where(hit, depth, 0.0)
    p = o + d * depth[..., None]
    albedo = torch.where(p[..., 2] < 0.05, 0.25, 0.6)
    albedo = torch.where(p[..., 1].abs() > 11.5, 0.45, albedo)
    inten = torch.where(hit, (albedo / (1.0 + (depth / 40.0) ** 2)).clamp(0, 1), 0.0)
    pts = p[hit]  # the scene's normalisation, from its points in the world
    center = (pts.amax(0) + pts.amin(0)) / 2
    scale = float(1.0 / (pts - center).abs().max())
    offset = center.tolist()
    images = torch.stack([hit.double(), inten, depth * scale], -1).reshape(n_train, H, W, 3)
    serve = torch.as_tensor(np.stack([street_pose(i + 0.5) for i in range(n_train - 1)]),
                            device=device)
    return _dataset(poses, images, serve, scale, offset, (H, W), STREET_K)


def _dataset(poses, images, serve, scale, offset, hw, K, masked=False):
    off = torch.as_tensor(offset, dtype=torch.float64, device=poses.device)
    out = {}
    for name, p in (("poses", poses), ("serve_poses", serve)):
        p = p.clone()
        p[:, :3, 3] = (p[:, :3, 3] - off) * scale
        out[name] = p.float()
    out["images"] = images.float().contiguous()
    F, H, W = images.shape[:3]
    if masked:  # the flat indices of each frame's unmasked pixels, padded with 0
        valid = images[..., 0].reshape(F, H * W) > -1
        counts = valid.sum(1)
        P = int(counts.max())
        rank = torch.cumsum(valid, 1) - 1
        idx = torch.zeros((F, P), dtype=torch.long, device=poses.device)
        f, q = torch.nonzero(valid, as_tuple=True)
        idx[f, rank[f, q]] = q
        out["valid_idx"], out["valid_counts"] = idx, counts.long()
    else:
        out["valid_idx"] = torch.zeros((F, 1), dtype=torch.long, device=poses.device)
        out["valid_counts"] = torch.full((F,), H * W, dtype=torch.long, device=poses.device)
    out.update(scale=scale, offset=list(offset), hw=hw, intrinsics=K, masked=masked)
    return out


def car_sdf(p):
    def box(c, h):
        q = (p - torch.as_tensor(c, dtype=p.dtype, device=p.device)).abs() - torch.as_tensor(
            h, dtype=p.dtype, device=p.device)
        return torch.linalg.vector_norm(q.clamp(min=0), dim=-1) + q.amax(-1).clamp(max=0)
    return torch.minimum(box(CAR_CENTER + [0.0, 0.0, -0.25], [2.2, 0.95, 0.65]),
                         box(CAR_CENTER + [-0.3, 0.0, 0.55], [1.1, 0.8, 0.45]))


def car_hits(o, d, n_steps=256, t_max=16.0):
    """Sphere-trace the car along o + t d ([N, 3] float32): (depth, 0 on a
    miss; intensity 0.25 + 0.6 |cos incidence|)."""
    o64, d64 = o.double(), d.double()

    def point(t):
        return (o64 + d64 * t.double()[:, None]).float()

    t = torch.full(o.shape[:1], 0.5, dtype=torch.float32, device=o.device)
    for _ in range(n_steps):
        t = torch.where(t < t_max, t + car_sdf(point(t)).clamp(1e-4, 1.0), t)
    p = point(t)
    hit = (t < t_max) & (car_sdf(p) < 1e-2)
    eps = torch.eye(3, device=o.device) * 1e-3
    n = torch.stack([car_sdf(p + e) - car_sdf(p - e) for e in eps], -1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-9)
    cosi = (n * d).sum(-1).abs()
    return torch.where(hit, t, 0.0), torch.where(hit, (0.25 + 0.6 * cosi).clamp(0, 1), 0.0)


def car_pose(ang, r, h):
    eye = CAR_CENTER + np.array([-r * np.cos(ang), -r * np.sin(ang), h])
    fwd = (CAR_CENTER - eye) / np.linalg.norm(CAR_CENTER - eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([fwd, -right, np.cross(right, fwd)], axis=1)
    pose[:3, 3] = eye
    return pose


def car(n_train, device, scale, hw=CAR_HW):
    """The car dataset: the tool's training poses (angles of a ring of
    n_train + 4 shuffled by RandomState(0), then each frame's radius in 5-7 m
    and height in -0.3-0.8 m from the same stream), the same for every seed;
    the novel poses halfway between neighbouring training angles."""
    H, W = hw
    rng = np.random.RandomState(0)
    angles = np.linspace(0, 2 * np.pi, n_train + 4, endpoint=False)
    rng.shuffle(angles)
    poses = []
    for a in angles[:n_train]:
        r = rng.uniform(5.0, 7.0)
        poses.append(car_pose(a, r, rng.uniform(-0.3, 0.8)))
    angles = angles[:n_train]
    poses = np.stack(poses)
    srt = np.sort(angles)
    mids = (srt + np.roll(srt, -1) + np.where(np.arange(n_train) == n_train - 1, 2 * np.pi, 0)) / 2
    serve = np.stack([car_pose(a, 6.0, 0.25) for a in mids])
    dirs = pano_dirs(H, W, CAR_K, device, torch.float32)
    images = []
    for pose in poses:
        R = torch.as_tensor(pose[:3, :3], dtype=torch.float32, device=device)
        d = dirs @ R.T
        o = torch.as_tensor(pose[:3, 3], dtype=torch.float32, device=device).expand_as(d)
        depth, inten = car_hits(o.contiguous(), d)
        depth, inten = depth.reshape(H, W), inten.reshape(H, W)
        hitm = depth > 0
        img = torch.full((H, W), -1.0, device=device)
        if bool(hitm.any()):
            rows = torch.nonzero(hitm.any(1))[:, 0]
            cols = torch.nonzero(hitm.any(0))[:, 0]
            r0, r1 = max(int(rows.min()) - 4, 0), min(int(rows.max()) + 5, H)
            c0, c1 = max(int(cols.min()) - 4, 0), min(int(cols.max()) + 5, W)
            img[r0:r1, c0:c1] = depth[r0:r1, c0:c1]
        drop = torch.where(img > 0, 1.0, torch.where(img == 0, 0.0, -1.0))
        images.append(torch.stack([drop, inten, img * scale], -1))
    hx, hy, hz = 2.6, 1.4, 1.5
    obb = np.array([CAR_CENTER + [sx * hx, sy * hy, sz * hz - 0.2]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    return _dataset(torch.as_tensor(poses, device=device), torch.stack(images),
                    torch.as_tensor(serve, device=device), scale, obb.mean(0).tolist(), (H, W),
                    CAR_K, masked=True)


def make(config, seed, device):
    """The dataset of a configuration (`config["scene"]`); the street's ray
    drop from the seed."""
    scene = config["scene"]
    if scene["generator"] == "street":
        gen = torch.Generator(device).manual_seed(seed)
        return street(scene["train_frames"], device, gen, tuple(scene.get("hw", STREET_HW)))
    if scene["generator"] == "car":
        return car(scene["train_frames"], device, config["scale"], tuple(scene.get("hw", CAR_HW)))
    raise ValueError(f"unknown scene generator {scene['generator']!r}")
