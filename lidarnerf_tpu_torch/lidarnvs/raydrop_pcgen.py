"""PCGen ray-drop MLP and its trainer (counterpart of
lidarnerf_tpu/lidarnvs/raydrop_pcgen.py).

The nerf-pytorch-style `RayDrop` MLP (D ReLU layers of width W and a linear
head, kaiming-normal weights, zero biases), the positional embedder, the
input packing of `run_network` (direction, depth and intensity
embeddings), flattened-ray batching, and the trainer with optax's Adam
under the exponential or cosine lr. The rays stay on the device and the
batches are slices of them; the batch order is the JAX trainer's (numpy
permutations from RandomState(0)). Checkpoints are the JAX package's
pickles: `{"global_step", "network_fn_state_dict": flax tree}`.
"""

import os
import pickle
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lidarnerf_tpu_torch.ops.dispatch import resolve_device
from lidarnerf_tpu_torch.utils.params import (
    load_state,
    raydrop_params_from_jax,
    raydrop_params_to_jax,
)


class RayDrop(nn.Module):
    """D fully-connected ReLU layers + a linear head; `layers[i]` is flax's Dense_i.

    Weights are kaiming-normal (std sqrt(2 / fan_in)) from `generator`,
    biases zero, as the JAX module's init.
    """

    def __init__(self, input_ch, D=4, W=128, output_ch=1, generator=None):
        super().__init__()
        dims = [input_ch] + [W] * D + [output_ch]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for layer in self.layers:
                fan_in = layer.weight.shape[1]
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                                   * np.sqrt(2.0 / fan_in))
                layer.bias.zero_()

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def get_embedder(multires, input_dims=3, i=0):
    """(embed_fn, out_dim); i=-1 -> identity."""
    if i == -1:
        return (lambda x: x), input_dims
    freq_bands = 2.0 ** np.linspace(0.0, multires - 1, multires)

    def embed(x):
        outs = [x]
        for f in freq_bands:
            outs.append(torch.sin(x * float(f)))
            outs.append(torch.cos(x * float(f)))
        return torch.cat(outs, dim=-1)

    return embed, input_dims * (1 + 2 * multires)


def run_network(inputs, model, embed_fn, embeddirs_fn):
    """inputs [N, 5] = (dir xyz, depth, intensity) -> raydrop logits [N, 1]."""
    dirs, depth, intensity = inputs[:, :3], inputs[:, 3:4], inputs[:, 4:5]
    packed = torch.cat([embeddirs_fn(dirs), embed_fn(depth), embed_fn(intensity)], dim=1)
    return model(packed)


def pack_rays(directions, panos, intensities, raydrop_masks):
    """Flatten frame lists to [N, 6] = (dir, depth, intensity, target).

    Pixels with mask == -1 (MVL bbox) are removed; targets binarised.
    """
    rays = np.concatenate(
        [
            np.asarray(directions).reshape(-1, 3),
            np.asarray(panos).reshape(-1, 1),
            np.asarray(intensities).reshape(-1, 1),
        ],
        axis=-1,
    )
    masks = np.asarray(raydrop_masks).reshape(-1)
    keep = masks > -1
    rays = rays[keep]
    targets = np.where(masks[keep] == 0.0, 0.0, 1.0)
    return np.concatenate([rays, targets.reshape(-1, 1)], axis=-1).astype(np.float32)


def load_pkl_data(data_dir, split):
    """The `{split}_data.pkl` that `run --enable_collect_raydrop_dataset` wrote."""
    pkl_path = Path(data_dir) / f"{split}_data.pkl"
    if not pkl_path.is_file():
        raise ValueError(f"File {pkl_path} does not exist.")
    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def cosine_scheduler(base_value, final_value, global_step, warmup_iters=0, start_warmup_value=0):
    """Per-step values: a linear warm-up, then a cosine from base to final."""
    warmup = (np.linspace(start_warmup_value, base_value, warmup_iters) if warmup_iters
              else np.array([]))
    iters = np.arange(global_step - warmup_iters)
    sched = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters))
    )
    return np.concatenate([warmup, sched])


class RayDropTrainer:
    """Adam + exponential or cosine lr + MSE (or L1) on the sigmoid, .ckpt save/load.

    The update is optax.adam's (b1 0.9, b2 0.999, eps 1e-8, eps_root 0):
    mu and nu are bias-corrected by the update's count and the step is
    lr(k) * mu_hat / (sqrt(nu_hat) + eps), where k counts the updates from 0
    (optax's schedule count). torch.optim.Adam computes the same step
    (fused into one kernel on CUDA); its lr is set from the host's count
    before each step, a float32 as optax's schedule gives it, so no step
    reads the device.

    Args:
        device: None runs on CUDA and raises if there is none; "cpu" runs on the CPU.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(
        self,
        netdepth=4,
        netwidth=128,
        multires=4,
        multires_views=10,
        i_embed=0,
        lrate=5e-4,
        lrate_decay=500,
        n_iters=10000,
        cos_lr=False,
        loss="mseloss",
        basedir="./log",
        expname="raysdrop",
        seed=0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.i_embed = i_embed
        self.embed_fn, ch = get_embedder(multires, input_dims=1, i=i_embed)
        self.embeddirs_fn, ch_views = get_embedder(multires_views, input_dims=3, i=i_embed)
        self.input_ch = ch * 2 + ch_views
        gen = torch.Generator().manual_seed(seed)
        self.model = RayDrop(self.input_ch, D=netdepth, W=netwidth, generator=gen).to(self.device)
        if cos_lr:
            sched = cosine_scheduler(lrate, lrate * 0.01, n_iters).astype(np.float32)
            self.lr_fn = lambda k: float(sched[min(k, len(sched) - 1)])
        else:
            decay = np.float32(lrate_decay * 1000)
            self.lr_fn = lambda k: float(
                np.float32(lrate) * np.float32(0.1) ** (np.float32(k) / decay))
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lrate,
                                          betas=(self.b1, self.b2), eps=self.eps,
                                          fused=self.device.type == "cuda")
        self.count = 0  # updates so far: optax's Adam and schedule counts
        self.loss_name = loss
        self.basedir = basedir
        self.expname = expname
        self.n_iters = n_iters
        self.loss_log = None  # [n_iters] device tensor of the last train()'s losses

    def loss_fn(self, batch):
        pred = run_network(batch[:, :5], self.model, self.embed_fn, self.embeddirs_fn)
        pred = torch.sigmoid(pred[:, 0])
        target = batch[:, 5]
        if self.loss_name == "l1loss":
            return torch.mean(torch.abs(pred - target))
        return torch.mean((pred - target) ** 2)

    def step(self, batch):
        """One Adam update on `batch` [N, 6] (on the device); returns the loss, 0-d on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch)
        loss.backward()
        self.optimizer.param_groups[0]["lr"] = self.lr_fn(self.count)
        self.optimizer.step()
        self.count += 1
        return loss.detach()

    def train(self, rays_all, N_rand=2048, n_iters=None, log_every=1000, verbose=True):
        """rays_all: [N, 6] packed rays; shuffled epochs of N_rand batches.

        Returns the last 10 losses as floats; `loss_log` holds them all.
        """
        n_iters = n_iters or self.n_iters
        rng = np.random.RandomState(0)
        order = rng.permutation(len(rays_all))
        rays = torch.from_numpy(rays_all[order]).to(self.device)
        ptr = 0
        self.loss_log = torch.zeros(n_iters, device=self.device)
        self.model.train()
        for it in range(n_iters):
            if ptr + N_rand > len(rays):
                order = rng.permutation(len(rays_all))
                rays = torch.from_numpy(rays_all[order]).to(self.device)
                ptr = 0
            loss = self.step(rays[ptr : ptr + N_rand])
            ptr += N_rand
            self.loss_log[it] = loss
            if verbose and (it % log_every == 0):
                print(f"[raydrop] iter {it}: loss {float(loss):.6f}")
        return self.loss_log[-10:].tolist()

    @torch.no_grad()
    def predict(self, rays_val):
        """rays_val [N, 5] -> raydrop probability [N] (numpy)."""
        self.model.eval()
        x = torch.as_tensor(np.asarray(rays_val, np.float32), device=self.device)
        logits = run_network(x, self.model, self.embed_fn, self.embeddirs_fn)
        return torch.sigmoid(logits[:, 0]).cpu().numpy()

    def save_checkpoint(self, step):
        path = os.path.join(self.basedir, self.expname, f"{step:06d}.ckpt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "global_step": step,
                    "network_fn_state_dict": raydrop_params_to_jax(self.model.state_dict()),
                },
                f,
            )
        return path

    def load_checkpoint(self, path):
        """Load either package's checkpoint; returns its global_step.

        Raises ValueError when the checkpoint's MLP takes another number of
        inputs than this one, i.e. it was trained with another `i_embed`.
        """
        ckpt = load_state(path)
        sd = raydrop_params_from_jax(ckpt["network_fn_state_dict"])
        n_in = sd["layers.0.weight"].shape[1]
        if n_in != self.input_ch:
            raise ValueError(
                f"{path}: the checkpoint's ray-drop MLP takes {n_in} inputs, this one "
                f"{self.input_ch} (i_embed {self.i_embed}); it was trained with another "
                "i_embed (-1: 5 inputs, 0: 81 at the default multires 4 and multires_views 10)"
            )
        self.model.load_state_dict(sd)
        return ckpt.get("global_step", 0)
