"""UNet ray-drop trainer for the meshing baselines (counterpart of
lidarnerf_tpu/lidarnvs/raydrop_unet.py).

- a pickle-backed dataset of per-frame feature dicts, collated into a
  10-channel [N, H, W, 10] image (hit_mask, hit_depth, hit_normal xyz,
  incidence, intensity, ray_dir xyz) and a binary [N, H, W] target;
- BCE-with-logits + dice loss, the update of the JAX trainer (below),
  ReduceLROnPlateau(max, patience 5) on the validation dice;
- per-epoch checkpoints `checkpoint_epoch{n}.ckpt` holding the JAX trainer's
  flax trees `{"params", "batch_stats"}` (utils/params.py).

The update is the JAX trainer's optax chain, not torch's RMSprop, in this
order: the weight decay wd * p added to every gradient (BatchNorm scales
and biases too); clip_by_global_norm(1.0); scale_by_rms(decay 0.99, eps
1e-8): g * rsqrt(nu + eps), eps inside the root, nu from 0; a momentum
trace of 0.999; then lr * the plateau's scale times the trace is
subtracted. torch.optim.RMSprop puts eps outside the root and adds the
decay after any clip. The step reads nothing back to the host: the loss
is summed on the device and read once an epoch.
"""

import os
import pickle
from pathlib import Path

import numpy as np
import torch

from lidarnerf_tpu_torch.lidarnvs.unet import UNet, dice_coeff, dice_loss
from lidarnerf_tpu_torch.ops.dispatch import resolve_device
from lidarnerf_tpu_torch.ops.losses import bce_with_logits
from lidarnerf_tpu_torch.utils.params import load_state, unet_params_from_jax, unet_params_to_jax


class RaydropDataset:
    """Pickle-backed per-frame dataset."""

    def __init__(self, data_dir, split):
        self.data_dir = Path(data_dir)
        if split not in ("train", "test"):
            raise ValueError(f"Split {split} not supported.")
        pkl_path = self.data_dir / f"{split}_data.pkl"
        if not pkl_path.is_file():
            raise ValueError(f"File {pkl_path} does not exist.")
        with open(pkl_path, "rb") as f:
            self.raydrop_data = pickle.load(f)

    def __len__(self):
        return len(self.raydrop_data)

    def __getitem__(self, idx):
        return self.raydrop_data[idx]

    @staticmethod
    def collate(samples):
        """list of frame dicts -> (images [N,H,W,10], masks [N,H,W]), numpy float32."""
        def stack(key):
            return np.stack([np.asarray(s[key]) for s in samples])

        images = np.concatenate(
            [
                stack("hit_masks")[..., None],
                stack("hit_depths")[..., None],
                stack("hit_normals"),
                stack("hit_incidences")[..., None],
                stack("intensities")[..., None],
                stack("rays_d"),
            ],
            axis=3,
        ).astype(np.float32)
        masks = stack("raydrop_masks").astype(np.float32)
        return images, masks


class ReduceLROnPlateau:
    """torch-equivalent plateau scheduler (mode='max', factor=0.1)."""

    def __init__(self, factor=0.1, patience=5, mode="max"):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric):
        better = self.best is None or (
            metric > self.best if self.mode == "max" else metric < self.best
        )
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale


class UNetRaydropTrainer:
    """Args as the JAX trainer's, plus `device`: None runs on CUDA and raises
    if there is none; "cpu" runs on the CPU."""

    rms_decay, rms_eps = 0.99, 1e-8

    def __init__(
        self,
        n_channels=10,
        learning_rate=1e-5,
        weight_decay=1e-8,
        momentum=0.999,
        gradient_clipping=1.0,
        seed=0,
        bilinear=False,
        device=None,
    ):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.model = UNet(n_channels=n_channels, n_classes=1, bilinear=bilinear,
                          generator=gen).to(self.device)
        self.lr = learning_rate
        self.plateau = ReduceLROnPlateau()
        self._lr_scale = 1.0
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.gradient_clipping = gradient_clipping
        self.params = list(self.model.parameters())
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.trace = [torch.zeros_like(p) for p in self.params]

    def _to_device(self, images, masks):
        x = torch.as_tensor(images, device=self.device).permute(0, 3, 1, 2)
        return x, torch.as_tensor(masks, device=self.device)

    def step(self, images, masks, lr_scale=1.0):
        """One update on a collated batch; returns the loss (0-d, on the device)."""
        self.model.train()
        x, masks = self._to_device(images, masks)
        for p in self.params:
            p.grad = None
        logits = self.model(x)[:, 0]  # [N, H, W]
        loss = torch.mean(bce_with_logits(logits, masks))
        loss = loss + dice_loss(torch.sigmoid(logits), masks)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad + self.weight_decay * p for p in self.params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.gradient_clipping
            lr = self.lr * lr_scale
            for p, g, nu, tr in zip(self.params, grads, self.nu, self.trace):
                g = torch.where(keep, g, (g / norm) * self.gradient_clipping)
                nu.copy_((1 - self.rms_decay) * (g * g) + self.rms_decay * nu)
                tr.copy_(-(torch.rsqrt(nu + self.rms_eps) * g) + self.momentum * tr)
                p.add_(tr * lr)
        return loss.detach()

    @torch.no_grad()
    def _dice(self, images, masks):
        self.model.eval()
        x, masks = self._to_device(images, masks)
        logits = self.model(x)[:, 0]
        pred = (torch.sigmoid(logits) > 0.5).float()
        return dice_coeff(pred, masks, reduce_batch_first=False)

    def train(self, data_dir, ckpt_dir, epochs=5, batch_size=1, verbose=True):
        """Epochs over the train pickles in numpy's RandomState(0) order, the
        test dice after each, a checkpoint each. Returns [{epoch, loss, dice,
        losses}], `losses` the epoch's steps'."""
        train_ds = RaydropDataset(data_dir, "train")
        test_ds = RaydropDataset(data_dir, "test")
        rng = np.random.RandomState(0)
        os.makedirs(ckpt_dir, exist_ok=True)
        history = []
        for epoch in range(1, epochs + 1):
            order = rng.permutation(len(train_ds))
            losses = []
            for start in range(0, len(order), batch_size):
                idxs = order[start : start + batch_size]
                images, masks = RaydropDataset.collate([train_ds[i] for i in idxs])
                losses.append(self.step(images, masks, self._lr_scale))
            losses = torch.stack(losses).tolist()
            epoch_loss = float(np.mean(losses))

            dice = self.evaluate(test_ds, batch_size)
            self._lr_scale = self.plateau.step(dice)
            history.append({"epoch": epoch, "loss": epoch_loss, "dice": dice, "losses": losses})
            if verbose:
                print(f"[unet-raydrop] epoch {epoch}: loss {epoch_loss:.4f} dice {dice:.4f}")
            self.save_checkpoint(os.path.join(ckpt_dir, f"checkpoint_epoch{epoch}.ckpt"))
        return history

    def evaluate(self, dataset, batch_size=1):
        """Mean over batches of the dice of the thresholded prediction."""
        scores = []
        for start in range(0, len(dataset), batch_size):
            images, masks = RaydropDataset.collate(
                [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
            )
            scores.append(self._dice(images, masks))
        return float(np.mean(torch.stack(scores).tolist())) if scores else 0.0

    @torch.no_grad()
    def predict(self, images):
        """images [N, H, W, 10] -> raydrop probability [N, H, W] (numpy)."""
        self.model.eval()
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        logits = self.model.predict_nhwc(x)[..., 0]
        return torch.sigmoid(logits).cpu().numpy()

    def save_checkpoint(self, path):
        params, batch_stats = unet_params_to_jax(self.model.state_dict())
        with open(path, "wb") as f:
            pickle.dump({"params": params, "batch_stats": batch_stats}, f)

    def load_checkpoint(self, path):
        """Load either package's checkpoint."""
        ckpt = load_state(path)
        self.model.load_state_dict(unet_params_from_jax(ckpt["params"], ckpt["batch_stats"]))
