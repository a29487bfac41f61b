"""UNet ray-drop segmenter and the dice metrics (counterpart of
lidarnerf_tpu/lidarnvs/unet.py).

The classic UNet (64-128-256-512-1024 encoder, skip-connected decoder,
BatchNorm DoubleConv blocks, transposed-conv or bilinear upsampling), NCHW
inside as PyTorch's convolutions want it; `UNet.predict_nhwc` takes the
JAX package's [N, H, W, C]. Where PyTorch's layers differ from flax's, this
module follows flax:
- `BatchNorm` normalises a training batch by its own mean and biased
  variance (E[x^2] - E[x]^2, clamped at 0) and moves the running
  statistics by momentum 0.99 towards the same biased variance; torch's
  BatchNorm2d moves `running_var` towards the unbiased one.
- flax's ConvTranspose((2, 2), strides 2) is a dilated convolution with
  an unflipped kernel; `nn.ConvTranspose2d` holds that kernel flipped in
  space (utils/params.py flips it on the way in and out).
- `jax.image.resize(..., "bilinear")` samples at half-pixel centres, which
  is `F.interpolate(align_corners=False)`.
The initial weights follow flax's initialisers (lecun-normal kernels, zero
biases, unit BatchNorm scales) from an explicit generator.
"""

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal_(weight, fan_in, generator):
    """flax's default kernel init: a normal truncated at 2 std, of variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over NCHW channels (momentum 0.99, eps 1e-5)."""

    def __init__(self, channels, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class DoubleConv(nn.Module):
    def __init__(self, in_channels, out_channels, mid_channels=None, generator=None):
        super().__init__()
        mid = mid_channels or out_channels
        self.conv1 = nn.Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = nn.Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(out_channels)
        _lecun_normal_(self.conv1.weight, 9 * in_channels, generator)
        _lecun_normal_(self.conv2.weight, 9 * mid, generator)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class Down(nn.Module):
    def __init__(self, in_channels, out_channels, generator=None):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, generator=generator)

    def forward(self, x):
        return self.conv(F.max_pool2d(x, 2))  # floors odd sizes, as flax's VALID pool


class Up(nn.Module):
    """Upsample x1 (in_channels), pad it to the skip x2 (skip_channels), then
    DoubleConv over the concatenation [x2, x1]."""

    def __init__(self, in_channels, skip_channels, out_channels, bilinear=False, generator=None):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(in_channels + skip_channels, out_channels,
                                   mid_channels=in_channels // 2, generator=generator)
        else:
            self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
            _lecun_normal_(self.up.weight, 4 * in_channels, generator)
            with torch.no_grad():
                self.up.bias.zero_()
            self.conv = DoubleConv(in_channels // 2 + skip_channels, out_channels,
                                   generator=generator)

    def forward(self, x1, x2):
        if self.bilinear:
            H, W = x1.shape[-2:]
            x1 = F.interpolate(x1, size=(2 * H, 2 * W), mode="bilinear", align_corners=False)
        else:
            x1 = self.up(x1)
        # pad to match the skip connection (odd input sizes)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


class UNet(nn.Module):
    """64-128-256-512-1024 encoder, skip-connected decoder, a 1x1 head."""

    def __init__(self, n_channels=10, n_classes=1, bilinear=False, generator=None):
        super().__init__()
        self.n_channels, self.n_classes, self.bilinear = n_channels, n_classes, bilinear
        factor = 2 if bilinear else 1
        g = generator
        self.inc = DoubleConv(n_channels, 64, generator=g)
        self.down1 = Down(64, 128, generator=g)
        self.down2 = Down(128, 256, generator=g)
        self.down3 = Down(256, 512, generator=g)
        self.down4 = Down(512, 1024 // factor, generator=g)
        self.up1 = Up(1024 // factor, 512, 512 // factor, bilinear, generator=g)
        self.up2 = Up(512 // factor, 256, 256 // factor, bilinear, generator=g)
        self.up3 = Up(256 // factor, 128, 128 // factor, bilinear, generator=g)
        self.up4 = Up(128 // factor, 64, 64, bilinear, generator=g)
        self.outc = nn.Conv2d(64, n_classes, 1)
        _lecun_normal_(self.outc.weight, 64, g)
        with torch.no_grad():
            self.outc.bias.zero_()

    def forward(self, x):
        """x [N, C, H, W] -> logits [N, n_classes, H, W]."""
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return self.outc(x)

    def predict_nhwc(self, x):
        """x [N, H, W, C] -> logits [N, H, W, n_classes], the JAX module's layout."""
        return self(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def dice_coeff(pred, target, reduce_batch_first=False, epsilon=1e-6):
    """Dice coefficient over the last two axes (and the batch with reduce_batch_first)."""
    assert pred.shape == target.shape
    if pred.ndim == 2 or not reduce_batch_first:
        sum_dim = (-1, -2)
    else:
        sum_dim = (-1, -2, -3)
    inter = 2 * (pred * target).sum(dim=sum_dim)
    sets_sum = pred.sum(dim=sum_dim) + target.sum(dim=sum_dim)
    sets_sum = torch.where(sets_sum == 0, inter, sets_sum)
    return ((inter + epsilon) / (sets_sum + epsilon)).mean()


def dice_loss(pred, target, multiclass=False):
    if multiclass:
        pred = pred.reshape((-1,) + tuple(pred.shape[2:]))
        target = target.reshape((-1,) + tuple(target.shape[2:]))
    return 1 - dice_coeff(pred, target, reduce_batch_first=True)
