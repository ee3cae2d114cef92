"""Feature extractors of FID and precision/recall, on the device.

JAX counterpart: ``diffusion_uncertainty_tpu/metrics/features.py``. These are
plain convolutional networks that the JAX package runs through XLA (no
Pallas kernel), so the port runs them on cuDNN (``F.conv2d`` in
channels_last) and cuBLAS. Every extractor maps uint8 NHWC images
[N, H, W, 3] to float32 features [N, dim] on its device (the card unless the
caller asks for the CPU), and runs its float32 products with TF32 off,
scoped to its own calls, as the float32 JAX extractors compute.

* ``RandomConvFeatures``: a weight-free deterministic stand-in (two strided
  random convs, tanh, global mean). JAX draws its weights from threefry,
  which torch cannot reproduce: the constructor takes the two HWIO arrays
  (e.g. JAX's ``_w1``, ``_w2``) or draws its own from a seeded generator.
* ``InceptionV3`` / ``InceptionV3Features``: the pytorch-fid InceptionV3
  (inference batch norm with eps 1e-3, 3x3 average pools with
  ``count_include_pad=False``, a max-pool branch in ``Mixed_7c``, the
  2048-d global mean), loaded from the pytorch-fid state dict
  (``pt_inception-2015-12-05-6726825d.pth``) by its own keys. Images are
  resized to 299² as ``jax.image.resize(..., "bilinear")`` does: half-pixel
  bilinear, antialiased when it downsamples.
* ``VGG16`` / ``VGG16Features``: the torchvision VGG16 trunk and fc1/fc2
  (``vgg16-397923af.pth``), the improved-P&R embedding; images below 224
  are centre-padded with zeros, larger ones resized by nearest neighbour
  with half-pixel centres (JAX ``"nearest"``, torch ``nearest-exact``).

``random_state_dict`` gives architecture-true random weights in the
checkpoint's layout, for runs without the weight files.
"""

from __future__ import annotations

import contextlib
import math
from pathlib import Path
from typing import Any, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = [
    "RandomConvFeatures",
    "InceptionV3",
    "InceptionV3Features",
    "inception_input",
    "VGG16",
    "VGG16Features",
    "vgg16_input",
    "random_state_dict",
]


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and cuBLAS matmuls without TF32 inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _nchw(images_uint8, device: torch.device) -> torch.Tensor:
    """uint8 NHWC (tensor or array) -> float32 NCHW view (channels_last) on ``device``."""
    return torch.as_tensor(images_uint8, device=device).float().permute(0, 3, 1, 2)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA "SAME" padding of a k x k stride-s conv: the low side gets the
    smaller half when the total is odd."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RandomConvFeatures:
    """Deterministic random-projection features (the uint8 NHWC -> [N, dim]
    contract of the Inception extractor, no weight file)."""

    def __init__(self, dim: int = 256, seed: int = 0, w1=None, w2=None, device="cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        if w1 is None or w2 is None:
            gen = torch.Generator().manual_seed(seed)
            w1 = torch.randn((4, 4, 3, 64), generator=gen) / 12.0
            w2 = torch.randn((4, 4, 64, dim), generator=gen) / 48.0
        # HWIO -> OIHW
        self.w1 = torch.as_tensor(np.array(w1, np.float32)).permute(3, 2, 0, 1).contiguous().to(self.device)
        self.w2 = torch.as_tensor(np.array(w2, np.float32)).permute(3, 2, 0, 1).contiguous().to(self.device)

    @torch.no_grad()
    def __call__(self, images_uint8) -> torch.Tensor:
        with full_float32():
            x = _nchw(images_uint8, self.device) / 127.5 - 1.0
            x = torch.tanh(F.conv2d(_same_pad(x, 4, 2), self.w1, stride=2))
            x = F.conv2d(_same_pad(x, 4, 2), self.w2, stride=2)
            return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# InceptionV3 (pytorch-fid variant)
# ---------------------------------------------------------------------------


class BasicConv(nn.Module):
    """conv (no bias) + inference batch norm (eps 1e-3) + ReLU."""

    def __init__(self, c_in: int, out: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, out, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_no_pad(x):
    """3x3 stride-1 average over the valid taps only (count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(c_in, 64, 1)
        self.branch5x5_1 = BasicConv(c_in, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_no_pad(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(c_in, 192, 1)
        self.branch7x7_1 = BasicConv(c_in, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_no_pad(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(c_in, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool  # the FID variant's final block takes a max pool
        self.branch1x1 = BasicConv(c_in, 320, 1)
        self.branch3x3_1 = BasicConv(c_in, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avg_pool_no_pad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """The trunk to the 2048-d pooled features (no fc); NCHW input in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> [B, 2048]


def inception_input(x: torch.Tensor) -> torch.Tensor:
    """float32 NCHW images in [0, 255] -> [-1, 1] at 299², resized as
    ``jax.image.resize(..., "bilinear")``: half-pixel bilinear, antialiased
    when it downsamples."""
    x = x / 255.0
    h, w = x.shape[2:]
    if (h, w) != (299, 299):
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=h > 299 or w > 299)
    return 2.0 * x - 1.0


def _state_dict(weights: Union[str, Path, dict]) -> dict:
    """A checkpoint file (or the dict itself) as {key: tensor}."""
    sd = weights if isinstance(weights, dict) else torch.load(weights, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return sd


def _load(model: nn.Module, sd: dict, skip: tuple, what: str) -> None:
    """Strict load of ``sd`` less the keys that start with ``skip`` (heads the
    features do not use) and the batch-norm step counters."""
    sd = {k: v for k, v in sd.items() if not k.startswith(skip) and not k.endswith("num_batches_tracked")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{what} checkpoint: missing {missing[:8]}, unexpected {unexpected[:8]}")


class _Extractor:
    """uint8 NHWC -> float32 [N, dim] through ``prepare`` and ``model``."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, device):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = model.to(device=self.device, dtype=dtype, memory_format=torch.channels_last).eval()
        self.model.requires_grad_(False)

    @torch.no_grad()
    def __call__(self, images_uint8) -> torch.Tensor:
        with full_float32():
            return self.model(self.prepare(_nchw(images_uint8, self.device)).to(self.dtype)).float()


class InceptionV3Features(_Extractor):
    """uint8 NHWC [N,H,W,3] -> [N, 2048] pytorch-fid pooled features."""

    dim = 2048

    def __init__(self, weights: Union[str, Path, dict], dtype=torch.float32, device="cuda"):
        model = InceptionV3()
        _load(model, _state_dict(weights), ("fc.", "AuxLogits"), "InceptionV3")
        super().__init__(model, dtype, device)

    @staticmethod
    def prepare(x):
        return inception_input(x)


# ---------------------------------------------------------------------------
# VGG16 (improved-P&R protocol: vgg16 fc2 features)
# ---------------------------------------------------------------------------

_VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_VGG16_POOL_AFTER = frozenset({1, 3, 6, 9, 12})  # max pool after these convs (0-based)


class VGG16(nn.Module):
    """torchvision VGG16 trunk (``features.{i}``) and the classifier's fc1 and
    fc2 (``classifier.0``, ``classifier.3``): NCHW [B, 3, 224, 224] ->
    [B, 4096] fc2 features (dropout inert at inference)."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for i, ch in enumerate(_VGG16_CHANNELS):
            layers += [nn.Conv2d(c_in, ch, 3, padding=1), nn.ReLU()]
            if i in _VGG16_POOL_AFTER:
                layers.append(nn.MaxPool2d(2, 2))
            c_in = ch
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(), nn.Linear(4096, 4096))

    def forward(self, x):
        x = self.features(x).flatten(1)  # NCHW order: the fc1 weight layout
        return self.classifier(x)


def vgg16_input(x: torch.Tensor) -> torch.Tensor:
    """float32 NCHW images in [0, 255] -> [0, 1] at 224²: centre zero-padded
    below 224, nearest (half-pixel centres) above."""
    x = x / 255.0
    h, w = x.shape[2:]
    if h < 224 or w < 224:
        ph, pw = (224 - h) // 2, (224 - w) // 2
        return F.pad(x, (pw, 224 - w - pw, ph, 224 - h - ph))
    if (h, w) != (224, 224):
        return F.interpolate(x, size=(224, 224), mode="nearest-exact")
    return x


class VGG16Features(_Extractor):
    """uint8 NHWC [N,H,W,3] -> [N, 4096] improved-P&R features."""

    dim = 4096

    def __init__(self, weights: Union[str, Path, dict], dtype=torch.float32, device="cuda"):
        model = VGG16()
        _load(model, _state_dict(weights), ("classifier.6.",), "VGG16")
        super().__init__(model, dtype, device)

    @staticmethod
    def prepare(x):
        return vgg16_input(x)


def random_state_dict(arch: str, seed: int = 0) -> dict[str, Any]:
    """Architecture-true random weights in the checkpoint's layout
    (``"inception"``: pytorch-fid, ``"vgg16"``: torchvision), float32 on the
    CPU from a seeded generator: conv and linear weights N(0, 2/fan_in),
    biases N(0, 0.01²), batch-norm scales 1 + N(0, 0.1²), shifts and running
    means N(0, 0.1²), running variances 1 + |N(0, 0.1²)|."""
    with torch.device("meta"):
        model = {"inception": InceptionV3, "vgg16": VGG16}[arch]()
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, v in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        noise = torch.randn(v.shape, generator=gen)
        leaf = key.rsplit(".", 1)[1]
        if ".bn." in key:
            sd[key] = {"weight": 1.0 + 0.1 * noise, "running_var": 1.0 + 0.1 * noise.abs()}.get(leaf, 0.1 * noise)
        elif leaf == "weight":
            sd[key] = noise * math.sqrt(2.0 / (v[0].numel()))
        else:
            sd[key] = 0.01 * noise
    return sd
