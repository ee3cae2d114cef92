"""Model and schedule factory of the dataset-generation CLI.

JAX counterpart: ``diffusion_uncertainty_tpu/factory.py`` (``ModelBundle``,
``init_scheduler``, ``instantiate_model_scheduler``, ``load_classifier``).
The same hard-coded settings per dataset:

  imagenet64  ADM-64, cosine schedule, dropout ``dropout or 0.1``
  imagenet128 ADM-128, linear schedule (1e-4, 0.02), dropout ``dropout``
  cifar10     diffusers UNet2DModel (google/ddpm-cifar10-32) with the dropout
              override, linear schedule (1e-4, 0.02)
  tiny        the small ADM test configuration, linear schedule
  imagenet256 U-ViT-huge/2 on 32x32x4 latents + the SD KL-f8 VAE decoder,
  imagenet512 U-ViT-huge/4 on 64x64x4 latents + the same decoder; both on
              the scaled-linear schedule (0.00085, 0.012), the VAE in the
              bundle's type (JAX ``_instantiate_uvit``, :208-266)

A checkpoint is a reference torch state dict (``torch.load``), read as it
is: the port's modules use the reference's key layout. With
``random_init=True`` every parameter is N(0, 0.02²) from a
``torch.Generator`` seeded with 0 on the target device (the JAX factory's
``0.02 * normal`` random init from key 0): architecture-true weights with no
checkpoint. For the U-ViT datasets one generator seeds U-ViT and then the
VAE, N(0, 0.02²) with LayerNorm and GroupNorm scales at 1 and shifts at 0
(the JAX factory's constant ``0.02 * ones`` VAE decodes to flat images).
``winograd=True`` builds the model with its Winograd route on (the JAX
package's ``DU_TPU_WINOGRAD=1``; the CLI reads that variable).

``load_classifier`` builds the noisy ADM classifier of classifier guidance
(``ADMClassifierConfig.imagenet`` at the dataset's size) in float32 by
default, as JAX, from ``64x64_classifier.pt`` / ``128x128_classifier.pt``;
its random init is ``init_normal_`` from a generator seeded with 0 (norm
scales 1, shifts 0; the JAX factory draws every leaf, norms included, as
``0.02 * normal``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from .diffusion.schedule import NoiseSchedule, cosine_schedule, make_schedule
from .models import (
    ADMClassifier, ADMClassifierConfig, ADMUNet, ADMUNetConfig, AutoencoderKL, AutoencoderKLConfig, UNet2D, UNet2DConfig,
    UViT, UViTConfig,
)
from .models.layers import GroupNorm32
from .models.mmdit import _QKNorm
from .utils import paths
from .utils.device import resolve_device

__all__ = [
    "ModelBundle", "DATASET_IMAGE_SIZE", "instantiate_model_scheduler", "init_scheduler", "init_normal_", "load_classifier",
]

DATASET_IMAGE_SIZE = {
    "imagenet64": 64,
    "imagenet128": 128,
    "imagenet256": 256,
    "imagenet512": 512,
    "cifar10": 32,
    "lsun_churches256": 256,
    "tiny": 16,
}

_CHECKPOINTS = {
    "imagenet64": "64x64_diffusion.pt",
    "imagenet128": "128x128_diffusion.pt",
    "imagenet64_classifier": "64x64_classifier.pt",
    "imagenet128_classifier": "128x128_classifier.pt",
    "cifar10": "ddpm-cifar10-32.bin",
    "imagenet256": "imagenet256_uvit_huge.pth",
    "imagenet512": "imagenet512_uvit_huge.pth",
    "autoencoder": "autoencoder_kl_ema.pth",
}


@dataclasses.dataclass
class ModelBundle:
    name: str
    model: torch.nn.Module
    schedule: NoiseSchedule
    image_size: int
    num_classes: Optional[int]
    # conditioned forwards: (x, t, y, noise) -> epsilon [B, H, W, 3]; the
    # deterministic one ignores ``noise``, the dropout one draws its masks
    # from it, the activation-noise one (ADM; the others' plain forward, as
    # JAX) its site noise
    apply_fn: Callable
    apply_fn_dropout: Callable
    apply_fn_act_noise: Callable
    sample_shape: tuple  # (H, W, C) the sampler operates on
    # latent models: final latents [B, h, w, C] -> images [B, H, W, 3] float32
    decode_fn: Optional[Callable] = None


def init_scheduler(dataset: str, device="cuda") -> NoiseSchedule:
    """The dataset's noise schedule (JAX ``init_scheduler``)."""
    if dataset == "tiny":
        return make_schedule("linear", 1000, device=device)
    if dataset.startswith("imagenet64"):
        return make_schedule(trained_betas=cosine_schedule(1000), device=device)
    if dataset.startswith("imagenet128") or dataset in ("cifar10", "lsun_churches256"):
        return make_schedule("linear", 1000, 0.0001, 0.02, device=device)
    if dataset in ("imagenet256", "imagenet512"):
        return make_schedule("scaled_linear", 1000, 0.00085, 0.012, device=device)
    raise ValueError(f"unknown dataset: {dataset}")


def _model_config(dataset: str, dropout: float, winograd: bool):
    if dataset == "imagenet64":
        return ADMUNet, dataclasses.replace(ADMUNetConfig.imagenet64(dropout=dropout or 0.1), winograd=winograd)
    if dataset == "imagenet128":
        return ADMUNet, dataclasses.replace(ADMUNetConfig.imagenet128(), dropout=dropout, winograd=winograd)
    if dataset == "cifar10":
        return UNet2D, dataclasses.replace(UNet2DConfig.ddpm_cifar10(dropout=dropout), winograd=winograd)
    if dataset == "tiny":
        return ADMUNet, dataclasses.replace(ADMUNetConfig.tiny(), dropout=dropout or 0.1, winograd=winograd)
    raise ValueError(f"unsupported dataset: {dataset!r}")


def instantiate_model_scheduler(
    dataset: str,
    dropout: float = 0.0,
    dtype: torch.dtype = torch.bfloat16,
    checkpoint: Optional[Path] = None,
    random_init: bool = False,
    models_dir: Optional[Path] = None,
    device: Any = "cuda",
    winograd: bool = False,
) -> ModelBundle:
    """The dataset's model (on ``device``, in ``dtype``, eval mode, no
    autograd on the parameters, 4-D weights channels_last), its schedule and
    its conditioned forwards (JAX ``instantiate_model_scheduler``)."""
    dev = resolve_device(device)
    if dataset in ("imagenet256", "imagenet512"):
        return _instantiate_uvit(dataset, dtype, checkpoint, random_init, models_dir, dev)
    model_cls, cfg = _model_config(dataset, dropout, winograd)
    schedule = init_scheduler(dataset, device=dev)
    ckpt = Path(checkpoint) if checkpoint else Path(models_dir or paths.models_dir()) / _CHECKPOINTS.get(dataset, "")
    with torch.device("meta"):
        model = model_cls(cfg)
    if random_init:
        model = model.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0.0, 0.02, generator=gen)
    else:
        _load(model, ckpt)
    model = model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval().requires_grad_(False)

    num_classes = getattr(cfg, "num_classes", None)

    def apply_fn(x, t, y, noise):
        return model(x, t, y if num_classes else None)[..., :3]  # learned-variance channels sliced off

    def apply_fn_dropout(x, t, y, noise):
        return model(x, t, y if num_classes else None, noise=noise)[..., :3]

    def apply_fn_act_noise(x, t, y, noise):
        return model(x, t, y if num_classes else None, act_noise=noise)[..., :3]

    size = DATASET_IMAGE_SIZE[dataset]
    return ModelBundle(
        name=dataset,
        model=model,
        schedule=schedule,
        image_size=size,
        num_classes=num_classes,
        apply_fn=apply_fn,
        apply_fn_dropout=apply_fn_dropout,
        # the CIFAR-10 UNet has no activation-noise sites (JAX ``UNet2D``)
        apply_fn_act_noise=apply_fn_act_noise if model_cls is ADMUNet else apply_fn,
        sample_shape=(size, size, 3),
    )


def _load(module: torch.nn.Module, ckpt: Path) -> None:
    """A reference state dict from ``ckpt`` into a meta-device module."""
    if not ckpt.is_file():
        raise FileNotFoundError(
            f"checkpoint {ckpt} not found: pass its path, or random_init=True for architecture-true random weights"
        )
    sd = torch.load(ckpt, map_location="cpu")
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    module.load_state_dict(sd, assign=True)


def init_normal_(module: torch.nn.Module, gen: torch.Generator, std: float = 0.02) -> torch.nn.Module:
    """Seeded random weights in place: N(0, std²) from ``gen`` in parameter
    order, LayerNorm, GroupNorm and RMS q/k-norm scales 1 and shifts 0."""
    norms = {n for n, m in module.named_modules() if isinstance(m, (torch.nn.LayerNorm, GroupNorm32, _QKNorm))}
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner, _, leaf = name.rpartition(".")
            if owner in norms:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            else:
                p.normal_(0.0, std, generator=gen)
    return module


def _instantiate_uvit(dataset, dtype, checkpoint, random_init, models_dir, dev) -> ModelBundle:
    """Latent U-ViT-huge and the KL-VAE decoder, both in ``dtype`` (JAX
    ``_instantiate_uvit``; the reference ``UViTAE``). The forwards are the
    plain U-ViT (4 latent channels, no dropout at inference and no
    activation-noise sites, so the dropout and activation-noise forwards are
    the same function, as JAX); ``decode_fn`` maps final latents to
    images."""
    size = DATASET_IMAGE_SIZE[dataset]
    cfg = UViTConfig.imagenet256() if size == 256 else UViTConfig.imagenet512()
    models_dir = Path(models_dir or paths.models_dir())
    with torch.device("meta"):
        model, ae = UViT(cfg), AutoencoderKL(AutoencoderKLConfig.sd_kl_ema())
    if random_init:
        model, ae = model.to_empty(device=dev), ae.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        init_normal_(model, gen)
        init_normal_(ae, gen)
    else:
        _load(model, Path(checkpoint) if checkpoint else models_dir / _CHECKPOINTS[dataset])
        _load(ae, models_dir / _CHECKPOINTS["autoencoder"])
    model, ae = (m.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval().requires_grad_(False)
                 for m in (model, ae))

    def apply_fn(x, t, y, noise):
        return model(x, t, y)

    return ModelBundle(
        name=dataset,
        model=model,
        schedule=init_scheduler(dataset, device=dev),
        image_size=size,
        num_classes=cfg.num_classes,
        apply_fn=apply_fn,
        apply_fn_dropout=apply_fn,
        apply_fn_act_noise=apply_fn,
        sample_shape=(cfg.img_size, cfg.img_size, cfg.in_chans),
        decode_fn=ae.decode,
    )


def load_classifier(
    dataset: str,
    dtype: torch.dtype = torch.float32,
    checkpoint: Optional[Path] = None,
    random_init: bool = False,
    models_dir: Optional[Path] = None,
    device: Any = "cuda",
) -> ADMClassifier:
    """The dataset's noisy ADM classifier (JAX ``load_classifier``) on
    ``device``, in ``dtype``, eval mode, 4-D weights channels_last, no
    autograd on the parameters (the guidance differentiates in x only)."""
    dev = resolve_device(device)
    cfg = ADMClassifierConfig.imagenet(DATASET_IMAGE_SIZE[dataset])
    with torch.device("meta"):
        model = ADMClassifier(cfg)
    if random_init:
        model = init_normal_(model.to_empty(device=dev), torch.Generator(device=dev).manual_seed(0))
    else:
        models_dir = Path(models_dir or paths.models_dir())
        _load(model, Path(checkpoint) if checkpoint else models_dir / _CHECKPOINTS.get(f"{dataset}_classifier", ""))
    return model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval().requires_grad_(False)
