"""Model and schedule factory of the dataset-generation CLI.

JAX counterpart: ``diffusion_uncertainty_tpu/factory.py`` (``ModelBundle``,
``init_scheduler``, ``instantiate_model_scheduler``). The same hard-coded
settings per dataset:

  imagenet64  ADM-64, cosine schedule, dropout ``dropout or 0.1``
  imagenet128 ADM-128, linear schedule (1e-4, 0.02), dropout ``dropout``
  cifar10     diffusers UNet2DModel (google/ddpm-cifar10-32) with the dropout
              override, linear schedule (1e-4, 0.02)
  tiny        the small ADM test configuration, linear schedule

A checkpoint is a reference torch state dict (``torch.load``), read as it
is: the port's modules use the reference's key layout. With
``random_init=True`` every parameter is N(0, 0.02²) from a
``torch.Generator`` seeded with 0 on the target device (the JAX factory's
``0.02 * normal`` random init from key 0): architecture-true weights with no
checkpoint. ``winograd=True`` builds the model with its Winograd route on
(the JAX package's ``DU_TPU_WINOGRAD=1``; the CLI reads that variable).
The U-ViT datasets (imagenet256, imagenet512) are not ported.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from .diffusion.schedule import NoiseSchedule, cosine_schedule, make_schedule
from .models import ADMUNet, ADMUNetConfig, UNet2D, UNet2DConfig
from .utils import paths
from .utils.device import resolve_device

__all__ = ["ModelBundle", "DATASET_IMAGE_SIZE", "instantiate_model_scheduler", "init_scheduler"]

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
    "cifar10": "ddpm-cifar10-32.bin",
}

# datasets of the JAX factory that the port does not run yet
_NOT_PORTED = {
    "imagenet256": "ROADMAP.md queue 1 item 13 (U-ViT)",
    "imagenet512": "ROADMAP.md queue 1 item 13 (U-ViT)",
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
    # from it
    apply_fn: Callable
    apply_fn_dropout: Callable
    sample_shape: tuple  # (H, W, C) the sampler operates on


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
    if dataset in _NOT_PORTED:
        raise NotImplementedError(f"dataset {dataset!r} is not ported yet: {_NOT_PORTED[dataset]}")
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
    elif ckpt.is_file():
        sd = torch.load(ckpt, map_location="cpu")
        if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
        model.load_state_dict(sd, assign=True)
    else:
        raise FileNotFoundError(
            f"checkpoint {ckpt} not found: pass its path, or random_init=True for architecture-true random weights"
        )
    model = model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval().requires_grad_(False)

    num_classes = getattr(cfg, "num_classes", None)

    def apply_fn(x, t, y, noise):
        return model(x, t, y if num_classes else None)[..., :3]  # learned-variance channels sliced off

    def apply_fn_dropout(x, t, y, noise):
        return model(x, t, y if num_classes else None, noise=noise)[..., :3]

    size = DATASET_IMAGE_SIZE[dataset]
    return ModelBundle(
        name=dataset,
        model=model,
        schedule=schedule,
        image_size=size,
        num_classes=num_classes,
        apply_fn=apply_fn,
        apply_fn_dropout=apply_fn_dropout,
        sample_shape=(size, size, 3),
    )
