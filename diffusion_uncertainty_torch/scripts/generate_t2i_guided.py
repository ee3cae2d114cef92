"""Text-to-image uncertainty-guided generation (Stable Diffusion 1.5), guided
against plain.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/generate_t2i_guided.py``
(``Config``, ``build_sd_stack``, ``main``). Runs the uncertainty-guided
pipeline on a prompt and saves ``output_sd_uc.png``, ``uncertainty.npz`` and
``args.yaml`` into a numbered folder, then (unless ``--skip-original true``)
the plain pipeline's ``output_sd.png`` beside it.

    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided --random-init true
    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided \\
        --unet-weights unet.pt --vae-weights vae.pt --prompt "a photo of a cat"

Models: ``sd15`` (the UNet in bfloat16 by default, the VAE decoder in
float32 as in the JAX CLI) and ``tiny`` (float32).
Weights: diffusers ``UNet2DConditionModel`` and CompVis KL-f8 state dicts
(``torch.load``), or ``--random-init true``: seeded N(0, 0.02) weights with
norm scales 1 and shifts 0, for the UNet and for a VAE, so the images have
their real size with no checkpoint (the JAX CLI decodes only with
``--vae-weights``). Conditioning: the CLIP text tower is not ported, so
prompts enter as ``pseudo_text_embeddings`` (stamped ``pseudo_text: true``
in ``args.yaml``), as in the JAX CLI without CLIP weights. Runs on the card
unless ``--device cpu``; raises without a card. Not ported yet: sd21,
sd3/flux, the safety checker and the streamed executor.
"""

from __future__ import annotations

import dataclasses
import struct
import time
import zlib
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule, make_schedule
from ..factory import init_normal_
from ..models import AutoencoderKL, AutoencoderKLConfig, SDUNet, SDUNetConfig
from ..utils import paths
from ..utils.config import parse_config, save_config
from ..utils.device import resolve_device

__all__ = ["Config", "SDStack", "build_sd_stack", "init_random_", "save_png", "main"]


@dataclasses.dataclass
class Config:
    """Uncertainty-guided text-to-image generation (Stable Diffusion 1.5)."""

    prompt: str = "a photo of a cat"
    prompt_negative: str = ""
    num_steps: int = 20
    seed: int = 491
    start_step_threshold: int = 0
    num_steps_threshold: int = 20
    percentile: float = 0.95
    skip_original: bool = False
    use_posterior: bool = False
    strength: float = 0.99  # the guidance's lr
    model: str = "sd15"  # sd15 | tiny
    guidance_scale: float = 7.5
    M: int = 5
    unet_weights: Optional[str] = None  # diffusers UNet state dict (torch file)
    vae_weights: Optional[str] = None  # CompVis / diffusers KL-VAE state dict
    random_init: bool = False
    dtype: str = "bfloat16"
    height: int = 512
    width: int = 512
    out_dir: Optional[str] = None
    device: str = "cuda"


class SDStack(NamedTuple):
    unet: SDUNet
    vae: Optional[AutoencoderKL]
    denoise_fn: Callable  # (z, t, embeds, noise) -> eps
    decode_fn: Optional[Callable]  # latents -> images in [-1, 1]
    schedule: NoiseSchedule
    latent_size: int
    mcfg: SDUNetConfig


# ROADMAP.md queue 1 items of the models this CLI does not run yet
_NOT_PORTED = {
    "sd21": "item 22 (sd21)",
    "sd3": "item 16 (SD3 MMDiT)",
    "sd3-tiny": "item 16 (SD3 MMDiT)",
    "sd35": "item 16 (SD3 MMDiT)",
    "flux": "item 16 (Flux)",
    "flux-tiny": "item 16 (Flux)",
}


def init_random_(module: torch.nn.Module, seed: int, std: float = 0.02) -> torch.nn.Module:
    """Seeded random weights in place: N(0, std) everywhere except the
    GroupNorm / LayerNorm scales (1) and shifts (0)."""
    return init_normal_(module, torch.Generator(device=next(module.parameters()).device).manual_seed(seed), std)


def _build(make: Callable[[], torch.nn.Module], weights: Optional[str], seed: int, device, dtype) -> torch.nn.Module:
    """``make()`` with the state dict in ``weights`` (or seeded random
    weights) on ``device`` in ``dtype``, 4-D weights channels_last, no
    autograd on the parameters."""
    with torch.device("meta"):
        module = make()
    if weights:
        module.load_state_dict(torch.load(weights, map_location="cpu"), assign=True)
    else:
        module = init_random_(module.to_empty(device=device), seed)
    module = module.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()
    return module.requires_grad_(False)


def build_sd_stack(cfg: Config, device=None) -> SDStack:
    """The UNet, the VAE (with ``--vae-weights``, ``--random-init`` or the
    tiny model), the scaled-linear schedule and the denoise / decode
    functions, on ``device`` (default ``cfg.device``: the card)."""
    if cfg.model in _NOT_PORTED:
        raise SystemExit(f"model {cfg.model!r} is not ported yet: ROADMAP.md queue 1, {_NOT_PORTED[cfg.model]}")
    if cfg.model not in ("sd15", "tiny"):
        raise SystemExit(f"unknown model {cfg.model!r}: sd15 | tiny")
    dev = resolve_device(cfg.device if device is None else device)
    tiny = cfg.model == "tiny"
    dtype = torch.float32 if tiny or cfg.dtype == "float32" else torch.bfloat16
    mcfg = SDUNetConfig.tiny() if tiny else SDUNetConfig.sd15()
    latent_size = mcfg.sample_size if tiny else cfg.height // 8
    if not (cfg.unet_weights or cfg.random_init):
        raise SystemExit("need --unet-weights or --random-init true")

    unet = _build(lambda: SDUNet(mcfg), cfg.unet_weights, 0, dev, dtype)
    vae = decode_fn = None
    if cfg.vae_weights or cfg.random_init or tiny:
        acfg = AutoencoderKLConfig.tiny() if tiny else AutoencoderKLConfig.sd_kl_ema()
        # float32 whatever ``cfg.dtype``: the JAX CLI decodes with the VAE's
        # default (float32) dtype
        vae = _build(lambda: AutoencoderKL(acfg), cfg.vae_weights, 1, dev, torch.float32)
        decode_fn = vae.decode

    # SD trains on the scaled-linear schedule
    schedule = make_schedule("scaled_linear", 1000, beta_start=0.00085, beta_end=0.012, device=dev)

    def denoise_fn(z, t, embeds, noise):
        return unet(z, t, embeds)

    return SDStack(unet, vae, denoise_fn, decode_fn, schedule, latent_size, mcfg)


def _png_bytes(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG file bytes (zlib, no filter)."""
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def save_png(path, images) -> None:
    """[B, H, W, 3] float in [-1, 1] -> one PNG, the images side by side."""
    arr = np.clip(np.asarray(images, np.float32) / 2.0 + 0.5, 0.0, 1.0)
    arr = (arr * 255.0).astype(np.uint8)
    Path(path).write_bytes(_png_bytes(np.ascontiguousarray(np.concatenate(list(arr), axis=1))))


def _numbered_dir(base: Path) -> Path:
    i = 0
    while (base / f"{i}").exists():
        i += 1
    dest = base / f"{i}"
    dest.mkdir()
    return dest


def main(argv=None) -> int:
    from ..pipelines.text_encoder import pseudo_text_embeddings
    from ..pipelines.text_to_image import T2IPipelineConfig, TextToImageUncertaintyPipeline
    from ..utils.rng import TorchNoise

    cfg = parse_config(Config, argv)
    stack = build_sd_stack(cfg)
    dev = stack.schedule.device
    mcfg = stack.mcfg
    seq_len = 5 if cfg.model == "tiny" else 77
    cond, uncond = (
        torch.from_numpy(pseudo_text_embeddings([p], seq_len=seq_len, dim=mcfg.cross_attention_dim)).to(dev)
        for p in (cfg.prompt, cfg.prompt_negative)
    )
    print("pseudo text conditioning: prompts enter as hash-seeded Gaussian embeddings (no CLIP tower in this package)")

    pcfg = T2IPipelineConfig(
        num_inference_steps=cfg.num_steps,
        guidance_scale=cfg.guidance_scale,
        start_step_uc=cfg.start_step_threshold,
        num_steps_uc=cfg.num_steps_threshold,
        percentile=cfg.percentile,
        use_posterior=cfg.use_posterior,
        lr=cfg.strength,
        M=cfg.M,
        latent_channels=mcfg.in_channels,
        latent_size=stack.latent_size,
    )
    base = paths.ensure(paths.sd_uncertainty_guidance() if cfg.out_dir is None else Path(cfg.out_dir))
    dest = _numbered_dir(base)
    save_config(cfg, dest / "args.yaml", pseudo_text=True)

    t0 = time.perf_counter()
    pipe = TextToImageUncertaintyPipeline(stack.denoise_fn, stack.schedule, stack.decode_fn, pcfg)
    res = pipe(cond, TorchNoise(cfg.seed, dev), uncond_embeds=uncond)
    images = res.images.float().cpu().numpy()
    print(f"guided sampling: {time.perf_counter() - t0:.2f} s for {cfg.num_steps} steps on {dev}")
    save_png(dest / "output_sd_uc.png", images)
    if res.uncertainty is not None:
        np.savez(dest / "uncertainty.npz", data=res.uncertainty.cpu().numpy())

    if not cfg.skip_original:
        plain = TextToImageUncertaintyPipeline(
            stack.denoise_fn, stack.schedule, stack.decode_fn, dataclasses.replace(pcfg, num_steps_uc=0)
        )
        res0 = plain(cond, TorchNoise(cfg.seed, dev), uncond_embeds=uncond)
        save_png(dest / "output_sd.png", res0.images.float().cpu().numpy())
    print(f"Saved to {dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
