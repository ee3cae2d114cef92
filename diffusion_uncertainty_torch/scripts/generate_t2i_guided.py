"""Text-to-image uncertainty-guided generation, guided against plain: Stable
Diffusion 1.5 on the DDIM pipeline, SD3 / SD3.5 (MMDiT) and Flux on the
flow-matching sampler.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/generate_t2i_guided.py``
(``Config``, ``build_sd_stack``, ``run_flow_match_family``, ``main``). Runs
the uncertainty-guided sampler on a prompt and saves the guided image,
``uncertainty.npz`` (key ``data``) and ``args.yaml`` into a numbered folder,
then (unless ``--skip-original true``) the plain run's image beside it:
``output_sd_uc.png`` / ``output_sd.png`` for SD 1.5; for SD3 and Flux
``output_sd3_uc.png`` / ``output_flux_uc.png`` (and the plain ones) when a
VAE decodes (``--vae-weights``), else ``output_latent_preview_sd3_uc.png``
etc., the first three latent channels.

    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided --random-init true
    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided --model flux --random-init true
    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided \\
        --unet-weights unet.pt --vae-weights vae.pt --prompt "a photo of a cat"

Models: ``sd15`` (the UNet in bfloat16 by default, the VAE decoder in
float32 as in the JAX CLI) and ``tiny`` (float32); ``sd3`` (SD3-medium,
2.0B), ``sd35`` (SD3.5-large, 8.1B) and ``flux`` (Flux-dev, 11.9B) in
bfloat16 by default, with the 16-channel VAE decoder in float32, and
``sd3-tiny`` / ``flux-tiny`` (float32). SD3 runs classifier-free guidance as
one concatenated batch; Flux takes ``guidance_scale·1000`` through its
guidance embedding. The flow-matching runs use shift 3 (dynamic shifting for
Flux) and the folded ensemble (``diffusion.flow_match.sample_flow_match``).
Weights: diffusers / CompVis state dicts (``torch.load``), or
``--random-init true``: seeded N(0, 0.02) weights with norm scales 1 and
shifts 0, drawn in the run type on the target device (for SD 1.5 a VAE too,
so its images have their real size with no checkpoint; the JAX CLI decodes
only with ``--vae-weights``). Conditioning: the CLIP / T5 text towers are not
ported, so prompts enter as ``pseudo_text_embeddings`` (stamped
``pseudo_text: true`` in ``args.yaml``), as in the JAX CLI without text
weights. Runs on the card unless ``--device cpu``; raises without a card.
Not ported yet, each exiting with its ROADMAP.md item: sd21, the real text
towers (``--text-towers small|full``), the streamed executor
(``--streamed true``) and the safety checker.
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

from ..diffusion.flow_match import FlowMatchConfig, sample_flow_match
from ..diffusion.schedule import NoiseSchedule, make_schedule
from ..factory import init_normal_
from ..models import (
    AutoencoderKL, AutoencoderKLConfig, FluxConfig, FluxTransformer, MMDiT, MMDiTConfig, SDUNet, SDUNetConfig,
)
from ..utils import paths
from ..utils.config import parse_config, save_config
from ..utils.device import resolve_device

__all__ = [
    "Config", "SDStack", "FlowStack", "build_sd_stack", "build_flow_stack", "run_flow_match_family", "init_random_",
    "save_png", "main",
]


@dataclasses.dataclass
class Config:
    """Uncertainty-guided text-to-image generation."""

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
    model: str = "sd15"  # sd15 | tiny | sd3 | sd3-tiny | sd35 | flux | flux-tiny
    streamed: bool = False  # the JAX streamed executor (not ported)
    guidance_scale: float = 7.5
    M: int = 5
    unet_weights: Optional[str] = None  # diffusers UNet state dict (torch file)
    vae_weights: Optional[str] = None  # CompVis / diffusers KL-VAE state dict
    # SD3 / Flux conditioning: "pseudo" (hash-seeded embeddings); the real
    # towers "small" / "full" are not ported
    text_towers: str = "pseudo"
    towers_params_dir: Optional[str] = None  # converted tower checkpoints (with the towers)
    tower_seq_len: int = 77  # per-tower token length (with the towers)
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
_NOT_PORTED = {"sd21": "item 22 (sd21)"}
FLOW_MODELS = ("sd3", "sd3-tiny", "sd35", "flux", "flux-tiny")
PSEUDO_TEXT_LEN = 16  # tokens of the SD3 / Flux pseudo context (the JAX CLI's)


def _not_ported(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not ported yet: ROADMAP.md queue 1, {item}")


def init_random_(module: torch.nn.Module, seed: int, std: float = 0.02) -> torch.nn.Module:
    """Seeded random weights in place: N(0, std) everywhere except the
    GroupNorm / LayerNorm / RMS q/k-norm scales (1) and shifts (0)."""
    return init_normal_(module, torch.Generator(device=next(module.parameters()).device).manual_seed(seed), std)


def _build(make: Callable[[], torch.nn.Module], weights: Optional[str], seed: int, device, dtype) -> torch.nn.Module:
    """``make()`` with the state dict in ``weights`` (or seeded random
    weights drawn in ``dtype`` on ``device``) on ``device`` in ``dtype``, 4-D
    weights channels_last, no autograd on the parameters. The module is cast
    while it is on the meta device, so random weights are allocated once, in
    ``dtype``."""
    with torch.device("meta"):
        module = make().to(dtype)
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
        raise _not_ported(f"model {cfg.model!r}", _NOT_PORTED[cfg.model])
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


class FlowStack(NamedTuple):
    model: torch.nn.Module  # MMDiT or FluxTransformer
    velocity_fn: Callable  # (x, t) -> v, the CLI's conditioning and guidance bound
    decode_fn: Optional[Callable]  # latents -> images in [-1, 1], with --vae-weights
    latent_size: int
    mcfg: object  # MMDiTConfig or FluxConfig
    is_flux: bool


def build_flow_stack(cfg: Config, device=None) -> FlowStack:
    """The SD3 / SD3.5 / Flux transformer, its velocity function with the
    CLI's pseudo text conditioning (classifier-free guidance as one
    concatenated batch for MMDiT, ``guidance_scale·1000`` as Flux's guidance
    embedding) and, with ``--vae-weights``, the 16-channel VAE decoder, on
    ``device`` (default ``cfg.device``: the card)."""
    from ..pipelines.text_encoder import pseudo_text_embeddings

    if cfg.model not in FLOW_MODELS:
        raise SystemExit(f"unknown flow-matching model {cfg.model!r}: {' | '.join(FLOW_MODELS)}")
    is_flux, tiny = cfg.model.startswith("flux"), cfg.model.endswith("tiny")
    if cfg.text_towers not in ("pseudo", "small", "full"):
        raise SystemExit(f"unknown --text-towers {cfg.text_towers!r}: pseudo | small | full")
    if (cfg.text_towers != "pseudo" and not tiny) or cfg.towers_params_dir:
        raise _not_ported(f"--text-towers {cfg.text_towers} (the CLIP / T5 text towers)", "item 20")
    if tiny and cfg.text_towers != "pseudo":
        print("tiny model configs have non-standard conditioning dims; falling back to pseudo embeddings")
    dev = resolve_device(cfg.device if device is None else device)
    dtype = torch.float32 if tiny or cfg.dtype == "float32" else torch.bfloat16
    if is_flux:
        mcfg = FluxConfig.tiny() if tiny else FluxConfig.flux_dev()
        make, latent_size = (lambda: FluxTransformer(mcfg)), 8 if tiny else cfg.height // 8
    else:
        mcfg = MMDiTConfig.tiny() if tiny else MMDiTConfig.sd35_large() if cfg.model == "sd35" else MMDiTConfig.sd3_medium()
        make, latent_size = (lambda: MMDiT(mcfg)), mcfg.sample_size if tiny else cfg.height // 8
    if not (cfg.unet_weights or cfg.random_init or tiny):
        raise SystemExit("need --unet-weights or --random-init true")
    model = _build(make, cfg.unet_weights, 0, dev, dtype)

    def embed(prompt: str, seq_len: int, dim: int) -> torch.Tensor:
        return torch.from_numpy(pseudo_text_embeddings([prompt], seq_len=seq_len, dim=dim)).to(dev)

    ctx, uncond_ctx = (embed(p, PSEUDO_TEXT_LEN, mcfg.joint_attention_dim) for p in (cfg.prompt, cfg.prompt_negative))
    pooled, uncond_pooled = (embed(p, 1, mcfg.pooled_projection_dim)[:, 0] for p in (cfg.prompt, cfg.prompt_negative))
    scale = cfg.guidance_scale
    flux_guidance = scale * 1000.0 if is_flux and mcfg.guidance_embeds else None

    def velocity_fn(x, t):
        # x's batch is the prompts' times the ensemble members folded into it
        n = x.shape[0] // ctx.shape[0]
        c, p = ctx.repeat(n, 1, 1), pooled.repeat(n, 1)
        if is_flux:
            return model(x, t, c, p, flux_guidance)
        if scale <= 1.0:
            return model(x, t, c, p)
        c2 = torch.cat([uncond_ctx.repeat(n, 1, 1), c])
        p2 = torch.cat([uncond_pooled.repeat(n, 1), p])
        vu, vc = model(torch.cat([x, x]), t, c2, p2).chunk(2)
        return vu + scale * (vc - vu)

    decode_fn = None
    if cfg.vae_weights and not tiny:
        acfg = AutoencoderKLConfig.flux_kl() if is_flux else AutoencoderKLConfig.sd3_kl()
        # float32 whatever ``cfg.dtype``, as the JAX CLI decodes
        decode_fn = _build(lambda: AutoencoderKL(acfg), cfg.vae_weights, 1, dev, torch.float32).decode
    return FlowStack(model, velocity_fn, decode_fn, latent_size, mcfg, is_flux)


def run_flow_match_family(cfg: Config) -> int:
    """SD3 (MMDiT) / Flux on the flow-matching sampler: the guided run, then
    (unless ``--skip-original``) the plain run from the same x_T, into a
    numbered folder with ``args.yaml``."""
    from ..utils.rng import TorchNoise

    stack = build_flow_stack(cfg)
    dev = next(stack.model.parameters()).device
    print("pseudo text conditioning: prompts enter as hash-seeded Gaussian embeddings (no CLIP / T5 towers in this package)")
    fm = FlowMatchConfig(
        num_inference_steps=cfg.num_steps,
        shift=3.0,
        # Flux: the dynamic shift keyed on the 2x2-packed token count
        use_dynamic_shifting=stack.is_flux,
        image_seq_len=(stack.latent_size // 2) ** 2 if stack.is_flux else 0,
        after_step=cfg.start_step_threshold,
        num_steps_uc=cfg.num_steps_threshold,
        M=cfg.M,
        percentile=cfg.percentile,
        use_posterior=cfg.use_posterior,
        lr=cfg.strength,
    )
    base_dir = paths.flux_uncertainty_guidance() if stack.is_flux else paths.sd3_uncertainty_guidance()
    dest = _numbered_dir(paths.ensure(base_dir if cfg.out_dir is None else Path(cfg.out_dir)))
    save_config(cfg, dest / "args.yaml", pseudo_text=True, pseudo_tokens=False)

    def to_png(sample: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            out = stack.decode_fn(sample) if stack.decode_fn is not None else sample[..., :3]
        return out.float().cpu().numpy()

    stem = "flux" if stack.is_flux else "sd3"
    img_stem = stem if stack.decode_fn is not None else f"latent_preview_{stem}"
    noise = TorchNoise(cfg.seed, dev)
    x_T = noise.normal((1, stack.latent_size, stack.latent_size, stack.mcfg.in_channels))
    t0 = time.perf_counter()
    res = sample_flow_match(stack.velocity_fn, x_T, noise, fm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_fwd = cfg.num_steps + min(cfg.num_steps_threshold, cfg.num_steps) * cfg.M
    print(f"guided sampling: {time.perf_counter() - t0:.2f} s for {cfg.num_steps} steps (~{n_fwd} forwards) on {dev}")
    save_png(dest / f"output_{img_stem}_uc.png", to_png(res.sample))
    if res.uncertainty is not None:
        np.savez(dest / "uncertainty.npz", data=res.uncertainty.cpu().numpy())
    if not cfg.skip_original:
        plain = sample_flow_match(stack.velocity_fn, x_T, noise, dataclasses.replace(fm, num_steps_uc=0))
        save_png(dest / f"output_{img_stem}.png", to_png(plain.sample))
    print(f"Saved to {dest}")
    return 0


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
    if cfg.streamed:
        raise _not_ported("--streamed true (the streamed executor, pipelines/streamed.py)", "item 16")
    if cfg.model in FLOW_MODELS:
        return run_flow_match_family(cfg)
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
