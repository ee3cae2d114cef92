"""Text-to-image uncertainty-guided generation, guided against plain: Stable
Diffusion 1.5 and 2.1 on the DDIM pipeline, SD3 / SD3.5 (MMDiT) and Flux on
the flow-matching sampler.

JAX counterpart: ``diffusion_uncertainty_tpu/scripts/generate_t2i_guided.py``
(``Config``, ``build_sd_stack``, ``run_flow_match_family``, ``main``). Runs
the uncertainty-guided sampler on a prompt and saves the guided image,
``uncertainty.npz`` (key ``data``) and ``args.yaml`` into a numbered folder,
then (unless ``--skip-original true``) the plain run's image beside it:
``output_sd_uc.png`` / ``output_sd.png`` for SD 1.5 / 2.1 (the decoded
image with ``--vae-weights`` or the tiny model, else the latent grid, an RGBA
PNG of the 4 latent channels); for SD3 and Flux ``output_sd3_uc.png`` /
``output_flux_uc.png`` (and the plain ones) when a VAE decodes
(``--vae-weights``), else ``output_latent_preview_sd3_uc.png`` etc., the
first three latent channels.

    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided --random-init true
    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided --model sd21 --random-init true
    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided --model flux --random-init true --text-towers full
    python -m diffusion_uncertainty_torch.scripts.generate_t2i_guided \\
        --unet-weights unet.pt --vae-weights vae.pt --safety-checker-weights checker.pt --prompt "a photo of a cat"

Models: ``sd15``, ``sd21`` (stable-diffusion-2-1-base: 512 px, epsilon
prediction, the scaled-linear schedule; each UNet in bfloat16 by default,
the VAE decoder in float32 as in the JAX CLI) and ``tiny`` (float32);
``sd3`` (SD3-medium, 2.0B), ``sd35`` (SD3.5-large, 8.1B) and ``flux``
(Flux-dev, 11.9B) in bfloat16 by default, with the 16-channel VAE decoder in
float32, and ``sd3-tiny`` / ``flux-tiny`` (float32). SD3 runs
classifier-free guidance as one concatenated batch; Flux takes
``guidance_scale·1000`` through its guidance embedding. The flow-matching
runs use shift 3 (dynamic shifting for Flux) and the folded ensemble
(``diffusion.flow_match.sample_flow_match``). Weights: diffusers / CompVis
state dicts (``torch.load``), or ``--random-init true``: seeded N(0, 0.02)
weights with norm scales 1 and shifts 0, drawn in the run type on the target
device. Conditioning, as in the JAX CLI: SD 1.x encodes with the CLIP text
tower where a tokenizer and weights are on disk (``--clip-path``), else
with ``pseudo_text_embeddings`` (77 x 768); where that width is not the
UNet's context width (SD 2.1's 1024, the tiny model's 16) the prompts enter
as 5-token pseudo embeddings of the UNet's width. SD3 / Flux take
``--text-towers``: ``pseudo`` (16 hash-seeded tokens), ``small`` or ``full``
(``pipelines.text_encoder.T2ITowers``: CLIP-L, CLIP-bigG and T5-XXL in
float32, seeded random weights or ``--towers-params-dir``; 77 CLIP and
``--tower-seq-len`` T5 tokens), encoded before the transformer is built and
freed after; ``args.yaml`` stamps ``pseudo_text`` and ``pseudo_tokens``.
``--safety-checker-weights`` (SD 1.x) runs the safety checker after each
decode, blacks out flagged images and appends ``nsfw_flags.yaml``. Runs on
the card unless ``--device cpu``; raises without a card. The streamed
executor (``--streamed true``) is not ported and exits naming its
ROADMAP.md item.
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
    model: str = "sd15"  # sd15 | sd21 | tiny | sd3 | sd3-tiny | sd35 | flux | flux-tiny
    streamed: bool = False  # the JAX streamed executor (not ported)
    guidance_scale: float = 7.5
    M: int = 5
    unet_weights: Optional[str] = None  # diffusers UNet state dict (torch file)
    vae_weights: Optional[str] = None  # CompVis / diffusers KL-VAE state dict
    # diffusers StableDiffusionSafetyChecker weights (file or folder), run
    # after each SD 1.x decode; None: no checker
    safety_checker_weights: Optional[str] = None
    clip_path: Optional[str] = None  # a local CLIP tokenizer (and, for SD 1.x, text model) folder
    # SD3 / Flux conditioning: "pseudo" (hash-seeded embeddings), "small"
    # (the real widths at depth 2) or "full" (CLIP-L, CLIP-bigG, T5-XXL)
    text_towers: str = "pseudo"
    towers_params_dir: Optional[str] = None  # the towers' converted parameters (T2ITowers.load)
    tower_seq_len: int = 77  # T5 tokens
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


SD_MODELS = ("sd15", "sd21", "tiny")
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
    """The UNet, the VAE decoder (with ``--vae-weights`` or the tiny model;
    otherwise none, and the CLI saves the latents, as the JAX CLI does), the
    scaled-linear schedule and the denoise / decode functions, on ``device``
    (default ``cfg.device``: the card)."""
    if cfg.model not in SD_MODELS:
        raise SystemExit(f"unknown model {cfg.model!r}: {' | '.join(SD_MODELS)}")
    dev = resolve_device(cfg.device if device is None else device)
    tiny = cfg.model == "tiny"
    dtype = torch.float32 if tiny or cfg.dtype == "float32" else torch.bfloat16
    mcfg = SDUNetConfig.tiny() if tiny else SDUNetConfig.sd21() if cfg.model == "sd21" else SDUNetConfig.sd15()
    latent_size = mcfg.sample_size if tiny else cfg.height // 8
    if not (cfg.unet_weights or cfg.random_init):
        raise SystemExit("need --unet-weights or --random-init true")

    unet = _build(lambda: SDUNet(mcfg), cfg.unet_weights, 0, dev, dtype)
    vae = decode_fn = None
    if cfg.vae_weights or tiny:
        acfg = AutoencoderKLConfig.tiny() if tiny else AutoencoderKLConfig.sd_kl_ema()
        # float32 whatever ``cfg.dtype``: the JAX CLI decodes with the VAE's
        # default (float32) dtype
        vae = _build(lambda: AutoencoderKL(acfg), cfg.vae_weights, 1, dev, torch.float32)
        decode_fn = vae.decode

    # SD 1.5 and 2.1-base train on the scaled-linear schedule
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
    pseudo_text: bool  # the prompts entered as hash-seeded embeddings
    pseudo_tokens: bool  # the towers read hash-seeded token ids (no tokenizer on disk)


def _encode_flow_prompts(cfg: Config, mcfg, is_flux: bool, tiny: bool, dev):
    """(ctx, pooled, uncond_ctx, uncond_pooled, pseudo_text, pseudo_tokens):
    the pseudo embeddings, or the text towers' encoding, after which the
    towers are freed (JAX ``run_flow_match_family``'s conditioning)."""
    from ..pipelines.text_encoder import T2ITowers, pseudo_text_embeddings

    if cfg.text_towers == "pseudo" or tiny:
        if tiny and cfg.text_towers != "pseudo":
            print("tiny model configs have non-standard conditioning dims; falling back to pseudo embeddings")
        print("PSEUDO TEXT CONDITIONING: prompts enter as hash-seeded Gaussian embeddings, not text encodings "
              "(stamped pseudo_text: true in args.yaml)")

        def embed(prompt: str, seq_len: int, dim: int) -> torch.Tensor:
            return torch.from_numpy(pseudo_text_embeddings([prompt], seq_len=seq_len, dim=dim)).to(dev)

        ctx, uncond_ctx = (embed(p, PSEUDO_TEXT_LEN, mcfg.joint_attention_dim) for p in (cfg.prompt, cfg.prompt_negative))
        pooled, uncond_pooled = (embed(p, 1, mcfg.pooled_projection_dim)[:, 0] for p in (cfg.prompt, cfg.prompt_negative))
        return ctx, pooled, uncond_ctx, uncond_pooled, True, False
    t0 = time.perf_counter()
    towers = T2ITowers("flux" if is_flux else "sd3", scale=cfg.text_towers, seed=cfg.seed, clip_seq=77,
                       t5_seq=cfg.tower_seq_len, device=dev)
    if cfg.towers_params_dir:
        towers.load(cfg.towers_params_dir)
    t1 = time.perf_counter()
    ctx, pooled = towers.encode([cfg.prompt], clip_path=cfg.clip_path)
    uncond_ctx, uncond_pooled = towers.encode([cfg.prompt_negative], clip_path=cfg.clip_path)
    pseudo_tokens = towers.used_pseudo_tokens
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"text towers ({cfg.text_towers}): built in {t1 - t0:.2f} s, two prompts encoded in "
          f"{time.perf_counter() - t1:.2f} s on {dev}; context {list(ctx.shape)}, pooled {list(pooled.shape)}")
    if pseudo_tokens:
        print("tokenizer vocabulary files unavailable: prompts tokenized as hash-seeded pseudo token ids (the towers "
              "are real; stamped pseudo_tokens: true in args.yaml)")
    return ctx, pooled, uncond_ctx, uncond_pooled, False, pseudo_tokens


def build_flow_stack(cfg: Config, device=None) -> FlowStack:
    """The SD3 / SD3.5 / Flux transformer, its velocity function with the
    CLI's text conditioning (classifier-free guidance as one concatenated
    batch for MMDiT, ``guidance_scale·1000`` as Flux's guidance embedding)
    and, with ``--vae-weights``, the 16-channel VAE decoder, on ``device``
    (default ``cfg.device``: the card). The prompts are encoded, and the
    text towers freed, before the transformer is built."""
    if cfg.model not in FLOW_MODELS:
        raise SystemExit(f"unknown flow-matching model {cfg.model!r}: {' | '.join(FLOW_MODELS)}")
    is_flux, tiny = cfg.model.startswith("flux"), cfg.model.endswith("tiny")
    if cfg.text_towers not in ("pseudo", "small", "full"):
        raise SystemExit(f"unknown --text-towers {cfg.text_towers!r}: pseudo | small | full")
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
    ctx, pooled, uncond_ctx, uncond_pooled, pseudo_text, pseudo_tokens = _encode_flow_prompts(cfg, mcfg, is_flux, tiny, dev)
    model = _build(make, cfg.unet_weights, 0, dev, dtype)
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
    return FlowStack(model, velocity_fn, decode_fn, latent_size, mcfg, is_flux, pseudo_text, pseudo_tokens)


def run_flow_match_family(cfg: Config) -> int:
    """SD3 (MMDiT) / Flux on the flow-matching sampler: the guided run, then
    (unless ``--skip-original``) the plain run from the same x_T, into a
    numbered folder with ``args.yaml``."""
    from ..utils.rng import TorchNoise

    stack = build_flow_stack(cfg)
    dev = next(stack.model.parameters()).device
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
    save_config(cfg, dest / "args.yaml", pseudo_text=stack.pseudo_text, pseudo_tokens=stack.pseudo_tokens)

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
    """[H, W, 3 or 4] uint8 -> RGB or RGBA PNG file bytes (zlib, no filter;
    PIL writes 4-channel arrays as RGBA, as the JAX CLI's latent grids)."""
    h, w, c = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def save_png(path, images) -> None:
    """[B, H, W, C] float in [-1, 1] (C = 3, or 4 for latents) -> one PNG,
    the images side by side."""
    arr = np.clip(np.asarray(images, np.float32) / 2.0 + 0.5, 0.0, 1.0)
    arr = (arr * 255.0).astype(np.uint8)
    Path(path).write_bytes(_png_bytes(np.ascontiguousarray(np.concatenate(list(arr), axis=1))))


def _append_flags(path: Path, tag: str, flags) -> None:
    """One ``tag: [flags]`` mapping appended to ``nsfw_flags.yaml`` in
    PyYAML's block style (the JAX CLI's ``yaml.safe_dump``)."""
    body = "".join(f"- {str(bool(x)).lower()}\n" for x in flags)
    with open(path, "a") as f:
        f.write(f"{tag}:\n{body}" if body else f"{tag}: []\n")


def _numbered_dir(base: Path) -> Path:
    i = 0
    while (base / f"{i}").exists():
        i += 1
    dest = base / f"{i}"
    dest.mkdir()
    return dest


def main(argv=None) -> int:
    from ..models.convert import load_any_state_dict
    from ..pipelines.safety_checker import load_safety_checker, run_safety_checker
    from ..pipelines.text_encoder import encode_prompts_ex, pseudo_text_embeddings
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
    cond, uncond, pseudo_text = encode_prompts_ex([cfg.prompt], [cfg.prompt_negative], local_path=cfg.clip_path,
                                                  device=dev)
    if cond.shape[-1] != mcfg.cross_attention_dim:  # the JAX CLI's rule: SD 2.1's 1024 and the tiny model's 16
        cond, uncond = (pseudo_text_embeddings([p], seq_len=5, dim=mcfg.cross_attention_dim)
                        for p in (cfg.prompt, cfg.prompt_negative))
        pseudo_text = True
    if pseudo_text:
        print("PSEUDO TEXT CONDITIONING: CLIP unavailable, prompts enter as hash-seeded Gaussian embeddings "
              f"{list(cond.shape)} (stamped pseudo_text: true in args.yaml)")
    cond, uncond = torch.from_numpy(cond).to(dev), torch.from_numpy(uncond).to(dev)

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
    save_config(cfg, dest / "args.yaml", pseudo_text=bool(pseudo_text))

    checker = None
    if cfg.safety_checker_weights:
        checker = load_safety_checker(load_any_state_dict(cfg.safety_checker_weights), device=dev)

    def checked(images: torch.Tensor, tag: str) -> np.ndarray:
        """[-1, 1] images through the safety checker (when given), to the host."""
        if checker is not None:
            filtered, flags = run_safety_checker(checker, (images.float() + 1.0) / 2.0)
            images = filtered * 2.0 - 1.0
            if flags.any():
                print(f"{tag}: {int(flags.sum())}/{len(flags)} images flagged nsfw and blacked out")
            _append_flags(dest / "nsfw_flags.yaml", tag, flags)
        return images.float().cpu().numpy()

    t0 = time.perf_counter()
    pipe = TextToImageUncertaintyPipeline(stack.denoise_fn, stack.schedule, stack.decode_fn, pcfg)
    res = pipe(cond, TorchNoise(cfg.seed, dev), uncond_embeds=uncond)
    images = checked(res.images, "guided")
    print(f"guided sampling: {time.perf_counter() - t0:.2f} s for {cfg.num_steps} steps on {dev}")
    save_png(dest / "output_sd_uc.png", images)
    if res.uncertainty is not None:
        np.savez(dest / "uncertainty.npz", data=res.uncertainty.cpu().numpy())

    if not cfg.skip_original:
        plain = TextToImageUncertaintyPipeline(
            stack.denoise_fn, stack.schedule, stack.decode_fn, dataclasses.replace(pcfg, num_steps_uc=0)
        )
        res0 = plain(cond, TorchNoise(cfg.seed, dev), uncond_embeds=uncond)
        save_png(dest / "output_sd.png", checked(res0.images, "original"))
    print(f"Saved to {dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
