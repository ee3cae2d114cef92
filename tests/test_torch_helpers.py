"""Shared helpers of the torch-port parity tests, and tests of the helpers.

* ``make_adm_state_dict``: a reference-layout ADM state dict with random,
  non-zero values everywhere (the reference zero-initialises ``out_conv``,
  ``proj_out`` and ``conv_out``, which would make a parity test pass
  trivially). The port loads it directly; the JAX model gets it through
  ``convert_adm_unet``.
* ``make_sd_unet_state_dict`` / ``make_vae_state_dict``: random diffusers /
  CompVis-layout SD UNet and KL-VAE state dicts (norm scales around 1).
* ``jax_sampler_noise`` walks the JAX key tree of ``sample_ddim`` with
  ``uncertainty_zigzag_centered`` and returns the Gaussian draws the JAX run
  makes, in the port's draw order; ``jax_guidance_noise`` does the same for
  the percentile guidance (and the text-to-image pipeline's initial
  latents), ``jax_flow_noise`` for the flow-matching text-to-image run;
  ``ReplayNoise`` hands them to the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffusion_uncertainty_torch.models import SDUNet as TSDUNet
from diffusion_uncertainty_torch.models import autoencoder_kl_state_dict_from_flax
from diffusion_uncertainty_torch.models.layers import GroupNorm32 as TGroupNorm32
from diffusion_uncertainty_torch.utils.rng import TorchNoise
from diffusion_uncertainty_tpu.diffusion.schedule import uncertainty_window
from diffusion_uncertainty_tpu.models import ADMUNetConfig, AutoencoderKL
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet


def make_adm_state_dict(cfg, seed: int = 0, std: float = 0.05) -> dict:
    """{key: float32 ndarray} in the reference's ``UNetModel`` layout."""
    rng = np.random.RandomState(seed)
    mc = cfg.model_channels
    emb = 4 * mc
    sd = {}

    def put(key, *shape):
        sd[key] = (rng.randn(*shape) * std).astype(np.float32)

    def norm(pfx, c):
        # around 1 so the normalised signal survives a deep stack
        sd[f"{pfx}.weight"] = (1.0 + rng.randn(c) * 0.1).astype(np.float32)
        put(f"{pfx}.bias", c)

    def resblock(pfx, c_in, c_out):
        norm(f"{pfx}.in_layers.0", c_in)
        put(f"{pfx}.in_layers.2.weight", c_out, c_in, 3, 3)
        put(f"{pfx}.in_layers.2.bias", c_out)
        put(f"{pfx}.emb_layers.1.weight", 2 * c_out, emb)
        put(f"{pfx}.emb_layers.1.bias", 2 * c_out)
        norm(f"{pfx}.out_layers.0", c_out)
        put(f"{pfx}.out_layers.3.weight", c_out, c_out, 3, 3)
        put(f"{pfx}.out_layers.3.bias", c_out)
        if c_in != c_out:
            put(f"{pfx}.skip_connection.weight", c_out, c_in, 1, 1)
            put(f"{pfx}.skip_connection.bias", c_out)

    def attention(pfx, c):
        norm(f"{pfx}.norm", c)
        put(f"{pfx}.qkv.weight", 3 * c, c, 1)
        put(f"{pfx}.qkv.bias", 3 * c)
        put(f"{pfx}.proj_out.weight", c, c, 1)
        put(f"{pfx}.proj_out.bias", c)

    put("time_embed.0.weight", emb, mc)
    put("time_embed.0.bias", emb)
    put("time_embed.2.weight", emb, emb)
    put("time_embed.2.bias", emb)
    if cfg.num_classes is not None:
        put("label_emb.weight", cfg.num_classes, emb)
    put("input_blocks.0.0.weight", mc, cfg.in_channels, 3, 3)
    put("input_blocks.0.0.bias", mc)
    ds, ch, idx = 1, mc, 1
    chans = [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            resblock(f"input_blocks.{idx}.0", ch, mult * mc)
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                attention(f"input_blocks.{idx}.1", ch)
            chans.append(ch)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            resblock(f"input_blocks.{idx}.0", ch, ch)
            chans.append(ch)
            idx += 1
            ds *= 2
    resblock("middle_block.0", ch, ch)
    attention("middle_block.1", ch)
    resblock("middle_block.2", ch, ch)
    idx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            resblock(f"output_blocks.{idx}.0", ch + chans.pop(), mult * mc)
            ch = mult * mc
            sub = 1
            if ds in cfg.attention_resolutions:
                attention(f"output_blocks.{idx}.{sub}", ch)
                sub += 1
            if level and i == cfg.num_res_blocks:
                resblock(f"output_blocks.{idx}.{sub}", ch, ch)
                ds //= 2
            idx += 1
    norm("out.0", ch)
    put("out.2.weight", cfg.out_channels, ch, 3, 3)
    put("out.2.bias", cfg.out_channels)
    return sd


def torch_state_dict(sd: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def make_sd_unet_state_dict(tcfg, seed: int = 0, std: float = 0.05) -> dict:
    """{key: float32 ndarray} in the diffusers ``UNet2DConditionModel``
    layout of the port's ``SDUNet`` (keys and shapes read on the meta
    device); GroupNorm / LayerNorm scales around 1."""
    with torch.device("meta"):
        model = TSDUNet(tcfg)
    norms = {n for n, m in model.named_modules() if isinstance(m, (torch.nn.LayerNorm, TGroupNorm32))}
    rng = np.random.RandomState(seed)
    sd = {}
    for key, v in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        if owner in norms and leaf == "weight":
            sd[key] = (1.0 + rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            sd[key] = (rng.randn(*v.shape) * std).astype(np.float32)
    return sd


def make_vae_state_dict(jcfg, seed: int = 0, std: float = 0.05) -> dict:
    """A full CompVis KL-VAE state dict (encoder and decoder): random JAX
    ``AutoencoderKL`` parameters (norm scales around 1) carried across by
    ``autoencoder_kl_state_dict_from_flax``."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        lambda k: AutoencoderKL(jcfg).init(k, jnp.zeros((1, 16, 16, 3)), "init", k), jax.random.key(0)
    )

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "scale" in name:
            return (1.0 + rng.randn(*s.shape) * 0.1).astype(np.float32)
        return (rng.randn(*s.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: v.numpy() for k, v in autoencoder_kl_state_dict_from_flax(params, jcfg).items()}


def jax_sampler_noise(key, shape, num_inference_steps, after_step, num_steps_uc, M, num_zigzag, start_step=0):
    """The standard-normal draws of the JAX ``sample_ddim`` (eta 0) with
    ``uncertainty_zigzag_centered``: per window step, member by member, zig by
    zig (``sampler.py:140-148``, ``estimators.py:136-150``)."""
    w0, w1 = uncertainty_window(after_step, num_steps_uc, num_inference_steps)
    draws = []
    for i in range(start_step, num_inference_steps):
        if w0 <= i < w1:
            key, _, k_est = jax.random.split(key, 3)
            for k_m in jax.random.split(k_est, M):
                for k_j in jax.random.split(k_m, num_zigzag):
                    k_n, _ = jax.random.split(k_j)
                    draws.append(np.asarray(jax.random.normal(k_n, shape, jnp.float32)))
        else:
            key, _ = jax.random.split(key)
    return draws


def jax_guidance_noise(key, shape, num_inference_steps, after_step, num_steps_uc, M, latents_shape=None, start_step=0):
    """The standard-normal draws of the JAX ``sample_ddim`` (eta 0) with a
    percentile guidance or ``uncertainty_centered``: one [M, *shape] draw per
    window step (``sampler.py:158``, ``estimators.py:104-108``); the JAX
    ``sample_dpm_solver`` walks its key the same way (``dpm_solver.py:239-255``).
    With ``latents_shape`` the key is the text-to-image pipeline's, whose
    first draw is the initial latents (``text_to_image.py:123-127``); the
    chain starts at step ``start_step``."""
    draws = []
    if latents_shape is not None:
        k_init, key = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(k_init, latents_shape, jnp.float32)))
    w0, w1 = uncertainty_window(after_step, num_steps_uc, num_inference_steps)
    for i in range(start_step, num_inference_steps):
        if w0 <= i < w1:
            key, _, k_est = jax.random.split(key, 3)
            k_noise, _ = jax.random.split(k_est)
            draws.append(np.asarray(jax.random.normal(k_noise, (M,) + tuple(shape), jnp.float32)))
        else:
            key, _ = jax.random.split(key)
    return draws


def jax_flow_noise(seed: int, shape, num_inference_steps, after_step, num_steps_uc, M):
    """The standard-normal draws of the JAX text-to-image CLI's flow-matching
    run: x_T from ``key(seed)``, then, walking ``key(seed + 1)`` as
    ``sample_flow_match`` does (``flow_match.py:176-190``), one [M, *shape]
    draw per window step (``:144``)."""
    draws = [np.asarray(jax.random.normal(jax.random.key(seed), shape))]
    w0, w1 = uncertainty_window(after_step, num_steps_uc, num_inference_steps) if num_steps_uc > 0 else (0, 0)
    key = jax.random.key(seed + 1)
    for i in range(num_inference_steps):
        if w0 <= i < w1:
            key, _, k_n, _ = jax.random.split(key, 4)
            draws.append(np.asarray(jax.random.normal(k_n, (M,) + tuple(shape), jnp.float32)))
        else:
            key, _ = jax.random.split(key)
    return draws


class ReplayNoise:
    """A noise source that hands out recorded draws in order: Gaussian
    ``draws`` for ``normal`` and dropout keep-``masks`` for ``bernoulli``."""

    def __init__(self, draws, masks=()):
        self.draws = list(draws)
        self.used = 0
        self.masks = list(masks)
        self.masks_used = 0

    def bernoulli(self, shape, p, device=None):
        m = self.masks[self.masks_used]
        if tuple(m.shape) != tuple(shape):
            raise AssertionError(f"mask {self.masks_used}: recorded shape {m.shape}, asked {tuple(shape)}")
        self.masks_used += 1
        return torch.from_numpy(np.array(m, dtype=bool)).to(device)

    def normal(self, shape, dtype=torch.float32, device=None):
        a = self.draws[self.used]
        if tuple(a.shape) != tuple(shape):
            raise AssertionError(f"draw {self.used}: recorded shape {a.shape}, asked {tuple(shape)}")
        self.used += 1
        return torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)


def test_state_dict_is_nonzero_and_converts():
    cfg = ADMUNetConfig.tiny()
    sd = make_adm_state_dict(cfg)
    assert all(np.count_nonzero(v) == v.size for v in sd.values())
    convert_adm_unet(sd, cfg)  # strict: every key consumed, none missing


def test_jax_sampler_noise_order_and_count():
    draws = jax_sampler_noise(jax.random.key(0), (1, 2, 2, 3), 10, 6, 4, 2, 3)
    assert len(draws) == 4 * 2 * 3
    assert all(d.shape == (1, 2, 2, 3) and d.dtype == np.float32 for d in draws)
    assert len({d.tobytes() for d in draws}) == len(draws)


def test_replay_noise_replays_in_order_and_checks_shape():
    draws = [np.full((2, 3), i, np.float32) for i in range(3)]
    src = ReplayNoise(draws)
    for i in range(3):
        assert float(src.normal((2, 3), torch.float32, "cpu")[0, 0]) == i
    bad = ReplayNoise(draws)
    try:
        bad.normal((3, 2), torch.float32, "cpu")
    except AssertionError:
        pass
    else:
        raise AssertionError("shape mismatch not caught")


def test_torch_noise_is_seeded():
    a = TorchNoise(3, device="cpu").normal((4, 5))
    b = TorchNoise(3, device="cpu").normal((4, 5))
    assert torch.equal(a, b) and a.dtype == torch.float32
