"""The port's Flux transformer against the JAX package, float32 on the CPU:
the tiny forward through the inverse converter (non-square latents with a
channel count that is not 4, so a wrong token packing or permutation shows),
the converter's exact round trip through JAX's ``convert_flux`` (dev and
schnell), the token permutation, the rotary tables and the full-size
parameter count."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_uncertainty_torch.models import FluxConfig as TFluxConfig
from diffusion_uncertainty_torch.models import FluxTransformer as TFlux
from diffusion_uncertainty_torch.models import flux_state_dict_from_flax
from diffusion_uncertainty_torch.models.convert import flux_token_permutation
from diffusion_uncertainty_torch.models.flux import _apply_rope, _rope_cos_sin
from diffusion_uncertainty_tpu.models import FluxConfig, FluxTransformer
from diffusion_uncertainty_tpu.models import flux as jflux
from diffusion_uncertainty_tpu.models.convert import _flux_token_perm, convert_flux

# float32 both sides; matmuls and norms sum in another order
FWD_REL = 1e-5
CHANNELS = 6  # not 4: a packing that mixes channels and patch positions shows

torch.set_num_threads(1)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _configs(**kw):
    return (dataclasses.replace(FluxConfig.tiny(), in_channels=CHANNELS, **kw),
            dataclasses.replace(TFluxConfig.tiny(), in_channels=CHANNELS, **kw))


@functools.cache
def _jax_params(jcfg, seed: int = 1):
    """JAX init, then every leaf moved by 0.1·N(0, 1) (shared by the tests:
    treat as read-only)."""
    rng = np.random.RandomState(seed)
    g = jnp.asarray(1000.0) if jcfg.guidance_embeds else None
    params = jax.jit(FluxTransformer(jcfg).init)(jax.random.key(seed), jnp.zeros((1, 4, 6, jcfg.in_channels)), jnp.asarray(1.0),
                                        jnp.zeros((1, 5, jcfg.joint_attention_dim)),
                                        jnp.zeros((1, jcfg.pooled_projection_dim)), g)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32), params)


def test_tiny_forward_matches_jax():
    """Latents 8x6 (a 4x3 token grid), 6 channels. t and the guidance stay
    in the hundreds and below: the float32 sincos of a value in the thousands
    is conditioned to ~1e-4 (XLA's and PyTorch's frequencies differ in the
    last bit), which the samplers' tests hold at the CLI's 7500 instead."""
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    model = TFlux(tcfg)
    model.load_state_dict(flux_state_dict_from_flax(params, tcfg))  # strict: diffusers keys and shapes
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 6, CHANNELS).astype(np.float32)
    ctx = rng.randn(2, 5, jcfg.joint_attention_dim).astype(np.float32)
    pooled = rng.randn(2, jcfg.pooled_projection_dim).astype(np.float32)
    ref = jax.jit(FluxTransformer(jcfg).apply)(params, jnp.asarray(x), jnp.asarray(321.5), jnp.asarray(ctx), jnp.asarray(pooled),
                                      jnp.asarray(35.0))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x), 321.5, torch.from_numpy(ctx), torch.from_numpy(pooled), 35.0)
    assert out.dtype == torch.float32 and out.shape == (2, 8, 6, CHANNELS)
    assert _rel_l2(out.numpy(), ref) <= FWD_REL
    with pytest.raises(ValueError, match="guidance"):
        model(torch.from_numpy(x), 321.5, torch.from_numpy(ctx), torch.from_numpy(pooled))


@pytest.mark.parametrize("guidance_embeds", [True, False], ids=["dev", "schnell"])
def test_converter_round_trips_exactly(guidance_embeds):
    jcfg, tcfg = _configs(guidance_embeds=guidance_embeds)
    params = _jax_params(jcfg)
    sd = flux_state_dict_from_flax(params, tcfg)
    with torch.device("meta"):
        assert set(sd) == set(TFlux(tcfg).state_dict())
    back = convert_flux({k: v.numpy() for k, v in sd.items()}, jcfg)  # strict: every key taken
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)))
    assert ("time_text_embed.guidance_embedder.linear_1.weight" in sd) == guidance_embeds


def test_token_permutation_is_the_jax_one():
    for c in (4, CHANNELS, 16):
        np.testing.assert_array_equal(flux_token_permutation(c), _flux_token_perm(c))


def test_rope_tables_match_jax():
    rng = np.random.RandomState(4)
    ids = np.concatenate([np.zeros((5, 3)), np.stack([np.zeros(12), np.repeat(np.arange(4.0), 3),
                                                      np.tile(np.arange(3.0), 4)], -1)]).astype(np.float32)
    axes = (16, 56, 56)
    cos, sin = _rope_cos_sin(torch.from_numpy(ids), axes)
    jcos, jsin = jflux._rope_cos_sin(jnp.asarray(ids), axes)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)
    x = rng.randn(2, 17, 3, 128).astype(np.float32)
    np.testing.assert_allclose(_apply_rope(torch.from_numpy(x), cos, sin).numpy(),
                               np.asarray(jflux._apply_rope(jnp.asarray(x), jcos, jsin)), atol=1e-5, rtol=0)


def test_full_size_parameter_count_equals_jax():
    jcfg, tcfg = FluxConfig.flux_dev(), TFluxConfig.flux_dev()
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(jcfg).items() if k not in ("dtype", "sp_axis")}
    with torch.device("meta"):
        n_port = sum(p.numel() for p in TFlux(tcfg).parameters())
    shapes = jax.eval_shape(
        lambda k: FluxTransformer(jcfg).init(k, jnp.zeros((1, 4, 4, 16)), jnp.asarray(1.0), jnp.zeros((1, 16, 4096)),
                                             jnp.zeros((1, 768)), jnp.asarray(1000.0)),
        jax.random.key(0),
    )
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_port == n_jax and 11.8e9 < n_port < 12.0e9
