"""The port's flow-matching sampler against the JAX package, float32 on the
CPU: the sigma schedules, one guided velocity update in each branch, and
``sample_flow_match`` / ``sample_flow_match_stepwise`` on a tiny MMDiT (with
classifier-free guidance, as the CLI runs it) and a tiny Flux (its guidance
embedding at the CLI's 7500), both branches, with JAX's draws replayed."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, jax_flow_noise

import diffusion_uncertainty_torch.diffusion.flow_match as tfm
import diffusion_uncertainty_tpu.diffusion.flow_match as jfm
from diffusion_uncertainty_torch.models import FluxConfig as TFluxConfig
from diffusion_uncertainty_torch.models import FluxTransformer as TFlux
from diffusion_uncertainty_torch.models import MMDiT as TMMDiT
from diffusion_uncertainty_torch.models import MMDiTConfig as TMMDiTConfig
from diffusion_uncertainty_torch.models import flux_state_dict_from_flax, mmdit_state_dict_from_flax
from diffusion_uncertainty_tpu.models import FluxConfig, FluxTransformer, MMDiT, MMDiTConfig

torch.set_num_threads(1)

M = 3
STEPS, AFTER, WINDOW = 4, 1, 2  # window [1, 3): plain steps on both sides
CFG_SCALE = 7.5
# Chains of 4 steps through random tiny transformers; measured rel L2
# against JAX: samples 2.2e-6 (MMDiT) and 4.7e-6 (Flux, whose guidance
# embedding at 7500 carries the float32 sincos's ~1e-4 conditioning), maps
# at most 1.0e-5 (the quantile masks are identical); the limits leave 4x
# and 10x
SAMPLE_REL, U_REL = 2e-5, 1e-4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("kw", [dict(num_inference_steps=20), dict(num_inference_steps=28, shift=1.0),
                                dict(num_inference_steps=20, use_dynamic_shifting=True, image_seq_len=1024),
                                dict(num_inference_steps=7, use_dynamic_shifting=True, image_seq_len=4096)],
                         ids=["sd3", "shift1", "flux", "flux_long"])
def test_sigmas_match_jax(kw):
    got = tfm._sigmas(tfm.FlowMatchConfig(**kw))
    want = jfm._sigmas(jfm.FlowMatchConfig(**kw))
    assert got.dtype == np.float32 and got.shape == (kw["num_inference_steps"] + 1,) and got[-1] == 0
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@functools.cache
def _models(kind: str):
    """(JAX velocity fn, port velocity fn, latent shape): a tiny MMDiT with
    CFG over a concatenated batch, or a tiny Flux with its guidance
    embedding, on seeded JAX weights carried across by the converter."""
    rng = np.random.RandomState(7)
    if kind == "mmdit":
        jcfg, tcfg, shape = MMDiTConfig.tiny(), TMMDiTConfig.tiny(), (1, 8, 8, 16)
        jmodel, tmodel, to_sd = MMDiT(jcfg), TMMDiT(tcfg), mmdit_state_dict_from_flax
    else:
        jcfg, tcfg, shape = FluxConfig.tiny(), TFluxConfig.tiny(), (1, 8, 8, 4)
        jmodel, tmodel, to_sd = FluxTransformer(jcfg), TFlux(tcfg), flux_state_dict_from_flax
    ctx = [rng.randn(1, 6, jcfg.joint_attention_dim).astype(np.float32) for _ in range(2)]
    pooled = [rng.randn(1, jcfg.pooled_projection_dim).astype(np.float32) for _ in range(2)]
    extra = (jnp.asarray(1000.0),) if kind == "flux" else ()
    params = jax.jit(jmodel.init)(jax.random.key(1), jnp.zeros(shape), jnp.asarray(1.0), jnp.asarray(ctx[0]),
                                  jnp.asarray(pooled[0]), *extra)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    tmodel.load_state_dict(to_sd(params, tcfg))
    tmodel.eval().requires_grad_(False)  # as the CLI builds it
    apply = jax.jit(jmodel.apply)
    g = CFG_SCALE * 1000.0

    def jax_fn(x, t, key):
        if kind == "flux":
            return apply(params, x, t, jnp.asarray(ctx[1]), jnp.asarray(pooled[1]), jnp.asarray(g))
        v2 = apply(params, jnp.concatenate([x, x]), t, jnp.asarray(np.concatenate(ctx)), jnp.asarray(np.concatenate(pooled)))
        vu, vc = jnp.split(v2, 2)
        return vu + CFG_SCALE * (vc - vu)

    tctx, tpooled = torch.from_numpy(np.concatenate(ctx)), torch.from_numpy(np.concatenate(pooled))

    def torch_fn(x, t):
        n = x.shape[0]  # the batch of one prompt, times the folded members
        c, p = tctx.repeat_interleave(n, 0), tpooled.repeat_interleave(n, 0)
        if kind == "flux":
            return tmodel(x, t, c[n:], p[n:], g)
        vu, vc = tmodel(torch.cat([x, x]), t, c, p).chunk(2)
        return vu + CFG_SCALE * (vc - vu)

    return jax_fn, torch_fn, shape


@pytest.mark.parametrize("use_posterior", [True, False], ids=["posterior", "gradient"])
def test_guided_velocity_matches_jax(use_posterior):
    jax_fn, torch_fn, shape = _models("mmdit")
    rng = np.random.RandomState(8)
    x, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    sigma = np.float32(0.6)
    t = float(sigma * np.float32(1000))
    cfg = dict(M=M, percentile=0.9, use_posterior=use_posterior, lr=0.99)
    k_n, k_e = jax.random.split(jax.random.key(9))
    noises = np.asarray(jax.random.normal(k_n, (M,) + shape, jnp.float32))
    want_v, want_u = jfm._guided_velocity(jax_fn, jnp.asarray(x), jnp.asarray(v), jnp.asarray(sigma), jnp.asarray(t),
                                          jfm.FlowMatchConfig(**cfg), k_n, k_e, sequential=False)
    for sequential in (False, True):
        with torch.no_grad():  # as the samplers call it
            got_v, got_u = tfm._guided_velocity(torch_fn, torch.from_numpy(x), torch.from_numpy(v), torch.tensor(sigma),
                                                t, tfm.FlowMatchConfig(**cfg), ReplayNoise([noises]), sequential)
        assert _rel_l2(got_u, want_u) <= U_REL
        assert _rel_l2(got_v.numpy() - v, np.asarray(want_v) - v) <= U_REL  # the update itself
        mask = tfm._quantile_mask(got_u, 0.9)
        assert 0 < float(mask.mean()) < 0.2
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jfm._quantile_mask(want_u, 0.9)))


@functools.cache
def _jax_run(kind: str, use_posterior: bool):
    jax_fn, _, shape = _models(kind)
    cfg = jfm.FlowMatchConfig(num_inference_steps=STEPS, after_step=AFTER, num_steps_uc=WINDOW, M=M, percentile=0.9,
                              use_posterior=use_posterior, lr=0.99, use_dynamic_shifting=kind == "flux",
                              image_seq_len=16 if kind == "flux" else 0)
    draws = jax_flow_noise(11, shape, STEPS, AFTER, WINDOW, M)
    res = jax.jit(lambda x, k: jfm.sample_flow_match(jax_fn, x, k, cfg)[:2])(jnp.asarray(draws[0]), jax.random.key(12))
    return cfg, draws, np.asarray(res[0]), np.asarray(res[1])


@pytest.mark.parametrize("use_posterior", [True, False], ids=["posterior", "gradient"])
@pytest.mark.parametrize("kind", ["mmdit", "flux"])
def test_samplers_match_jax(kind, use_posterior):
    """The folded sampler and the stepwise one against JAX's scan sampler
    (which JAX's own tests hold equal to its stepwise twin), JAX's draws
    replayed: x_T, then one [M, *shape] draw per window step."""
    cfg, draws, want_x, want_u = _jax_run(kind, use_posterior)
    _, torch_fn, _ = _models(kind)
    tcfg = tfm.FlowMatchConfig(**dataclasses.asdict(cfg))
    x_T = torch.from_numpy(np.array(draws[0]))
    for sampler in (tfm.sample_flow_match, tfm.sample_flow_match_stepwise):
        noise = ReplayNoise(draws[1:])
        res = sampler(torch_fn, x_T, noise, tcfg)
        assert noise.used == WINDOW and res.uncertainty.shape == (WINDOW,) + x_T.shape
        np.testing.assert_array_equal(res.sigmas, jfm._sigmas(cfg)[AFTER:AFTER + WINDOW])
        assert _rel_l2(res.sample, want_x) <= SAMPLE_REL, sampler.__name__
        assert _rel_l2(res.uncertainty, want_u) <= U_REL, sampler.__name__
    # the plain chain: no draws, no maps, the whole schedule
    plain = tfm.sample_flow_match(torch_fn, x_T, ReplayNoise([]), dataclasses.replace(tcfg, num_steps_uc=0))
    assert plain.uncertainty is None and len(plain.sigmas) == STEPS + 1
    assert _rel_l2(plain.sample, want_x) > 10 * SAMPLE_REL  # the guidance moved the guided chain
