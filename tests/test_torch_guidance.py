"""The port's percentile guidance and text-to-image pipeline against the JAX
package, float32 on the CPU, with the JAX run's Gaussian draws replayed
into the port (``test_torch_helpers.jax_guidance_noise``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, jax_guidance_noise, make_sd_unet_state_dict, make_vae_state_dict, torch_state_dict

from diffusion_uncertainty_torch.diffusion import DiffusionConfig as TDiffusionConfig
from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import ddim_step as t_ddim_step
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.diffusion import sample_ddim as t_sample_ddim
from diffusion_uncertainty_torch.diffusion.sampler import StepState as TStepState
from diffusion_uncertainty_torch.models import AutoencoderKL as TAutoencoderKL
from diffusion_uncertainty_torch.models import AutoencoderKLConfig as TAutoencoderKLConfig
from diffusion_uncertainty_torch.models import SDUNet as TSDUNet
from diffusion_uncertainty_torch.models import SDUNetConfig as TSDUNetConfig
from diffusion_uncertainty_torch.pipelines import T2IPipelineConfig as TT2IPipelineConfig
from diffusion_uncertainty_torch.pipelines import TextToImageUncertaintyPipeline as TPipeline
from diffusion_uncertainty_torch.uncertainty import guidance as tguid
from diffusion_uncertainty_tpu.diffusion import DiffusionConfig, ddim_step, make_schedule
from diffusion_uncertainty_tpu.diffusion.sampler import StepState
from diffusion_uncertainty_tpu.models import AutoencoderKL, AutoencoderKLConfig, SDUNet, SDUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_autoencoder_kl, convert_sd_unet
from diffusion_uncertainty_tpu.pipelines.text_to_image import T2IPipelineConfig, TextToImageUncertaintyPipeline
from diffusion_uncertainty_tpu.uncertainty import guidance as jguid

SCHED = dict(kind="scaled_linear", num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012)
DCFG = dict(clip_sample=False)
M = 3


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("percentile,mode", [(0.9, "higher"), (0.5, "lower"), (0.95, "higher")])
def test_quantile_mask_matches_jax(percentile, mode):
    u = np.abs(_rand(np.random.RandomState(0), 3, 8, 8, 4))
    got = tguid.quantile_mask(torch.from_numpy(u), percentile, mode).numpy()
    np.testing.assert_array_equal(got, np.asarray(jguid.quantile_mask(jnp.asarray(u), percentile, mode)))


def test_posterior_score_matches_jax():
    rng = np.random.RandomState(1)
    stacked = _rand(rng, M + 1, 2, 4, 4, 4)
    u, post = tguid._posterior_score(torch.from_numpy(stacked), torch.from_numpy(stacked[-1]), torch.tensor(0.4), M)
    ju, jpost = jguid._posterior_score(jnp.asarray(stacked), jnp.asarray(stacked[-1]), jnp.float32(0.4), M)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-6, atol=0)
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost), rtol=1e-5, atol=1e-6)


def _tiny_unet(seed=5):
    sd = make_sd_unet_state_dict(TSDUNetConfig.tiny(), seed=seed)
    tmodel = TSDUNet(TSDUNetConfig.tiny())
    tmodel.load_state_dict(torch_state_dict(sd))
    return tmodel.eval().requires_grad_(False), convert_sd_unet(sd, SDUNetConfig.tiny())


def _eps_from_prev(x, prev, ab_t, ab_prev):
    """The eps that DDIM (eta 0, no clipping) turned x_t into x_{t-1} with."""
    a, b = np.sqrt(ab_prev / ab_t), np.sqrt(1.0 - ab_prev) - np.sqrt(ab_prev) * np.sqrt(1.0 - ab_t) / np.sqrt(ab_t)
    return (prev - a * x) / b


@pytest.mark.parametrize("use_posterior", [True, False])
def test_percentile_guidance_matches_jax(use_posterior):
    """One window step of ``make_percentile_guidance`` on the tiny SD UNet,
    both branches (the gradient through the model and the kernel ops'
    autograd wrappers): new eps and u within 1e-4."""
    tmodel, params = _tiny_unet()
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 8, 8, 4)
    ctx = _rand(rng, 2, 5, 16)
    t, t_prev = 601, 551
    jmodel = SDUNet(SDUNetConfig.tiny())
    j_fn = lambda z, tt, k: jmodel.apply(params, z, jnp.asarray(tt), jnp.asarray(ctx))  # noqa: E731
    # the port folds the ensemble into the batch: conditioning tiled member-major
    t_fn = lambda z, tt, _: tmodel(z, tt, torch.from_numpy(ctx).repeat(z.shape[0] // 2, 1, 1))  # noqa: E731

    sched, tsched = make_schedule(**SCHED), t_make_schedule(**SCHED, device="cpu")
    eps0 = np.array(j_fn(jnp.asarray(x), t, None))
    jstep = ddim_step(sched, jnp.asarray(x), jnp.asarray(eps0), t, t_prev, DiffusionConfig(**DCFG))
    jstate = StepState(jnp.asarray(x), jstep.pred_original_sample, jstep.pred_epsilon, jstep.prev_sample, jnp.int32(t), jnp.int32(t_prev))
    tstep = t_ddim_step(tsched, torch.from_numpy(x), torch.from_numpy(eps0), t, t_prev, TDiffusionConfig(**DCFG))
    tstate = TStepState(torch.from_numpy(x), tstep.pred_original_sample, tstep.pred_epsilon, tstep.prev_sample, t, t_prev)

    kw = dict(M=M, percentile=0.9, use_posterior=use_posterior, lr=0.99)
    key = jax.random.key(3)
    jprev, ju, _ = jguid.make_percentile_guidance(**kw, dcfg=DiffusionConfig(**DCFG)).apply(j_fn, sched, jstate, key, None)
    # the guidance's own draw from its key (``estimators.py:104-108``)
    noise = ReplayNoise([np.asarray(jax.random.normal(jax.random.split(key)[0], (M,) + x.shape, jnp.float32))])
    with torch.no_grad():
        tprev, tu, _ = tguid.make_percentile_guidance(**kw, dcfg=TDiffusionConfig(**DCFG)).apply(t_fn, tsched, tstate, noise, None)
    assert noise.used == 1
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4, rtol=0)
    ab_t, ab_prev = float(sched.alpha_bar(t)), float(sched.alpha_bar(t_prev))
    new_eps = _eps_from_prev(x, tprev.numpy().astype(np.float64), ab_t, ab_prev)
    j_new_eps = _eps_from_prev(x, np.asarray(jprev).astype(np.float64), ab_t, ab_prev)
    assert np.abs(j_new_eps - eps0).max() > 1e-3  # the guidance did move eps
    np.testing.assert_allclose(new_eps, j_new_eps, atol=1e-4, rtol=0)


def test_sampler_guidance_window_and_draws():
    """``sample_ddim(guidance=)``: the guidance sets x_{t-1} inside the window
    only, its maps fill the window, one draw per window step."""
    calls = []

    def apply(model_fn, schedule, state, noise, aux):
        calls.append(state.timestep)
        noise.normal((1,), torch.float32, None)
        return state.prev_sample + 1.0, torch.full_like(state.pred_epsilon, float(len(calls))), aux + 1

    g = tguid.Guidance(lambda x: 0, apply)
    sched = t_make_schedule(device="cpu")
    cfg = TSamplerConfig(num_inference_steps=10, after_step=3, num_steps_uc=4)
    x = torch.ones(1, 2, 2, 1)
    noise = ReplayNoise([np.zeros(1, np.float32)] * 4)
    res = t_sample_ddim(lambda z, t, _: 0.1 * z, sched, x, noise, cfg, guidance=g)
    plain = t_sample_ddim(lambda z, t, _: 0.1 * z, sched, x, noise, TSamplerConfig(num_inference_steps=10))
    assert len(calls) == 4 and noise.used == 4
    assert res.uncertainty.shape == (4, 1, 2, 2, 1) and [float(u.max()) for u in res.uncertainty] == [1, 2, 3, 4]
    assert not torch.equal(res.sample, plain.sample)


def _pipelines(use_posterior):
    tunet, uparams = _tiny_unet(seed=6)
    vsd = make_vae_state_dict(AutoencoderKLConfig.tiny(), seed=7)
    tvae = TAutoencoderKL(TAutoencoderKLConfig.tiny())
    tvae.load_state_dict(torch_state_dict(vsd))
    tvae.eval().requires_grad_(False)
    vparams = convert_autoencoder_kl(vsd, AutoencoderKLConfig.tiny())
    jmodel, jvae = SDUNet(SDUNetConfig.tiny()), AutoencoderKL(AutoencoderKLConfig.tiny())
    kw = dict(num_inference_steps=4, guidance_scale=7.5, start_step_uc=0, num_steps_uc=2, percentile=0.9,
              use_posterior=use_posterior, lr=0.99, M=M, latent_channels=4, latent_size=8)
    jpipe = TextToImageUncertaintyPipeline(
        lambda z, t, e, k: jmodel.apply(uparams, z, t, e), make_schedule(**SCHED),
        lambda z: jvae.apply(vparams, z, "decode"), T2IPipelineConfig(**kw),
    )
    tpipe = TPipeline(lambda z, t, e, _: tunet(z, t, e), t_make_schedule(**SCHED, device="cpu"), tvae.decode, TT2IPipelineConfig(**kw))
    return jpipe, tpipe


@pytest.mark.parametrize("use_posterior", [True, False])
def test_tiny_pipeline_matches_jax(use_posterior):
    """The tiny text-to-image pipeline end to end: CFG 7.5, 4 DDIM steps,
    percentile guidance on steps [0, 2), VAE decode. Tolerance 2e-3 on the
    latents, images and maps, from the float32 rounding of the chain: CFG
    multiplies each step's eps difference by 7.5, and each DDIM step carries
    it forward about 3x (ROADMAP.md section 3); single forwards agree to
    1e-5."""
    jpipe, tpipe = _pipelines(use_posterior)
    rng = np.random.RandomState(8)
    cond, uncond = _rand(rng, 1, 5, 16), _rand(rng, 1, 5, 16)
    key = jax.random.key(9)
    jres = jpipe(jnp.asarray(cond), key, uncond_embeds=jnp.asarray(uncond))
    noise = ReplayNoise(jax_guidance_noise(key, (1, 8, 8, 4), 4, 0, 2, M, latents_shape=(1, 8, 8, 4)))
    tres = tpipe(torch.from_numpy(cond), noise, uncond_embeds=torch.from_numpy(uncond))
    assert noise.used == 3
    assert tres.uncertainty.shape == (1, 2, 8, 8, 4) and tres.images.shape == (1, 16, 16, 3)
    for got, want in ((tres.latents, jres.latents), (tres.images, jres.images), (tres.uncertainty, jres.uncertainty)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)
