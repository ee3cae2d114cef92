"""The slice as a whole: the port's ``sample_ddim`` with
``uncertainty_zigzag_centered`` on the tiny ADM against the JAX package, in
float32 on the CPU, with the same x_T, labels, weights and noise (the port
replays the draws the JAX run makes).

The chain starts at step 4 (t=500): each DDIM step multiplies an epsilon
difference by about sqrt(ab_prev / ab_t) + 1 in x, so float32 rounding
differences of the forwards (~5e-6) grow ~3x per step from t=900 and reach
4e-3 after 10 steps; from t=500 they stay near 6e-5."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, jax_sampler_noise, make_adm_state_dict, torch_state_dict

from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.diffusion import sample_ddim as t_sample_ddim
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_tpu.diffusion import SamplerConfig, make_schedule, sample_ddim
from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet
from diffusion_uncertainty_tpu.uncertainty import EstimatorConfig, make_estimator

STEPS, START, AFTER, N_UC, M, ZIG = 10, 4, 6, 4, 2, 2
SHAPE = (2, 16, 16, 3)


@pytest.fixture(scope="module")
def setup():
    jcfg = ADMUNetConfig.tiny()
    sd = make_adm_state_dict(jcfg, seed=3)
    params = convert_adm_unet(sd, jcfg)
    tmodel = TADMUNet(TADMUNetConfig.tiny())
    tmodel.load_state_dict(torch_state_dict(sd))
    tmodel.eval()
    rng = np.random.RandomState(7)
    x_T = rng.randn(*SHAPE).astype(np.float32)
    y = np.array([2, 5])
    return jcfg, params, tmodel, x_T, y


@pytest.mark.parametrize("chunk", [0, 1])
def test_zigzag_sampling_matches_jax(setup, chunk):
    jcfg, params, tmodel, x_T, y = setup
    key = jax.random.key(11)

    jmodel = ADMUNet(jcfg)
    yj = jnp.asarray(y)
    scfg = SamplerConfig(num_inference_steps=STEPS, after_step=AFTER, num_steps_uc=N_UC, start_step=START)
    est = make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=M, num_zigzag=ZIG, ensemble_chunk=chunk))
    ref = jax.jit(
        lambda p, x, k: sample_ddim(lambda xx, tt, kk: jmodel.apply(p, xx, tt, yj), make_schedule("linear", 1000), x, k, scfg, estimator=est)
    )(params, jnp.asarray(x_T), key)

    draws = jax_sampler_noise(key, SHAPE, STEPS, AFTER, N_UC, M, ZIG, start_step=START)
    noise = ReplayNoise(draws)
    yt = torch.from_numpy(y)
    t_est = t_make_estimator(TEstimatorConfig(name="uncertainty_zigzag_centered", M=M, num_zigzag=ZIG, ensemble_chunk=chunk))
    tcfg = TSamplerConfig(num_inference_steps=STEPS, after_step=AFTER, num_steps_uc=N_UC, start_step=START)
    out = t_sample_ddim(
        lambda xx, tt, _: tmodel(xx, tt, yt), t_make_schedule("linear", 1000, device="cpu"), torch.from_numpy(x_T), noise, tcfg, estimator=t_est
    )
    assert noise.used == len(draws)

    # float32 on both sides; differences are summation order inside the
    # convolutions and attention, amplified along the chain (see above)
    np.testing.assert_allclose(out.sample.numpy(), np.asarray(ref.sample), atol=1e-4, rtol=0)
    # the model's output at window points whose x already differs by up to
    # 6e-5: the random-weight model doubles that difference
    np.testing.assert_allclose(out.pred_epsilon.numpy(), np.asarray(ref.pred_epsilon), atol=2e-4, rtol=0)
    # the map is a mean of squared score differences: relative to its scale
    u, u_ref = out.uncertainty.numpy(), np.asarray(ref.uncertainty)
    assert u.shape == u_ref.shape == (N_UC,) + SHAPE
    np.testing.assert_allclose(u, u_ref, rtol=1e-3, atol=1e-3 * float(np.abs(u_ref).max()))
    np.testing.assert_array_equal(out.window_timesteps, ref.window_timesteps)
