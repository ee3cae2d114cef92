"""Schedule, DDIM step, re-noising, timestep embedding and the estimator
regimes of the port against the JAX package (float32, CPU). Tolerance:
1e-6 relative, the rounding of one float32 expression evaluated in two
frameworks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_uncertainty_torch.diffusion import DiffusionConfig as TDiffusionConfig
from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import StepState as TStepState
from diffusion_uncertainty_torch.diffusion import ddim_step as t_ddim_step
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.diffusion import sample_ddim as t_sample_ddim
from diffusion_uncertainty_torch.diffusion import spaced_timesteps as t_spaced
from diffusion_uncertainty_torch.diffusion import to_uint8 as t_to_uint8
from diffusion_uncertainty_torch.diffusion.sampler import _recompute_prev as t_recompute_prev
from diffusion_uncertainty_torch.models.layers import timestep_embedding as t_temb
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import Guidance as TGuidance
from diffusion_uncertainty_torch.uncertainty import ensemble_forward as t_ensemble_forward
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_torch.uncertainty.estimators import _renoise as t_renoise
from diffusion_uncertainty_torch.utils import TorchNoise
from diffusion_uncertainty_tpu.diffusion import DiffusionConfig, StepState, ddim_step, make_schedule, spaced_timesteps, to_uint8
from diffusion_uncertainty_tpu.diffusion.sampler import _recompute_prev
from diffusion_uncertainty_tpu.models.layers import timestep_embedding
from diffusion_uncertainty_tpu.uncertainty.estimators import _renoise

RTOL = 1e-6
SHAPE = (2, 4, 4, 3)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize(
    "kind,kw",
    [("linear", {}), ("scaled_linear", {}), ("squaredcos_cap_v2", {}), ("sigmoid", {}),
     ("linear", {"rescale_betas_zero_snr": True}), ("linear", {"set_alpha_to_one": False})],
)
def test_schedule_tables_match_jax(kind, kw):
    ref = make_schedule(kind, 1000, **kw)
    out = t_make_schedule(kind, 1000, **kw, device="cpu")
    for name in ("betas", "alphas_cumprod", "final_alpha_cumprod"):
        _close(getattr(out, name).numpy(), getattr(ref, name))
    ts = np.array([-20, 0, 1, 499, 999])
    _close(out.alpha_bar(torch.from_numpy(ts)).numpy(), ref.alpha_bar(jnp.asarray(ts)))
    _close(out.alpha_bar(-20).numpy(), ref.alpha_bar(jnp.asarray(-20)))


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
@pytest.mark.parametrize("n", [10, 50, 1000])
def test_spaced_timesteps_match_jax(spacing, n):
    np.testing.assert_array_equal(t_spaced(1000, n, spacing, 1), spaced_timesteps(1000, n, spacing, 1))


@pytest.mark.parametrize(
    "cfg",
    [{}, {"eta": 0.7}, {"prediction_type": "v_prediction", "clip_sample": False},
     {"prediction_type": "sample"}, {"thresholding": True, "sample_max_value": 1.5},
     {"use_clipped_model_output": True, "eta": 0.3}],
)
@pytest.mark.parametrize("t,t_prev", [(981, 961), (20, -20), (500, 480)])
def test_ddim_step_matches_jax(cfg, t, t_prev):
    rng = np.random.RandomState(t)
    x, eps, noise = (rng.randn(*SHAPE).astype(np.float32) for _ in range(3))
    ref = ddim_step(make_schedule(), jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(t_prev), DiffusionConfig(**cfg), noise=jnp.asarray(noise))
    out = t_ddim_step(t_make_schedule(device="cpu"), torch.from_numpy(x), torch.from_numpy(eps), t, t_prev, TDiffusionConfig(**cfg), noise=torch.from_numpy(noise))
    for a, b in zip(out, ref):
        _close(a.numpy(), b)


@pytest.mark.parametrize("predict_next", [False, True])
def test_renoise_matches_jax(predict_next):
    rng = np.random.RandomState(1)
    x, x0, eps, prev, noise = (rng.randn(*SHAPE).astype(np.float32) for _ in range(5))
    j_state = StepState(jnp.asarray(x), jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(prev), jnp.asarray(700), jnp.asarray(680))
    t_state = TStepState(*(torch.from_numpy(a) for a in (x, x0, eps, prev)), 700, 680)
    ref = _renoise(make_schedule(), j_state, jnp.asarray(noise), predict_next)
    out = t_renoise(t_make_schedule(device="cpu"), t_state, torch.from_numpy(noise), predict_next)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("cfg", [{}, {"eta": 0.5, "clip_sample": False}])
def test_recompute_prev_matches_jax(cfg):
    rng = np.random.RandomState(2)
    x, x0, eps, prev, new_eps = (rng.randn(*SHAPE).astype(np.float32) for _ in range(5))
    j_state = StepState(jnp.asarray(x), jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(prev), jnp.asarray(600), jnp.asarray(580))
    t_state = TStepState(*(torch.from_numpy(a) for a in (x, x0, eps, prev)), 600, 580)
    ref = _recompute_prev(make_schedule(), j_state, jnp.asarray(new_eps), DiffusionConfig(**cfg))
    out = t_recompute_prev(t_make_schedule(device="cpu"), t_state, torch.from_numpy(new_eps), TDiffusionConfig(**cfg))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("cos_first,freq_shift,dim", [(True, 0.0, 128), (False, 1.0, 64), (True, 0.0, 33)])
def test_timestep_embedding_matches_jax(cos_first, freq_shift, dim):
    t = np.array([0, 1, 250, 999])
    ref = timestep_embedding(jnp.asarray(t), dim, cos_first=cos_first, freq_shift=freq_shift)
    out = t_temb(torch.from_numpy(t), dim, cos_first=cos_first, freq_shift=freq_shift)
    # sin/cos of arguments up to 1e3: one float32 ulp of the argument
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    scalar = t_temb(500, dim, cos_first=cos_first, freq_shift=freq_shift)
    assert scalar.shape == (1, dim)


def test_to_uint8_matches_jax():
    x = np.linspace(-1.2, 1.2, 97, dtype=np.float32)
    np.testing.assert_array_equal(t_to_uint8(torch.from_numpy(x)).numpy(), np.asarray(to_uint8(jnp.asarray(x))))


def _state(seed=0):
    rng = np.random.RandomState(seed)
    a = [torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)) for _ in range(4)]
    return TStepState(a[0], a[1].clamp(-1, 1), a[2], a[3], 500, 480)


@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_zigzag_ensemble_chunks_agree(chunk):
    """All ensemble_chunk regimes draw the same noise in the same order and
    give the same map (a model that mixes the batch would break folding)."""
    model_fn = lambda x, t, _: torch.tanh(0.7 * x) + 0.01 * t  # noqa: E731
    state = _state()
    base = t_make_estimator(TEstimatorConfig(name="uncertainty_zigzag_centered", M=4, num_zigzag=3))
    est = t_make_estimator(TEstimatorConfig(name="uncertainty_zigzag_centered", M=4, num_zigzag=3, ensemble_chunk=chunk))
    u_base = base(model_fn, t_make_schedule(device="cpu"), state, TorchNoise(5, device="cpu"))
    u = est(model_fn, t_make_schedule(device="cpu"), state, TorchNoise(5, device="cpu"))
    torch.testing.assert_close(u, u_base, rtol=1e-6, atol=1e-7)
    assert u.shape == SHAPE and bool((u > 0).all())


def test_zigzag_collapse_runs_one_forward_per_member():
    calls = []
    model_fn = lambda x, t, _: calls.append(x.shape[0]) or 0.5 * x  # noqa: E731
    est = t_make_estimator(TEstimatorConfig(name="uncertainty_zigzag_centered", M=3, num_zigzag=4, zigzag_collapse=True))
    est(model_fn, t_make_schedule(device="cpu"), _state(), TorchNoise(0, device="cpu"))
    assert calls == [3 * SHAPE[0]]
    calls.clear()
    t_make_estimator(TEstimatorConfig(name="uncertainty_zigzag_centered", M=3, num_zigzag=4))(model_fn, t_make_schedule(device="cpu"), _state(), TorchNoise(0, device="cpu"))
    assert calls == [3 * SHAPE[0]] * 4


def test_centered_zero_model_gives_eps_squared():
    state = _state(2)
    u = t_make_estimator(TEstimatorConfig(name="uncertainty_centered", M=3))(lambda x, t, _: torch.zeros_like(x), t_make_schedule(device="cpu"), state, TorchNoise(1, device="cpu"))
    torch.testing.assert_close(u, state.pred_epsilon**2)


def test_ensemble_forward_chunking():
    xs = torch.randn(6, 2, 3)
    fn = lambda x, t, _: x * 2 + x.shape[0]  # noqa: E731  batch size leaks into the output
    assert torch.equal(t_ensemble_forward(fn, xs, 0, chunk=0), xs * 2 + 12)
    assert torch.equal(t_ensemble_forward(fn, xs, 0, chunk=3), xs * 2 + 6)
    with pytest.raises(ValueError):
        t_ensemble_forward(fn, xs, 0, chunk=4)


def test_make_estimator_registry():
    est = t_make_estimator(TEstimatorConfig(name="uncertainty_zigzag_centered"))
    assert est.keywords["cfg"].predict_next  # forced, as in the reference
    assert t_make_estimator(TEstimatorConfig(name="infer_noise")).func.__name__ == "infer_noise"  # ported
    with pytest.raises(KeyError, match="unknown"):
        t_make_estimator(TEstimatorConfig(name="nope"))


def test_sampler_window_and_guidance_interface():
    sched = t_make_schedule(device="cpu")
    est = t_make_estimator(TEstimatorConfig(name="uncertainty_centered", M=2))
    cfg = TSamplerConfig(num_inference_steps=20, after_step=5, num_steps_uc=4)
    res = t_sample_ddim(lambda x, t, _: 0.1 * x, sched, torch.ones(SHAPE), TorchNoise(0, device="cpu"), cfg, estimator=est, collect_intermediates=True)
    assert res.uncertainty.shape == res.pred_epsilon.shape == (4,) + SHAPE
    np.testing.assert_array_equal(res.window_timesteps, spaced_timesteps(1000, 20)[5:9])
    assert res.intermediates.shape == (20,) + SHAPE
    plain = t_sample_ddim(lambda x, t, _: 0.1 * x, sched, torch.ones(SHAPE), TorchNoise(0, device="cpu"), TSamplerConfig(num_inference_steps=20))
    assert plain.uncertainty is None and torch.equal(plain.sample, res.sample)
    # a guidance takes the estimator's place in the window and sets x_{t-1}
    guided = t_sample_ddim(lambda x, t, _: 0.1 * x, sched, torch.ones(SHAPE), TorchNoise(0, device="cpu"), cfg,
                           guidance=TGuidance(lambda x: None, lambda m, s, st, n, aux: (st.prev_sample, torch.ones_like(st.sample), aux)))
    assert torch.equal(guided.sample, plain.sample) and bool((guided.uncertainty == 1).all())
