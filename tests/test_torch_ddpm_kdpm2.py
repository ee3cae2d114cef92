"""The DDPM and KDPM2 samplers of the port against the JAX package, float32 on
the CPU.

* ``ddpm_step`` and ``posterior_log_variance`` for every variance type and
  prediction type, with and without thresholding: max |port - JAX| <= 1e-6
  of max |JAX| (the same float32 formulas on both sides; what differs is the
  rounding of a fused or reordered product, a few ulps).
* ``sample_ddpm`` on the tiny ADM (taken through ``models/convert.py``),
  started at t=500 (``num_train_timesteps`` 600 over 6 leading steps: t =
  500, 400, ..., 0 on the 1000-step schedule), with the step noise the JAX
  run drew replayed by repeating its ``split(k, 4)`` chain: without a
  window, with an ``uncertainty_centered`` window (the estimator's draw
  replayed as ``tests/test_torch_estimators.py`` does), and with
  ``learned_range`` on the model's 6-channel output (the estimator's
  ensemble on the ε channels). Samples and maps within relative L2 1e-4;
  they read about 1.4e-6 and 5e-6 (float32 forwards differ by about 5e-6,
  and six ancestral steps from t=500 do not amplify it).
* ``_tables`` equal to JAX's exactly, and ``sample_kdpm2`` on the same model
  (five steps from sigma_max = 157) within relative L2 1e-4 of JAX, with
  2n model calls at the tables' timesteps. The float32 carry holds x·157, so
  one rounding of it is about 1e-5 of a unit sample; the chains read 9e-7
  (epsilon) and 3.6e-5 (sample prediction, whose x0 is the raw output).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, make_adm_state_dict, torch_state_dict

import diffusion_uncertainty_torch.diffusion.kdpm2 as tk
import diffusion_uncertainty_tpu.diffusion.kdpm2 as jk
from diffusion_uncertainty_torch.diffusion import DiffusionConfig as TDiffusionConfig
from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import cosine_schedule as t_cosine_schedule
from diffusion_uncertainty_torch.diffusion import ddpm_step as t_ddpm_step
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.diffusion import posterior_log_variance as t_posterior_log_variance
from diffusion_uncertainty_torch.diffusion import sample_ddpm as t_sample_ddpm
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_tpu.diffusion import DiffusionConfig, SamplerConfig, cosine_schedule, ddpm_step
from diffusion_uncertainty_tpu.diffusion import make_schedule, posterior_log_variance, sample_ddpm
from diffusion_uncertainty_tpu.diffusion.schedule import uncertainty_window
from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet
from diffusion_uncertainty_tpu.uncertainty import EstimatorConfig, make_estimator

VARIANCE_TYPES = ("fixed_small", "fixed_small_log", "fixed_large", "learned", "learned_range")
SHAPE = (2, 8, 8, 3)
STEP_TOL = 1e-6  # times max |JAX|
CHAIN_TOL = 1e-4  # relative L2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU shapes: one intra-op thread, so the test workers sharing the
    cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want, tol=STEP_TOL) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def _schedules(kind):
    if kind == "linear":
        return make_schedule("linear", 1000), t_make_schedule("linear", 1000, device="cpu")
    return make_schedule(trained_betas=cosine_schedule(1000)), t_make_schedule(trained_betas=t_cosine_schedule(1000), device="cpu")


# (t, t_prev): early, mid, the last leading step (t_prev < 0)
STEPS = ((980, 960), (500, 400), (20, -30))


@pytest.mark.parametrize("variance_type", VARIANCE_TYPES)
def test_posterior_log_variance_matches_jax(variance_type):
    rng = np.random.RandomState(1)
    v = rng.uniform(-1.2, 1.2, SHAPE).astype(np.float32)
    for kind in ("linear", "cosine"):
        js, ts = _schedules(kind)
        for t, tp in STEPS:
            pv = v if variance_type.startswith("learned") else None
            want = np.asarray(posterior_log_variance(js, jnp.int32(t), jnp.int32(tp), variance_type,
                                                     None if pv is None else jnp.asarray(pv)))
            got = t_posterior_log_variance(ts, t, tp, variance_type, None if pv is None else torch.from_numpy(pv)).numpy()
            assert got.shape == want.shape and close(got, want), (kind, t, tp)


def test_posterior_log_variance_rejects_missing_channels():
    _, ts = _schedules("linear")
    with pytest.raises(ValueError, match="variance channels"):
        t_posterior_log_variance(ts, 500, 400, "learned_range")
    with pytest.raises(ValueError, match="unknown variance_type"):
        t_posterior_log_variance(ts, 500, 400, "nope")


@pytest.mark.parametrize("variance_type", VARIANCE_TYPES)
@pytest.mark.parametrize("dcfg", [
    {}, {"prediction_type": "sample"}, {"prediction_type": "v_prediction"},
    {"thresholding": True, "sample_max_value": 1.5}, {"clip_sample": False},
], ids=["epsilon", "sample", "v_prediction", "thresholding", "no_clip"])
def test_ddpm_step_matches_jax(variance_type, dcfg):
    rng = np.random.RandomState(2)
    x = (rng.randn(*SHAPE) * 1.5).astype(np.float32)
    out = rng.randn(*SHAPE).astype(np.float32)
    nz = rng.randn(*SHAPE).astype(np.float32)
    pv = rng.uniform(-1.0, 1.0, SHAPE).astype(np.float32) if variance_type.startswith("learned") else None
    js, ts = _schedules("linear")
    jcfg, tcfg = DiffusionConfig(**dcfg), TDiffusionConfig(**dcfg)
    for t, tp in STEPS:
        want = ddpm_step(js, jnp.asarray(x), jnp.asarray(out), jnp.int32(t), jnp.int32(tp), jcfg, noise=jnp.asarray(nz),
                         variance_type=variance_type, predicted_variance=None if pv is None else jnp.asarray(pv))
        got = t_ddpm_step(ts, torch.from_numpy(x), torch.from_numpy(out), t, tp, tcfg, noise=torch.from_numpy(nz),
                          variance_type=variance_type, predicted_variance=None if pv is None else torch.from_numpy(pv))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and close(g.numpy(), w), (t, tp)
        if tp < 0:  # the chain's end adds no noise
            quiet = t_ddpm_step(ts, torch.from_numpy(x), torch.from_numpy(out), t, tp, tcfg, variance_type=variance_type,
                                predicted_variance=None if pv is None else torch.from_numpy(pv))
            assert torch.equal(quiet.prev_sample, got.prev_sample)


def test_ddpm_step_keeps_the_sample_type():
    _, ts = _schedules("linear")
    x = torch.randn(SHAPE).to(torch.bfloat16)
    step = t_ddpm_step(ts, x, torch.randn(SHAPE), 500, 400, TDiffusionConfig(), noise=torch.randn(SHAPE))
    assert step.prev_sample.dtype == torch.bfloat16 and step.pred_original_sample.dtype == torch.float32


@pytest.fixture(scope="module")
def models():
    """(JAX model, its parameters, the port's model) for 3 and 6 output channels."""
    out = {}
    for ch in (3, 6):
        jcfg = dataclasses.replace(ADMUNetConfig.tiny(), out_channels=ch)
        sd = make_adm_state_dict(jcfg, seed=10 + ch)
        tm = TADMUNet(dataclasses.replace(TADMUNetConfig.tiny(), out_channels=ch)).eval().requires_grad_(False)
        tm.load_state_dict(torch_state_dict(sd))
        out[ch] = (ADMUNet(jcfg), convert_adm_unet(sd, jcfg), tm)
    return out


def jax_ddpm_noise(key, shape, n, after_step=0, num_steps_uc=0, M=0):
    """The standard-normal draws of the JAX ``sample_ddpm``, in the port's
    order: per step the ancestral noise from ``k_n`` of ``split(k, 4)``
    (``sampler.py:224-229``), then in the window the centered estimator's
    [M, *shape] draw from the first half of ``k_est`` (``estimators.py:104-108``)."""
    w0, w1 = uncertainty_window(after_step, num_steps_uc, n) if num_steps_uc else (0, 0)
    draws = []
    for i in range(n):
        key, _, k_n, k_est = jax.random.split(key, 4)
        draws.append(np.asarray(jax.random.normal(k_n, shape, jnp.float32)))
        if w0 <= i < w1:
            k_noise, _ = jax.random.split(k_est)
            draws.append(np.asarray(jax.random.normal(k_noise, (M,) + tuple(shape), jnp.float32)))
    return draws


# 6 leading steps of 100 over the first 600 timesteps: t = 500, 400, ..., 0
N, T_TRAIN = 6, 600


@pytest.mark.parametrize("variance_type,window", [
    ("fixed_small", False), ("fixed_small", True), ("fixed_large", False), ("learned_range", False), ("learned_range", True),
])
def test_sample_ddpm_matches_jax(models, variance_type, window):
    ch = 6 if variance_type.startswith("learned") else 3
    jm, jp, tm = models[ch]
    rng = np.random.RandomState(20)
    x_T, y = rng.randn(2, 16, 16, 3).astype(np.float32), np.array([3, 7])
    after, n_uc, M = (3, 2, 3) if window else (0, 0, 0)
    key = jax.random.key(21)
    jcfg = SamplerConfig(num_inference_steps=N, num_train_timesteps=T_TRAIN, after_step=after, num_steps_uc=n_uc,
                         start_step=2)  # ignored, as the port ignores it
    jest = make_estimator(EstimatorConfig(name="uncertainty_centered", M=M)) if window else None
    # the estimator's ensemble reads ε only: the variance channels sliced off
    ref = jax.jit(lambda p, x, k: sample_ddpm(lambda xx, tt, kk: jm.apply(p, xx, tt, jnp.asarray(y)),
                                              make_schedule("linear", 1000), x, k, jcfg, variance_type=variance_type,
                                              estimator=jest,
                                              estimator_model_fn=lambda xx, tt, kk: jm.apply(p, xx, tt, jnp.asarray(y))[..., :3]),
                  )(jp, jnp.asarray(x_T), key)

    draws = jax_ddpm_noise(key, x_T.shape, N, after, n_uc, M)
    noise, calls = ReplayNoise(draws), []
    yt = torch.from_numpy(y)

    def model_fn(x, t, nz):
        calls.append((t, nz))
        return tm(x, t, yt)

    tcfg = TSamplerConfig(num_inference_steps=N, num_train_timesteps=T_TRAIN, after_step=after, num_steps_uc=n_uc,
                          start_step=2)
    test = t_make_estimator(TEstimatorConfig(name="uncertainty_centered", M=M)) if window else None
    res = t_sample_ddpm(model_fn, t_make_schedule("linear", 1000, device="cpu"), torch.from_numpy(x_T), noise, tcfg,
                        variance_type=variance_type, estimator=test,
                        estimator_model_fn=lambda x, t, nz: model_fn(x, t, nz)[..., :3])
    assert noise.used == len(draws) == N + n_uc
    traj = [t for t, nz in calls if nz is None]
    assert traj[:N] == list(range(500, -1, -100))  # the trajectory forward gets None
    assert res.pred_epsilon is None and res.sample.shape == x_T.shape
    assert rel_l2(res.sample.numpy(), ref.sample) <= CHAIN_TOL
    if window:
        np.testing.assert_array_equal(res.window_timesteps, ref.window_timesteps)
        assert res.uncertainty.shape == (n_uc,) + x_T.shape
        assert rel_l2(res.uncertainty.numpy(), ref.uncertainty) <= CHAIN_TOL
    else:
        assert res.uncertainty is None and ref.uncertainty is None and res.window_timesteps is None


@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing"])
def test_kdpm2_tables_equal_jax(spacing):
    for kind in ("linear", "cosine"):
        js, ts = _schedules(kind)
        for n in (1, 5, 10, 50):
            cfg = dict(num_inference_steps=n, timestep_spacing=spacing)
            want = jk._tables(js, jk.KDPM2Config(**cfg))
            got = tk._tables(ts, tk.KDPM2Config(**cfg))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), (kind, n)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample"])
def test_sample_kdpm2_matches_jax(models, prediction_type):
    jm, jp, tm = models[3]
    rng = np.random.RandomState(30)
    x_T, y = rng.randn(2, 16, 16, 3).astype(np.float32), np.array([1, 9])
    n = 5
    jcfg = jk.KDPM2Config(num_inference_steps=n, prediction_type=prediction_type)
    jsched = make_schedule("linear", 1000)  # outside the jit: the tables are built on the host
    ref = jax.jit(lambda p, x, k: jk.sample_kdpm2(lambda xx, tt, kk: jm.apply(p, xx, tt, jnp.asarray(y)), jsched, x, k,
                                                  jcfg))(jp, jnp.asarray(x_T), jax.random.key(0))
    tcfg = tk.KDPM2Config(num_inference_steps=n, prediction_type=prediction_type)
    yt = torch.from_numpy(y)
    calls = []

    def model_fn(x, t, nz):
        calls.append((x.dtype, t, nz))
        return tm(x, t, yt)

    res = tk.sample_kdpm2(model_fn, t_make_schedule("linear", 1000, device="cpu"), torch.from_numpy(x_T), ReplayNoise([]), tcfg)
    assert len(calls) == 2 * n and all(dt == torch.float32 and nz is None for dt, _, nz in calls)
    ts, _, _, t_mid = tk._tables(t_make_schedule("linear", 1000, device="cpu"), tcfg)
    assert [t for _, t, _ in calls] == [int(v) for pair in zip(ts, np.round(t_mid).astype(int)) for v in pair]
    assert res.sample.dtype == torch.float32 and res.uncertainty is None
    assert rel_l2(res.sample.numpy(), ref.sample) <= CHAIN_TOL


def test_sample_kdpm2_rejects_unknown_prediction_type():
    with pytest.raises(ValueError):
        tk.sample_kdpm2(lambda x, t, nz: x, t_make_schedule("linear", 1000, device="cpu"), torch.zeros(1, 2, 2, 3), None,
                        tk.KDPM2Config(num_inference_steps=2, prediction_type="v_prediction"))
