"""The DPM-Solver++ sampler of the port against the JAX package, float32 on
the CPU: the host tables (``_tables``), the chain on an analytic model for
orders 1-3, the tiny ADM with the centered window on the JAX run's draws,
and ``generate_uncertainty_dataset(sampler="dpm")`` shard for shard.

Tolerances: tables exact (timesteps, orders) or within 1e-12 (σ, α, λ:
both sides compute them in float64 from the same float32 ᾱ); the analytic
chain within 1e-4 of the largest reference value (the first step's
x0 = (x − σ·ε)/α cancels to α·x0 and divides by α_999 ≈ 0.0064, so one
float32 rounding of x, fused or not, moves x0 by about 1e-5); the tiny
ADM's chains, which start at t=999, within relative L2 1e-4 for samples,
maps and ε (five DPM steps amplify the float32 differences of the UNet
forward, ROADMAP.md section 3), and the dataset run's uint8 images within
one step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import ReplayNoise, jax_guidance_noise, make_adm_state_dict, torch_state_dict

import diffusion_uncertainty_torch.diffusion.dpm_solver as tdpm
import diffusion_uncertainty_tpu.diffusion.dpm_solver as jdpm
from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import cosine_schedule as t_cosine_schedule
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.sampling import generate_uncertainty_dataset as t_generate
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_torch.utils.experiments import load_run_arrays
from diffusion_uncertainty_tpu.diffusion.sampler import SamplerConfig
from diffusion_uncertainty_tpu.diffusion.schedule import cosine_schedule, make_schedule
from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet
from diffusion_uncertainty_tpu.sampling import generate_uncertainty_dataset
from diffusion_uncertainty_tpu.uncertainty import EstimatorConfig, make_estimator
from diffusion_uncertainty_tpu.utils.rng import batch_key, run_key

SHAPE = (2, 8, 8, 3)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _schedules():
    """(JAX, port) linear (ADM-128) and cosine (ADM-64) schedules."""
    yield make_schedule("linear", 1000), t_make_schedule("linear", 1000, device="cpu")
    yield (make_schedule(trained_betas=cosine_schedule(1000)),
           t_make_schedule(trained_betas=t_cosine_schedule(1000), device="cpu"))


@pytest.mark.parametrize("final", ["zero", "sigma_min"])
@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing", "karras"])
def test_tables_match_jax(spacing, final):
    for jsched, tsched in _schedules():
        for n in (5, 10, 20):
            for order in (1, 2, 3):
                kw = dict(num_inference_steps=n, solver_order=order, final_sigmas_type=final, steps_offset=1)
                kw.update(use_karras_sigmas=True) if spacing == "karras" else kw.update(timestep_spacing=spacing)
                want = jdpm._tables(jsched, jdpm.DPMSolverConfig(**kw))
                got = tdpm._tables(tsched, tdpm.DPMSolverConfig(**kw))
                where = (spacing, final, n, order)
                for i in (0, 5):  # timesteps, orders
                    assert got[i].dtype == want[i].dtype and np.array_equal(got[i], want[i]), where
                for i in (1, 2, 3, 4):  # sigma, alpha_t, sigma_t, lambda_t
                    np.testing.assert_allclose(got[i], want[i], rtol=1e-12, atol=0, err_msg=str(where))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_analytic_chain_matches_jax(order):
    """The constant-ε oracle of ``tests/test_dpm_solver.py`` (x_T made from
    x0 and ε at t=999), no window: the same sample, and it lands on x0."""
    k1, k2 = jax.random.split(jax.random.key(order))
    x0 = jax.random.uniform(k1, SHAPE, minval=-0.8, maxval=0.8)
    eps = jax.random.normal(k2, SHAPE)
    jsched = make_schedule("linear", 1000)
    ab = jsched.alphas_cumprod[999]
    x_T = jnp.sqrt(ab) * x0 + jnp.sqrt(1 - ab) * eps
    cfg = dict(num_inference_steps=12, solver_order=order)
    ref = np.asarray(jdpm.sample_dpm_solver(lambda x, t, k: eps, jsched, x_T, jax.random.key(9),
                                            jdpm.DPMSolverConfig(**cfg)).sample)
    teps = torch.from_numpy(np.array(eps))
    res = tdpm.sample_dpm_solver(lambda x, t, nz: teps, t_make_schedule("linear", 1000, device="cpu"),
                                 torch.from_numpy(np.array(x_T)), ReplayNoise([]), tdpm.DPMSolverConfig(**cfg))
    assert res.uncertainty is None and res.window_timesteps is None
    np.testing.assert_allclose(res.sample.numpy(), ref, atol=1e-4 * float(np.abs(ref).max()), rtol=0)
    np.testing.assert_allclose(res.sample.numpy(), np.asarray(x0), atol=5e-3)


def _tiny_adm(seed):
    jcfg, tcfg = ADMUNetConfig.tiny(), TADMUNetConfig.tiny()
    sd = make_adm_state_dict(jcfg, seed=seed)
    model = TADMUNet(tcfg).eval().requires_grad_(False)
    model.load_state_dict(torch_state_dict(sd))
    return ADMUNet(jcfg), convert_adm_unet(sd, jcfg), model


@pytest.mark.parametrize("order", [2, 3])
def test_tiny_adm_window_matches_jax(order):
    """Five DPM steps of the tiny ADM with ``uncertainty_centered`` (M=3) on
    steps [2, 5), the JAX run's draws replayed: sample, maps and ε."""
    jm, jp, tm = _tiny_adm(seed=3)
    rng = np.random.RandomState(4)
    x_T, y = rng.randn(2, 16, 16, 3).astype(np.float32), np.array([4, 8])
    n, after, n_uc, M = 5, 2, 3, 3
    key = jax.random.key(12)
    jcfg = jdpm.DPMSolverConfig(num_inference_steps=n, solver_order=order, after_step=after, num_steps_uc=n_uc)
    ref = jdpm.sample_dpm_solver(lambda x, t, k: jm.apply(jp, x, t, jnp.asarray(y)), make_schedule("linear", 1000),
                                 jnp.asarray(x_T), key, jcfg,
                                 estimator=make_estimator(EstimatorConfig(name="dpm_2_uncertainty_centered", M=M)))
    noise = ReplayNoise(jax_guidance_noise(key, x_T.shape, n, after, n_uc, M))
    tcfg = tdpm.DPMSolverConfig(num_inference_steps=n, solver_order=order, after_step=after, num_steps_uc=n_uc)
    yt = torch.from_numpy(y)
    res = tdpm.sample_dpm_solver(lambda x, t, nz: tm(x, t, yt), t_make_schedule("linear", 1000, device="cpu"),
                                 torch.from_numpy(x_T), noise, tcfg,
                                 estimator=t_make_estimator(TEstimatorConfig(name="dpm_2_uncertainty_centered", M=M)))
    assert noise.used == n_uc and res.uncertainty.shape == (n_uc, 2, 16, 16, 3)
    np.testing.assert_array_equal(res.window_timesteps, ref.window_timesteps)
    for got, want in ((res.sample, ref.sample), (res.uncertainty, ref.uncertainty), (res.pred_epsilon, ref.pred_epsilon)):
        assert rel_l2(got.numpy(), want) <= 1e-4


def test_generate_uncertainty_dataset_dpm_matches_jax(tmp_path):
    """``sampler="dpm"`` through both packages' generation loops: the tiny ADM
    (labels), ``dpm_2_uncertainty_centered`` M=2, 5 steps, window [2, 4), 3
    images in batches of 2, each batch's JAX draws replayed: the same files,
    images within one uint8 step, maps and scores within rel L2 1e-4."""
    jm, jp, tm = _tiny_adm(seed=5)
    rng = np.random.RandomState(6)
    x_t, y = rng.randn(3, 16, 16, 3).astype(np.float32), np.array([1, 5, 9])
    n, after, n_uc, M, seed = 5, 2, 2, 2, 3
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    generate_uncertainty_dataset(
        lambda p, x, t, yy, k: jm.apply(p, x, t, yy), make_schedule("linear", 1000),
        SamplerConfig(num_inference_steps=n, after_step=after, num_steps_uc=n_uc), x_t, y, 2, params=jp, seed=seed,
        estimator=make_estimator(EstimatorConfig(name="dpm_2_uncertainty_centered", M=M)), run_dir=jdir, sampler="dpm",
    )
    draws = {b: jax_guidance_noise(batch_key(run_key(seed), b), (2, 16, 16, 3), n, after, n_uc, M) for b in range(2)}
    sources = []

    def replay(s, device):
        sources.append(ReplayNoise(draws[s % 2**32]))
        return sources[-1]

    t_generate(
        lambda x, t, yy, nz: tm(x, t, yy), t_make_schedule("linear", 1000, device="cpu"),
        TSamplerConfig(num_inference_steps=n, after_step=after, num_steps_uc=n_uc), x_t, y, 2, seed=seed,
        estimator=t_make_estimator(TEstimatorConfig(name="dpm_2_uncertainty_centered", M=M)), run_dir=tdir,
        sampler="dpm", noise_factory=replay,
    )
    assert [s.used for s in sources] == [n_uc, n_uc]
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    np.testing.assert_array_equal(np.load(tdir / "timestep.npz")["data"], np.load(jdir / "timestep.npz")["data"])
    assert np.abs(load_run_arrays(tdir, "gen_images").astype(int) - load_run_arrays(jdir, "gen_images")).max() <= 1
    for name in ("uncertainty", "score"):
        for shard in (0, 1):
            got = np.load(tdir / f"{name}_{shard}.npz")["data"]
            want = np.load(jdir / f"{name}_{shard}.npz")["data"]
            assert got.shape == want.shape and rel_l2(got, want) <= 1e-4, (name, shard)
