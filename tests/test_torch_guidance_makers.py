"""The port's guidance makers against the JAX package's, on the tiny ADM,
float32 on the CPU, with the JAX draws replayed into the port.

Each maker runs a two-step window (t = 600, 550 of a 20-step table: global
steps 7 and 8) on the JAX side, its ``aux`` carried from step to step;
the port's maker, its own ``aux`` carried the same way, is given each of
JAX's step states in turn (teacher forcing: a window of each side's own
trajectory compounds the forwards' float32 rounding by about 3x a step,
ROADMAP.md section 3), and each window step's draws are the JAX key's,
replayed in the port's order (the ensemble's re-noise [M, *shape] first,
then the model's draws, then the second-order sign draw; the MC-dropout
gradient's member masks folded member-major per site). Tolerances, on
every step's map and x_{t-1} and on the carried momentum: the forward-only
makers max|port − JAX| <= 1e-5·max|JAX|; the gradient makers (MC-dropout,
model gradient, ``uncertainty_grad``, score model) <= 1e-4·max|JAX|,
``tests/test_torch_guidance.py``'s gradient tolerance scaled to the
output. The threshold guidance with the compat knobs is held at
1e-4·max|JAX|: ``compat_step_index_alpha`` reads ᾱ at the step index
(0.9993 at steps 7 and 8), so its re-noised inputs sit within 0.03 of x̂0 and
its map is the square of forward differences that the forwards' float32
rounding moves by 2e-5 of its largest value.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cifar import record_dropout_masks
from test_torch_estimators import Tiny, _close
from test_torch_helpers import ReplayNoise

from diffusion_uncertainty_torch.diffusion import DiffusionConfig as TDiffusionConfig
from diffusion_uncertainty_torch.diffusion import StepState as TStepState
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import guidance as tguid
from diffusion_uncertainty_torch.uncertainty import resolve_scheduler_transform as t_resolve
from diffusion_uncertainty_tpu.diffusion import DiffusionConfig, StepState, ddim_step, spaced_timesteps
from diffusion_uncertainty_tpu.uncertainty import ESTIMATORS, EstimatorConfig, resolve_scheduler_transform
from diffusion_uncertainty_tpu.uncertainty import guidance as jguid

M = 3
STEPS = 20
WINDOW = ((600, 550), (550, 500))  # global steps 7, 8
N_WIN = len(WINDOW)
OFFSET = 7
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU shapes: one intra-op thread, so the test workers sharing the
    cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ens(key, shape):
    """A maker that splits its key into (k_noise, k_model): one re-noise draw."""
    return [np.asarray(jax.random.normal(jax.random.split(key)[0], (M,) + shape, jnp.float32))]


def _second_order(key, shape):
    """k_est, k_sign = split(key): the ensemble's draw from k_est, then the sign."""
    k_est, k_sign = jax.random.split(key)
    return _ens(k_est, shape) + [np.asarray(jax.random.normal(k_sign, shape, jnp.float32))]


def _none(key, shape):
    return []


def _table(shape, scale, seed=0):
    """A per-step pixel-wise table [STEPS, H, W, C] around ``scale``."""
    return ((0.5 + np.random.RandomState(seed).rand(STEPS, *shape[1:])) * scale).astype(np.float32)


# name: (make(guidance module, EstimatorConfig class, u scale) -> guidance, draws(key, shape), tolerance)
CASES = {
    "threshold_quantile": (lambda g, E, s: g.make_threshold_guidance(M=M, threshold=0.8), _ens, FWD_TOL),
    "threshold_table": (lambda g, E, s: g.make_threshold_guidance(
        M=M, threshold=_table((2, 16, 16, 3), s), step_index_offset=OFFSET, num_window_steps=N_WIN), _ens, FWD_TOL),
    "threshold_compat": (lambda g, E, s: g.make_threshold_guidance(
        M=M, threshold=_table((2, 16, 16, 3), s, 1), threshold_type="lower", step_index_offset=OFFSET, num_window_steps=N_WIN,
        compat_step_index_alpha=True, compat_batch_sum=True), _ens, GRAD_TOL),
    "mask_binary": (lambda g, E, s: g.make_mask_guidance(E(name="infer_noise", M=M)), _ens, FWD_TOL),
    "flip_threshold": (lambda g, E, s: g.GUIDANCE_FACTORIES["flip_threshold"](), _none, FWD_TOL),
    "second_order": (lambda g, E, s: g.make_second_order_guidance(M=M, threshold=0.7), _second_order, FWD_TOL),
    "second_order_table": (lambda g, E, s: g.make_second_order_guidance(
        M=M, threshold=_table((2, 16, 16, 3), s, 2), step_index_offset=OFFSET, num_window_steps=N_WIN), _second_order,
        FWD_TOL),
    "model_gradient": (lambda g, E, s: g.make_model_gradient_guidance(M=M, lr=0.5), _ens, GRAD_TOL),
    "uncertainty_grad": (lambda g, E, s: g.make_uncertainty_grad_guidance(M=M), _ens, GRAD_TOL),
    "mc_dropout_gradient": (lambda g, E, s: g.make_mc_dropout_gradient_guidance(M=M, mix=0.5), None, GRAD_TOL),
}


def _run_jax(tiny, guid, est_fn, keys):
    """The window on the JAX side: [(state arrays, t, t_prev, x_{t-1}, u)]
    and the final aux; ``guid=None``: plain DDIM steps (x_{t-1} only)."""
    x = jnp.asarray(tiny.x)
    aux, steps = None if guid is None else guid.init(x), []
    for (t, tp), k in zip(WINDOW, keys):
        eps = tiny.jfn()(x, jnp.asarray(t), None)
        step = ddim_step(tiny.sched, x, eps, t, tp, DiffusionConfig())
        arrs = (x, step.pred_original_sample, step.pred_epsilon, step.prev_sample)
        u = None
        if guid is None:
            x = step.prev_sample
        else:
            x, u, aux = guid.apply(est_fn, tiny.sched, StepState(*arrs, jnp.asarray(t), jnp.asarray(tp)), k, aux)
        steps.append(([np.asarray(a) for a in arrs], t, tp, np.asarray(x), None if u is None else np.asarray(u)))
    return steps, aux


def _run_port(tiny, guid, est_fn, noise, steps):
    """The port's maker on JAX's step states: [(x_{t-1}, u)] and the final aux."""
    aux, outs = guid.init(torch.from_numpy(tiny.x)), []
    with torch.no_grad():
        for arrs, t, tp, _, _ in steps:
            x, u, aux = guid.apply(est_fn, tiny.tsched, TStepState(*(torch.from_numpy(a) for a in arrs), t, tp), noise, aux)
            outs.append((x, u))
    return outs, aux


def _check_steps(outs, steps, tol, case):
    for i, ((tx, tu), (_, _, _, jx, ju)) in enumerate(zip(outs, steps)):
        _close(tu, ju, tol, f"{case}: map of window step {i}")
        _close(tx, jx, tol, f"{case}: x_(t-1) of window step {i}")


@partial(jax.jit, static_argnums=0)
def _japply_dropout(model, params, x, t, y, key):
    return model.apply(params, x, t, y, deterministic=False, rngs={"dropout": key})


def _dropout_fns(tiny):
    y = jnp.asarray(tiny.y)
    jfn = lambda x, t, k: _japply_dropout(tiny.jmodel, tiny.params, x, t, y, k)  # noqa: E731
    tfn = lambda x, t, nz: tiny.tmodel(x, t, torch.from_numpy(tiny.y), noise=nz)  # noqa: E731
    return jfn, tfn


@pytest.mark.parametrize("case", sorted(CASES))
def test_guidance_window_matches_jax(monkeypatch, case):
    build, draws, tol = CASES[case]
    tiny = Tiny()
    keys = jax.random.split(jax.random.key(21), len(WINDOW))
    scale = 0.0
    if "table" in case or "compat" in case:  # thresholds around the first step's posterior u
        probe, _ = _run_jax(tiny, jguid.make_threshold_guidance(M=M, threshold=0.5), tiny.jfn(), keys[:1])
        scale = float(np.median(probe[0][4]))
    jg, tg = build(jguid, EstimatorConfig, scale), build(tguid, TEstimatorConfig, scale)
    j_est, t_est = tiny.jfn(), tiny.tfn()
    shape = tiny.x.shape
    if draws is None:  # the MC-dropout gradient: each member's masks, folded per site
        j_est, t_est = _dropout_fns(tiny)
        masks = []
        for k in keys:
            per_member = []
            for km in jax.random.split(k, M):
                rec = record_dropout_masks(monkeypatch)
                tiny.jmodel.apply(tiny.params, jnp.zeros(shape), jnp.asarray(500), jnp.asarray(tiny.y),
                                  deterministic=False, rngs={"dropout": km})
                per_member.append(rec.masks)
            masks += [np.concatenate(site) for site in zip(*per_member)]
        monkeypatch.undo()  # the recorder off before the vmapped JAX run
        noise = ReplayNoise([], masks)
    else:
        noise = ReplayNoise([d for k in keys for d in draws(k, shape)])
    steps, jaux = _run_jax(tiny, jg, j_est, keys)
    outs, taux = _run_port(tiny, tg, t_est, noise, steps)
    assert noise.used == len(noise.draws) and noise.masks_used == len(noise.masks)
    _check_steps(outs, steps, tol, case)
    assert np.abs(steps[-1][3] - _run_jax(tiny, None, None, keys)[0][-1][3]).max() > 1e-4  # the guidance moved x
    if case.startswith("threshold"):
        assert taux == int(jaux) == N_WIN
    if case.startswith("second_order"):
        assert taux["step"] == int(jaux["step"]) == N_WIN
        _close(taux["momentum"], jaux["momentum"], tol, f"{case}: momentum")


def test_mask_multiscale_levels_match_jax():
    """The multiscale mask (1.0 / 0.9 / 0.8 on the z-normalised map) on an
    analytic model, eps = w·x with a left-skewed w² and M=16 members, so the
    map has pixels at every level (a model's variance map rarely falls 1 std
    below its mean): one step, both sides on the same state and draw."""
    rng = np.random.RandomState(4)
    shape, m = (2, 16, 16, 3), 16
    w = np.sqrt(np.clip(10.0 - rng.exponential(2.0, shape), 0.05, None)).astype(np.float32)
    x, x0, eps, prev = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    key = jax.random.key(9)
    draw = np.asarray(jax.random.normal(jax.random.split(key)[0], (m,) + shape, jnp.float32))
    tiny = Tiny()
    jg = jguid.GUIDANCE_FACTORIES["multiscale_threshold"](EstimatorConfig(name="infer_noise", M=m))
    tg = tguid.GUIDANCE_FACTORIES["multiscale_threshold"](TEstimatorConfig(name="infer_noise", M=m))
    jstate = StepState(*(jnp.asarray(a) for a in (x, x0, eps, prev)), jnp.asarray(600), jnp.asarray(550))
    tstate = TStepState(*(torch.from_numpy(a) for a in (x, x0, eps, prev)), 600, 550)
    jx, ju, _ = jg.apply(lambda z, t, k: z * jnp.asarray(w), tiny.sched, jstate, key, None)
    tw = torch.from_numpy(w)
    tx, tu, _ = tg.apply(lambda z, t, nz: z * tw.repeat(z.shape[0] // 2, 1, 1, 1), tiny.tsched, tstate, ReplayNoise([draw]), None)
    ju = np.asarray(ju)
    assert ((ju < -1) & (ju > -2)).sum() > 10 and ((ju < -2) & (ju > -3)).sum() > 5
    _close(tu, ju, FWD_TOL, "map")
    _close(tx, jx, FWD_TOL, "x_(t-1)")


def test_short_threshold_table_raises():
    table = np.zeros((OFFSET + N_WIN - 1, 16, 16, 3), np.float32)  # misses the window's last global step
    for g in (jguid, tguid):
        for maker in (g.make_threshold_guidance, g.make_second_order_guidance):
            with pytest.raises(ValueError, match=f"per-step threshold table has {OFFSET + N_WIN - 1} rows"):
                maker(M=M, threshold=table, step_index_offset=OFFSET, num_window_steps=N_WIN)


@pytest.mark.parametrize("normalize_grad", [False, True])
def test_score_model_gradient_matches_jax(normalize_grad):
    """A small analytic surrogate u = (1 + step) · Σ_c ε² / C in place of the
    trained ScoreUncertaintyModel (which waits for the port of training)."""
    tiny = Tiny()
    ts = spaced_timesteps(1000, STEPS)
    jg = jguid.make_score_model_gradient_guidance(
        lambda e, idx: jnp.mean(e**2, axis=-1, keepdims=True) * (1.0 + idx[:, None, None, None]), ts, normalize_grad)
    tg = tguid.make_score_model_gradient_guidance(
        lambda e, idx: torch.mean(e**2, dim=-1, keepdim=True) * (1.0 + idx[:, None, None, None]), ts, normalize_grad)
    steps, _ = _run_jax(tiny, jg, tiny.jfn(), jax.random.split(jax.random.key(0), len(WINDOW)))
    outs, _ = _run_port(tiny, tg, tiny.tfn(), ReplayNoise([]), steps)
    _check_steps(outs, steps, GRAD_TOL, "score model")


def test_guidance_factories_have_jax_keys():
    assert sorted(tguid.GUIDANCE_FACTORIES) == sorted(jguid.GUIDANCE_FACTORIES)


def test_resolve_scheduler_transform_matches_jax():
    """Every JAX scheduler name resolves to the same kind of transform;
    ``uncertainty_grad`` to the guidance (one window step of it is held to
    JAX in ``test_guidance_window_matches_jax[uncertainty_grad]``)."""
    ts = spaced_timesteps(1000, STEPS)
    for name in ESTIMATORS:
        j_est, j_guid = resolve_scheduler_transform(EstimatorConfig(name=name, M=M), timesteps=ts)
        t_est, t_guid = t_resolve(TEstimatorConfig(name=name, M=M), timesteps=ts, dcfg=TDiffusionConfig(eta=0.5))
        assert (t_est is None, t_guid is None) == (j_est is None, j_guid is None), name
        assert (t_guid is not None) == (name == "uncertainty_grad")
        assert isinstance(t_guid, (tguid.Guidance, type(None)))
