"""The port's estimators against the JAX package's, on the tiny ADM (16²,
activation-noise sites ``in_1`` and ``out_1``), float32 on the CPU, with the
JAX draws replayed into the port (``test_torch_helpers.ReplayNoise``).

* Activation noise: JAX draws one site tensor per member per site with each
  member's key (``jax.random.split(key, M)`` under ``vmap``); the port's
  folded forward draws one [M·B, ...] tensor per site. ``record_act_noise``
  records each member's draws with one un-vmapped JAX forward per key and
  the test stacks them member-major, site by site.
* Tolerances: forward-only estimators max|port − JAX| <= 1e-5·max|JAX|
  (both sides float32; a tiny-ADM forward differs by about 5e-6 on outputs
  of about 2); the gradient estimators (``grad_based``, ``flip_grad``)
  <= 1e-4·max|JAX|. The activation-noise estimator runs with
  ``activation_noise_std`` 0.5 on both sides: at the default 0.01 its map is
  the square of a 0.07 difference of two forwards, which the float32
  rounding of the forwards (6e-6) moves by 2e-4 of its largest value; the
  default std is held in the forward test, output within 1e-5·max and the
  noise's effect (noisy − clean forward) within 1e-3 of its largest value.
"""

from __future__ import annotations

import dataclasses
import subprocess
from functools import partial
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_helpers import ReplayNoise, make_adm_state_dict, torch_state_dict

import diffusion_uncertainty_tpu.models.adm_unet as jadm
from diffusion_uncertainty_torch.diffusion import StepState as TStepState
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.kernels import attention as katt
from diffusion_uncertainty_torch.kernels import avgpool as kpool
from diffusion_uncertainty_torch.kernels import groupnorm as kgn
from diffusion_uncertainty_torch.kernels import interleave as kilv
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.uncertainty import ESTIMATORS as T_ESTIMATORS
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_torch.uncertainty import make_flip_grad_estimator as t_make_flip_grad
from diffusion_uncertainty_tpu.diffusion import DiffusionConfig, StepState, ddim_step, make_schedule, spaced_timesteps
from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet
from diffusion_uncertainty_tpu.uncertainty import ESTIMATORS, EstimatorConfig, make_estimator
from diffusion_uncertainty_tpu.uncertainty.estimators import make_flip_grad_estimator

REPO = Path(__file__).resolve().parents[1]
M = 3
STEPS = 20  # the inference table: 950, 900, ..., 0
T, T_PREV = 600, 550
FWD_TOL = 1e-5  # forward-only, times max|JAX|
GRAD_TOL = 1e-4  # gradient estimators, times max|JAX|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU shapes: one intra-op thread, so the test workers sharing the
    cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class record_act_noise:
    """Wraps the JAX ``ADMUNet._maybe_noise`` so each activation-noise site
    records the standard-normal draw it makes (the same ``make_rng`` key and
    ``jax.random.normal`` call), in forward order."""

    def __init__(self, monkeypatch):
        self.draws = []

        def rec(mod, h, tag):
            cfg = mod.cfg
            if tag in cfg.activation_noise_blocks and mod.has_rng("act_noise"):
                n = jax.random.normal(mod.make_rng("act_noise"), h.shape, jnp.float32)
                self.draws.append(np.asarray(n))
                h = h + cfg.activation_noise_std * n.astype(h.dtype)
            if cfg.grad_taps:
                h = mod.perturb(f"tap_{tag}", h)
            return h

        monkeypatch.setattr(jadm.ADMUNet, "_maybe_noise", rec)


@partial(jax.jit, static_argnums=0)
def _japply(model, params, x, t, y):
    return model.apply(params, x, t, y)


class Tiny:
    """The tiny ADM on both sides with the same seeded reference weights, and
    a step state built from the JAX model's ε at x_t (DDIM, clipped x0)."""

    def __init__(self, seed=3, batch=2, **over):
        self.jcfg = dataclasses.replace(ADMUNetConfig.tiny(), **over)
        self.tcfg = dataclasses.replace(TADMUNetConfig.tiny(), **{k: v for k, v in over.items() if k != "grad_taps"})
        sd = make_adm_state_dict(self.jcfg, seed=seed)
        self.params = convert_adm_unet(sd, self.jcfg)
        self.jmodel = ADMUNet(self.jcfg)
        self.tmodel = TADMUNet(self.tcfg).eval().requires_grad_(False)
        self.tmodel.load_state_dict(torch_state_dict(sd))
        rng = np.random.RandomState(seed + 1)
        self.x = rng.randn(batch, 16, 16, 3).astype(np.float32)
        self.y = rng.randint(0, 10, size=batch)
        self.sched, self.tsched = make_schedule("linear", 1000), t_make_schedule("linear", 1000, device="cpu")

    def jfn(self, rngs=None):
        y = jnp.asarray(self.y)
        if rngs is None:  # jitted: the deterministic forward serves most tests
            return lambda x, t, k: _japply(self.jmodel, self.params, x, t, y)
        return lambda x, t, k: self.jmodel.apply(self.params, x, t, y, rngs={rngs: k})

    def tfn(self, act_noise=False):
        y = torch.from_numpy(self.y)
        if act_noise:
            return lambda x, t, nz: self.tmodel(x, t, y, act_noise=nz)
        return lambda x, t, nz: self.tmodel(x, t, y)

    def states(self, t=T, t_prev=T_PREV, x=None):
        x = self.x if x is None else x
        eps = np.asarray(self.jfn()(jnp.asarray(x), jnp.asarray(t), None))
        step = ddim_step(self.sched, jnp.asarray(x), jnp.asarray(eps), t, t_prev, DiffusionConfig())
        arrs = [x] + [np.asarray(a) for a in (step.pred_original_sample, step.pred_epsilon, step.prev_sample)]
        jstate = StepState(*(jnp.asarray(a) for a in arrs), jnp.asarray(t), jnp.asarray(t_prev))
        return jstate, TStepState(*(torch.from_numpy(a) for a in arrs), t, t_prev)


def member_act_noise(monkeypatch, tiny: Tiny, xs, t, keys):
    """Each member's site draws (one un-vmapped JAX forward per key),
    stacked member-major per site: the port's draws for one folded forward."""
    per_member = []
    for x, k in zip(xs, keys):
        rec = record_act_noise(monkeypatch)
        tiny.jfn("act_noise")(jnp.asarray(x), jnp.asarray(t), k)
        per_member.append(rec.draws)
    return [np.concatenate(site) for site in zip(*per_member)]


def _close(got, want, tol, what=""):
    """max|got − want| <= tol·max|want|, shapes equal."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * float(np.abs(want).max()), rtol=0, err_msg=what)


def test_registry_has_every_jax_name():
    assert sorted(T_ESTIMATORS) == sorted(ESTIMATORS)
    ts = spaced_timesteps(1000, STEPS)
    for name in ESTIMATORS:
        assert callable(t_make_estimator(TEstimatorConfig(name=name), timesteps=ts))
    with pytest.raises(ValueError, match="timestep table"):
        t_make_estimator(TEstimatorConfig(name="uncertainty_centered_d"))
    with pytest.raises(KeyError, match="unknown"):
        t_make_estimator(TEstimatorConfig(name="flip_grad"))


def test_act_noise_forward_matches_jax(monkeypatch):
    """The tiny ADM's act-noise forward at the default std (0.01), the JAX
    draws replayed: one draw per site, in block order, of the site's shape."""
    tiny = Tiny()
    assert tiny.tcfg.activation_noise_blocks == tiny.jcfg.activation_noise_blocks == ("in_1", "out_1")
    assert tiny.tcfg.activation_noise_std == tiny.jcfg.activation_noise_std == 0.01
    x, t, key = jnp.asarray(tiny.x), jnp.asarray(T), jax.random.key(5)
    rec = record_act_noise(monkeypatch)
    noisy = np.asarray(tiny.jfn("act_noise")(x, t, key))
    clean = np.asarray(tiny.jfn()(x, t, None))
    assert [d.shape for d in rec.draws] == [(2, 16, 16, 32), (2, 8, 8, 64)]
    noise = ReplayNoise(rec.draws)
    with torch.no_grad():
        t_noisy = tiny.tfn(act_noise=True)(torch.from_numpy(tiny.x), T, noise)
        t_clean = tiny.tfn()(torch.from_numpy(tiny.x), T, None)
    assert noise.used == 2
    _close(t_noisy, noisy, FWD_TOL)
    _close(t_noisy - t_clean, noisy - clean, 1e-3)
    assert np.abs(noisy - clean).max() > 1e-2  # the noise reached the output


def test_imagenet128_act_noise_sites_match_jax(monkeypatch):
    """Full width (meta device on the port's side, plain kernel versions;
    ``jax.eval_shape`` on JAX's): the four sites in_8, out_1, out_4, out_12
    at the plain ResBlock outputs, with JAX's shapes, in JAX's order."""
    jcfg, tcfg = ADMUNetConfig.imagenet128(), TADMUNetConfig.imagenet128()
    assert tcfg.activation_noise_blocks == jcfg.activation_noise_blocks == ("in_8", "out_1", "out_4", "out_12")
    jshapes = []

    def rec(mod, h, tag):
        if tag in mod.cfg.activation_noise_blocks and mod.has_rng("act_noise"):
            jshapes.append((tag, tuple(h.shape)))
            h = h + mod.cfg.activation_noise_std * jax.random.normal(mod.make_rng("act_noise"), h.shape).astype(h.dtype)
        return h

    monkeypatch.setattr(jadm.ADMUNet, "_maybe_noise", rec)
    x, y = jnp.zeros((2, 128, 128, 3)), jnp.zeros((2,), jnp.int32)
    shapes = jax.eval_shape(lambda k: ADMUNet(jcfg).init({"params": k, "act_noise": k}, x, jnp.asarray(1), y), jax.random.key(0))
    jshapes.clear()  # init traced the sites once; the apply below is the one to read
    jax.eval_shape(lambda p, k: ADMUNet(jcfg).apply(p, x, jnp.asarray(1), y, rngs={"act_noise": k}), shapes, jax.random.key(1))

    for mod, names in ((kgn, ("group_norm",)), (katt, ("attention",)), (kpool, ("avg_pool_2x2", "avg_pool_2x2_pair")),
                       (kilv, ("interleave_2x", "nearest_2x", "interleave_2x_pair"))):
        for n in names:
            monkeypatch.setattr(mod, n, getattr(mod, n + "_plain"))

    class Shapes:
        def __init__(self):
            self.shapes = []

        def normal(self, shape, dtype, device):
            self.shapes.append(tuple(shape))
            return torch.zeros(shape, dtype=dtype, device=device)

    src = Shapes()
    with torch.device("meta"):
        out = TADMUNet(tcfg)(torch.zeros(2, 128, 128, 3), 1, torch.zeros(2, dtype=torch.long), act_noise=src)
    assert out.shape == (2, 128, 128, 6)
    assert jshapes == list(zip(jcfg.activation_noise_blocks, src.shapes))
    assert src.shapes == [(2, 32, 32, 512), (2, 8, 8, 1024), (2, 16, 16, 768), (2, 128, 128, 256)]


def test_activation_noise_estimator_matches_jax(monkeypatch):
    """M act-noise forwards on the same x_t, each member's draws replayed
    (std 0.5 on both sides, see the module note)."""
    tiny = Tiny(activation_noise_std=0.5)
    jstate, tstate = tiny.states()
    key = jax.random.key(7)
    est = make_estimator(EstimatorConfig(name="uncertainty", M=M))
    ref = jax.jit(lambda st, k: est(tiny.jfn("act_noise"), tiny.sched, st, k))(jstate, key)
    noise = ReplayNoise(member_act_noise(monkeypatch, tiny, [tiny.x] * M, T, jax.random.split(key, M)))
    with torch.no_grad():
        u = t_make_estimator(TEstimatorConfig(name="uncertainty", M=M))(tiny.tfn(act_noise=True), tiny.tsched, tstate, noise)
    assert noise.used == 2 and float(u.mean()) > 0
    _close(u, ref, FWD_TOL)


def _ensemble_draw(key, shape):
    """The re-noise draw of a JAX estimator that splits its key into
    (k_noise, k_model)."""
    return np.asarray(jax.random.normal(jax.random.split(key)[0], (M,) + tuple(shape), jnp.float32))


@pytest.mark.parametrize("name,extra", [("infer_noise", {}), ("uncertainty_image", {}), ("uncertainty_image", {"eta": 0.5}),
                                        ("flip", {})])
def test_forward_estimators_match_jax(name, extra):
    tiny = Tiny()
    jstate, tstate = tiny.states()
    key = jax.random.key(11)
    ref = make_estimator(EstimatorConfig(name=name, M=M, **extra))(tiny.jfn(), tiny.sched, jstate, key)
    noise = ReplayNoise([] if name == "flip" else [_ensemble_draw(key, tiny.x.shape)])
    with torch.no_grad():
        u = t_make_estimator(TEstimatorConfig(name=name, M=M, **extra))(tiny.tfn(), tiny.tsched, tstate, noise)
    assert noise.used == len(noise.draws) and float(u.mean()) > 0
    _close(u, ref, FWD_TOL)


@pytest.mark.parametrize("t,t_prev,distance", [(T, T_PREV, 4), (100, 50, 20)])
def test_centered_d_matches_jax(t, t_prev, distance):
    """The step index recovered from the timestep value; at t=100 (step 18
    of 20) the distance 20 runs past the last step and is cut to 1."""
    tiny = Tiny()
    jstate, tstate = tiny.states(t, t_prev)
    ts = spaced_timesteps(1000, STEPS)
    key = jax.random.key(13)
    cfg = dict(name="uncertainty_centered_d", M=M, uncertainty_distance=distance)
    ref = make_estimator(EstimatorConfig(**cfg), timesteps=ts)(tiny.jfn(), tiny.sched, jstate, key)
    seen = []
    tfn = tiny.tfn()
    noise = ReplayNoise([_ensemble_draw(key, tiny.x.shape)])
    with torch.no_grad():
        u = t_make_estimator(TEstimatorConfig(**cfg), timesteps=ts)(
            lambda x, tt, nz: seen.append(tt) or tfn(x, tt, nz), tiny.tsched, tstate, noise)
    assert seen == [int(ts[min(list(ts).index(t) + distance, STEPS - 1)])] and noise.used == 1
    _close(u, ref, FWD_TOL)


def test_grad_based_matches_jax():
    """|∂ Σ mean_m (score_m − ε)² / ∂ε| through the tiny ADM."""
    tiny = Tiny()
    jstate, tstate = tiny.states()
    key = jax.random.key(17)
    ref = make_estimator(EstimatorConfig(name="uncertainty_grad", M=M))(tiny.jfn(), tiny.sched, jstate, key)
    noise = ReplayNoise([_ensemble_draw(key, tiny.x.shape)])
    with torch.no_grad():
        u = t_make_estimator(TEstimatorConfig(name="uncertainty_grad", M=M))(tiny.tfn(), tiny.tsched, tstate, noise)
    assert noise.used == 1 and float(u.abs().max()) > 0
    _close(u, ref, GRAD_TOL)


def test_flip_grad_matches_jax():
    """The activation-gradient saliency at every ResBlock tap, against the
    JAX model built with ``grad_taps=True``: 6 taps (the plain ResBlocks
    in_1 at 16² and in_3 at 8², and the four output blocks), u [B, 16, 16, 1]."""
    tiny = Tiny(grad_taps=True)
    jstate, tstate = tiny.states()
    est = make_flip_grad_estimator(tiny.jmodel, tiny.params, jnp.asarray(tiny.y))
    ref = jax.jit(lambda st: est(None, tiny.sched, st, jax.random.key(0)))(jstate)
    taps = []
    est = t_make_flip_grad(tiny.tmodel, torch.from_numpy(tiny.y))
    real = tiny.tmodel.forward

    def spy(*a, **kw):
        out = real(*a, **kw)
        taps.append(sorted(kw["taps"]))
        return out

    tiny.tmodel.forward = spy
    with torch.no_grad():
        u = est(None, tiny.tsched, tstate, ReplayNoise([]))
    assert taps[-1] == ["in_1", "in_3", "out_0", "out_1", "out_2", "out_3"] and u.shape == (2, 16, 16, 1)
    assert float(u.max()) == pytest.approx(1.0)
    _close(u, ref, GRAD_TOL)


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_nearest_upscale_picks_jax_pixels(factor):
    """flip_grad's nearest upscale: ``F.interpolate`` and ``jax.image.resize``
    agree exactly at integer power-of-two factors."""
    g = np.random.RandomState(factor).rand(2, 16 // factor, 16 // factor, 1).astype(np.float32)
    want = jax.image.resize(jnp.asarray(g), (2, 16, 16, 1), "nearest")
    got = F.interpolate(torch.from_numpy(g).permute(0, 3, 1, 2), size=(16, 16), mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_NO_JAX = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "diffusion_uncertainty_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
for m in ("diffusion_uncertainty_torch.models.adm_unet", "diffusion_uncertainty_torch.factory",
          "diffusion_uncertainty_torch.diffusion.sampler", "diffusion_uncertainty_torch.uncertainty",
          "diffusion_uncertainty_torch.uncertainty.estimators", "diffusion_uncertainty_torch.uncertainty.guidance",
          "diffusion_uncertainty_torch.scripts.generate_dataset_score_uncertainty",
          "diffusion_uncertainty_torch.scripts.compute_ause", "diffusion_uncertainty_torch.scripts.generate_guided",
          "diffusion_uncertainty_torch.scripts.profile_forward", "diffusion_uncertainty_torch.scripts.bench_guided_path",
          "diffusion_uncertainty_torch.models.uvit", "chip_smoke"):
    importlib.import_module(m)
import torch
from diffusion_uncertainty_torch.diffusion import StepState
from diffusion_uncertainty_torch.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_torch.uncertainty import make_flip_grad_estimator
from diffusion_uncertainty_torch.utils import TorchNoise
model = ADMUNet(ADMUNetConfig.tiny()).eval().requires_grad_(False)
x, y = torch.randn(1, 16, 16, 3), torch.tensor([2])
with torch.no_grad():
    out = model(x, 10, y, act_noise=TorchNoise(0, device="cpu"))
    u = make_flip_grad_estimator(model, y)(None, None, StepState(x, x, x, x, 10, 0), None)
assert out.shape == (1, 16, 16, 3) and u.shape == (1, 16, 16, 1)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no jax")
"""


def test_slice_modules_import_no_jax():
    """Every module this slice changes, and ``chip_smoke.py``, import with
    JAX and the JAX package blocked."""
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "no jax", out.stderr[-2000:]
