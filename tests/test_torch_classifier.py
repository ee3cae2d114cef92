"""Classifier guidance of the port against the JAX package, float32 on the
CPU: ``ADMClassifierConfig`` / ``ADMClassifier`` (both pools), the converter
``adm_classifier_state_dict_from_flax`` against ``convert_adm_classifier``,
the full-width ImageNet-128 keys and shapes, ``factory.load_classifier``,
``with_classifier_guidance`` around the tiny ADM, the classifier-guided
``generate_uncertainty_dataset`` with the centered estimator (JAX draws
replayed), the dataset CLI's ``--classifier-scale``, and the no-jax imports
of the new modules.

Tolerances: a narrow classifier's logits and the guided ε within relative L2
1e-5 (float32 summation order of convs, GroupNorm and attention); the
dataset run's images within one uint8 step, maps and scores within
``ATOL`` of the largest reference value, as ``tests/test_torch_cifar.py``.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, jax_guidance_noise, make_adm_state_dict, torch_state_dict

import diffusion_uncertainty_torch.models.convert as tconvert
from diffusion_uncertainty_torch.classifier_guidance import with_classifier_guidance as t_guidance
from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.factory import load_classifier
from diffusion_uncertainty_torch.models import ADMClassifier as TADMClassifier
from diffusion_uncertainty_torch.models import ADMClassifierConfig as TADMClassifierConfig
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.models import adm_classifier_state_dict_from_flax
from diffusion_uncertainty_torch.models.adm_unet import ResBlock as TResBlock
from diffusion_uncertainty_torch.models.layers import AttentionBlock as TAttentionBlock
from diffusion_uncertainty_torch.models.layers import GroupNorm32 as TGroupNorm32
from diffusion_uncertainty_torch.sampling import generate_uncertainty_dataset as t_generate
from diffusion_uncertainty_torch.scripts import generate_dataset_score_uncertainty as tcli
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_torch.utils.experiments import load_run_arrays
from diffusion_uncertainty_tpu.classifier_guidance import with_classifier_guidance
from diffusion_uncertainty_tpu.diffusion.sampler import SamplerConfig
from diffusion_uncertainty_tpu.diffusion.schedule import make_schedule
from diffusion_uncertainty_tpu.models import ADMClassifier, ADMClassifierConfig, ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_classifier, convert_adm_unet
from diffusion_uncertainty_tpu.sampling import generate_uncertainty_dataset
from diffusion_uncertainty_tpu.uncertainty import EstimatorConfig, make_estimator
from diffusion_uncertainty_tpu.utils.rng import batch_key, run_key

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4  # as tests/test_torch_cifar.py


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def narrow(image_size=32, out_channels=1000, **kw):
    """(JAX config, port config) of a narrow classifier: width 32, levels
    (1, 2, 2) of one ResBlock, attention at 16² and 8², 16-channel heads
    (at 16²: levels (1, 2), attention at 8²)."""
    mult = (1, 2, 2) if image_size == 32 else (1, 2)
    fields = dict(image_size=image_size, model_channels=32, out_channels=out_channels, num_res_blocks=1,
                  attention_resolutions=tuple(image_size // r for r in (16, 8) if image_size // r > 1),
                  channel_mult=mult, num_head_channels=16, **kw)
    return ADMClassifierConfig(**fields), TADMClassifierConfig(**fields)


def random_classifier_params(jcfg, seed):
    """Seeded random JAX ``ADMClassifier`` parameters (norm scales around 1)."""
    rng = np.random.RandomState(seed)
    x0 = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))
    shapes = jax.eval_shape(lambda k: ADMClassifier(jcfg).init(k, x0, jnp.asarray(0)), jax.random.key(0))

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "scale" in name:
            return (1.0 + rng.randn(*s.shape) * 0.1).astype(np.float32)
        return (rng.randn(*s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_classifier(jcfg, tcfg, params):
    model = TADMClassifier(tcfg).eval().requires_grad_(False)
    model.load_state_dict(adm_classifier_state_dict_from_flax(params, jcfg))  # strict
    return model


@pytest.mark.parametrize("size", [64, 128, 256])
def test_imagenet_config_matches_jax(size):
    assert dataclasses.asdict(TADMClassifierConfig.imagenet(size)) == {
        k: v for k, v in dataclasses.asdict(ADMClassifierConfig.imagenet(size)).items() if k != "dtype"}


def test_state_dict_from_flax_inverts_convert():
    """A seeded reference-layout state dict of the narrow classifier, through
    ``convert_adm_classifier`` and back: every key and value exactly."""
    jcfg, tcfg = narrow()
    with torch.device("meta"):
        keys = {k: tuple(v.shape) for k, v in TADMClassifier(tcfg).state_dict().items()}
    rng = np.random.RandomState(1)
    sd = {k: rng.randn(*s).astype(np.float32) for k, s in keys.items()}
    back = adm_classifier_state_dict_from_flax(convert_adm_classifier(sd, jcfg), tcfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_full_width_keys_and_shapes_match_jax(monkeypatch):
    """``imagenet(128)`` at full width: the port's state dict on the meta
    device against JAX's parameters through eval_shape and the converter,
    and the block counts a forward launches kernels for (40 GroupNorms, 7
    attention blocks and the pool, 4 down ResBlocks)."""
    with torch.device("meta"):
        model = TADMClassifier(TADMClassifierConfig.imagenet(128))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    jcfg = ADMClassifierConfig.imagenet(128)
    shapes = jax.eval_shape(
        lambda k: ADMClassifier(jcfg).init(k, jnp.zeros((1, 128, 128, 3)), jnp.asarray(0)), jax.random.key(0))
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    monkeypatch.setattr(tconvert._Out, "put", lambda self, key, a: self.sd.__setitem__(key, tuple(np.shape(a))))
    assert adm_classifier_state_dict_from_flax(views, jcfg) == want
    assert want["out.2.positional_embedding"] == (512, 65) and want["out.2.qkv_proj.weight"] == (1536, 512, 1)
    mods = list(model.modules())
    assert sum(isinstance(m, TGroupNorm32) for m in mods) == 40
    assert sum(isinstance(m, TAttentionBlock) for m in mods) == 7
    assert sum(isinstance(m, TResBlock) and m.down for m in mods) == 4


@pytest.mark.parametrize("pool", ["attention", "adaptive"])
def test_narrow_forward_matches_jax(pool):
    jcfg, tcfg = narrow(pool=pool)
    params = random_classifier_params(jcfg, seed=2)
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    ref = np.asarray(ADMClassifier(jcfg).apply(params, jnp.asarray(x), jnp.asarray(400)))
    with torch.no_grad():
        out = port_classifier(jcfg, tcfg, params)(torch.from_numpy(x), 400)
    assert out.dtype == torch.float32 and out.shape == (2, 1000)
    assert rel_l2(out.numpy(), ref) <= 1e-5


def test_load_classifier_random_init_and_missing_checkpoint(monkeypatch):
    monkeypatch.setattr(TADMClassifierConfig, "imagenet", staticmethod(lambda size: narrow(image_size=size)[1]))
    a = load_classifier("imagenet64", random_init=True, device="cpu")
    b = load_classifier("imagenet64", random_init=True, device="cpu")
    assert isinstance(a, TADMClassifier) and a.cfg.image_size == 64
    assert all(torch.equal(p, q) and p.dtype == torch.float32 and not p.requires_grad
               for p, q in zip(a.parameters(), b.parameters()))
    assert torch.equal(a.out[0].weight, torch.ones(64)) and float(a.input_blocks[0][0].weight.std()) > 0.01
    with pytest.raises(FileNotFoundError, match="64x64_classifier.pt"):
        load_classifier("imagenet64", device="cpu", models_dir="/nonexistent")


def _tiny_pair(seed):
    """The tiny ADM (16², 10 classes) and a 16² classifier of 10 classes,
    both sides, on the same weights."""
    jcfg, tcfg = ADMUNetConfig.tiny(), TADMUNetConfig.tiny()
    sd = make_adm_state_dict(jcfg, seed=seed)
    jparams = convert_adm_unet(sd, jcfg)
    tmodel = TADMUNet(tcfg).eval().requires_grad_(False)
    tmodel.load_state_dict(torch_state_dict(sd))
    jc, tc = narrow(image_size=16, out_channels=10)
    cparams = random_classifier_params(jc, seed=seed + 1)
    return (ADMUNet(jcfg), jparams, ADMClassifier(jc), cparams), (tmodel, port_classifier(jc, tc, cparams))


def test_guided_eps_matches_jax():
    """eps - sqrt(1 - ab_t)·scale·grad log p(y|x) at two timesteps with
    per-sample labels, and the guidance term alone (the wrappers around a
    zero eps), which is non-zero."""
    (jm, jp, jc, jcp), (tm, tc) = _tiny_pair(seed=4)
    rng = np.random.RandomState(5)
    x, y = rng.randn(3, 16, 16, 3).astype(np.float32), np.array([1, 7, 3])
    jsched, tsched = make_schedule("linear", 1000), t_make_schedule("linear", 1000, device="cpu")
    jclf = lambda p, xx, t: jc.apply(p["classifier"], xx, t)  # noqa: E731
    jg = jax.jit(with_classifier_guidance(lambda p, xx, t, yy, k: jm.apply(p["model"], xx, t, yy), jclf, jsched, 2.0))
    jterm = jax.jit(with_classifier_guidance(lambda p, xx, t, yy, k: jnp.zeros_like(xx), jclf, jsched, 2.0))
    tg = t_guidance(lambda xx, t, yy, nz: tm(xx, t, yy), tc, tsched, 2.0)
    tterm = t_guidance(lambda xx, t, yy, nz: torch.zeros_like(xx), tc, tsched, 2.0)
    p = {"model": jp, "classifier": jcp}
    for t in (800, 250):
        args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), None)
        ref, ref_term = np.asarray(jg(p, *args)), np.asarray(jterm(p, *args))
        with torch.no_grad():
            got = tg(torch.from_numpy(x), t, torch.from_numpy(y), None)
            term = tterm(torch.from_numpy(x), t, torch.from_numpy(y), None)
        assert got.dtype == torch.float32 and not got.requires_grad
        assert rel_l2(got.numpy(), ref) <= 1e-5, t
        assert float(term.abs().max()) > 1e-4 and rel_l2(term.numpy(), ref_term) <= 1e-5, t


def test_guided_generation_matches_jax(tmp_path):
    """The tiny ADM guided by the 16² classifier (scale 1) through both
    packages' generation loops with ``uncertainty_centered`` (its ensemble on
    the unguided model, as the CLI wires it) and the JAX run's draws: 3 images
    in batches of 2, a chain of 6 steps started at step 2 (t=500), window
    [3, 6)."""
    (jm, jp, jc, jcp), (tm, tc) = _tiny_pair(seed=6)
    rng = np.random.RandomState(7)
    x_t, y = rng.randn(3, 16, 16, 3).astype(np.float32), np.array([2, 9, 4])
    steps, start, after, n_uc, M, seed = 6, 2, 3, 3, 2, 5
    jsched, tsched = make_schedule("linear", 1000), t_make_schedule("linear", 1000, device="cpu")
    plain = lambda p, xx, t, yy, k: jm.apply(p["model"], xx, t, yy)  # noqa: E731
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    generate_uncertainty_dataset(
        with_classifier_guidance(plain, lambda p, xx, t: jc.apply(p["classifier"], xx, t), jsched, 1.0),
        jsched, SamplerConfig(num_inference_steps=steps, after_step=after, num_steps_uc=n_uc, start_step=start),
        x_t, y, 2, params={"model": jp, "classifier": jcp}, seed=seed,
        estimator=make_estimator(EstimatorConfig(name="uncertainty_centered", M=M)), estimator_apply_fn=plain,
        run_dir=jdir,
    )
    draws = {b: jax_guidance_noise(batch_key(run_key(seed), b), (2, 16, 16, 3), steps, after, n_uc, M, start_step=start)
             for b in range(2)}
    sources = []

    def replay(s, device):
        sources.append(ReplayNoise(draws[s % 2**32]))
        return sources[-1]

    tplain = lambda xx, t, yy, nz: tm(xx, t, yy)  # noqa: E731
    t_generate(
        t_guidance(tplain, tc, tsched, 1.0), tsched,
        TSamplerConfig(num_inference_steps=steps, after_step=after, num_steps_uc=n_uc, start_step=start),
        x_t, y, 2, seed=seed, estimator=t_make_estimator(TEstimatorConfig(name="uncertainty_centered", M=M)),
        estimator_apply_fn=tplain, run_dir=tdir, noise_factory=replay,
    )
    assert [s.used for s in sources] == [n_uc, n_uc]
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    assert np.abs(load_run_arrays(tdir, "gen_images").astype(int) - load_run_arrays(jdir, "gen_images")).max() <= 1
    for name in ("uncertainty", "score"):
        got, want = load_run_arrays(tdir, name), load_run_arrays(jdir, name)
        assert got.shape == (3, n_uc, 16, 16, 3)
        np.testing.assert_allclose(got, want, atol=ATOL * float(np.abs(want).max()), rtol=0, err_msg=name)


def test_dataset_cli_with_classifier_scale(monkeypatch, tmp_path):
    """``--classifier-scale 1.0`` on ``tiny`` (the factory has no 16²
    classifier: ``load_classifier`` gives the narrow one): the run writes its
    shards, and its images differ from the unguided run's."""
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    d = tmp_path / "data" / "diffusion-starting-points" / "tiny"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    np.savez(d / "X_T.npz", data=rng.randn(2, 16, 16, 3).astype(np.float32))
    np.savez(d / "y.npz", data=rng.randint(0, 10, size=2).astype(np.int32))
    _, tc = narrow(image_size=16, out_channels=10)
    asked = []

    def fake_load(dataset, random_init=False, device="cuda"):
        asked.append((dataset, random_init, device))
        model = TADMClassifier(tc).eval().requires_grad_(False)
        gen = torch.Generator().manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, 0.0, 0.2, generator=gen)
        return model

    monkeypatch.setattr(tcli, "load_classifier", fake_load)
    argv = ["--dataset", "tiny", "--scheduler-type", "uncertainty_centered", "--random-init", "true", "--device", "cpu",
            "--dtype", "float32", "--num-samples", "2", "--batch-size", "2", "--M", "2", "--generation-steps", "4",
            "--start-step-uc", "2", "--num-steps-uc", "2"]
    guided = tcli.main(argv + ["--classifier-scale", "1.0", "--run-dir", str(tmp_path / "guided")])
    plain = tcli.main(argv + ["--run-dir", str(tmp_path / "plain")])
    assert asked == [("tiny", True, "cpu")]
    u = load_run_arrays(guided, "uncertainty")
    assert u.shape == (2, 2, 16, 16, 3) and np.isfinite(u).all() and u.mean() > 0
    assert not np.array_equal(load_run_arrays(guided, "gen_images"), load_run_arrays(plain, "gen_images"))
    assert "classifier_scale: 1.0" in (guided / "args.yaml").read_text()


_NO_JAX = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "diffusion_uncertainty_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
for m in ("diffusion_uncertainty_torch.models.adm_unet", "diffusion_uncertainty_torch.models.convert",
          "diffusion_uncertainty_torch.factory", "diffusion_uncertainty_torch.classifier_guidance",
          "diffusion_uncertainty_torch.diffusion.dpm_solver", "diffusion_uncertainty_torch.sampling",
          "diffusion_uncertainty_torch.scripts.generate_dataset_score_uncertainty",
          "diffusion_uncertainty_torch.scripts.profile_forward", "diffusion_uncertainty_torch.scripts.bench_guided_path",
          "chip_smoke"):
    importlib.import_module(m)
import torch
from diffusion_uncertainty_torch.models import ADMClassifier, ADMClassifierConfig
cfg = ADMClassifierConfig(image_size=16, model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
                          channel_mult=(1, 2), num_head_channels=16)
with torch.no_grad():
    out = ADMClassifier(cfg).eval()(torch.zeros(1, 16, 16, 3), 10)
assert out.shape == (1, 1000)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no jax")
"""


def test_classifier_and_dpm_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "no jax", out.stderr[-2000:]
