"""The port's CLIP vision tower and SD 1.5 safety checker against the JAX
package, float32 on the CPU: the tiny vision tower with weights carried from
JAX parameters, ``clip_preprocess`` (JAX's antialiased Keys-cubic resize) at
512 -> 224 and at non-square sizes, ``safety_scores`` and
``run_safety_checker`` with thresholds that flag some images and not others,
the converter round trip, the full-size parameter count, and the t2i CLI's
``--safety-checker-weights`` against the JAX CLI's ``nsfw_flags.yaml``.
Torch runs on one intra-op thread; 101 s on one worker under the suite's
6-worker run, most of it the JAX CLI's compiles."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import diffusion_uncertainty_torch.models.clip_vision as tcv
import diffusion_uncertainty_torch.pipelines.safety_checker as tsc
import diffusion_uncertainty_tpu.models.clip_vision as jcv
import diffusion_uncertainty_tpu.pipelines.safety_checker as jsc
from diffusion_uncertainty_torch.models import clip_vision_state_dict_from_flax, safety_checker_state_dict_from_flax
from diffusion_uncertainty_torch.scripts import generate_t2i_guided as tcli
from diffusion_uncertainty_tpu.models.convert import convert_clip_vision, convert_safety_checker
from diffusion_uncertainty_tpu.scripts import generate_t2i_guided as jcli

torch.set_num_threads(1)

REL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _vision_params(cfg, seed: int):
    rng = np.random.RandomState(seed)
    px = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    params = jcv.CLIPVisionEncoder(cfg).init(jax.random.key(seed), px)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params)


def _checker_params(cfg, seed: int, concept_w=None, special_w=None):
    rng = np.random.RandomState(seed + 100)
    proj = cfg.projection_dim
    return jsc.SafetyCheckerParams(
        vision=_vision_params(cfg, seed),
        concept_embeds=jnp.asarray(rng.randn(17, proj).astype(np.float32)),
        special_care_embeds=jnp.asarray(rng.randn(3, proj).astype(np.float32)),
        concept_embeds_weights=jnp.asarray(np.full(17, 2.0, np.float32) if concept_w is None else concept_w),
        special_care_embeds_weights=jnp.asarray(np.full(3, 2.0, np.float32) if special_w is None else special_w),
    )


def test_clip_vision_tiny_matches_jax():
    cfg, tcfg = jcv.CLIPVisionConfig.tiny(), tcv.CLIPVisionConfig.tiny()
    assert {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"} == dataclasses.asdict(tcfg)
    params = _vision_params(cfg, 0)
    px = np.random.RandomState(1).randn(3, 16, 16, 3).astype(np.float32)
    ref = jcv.CLIPVisionEncoder(cfg).apply(params, jnp.asarray(px))
    sd = clip_vision_state_dict_from_flax(params, tcfg)
    model = tcv.CLIPVisionEncoder(tcfg).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(px))
    for name in ("last_hidden", "pooled", "image_embeds"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape and _rel(got, want) <= REL, name
    back = convert_clip_vision({k: v.numpy() for k, v in sd.items()}, cfg)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0], jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("shape", [(2, 512, 512, 3), (1, 300, 200, 3), (1, 100, 150, 3)],
                         ids=["512", "300x200", "100x150"])
def test_clip_preprocess_matches_jax(shape):
    """Against JAX (atol 1e-5), and against the float64 product of JAX's own
    per-axis weight matrices (``compute_weight_mat``), which the port's
    float32 products meet within 2e-6."""
    from jax._src.image import scale as jscale

    x = np.random.RandomState(2).uniform(-0.1, 1.1, size=shape).astype(np.float32)
    want = np.asarray(jsc.clip_preprocess(jnp.asarray(x)))
    got = tsc.clip_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    h, w = shape[1:3]
    s = 224 / min(h, w)
    nh, nw = max(int(round(h * s)), 224), max(int(round(w * s)), 224)
    mats = [np.eye(n) if n == m else np.asarray(jscale.compute_weight_mat(
        m, n, n / m, 0.0, jscale._fill_keys_cubic_kernel, True), np.float64) for m, n in ((h, nh), (w, nw))]
    exact = np.einsum("bywc,wx->byxc", np.einsum("bhwc,hy->bywc", x.astype(np.float64), mats[0]), mats[1])
    top, left = (nh - 224) // 2, (nw - 224) // 2
    exact = (np.clip(exact[:, top:top + 224, left:left + 224], 0, 1) - jsc.CLIP_MEAN) / jsc.CLIP_STD
    np.testing.assert_allclose(got, exact, atol=2e-6, rtol=0)


def test_safety_scores_and_checker_match_jax():
    cfg, tcfg = jcv.CLIPVisionConfig.tiny(), tcv.CLIPVisionConfig.tiny()
    images = np.random.RandomState(3).uniform(0, 1, size=(6, 32, 24, 3)).astype(np.float32)
    probe = _checker_params(cfg, 4)
    clip_in = jsc.clip_preprocess(jnp.asarray(images), size=cfg.image_size)
    embeds = np.asarray(jcv.CLIPVisionEncoder(cfg).apply(probe.vision, clip_in).image_embeds)
    img = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
    cos = np.sort(img @ (probe.concept_embeds[0] / np.linalg.norm(probe.concept_embeds[0])))
    s_cos = np.sort(img @ (probe.special_care_embeds[1] / np.linalg.norm(probe.special_care_embeds[1])))
    # concept 0 flags the top half; special-care 1 hits the top third and lowers every threshold by 0.01
    concept_w = np.full(17, 2.0, np.float32)
    concept_w[0] = (cos[2] + cos[3]) / 2
    special_w = np.full(3, 2.0, np.float32)
    special_w[1] = (s_cos[3] + s_cos[4]) / 2
    params = _checker_params(cfg, 4, concept_w, special_w)
    checker = tsc.load_safety_checker(safety_checker_state_dict_from_flax(params, tcfg), tcfg, device="cpu")
    x = torch.from_numpy(images)
    flags, c_scores, s_scores = tsc.safety_scores(checker, tsc.clip_preprocess(x, size=16))
    j_flags, j_c, j_s = jsc.safety_scores(cfg, params, clip_in)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(j_flags))
    assert 0 < int(flags.sum()) < len(images) and np.abs(np.asarray(j_c)).min() > 1e-4
    np.testing.assert_allclose(c_scores.numpy(), np.asarray(j_c), atol=1e-5, rtol=0)
    np.testing.assert_allclose(s_scores.numpy(), np.asarray(j_s), atol=1e-5, rtol=0)
    filtered, has_nsfw = tsc.run_safety_checker(checker, x)
    j_filtered, j_has = jsc.run_safety_checker(cfg, params, jnp.asarray(images))
    np.testing.assert_array_equal(has_nsfw, j_has)
    np.testing.assert_array_equal(filtered.numpy(), np.asarray(j_filtered))
    assert tsc.run_safety_checker(None, x) == (x, None)
    # the converter round trip, the doubled prefix included
    sd = {k: v.numpy() for k, v in safety_checker_state_dict_from_flax(params, tcfg).items()}
    assert "vision_model.vision_model.post_layernorm.weight" in sd and "visual_projection.weight" in sd
    back = convert_safety_checker(sd, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_full_size_vision_parameter_count():
    shapes = jax.eval_shape(jcv.CLIPVisionEncoder(jcv.CLIPVisionConfig.vit_l_14()).init, jax.random.key(0),
                            jnp.zeros((1, 224, 224, 3)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 303_966_208
    with torch.device("meta"):
        model = tcv.CLIPVisionEncoder(tcv.CLIPVisionConfig.vit_l_14())
    assert sum(p.numel() for p in model.parameters()) == 303_966_208


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


@pytest.mark.parametrize("threshold,flagged", [(-2.0, True), (2.0, False)], ids=["all_flag", "none_flag"])
def test_cli_safety_checker_matches_jax(monkeypatch, tmp_path, threshold, flagged):
    """Both CLIs on the tiny SD model with one checker file (the ViT-L
    factory narrowed on both sides): the same ``nsfw_flags.yaml``, flagged
    images black."""
    for mod in (jcv, tcv):
        monkeypatch.setattr(mod.CLIPVisionConfig, "vit_l_14", staticmethod(mod.CLIPVisionConfig.tiny))
    params = _checker_params(jcv.CLIPVisionConfig.tiny(), 7, np.full(17, threshold, np.float32),
                             np.full(3, 2.0, np.float32))
    weights = tmp_path / "checker.pt"
    torch.save(safety_checker_state_dict_from_flax(params, tcv.CLIPVisionConfig.tiny()), weights)
    argv = ["--model", "tiny", "--random-init", "true", "--num-steps", "2", "--num-steps-threshold", "1", "--M", "2",
            "--safety-checker-weights", str(weights)]
    assert jcli.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    assert tcli.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want, got = tmp_path / "jax" / "0", tmp_path / "port" / "0"
    names = ["args.yaml", "nsfw_flags.yaml", "output_sd.png", "output_sd_uc.png", "uncertainty.npz"]
    assert sorted(p.name for p in want.iterdir()) == sorted(p.name for p in got.iterdir()) == names
    text = (got / "nsfw_flags.yaml").read_text()
    assert text == (want / "nsfw_flags.yaml").read_text() == f"guided:\n- {str(flagged).lower()}\noriginal:\n- {str(flagged).lower()}\n"
    for name in ("output_sd.png", "output_sd_uc.png"):
        a, b = _png(got / name), _png(want / name)
        assert a.shape == b.shape == (16, 16, 3)
        assert bool((a == 0).all()) == bool((b == 0).all()) == flagged
