"""The port's evaluation metrics against the JAX package, on the CPU in
float32, with the same inputs (numpy seeds) on both sides.

* ``compute_aucs``, ``RunningStats`` / ``frechet_distance`` and
  ``SyntheticDataset`` are numpy copies: bit-identical.
* ``sparsification_curves_fast``: within 1e-6 of the curve's max (the port
  sums in float64, JAX in float32).
* ``precision_recall``: identical memberships, on data whose every query lies
  at least 1e-4 (relative) away from every radius, so that float32 rounding
  of the distances cannot flip a strict ``<``; the test asserts that margin.
* ``calc_bpd_loop``: a tiny ADM (6 channels under ``learned_range``, 3 under
  ``fixed_small``) on a 20-step schedule with JAX's per-step noise replayed,
  rtol 1e-4.
* The feature extractors: ``RandomConvFeatures`` with JAX's weights, the
  Inception trunk from a random pytorch-fid state dict (JAX through
  ``convert_inception``), the Inception resize, and VGG16 on its pad and
  nearest paths: float32 summation order only (tolerances below).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, make_adm_state_dict, torch_state_dict

from diffusion_uncertainty_torch.datasets import SyntheticDataset as TSyntheticDataset
from diffusion_uncertainty_torch.datasets import iterate_batches as t_iterate_batches
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.metrics import ause as tause
from diffusion_uncertainty_torch.metrics import features as tfeat
from diffusion_uncertainty_torch.metrics import fid as tfid
from diffusion_uncertainty_torch.metrics import nll as tnll
from diffusion_uncertainty_torch.metrics.precision_recall import knn_radii as t_knn_radii
from diffusion_uncertainty_torch.metrics.precision_recall import manifold_membership as t_manifold_membership
from diffusion_uncertainty_torch.metrics.precision_recall import precision_recall as t_precision_recall
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_tpu.datasets import SyntheticDataset
from diffusion_uncertainty_tpu.datasets.folder import iterate_batches
from diffusion_uncertainty_tpu.diffusion import make_schedule
from diffusion_uncertainty_tpu.metrics import ause as jause
from diffusion_uncertainty_tpu.metrics import features as jfeat
from diffusion_uncertainty_tpu.metrics import fid as jfid
from diffusion_uncertainty_tpu.metrics import nll as jnll
from diffusion_uncertainty_tpu.metrics.precision_recall import knn_radii as j_knn_radii
from diffusion_uncertainty_tpu.metrics.precision_recall import manifold_membership as j_manifold_membership
from diffusion_uncertainty_tpu.metrics.precision_recall import precision_recall as j_precision_recall
from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet


def _maps(kind: str, seed: int = 0, shape=(4, 16, 16, 3)):
    """(gt, pred, uncertainty) of one kind: random, tied (uncertainty on 4
    levels), or all-zero uncertainty."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(*shape).astype(np.float32)
    pred = np.clip(gt + rng.randn(*shape).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    u = np.abs(gt - pred) + rng.rand(*shape).astype(np.float32) * 0.05
    if kind == "ties":
        u = np.floor(u * 40.0) / 10.0  # a few levels, many ties
    elif kind == "zero":
        u = np.zeros(shape, np.float32)
    return gt, pred, u.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "zero"])
def test_compute_aucs_is_bit_identical(kind):
    gt, pred, u = _maps(kind)
    got, got_curves = tause.compute_aucs(gt, pred, u, intervals=20)
    want, want_curves = jause.compute_aucs(gt, pred, u, intervals=20)
    np.testing.assert_array_equal(np.asarray(got["rmse"]), np.asarray(want["rmse"]))
    np.testing.assert_array_equal(np.asarray(got_curves["rmse"]), np.asarray(want_curves["rmse"]))
    curves = [np.asarray(c, np.float64) for c in want_curves["rmse"]]
    assert tause.ause_aurg_from_curves(*curves) == jause.ause_aurg_from_curves(*curves)


@pytest.mark.parametrize("kind", ["random", "ties", "zero"])
@pytest.mark.parametrize("intervals", [50, 7])
def test_sparsification_curves_fast_matches_jax(kind, intervals):
    gt, pred, u = _maps(kind, seed=1)
    got = tause.sparsification_curves_fast(torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(u), intervals)
    want = jause.sparsification_curves_fast(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(u), intervals)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape == (intervals + 1,)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * float(np.abs(w).max()))


def test_running_stats_and_frechet_distance_are_bit_identical():
    rng = np.random.RandomState(2)
    a, b = rng.randn(40, 6).astype(np.float32), (rng.randn(30, 6) * 1.5 + 0.3).astype(np.float32)
    stats = []
    for mod in (tfid, jfid):
        rs, part = mod.RunningStats(6), mod.RunningStats(6)
        rs.update(a[:25])
        part.update(a[25:])
        rs.merge(part)
        stats.append((rs.finalize(), mod.compute_statistics(b)))
    (ta, tb), (ja, jb) = stats
    for x, y in zip(ta + tb, ja + jb):
        np.testing.assert_array_equal(x, y)
    assert tfid.fid_from_stats(ta, tb) == jfid.fid_from_stats(ja, jb)
    assert tfid.frechet_distance(*ta, *ta) == pytest.approx(0.0, abs=1e-9)


def _nearest_margin(queries: np.ndarray, refs: np.ndarray, radii: np.ndarray) -> float:
    """Smallest |d(q, r) − radius_r| / radius_r over all pairs (float64)."""
    d = ((queries[:, None, :].astype(np.float64) - refs[None, :, :]) ** 2).sum(-1)
    return float(np.min(np.abs(d - radii[None, :]) / radii[None, :]))


def _knn_radii64(f: np.ndarray, k: int) -> np.ndarray:
    d = ((f[:, None, :].astype(np.float64) - f[None, :, :]) ** 2).sum(-1)
    return np.sort(d, axis=1)[:, k]


@pytest.mark.parametrize("k", [2, 3])
def test_precision_recall_matches_jax(k):
    rng = np.random.RandomState(5)
    real = rng.randn(40, 8).astype(np.float32)
    gen = (rng.randn(37, 8) * 1.2 + 0.2).astype(np.float32)
    # the data's margin: no query within 1e-4 (relative) of a radius
    assert _nearest_margin(gen, real, _knn_radii64(real, k)) >= 1e-4
    assert _nearest_margin(real, gen, _knn_radii64(gen, k)) >= 1e-4
    tile = 16  # smaller than N: several tiles
    got = t_precision_recall(real, gen, k=k, tile=tile, device="cpu")
    want = j_precision_recall(real, gen, k=k, tile=tile)
    # the same fractions, up to the float32 rounding of the mean
    assert got.precision == pytest.approx(want.precision, abs=1e-6) and got.recall == pytest.approx(want.recall, abs=1e-6)
    assert 0.0 < got.precision < 1.0 and 0.0 < got.recall < 1.0
    radii = t_knn_radii(torch.from_numpy(real), k, tile)
    np.testing.assert_allclose(radii.numpy(), np.asarray(j_knn_radii(jnp.asarray(real), k, tile)), rtol=1e-5)
    # the same members, query by query
    member = t_manifold_membership(torch.from_numpy(gen), torch.from_numpy(real), radii, tile).numpy()
    np.testing.assert_array_equal(member, np.asarray(j_manifold_membership(jnp.asarray(gen), jnp.asarray(real), jnp.asarray(radii.numpy()), tile)))


def _jax_bpd_noise(key, shape, T):
    """The per-step draws of the JAX ``calc_bpd_loop``, t = T-1 first."""
    draws, k = [], key
    for _ in range(T):
        k, k_noise, _ = jax.random.split(k, 3)
        draws.append(np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))
    return draws


@pytest.mark.parametrize("variance_type,out_channels", [("learned_range", 6), ("fixed_small", 3)])
def test_calc_bpd_loop_matches_jax(variance_type, out_channels):
    T = 20
    jcfg = dataclasses.replace(ADMUNetConfig.tiny(), out_channels=out_channels)
    tcfg = dataclasses.replace(TADMUNetConfig.tiny(), out_channels=out_channels)
    sd = make_adm_state_dict(jcfg, seed=4)
    params = convert_adm_unet(sd, jcfg)
    tmodel = TADMUNet(tcfg).eval()
    tmodel.load_state_dict(torch_state_dict(sd))
    rng = np.random.RandomState(8)
    x0 = (rng.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    y = np.array([3, 6])
    key = jax.random.key(9)

    jmodel = ADMUNet(jcfg)
    yj = jnp.asarray(y)
    ref = jax.jit(lambda p, x, k: jnll.calc_bpd_loop(
        lambda xx, tt, kk: jmodel.apply(p, xx, jnp.broadcast_to(tt, (xx.shape[0],)), yj),
        make_schedule("linear", T, 1e-4, 0.2), x, k, variance_type=variance_type,
    ))(params, jnp.asarray(x0), key)

    noise = ReplayNoise(_jax_bpd_noise(key, x0.shape, T))
    yt = torch.from_numpy(y)
    with torch.no_grad():
        got = tnll.calc_bpd_loop(lambda xx, tt, _: tmodel(xx, tt, yt), t_make_schedule("linear", T, 1e-4, 0.2, device="cpu"),
                                 torch.from_numpy(x0), noise, variance_type=variance_type)
    assert noise.used == T
    assert got.vb_terms.shape == (T, 2) and got.mse.shape == (T, 2)
    for name in ("total_bpd", "prior_bpd", "vb_terms", "mse"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("size", [32, 29])
def test_random_conv_features_match_jax_with_its_weights(size):
    j = jfeat.RandomConvFeatures(dim=64, seed=3)
    t = tfeat.RandomConvFeatures(dim=64, w1=np.asarray(j._w1), w2=np.asarray(j._w2), device="cpu")
    imgs = np.random.RandomState(size).randint(0, 256, (3, size, size, 3)).astype(np.uint8)
    got, want = t(imgs).numpy(), np.asarray(j(jnp.asarray(imgs)))
    assert got.shape == want.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    # its own seeded default is deterministic
    a = tfeat.RandomConvFeatures(dim=64, seed=1, device="cpu")(imgs)
    assert torch.equal(a, tfeat.RandomConvFeatures(dim=64, seed=1, device="cpu")(imgs))


def test_inception_trunk_matches_jax_convert_inception():
    sd = tfeat.random_state_dict("inception", seed=1)
    model = tfeat.InceptionV3().eval()
    model.load_state_dict(sd, strict=False)
    assert set(model.state_dict()) - set(sd) == {k for k in model.state_dict() if k.endswith("num_batches_tracked")}
    x = np.random.RandomState(3).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    jparams = jfeat.convert_inception({k: v.numpy() for k, v in sd.items()})
    want = np.asarray(jax.jit(jfeat.InceptionV3().apply)(jparams, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("size", [32, 512])
def test_inception_resize_matches_jax_image_resize(size):
    """Bilinear to 299² with half-pixel centres: a plain upsample from 32,
    an antialiased downsample from 512 (whose float32 tap weights differ
    from JAX's by rounding: up to 4.3e-6 of the [-1, 1] range seen)."""
    imgs = np.random.RandomState(size).randint(0, 256, (1, size, size, 3)).astype(np.uint8)
    got = tfeat.inception_input(torch.from_numpy(imgs).float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    x = jnp.asarray(imgs).astype(jnp.float32) / 255.0
    want = np.asarray(2.0 * jax.image.resize(x, (1, 299, 299, 3), "bilinear") - 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def vgg_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg16.pth"
    torch.save(tfeat.random_state_dict("vgg16", seed=2), path)
    return path


@pytest.mark.parametrize("size", [32, 256])
def test_vgg16_features_match_jax(vgg_weights, size):
    """32²: centre zero-padding to 224; 256²: nearest resize with half-pixel
    centres (JAX ``"nearest"``)."""
    imgs = np.random.RandomState(size).randint(0, 256, (1, size, size, 3)).astype(np.uint8)
    got = tfeat.VGG16Features(vgg_weights, device="cpu")(imgs).numpy()
    want = np.asarray(jfeat.VGG16Features(vgg_weights)(jnp.asarray(imgs)))
    assert got.shape == want.shape == (1, 4096)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
    x = torch.from_numpy(imgs).float().permute(0, 3, 1, 2)
    prepared = tfeat.vgg16_input(x).permute(0, 2, 3, 1).numpy()
    if size == 256:
        want_in = np.asarray(jax.image.resize(jnp.asarray(imgs).astype(jnp.float32) / 255.0, (1, 224, 224, 3), "nearest"))
        np.testing.assert_array_equal(prepared, want_in)
    else:
        assert prepared.shape == (1, 224, 224, 3) and prepared[0, :96].max() == 0 and prepared[0, 128:].max() == 0


def test_synthetic_dataset_and_batches_are_bit_identical():
    t, j = TSyntheticDataset(num_samples=7, image_size=8, seed=3), SyntheticDataset(num_samples=7, image_size=8, seed=3)
    for i in range(7):
        assert t[i]["image"].tobytes() == j[i]["image"].tobytes() and t[i]["label"] == j[i]["label"]
    got, want = list(t_iterate_batches(t, 3, [6, 0, 2, 5, 1])), list(iterate_batches(j, 3, [6, 0, 2, 5, 1]))
    assert [b["count"] for b in got] == [b["count"] for b in want] == [3, 2]
    for a, b in zip(got, want):
        assert a["image"].tobytes() == b["image"].tobytes() and a["label"].tobytes() == b["label"].tobytes()


def test_adm64_attention_layout_forward_matches_jax():
    """ADM-64's attention layout on a narrow ADM: heads of 16 channels by
    ``num_head_channels`` (ADM-64: 64) in the new qkv order, 6 output
    channels (epsilon and the variance channels ``compute_nll`` reads)."""
    over = dict(num_head_channels=16, num_heads_upsample=4, use_new_attention_order=True, out_channels=6)
    jcfg = dataclasses.replace(ADMUNetConfig.tiny(), **over)
    tcfg = dataclasses.replace(TADMUNetConfig.tiny(), **over)
    sd = make_adm_state_dict(jcfg, seed=7)
    tmodel = TADMUNet(tcfg).eval()
    tmodel.load_state_dict(torch_state_dict(sd))
    rng = np.random.RandomState(6)
    x, y = rng.randn(2, 16, 16, 3).astype(np.float32), np.array([4, 9])
    want = np.asarray(ADMUNet(jcfg).apply(convert_adm_unet(sd, jcfg), jnp.asarray(x), jnp.asarray(400), jnp.asarray(y)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), 400, torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
