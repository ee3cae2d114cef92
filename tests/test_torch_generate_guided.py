"""``scripts/generate_guided.py``, the guided-generation A/B CLI, against the
JAX CLI on ``tiny``, float32 on the CPU: the posterior run with FID on the
same weights and starting points, the JAX run's draws replayed into the
guided run (``test_torch_helpers.jax_guidance_noise``), and every
``--guidance`` branch of JAX's ``build_guidance`` writing its record.
Tolerances are stated in each test."""

from __future__ import annotations

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, jax_guidance_noise

import diffusion_uncertainty_torch.scripts.compute_fid as tfid
import diffusion_uncertainty_torch.scripts.generate_guided as tgg
import diffusion_uncertainty_tpu.scripts.generate_guided as jgg
from diffusion_uncertainty_torch.metrics.features import RandomConvFeatures as TRandomConvFeatures
from diffusion_uncertainty_tpu.metrics.features import RandomConvFeatures
from diffusion_uncertainty_tpu.utils.rng import batch_key, run_key

M = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU shapes: one intra-op thread, so the test workers sharing the
    cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_points(root, n=3):
    d = root / "data" / "diffusion-starting-points" / "tiny"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    np.savez(d / "X_T.npz", data=rng.randn(n, 16, 16, 3).astype(np.float32))
    np.savez(d / "y.npz", data=rng.randint(0, 10, size=n).astype(np.int32))


def test_generate_guided_matches_jax(monkeypatch, tmp_path):
    """``generate_guided --guidance posterior`` on ``tiny`` with FID on, both
    packages on the same starting points and weights (the JAX CLI's random
    init carried into the port), the JAX run's draws replayed into the
    guided run, the port's extractor given the JAX extractor's weights: the
    same record keys and values (FID within 1e-2 of JAX's, the images it is
    computed from within one uint8 step), and both records appended."""
    import diffusion_uncertainty_torch.factory as tfactory
    import diffusion_uncertainty_tpu.factory as jfactory
    from diffusion_uncertainty_torch.models import adm_state_dict_from_flax

    argv = ["--dataset", "tiny", "--guidance", "posterior", "--random-init", "true", "--dtype", "float32",
            "--num-samples", "3", "--batch-size", "2", "--generation-steps", "4", "--M", str(M),
            "--start-step-uc", "2", "--num-steps-uc", "2", "--threshold", "0.8"]
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    _tiny_points(tmp_path)
    images = {"jax": [], "port": []}
    j_gen = jgg.generate_uncertainty_dataset

    def j_spy(*a, **kw):
        res = j_gen(*a, **kw)
        images["jax"].append(res.gen_images)
        return res

    monkeypatch.setattr(jgg, "generate_uncertainty_dataset", j_spy)
    bundles = []
    j_inst = jfactory.instantiate_model_scheduler

    def j_inst_spy(*a, **kw):
        bundles.append(j_inst(*a, **kw))
        return bundles[-1]

    monkeypatch.setattr(jgg, "instantiate_model_scheduler", j_inst_spy)
    jrec = jgg.main(argv)

    # the port's bundle with the JAX run's random weights
    t_inst = tfactory.instantiate_model_scheduler

    def t_inst_same(*a, **kw):
        bundle = t_inst(*a, **kw)
        jb = bundles[0]
        sd = adm_state_dict_from_flax(jax.tree.map(np.asarray, jb.params["model"]), jb.model.cfg)
        bundle.model.load_state_dict(sd)
        return bundle

    monkeypatch.setattr(tgg, "instantiate_model_scheduler", t_inst_same)
    t_gen = tgg.generate_uncertainty_dataset

    def t_spy(*a, guidance=None, **kw):
        if guidance is not None:
            shape = (2, 16, 16, 3)
            per_batch = iter([jax_guidance_noise(batch_key(run_key(0), b), shape, 4, 2, 2, M) for b in range(2)])
            kw["noise_factory"] = lambda seed, dev: ReplayNoise(next(per_batch))
        res = t_gen(*a, guidance=guidance, **kw)
        images["port"].append(res.gen_images)
        return res

    monkeypatch.setattr(tgg, "generate_uncertainty_dataset", t_spy)
    jext = RandomConvFeatures(dim=256)
    monkeypatch.setattr(tfid, "make_extractor", lambda cfg: TRandomConvFeatures(
        dim=256, w1=np.asarray(jext._w1), w2=np.asarray(jext._w2), device=cfg.device))
    trec = tgg.main(argv + ["--device", "cpu"])

    assert sorted(trec) == sorted(jrec) and "fid_guided_vs_plain" in trec
    for k in jrec:
        if k != "fid_guided_vs_plain":
            assert trec[k] == jrec[k], k
    for got, want in zip(images["port"], images["jax"]):
        assert got.shape == want.shape == (3, 16, 16, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert not np.array_equal(images["port"][0], images["port"][1])  # the guidance moved the samples
    assert np.isfinite(trec["fid_guided_vs_plain"])
    # the FID of guided against plain (3e-4 here) is the distance of two sets
    # that differ by a few uint8 steps: one step of one pixel moves it by 1e-3
    np.testing.assert_allclose(trec["fid_guided_vs_plain"], jrec["fid_guided_vs_plain"], rtol=1e-2)
    log = (tmp_path / "results" / "uncertainty_guidance" / "results.json").read_text()
    assert log.count('"guidance": "posterior"') == 2
    shutil.rmtree(tmp_path / "data")


@pytest.mark.parametrize("guidance", ["gradient", "percentile", "second_order", "mask", "mc_dropout_gradient", "model_gradient"])
def test_generate_guided_runs_every_branch(monkeypatch, tmp_path, guidance):
    """Every ``--guidance`` branch of JAX's ``build_guidance`` runs on
    ``tiny`` and writes its record (without FID); a threshold file's
    ``window_offset`` sets the table's offset."""
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    _tiny_points(tmp_path)
    argv = ["--dataset", "tiny", "--guidance", guidance, "--random-init", "true", "--dtype", "float32", "--device", "cpu",
            "--num-samples", "2", "--batch-size", "2", "--generation-steps", "3", "--M", "2",
            "--start-step-uc", "2", "--num-steps-uc", "1", "--threshold", "0.8", "--compute-fid", "false"]
    if guidance == "second_order":
        np.savez(tmp_path / "thr.npz", data=np.full((2, 16, 16, 3), 1e-3, np.float32), window_offset=np.int64(1))
        argv += ["--threshold-file", str(tmp_path / "thr.npz")]
        cfg = dataclasses.replace(tgg.Config(), threshold_file=str(tmp_path / "thr.npz"), start_step_uc=0)
        with pytest.raises(SystemExit, match="window starts earlier"):
            tgg.build_guidance(cfg)
    rec = tgg.main(argv)
    assert rec["guidance"] == guidance and "fid_guided_vs_plain" not in rec
    assert (tmp_path / "results" / "uncertainty_guidance" / "results.json").exists()
