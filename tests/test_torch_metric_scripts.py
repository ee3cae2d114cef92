"""The port's five metric CLIs against the JAX package's, float32 on the CPU:
``compute_ause``, ``compute_nll``, ``compute_fid``, ``compute_precision_recall``
and ``compute_threshold_pixel_wise``.

* Each CLI, run on the tiny dataset (``--random-init true --device cpu``),
  writes the files its JAX counterpart writes, under the same names.
* ``compute_ause``'s per-batch function, with the same weights and the noise
  the JAX CLI drew replayed, gives the JAX CLI's reconstruction up to one
  uint8 step and its summed maps at the sampler tests' relative tolerance.
* ``compute_threshold_pixel_wise`` writes the JAX script's ``.npz`` bytes.
* ``compute_ause`` runs ``uncertainty_grad`` (a guidance) on ``tiny``.
* The metric, dataset and CLI modules import no JAX (a subprocess that
  blocks the import).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import ReplayNoise, jax_sampler_noise, make_adm_state_dict, torch_state_dict

import diffusion_uncertainty_torch.factory as tfactory
import diffusion_uncertainty_tpu.factory as jfactory
from diffusion_uncertainty_torch.datasets import iterate_batches as t_iterate_batches
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.factory import instantiate_model_scheduler as t_instantiate
from diffusion_uncertainty_torch.scripts import compute_ause as tause
from diffusion_uncertainty_torch.scripts import compute_fid as tfid
from diffusion_uncertainty_torch.scripts import compute_nll as tnll
from diffusion_uncertainty_torch.scripts import compute_precision_recall as tpr
from diffusion_uncertainty_torch.scripts import compute_threshold_pixel_wise as tthr
from diffusion_uncertainty_torch.scripts import generate_dataset_score_uncertainty as tgen
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig, resolve_scheduler_transform
from diffusion_uncertainty_torch.utils.config import parse_config, read_config
from diffusion_uncertainty_tpu.diffusion import make_schedule as j_make_schedule
from diffusion_uncertainty_tpu.metrics import compute_aucs as j_compute_aucs
from diffusion_uncertainty_tpu.models import ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet
from diffusion_uncertainty_tpu.scripts import compute_ause as jause
from diffusion_uncertainty_tpu.scripts import compute_fid as jfid
from diffusion_uncertainty_tpu.scripts import compute_nll as jnll
from diffusion_uncertainty_tpu.scripts import compute_precision_recall as jpr
from diffusion_uncertainty_tpu.scripts import compute_threshold_pixel_wise as jthr

REPO = Path(__file__).resolve().parents[1]
TINY = ["--dataset", "tiny", "--random-init", "true", "--dtype", "float32"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A dataset-CLI run of the port on the tiny dataset (6 images, window
    steps [1, 3) of 4), outside the CLIs' roots."""
    root = tmp_path_factory.mktemp("gen")
    mp = pytest.MonkeyPatch()
    mp.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(root))
    d = root / "data" / "diffusion-starting-points" / "tiny"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    np.savez(d / "X_T.npz", data=rng.randn(6, 16, 16, 3).astype(np.float32))
    np.savez(d / "y.npz", data=rng.randint(0, 10, size=6).astype(np.int32))
    try:
        return tgen.main(TINY + CPU + ["--scheduler-type", "uncertainty_centered", "--num-samples", "6", "--batch-size", "3",
                                       "--M", "2", "--generation-steps", "4", "--start-step-uc", "1", "--num-steps-uc", "2"])
    finally:
        mp.undo()


def _cli_runs(name: str, run: Path):
    """(JAX main, port main, [argv without --device, ...]) of one CLI."""
    drop = ["--run-dir", str(run), "--drop-fraction", "0.34"]
    return {
        "ause": (jause.main, tause.main, [TINY + ["--scheduler-type", "uncertainty_zigzag_centered", "--num-samples", "4",
                                                  "--batch-size", "2", "--num-steps-uc", "4", "--M", "2", "--num-zigzag", "2"]]),
        "nll": (jnll.main, tnll.main, [TINY + ["--num-samples", "2", "--batch-size", "2", "--variance-type", "fixed_small"]]),
        "fid": (jfid.main, tfid.main, [["--mode", "stats", "--dataset", "tiny", "--num-samples", "16", "--batch-size", "8"],
                                       ["--mode", "drop", "--dataset", "tiny"] + drop]),
        "precision_recall": (jpr.main, tpr.main, [["--mode", "real", "--dataset", "tiny", "--num-samples", "16",
                                                   "--batch-size", "8"],
                                                  ["--mode", "generated", "--dataset", "tiny", "--k", "2"] + drop]),
        "threshold": (jthr.main, tthr.main, [["--run-dirs", str(run), "--perc", "0.5"]]),
    }[name]


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("cli", ["ause", "nll", "fid", "precision_recall", "threshold"])
def test_cli_writes_the_files_of_its_jax_counterpart(monkeypatch, tmp_path, run_dir, cli):
    jax_main, port_main, argvs = _cli_runs(cli, run_dir)
    if cli == "nll":  # 20 train timesteps on both sides in place of the tiny dataset's 1000: the same files
        monkeypatch.setattr(jfactory, "init_scheduler", lambda dataset: j_make_schedule("linear", 20, 1e-4, 0.2))
        monkeypatch.setattr(tfactory, "init_scheduler",
                            lambda dataset, device="cuda": t_make_schedule("linear", 20, 1e-4, 0.2, device=device))
    port_cpu = CPU if cli != "threshold" else []  # the threshold CLI is host numpy: no --device
    outs = {}
    for side, main, extra in (("jax", jax_main, []), ("port", port_main, port_cpu)):
        monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path / side))
        outs[side] = [main(argv + extra) for argv in argvs]
    files = _files(tmp_path / "port")
    assert files and files == _files(tmp_path / "jax")
    for f in files:  # the YAML and JSON results read back with the same keys (the port's configs add device)
        a, b = tmp_path / "jax" / f, tmp_path / "port" / f
        if f.endswith(".yaml"):
            mine = read_config(b)
            assert mine == yaml.safe_load(b.read_text())
            assert mine.keys() - {"device"} == yaml.safe_load(a.read_text()).keys()
        elif f.endswith(".json"):
            assert json.loads(b.read_text())[0].keys() == json.loads(a.read_text())[0].keys()
    if cli == "ause":
        res = outs["port"][0]
        assert np.isfinite([res.ause, res.aurg]).all() and res.uncertainty_mean > 0 and res.images == 4
    if cli == "nll":
        assert np.isfinite(outs["port"][0].total_bpd) and outs["port"][0].total_bpd > 0
    if cli == "precision_recall":
        assert all(0.0 <= outs["port"][1][k] <= 1.0 for k in ("precision_drop_most", "recall_drop_most"))


def test_ause_run_batch_matches_jax(monkeypatch, tmp_path):
    """Same tiny ADM weights on both sides; the JAX CLI's maps and
    reconstructions are read where it hands them to ``compute_aucs``."""
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    jcfg = ADMUNetConfig.tiny()
    sd = make_adm_state_dict(jcfg, seed=5)
    real_instantiate = jause.instantiate_model_scheduler
    monkeypatch.setattr(jause, "instantiate_model_scheduler", lambda *a, **k: dataclasses.replace(
        real_instantiate(*a, **k), params={"model": convert_adm_unet(sd, jcfg)}))
    seen = {}

    def capture(gt, recon, unc, intervals):
        seen.update(recon=recon, unc=unc)
        return j_compute_aucs(gt, recon, unc, intervals=intervals)

    monkeypatch.setattr(jause, "compute_aucs", capture)
    argv = TINY + ["--scheduler-type", "uncertainty_zigzag_centered", "--num-samples", "3", "--batch-size", "2",
                   "--num-steps-uc", "6", "--M", "2", "--num-zigzag", "2", "--seed", "4"]
    jause.main(argv)

    cfg = parse_config(tause.Config, argv + CPU)
    bundle = t_instantiate("tiny", dtype=torch.float32, random_init=True, device="cpu")
    bundle.model.load_state_dict(torch_state_dict(sd))
    run_batch = tause.make_run_batch(bundle, cfg)
    dataset = tause.load_eval_dataset(cfg, bundle.image_size)
    indices = np.random.RandomState(cfg.seed).permutation(len(dataset))[: cfg.num_samples]
    n, half = cfg.num_steps_uc, cfg.num_steps_uc // 2
    recons, uncs = [], []
    for b, batch in enumerate(t_iterate_batches(dataset, cfg.batch_size, indices)):
        k_noise, k_sample = jax.random.split(jax.random.fold_in(jax.random.key(cfg.seed), b))
        shape = batch["image"].shape
        draws = [np.asarray(jax.random.normal(k_noise, shape, jnp.float32))]
        draws += jax_sampler_noise(k_sample, shape, n, half, n - half, cfg.M, cfg.num_zigzag, start_step=half)
        noise = ReplayNoise(draws)
        with torch.no_grad():
            recon, u = run_batch(torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"]).long(), noise)
        assert noise.used == len(draws)
        recons.append(recon.numpy()[: batch["count"]])
        uncs.append(u.numpy()[: batch["count"]])
    recon, unc = np.concatenate(recons).astype(np.float32) / 255.0, np.concatenate(uncs)
    assert recon.shape == seen["recon"].shape == (3, 16, 16, 3)
    np.testing.assert_allclose(recon, seen["recon"], rtol=0, atol=1.0001 / 255.0)  # up to one uint8 step
    assert np.mean(recon != seen["recon"]) < 0.01
    np.testing.assert_allclose(unc, seen["unc"], rtol=1e-3, atol=1e-3 * float(np.abs(seen["unc"]).max()))


@pytest.mark.parametrize("writer", ["port", "pyyaml"])
def test_threshold_npz_is_byte_equal_to_jax(monkeypatch, tmp_path, run_dir, writer):
    """On the same run folder, with the zip timestamps pinned; the run's
    ``args.yaml`` as the port writes it (JSON values) or as PyYAML does."""
    run = tmp_path / "run"
    shutil.copytree(run_dir, run)
    if writer == "pyyaml":
        (run / "args.yaml").write_text(yaml.safe_dump(read_config(run_dir / "args.yaml")))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    outs = {}
    for side, main in (("jax", jthr.main), ("port", tthr.main)):
        monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path / side))
        outs[side] = main(["--run-dirs", str(run), "--perc", "0.34"])
    assert outs["port"].relative_to(tmp_path / "port") == outs["jax"].relative_to(tmp_path / "jax")
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    with np.load(outs["port"]) as f:
        assert f["data"].shape == (2, 16, 16, 3) and int(f["window_offset"]) == 1


def test_ause_mc_dropout_runs_through_select_apply_fn(monkeypatch, tmp_path):
    """``mc_dropout``: the dropout forward (``select_apply_fn``) serves the
    ensemble only, so two runs with one seed agree and the maps are positive."""
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    argv = TINY + CPU + ["--scheduler-type", "mc_dropout", "--num-samples", "3", "--batch-size", "2",
                         "--num-steps-uc", "4", "--M", "2"]
    a, b = tause.main(argv), tause.main(argv)
    assert a.ause == b.ause and a.uncertainty_mean == b.uncertainty_mean > 0 and np.isfinite(a.aurg)
    assert (tmp_path / "results" / "ause" / "tiny" / "ause_vs_M_mc_dropout.jsonl").read_text().count("\n") == 2


def test_uncertainty_grad_names_its_roadmap_item(monkeypatch, tmp_path):
    """``uncertainty_grad`` (ROADMAP.md queue 1 item 23, now ported) resolves
    to its guidance, and ``compute_ause`` runs it on ``tiny``."""
    est, guidance = resolve_scheduler_transform(EstimatorConfig(name="uncertainty_grad"))
    assert est is None and guidance is not None
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    res = tause.main(TINY + CPU + ["--scheduler-type", "uncertainty_grad", "--num-samples", "3", "--batch-size", "2",
                                   "--num-steps-uc", "4", "--M", "2"])
    assert np.isfinite(res.ause) and np.isfinite(res.aurg) and res.uncertainty_mean > 0 and res.images == 3
    assert (tmp_path / "results" / "ause" / "tiny" / "results_uncertainty_grad.yaml").exists()
    est, guidance = resolve_scheduler_transform(EstimatorConfig(name="uncertainty_zigzag_centered"))
    assert callable(est) and guidance is None


_NO_JAX = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "diffusion_uncertainty_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
mods = ["diffusion_uncertainty_torch.metrics", "diffusion_uncertainty_torch.metrics.features",
        "diffusion_uncertainty_torch.datasets", "diffusion_uncertainty_torch.utils.logging"]
mods += ["diffusion_uncertainty_torch.scripts." + s for s in ("compute_ause", "compute_nll", "compute_fid",
         "compute_precision_recall", "compute_threshold_pixel_wise")]
for m in mods:
    importlib.import_module(m)
import numpy as np
from diffusion_uncertainty_torch.metrics import compute_aucs
from diffusion_uncertainty_torch.metrics.features import RandomConvFeatures
compute_aucs(np.zeros(8), np.ones(8), np.arange(8.0))
RandomConvFeatures(dim=8, device="cpu")(np.zeros((1, 8, 8, 3), np.uint8))
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no jax")
"""


def test_metric_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "no jax", out.stderr[-2000:]
