"""The port's timing, grid and run-analysis CLIs against the JAX package's,
on the CPU (``--device cpu --random-init true``, the tiny configuration of
``tests/test_scripts.py`` and ``tests/test_pipeline.py``), and the utilities
they use.

* ``measure_times`` (both baselines) and ``uncertainty_benchmark`` (every
  estimator method and two guided ones) append records with the JAX CLIs'
  keys (the JAX CLI's own record, its sampling stubbed out, gives the keys).
* ``summary_experiments`` prints the JAX CLI's table, byte for byte, for a
  results folder holding a run of the port's dataset CLI and a run folder
  the JAX package's utilities wrote; ``--clean`` removes the same runs.
* ``plot_results`` writes every ``--kind`` under the JAX CLI's file name,
  from a run of the port's dataset CLI and the records of the port's
  ``measure_times``, ``compute_fid``, ``compute_precision_recall`` and
  ``compute_ause``, and reads a run folder the JAX package wrote.
* ``utils.experiments`` (``find_runs``, ``clean_empty_runs``),
  ``utils.interop``, ``utils.profiling`` and ``utils.logging.Timer``
  against their JAX counterparts or their contracts.
* The slice's modules import no JAX (a subprocess that blocks the import)
  and run the DDPM and KDPM2 samplers there.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import diffusion_uncertainty_tpu.scripts.measure_times as jmt
import diffusion_uncertainty_tpu.scripts.uncertainty_benchmark as jub
from diffusion_uncertainty_torch.scripts import compute_ause as tause
from diffusion_uncertainty_torch.scripts import compute_fid as tfid
from diffusion_uncertainty_torch.scripts import compute_precision_recall as tpr
from diffusion_uncertainty_torch.scripts import generate_dataset_score_uncertainty as tgen
from diffusion_uncertainty_torch.scripts import measure_times as tmt
from diffusion_uncertainty_torch.scripts import plot_results as tplot
from diffusion_uncertainty_torch.scripts import summary_experiments as tsum
from diffusion_uncertainty_torch.scripts import uncertainty_benchmark as tub
from diffusion_uncertainty_torch.utils import experiments as texp
from diffusion_uncertainty_torch.utils import interop as tinterop
from diffusion_uncertainty_torch.utils import paths as tpaths
from diffusion_uncertainty_torch.utils.config import save_config
from diffusion_uncertainty_torch.utils.logging import Timer
from diffusion_uncertainty_torch.utils.profiling import device_timeit, trace
from diffusion_uncertainty_tpu.scripts import plot_results as jplot
from diffusion_uncertainty_tpu.scripts import summary_experiments as jsum
from diffusion_uncertainty_tpu.utils import experiments as jexp
from diffusion_uncertainty_tpu.utils import interop as jinterop

REPO = Path(__file__).resolve().parents[1]
TINY = ["--dataset", "tiny", "--random-init", "true", "--dtype", "float32"]
CPU = ["--device", "cpu"]
SHORT = ["--generation-steps", "4", "--M", "2", "--start-step-uc", "1", "--num-steps-uc", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU shapes: one intra-op thread, so the test workers sharing the
    cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def root(tmp_path, monkeypatch):
    """A results root with 12 tiny starting points (both packages read it)."""
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    d = tpaths.ensure(tpaths.starting_points() / "tiny")
    rng = np.random.RandomState(49394)
    np.savez(d / "X_T.npz", data=rng.randn(12, 16, 16, 3).astype(np.float32))
    np.savez(d / "y.npz", data=rng.randint(0, 10, 12).astype(np.int32))
    return tmp_path


def _port_run(run_dir=None):
    """A run of the port's dataset CLI on the tiny dataset: 6 images in two
    shards, window steps [1, 3) of 4."""
    extra = ["--run-dir", str(run_dir)] if run_dir else []
    return tgen.main(TINY + CPU + SHORT + extra + ["--scheduler-type", "uncertainty_centered", "--num-samples", "6",
                                                   "--batch-size", "3"])


def test_measure_times_records_the_jax_keys(root, monkeypatch):
    monkeypatch.setattr(jmt, "_time", lambda fn, *a, repeats=3: 0.5)  # the JAX record without its sampling
    want = jmt.main(TINY + ["--batch-size", "2", "--repeats", "1"] + SHORT)
    got = [tmt.main(TINY + CPU + ["--batch-size", "2", "--repeats", "1", "--baseline", b] + SHORT) for b in ("ddim", "kdpm2")]
    for rec, b in zip(got, ("ddim", "kdpm2")):
        assert rec.keys() == want.keys() and rec["baseline"] == b and rec["device"] == "cpu"
        assert rec["overhead_x"] > 0 and rec["images_per_sec_plain"] > 0
    records = json.loads((tpaths.results() / "times.json").read_text())
    assert len(records) == 3 and [r["baseline"] for r in records] == ["ddim", "ddim", "kdpm2"]
    assert records[1].keys() == records[0].keys()  # both with the sink's ts


def test_measure_times_warms_up_and_takes_the_minimum():
    calls, syncs = [], []
    t = tmt._time(lambda: calls.append(1), repeats=3, sync=lambda: syncs.append(len(calls)))
    assert len(calls) == 4 and syncs == [1, 2, 2, 3, 3, 4] and t >= 0.0


def test_uncertainty_benchmark_records_the_jax_keys(root, monkeypatch):
    assert (tub.ESTIMATOR_METHODS, tub.GUIDED_METHODS) == (jub.ESTIMATOR_METHODS, jub.GUIDED_METHODS)
    monkeypatch.setattr(jub, "generate_uncertainty_dataset",
                        lambda *a, **kw: type("R", (), {"uncertainty": np.ones(2)})())
    want = jub.main(TINY + ["--methods", "flip", "--num-samples", "2", "--batch-size", "2"])[0]
    methods = tub.ESTIMATOR_METHODS + ("uncertainty_threshold", "mc_dropout_gradient")
    rows = tub.main(TINY + CPU + ["--methods", ",".join(methods), "--num-samples", "4", "--batch-size", "2",
                                  "--generation-steps", "4", "--M", "2", "--num-steps-uc", "4"])
    assert [r["method"] for r in rows] == list(methods)
    for r in rows:
        assert r.keys() == want.keys() and r["images_per_sec"] > 0 and np.isfinite(r["mean_uncertainty"]), r
    assert len(json.loads((tpaths.results() / "uncertainty_benchmark.json").read_text())) == 1 + len(methods)


def _jax_run(name="jax_run"):
    """A run folder the JAX package's utilities wrote: its PyYAML args.yaml
    and shards of the dataset CLI's names."""

    @dataclasses.dataclass
    class Meta:
        dataset: str = "tiny"
        scheduler_type: str = "uncertainty_zigzag_centered"
        num_samples: int = 4
        M: int = 3

    run = jexp.new_run_dir(config=Meta(), timestamp=name)
    rng = np.random.RandomState(3)
    for shard in (0, 1):
        jexp.save_shard(run, "gen_images", shard, rng.randint(0, 255, (2, 16, 16, 3)).astype(np.uint8))
        jexp.save_shard(run, "uncertainty", shard, rng.rand(2, 3, 16, 16, 3).astype(np.float32))
    return run


def test_summary_prints_the_jax_table(root, capsys):
    port_run = _port_run()
    _jax_run()
    empty = tpaths.ensure(tpaths.score_uncertainty() / "empty_run")
    save_config({"dataset": "tiny"}, empty / "args.yaml")
    capsys.readouterr()
    tables = {}
    for side, main in (("jax", jsum.main), ("port", tsum.main)):
        rows = main([])
        tables[side] = (rows, capsys.readouterr().out)
    assert tables["port"] == tables["jax"]
    rows = tables["port"][0]
    assert [r[0] for r in rows] == sorted([port_run.name, "jax_run", "empty_run"])
    by_name = {r[0]: r for r in rows}
    assert by_name[port_run.name][1:] == ["tiny", "uncertainty_centered", 6, 2, 4, 1, 2, 2]
    assert by_name["jax_run"][-1] == 2 and by_name["empty_run"][2:] == ["-"] * 6 + [0]
    assert tsum.main(["--clean", "true"]) == [r for r in rows if r[0] != "empty_run"]
    assert capsys.readouterr().out.startswith("removed 1 empty runs\n") and not empty.exists()
    assert sorted(p.name for p in texp.find_runs()) == sorted([port_run.name, "jax_run"])


def test_summary_with_no_runs(root, capsys):
    assert tsum.main([]) == [] and "no runs found under" in capsys.readouterr().out


def test_find_runs_and_clean_match_jax(root):
    port_run = _port_run()
    _jax_run()
    tpaths.ensure(tpaths.score_uncertainty() / "crashed")
    (tpaths.score_uncertainty() / "crashed" / "args.yaml").write_text("dataset: [unclosed\n")  # unreadable: skipped
    for query in ({}, {"dataset": "tiny"}, {"scheduler_type": "uncertainty_centered"}, {"M": 3}, {"M": 99}):
        assert list(texp.find_runs(**query)) == list(jexp.find_runs(**query)), query
    assert list(texp.find_runs(scheduler_type="uncertainty_centered")) == [port_run]
    assert list(texp.find_runs(tpaths.root() / "nowhere")) == []
    removed = texp.clean_empty_runs()
    assert [p.name for p in removed] == ["crashed"] and jexp.clean_empty_runs() == []


def _records(root, run):
    """The result records the record-based kinds read, written by the port's CLIs."""
    tmt.main(TINY + CPU + ["--batch-size", "2", "--repeats", "1"] + SHORT)
    tfid.main(["--mode", "stats", "--dataset", "tiny", "--num-samples", "12", "--batch-size", "6"] + CPU)
    for frac in ("0.2", "0.5"):
        tfid.main(["--mode", "drop", "--dataset", "tiny", "--run-dir", str(run), "--drop-fraction", frac] + CPU)
    tpr.main(["--mode", "real", "--dataset", "tiny", "--num-samples", "12", "--batch-size", "6"] + CPU)
    for m in ("2", "3"):
        tause.main(TINY + CPU + ["--scheduler-type", "uncertainty_centered", "--num-samples", "2", "--batch-size", "2",
                                 "--num-steps-uc", "2", "--M", m])
    # two saved text-to-image runs per prompt (the SD grids), as the t2i CLI names its files
    from PIL import Image

    base = tpaths.ensure(tpaths.sd_uncertainty_guidance())
    rng = np.random.RandomState(0)
    for i, (prompt, perc) in enumerate([("a cat", 0.9), ("a cat", 0.95), ("a dog", 0.9), ("a dog", 0.95)]):
        d = tpaths.ensure(base / str(i))
        save_config({"prompt": prompt, "percentile": perc}, d / "args.yaml")
        for name in ("output_sd_uc.png", "output_sd.png"):
            Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8)).save(d / name)


def test_plot_results_writes_every_kind(root):
    run = _port_run()
    _records(root, run)
    kinds = sorted(jplot._KINDS)
    assert sorted(tplot._KINDS) == kinds
    extra = {"denoising_schedule": ["--stride", "1"], "pr_curve": ["--dataset", "tiny", "--group-size", "4",
                                                                  "--num-groups", "2", "--k", "2"],
             "sd_row": ["--prompt", "a cat"], "ause_vs_m": ["--dataset", "tiny"], "ause_m": ["--dataset", "tiny"]}
    for kind in kinds:
        out = tplot.main(["--kind", kind, "--run-dir", str(run), "--num-images", "4"] + CPU + extra.get(kind, []))
        assert out == tpaths.results() / "plots" / f"{kind}.png" and out.stat().st_size > 0, kind
    assert sorted(p.name for p in (tpaths.results() / "plots").iterdir()) == sorted(f"{k}.png" for k in kinds)
    with pytest.raises(SystemExit):
        tplot.main(["--kind", "nope"])


def test_plot_results_reads_a_jax_run(root):
    run = _jax_run()
    for kind in ("uncertainty_schedule", "image_grid", "uncertainty_maps", "denoising_schedule"):
        out = tplot.main(["--kind", kind, "--run-dir", str(run), "--stride", "2", "--out", str(root / f"{kind}.png")])
        assert out.stat().st_size > 0, kind


def test_interop_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "args.yaml").write_text("dataset: tiny\n")
    for shard in (0, 2):
        torch.save(torch.from_numpy(rng.rand(2, 3, 8, 8).astype(np.float32)), ref / f"gen_images_{shard}.pth")
        torch.save(torch.from_numpy(rng.rand(2, 4, 3, 8, 8).astype(np.float32)), ref / f"uncertainty_{shard}.pth")
    tinterop.import_reference_run(ref, tmp_path / "port")
    jinterop.import_reference_run(ref, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for n in names:
        a, b = tmp_path / "jax" / n, tmp_path / "port" / n
        if n.endswith(".npz"):
            np.testing.assert_array_equal(np.load(a)["data"], np.load(b)["data"])
        else:
            assert a.read_text() == b.read_text()
    assert texp.load_run_arrays(tmp_path / "port", "uncertainty").shape == (4, 4, 8, 8, 3)
    x = rng.rand(2, 8, 8, 3).astype(np.float32)
    tinterop.save_pth_array(tmp_path / "x.pth", x)
    np.testing.assert_array_equal(jinterop.load_pth_array(tmp_path / "x.pth"), x)
    np.testing.assert_array_equal(tinterop.load_pth_array(tmp_path / "x.pth"), x)
    with pytest.raises(FileNotFoundError):
        tinterop.import_reference_run(tmp_path / "port", tmp_path / "none")


def test_profiling_and_timer(tmp_path):
    out = device_timeit(lambda a: a * 2, torch.ones(4), repeats=2)
    assert set(out) == {"min_s", "mean_s", "times"} and len(out["times"]) == 2 and out["min_s"] <= out["mean_s"]
    with trace(tmp_path / "tr"):
        torch.ones(8) @ torch.ones(8)
    assert "traceEvents" in json.loads((tmp_path / "tr" / "trace.json").read_text())
    with Timer() as t:
        sum(range(1000))
    assert t.elapsed >= 0.0


_NO_JAX = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "diffusion_uncertainty_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
mods = ["diffusion_uncertainty_torch.diffusion.ddpm", "diffusion_uncertainty_torch.diffusion.kdpm2",
        "diffusion_uncertainty_torch.utils.profiling", "diffusion_uncertainty_torch.utils.interop",
        "diffusion_uncertainty_torch.utils.experiments", "chip_smoke"]
mods += ["diffusion_uncertainty_torch.scripts." + s for s in ("measure_times", "uncertainty_benchmark",
         "summary_experiments", "plot_results")]
for m in mods:
    importlib.import_module(m)
import dataclasses, torch
from diffusion_uncertainty_torch.diffusion import SamplerConfig, make_schedule, sample_ddpm
from diffusion_uncertainty_torch.diffusion.kdpm2 import KDPM2Config, sample_kdpm2
from diffusion_uncertainty_torch.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_torch.utils import TorchNoise
m = ADMUNet(dataclasses.replace(ADMUNetConfig.tiny(), out_channels=6)).eval()
s, x = make_schedule("linear", 1000, device="cpu"), torch.zeros(1, 16, 16, 3)
a = sample_ddpm(lambda x, t, n: m(x, t, torch.zeros(1, dtype=torch.long)), s, x, TorchNoise(0, "cpu"),
                SamplerConfig(num_inference_steps=2), variance_type="learned_range")
b = sample_kdpm2(lambda x, t, n: m(x, t, torch.zeros(1, dtype=torch.long))[..., :3], s, x, None, KDPM2Config(num_inference_steps=2))
assert a.sample.shape == b.sample.shape == x.shape
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no jax")
"""


def test_slice_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "no jax", out.stderr[-2000:]
