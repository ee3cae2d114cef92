"""The classifier-guided, DPM-Solver++, activation-noise and gradient-guided
ImageNet-128 paths alone in a process, on the card: images/s, where the time
goes, and a digest of the output.

    python -m diffusion_uncertainty_torch.scripts.bench_guided_path [--runs 3] [--json PATH]
    PYTHONPATH=<another checkout> python <this file> [--runs 3] [--json PATH]

No JAX counterpart. The protocols of ``chip_smoke.py`` phases 11b and 11c
through the functions the dataset CLI calls, without the phases before them:
the factory's ``imagenet128`` bundle (ADM-128, seeded random bf16 weights)
and, for ``guided``, ``load_classifier`` (float32, seeded random) wrapped by
``with_classifier_guidance`` at scale 1.0 around the trajectory forward;
``generate_uncertainty_dataset`` at batch 8 with 50 steps and the window
[40, 50): ``guided`` runs DDIM with zigzag-centered M=5 x3 (its ensemble on
the unguided model), ``dpm`` DPM-Solver++ with the centered estimator, M=5,
``uncertainty`` DDIM with the activation-noise estimator (M=5 on the
bundle's ``apply_fn_act_noise``), ``uncertainty_grad`` DDIM with the
gradient guidance (M=5: a forward and a backward at the folded batch 40 a
window step), as ``chip_smoke.py`` phase 12a runs them.
Starting points and labels come from a seeded numpy generator. One warm-up
run each, then ``--runs`` runs timed on the host clock (each ending in a
synchronize), then one run with a synchronize around every ADM call and
every guidance term or window step, which splits its time into ADM calls at
batch 8, ADM calls at the folded batch 40, guidance terms, the gradient
guidance's backwards (its window steps less their forwards) and the rest
(the sampler's and the estimator's own work and the host), and, apart from
the runs, the time to write the run's shards (``save_shard``: images, maps, scores). The digest
(float64 sums of the uint8 images and the maps) shows whether two checkouts
compute the same output. Run with another checkout first on the path, it
runs that checkout's port.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

BATCH = 8
M = 5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3, help="timed runs of each protocol")
    ap.add_argument("--json", help="write the runs, the split and the digests to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_guided_path: needs a CUDA card")
    from diffusion_uncertainty_torch.classifier_guidance import with_classifier_guidance
    from diffusion_uncertainty_torch.diffusion import SamplerConfig
    from diffusion_uncertainty_torch.factory import instantiate_model_scheduler, load_classifier
    from diffusion_uncertainty_torch.sampling import generate_uncertainty_dataset
    from diffusion_uncertainty_torch.uncertainty import EstimatorConfig, Guidance, make_estimator, resolve_scheduler_transform
    from diffusion_uncertainty_torch.utils.experiments import save_shard

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    bundle = instantiate_model_scheduler("imagenet128", random_init=True)
    classifier = load_classifier("imagenet128", random_init=True)
    rng = np.random.RandomState(0)
    x_t = rng.randn(BATCH, 128, 128, 3).astype(np.float32)
    y = rng.randint(0, 1000, BATCH)
    split = defaultdict(float)
    timing = [False]

    def timed(fn, key):
        def call(x, *a):
            if not timing[0]:
                return fn(x, *a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, *a)
            torch.cuda.synchronize()
            split[key(x) if callable(key) else key] += time.perf_counter() - t0
            return out

        return call

    adm = timed(bundle.apply_fn, lambda x: f"ADM calls at batch {x.shape[0]}")
    # a guided call is a trajectory ADM call at batch 8 and the guidance term
    guided = timed(with_classifier_guidance(adm, classifier, bundle.schedule, 1.0), "guided calls")
    scfg = SamplerConfig(num_inference_steps=50, after_step=40, num_steps_uc=10)
    act_noise = timed(bundle.apply_fn_act_noise, lambda x: f"ADM calls at batch {x.shape[0]}")
    grad_guidance = resolve_scheduler_transform(EstimatorConfig(name="uncertainty_grad", M=M))[1]
    protocols = {
        "guided": dict(apply_fn=guided, estimator_apply_fn=adm, sampler="ddim",
                       estimator=make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=M, num_zigzag=3))),
        "dpm": dict(apply_fn=adm, sampler="dpm",
                    estimator=make_estimator(EstimatorConfig(name="dpm_2_uncertainty_centered", M=M))),
        "uncertainty": dict(apply_fn=adm, estimator_apply_fn=act_noise, sampler="ddim",
                            estimator=make_estimator(EstimatorConfig(name="uncertainty", M=M))),
        "uncertainty_grad": dict(apply_fn=adm, sampler="ddim",
                                 guidance=Guidance(grad_guidance.init, timed(grad_guidance.apply, "window steps"))),
    }
    out = {"card": card}
    for name, kw in protocols.items():
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = generate_uncertainty_dataset(schedule=bundle.schedule, sampler_cfg=scfg, X_T=x_t, y=y,
                                               batch_size=BATCH, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        run()  # warm-up: cuDNN and cuBLAS plans at both batches
        runs = [BATCH / run()[1] for _ in range(args.runs)]
        split.clear()
        timing[0] = True
        res, total = run()
        timing[0] = False
        parts = {k: v for k, v in split.items() if k not in ("guided calls", "window steps")}
        if "guided calls" in split:
            parts["guidance terms (classifier forward + backward)"] = split["guided calls"] - split[f"ADM calls at batch {BATCH}"]
        if "window steps" in split:
            parts["backwards and the guidance's own work"] = split["window steps"] - split[f"ADM calls at batch {M * BATCH}"]
        parts["the rest (sampler, estimator, host)"] = total - sum(parts.values())
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            for kind, arr in (("gen_images", res.gen_images), ("uncertainty", res.uncertainty), ("score", res.pred_epsilon)):
                save_shard(Path(d), kind, 0, arr)
            write_s = time.perf_counter() - t0
        digest = {"images_sum": float(res.gen_images.astype(np.float64).sum()),
                  "uncertainty_sum": float(res.uncertainty.astype(np.float64).sum())}
        out[name] = {"images_per_s": runs, "split_s": parts, "split_total_s": total, "shard_write_s": write_s, **digest}
        print(f"{name}: images/s {' '.join(f'{r:.4f}' for r in runs)}; one run with a synchronize around every call "
              f"{total:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
              + f"; shard writes {write_s:.3f} s; digest {json.dumps(digest)}; {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
