"""The U-ViT dataset path alone in a process, on the card: images/s of the
zigzag-uncertainty run of ``imagenet256`` (or ``imagenet512``) with its
bf16 VAE decode, and a digest of its output.

    python -m diffusion_uncertainty_torch.scripts.bench_uvit_path [--dataset imagenet256] [--runs 3] [--json PATH]
    PYTHONPATH=<another checkout> python <this file> [--runs 3] [--json PATH]

No JAX counterpart. The protocol of ``chip_smoke.py`` phase 10b without the
phases before it: the factory's bundle (U-ViT-huge and the KL-VAE decoder,
seeded random bf16 weights), ``generate_uncertainty_dataset`` with
zigzag-centered M=5 x3, 50 DDIM steps, the window [40, 50), batch 8, the
final latents decoded to images; latents and labels from a seeded numpy
generator. One warm-up forward at the folded ensemble's batch and one
decode, then ``--runs`` runs timed on the host clock (each ending in a
synchronize). The digest (float64 sums of the uint8 images and of the
uncertainty maps) shows whether two checkouts compute the same output. Run
with another checkout first on the path, it runs that checkout's port.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 8
M = 5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="imagenet256", help="imagenet256 | imagenet512")
    ap.add_argument("--runs", type=int, default=3, help="timed runs")
    ap.add_argument("--json", help="write the runs and the digest to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_uvit_path: needs a CUDA card")
    from diffusion_uncertainty_torch.diffusion import SamplerConfig
    from diffusion_uncertainty_torch.factory import instantiate_model_scheduler
    from diffusion_uncertainty_torch.sampling import generate_uncertainty_dataset
    from diffusion_uncertainty_torch.uncertainty import EstimatorConfig, make_estimator

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    bundle = instantiate_model_scheduler(args.dataset, random_init=True)
    rng = np.random.RandomState(0)
    x_t = rng.randn(BATCH, *bundle.sample_shape).astype(np.float32)
    y = rng.randint(0, 1000, BATCH)
    with torch.no_grad():  # cuBLAS and cuDNN plans at the run's shapes
        z = torch.from_numpy(x_t).cuda()
        bundle.apply_fn(z.repeat(M, 1, 1, 1), 999, torch.from_numpy(y).cuda(), None)
        bundle.decode_fn(z)
    torch.cuda.synchronize()
    runs = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        res = generate_uncertainty_dataset(
            bundle.apply_fn, bundle.schedule, SamplerConfig(num_inference_steps=50, after_step=40, num_steps_uc=10),
            x_t, y, BATCH, estimator=make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=M, num_zigzag=3)),
            decode_fn=bundle.decode_fn,
        )
        torch.cuda.synchronize()
        runs.append(BATCH / (time.perf_counter() - t0))
    digest = {"images_sum": float(res.gen_images.astype(np.float64).sum()),
              "uncertainty_sum": float(res.uncertainty.astype(np.float64).sum())}
    print(f"U-ViT path ({args.dataset}), batch {BATCH}: images/s {' '.join(f'{r:.4f}' for r in runs)}; "
          f"digest {json.dumps(digest)}; {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "dataset": args.dataset, "images_per_s": runs, **digest}, indent=1))


if __name__ == "__main__":
    main()
