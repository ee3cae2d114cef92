"""The ADM-128 main path alone in a process, on the card: images/s of the
zigzag-uncertainty sampling run, and a digest of its output.

    python -m diffusion_uncertainty_torch.scripts.bench_adm_path [--runs 3] [--json PATH]
    PYTHONPATH=<another checkout> python <this file> [--runs 3] [--json PATH]

No JAX counterpart. The protocol of ``chip_smoke.py`` phase 4 without the
phases before it: ImageNet-128 ADM at full width with seeded random bf16
weights (``init_random_``, seed 0), batch 8, 50 DDIM steps, zigzag-centered
M=5 x3 in the window [40, 50), inputs from a seeded generator. One warm-up
forward, then ``--runs`` sampling runs timed on the host clock (each ending in
a synchronize). The digest (the float64 sums of the sample and of the
uncertainty) shows whether two checkouts compute the same output. Run with
another checkout first on the path, it runs that checkout's model.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

BATCH = 8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3, help="timed sampling runs")
    ap.add_argument("--json", help="write the runs and the digest to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_adm_path: needs a CUDA card")
    from diffusion_uncertainty_torch.diffusion import SamplerConfig, make_schedule, sample_ddim
    from diffusion_uncertainty_torch.models import ADMUNet, ADMUNetConfig
    from diffusion_uncertainty_torch.scripts.generate_t2i_guided import init_random_
    from diffusion_uncertainty_torch.uncertainty import EstimatorConfig, make_estimator
    from diffusion_uncertainty_torch.utils import TorchNoise

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cfg = ADMUNetConfig.imagenet128()
    with torch.device(dev):
        model = init_random_(ADMUNet(cfg), seed=0)
    model = model.to(dtype=torch.bfloat16, memory_format=torch.channels_last).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.randint(0, cfg.num_classes, (BATCH,), generator=gen, device=dev)
    x_T = torch.randn(BATCH, 128, 128, 3, generator=gen, device=dev).to(torch.bfloat16)
    sched = make_schedule("linear", 1000, device=dev)
    scfg = SamplerConfig(num_inference_steps=50, after_step=40, num_steps_uc=10)
    est = make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=5, num_zigzag=3, ensemble_chunk=1))

    def model_fn(x, t, _):
        return model(x, t, y)[..., :3]

    with torch.no_grad():
        model_fn(x_T, 999, None)  # warm-up at this batch
    torch.cuda.synchronize()
    runs = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        res = sample_ddim(model_fn, sched, x_T, TorchNoise(1, dev), scfg, estimator=est)
        torch.cuda.synchronize()
        runs.append(BATCH / (time.perf_counter() - t0))
    digest = {"sample_sum": float(res.sample.double().sum()), "uncertainty_sum": float(res.uncertainty.double().sum())}
    print(f"ADM-128 main path, batch {BATCH}: images/s {' '.join(f'{r:.4f}' for r in runs)}; "
          f"digest {json.dumps(digest)}; {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "images_per_s": runs, **digest}, indent=1))


if __name__ == "__main__":
    main()
