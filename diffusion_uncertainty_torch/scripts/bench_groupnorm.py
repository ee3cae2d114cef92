"""The GroupNorm pair (``gn_stats`` + ``gn_apply``) at the SD VAE decoder's
pair maps, on the card.

    python -m diffusion_uncertainty_torch.scripts.bench_groupnorm [--dtype float32] [--json PATH]
    PYTHONPATH=<another checkout> python <this file> [--json PATH]

No JAX counterpart. The sites (``SITES``) are the decoder's GroupNorm inputs
that take the pair at batch 1 (a 64x64 latent, 512x512 image), with their
calls per decode: 19 in all, every one with SiLU and without scale-shift.
Per site, for ``gn_stats``, ``gn_apply`` and the two back to back (``pair``):
``ms``, CUDA events around 10 back-to-back wrapper calls (x stays in the 50
MB L2 between calls where it fits, as a decode's conv output partly does);
``device_only_ms``, the same calls captured once in a CUDA graph and timed by
its replays; ``cold_ms``, one call after 128 MB of writes has flushed the L2
(events around one replay of the call captured in a CUDA graph); for
``gn_apply`` also ``after_stats_ms``, the same right after one ``gn_stats``
call on the flushed L2, as the pair runs it (``gn_stats`` leaves the rows it
read last in the L2). Beside them the one PyTorch call of each
function where there is one: ``torch.var_mean`` of the [N, HW, G, gs] view
over (1, 3) for the statistics, ``F.group_norm`` + ``F.silu`` on the
channels_last view for the pair (``gn_apply``'s FMA + SiLU has none); the
bound, bytes moved (each input read once, each output written once) over
3.35 TB/s; whether two ``gn_stats`` calls gave bit-identical A, B; and the
route the launches took. The sums add the distinct sites once
(``shapes``) and by their calls per decode (``decode``). Run with another
checkout first on the path, it times that checkout's kernels with this
file's clocks.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
GROUPS, EPS = 32, 1e-6  # the VAE decoder's GroupNorms
# (H, W, C): calls per decode, the decoder's levels from 128x128 up
SITES = {(128, 128, 512): 6, (256, 256, 512): 1, (256, 256, 256): 5, (512, 512, 256): 1, (512, 512, 128): 6}
FLUSH_BYTES = 128 << 20  # writes that push x out of the 50 MB L2
KERNELS = ("gn_stats", "gn_apply", "pair")
CLOCKS = ("ms", "device_only_ms", "cold_ms")


def _clocks():
    """``device_ms``, ``graph_ms`` of this file's checkout (a standalone
    module: the package on the path may be another checkout's)."""
    path = Path(__file__).resolve().parents[1] / "utils" / "device.py"
    spec = importlib.util.spec_from_file_location("_bench_groupnorm_clocks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms, mod.graph_ms


def _graph(fn) -> torch.cuda.CUDAGraph:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def cold_ms(fn, flush: torch.Tensor, reps: int = 7, before=None) -> float:
    """Median device time of one call of ``fn`` right after ``flush`` was
    overwritten (the write evicts what the L2 held) and, where given, one
    call of ``before`` ran (it leaves in the L2 what it read last). The calls
    are captured in CUDA graphs and replayed, so the host's time to launch
    them stays inside the flush's."""
    graph, first = _graph(fn), before and _graph(before)
    times = []
    for _ in range(reps):
        flush.zero_()
        if first:
            first.replay()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def pair_routes(kgn) -> dict:
    return dict(getattr(kgn, "PAIR_ROUTE_LAUNCHES", {}))


def measure(kgn, shape, dtype, gen, flush, clocks=None) -> dict:
    """The three kernels' clocks, the library calls, the bounds, bit-identity
    and route at one site (module docstring)."""
    device_ms, graph_ms = clocks or _clocks()
    h, w, c = shape
    x = torch.randn(1, h, w, c, generator=gen, device="cuda").to(dtype)
    gamma = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    before = pair_routes(kgn)
    a, b = kgn.gn_stats(x, gamma, beta, GROUPS, EPS)
    a2, b2 = kgn.gn_stats(x, gamma, beta, GROUPS, EPS)
    kgn.gn_apply(x, a, b, True)
    route = "+".join(k for k, v in pair_routes(kgn).items() if v > before.get(k, 0)) or "-"
    fns = {
        "gn_stats": lambda: kgn.gn_stats(x, gamma, beta, GROUPS, EPS),
        "gn_apply": lambda: kgn.gn_apply(x, a, b, True),
        "pair": lambda: kgn.gn_apply(x, *kgn.gn_stats(x, gamma, beta, GROUPS, EPS), True),
    }
    xv = x.view(1, h * w, GROUPS, c // GROUPS)
    xc = x.permute(0, 3, 1, 2)
    libs = {"gn_stats": lambda: torch.var_mean(xv, dim=(1, 3), correction=0),
            "pair": lambda: F.silu(F.group_norm(xc, GROUPS, gamma, beta, EPS))}
    nx, coef, par = x.numel() * x.element_size(), 2 * c * 4, 2 * c * x.element_size()
    nbytes = {"gn_stats": nx + par + coef, "gn_apply": 2 * nx + coef, "pair": 2 * nx + par}
    out = {"shape": [1, h, w, c], "dtype": str(dtype).split(".")[-1], "calls": SITES.get(shape, 1), "route": route,
           "bit_identical": bool(torch.equal(a, a2) and torch.equal(b, b2))}
    for k, fn in fns.items():
        out[k] = {"ms": device_ms(fn), "device_only_ms": graph_ms(fn), "cold_ms": cold_ms(fn, flush),
                  "bound_ms": nbytes[k] / HBM_BYTES_PER_S * 1e3}
        if k == "gn_apply":  # as in the pair: right after gn_stats read x
            out[k]["after_stats_ms"] = cold_ms(fn, flush, before=fns["gn_stats"])
        if k in libs:
            out[k].update(library_ms=device_ms(libs[k]), library_cold_ms=cold_ms(libs[k], flush))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--json", help="write every row and the sums to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_groupnorm: needs a CUDA card")
    from diffusion_uncertainty_torch.kernels import groupnorm as kgn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    clocks = _clocks()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    dtype = getattr(torch, args.dtype)
    rows = [measure(kgn, shape, dtype, gen, flush, clocks) for shape in SITES]
    sums = {}
    for r in rows:
        for k in KERNELS:
            for weight in ("shapes", "decode"):
                t = sums.setdefault(f"{k} {weight}", {})
                m = 1 if weight == "shapes" else r["calls"]
                for key, val in r[k].items():
                    t[key] = t.get(key, 0.0) + m * val
        print(f"{str(r['shape']):<20} {r['dtype']:<8} x{r['calls']}  route {r['route']:<12} bit-identical "
              f"{r['bit_identical']}", flush=True)
        for k in KERNELS:
            t = r[k]
            lib = (f"  library {t['library_ms']:.4f} (cold {t['library_cold_ms']:.4f})" if "library_ms" in t else "")
            after = f"  after gn_stats {t['after_stats_ms']:.4f}" if "after_stats_ms" in t else ""
            print(f"    {k:<9} {t['ms']:.4f} ms  device-only {t['device_only_ms']:.4f}  cold {t['cold_ms']:.4f}{after}"
                  f"{lib}  bound {t['bound_ms']:.4f}", flush=True)
    for key, t in sums.items():
        lib = f"  library {t['library_ms']:.4f} (cold {t['library_cold_ms']:.4f})" if "library_ms" in t else ""
        after = f"  after gn_stats {t['after_stats_ms']:.4f}" if "after_stats_ms" in t else ""
        print(f"sum {key:<16} {t['ms']:.4f} ms  device-only {t['device_only_ms']:.4f}  cold {t['cold_ms']:.4f}{after}{lib}  "
              f"bound {t['bound_ms']:.4f}", flush=True)
    print(card, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "dtype": args.dtype, "rows": rows, "sums": sums}, indent=1))


if __name__ == "__main__":
    main()
