"""Interop with the reference's torch ``.pth`` artifacts.

JAX counterpart: ``diffusion_uncertainty_tpu/utils/interop.py`` (torch-only
there too). The reference stores its run artifacts as NCHW tensors
(``uncertainty_*.pth``, ``gen_images_*.pth``, the ``X_T.pth`` / ``y.pth``
starting points); these helpers read them into the NHWC npz layout of
``utils.experiments`` and write npz arrays back as ``.pth`` for the
reference's evaluation scripts.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["load_pth_array", "save_pth_array", "import_reference_run", "nchw_to_nhwc", "nhwc_to_nchw"]


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 2, 3, 1)) if x.ndim == 4 else np.transpose(x, (0, 1, 3, 4, 2))


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 3, 1, 2)) if x.ndim == 4 else np.transpose(x, (0, 1, 4, 2, 3))


def load_pth_array(path: Path, to_nhwc: bool = True) -> np.ndarray:
    """A ``.pth`` tensor as an array; image-like NCHW (or [N, T, C, H, W])
    with 1, 3, 4 or 6 channels turned NHWC."""
    x = torch.load(path, map_location="cpu", weights_only=True)
    x = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    if to_nhwc and x.ndim >= 4 and x.shape[-3] in (1, 3, 4, 6):
        x = nchw_to_nhwc(x)
    return x


def save_pth_array(path: Path, array: np.ndarray, from_nhwc: bool = True) -> Path:
    """An array as a ``.pth`` tensor, NHWC turned NCHW where the last axis
    has 1, 3, 4 or 6 channels."""
    x = np.asarray(array)
    if from_nhwc and x.ndim >= 4 and x.shape[-1] in (1, 3, 4, 6):
        x = nhwc_to_nchw(x)
    torch.save(torch.from_numpy(np.ascontiguousarray(x)), path)
    return Path(path)


def import_reference_run(ref_dir: Path, out_dir: Path, names=("uncertainty", "gen_images", "score")) -> Path:
    """A reference run folder (``<name>_<i>.pth`` shards and ``args.yaml``)
    converted into the npz run layout under ``out_dir``."""
    ref_dir, out_dir = Path(ref_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if (ref_dir / "args.yaml").exists():
        (out_dir / "args.yaml").write_text((ref_dir / "args.yaml").read_text())
    converted = 0
    for name in names:
        for p in sorted(ref_dir.glob(f"{name}_*.pth")):
            shard = int(p.stem.rsplit("_", 1)[1])
            np.savez_compressed(out_dir / f"{name}_{shard}.npz", data=load_pth_array(p))
            converted += 1
    if not converted:
        raise FileNotFoundError(f"no {names} shards found in {ref_dir}")
    return out_dir
