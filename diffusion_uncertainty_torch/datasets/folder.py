"""Folder datasets and the batch iterator (numpy; PIL only to read a file).

JAX counterpart: ``diffusion_uncertainty_tpu/datasets/folder.py`` (:31-174), a
copy: the same classes, the same records, and ``SyntheticDataset``'s bytes
equal the JAX package's. ``iterate_batches`` yields fixed-size numpy
batches, the last one padded by repetition (``count`` says how many rows
are real). PIL is imported only when a file is read, so nothing on the
synthetic path needs it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

__all__ = [
    "ImageFolderDataset",
    "ImagenetDataset",
    "CIFAR10Dataset",
    "LSUNChurches256",
    "SyntheticDataset",
    "iterate_batches",
    "NpzImagesDataset",
]

_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".JPEG")


def _load_image(path: Path, image_size: Optional[int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if image_size is not None and img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


class ImageFolderDataset:
    """class-subfolder layout: root/<class_name>/<img>."""

    def __init__(self, root: Path, image_size: Optional[int] = None, class_names: Optional[Sequence[str]] = None):
        self.root = Path(root)
        self.image_size = image_size
        dirs = sorted(d for d in self.root.iterdir() if d.is_dir())
        names = list(class_names) if class_names else [d.name for d in dirs]
        self.class_to_idx = {n: i for i, n in enumerate(names)}
        self.samples: list[tuple[Path, int]] = []
        for d in dirs:
            if d.name not in self.class_to_idx:
                continue
            label = self.class_to_idx[d.name]
            for f in sorted(d.iterdir()):
                if f.suffix in _EXTS:
                    self.samples.append((f, label))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        path, label = self.samples[i]
        return {"image": _load_image(path, self.image_size), "label": label}


class ImagenetDataset(ImageFolderDataset):
    """ImageNet with a synset→index map file (one synset id per line, index =
    line number — the reference's class-map convention, ``dataset/imagenet.py:11-121``)."""

    def __init__(self, root: Path, split: str = "train", image_size: Optional[int] = None, class_map: Optional[Path] = None):
        root = Path(root) / split
        names = None
        if class_map is not None:
            names = [l.strip().split()[0] for l in Path(class_map).read_text().splitlines() if l.strip()]
        super().__init__(root, image_size=image_size, class_names=names)


class CIFAR10Dataset(ImageFolderDataset):
    CLASSES = (
        "airplane", "automobile", "bird", "cat", "deer",
        "dog", "frog", "horse", "ship", "truck",
    )

    def __init__(self, root: Path, image_size: Optional[int] = 32):
        super().__init__(root, image_size=image_size, class_names=self.CLASSES)


class LSUNChurches256:
    """Flat folder of webp images, label fixed to 0 (``lsun_churches256.py:7-35``)."""

    def __init__(self, root: Path, image_size: Optional[int] = 256):
        self.files = sorted(p for p in Path(root).iterdir() if p.suffix in _EXTS)
        self.image_size = image_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        return {"image": _load_image(self.files[i], self.image_size), "label": 0}


@dataclasses.dataclass
class SyntheticDataset:
    """Deterministic random-image dataset for tests / air-gapped smoke runs."""

    num_samples: int = 64
    image_size: int = 32
    num_classes: int = 10
    seed: int = 0

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed * 100003 + i)
        return {
            "image": rng.rand(self.image_size, self.image_size, 3).astype(np.float32),
            "label": int(rng.randint(self.num_classes)),
        }


def iterate_batches(
    dataset,
    batch_size: int,
    indices: Optional[Sequence[int]] = None,
    drop_remainder: bool = False,
) -> Iterator[dict]:
    """Yield {'image': [B,H,W,3] f32, 'label': [B] i32, 'count': valid rows}.
    The final ragged batch is padded by repetition so jitted shapes stay static."""
    idx = list(indices) if indices is not None else list(range(len(dataset)))
    for lo in range(0, len(idx), batch_size):
        chunk = idx[lo : lo + batch_size]
        if len(chunk) < batch_size:
            if drop_remainder:
                return
            chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
            count = len(idx) - lo
        else:
            count = batch_size
        records = [dataset[i] for i in chunk]
        yield {
            "image": np.stack([r["image"] for r in records]),
            "label": np.asarray([r["label"] for r in records], np.int32),
            "count": count,
        }


class NpzImagesDataset:
    """Array-file dataset (the reference's ImageNet64-NPZ format:
    ``scripts/compute_dataset_fid.py:62-87`` — a .npz/.npy of uint8 images,
    NCHW or NHWC, optional labels array)."""

    def __init__(self, path: Path, image_key: str = "data", label_key: Optional[str] = "labels"):
        path = Path(path)
        if path.suffix == ".npy":
            self.images = np.load(path, mmap_mode="r")
            self.labels = None
        else:
            f = np.load(path)
            key = image_key if image_key in f else list(f.keys())[0]
            self.images = f[key]
            self.labels = f[label_key] if (label_key and label_key in f) else None
        if self.images.ndim == 4 and self.images.shape[1] in (1, 3) and self.images.shape[-1] not in (1, 3):
            self.images = np.transpose(self.images, (0, 2, 3, 1))  # NCHW -> NHWC

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> dict:
        img = np.asarray(self.images[i], np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        label = int(self.labels[i]) if self.labels is not None else 0
        return {"image": img, "label": label}
