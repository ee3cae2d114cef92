"""Folder-layout image datasets (PIL + numpy, no framework).

JAX counterpart: ``diffusion_uncertainty_tpu/datasets/``. Records are dicts
``{'image': float32 [H,W,3] in [0,1], 'label': int}``.
"""

from .folder import (  # noqa: F401
    CIFAR10Dataset,
    ImageFolderDataset,
    ImagenetDataset,
    LSUNChurches256,
    NpzImagesDataset,
    SyntheticDataset,
    iterate_batches,
)
