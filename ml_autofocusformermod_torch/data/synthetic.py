"""Synthetic validation data (counterpart of ``SyntheticDataset`` and its
use in the JAX package's ``data/imagenet.py:103-151``).

The JAX CLI serves deterministic fake images when ``DATA.DATA_PATH`` does
not exist; so does the port. Real ImageFolder loaders are ROADMAP queue A
item 9.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["SyntheticDataset", "build_val_dataset", "iterate_batches"]


class SyntheticDataset:
    """Deterministic fake images: item ``idx`` is drawn from
    ``np.random.default_rng(idx)``, HWC float32, label ``idx % classes``."""

    def __init__(self, img_size: int, num_classes: int, length: int = 1024):
        self.img_size = img_size
        self.num_classes = num_classes
        self.length = length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(idx)
        arr = rng.standard_normal(
            (self.img_size, self.img_size, 3)
        ).astype(np.float32)
        return arr, np.int32(idx % self.num_classes)


def build_val_dataset(config) -> SyntheticDataset:
    """The validation set: synthetic when ``DATA.DATA_PATH/val`` is absent."""
    root = os.path.join(config.DATA.DATA_PATH, "val")
    if os.path.isdir(root):
        raise NotImplementedError(
            f"{root} exists, but the ImageFolder loader is not ported yet "
            "(ROADMAP.md queue A item 9); point DATA.DATA_PATH elsewhere to "
            "evaluate on synthetic data")
    length = max(4 * config.DATA.BATCH_SIZE, 64)
    return SyntheticDataset(config.DATA.IMG_SIZE, config.MODEL.NUM_CLASSES,
                            length=length)


def iterate_batches(dataset, batch_size: int
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(images NCHW float32, labels int64) CPU batches in index order; the
    last batch may be short."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size,
                                                      len(dataset)))]
        imgs = np.stack([a for a, _ in items]).transpose(0, 3, 1, 2)
        labels = np.asarray([l for _, l in items], np.int64)
        yield torch.from_numpy(np.ascontiguousarray(imgs)), torch.from_numpy(labels)
