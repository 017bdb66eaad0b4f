"""Synthetic train and validation data (counterpart of ``SyntheticDataset``,
``Loader`` and their use in the JAX package's ``data/imagenet.py:103-151``).

The JAX CLI serves deterministic fake images when ``DATA.DATA_PATH`` does
not exist; so does the port. The train split is shuffled per epoch with
``np.random.default_rng((seed, epoch))`` and drops the last partial batch,
as the JAX ``Loader`` does on one host. Real ImageFolder loaders are
ROADMAP queue A item 9.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["SyntheticDataset", "TrainLoader", "build_train_dataset",
           "build_val_dataset", "iterate_batches"]


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


def _synthetic(config, split: str) -> SyntheticDataset:
    """The ``split`` set: synthetic (``max(4 * batch, 64)`` items) when
    ``DATA.DATA_PATH/<split>`` is absent."""
    root = os.path.join(config.DATA.DATA_PATH, split)
    if os.path.isdir(root):
        raise NotImplementedError(
            f"{root} exists, but the ImageFolder loader is not ported yet "
            "(ROADMAP.md queue A item 9); point DATA.DATA_PATH elsewhere to "
            "run on synthetic data")
    length = max(4 * config.DATA.BATCH_SIZE, 64)
    return SyntheticDataset(config.DATA.IMG_SIZE, config.MODEL.NUM_CLASSES,
                            length=length)


def build_train_dataset(config) -> SyntheticDataset:
    """The train set: synthetic when ``DATA.DATA_PATH/train`` is absent."""
    return _synthetic(config, "train")


def build_val_dataset(config) -> SyntheticDataset:
    """The validation set: synthetic when ``DATA.DATA_PATH/val`` is absent."""
    return _synthetic(config, "val")


def _batch(dataset, indices) -> Tuple[torch.Tensor, torch.Tensor]:
    items = [dataset[int(i)] for i in indices]
    imgs = np.stack([a for a, _ in items]).transpose(0, 3, 1, 2)
    labels = np.asarray([l for _, l in items], np.int64)
    return (torch.from_numpy(np.ascontiguousarray(imgs)),
            torch.from_numpy(labels))


def iterate_batches(dataset, batch_size: int
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(images NCHW float32, labels int64) CPU batches in index order; the
    last batch may be short."""
    for start in range(0, len(dataset), batch_size):
        yield _batch(dataset, range(start, min(start + batch_size,
                                               len(dataset))))


class TrainLoader:
    """Shuffled train batches, dropping the last partial one (the JAX
    ``Loader(shuffle=True, drop_last=True)`` on one host)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        idx = np.random.default_rng((self.seed, self.epoch)).permutation(
            len(self.dataset))
        for k in range(len(self)):
            yield _batch(self.dataset,
                         idx[k * self.batch_size:(k + 1) * self.batch_size])
