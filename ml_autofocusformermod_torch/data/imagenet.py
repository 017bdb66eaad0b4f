"""ImageFolder datasets and per-host sharded loaders (the port's copy of the
JAX package's ``data/imagenet.py``).

Replaces the reference's ``data/build.py`` (torchvision ImageFolder + timm
transforms + DistributedSampler): a plain folder scanner, the native JPEG
decoder with a Pillow fallback, and torch's worker-pool DataLoader. The
train split is shuffled per epoch and sharded per host (``drop_last``); the
validation split strides ``indices[host::num_hosts]`` like the reference's
``SubsetRandomSampler`` scheme (``data/samplers.py:11-29``), padded with
``-1`` sentinels and a ``valid`` mask.

Batches are ``{'image': (b, 3, h, w) float tensor, 'label': int64 tensor,
['valid': bool tensor]}``: the images are transposed to the model's NCHW
(and cast to ``DATA.TRANSPORT_DTYPE``) in the worker, where the JAX
package's batches stay NHWC numpy. When ``DATA.DATA_PATH/<split>`` does not
exist, a deterministic synthetic dataset stands in, as in the JAX package.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import random
from typing import Iterator, Optional

import numpy as np
import torch

from . import native_jpeg
from .transforms import EvalTransform, TrainTransform

__all__ = ["IMG_EXTENSIONS", "ImageFolderDataset", "SyntheticDataset",
           "Loader", "build_dataset", "build_loaders", "stop_worker_server"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolderDataset:
    """<root>/<class_name>/<image> scanner with deterministic class ids.

    ``load(idx)`` returns ``(image HWC float32, label, decoder)``, where
    ``decoder`` names the path that decoded the item: ``"native"`` or
    ``"pil"`` (a file that is not a JPEG, or one the native library cannot
    decode, or no library at all). Whether the library is there is decided
    once (``native``), in the process that builds the dataset, so loader
    workers do not each try to build it.
    """

    def __init__(self, root: str, transform, seed: int = 0):
        self.root = root
        self.transform = transform
        self.seed = seed
        self.epoch = 0  # bumped by Loader.set_epoch: fresh augs every epoch
        self.native = native_jpeg.available()
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append(
                        (os.path.join(cdir, fname), self.class_to_idx[c])
                    )
        self.num_classes = len(classes)

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int):
        path, label = self.samples[idx]
        # deterministic per-(seed, epoch, sample) stream: reproducible under
        # SEED whichever worker process decodes the item, and a fresh
        # augmentation draw every epoch (an int tuple's hash is unsalted,
        # so it is the same in every process and in both packages)
        rng_key = hash((self.seed, self.epoch, idx))
        arr = (self._native_item(path, random.Random(rng_key))
               if self.native else None)
        decoder = "native"
        if arr is None:
            from PIL import Image

            with Image.open(path) as img:
                arr = self.transform(img, random.Random(rng_key))
            decoder = "pil"
        return arr.astype(np.float32), np.int32(label), decoder

    def __getitem__(self, idx: int):
        arr, label, _ = self.load(idx)
        return arr, label

    def _native_item(self, path: str, rng) -> Optional[np.ndarray]:
        """Native decode+crop+resample; None on any failure, so the Pillow
        path takes over with a fresh rng."""
        if not path.lower().endswith((".jpg", ".jpeg")):
            return None
        try:
            with open(path, "rb") as f:
                data = f.read()
            dims = native_jpeg.jpeg_dims(data)
            if dims is None:
                return None
            w, h = dims
            box, interp, flip, fast = self.transform.native_geometry(w, h, rng)
            arr8 = native_jpeg.decode_crop_resize(
                data, box, (self.transform.size, self.transform.size),
                flip=flip, interpolation=interp, fast_scale=fast,
            )
            if arr8 is None:
                return None
            return self.transform.finish_uint8(arr8, rng)
        except (OSError, AttributeError):
            return None


class SyntheticDataset:
    """Deterministic fake images for smoke tests and dry runs: item ``idx``
    is drawn from ``np.random.default_rng(idx)``, HWC float32, label
    ``idx % num_classes``."""

    def __init__(self, img_size: int, num_classes: int, length: int = 1024):
        self.img_size = img_size
        self.num_classes = num_classes
        self.length = length

    def __len__(self) -> int:
        return self.length

    def load(self, idx: int):
        rng = np.random.default_rng(idx)
        arr = rng.standard_normal(
            (self.img_size, self.img_size, 3)
        ).astype(np.float32)
        return arr, np.int32(idx % self.num_classes), "synthetic"

    def __getitem__(self, idx: int):
        arr, label, _ = self.load(idx)
        return arr, label


def _host_shard_indices(
    n: int, host: int, num_hosts: int, shuffle: bool, seed: int, epoch: int
):
    """DistributedSampler-equivalent per-host index shard (train) with
    drop-last semantics."""
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng((seed, epoch))
        idx = rng.permutation(n)
    per_host = n // num_hosts  # drop_last
    return idx[host * per_host: (host + 1) * per_host]


def build_dataset(config, is_train: bool):
    """``(dataset, num_classes)`` of the split: the ImageFolder under
    ``DATA.DATA_PATH/<split>`` (``imagenet22k`` trains on
    ``DATA.DATA_PATH`` itself), else synthetic data."""
    split = "train" if is_train else "val"
    transform = TrainTransform(config) if is_train else EvalTransform(config)
    root = os.path.join(config.DATA.DATA_PATH, split)
    if config.DATA.DATASET == "imagenet22k" and is_train:
        root = config.DATA.DATA_PATH
    if os.path.isdir(root):
        ds = ImageFolderDataset(root, transform, seed=config.SEED)
        if ds.num_classes:
            return ds, ds.num_classes
    # fall back to synthetic data (keeps --throughput / smoke paths alive)
    num_classes = config.MODEL.NUM_CLASSES
    length = max(4 * config.DATA.BATCH_SIZE, 64)
    return (
        SyntheticDataset(config.DATA.IMG_SIZE, num_classes, length=length),
        num_classes,
    )


def _worker_context():
    """The start method of the loader's worker processes: ``forkserver``,
    with this module (and so torch and numpy) preloaded in the server. The
    caller runs threads (the prefetch, CUDA's), so its own process must not
    fork; ``spawn`` would import torch in every worker of every pass (13-15
    s for 8 workers on an 8-core host, PERF.md section 6), where the server
    imports it once and forks each worker from its single thread."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def stop_worker_server() -> None:
    """Stop the worker server of :func:`_worker_context` and the resource
    tracker it started, and wait for both to exit; the next pass with
    workers starts them anew. Without this they outlive the process that
    started them until each reads the end of its pipe, after that process
    has exited. Call it once no loader iteration is open: the workers of a
    pass that is still running are the server's children."""
    from multiprocessing import forkserver, resource_tracker

    # the server holds the tracker's pipe too, so it must go first
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _item(dataset, j: int, transport_dtype):
    """Index ``j`` of ``dataset`` as the loader ships it: (CHW image in the
    transport dtype, label, valid, decoder); ``j = -1`` is padding (item 0,
    not valid)."""
    img, label, decoder = dataset.load(0 if j < 0 else j)
    img = np.ascontiguousarray(img.transpose(2, 0, 1).astype(transport_dtype))
    return torch.from_numpy(img), int(label), bool(j >= 0), decoder


class _Indexed(torch.utils.data.Dataset):
    """The items of one epoch's index list, for the DataLoader's workers
    (the cast and transpose run in the worker, so the pipe carries the
    transport payload)."""

    def __init__(self, dataset, indices: np.ndarray, transport_dtype):
        self.dataset = dataset
        self.indices = indices
        self.transport_dtype = transport_dtype

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return _item(self.dataset, int(self.indices[i]), self.transport_dtype)


class Loader:
    """Epoch-based loader yielding batches ``{'image', 'label'[,
    'valid']}`` of torch tensors on the CPU.

    ``decode_counts`` counts the items of every batch yielded so far by the
    path that decoded them (``native``, ``pil`` or ``synthetic``), whichever
    process decoded them. With ``num_workers`` > 0 the items are decoded by
    a ``torch.utils.data.DataLoader`` whose worker processes start anew for
    each pass (:func:`_worker_context`), and ``pin_memory`` pins its
    batches.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool,
        host: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        num_workers: int = 0,
        drop_last: bool = True,
        stride_shard: bool = False,
        transport_dtype: str = "float32",
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.host = host
        self.num_hosts = num_hosts
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.stride_shard = stride_shard
        # DATA.TRANSPORT_DTYPE: wire format of the normalized images from
        # the decode worker to the device. "float16" halves the worker IPC
        # and H2D payload (77 -> 38 MB at b128/224); fp16's ulp at the
        # normalized image range (~0.002) sits 8-16x below bf16 compute
        # rounding. The default float32 keeps evaluation exact.
        self.transport_dtype = np.dtype(transport_dtype)
        self.pin_memory = pin_memory
        self.epoch = 0
        self.decode_counts = collections.Counter()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch  # re-keys the augmentation stream

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.stride_shard:
            # every host reports the padded (equal) length
            local = -(-n // self.num_hosts)
        else:
            local = n // self.num_hosts
        if self.drop_last:
            return local // self.batch_size
        return (local + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.stride_shard:
            # val sharding: indices[host::num_hosts] (data/samplers.py:23-26),
            # padded with -1 sentinels so every host yields the SAME number
            # of equally-shaped batches (multi-host eval steps are
            # collective: unequal counts would deadlock)
            idx = np.arange(n)[self.host:: self.num_hosts]
            maxlen = -(-n // self.num_hosts)
            if len(idx) < maxlen:
                idx = np.concatenate([idx, np.full(maxlen - len(idx), -1)])
            return idx
        return _host_shard_indices(
            n, self.host, self.num_hosts, self.shuffle, self.seed, self.epoch
        )

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        if self.num_workers > 0:
            yield from self._iter_workers(indices)
            return
        items = []
        for j in indices:
            items.append(_item(self.dataset, int(j), self.transport_dtype))
            if len(items) == self.batch_size:
                yield self._pack(items)
                items = []
        if items and not self.drop_last:
            yield self._pack(items)

    def _pack(self, items) -> dict:
        imgs, labels, valid, decoders = zip(*items)
        return self._batch(torch.stack(imgs),
                           torch.tensor(labels, dtype=torch.int64),
                           torch.tensor(valid, dtype=torch.bool), decoders)

    def _batch(self, images, labels, valid, decoders) -> dict:
        self.decode_counts.update(decoders)
        out = {"image": images, "label": labels}
        if not bool(valid.all()):
            out["valid"] = valid
        return out

    def _iter_workers(self, indices: np.ndarray) -> Iterator[dict]:
        dl = torch.utils.data.DataLoader(
            _Indexed(self.dataset, indices, self.transport_dtype),
            batch_size=self.batch_size,
            num_workers=self.num_workers,
            drop_last=self.drop_last,
            shuffle=False,
            pin_memory=self.pin_memory,
            persistent_workers=False,
            multiprocessing_context=_worker_context(),
        )
        for imgs, labels, valid, decoders in dl:
            yield self._batch(imgs, labels, valid, decoders)


def build_loaders(config, host: int = 0, num_hosts: int = 1):
    """(train_loader, val_loader, num_classes) for this host. Workers:
    ``min(DATA.NUM_WORKERS, os.cpu_count())``, none for synthetic data;
    ``DATA.PIN_MEMORY`` pins the workers' batches where a GPU is visible."""
    train_ds, num_classes = build_dataset(config, is_train=True)
    val_ds, _ = build_dataset(config, is_train=False)
    workers = min(config.DATA.NUM_WORKERS, os.cpu_count() or 1)
    if isinstance(train_ds, SyntheticDataset):
        workers = 0
    pin = bool(config.DATA.PIN_MEMORY) and torch.cuda.is_available()
    train_loader = Loader(
        train_ds,
        config.DATA.BATCH_SIZE,
        shuffle=True,
        host=host,
        num_hosts=num_hosts,
        seed=config.SEED,
        num_workers=workers,
        drop_last=True,
        transport_dtype=config.DATA.TRANSPORT_DTYPE,
        pin_memory=pin,
    )
    val_loader = Loader(
        val_ds,
        config.DATA.BATCH_SIZE,
        shuffle=False,
        host=host,
        num_hosts=num_hosts,
        seed=config.SEED,
        num_workers=workers,
        drop_last=False,
        stride_shard=True,
        pin_memory=pin,
    )
    return train_loader, val_loader, num_classes
