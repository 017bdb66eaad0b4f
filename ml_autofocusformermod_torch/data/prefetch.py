"""Device prefetch: host batch production and the host-to-device copy run
ahead of the step that consumes them (counterpart of the JAX package's
``data/prefetch.py::prefetch_to_mesh``).

Two daemon threads: the first iterates the loader (decode, augment,
collate) and applies ``transform``; the second pins each batch (unless the
loader pinned it already) and issues ``non_blocking`` copies on a side
CUDA stream, recording an event after them. The consumer makes its current
stream wait on that event and marks each tensor as used by it
(``record_stream``), so the caching allocator never hands the memory to
another stream while the step still reads it. The host leg and the copy
leg overlap each other and the device's work on earlier batches. Depth 2:
one batch on the wire while the device works on the previous one.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch

__all__ = ["prefetch_to_device"]

_END = object()


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` on ``q`` unless the consumer has gone; False then."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def _to_device(batch: dict, device: torch.device, stream) -> tuple:
    """(device batch, its event, the host batch the copies read)."""
    host = {k: v if v.is_pinned() else v.pin_memory()
            for k, v in batch.items()}
    with torch.cuda.stream(stream):
        out = {k: v.to(device, non_blocking=True) for k, v in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event, host


def prefetch_to_device(
    iterable: Iterable,
    device,
    size: int = 2,
    transform: Optional[Callable] = None,
) -> Iterator[dict]:
    """Iterate ``iterable`` (batches: dicts of CPU tensors), yielding each
    batch on ``device``, up to ``size`` batches ahead of the consumer.

    ``transform`` runs on the host thread on each batch before the copy.
    An exception of the loader, of ``transform`` or of the copy re-raises at
    the consumer's ``next()``. When the consumer stops early (``break``, or
    the generator is closed), both threads stop at their next hand-off,
    which ends the loader's iteration and its worker processes; the threads
    are daemons, so an iterator that is never closed cannot hang the
    interpreter's exit. On a CPU device the batches pass through as they
    are.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:  # the consumer's current card
        device = torch.device("cuda", torch.cuda.current_device())
    q1: queue.Queue = queue.Queue(maxsize=max(1, size))
    q2: queue.Queue = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def produce_host() -> None:
        try:
            for batch in iterable:
                if transform is not None:
                    batch = transform(batch)
                if not _put(q1, batch, stop):
                    return
            _put(q1, _END, stop)
        except BaseException as e:  # noqa: BLE001 -- re-raised by consumer
            _put(q1, e, stop)

    def produce_device() -> None:
        try:
            if cuda:
                torch.cuda.set_device(device)  # this thread's device
                stream = torch.cuda.Stream(device)
            while not stop.is_set():
                try:
                    item = q1.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is _END or isinstance(item, BaseException):
                    _put(q2, item, stop)
                    return
                if cuda:
                    item = _to_device(item, device, stream)
                if not _put(q2, item, stop):
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised by consumer
            _put(q2, e, stop)

    threads = [threading.Thread(target=produce_host, daemon=True,
                                name="prefetch-host"),
               threading.Thread(target=produce_device, daemon=True,
                                name="prefetch-h2d")]
    for t in threads:
        t.start()
    try:
        while True:
            item = q2.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            if cuda:
                batch, event, _host = item
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in batch.values():
                    t.record_stream(current)
                item = batch
            yield item
    finally:
        stop.set()
