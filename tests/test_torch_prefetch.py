"""``data/prefetch.py::prefetch_to_device`` on the CPU device (where the
copy is a pass-through): the loader's order, ``transform`` on the host
thread, the producer's errors re-raised at ``next()``, and an early
``break`` that stops both threads and closes the loader. The copy to a
card is checked by the ``cuda``-marked test (and ``chip_smoke.py``)."""

import threading
import time

import pytest
import torch

from ml_autofocusformermod_torch.data.prefetch import prefetch_to_device

torch.set_num_threads(1)


def _batches(n):
    for i in range(n):
        yield {"image": torch.full((2, 3, 4, 4), float(i)),
               "label": torch.tensor([i, i + 1])}


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("prefetch-")]


def _wait_gone(seconds=5.0):
    deadline = time.monotonic() + seconds
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    return not _prefetch_threads()


@pytest.mark.parametrize("size", [1, 2, 5])
def test_order_and_values_are_the_loaders(size):
    got = list(prefetch_to_device(_batches(7), "cpu", size=size))
    want = list(_batches(7))
    assert len(got) == 7
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k]) and g[k].device.type == "cpu"
    assert _wait_gone()


def test_transform_runs_on_the_host_thread():
    names = []

    def transform(batch):
        names.append(threading.current_thread().name)
        return {**batch, "label": batch["label"] * 10}

    got = list(prefetch_to_device(_batches(3), "cpu", transform=transform))
    assert [g["label"].tolist() for g in got] == [[0, 10], [10, 20],
                                                  [20, 30]]
    assert names == ["prefetch-host"] * 3


@pytest.mark.parametrize("where", ["loader", "transform"])
def test_producer_errors_reraise_at_next(where):
    def loader():
        yield from _batches(2)
        if where == "loader":
            raise OSError("disk went away")
        yield from _batches(1)

    calls = []

    def transform(batch):
        calls.append(1)
        if where == "transform" and len(calls) == 3:
            raise ValueError("bad batch")
        return batch

    seen = []
    it = prefetch_to_device(loader(), "cpu", transform=transform)
    seen.append(next(it))
    error = OSError if where == "loader" else ValueError
    with pytest.raises(error):
        for batch in it:
            seen.append(batch)
    assert len(seen) == 2  # the batches before the error arrive first
    assert _wait_gone()


def test_early_break_stops_the_threads_and_closes_the_loader():
    closed = threading.Event()
    produced = []

    def endless():
        try:
            i = 0
            while True:
                produced.append(i)
                yield {"label": torch.tensor([i])}
                i += 1
        finally:
            closed.set()

    for i, batch in enumerate(prefetch_to_device(endless(), "cpu", size=2)):
        assert batch["label"].item() == i
        if i == 3:
            break
    assert _wait_gone(), _prefetch_threads()
    assert closed.wait(5.0)
    assert len(produced) <= 4 + 2 * 2 + 2  # bounded by the two queues


@pytest.mark.cuda
def test_copies_to_the_card_equal_the_loaders_batches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the copy is a pass-through on the "
                    "CPU")
    want = list(_batches(4))
    got = list(prefetch_to_device(_batches(4), "cuda"))
    for g, w in zip(got, want):
        for k in g:
            assert g[k].device.type == "cuda"
            assert torch.equal(g[k].cpu(), w[k])
