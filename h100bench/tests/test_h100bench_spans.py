"""``spans.summarise``: the program's spans and the host's blocking points
of a profiled stretch.

* a synthetic trace: nested spans, a kernel launched inside ``geom.knn``,
  a ``sync.*`` span around a ``cudaStreamSynchronize``, a ``Memcpy DtoH``
  outside every sync span, and an idle gap inside
  ``train_step.optimizer``, gives the expected ``spans``, ``syncs``,
  ``unspanned`` and readings;
* ``trace.summarise`` reads the same events to the same values before
  and after ``spans.summarise`` has read them;
* a tiny training cell on the CPU, profiled as the traced run profiles
  it, reports every phase of the step.
"""

import json
from pathlib import Path

import pytest

from h100bench import loops, run, spans, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _events():
    """One step, 0-100 us on the host; device work at 12-16 (the kNN
    kernel), 30-34 (a backward kernel, launched from thread 2), 50-52
    (the DtoH copy), 80-86 (an AdamW kernel) and 100-106 (launched
    after the optimizer)."""
    ua = "user_annotation"
    return [
        _x(trace.STEP_SPAN, ua, 0, 100),
        _x("train_step", ua, 1, 98),
        _x("train_step.forward", ua, 2, 24),
        _x("geom.knn", ua, 5, 10),
        _x("aten::sort", "cpu_op", 6, 4),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 1, correlation=1),
        _x("sort_kernel", "kernel", 12, 4, tid=7, correlation=1),
        _x("train_step.backward", ua, 27, 20),
        _x("autograd::engine::evaluate_function", "cpu_op", 28, 6, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 29, 1, tid=2,
           correlation=2),
        _x("bwd_kernel", "kernel", 30, 4, tid=7, correlation=2),
        _x("aten::_local_scalar_dense", "cpu_op", 40, 6),
        _x("cudaMemcpyAsync", "cuda_runtime", 41, 1, correlation=3),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 50, 2, tid=7,
           correlation=3),
        _x("cudaStreamSynchronize", "cuda_runtime", 43, 2),
        _x("train_step.optimizer", ua, 48, 50),
        _x("sync.grads_finite", ua, 55, 10),
        _x("aten::is_nonzero", "cpu_op", 56, 8),
        _x("cudaStreamSynchronize", "cuda_runtime", 57, 6),
        _x("aten::mul", "cpu_op", 70, 3),
        _x("cudaLaunchKernel", "cuda_runtime", 71, 1, correlation=4),
        _x("adam_kernel", "kernel", 80, 6, tid=7, correlation=4),
        _x("train_step", "gpu_user_annotation", 1, 98, tid=7),
        # the profiler's closing synchronise, after the step: not counted
        _x("cudaDeviceSynchronize", "cuda_runtime", 101, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 90, 1, correlation=5),
        _x("late_kernel", "kernel", 100, 6, tid=7, correlation=5),
    ]


def test_summarise_synthetic_trace():
    s = spans.summarise(_events(), 1)
    assert set(s["spans"]) == {"train_step", "train_step.forward",
                               "geom.knn", "train_step.backward",
                               "train_step.optimizer", "sync.grads_finite"}
    sp = {k: {m: pytest.approx(v * 1e6) if isinstance(v, float) else v
              for m, v in r.items()} for k, r in s["spans"].items()}
    assert sp["train_step"] == {"calls": 1, "host_s": 98, "self_s": 88,
                                "kernel_s": 16, "idle_s": 0}
    assert sp["train_step.optimizer"]["self_s"] == 40
    assert sp["sync.grads_finite"]["self_s"] == 10
    # the backward kernel was launched on another thread
    assert sp["train_step.backward"]["kernel_s"] == 0
    assert sp["geom.knn"]["kernel_s"] == 4
    assert sp["train_step.forward"]["kernel_s"] == 4
    assert sp["train_step.optimizer"]["kernel_s"] == 12
    # gaps: 0-12 (no program span open at 0), 16-30 (in the forward),
    # 34-50 (the backward), 52-80 and 86-100 (the optimizer)
    assert s["idle_outside_s"] == pytest.approx(12e-6)
    assert sp["train_step.forward"]["idle_s"] == 14
    assert sp["train_step.backward"]["idle_s"] == 16
    assert sp["train_step.optimizer"]["idle_s"] == 28 + 14
    assert s["window_s"] == pytest.approx(106e-6)
    # two blocking points: the scalar read (its copy and sync counted
    # once) outside any sync span, and the one inside sync.grads_finite
    assert s["syncs"] == 2
    assert [list(u) for u in s["unspanned"]] == [
        ["train_step > train_step.backward > aten::_local_scalar_dense", 1]]
    assert s["call_s"] == pytest.approx(100e-6)
    r = {k: f(s) for k, f in spans.READERS.items()}
    assert r["forward_host_ms.train"] == pytest.approx(24e-3)
    assert r["backward_host_ms.train"] == pytest.approx(20e-3)
    assert r["optimizer_host_ms.train"] == pytest.approx(40e-3)
    assert r["sync_wait_ms.train"] == pytest.approx(10e-3)
    assert r["host_syncs.train"] == r["host_syncs.latency"] == 2
    assert r["geometry_ms.train"] == r["geometry_ms.infer"] \
        == pytest.approx(4e-3)
    shares = spans.step_shares(s)
    assert shares["phases_of_step"] == pytest.approx(94 / 98)
    assert shares["idle_in_phases"] == pytest.approx(1.0)


def test_trace_summary_is_unchanged_by_reading_spans():
    events = _events()
    before = trace.summarise(events, 1, 8)
    spans.summarise(events, 1)
    assert trace.summarise(events, 1, 8) == before
    after = spans.summarise(events, 1)
    for k in set(before) & set(after):  # the same window
        assert after[k] == pytest.approx(before[k]), k


def test_a_parent_without_spans_reads_nothing():
    events = [e for e in _events() if e["cat"] != "user_annotation"
              or e["name"] == trace.STEP_SPAN]
    s = spans.summarise(events, 1)
    assert s["spans"] == {} and spans.step_shares(s) is None
    r = {k: f(s) for k, f in spans.READERS.items()}
    assert r["forward_host_ms.train"] is None
    assert r["geometry_ms.train"] is None
    assert r["host_syncs.train"] == 2


def test_cpu_training_cell_reports_each_phase():
    cell = next(w for w in BENCH["workloads"]
                if w["name"] == "aff_mini.train.b128")
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    cfg["opts"]["TPU.COMPUTE_DTYPE"] = "float32"
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    traffic.update({"batch": 2, "pool": 2, "warmup_steps": 2,
                    "check_steps": 1})
    loop = loops.KINDS[traffic["kind"]](cfg, traffic, 2 ** 31 + 5, "cpu")
    loop.setup()
    s = spans.summarise(loop.profile(2), 2)
    assert s["spans"]["train_step"]["calls"] == 2
    r = {k: f(s) for k, f in spans.READERS.items()}
    for k in ("forward_host_ms.train", "backward_host_ms.train",
              "optimizer_host_ms.train", "sync_wait_ms.train"):
        assert r[k] > 0, k
    assert spans.step_shares(s)["phases_of_step"] > 0.9
    assert s["spans"]["sync.clip"]["calls"] == 2
